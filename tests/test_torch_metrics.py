"""The port's Prometheus plane (``langstream_tpu_torch/core/metrics.py`` and
the engines' series) against the JAX package's.

- The registry: the stdlib renderer equals the JAX module's fallback
  renderer byte for byte (buckets, HELP, TYPE, ``agent_id``), with and
  without exemplars (the timestamp aside), and the scrape passes the
  OpenMetrics line grammar of ``tests/test_incident.py``.
- Seven workloads through both engines on the JAX engine's weights: FIFO
  combined, QoS with streaming and an SLO, the prefix store, the adapter
  store, prefill and decode pools, survival with a journal, and
  speculation. Each gives the same set of ``langstream_serving_*`` and
  ``langstream_stream_*`` families, and the same change per series for
  counters, gauges that are not times, and histogram ``_count``s. Both
  packages render from a fresh registry in each test (the JAX one through
  its stdlib registry), so a series' change is its value after the
  workload less its value before.
- The default-config pin, a traced request's TTFT exemplar resolving
  through ``tools/journey.py --trace``, the embeddings counter, and the
  flight events the port now records (``recompile``, ``spec-auto-*``,
  ``warmup``) with the JAX details.
"""

import asyncio
import importlib.util
import json
import re
from pathlib import Path

import pytest
import torch

from langstream_tpu.api import metrics as jax_metrics
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.core import metrics, tracing
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving import journey
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from test_torch_engine import flatten_jax_params

REPO = Path(__file__).resolve().parents[1]
TINY = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 192,
        "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16}
PROMPTS = ["metrics plane request one, a sentence", "the second, shorter",
           "and a third prompt that runs a little longer than the others"]
#: series compared by presence only: a time (or a ratio of times), the
#: handoff's wire bytes (its header carries the prefill timings as decimal
#: text, so a payload's length moves with the clock), and the memory
#: ledger's device bytes (each package's own tensors: the upload caches
#: hold other dtypes)
TIMED = re.compile(r"_seconds(_total)?$|_uplift$|kv_(ex|im)port_bytes_total$|hbm_bytes_")
#: per workload, gauges sampled against a wall-clock schedule: under the
#: survival workload the pool's reserved ratio is read at the last dispatch
#: against a budget the recovery probe restores on a clock
CLOCKED = {"survival_journal": {"langstream_serving_kv_pool_used_ratio"}}
#: the families only a configured plane registers (the default-config pin)
CONDITIONAL = re.compile(
    r"langstream_stream_|_slo_|_qos_|handoff_|kv_export|kv_import|prefix_tier|"
    r"prefix_t[12]_|prefix_demotions|prefix_evictions|adapter_|breaker_open|"
    r"deadline_shed|journal_depth")

# the OpenMetrics line grammar of tests/test_incident.py
_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_VALUE = r"(?:[-+]?(?:[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)|NaN|[-+]?Inf)"
_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
_LABELS = rf"\{{(?:{_LABEL}(?:,{_LABEL})*)?,?\}}"
_EXEMPLAR = rf' # \{{trace_id="[^"]+"\}} {_VALUE} {_VALUE}'
_HELP = re.compile(rf"^# HELP {_NAME} .*$")
_TYPE = re.compile(rf"^# TYPE {_NAME} (counter|gauge|histogram|summary|untyped)$")
_SAMPLE = re.compile(rf"^(?P<name>{_NAME})(?P<labels>{_LABELS})? (?P<value>{_VALUE})"
                     rf"(?: {_VALUE})?(?P<exemplar>{_EXEMPLAR})?$")


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    """Both packages' registries start empty (the JAX one on its stdlib
    registry), the port's reporter is its own, and the port's journeys
    stay in its ledger."""
    monkeypatch.setattr(jax_metrics, "_HAVE_PROM", False)
    monkeypatch.setattr(jax_metrics, "_fallback", {})
    monkeypatch.setattr(jax_metrics, "_exemplars", {})
    monkeypatch.setattr(metrics, "_registry", {})
    monkeypatch.setattr(metrics, "_exemplars", {})
    monkeypatch.setattr(metrics, "REPORTER", metrics.PrometheusMetricsReporter)
    monkeypatch.setattr(journey.JOURNEYS, "mirror", None)
    # the uplift verdict is a wall-clock ratio: out of reach here
    monkeypatch.setenv("LS_TPU_SPEC_CALIBRATE_EVERY", "1000000")


@pytest.fixture(scope="module")
def flat():
    """The JAX engine's tiny f32 weights (seed 0: every workload's JAX
    engine draws the same), as numpy."""
    engine = TpuServingEngine(JaxServingConfig.from_dict(TINY))
    try:
        return flatten_jax_params(engine.params)
    finally:
        asyncio.run(engine.close())
        TpuServingEngine.reset_instances()


def _port(cfg, flat):
    return TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu",
                              params=params_from_numpy(flat, device="cpu",
                                                       dtype=torch.float32))


def _jax(cfg):
    return TpuServingEngine(JaxServingConfig.from_dict(cfg))


def check_grammar(body: str) -> list[str]:
    """Every line a HELP/TYPE comment or a well-formed sample; exemplars on
    ``_bucket`` lines only. Returns the exemplar trace ids."""
    assert body.strip()
    ids = []
    for line in body.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            # HELP, TYPE, or the empty registry's one comment
            assert _HELP.match(line) or _TYPE.match(line) or line == (
                "# no metrics registered yet"), line
            continue
        m = _SAMPLE.match(line)
        assert m, f"malformed sample line: {line!r}"
        if m.group("exemplar"):
            assert m.group("name").endswith("_bucket"), line
            ids.append(re.search(r'trace_id="([^"]+)"', line).group(1))
    return ids


def scrape(body: bytes) -> tuple[dict[str, str], dict[tuple[str, str], float]]:
    """(family -> type, (sample name, labels) -> value) of a rendering."""
    text = body.decode()
    check_grammar(text)
    families, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            families[name] = kind
        elif line and not line.startswith("#"):
            m = _SAMPLE.match(line)
            samples[(m.group("name"), m.group("labels") or "")] = float(m.group("value"))
    return families, samples


def changes(before: bytes, after: bytes) -> tuple[set[str], dict, set]:
    """The serving families after a workload; the change of each counter,
    gauge that is not a time, and histogram ``_count``; and the timed
    series present (compared by presence only)."""
    families, now = scrape(after)
    _, then = scrape(before)
    served = {f for f in families if f.startswith(("langstream_serving_",
                                                   "langstream_stream_"))}
    delta, timed = {}, set()
    for (name, labels), value in now.items():
        family = re.sub(r"_(bucket|count|sum)$", "", name)
        if family not in served or name.endswith(("_bucket", "_sum")):
            continue
        if families.get(family) != "histogram" and TIMED.search(name):
            timed.add((name, labels))
            continue
        delta[(name, labels)] = value - then.get((name, labels), 0.0)
    return served, delta, timed


def run_both(workload, flat, tmp_path):
    """``workload(package, make, tmp)`` on the JAX engines, then on the
    port's; each package's (result, serving families, changes, timed
    series)."""
    out = {}
    for package, render, make in (
        ("jax", jax_metrics.render_metrics, _jax),
        ("port", metrics.render_metrics, lambda cfg: _port(cfg, flat)),
    ):
        before = render()
        result = asyncio.run(workload(package, make, tmp_path / package))
        TpuServingEngine.reset_instances()
        out[package] = (result, *changes(before, render()))
    return out


async def _settle(*engines):
    """Wait until each loop idles (its last pass set the slot and queue
    gauges, then cleared its wake event), refresh the section gauges, and
    close."""
    for engine in engines:
        for _ in range(500):
            if all(s.free for s in engine.slots) and not engine._wake.is_set():
                break
            await asyncio.sleep(0.01)
    for engine in engines:
        engine.stats()
        await engine.close()


# ---------------------------------------------------------------------------
# the seven workloads
# ---------------------------------------------------------------------------


async def fifo_combined(package, make, tmp):
    engine = make({**TINY, "prefix-cache": True})
    waves = []
    for _ in range(2):  # the second wave hits the prefix cache
        outs = await asyncio.gather(*(engine.generate(p, {"max-tokens": 6}) for p in PROMPTS))
        waves.append([o["tokens"] for o in outs])
    await _settle(engine)
    return waves, engine.prefix_hits


async def qos_streaming_slo(package, make, tmp):
    from test_torch_qos import BASE as QOS_BASE
    from test_torch_qos import PREEMPT_POOL, _preemption

    slo = {"objectives": {"availability": {"target": 0.999},
                          "shed-rate": {"target": 0.95}}}
    engine = make({**QOS_BASE, **PREEMPT_POOL, "qos": {}, "streaming": True, "slo": slo})
    preempted = await _preemption()(engine)
    chunks = []
    streamed = await engine.generate("a streamed interactive reply",
                                     {"max-tokens": 12, "priority": "interactive"},
                                     on_chunk=lambda ids, text, final: chunks.append(final))
    await _settle(engine)
    return preempted[:4], streamed["tokens"], len(chunks)


async def prefix_store(package, make, tmp):
    from test_torch_prefixstore import OPTS, PROMPT, _drain_tiers, _spec_dict
    from test_torch_prefixstore import _cfg as prefix_cfg

    engine = make(prefix_cfg(None, _spec_dict(tmp, **{"t1-bytes": 1})))
    first = await engine.generate(PROMPT, dict(OPTS))
    await _drain_tiers(engine)
    # the chain now lives in T2 only: the same prompt hydrates it back
    second = await engine.generate(PROMPT, dict(OPTS))
    await _settle(engine)
    return first["tokens"], second["tokens"]


async def adapter_store(package, make, tmp):
    from test_torch_lora_engine import ADAPTERS, PROMPT, _cfg, _opts

    engine = make(_cfg())
    for name, factors in ADAPTERS.items():
        engine.install_adapter(name, factors)
    outs = await asyncio.gather(*(engine.generate(PROMPT, _opts(name))
                                  for name in ("tenant-a", "", "tenant-b")))
    await _settle(engine)
    return [o["tokens"] for o in outs]


async def split_pools(package, make, tmp):
    pre, dec = make({**TINY, "pool-role": "prefill"}), make({**TINY, "pool-role": "decode"})
    outs = []
    for prompt in PROMPTS[:2]:
        ticket = await pre.generate(prompt, {"max-tokens": 7})
        outs.append((await dec.import_handoff(pre.take_export(ticket["handoff"])))["tokens"])
    # the chainer's hooks, as a router would call them
    pre.note_handoff_retry("r-1", replica="dec-0", attempt=1, reason="refused")
    pre.note_handoff_fallback("r-1", attempts=3)
    pre.note_breaker_open(2)
    await _settle(pre, dec)
    return outs


async def survival_journal(package, make, tmp):
    from test_torch_faults import BASE as FAULT_BASE
    from test_torch_faults import PROMPTS as FAULT_PROMPTS
    from test_torch_faults import _wave

    engine = make({**FAULT_BASE, "journal-dir": str(tmp),
                   "faults": [{"site": "prefill", "count": 1}]})
    tokens = await _wave(engine, FAULT_PROMPTS[:5])
    survival = engine.stats()["survival"]
    await _settle(engine)
    return tokens, survival["shrinks"], survival["restores"]


async def speculation(package, make, tmp):
    from test_torch_engine import REPETITIVE

    engine = make({**TINY, "prefix-cache": False, "speculative-drafts": 4})
    outs = await asyncio.gather(engine.generate(*REPETITIVE),
                                engine.generate(PROMPTS[0], {"max-tokens": 12}))
    await _settle(engine)
    return [o["tokens"] for o in outs], engine.spec_steps > 0


WORKLOADS = {f.__name__: f for f in (fifo_combined, qos_streaming_slo, prefix_store,
                                     adapter_store, split_pools, survival_journal,
                                     speculation)}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_workload_scrape_equals_jax(name, flat, tmp_path):
    out = run_both(WORKLOADS[name], flat, tmp_path)
    (want, jax_families, jax_delta, jax_timed) = out["jax"]
    (got, families, delta, timed) = out["port"]
    for clocked in CLOCKED.get(name, ()):
        for d, t in ((delta, timed), (jax_delta, jax_timed)):
            t.update(k for k in list(d) if k[0] == clocked)
            for k in [k for k in d if k[0] == clocked]:
                del d[k]
    assert got == want
    assert families == jax_families
    assert timed == jax_timed
    assert delta == jax_delta
    # each plane's families are really there
    expect = {
        "fifo_combined": "langstream_serving_prefix_cache_hits_total",
        "qos_streaming_slo": "langstream_stream_tbt_seconds",
        "prefix_store": "langstream_serving_prefix_t2_hydrations_total",
        "adapter_store": "langstream_serving_adapter_loads_total",
        "split_pools": "langstream_serving_breaker_open_replicas",
        "survival_journal": "langstream_serving_journal_depth",
        "speculation": "langstream_serving_speculative_steps_total",
    }[name]
    assert expect in families
    moved = {k[0] for k, v in delta.items() if v}
    assert "langstream_serving_tokens_generated_total" in moved


def test_default_combined_fifo_engine_registers_no_conditional_family(flat):
    """The port's twin of ``tests/test_handoff.py``'s default-config pin:
    a combined FIFO engine (dense, the default layout, and paged) registers
    the always-on families only (the paged pool adds its budget series),
    and serving registers nothing lazily."""
    async def serve(engine):
        try:
            await engine.generate("pin prompt", {"max-tokens": 8})
            engine.stats()
        finally:
            await engine.close()

    for layout in ({}, {"kv-layout": "paged"}):
        cfg = {**TINY, "kv-layout": "dense", **layout}
        engine = _port(cfg, flat)
        assert engine._m_handoff_retries is None and engine._m_deadline_shed is None
        asyncio.run(serve(engine))
        families, _ = scrape(metrics.render_metrics())
        assert families and not [f for f in families if CONDITIONAL.search(f)]
        paged = {"langstream_serving_pool_shrinks_total", "langstream_serving_kv_budget_blocks"}
        assert (paged <= set(families)) == bool(layout)
        assert engine._m_breaker_open is None and engine._m_tbt_hist == {}


def test_registry_renders_as_the_jax_fallback_registry(monkeypatch):
    """The same registrations and observations render byte for byte as the
    JAX module's stdlib registry: empty, plain (exemplar slots registered
    but empty), then with an exemplar (equal up to its timestamp)."""
    assert metrics.render_metrics() == jax_metrics.render_metrics() == (
        b"# no metrics registered yet\n")
    assert metrics.LATENCY_BUCKETS == jax_metrics.LATENCY_BUCKETS
    handles = []
    for module in (metrics, jax_metrics):
        rep = module.PrometheusMetricsReporter(prefix="langstream_serving", agent_id="m")
        handles.append((rep.counter("c_total", "a counter"), rep.gauge("g", ""),
                        rep.histogram("h_seconds", "h", buckets=(0.5, 1.0)),
                        rep.exemplar_histogram("x_seconds", "x"),
                        rep.with_prefix("sub").counter("d-e.f")))
    for c, g, h, x, d in handles:
        c(3)
        g(0.25)
        for v in (0.1, 0.7, 2.0):
            h(v)
        x(0.02)
        d()
    plain = metrics.render_metrics()
    assert plain == jax_metrics.render_metrics()
    assert b'langstream_serving_h_seconds_bucket{agent_id="m",le="0.5"} 1' in plain
    assert b'langstream_serving_h_seconds_bucket{agent_id="m",le="+Inf"} 3' in plain
    assert b"langstream_serving_sub_d_e_f" in plain
    for _, _, _, x, _ in handles:
        x(0.04, "0af7651916cd43dd8448eb211c80319c")
    stamp = re.compile(rb" [0-9.]+$", re.M)
    port, jax = metrics.render_metrics(), jax_metrics.render_metrics()
    assert stamp.sub(b"", port) == stamp.sub(b"", jax) != stamp.sub(b"", plain)
    assert check_grammar(port.decode()) == ["0af7651916cd43dd8448eb211c80319c"]


def test_traced_ttft_exemplar_resolves_to_the_ports_journey(flat, tmp_path, capsys):
    """A traced request's journey id rides its TTFT bucket; the operator's
    next command, ``tools/journey.py --trace <id>``, opens the port's
    journey for it."""
    ctx = tracing.TraceContext.new()

    async def run():
        engine = _port(TINY, flat)
        token = tracing.set_current(ctx)
        try:
            await engine.generate("trace me to my bucket", {"max-tokens": 8})
        finally:
            tracing.reset_current(token)
            await engine.close()

    asyncio.run(run())
    body = metrics.render_metrics().decode()
    ttft = [line for line in body.splitlines()
            if line.startswith("langstream_serving_ttft_seconds_bucket") and " # {" in line]
    assert len(ttft) == 1 and check_grammar(body) == [ctx.trace_id]
    events = journey.JOURNEYS.events(ctx.trace_id)
    assert [e["kind"] for e in events] == ["submit", "admit", "first-token", "finish"]
    dump = tmp_path / "journeys.json"
    dump.write_text(json.dumps([journey.stitch(ctx.trace_id, [events])]))
    spec = importlib.util.spec_from_file_location("journey_tool", REPO / "tools" / "journey.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--trace", ctx.trace_id, str(dump)]) == 0
    assert ctx.trace_id in capsys.readouterr().out


def test_embeddings_counter_equals_jax():
    from langstream_tpu.serving.engine import EmbeddingEngine as JaxEmbeddingEngine
    from langstream_tpu_torch.serving.embeddings import EmbeddingEngine

    texts = ["one", "two", "three"]
    port = EmbeddingEngine("tiny", device="cpu")
    jax = JaxEmbeddingEngine("tiny", None, None, None)
    for engine in (port, jax):
        asyncio.run(engine.embed(texts))
    port.close()
    series = 'langstream_serving_embeddings_total{agent_id="tiny"} 3.0'
    assert series in metrics.render_metrics().decode()
    assert series in jax_metrics.render_metrics().decode()


# ---------------------------------------------------------------------------
# the flight events the port records since this plane
# ---------------------------------------------------------------------------


def _kinds_in(path: Path) -> set[str]:
    return set(re.findall(r'\.event\(\s*"([a-z-]+)"', path.read_text()))


def test_jax_only_flight_event_kinds_are_the_multi_gpu_one():
    jax_kinds = _kinds_in(REPO / "langstream_tpu" / "serving" / "engine.py")
    port_kinds = _kinds_in(REPO / "langstream_tpu_torch" / "serving" / "engine.py")
    # the multi-GPU one, lockstep-divergence, is recorded by the port too
    # since its lockstep plane (tests/test_torch_lockstep.py)
    assert "lockstep-divergence" in port_kinds
    assert jax_kinds - port_kinds == set()


def _events(engine, *kinds):
    return [{k: v for k, v in e.items() if k not in ("seq", "t_ms", "m_s")}
            for e in engine.flight.recent_events(0) if e["kind"] in kinds]


def test_warmup_and_recompile_events_carry_the_jax_details(flat):
    """Warmup's ``begin`` and ``end`` (with the variants it dispatched) and a
    ``recompile`` at each first (kind, shape key), then a wave of new
    shapes: the same events in the same order on both engines, and
    ``recompiles_total`` counts them."""
    cfg = {**TINY, "prefix-cache": True, "prefill-chunk": 32}

    async def scenario(engine):
        try:
            await engine.warmup()
            await asyncio.gather(*(engine.generate(p * 3, {"max-tokens": 5, "temperature": t})
                                   for p, t in zip(PROMPTS, (0.0, 0.7, 0.0))))
            await engine.generate(PROMPTS[2] * 3, {"max-tokens": 5})  # a prefix hit
            await engine.generate("short", {"max-tokens": 5})  # one plain prefill
            return _events(engine, "warmup", "recompile")
        finally:
            await engine.close()

    want = asyncio.run(scenario(_jax(cfg)))
    got = asyncio.run(scenario(_port(cfg, flat)))
    assert got == want
    assert got[0] == {"kind": "warmup", "stage": "begin"}
    end = next(e for e in got if e.get("stage") == "end")
    assert end["decode_variants"] >= 1 and end["prefill_variants"] == 0
    compiled = {e["what"] for e in got if e["kind"] == "recompile"}
    assert compiled == {"decode", "prefill", "prefill-continue"}
    assert (f'langstream_serving_recompiles_total{{agent_id="tiny"}} '
            f'{float(len(got) - 2)}') in metrics.render_metrics().decode()


def test_spec_auto_disable_and_enable_events_carry_the_jax_details(flat, monkeypatch):
    """The uplift verdict pinned below 1 on both engines: the disable event
    with the windows' sizes, then after ``LS_TPU_SPEC_RETRY_CHUNKS`` plain
    chunks the enable event; the uplift gauge holds the verdict."""
    from test_torch_engine import REPETITIVE

    monkeypatch.setenv("LS_TPU_SPEC_CALIBRATE_EVERY", "2")
    monkeypatch.setenv("LS_TPU_SPEC_UPLIFT_WINDOW", "2")
    monkeypatch.setenv("LS_TPU_SPEC_RETRY_CHUNKS", "2")
    cfg = {**TINY, "prefix-cache": False, "speculative-drafts": 4, "slots": 2}

    async def scenario(engine):
        # the real verdict's preconditions (a full window and a plain
        # sample), its value pinned
        engine._spec_uplift = lambda: (0.5 if len(engine._spec_window) >= 2
                                       and engine._plain_window else None)
        try:
            out = await engine.generate(REPETITIVE[0], {"max-tokens": 48})
            return out["tokens"], _events(engine, "spec-auto-disable", "spec-auto-enable")
        finally:
            await engine.close()

    want = asyncio.run(scenario(_jax(cfg)))
    got = asyncio.run(scenario(_port(cfg, flat)))
    assert got == want
    kinds = [e["kind"] for e in got[1]]
    assert kinds[:2] == ["spec-auto-disable", "spec-auto-enable"]
    assert got[1][0] == {"kind": "spec-auto-disable", "uplift": 0.5, "window_steps": 2,
                         "plain_samples": 1}
    assert got[1][1] == {"kind": "spec-auto-enable", "plain_chunks": 2}
    assert 'langstream_serving_speculative_uplift{agent_id="tiny"} 0.5' in (
        metrics.render_metrics().decode())
