"""The port's journey ledger (``langstream_tpu_torch/serving/journey.py``)
and the engine's lifecycle edges against the JAX package.

Exact throughout: the ledger's bounds and eviction accounting, the
segment table, ``segments`` and ``stitch`` (a hypothesis property over
random event lists) equal the JAX module's; the same workload through the
JAX engine and the port's, on the JAX engine's weights, records per
request the same sequence of kinds and the same details, times aside
(``t_ms``, ``m_s``, ``seq`` and the ``ms``/``*_ms``/``*_s`` durations) and
the wire's ``bytes`` (the handoff header carries the prefill timings as
decimal text, so a payload's length moves with the clock). Workloads:
combined, prefix hit, QoS preempt and resume, T2 prefix hydrate, adapter
hydrate, drain requeue, journal replay, cancel, deadline shed, a late
completion (``deadline-overrun``, counted 1 on both engines), and a
handoff inside each package; a JAX prefill pool into a port decode pool,
and the reverse, stitch into one journey.
"""

import asyncio

import hypothesis
import hypothesis.strategies as st
import pytest
import torch

from langstream_tpu.serving import journey as jax_journey
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving import journey
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from langstream_tpu_torch.serving.journey import JourneyLedger, segments, stitch
from test_torch_engine import flatten_jax_params

TINY = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 192,
        "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16,
        "prefix-cache": False}
#: the details that carry a time (or a length that moves with one)
TIMED = {"t_ms", "m_s", "seq", "ms", "device_ms", "waited_ms", "overrun_s",
         "remaining_s", "bytes"}
HANDOFF_CHAIN = ["submit", "admit", "first-token", "export", "export-taken",
                 "import-received", "import", "first-step", "finish"]


@pytest.fixture(autouse=True)
def _unmirrored(monkeypatch):
    """The port's ledger records into itself only (a launcher registered
    earlier in this process may have mirrored it into the JAX ledger)."""
    monkeypatch.setattr(journey.JOURNEYS, "mirror", None)


# ---------------------------------------------------------------------------
# shared helpers (the other request-evidence test files import them)
# ---------------------------------------------------------------------------


def ledger_of(engine):
    return journey.JOURNEYS if isinstance(engine, TorchServingEngine) else jax_journey.JOURNEYS


def untimed(events):
    return [{k: v for k, v in e.items() if k not in TIMED} for e in events]


def kinds(events):
    return [e["kind"] for e in events]


def recording(scenario):
    """``scenario(engine)`` wrapped to also return the journeys it opened, in
    submit order, times aside."""
    async def run(engine):
        ledger = ledger_of(engine)
        before = set(ledger.ids())
        result = await scenario(engine)
        return result, [untimed(ledger.events(j)) for j in ledger.ids() if j not in before]

    return run


def jax_engine(cfg):
    return TpuServingEngine(JaxServingConfig.from_dict(cfg))


def port_engine(cfg, flat):
    return TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu",
                              params=params_from_numpy(flat, device="cpu", dtype=torch.float32))


def both(cfg, scenario, jax_cfg=None):
    """``scenario(engine)`` on a JAX engine, then on a port engine with its
    weights: (JAX result, port result, the flat weights). The port engine
    ends with its block manager idle."""
    async def jax():
        engine = jax_engine(jax_cfg or cfg)
        try:
            return flatten_jax_params(engine.params), await scenario(engine)
        finally:
            await engine.close()
            TpuServingEngine.reset_instances()

    flat, want = asyncio.run(jax())

    async def port():
        engine = port_engine(cfg, flat)
        try:
            return await scenario(engine)
        finally:
            await engine.close()
            if engine.block_mgr is not None:
                assert engine.block_mgr.stats()["reserved_blocks"] == 0

    return want, asyncio.run(port()), flat


# ---------------------------------------------------------------------------
# the module against the JAX module
# ---------------------------------------------------------------------------


def test_vocabulary_equals_jax():
    assert journey.TERMINAL_KINDS == jax_journey.TERMINAL_KINDS
    assert journey.LIFECYCLE_CHAIN == jax_journey.LIFECYCLE_CHAIN
    assert journey.SEGMENT_ORDER == jax_journey.SEGMENT_ORDER
    assert journey.EDGE_SEGMENTS == jax_journey.EDGE_SEGMENTS
    for prev, nxt in list(journey.EDGE_SEGMENTS) + [("submit", "bounce"), ("x", "y")]:
        assert journey.classify_edge(prev, nxt) == jax_journey.classify_edge(prev, nxt)


def test_ledger_bounds_and_eviction_accounting_equal_jax():
    port, jax = JourneyLedger(max_requests=4, max_events=8), jax_journey.JourneyLedger(
        max_requests=4, max_events=8)
    script = [(f"j{i % 7}", ["submit", "admit", "first-token", "finish"][i % 4], i % 3)
              for i in range(60)]
    script += [("long", "first-emit", i) for i in range(30)]
    script += [("", "submit", 0), (None, "admit", 0)]
    for jid, kind, n in script:
        port.record(jid, kind, n=n)
        jax.record(jid, kind, n=n)
    assert port.stats() == jax.stats()
    assert port.stats()["evicted_requests"] > 0 and port.stats()["dropped_events"] > 0
    assert port.ids() == jax.ids()
    for jid in port.ids():
        assert untimed(port.events(jid)) == untimed(jax.events(jid))
        assert len(port.events(jid)) <= 8
    strip = lambda rows: [{k: v for k, v in r.items() if k != "t_ms"} for r in rows]  # noqa: E731
    assert strip(port.summaries()) == strip(jax.summaries())
    assert port.events("unknown") == [] and port.stats()["recorded_events"] == 90
    port.clear()
    assert port.ids() == []


def test_ledger_sizes_from_the_environment(monkeypatch):
    for buf, events, want in (("2048", "256", (2048, 256)), ("1", "1", (16, 8)),
                              ("junk", "junk", (1024, 128))):
        monkeypatch.setenv("LS_TPU_JOURNEY_BUFFER", buf)
        monkeypatch.setenv("LS_TPU_JOURNEY_EVENTS", events)
        port, jax = JourneyLedger(), jax_journey.JourneyLedger()
        assert (port.max_requests, port.max_events) == (jax.max_requests,
                                                         jax.max_events) == want


def test_mirror_records_every_edge_into_a_second_ledger():
    port, other = JourneyLedger(), jax_journey.JourneyLedger()
    port.mirror = other
    port.record("j", "submit", model="tiny")
    port.record(None, "admit")
    assert kinds(other.events("j")) == kinds(port.events("j")) == ["submit"]
    assert other.events("j")[0]["model"] == "tiny"


_KINDS = st.sampled_from(sorted({k for pair in jax_journey.EDGE_SEGMENTS for k in pair}
                                | {"journal-replay", "deadline-overrun", "fail"}))
_EVENT = st.fixed_dictionaries({
    "kind": _KINDS,
    "t_ms": st.floats(min_value=0.0, max_value=1e6, allow_nan=False),
})


@hypothesis.settings(max_examples=60, deadline=None, derandomize=True)
@hypothesis.given(st.lists(st.lists(_EVENT, max_size=12), min_size=1, max_size=3))
def test_segments_and_stitch_equal_jax(partials):
    for part in partials:
        assert segments(part) == jax_journey.segments(part)
    got, want = stitch("j", partials), jax_journey.stitch("j", partials)
    assert got == want
    # the segments tile the stitched timeline
    if got["events"]:
        assert abs(sum(s["ms"] for s in got["segments"]) - got["total_ms"]) < 1e-3 * (
            1 + len(got["segments"]))


# ---------------------------------------------------------------------------
# the engines: the same workload, the same edges
# ---------------------------------------------------------------------------


def test_combined_wave_records_the_jax_edges():
    """Plain, streaming and stop-string requests on a streaming engine:
    submit, admit, first-token, (first-emit, last-emit), finish."""
    cfg = {**TINY, "streaming": True}

    fetches = {}

    async def wave(engine):
        chunks = []

        async def on_chunk(ids, text, final):
            chunks.append(final)

        outs = await asyncio.gather(
            engine.generate("hello journey", {"max-tokens": 6}),
            engine.generate("a streamed one", {"max-tokens": 9}, on_chunk=on_chunk),
            engine.generate("stop early", {"max-tokens": 12, "stop": ["\x00"]}),
        )
        fetches[type(engine)] = engine.stats()["decode-chunks"]["host_fetches_per_chunk"]
        return [o["tokens"] for o in outs]

    want, got, _ = both(cfg, recording(wave))
    journeys = got[1]
    assert got == want
    assert fetches[TorchServingEngine] == 1.0  # the edges cost no extra fetch
    assert kinds(journeys[0]) == ["submit", "admit", "first-token", "finish"]
    assert kinds(journeys[1]) == ["submit", "admit", "first-token", "first-emit",
                                  "last-emit", "finish"]
    assert journeys[0][0] == {"kind": "submit", "model": "tiny", "role": "combined",
                              "prompt_tokens": 14, "max_tokens": 6}
    assert journeys[0][-1]["reason"] == "length" and journeys[0][-1]["tokens"] == 6


def test_prefix_hit_records_the_jax_edges():
    cfg = {**TINY, "prefix-cache": True}
    prompt = list(range(1, 60))

    async def twice(engine):
        first = await engine.generate(prompt, {"max-tokens": 5})
        second = await engine.generate(prompt, {"max-tokens": 5})
        return first["tokens"], second["tokens"], engine.prefix_hits

    want, got, _ = both(cfg, recording(twice))
    assert got == want
    (first, second, hits), journeys = got
    assert first == second and hits == 1
    assert [kinds(j) for j in journeys] == [["submit", "admit", "first-token", "finish"]] * 2


def test_qos_preempt_and_resume_record_the_jax_edges():
    from test_torch_qos import BASE as QOS_BASE
    from test_torch_qos import PREEMPT_POOL, _preemption

    cfg = {**QOS_BASE, **PREEMPT_POOL, "qos": {}}
    want, got, _ = both(cfg, recording(_preemption()))
    assert got == want
    journeys = got[1]
    preempted = [j for j in journeys if "preempt" in kinds(j)]
    assert len(preempted) == 1
    assert kinds(preempted[0]) == ["submit", "admit", "first-token", "preempt", "resume",
                                   "admit", "finish"]
    assert preempted[0][3]["reason"] == "no-kv-blocks"


def test_t2_prefix_hydrate_records_the_jax_edges(tmp_path):
    from test_torch_prefixstore import OPTS, PROMPT, _drain_tiers, _spec_dict
    from test_torch_prefixstore import _cfg as prefix_cfg

    async def writer(engine):
        out = await engine.generate(PROMPT, dict(OPTS))
        await _drain_tiers(engine)
        return out["tokens"]

    async def reader(engine):
        assert engine.prefix_store.flush(10)
        return (await engine.generate(PROMPT, dict(OPTS)))["tokens"]

    def cfg(package):
        return prefix_cfg(None, _spec_dict(tmp_path / package, **{"t1-bytes": 1}))

    # each package's replica A writes its own T2 directory, then replica B
    # of the same package hydrates from it
    flat = both(cfg("port"), writer, jax_cfg=cfg("jax"))[2]
    runs = {}
    for package in ("jax", "port"):
        async def serve(package=package):
            engine = jax_engine(cfg(package)) if package == "jax" else port_engine(
                cfg(package), flat)
            try:
                return await recording(reader)(engine)
            finally:
                await engine.close()
                TpuServingEngine.reset_instances()

        runs[package] = asyncio.run(serve())
    assert runs["port"] == runs["jax"]
    tokens, journeys = runs["port"]
    assert kinds(journeys[0]) == ["submit", "hydrate-begin", "hydrate-done", "admit",
                                  "first-token", "finish"]
    assert journeys[0][1]["blocks"] >= 1 and journeys[0][2]["timeout"] is False


def test_adapter_hydrate_records_the_jax_edges(tmp_path):
    from langstream_tpu.serving import adapters as jax_ad
    from langstream_tpu_torch.serving.adapters import publish_adapter
    from test_torch_lora_engine import PROMPT, STORE, _cfg, _factors, _opts

    factors = _factors(31)
    flat = both(_cfg(None), lambda e: asyncio.sleep(0))[2]
    fingerprint = port_engine(_cfg(), flat).adapter_fingerprint()
    jax_ad.publish_adapter({"type": "local", "path": str(tmp_path / "jax")}, "pub", factors,
                           fingerprint)
    publish_adapter({"type": "local", "path": str(tmp_path / "port")}, "pub", factors,
                    fingerprint)

    async def hydrate(engine):
        assert engine.adapter_store.flush(10)
        engine.adapter_store.apply_results()
        return (await engine.generate(PROMPT, _opts("pub")))["tokens"]

    def cfg(package):
        return _cfg({**STORE, "t2": {"type": "local", "path": str(tmp_path / package)}})

    want, got, _ = both(cfg("port"), recording(hydrate), jax_cfg=cfg("jax"))
    assert got == want
    assert kinds(got[1][0]) == ["submit", "adapter-hydrate", "adapter-hydrate-done", "admit",
                                "first-token", "finish"]
    assert got[1][0][1] == {"kind": "adapter-hydrate", "adapter": "pub"}


def test_drain_requeue_records_the_jax_edges():
    from test_torch_drain import BASE as DRAIN_BASE
    from test_torch_drain import _drained

    want, got, _ = both(DRAIN_BASE, recording(_drained))
    assert got == want
    journeys = got[1]
    drained = [j for j in journeys if "preempt" in kinds(j)]
    assert drained and all(j[kinds(j).index("preempt")]["reason"] == "drain" for j in drained)
    assert kinds(journeys[-1]) == ["submit", "shed"] and journeys[-1][1]["reason"] == "draining"


def test_journal_replay_records_the_jax_edges(tmp_path):
    from test_torch_journal import BASE as JOURNAL_BASE
    from test_torch_journal import HANG, _crash, _restart

    flat = both(JOURNAL_BASE, lambda e: asyncio.sleep(0))[2]
    runs = {}
    for package in ("jax", "port"):
        cfg = {**JOURNAL_BASE, "journal-dir": str(tmp_path / package)}
        make = jax_engine if package == "jax" else (lambda c: port_engine(c, flat))
        ledger = jax_journey.JOURNEYS if package == "jax" else journey.JOURNEYS
        before = set(ledger.ids())
        asyncio.run(_crash(make({**cfg, "faults": HANG})))
        TpuServingEngine.reset_instances()
        tokens, fresh, stats, _ = asyncio.run(_restart(make(cfg)))
        TpuServingEngine.reset_instances()
        runs[package] = (tokens, fresh["tokens"], stats["replayed"],
                         [untimed(ledger.events(j)) for j in ledger.ids() if j not in before])
    assert runs["port"] == runs["jax"]
    journeys = runs["port"][3]
    replayed = [j for j in journeys if "journal-replay" in kinds(j)]
    assert len(replayed) == 3
    for j in replayed:
        assert kinds(j)[0] == "submit"
        assert kinds(j)[kinds(j).index("journal-replay"):] == [
            "journal-replay", "admit", "first-token", "finish"]


def test_cancel_records_the_jax_edges():
    async def cancel(engine):
        seen = []

        async def on_token(token, logprob, last):
            seen.append(token)
            if len(seen) == 2:
                task.cancel()

        task = asyncio.ensure_future(engine.generate("cancel me soon", {"max-tokens": 40},
                                                     on_token=on_token))
        with pytest.raises(asyncio.CancelledError):
            await task
        for _ in range(300):
            if all(s.free for s in engine.slots) and engine._pending_chunk is None:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        return engine.completed_requests

    want, got, _ = both(TINY, recording(cancel))
    assert got == want
    assert kinds(got[1][0]) == ["submit", "admit", "first-token", "cancelled"]


def test_deadline_shed_records_the_jax_edges():
    from langstream_tpu.serving.handoff import DeadlineExceeded as JaxDeadlineExceeded
    from langstream_tpu_torch.serving.handoff import DeadlineExceeded

    async def shed(engine):
        with pytest.raises((DeadlineExceeded, JaxDeadlineExceeded)):
            await engine.generate("too late already", {"max-tokens": 4, "deadline-s": 0})
        return engine.stats()["survival"]["deadline_sheds"]

    want, got, _ = both(TINY, recording(shed))
    assert got == want
    assert got[1][0][1:] == [{"kind": "deadline-exceeded", "where": "submit"}]


def test_late_completion_counts_one_overrun_on_both_engines():
    """The same late completion (a consumer that outspends a 0.25 s budget)
    answers, and reads ``deadline_overruns == 1`` and a ``deadline-overrun``
    edge before ``finish`` on both engines."""
    async def late(engine):
        async def slow_consumer(token, logprob, last):
            await asyncio.sleep(0.1)

        result = await engine.generate("a budget the token stream outspends",
                                       {"max-tokens": 4, "deadline-s": 0.25},
                                       on_token=slow_consumer)
        events = [e for e in engine.flight.recent_events(0) if e["kind"] == "deadline-overrun"]
        return (len(result["tokens"]), engine.stats()["survival"]["deadline_overruns"],
                len(events), events[0]["overrun_s"] > 0)

    want, got, _ = both({**TINY, "slots": 2}, recording(late))
    assert got == want
    assert got[0] == (4, 1, 1, True)
    assert kinds(got[1][0]) == ["submit", "admit", "first-token", "deadline-overrun", "finish"]


def test_warmup_probes_record_no_journey():
    async def warm(engine):
        await engine.warmup()
        return engine.completed_requests > 0

    want, got, _ = both(TINY, recording(warm))
    assert got == want and got[1] == []


# ---------------------------------------------------------------------------
# handoffs: inside each package, and across the two
# ---------------------------------------------------------------------------


def _pools(package, flat):
    make = jax_engine if package == "jax" else (lambda c: port_engine(c, flat))
    return (make({**TINY, "pool-role": "prefill"}), make({**TINY, "pool-role": "decode"}))


async def _handoff(pre, dec, prompts):
    outs = []
    for prompt in prompts:
        ticket = await pre.generate(prompt, {"max-tokens": 7})
        outs.append(await dec.import_handoff(pre.take_export(ticket["handoff"])))
    return outs


def test_handoff_inside_each_package_records_the_jax_edges():
    flat = both(TINY, lambda e: asyncio.sleep(0))[2]
    runs = {}
    for package in ("jax", "port"):
        pre, dec = _pools(package, flat)

        async def main(pre=pre, dec=dec):
            try:
                return await recording(lambda _: _handoff(pre, dec, ["hand off one",
                                                                     "and two"]))(pre)
            finally:
                await pre.close()
                await dec.close()

        outs, journeys = asyncio.run(main())
        runs[package] = ([o["tokens"] for o in outs], journeys)
    assert runs["port"] == runs["jax"]
    for j in runs["port"][1]:
        assert kinds(j) == HANDOFF_CHAIN
        assert j[3]["role"] == "prefill" and j[6]["role"] == "decode"


@pytest.mark.parametrize("prefill,decode", [("jax", "port"), ("port", "jax")])
def test_a_journey_crossing_packages_stitches_into_one(prefill, decode):
    flat = both(TINY, lambda e: asyncio.sleep(0))[2]
    pre = _pools(prefill, flat)[0]
    dec = _pools(decode, flat)[1]
    prompt = "one journey across two packages"

    async def main():
        try:
            ticket = await pre.generate(prompt, {"max-tokens": 7})
            jid = ledger_of(pre).ids()[-1]
            out = await dec.import_handoff(pre.take_export(ticket["handoff"]))
            return jid, out
        finally:
            await pre.close()
            await dec.close()

    jid, out = asyncio.run(main())
    partials = [ledger_of(pre).events(jid), ledger_of(dec).events(jid)]
    assert kinds(partials[0]) == HANDOFF_CHAIN[:5]
    assert kinds(partials[1]) == HANDOFF_CHAIN[5:]
    merged = stitch(jid, partials)
    assert merged == jax_journey.stitch(jid, partials)
    assert kinds(merged["events"]) == HANDOFF_CHAIN
    assert merged["complete"] and merged["anomalies"] == []
    assert {"prefill", "transfer", "decode-admission", "first-step", "decode"} <= set(
        merged["by_segment_ms"])
    assert len(out["tokens"]) == 7
