"""The pod's probes and KV pickup reach the port's engines, and the config
the port refused or ignored where the JAX engine serves or refuses.

- Through ``serve_torch.register(device="cpu")``, the pod functions
  ``runtime/pod.py`` reads from ``langstream_tpu.serving.engine`` at call
  time (``health_report``, ``kick_warmups``, ``take_kv_export``) also
  answer for the port's engines: ``_probe_healthz`` is 503 while a port
  engine is wedged, ``_probe_ready`` starts a ``warmup-on-start`` port
  engine's warmup and is 503 until it finishes, ``_kv_export_payload``
  pops a port prefill pool's export. A second ``register`` wraps nothing
  twice.
- ``LS_TPU_FAULTS`` set raises ``NotImplementedError`` (the JAX engine arms
  plans from it); shrink bounds raise the JAX engine's ``ValueError`` for
  the same values; ``journal-dir: ""``, ``incident-dir: ""`` and
  ``adapter-store: {enabled: false}`` serve, as in the JAX engine.
"""

import asyncio
import time

import pytest

import serve_torch
from langstream_tpu.runtime import pod
from langstream_tpu.serving import engine as jax_engine
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.serving import engine as port_engine
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

TINY = {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 128,
        "decode-chunk": 4}


@pytest.fixture
def registered(monkeypatch):
    """``serve_torch.register(device="cpu")`` with the process-global state
    it touches restored afterwards, and no foreign engine in either
    package's instance map."""
    from langstream_tpu.agents import services
    from langstream_tpu.k8s import operator as k8s_operator

    from langstream_tpu_torch.core import metrics as port_metrics
    from langstream_tpu_torch.core.tracing import SPANS
    from langstream_tpu_torch.serving.journey import JOURNEYS

    from langstream_tpu.runtime import pod

    for name in serve_torch.POD_SEAM:
        monkeypatch.setattr(jax_engine, name, getattr(jax_engine, name))
    for name in serve_torch.SLICE_SEAM:
        monkeypatch.setattr(pod, name, getattr(pod, name))
    for name in serve_torch.OPERATOR_SEAM:
        monkeypatch.setattr(k8s_operator, name, getattr(k8s_operator, name))
    monkeypatch.setattr(services, "_provider_factories", dict(services._provider_factories))
    monkeypatch.setattr(JOURNEYS, "mirror", JOURNEYS.mirror)
    monkeypatch.setattr(SPANS, "mirror", SPANS.mirror)
    monkeypatch.setattr(port_metrics, "REPORTER", port_metrics.REPORTER)
    monkeypatch.setattr(TpuServingEngine, "_instances", {})
    monkeypatch.setattr(TorchServingEngine, "_instances", {})
    serve_torch.register(device="cpu")
    yield
    TorchServingEngine.reset_instances()


def test_register_wraps_the_pod_functions_once(registered):
    wrapped = {name: getattr(jax_engine, name) for name in serve_torch.POD_SEAM}
    serve_torch.register(device="cpu")
    for name, fn in wrapped.items():
        current = getattr(jax_engine, name)
        assert current is fn and current.with_port
        assert not getattr(current.__wrapped__, "with_port", False)
    assert jax_engine.health_report() == []
    assert jax_engine.take_kv_export("nothing") is None
    assert jax_engine.incident_report() == jax_engine.incident_report("incident-1") == []


def test_healthz_answers_503_for_a_wedged_port_engine(registered):
    """As ``tests/test_health.py`` wedges a JAX engine: the port engine's
    admission blocks while a request is queued, the heartbeat stops, and the
    pod's liveness probe flips to 503 naming it; then recovers."""
    cfg = ServingConfig.from_dict({**TINY, "wedge-window-s": 0.3})
    engine = TorchServingEngine.get_or_create(cfg, device="cpu")

    async def main():
        try:
            await engine.generate("healthy probe", {"max-tokens": 2})
            assert pod._probe_healthz(None)[0] == 200
            gate = asyncio.Event()
            real_admit = engine._admit

            async def wedged_admit(loop):
                await gate.wait()
                await real_admit(loop)

            engine._admit = wedged_admit
            stuck = asyncio.ensure_future(engine.generate("stuck request", {"max-tokens": 2}))
            deadline = time.monotonic() + 10.0
            status, body = 200, {}
            while time.monotonic() < deadline:
                status, body = pod._probe_healthz(None)
                if status == 503:
                    break
                await asyncio.sleep(0.05)
            ready = pod._probe_ready(None)
            gate.set()
            await asyncio.wait_for(stuck, 30)
            for _ in range(100):
                if pod._probe_healthz(None)[0] == 200:
                    break
                await asyncio.sleep(0.05)
            return status, body, ready, pod._probe_healthz(None)
        finally:
            await engine.close()

    status, body, ready, after = asyncio.run(main())
    assert status == 503 and body["status"] == "wedged" and body["wedged"] == ["tiny"]
    assert ready[0] == 503 and "engine:tiny:wedged" in ready[1]["blockers"]
    assert after[0] == 200 and after[1]["status"] == "ok"


def test_ready_starts_a_port_warmup_and_waits_for_it(registered):
    cfg = ServingConfig.from_dict({**TINY, "warmup-on-start": True})
    health = pod.PodHealth()
    health.agent_ready = True

    async def main():
        engine = TorchServingEngine.get_or_create(cfg, device="cpu")
        try:
            assert engine.stats()["warmup"]["state"] == "pending"
            status, body = pod._probe_ready(health)  # kicks the warmup
            first = (status, list(body["blockers"]), engine._warmup_task is not None)
            for _ in range(600):
                status, body = pod._probe_ready(health)
                if status == 200:
                    break
                await asyncio.sleep(0.05)
            return first, (status, body), engine.stats()["warmup"]
        finally:
            await engine.close()

    first, (status, body), warmup = asyncio.run(main())
    assert first[0] == 503 and first[2]
    assert any(b.startswith("engine:tiny:warmup-") for b in first[1])
    assert status == 200 and body["ready"] and warmup["state"] == "done"


def test_kv_export_pickup_reaches_a_port_prefill_pool(registered):
    cfg = ServingConfig.from_dict({**TINY, "kv-layout": "paged", "kv-block-size": 16,
                                   "pool-role": "prefill"})

    async def main():
        engine = TorchServingEngine.get_or_create(cfg, device="cpu")
        try:
            ticket = await engine.generate("hand me off", {"max-tokens": 4})
            entry = pod._kv_export_payload(ticket["handoff"])
            again = pod._kv_export_payload(ticket["handoff"])
            return ticket, entry, again, engine.kv_transfer_section()
        finally:
            await engine.close()

    ticket, entry, again, section = asyncio.run(main())
    assert entry is not None and entry["payload"][:4] == b"LSKV"
    assert again is None and section["pending_exports"] == 0
    assert ticket["finish_reason"] == "handoff"


def test_port_module_functions_alone(registered):
    """The port's own ``kick_warmups`` and ``take_kv_export`` over an empty
    instance map: nothing to do, nothing found."""
    port_engine.kick_warmups()
    assert port_engine.take_kv_export("none") is None


# --------------------------------------------------------------------------
# config repairs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("value", ['[{"site": "prefill"}]', "not json", "[]"])
def test_ls_tpu_faults_set_is_refused(monkeypatch, value):
    """``LS_TPU_FAULTS`` arms the port's engine as it arms the JAX engine: the
    same plans, the same refusal of malformed JSON (a chaos run whose faults
    failed to arm would pass against a healthy engine), no injector for an
    empty list."""
    monkeypatch.setenv("LS_TPU_FAULTS", value)

    def armed(make):
        try:
            engine = make()
        except ValueError as e:  # json.JSONDecodeError is a ValueError
            return type(e).__name__
        try:
            return engine.survival_section().get("faults")
        finally:
            asyncio.run(engine.close())

    want = armed(lambda: TpuServingEngine(JaxServingConfig.from_dict(TINY)))
    TpuServingEngine.reset_instances()
    got = armed(lambda: TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu"))
    assert got == want
    assert got == {'[{"site": "prefill"}]': [
        {"site": "prefill", "shape": "oom", "after": 0, "count": 1, "seen": 0, "fired": 0,
         "armed": True}], "not json": "JSONDecodeError", "[]": None}[value]


def test_ls_tpu_faults_blank_serves(monkeypatch):
    monkeypatch.setenv("LS_TPU_FAULTS", "  ")
    engine = TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu")
    assert asyncio.run(engine.generate("hi", {"max-tokens": 2}))["tokens"]
    asyncio.run(engine.close())


@pytest.mark.parametrize("overrides", [
    {"shrink-fraction": 0.0}, {"shrink-fraction": -0.5}, {"shrink-fraction": 1.5},
    {"shrink-recovery-s": 0}, {"shrink-recovery-s": -3.0},
    {"shrink-fraction": 1.0}, {"shrink-fraction": 0.25, "shrink-recovery-s": 0.5},
])
def test_shrink_bounds_as_jax(overrides):
    d = {**TINY, **overrides}
    try:
        TpuServingEngine(JaxServingConfig.from_dict(d))
        jax_error = None
    except ValueError as e:
        jax_error = str(e)
    finally:
        TpuServingEngine.reset_instances()
    if jax_error is None:
        engine = TorchServingEngine(ServingConfig.from_dict(d), device="cpu")
        asyncio.run(engine.close())
        return
    with pytest.raises(ValueError) as err:
        TorchServingEngine(ServingConfig.from_dict(d), device="cpu")
    assert str(err.value) == jax_error


@pytest.mark.parametrize("overrides", [
    {"journal-dir": ""}, {"incident-dir": ""},
    {"adapter-store": {"enabled": False}},
    {"adapter-store": {"enabled": "false", "rank": 4}, "kv-layout": "paged"},
])
def test_empty_dirs_and_disabled_adapter_store_serve_as_jax(overrides):
    d = {**TINY, **overrides}

    async def serve(engine):
        try:
            out = await engine.generate("hi there", {"max-tokens": 3, "temperature": 0})
            return out["tokens"], engine.adapter_store, "adapters" in engine.stats()
        finally:
            await engine.close()

    want = asyncio.run(serve(TpuServingEngine(JaxServingConfig.from_dict(d))))
    TpuServingEngine.reset_instances()
    got = asyncio.run(serve(TorchServingEngine(ServingConfig.from_dict(d), device="cpu")))
    assert got[0] and got[1] is None and got[2] is False
    assert want[1] is None and want[2] is False


# --------------------------------------------------------------------------
# drain, KV import, flight, attribution and profile through the pod
# --------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _pod(monkeypatch):
    """The pod's info server on a free port: (server, aiohttp session, base)."""
    import aiohttp

    port = _free_port()
    monkeypatch.setenv("LS_HTTP_PORT", str(port))
    server = await pod._serve_info(None, health=pod.PodHealth())
    return server, aiohttp.ClientSession(), f"http://127.0.0.1:{port}"


def test_register_wraps_the_eight_pod_functions(registered):
    # the eight of the device-survival slice, and incident_report since the
    # request-evidence slice: every function the pod reads from the engine
    assert serve_torch.POD_SEAM == (
        "health_report", "kick_warmups", "take_kv_export", "flight_report",
        "attribution_report", "drain_engines", "import_kv_handoff", "profile_engines",
        "incident_report")
    for name in serve_torch.POD_SEAM:
        assert getattr(jax_engine, name).with_port
        assert callable(getattr(port_engine, name))


def test_pod_drain_covers_both_packages_under_one_grace(registered, monkeypatch):
    """``GET /drain?grace-s=2`` with a JAX and a port engine whose work
    outlasts the grace: both drain, the port in what the JAX engine left of
    the one deadline (its 0.5 s floor), not a grace of its own."""
    cfg = {**TINY, "kv-layout": "paged", "kv-block-size": 16, "max-seq-len": 256}

    async def slow(token, logprob, last):
        await asyncio.sleep(0.05)

    async def main():
        jax = TpuServingEngine.get_or_create(JaxServingConfig.from_dict(cfg))
        port = TorchServingEngine.get_or_create(ServingConfig.from_dict(cfg), device="cpu")
        server, session, base = await _pod(monkeypatch)
        try:
            tasks = [asyncio.ensure_future(e.generate(f"long {i}", {"max-tokens": 200},
                                                      on_token=slow))
                     for e in (jax, port) for i in range(2)]
            while not all(any(not s.free for s in e.slots) for e in (jax, port)):
                await asyncio.sleep(0.02)
            t0 = time.monotonic()
            async with session.get(f"{base}/drain?grace-s=2") as resp:
                status, body = resp.status, await resp.json()
            wall = time.monotonic() - t0
            done = await asyncio.gather(*tasks, return_exceptions=True)
            return status, body, wall, done
        finally:
            await session.close()
            server.close()
            await jax.close()
            await port.close()

    status, body, wall, done = asyncio.run(main())
    reports = body["engines"]
    assert status == 200 and body["draining"] is True
    assert set(reports) == {"tiny", "tiny (torch)"}
    assert reports["tiny"]["duration_s"] >= 1.9
    assert reports["tiny (torch)"]["duration_s"] < 1.0  # the deadline's remainder
    assert wall < 3.5  # one grace (+ the floor), not two
    for report in reports.values():
        assert report["shed"] >= 1 and report["completed"] + report["shed"] == 2
    assert all(isinstance(r, BaseException) for r in done)


def test_pod_kv_import_reaches_a_port_decode_pool(registered, monkeypatch):
    """``POST /kv/import`` lands a port prefill pool's export in a port decode
    pool (200, the tokens of a combined engine) and answers 409 (layout
    mismatch), 504 (spent deadline) and 503 with Retry-After (draining) for
    the port's refusals, never 500."""
    paged = {**TINY, "kv-layout": "paged", "kv-block-size": 16}

    async def main():
        pre = TorchServingEngine.get_or_create(
            ServingConfig.from_dict({**paged, "pool-role": "prefill"}), device="cpu")
        combined = TorchServingEngine(ServingConfig.from_dict(paged), device="cpu")
        server, session, base = await _pod(monkeypatch)
        dec = None
        try:
            tickets = [await pre.generate(p, {"max-tokens": 6, "temperature": 0})
                       for p in ("first handoff", "second handoff", "third", "fourth")]
            payloads = [pre.take_export(t["handoff"]) for t in tickets]
            want = await combined.generate("first handoff", {"max-tokens": 6,
                                                              "temperature": 0})
            answers = {}

            async def post(payload, **headers):
                async with session.post(f"{base}/kv/import", data=payload,
                                        headers=headers) as resp:
                    return resp.status, await resp.json(), resp.headers.get("Retry-After")

            # no decode-capable engine of either package: the JAX refusal
            answers["none"] = await post(payloads[0])
            # a decode pool whose block size differs: the port's refusal
            odd = TorchServingEngine.get_or_create(ServingConfig.from_dict(
                {**paged, "kv-block-size": 32, "pool-role": "decode"}), device="cpu")
            answers["mismatch"] = await post(payloads[0])
            await odd.close()
            TorchServingEngine._instances.pop(next(
                k for k, v in TorchServingEngine._instances.items() if v is odd))
            dec = TorchServingEngine.get_or_create(ServingConfig.from_dict(
                {**paged, "pool-role": "decode"}), device="cpu")
            answers["ok"] = await post(payloads[0])
            answers["late"] = await post(payloads[1], **{"langstream-deadline": "1.0"})
            await dec.drain(grace_s=1.0)
            answers["draining"] = await post(payloads[2])
            return want, answers
        finally:
            await session.close()
            server.close()
            for engine in (pre, combined, dec):
                if engine is not None:
                    await engine.close()

    want, answers = asyncio.run(main())
    assert answers["none"][0] == 409
    assert answers["mismatch"][0] == 409 and "kv-block-size" in answers["mismatch"][1]["error"]
    status, body, _ = answers["ok"]
    assert status == 200 and body["tokens"] == want["tokens"]
    assert answers["late"][0] == 504 and "deadline" in answers["late"][1]["error"]
    status, body, retry = answers["draining"]
    assert status == 503 and body["reason"] == "draining" and retry == "1"


def test_flight_attribution_and_profile_list_both_packages(registered, tmp_path):
    async def main():
        jax = TpuServingEngine.get_or_create(JaxServingConfig.from_dict(TINY))
        port = TorchServingEngine.get_or_create(ServingConfig.from_dict(TINY), device="cpu")
        try:
            for engine in (jax, port):
                await engine.generate("hello", {"max-tokens": 2})
            flight = jax_engine.flight_report()
            summary = jax_engine.flight_report(summary_only=True)
            attribution = jax_engine.attribution_report()
            memory = pod._memory_payload()
            started = jax_engine.profile_engines("start", str(tmp_path))
            await jax.generate("traced", {"max-tokens": 2})
            stopped = jax_engine.profile_engines("stop")
            with pytest.raises(ValueError):
                jax_engine.profile_engines("pause")
            return flight, summary, attribution, memory, started, stopped
        finally:
            await jax.close()
            await port.close()

    flight, summary, attribution, memory, started, stopped = asyncio.run(main())
    assert [e["model"] for e in flight] == ["tiny", "tiny"]
    port_entry = flight[1]
    assert set(flight[0]) <= set(port_entry)
    assert {"samples", "events"} <= set(port_entry)
    assert not {"samples", "events"} & set(summary[1])
    assert port_entry["survival"]["shrinks"] == 0 and port_entry["drain"] == {"draining": False}
    assert len(attribution) == len(memory) == 2
    assert set(attribution[0]) == set(attribution[1])
    assert set(started) == set(stopped) == {"tiny", "tiny (torch)"}
    assert started["tiny (torch)"] and stopped["tiny (torch)"]
    assert list(tmp_path.glob("trace-*.json"))


def test_pod_journey_and_traces_list_both_packages_as_one_timeline(registered):
    """Through ``serve_torch.register`` the port's journey edges and spans are
    mirrored into the platform's ledger and span buffer: a traced request
    whose prefill ran on a JAX prefill pool and whose decode ran on a port
    decode pool reads as one journey on the pod's ``/journey/{id}`` and one
    trace on ``/traces/{id}``."""
    from langstream_tpu.core import tracing as jax_tracing
    from langstream_tpu_torch.models.convert import params_from_numpy
    from test_torch_engine import flatten_jax_params

    paged = {**TINY, "kv-layout": "paged", "kv-block-size": 16, "prefix-cache": False}

    async def main():
        pre = TpuServingEngine(JaxServingConfig.from_dict({**paged, "pool-role": "prefill"}))
        dec = TorchServingEngine(
            ServingConfig.from_dict({**paged, "pool-role": "decode"}), device="cpu",
            params=params_from_numpy(flatten_jax_params(pre.params), device="cpu"))
        ctx = jax_tracing.TraceContext.new()
        token = jax_tracing.set_current(ctx)
        try:
            ticket = await pre.generate("one timeline", {"max-tokens": 5})
        finally:
            jax_tracing.reset_current(token)
        try:
            await dec.import_handoff(pre.take_export(ticket["handoff"]))
        finally:
            await pre.close()
            await dec.close()
        return ctx

    ctx = asyncio.run(main())
    events = pod._journey_payload(ctx.trace_id)
    assert [e["kind"] for e in events] == [
        "submit", "admit", "first-token", "export", "export-taken", "import-received",
        "import", "first-step", "finish"]
    assert ctx.trace_id in {j["journey"] for j in pod._journey_payload(None)}
    spans = jax_tracing.SPANS.spans(ctx.trace_id)
    assert {"engine.kv-export", "engine.kv-import", "engine.decode"} <= {s["name"] for s in spans}
    assert all(s["parent_id"] == ctx.span_id for s in spans)



def test_pod_metrics_scrape_carries_a_port_engines_series(registered, monkeypatch):
    """Through ``serve_torch.register`` a port engine registers in the
    platform's registry: the pod's one ``GET /metrics`` carries its
    ``langstream_serving_*`` series under the JAX names, with a traced
    request's TTFT exemplar, and the port's own registry stays empty."""
    from langstream_tpu.api import metrics as jax_metrics
    from langstream_tpu_torch.core import metrics as port_metrics
    from langstream_tpu_torch.core import tracing as port_tracing

    # the platform's stdlib registry, fresh: the scrape holds this test's
    # series only
    monkeypatch.setattr(jax_metrics, "_HAVE_PROM", False)
    monkeypatch.setattr(jax_metrics, "_fallback", {})
    monkeypatch.setattr(jax_metrics, "_exemplars", {})
    monkeypatch.setattr(port_metrics, "_registry", {})
    assert port_metrics.REPORTER is jax_metrics.PrometheusMetricsReporter

    async def main():
        engine = TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu")
        server, session, base = await _pod(monkeypatch)
        ctx = port_tracing.TraceContext.new()
        try:
            token = port_tracing.set_current(ctx)
            try:
                await engine.generate("scrape me", {"max-tokens": 5})
            finally:
                port_tracing.reset_current(token)
            async with session.get(f"{base}/metrics") as resp:
                return resp.status, await resp.text(), engine.total_generated, ctx
        finally:
            await session.close()
            server.close()
            await engine.close()

    status, body, generated, ctx = asyncio.run(main())
    assert status == 200 and generated > 0
    assert (f'langstream_serving_tokens_generated_total{{agent_id="tiny"}} '
            f'{float(generated)}') in body
    assert 'langstream_serving_requests_completed_total{agent_id="tiny"} 1.0' in body
    assert f'# {{trace_id="{ctx.trace_id}"}}' in body
    assert port_metrics.render_metrics() == b"# no metrics registered yet\n"
