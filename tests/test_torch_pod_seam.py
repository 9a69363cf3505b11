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

    for name in serve_torch.POD_SEAM:
        monkeypatch.setattr(jax_engine, name, getattr(jax_engine, name))
    monkeypatch.setattr(services, "_provider_factories", dict(services._provider_factories))
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
    """The JAX engine arms fault plans from ``LS_TPU_FAULTS``: a chaos run
    whose faults fail to arm must not pass quietly on the port."""
    monkeypatch.setenv("LS_TPU_FAULTS", value)
    with pytest.raises(NotImplementedError, match="LS_TPU_FAULTS.*item 9"):
        TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu")


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
