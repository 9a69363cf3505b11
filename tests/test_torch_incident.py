"""The port's incident capture plane (``langstream_tpu_torch/serving/
incident.py`` and the engine's triggers) against the JAX package's.

Exact throughout (no floating point but timings, which only order):

- the recorder's cooldown, dedup and suppression, write-then-rename,
  reload and eviction equal the JAX recorder's for the same sequence, and
  the files are name for name and key for key the same;
- a bundle directory written by either package is re-indexed by the other;
- ``breaker_storm``, ``adapter_eviction_storm`` and ``worst_journeys``
  equal the JAX functions on the same tails and ledgers;
- the JAX chaos-breach workload captures one ``shrink-pressure`` bundle on
  the port, with the JAX bundle's keys and trigger; an SLO fast burn
  captures ``slo-fast-burn`` on both engines;
- an engine whose ``incident-dir`` is unset or ``""`` has no ``incidents``
  key;
- the pod's ``/incidents`` lists a port engine's bundles through
  ``serve_torch.register``.
"""

import asyncio
import json
import socket
import types

import numpy as np
import pytest

from langstream_tpu.serving import incident as jax_incident
from langstream_tpu.serving import journey as jax_journey
from langstream_tpu_torch.serving import incident, journey
from langstream_tpu_torch.serving import engine as port_engine_module
from langstream_tpu_torch.serving.incident import (
    IncidentRecorder,
    adapter_eviction_storm,
    breaker_storm,
    worst_journeys,
)
from test_torch_journey import both, ledger_of

BASE = {"model": "tiny", "slots": 4, "max-seq-len": 192, "model-dtype": "float32",
        "kv-layout": "paged", "kv-block-size": 16, "decode-chunk": 4, "max-tokens": 24,
        "shrink-recovery-s": 0.3}


@pytest.fixture(autouse=True)
def _unmirrored(monkeypatch):
    monkeypatch.setattr(journey.JOURNEYS, "mirror", None)


def _recorders(tmp_path, **kw):
    return (IncidentRecorder(str(tmp_path / "port"), **kw),
            jax_incident.IncidentRecorder(str(tmp_path / "jax"), **kw))


def _bundle(kind="health-degraded", **extra):
    return {"trigger": {"kind": kind, "reasons": ["r1"]}, "captured_at_ms": 1.0,
            "events": [{"kind": "x", "seq": 1}], "worst_journeys": [], **extra}


def test_vocabulary_equals_jax():
    assert incident.TRIGGER_KINDS == jax_incident.TRIGGER_KINDS
    assert incident.OFFENDING_SEGMENT == jax_incident.OFFENDING_SEGMENT
    assert set(incident.OFFENDING_SEGMENT) == set(incident.TRIGGER_KINDS)


def test_cooldown_dedup_and_suppression_equal_jax(tmp_path):
    port, jax = _recorders(tmp_path, cooldown_s=60.0)
    script = [("health-degraded", None), ("health-degraded", None), ("tbt-burn", "a"),
              ("tbt-burn", "b"), ("tbt-burn", "b"), ("slo-fast-burn", "ttft"),
              ("slo-fast-burn", "ttft"), ("breaker-storm", None)]
    try:
        for kind, key in script:
            assert port.should_capture(kind, key) == jax.should_capture(kind, key)
        assert port.suppressed == jax.suppressed == {
            "health-degraded": 1, "tbt-burn": 1, "slo-fast-burn": 1}
    finally:
        port.close()
        jax.close()
    assert not port.should_capture("health-degraded")


def test_write_rename_reload_and_files_equal_jax(tmp_path):
    port, jax = _recorders(tmp_path)
    ids = []
    for rec in (port, jax):
        ids.append([rec.submit(_bundle()), rec.submit(_bundle("breaker-storm"))])
        assert rec.flush()
        rec.close()
    assert ids[0] == ids[1] == ["incident-000001-health-degraded",
                                "incident-000002-breaker-storm"]
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in port_files:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    assert not list(tmp_path.glob("*/*.tmp.*"))
    again = IncidentRecorder(str(tmp_path / "port"))
    try:
        assert [b["id"] for b in again.list()] == ids[0]
        assert again.submit(_bundle("tbt-burn")) == "incident-000003-tbt-burn"
        assert again.flush()
    finally:
        again.close()


def test_eviction_equals_jax(tmp_path):
    evicted = {"port": [], "jax": []}
    port = IncidentRecorder(str(tmp_path / "port"), max_bundles=2,
                            on_evict=evicted["port"].append)
    jax = jax_incident.IncidentRecorder(str(tmp_path / "jax"), max_bundles=2,
                                        on_evict=evicted["jax"].append)
    try:
        for rec in (port, jax):
            for i in range(3):
                assert rec.should_capture("slo-fast-burn", dedup_key=f"o{i}")
                rec.submit(_bundle("slo-fast-burn"))
            assert rec.flush()
        stats = [{k: v for k, v in r.stats().items() if k != "dir"} for r in (port, jax)]
        assert stats[0] == stats[1]
        assert stats[0]["live"] == 2 and stats[0]["evicted"] == 1
        assert evicted["port"] == evicted["jax"] == ["incident-000001-slo-fast-burn"]
        assert [b["id"] for b in port.list()] == [b["id"] for b in jax.list()]
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_bundle_directory_crosses_packages(tmp_path, writer):
    make = {"jax": jax_incident.IncidentRecorder, "port": IncidentRecorder}
    reader = "port" if writer == "jax" else "jax"
    first = make[writer](str(tmp_path), max_bundles=3)
    for kind in ("health-wedged", "adapter-storm"):
        first.submit(_bundle(kind))
    assert first.flush()
    first.close()
    second = make[reader](str(tmp_path), max_bundles=3)
    try:
        assert second.list() == first.list()
        assert second.get("incident-000002-adapter-storm")["trigger"]["kind"] == "adapter-storm"
        assert second.submit(_bundle()) == "incident-000003-health-degraded"
        assert second.flush()
    finally:
        second.close()
    third = make[writer](str(tmp_path), max_bundles=2)  # the bound applies on reload
    try:
        assert [b["id"] for b in third.list()] == ["incident-000002-adapter-storm",
                                                   "incident-000003-health-degraded"]
    finally:
        third.close()


@pytest.mark.parametrize("seed", range(6))
def test_storm_predicates_equal_jax_on_the_same_tails(seed):
    rng = np.random.default_rng(seed)
    now = 1000.0
    tail = []
    for i in range(40):
        kind = ["breaker-open", "breaker-close", "adapter-evict", "drain"][int(rng.integers(4))]
        event = {"kind": kind, "seq": i, "m_s": now - float(rng.integers(0, 60))}
        if kind.startswith("breaker"):
            event["replica"] = f"r{int(rng.integers(4))}"
        if kind == "adapter-evict":
            event["adapter"] = f"a{int(rng.integers(3))}"
        if rng.random() < 0.05:
            event["m_s"] = None
        tail.append(event)
    for k, window in ((2, 10.0), (3, 30.0), (5, 60.0)):
        assert breaker_storm(tail, now, k, window) == jax_incident.breaker_storm(
            tail, now, k, window)
        assert adapter_eviction_storm(tail, now, k, window) == \
            jax_incident.adapter_eviction_storm(tail, now, k, window)
    assert breaker_storm(tail, now, k=1, window_s=60.0) is not None


def test_worst_journeys_equal_jax_on_the_same_ledger(monkeypatch):
    rng = np.random.default_rng(3)
    chain = ["submit", "admit", "first-token", "first-emit", "last-emit", "finish"]
    ledger = {}
    for j in range(6):
        t = float(rng.integers(0, 1000))
        events = []
        for kind in chain:
            t += float(rng.integers(1, 500))
            events.append({"seq": len(events), "t_ms": t, "m_s": t / 1e3, "kind": kind})
        ledger[f"j{j}"] = events
    fake = types.SimpleNamespace(ids=lambda: list(ledger), events=lambda j: list(ledger[j]))
    monkeypatch.setattr(journey, "JOURNEYS", fake)
    monkeypatch.setattr(jax_journey, "JOURNEYS", fake)
    for kind in incident.TRIGGER_KINDS:
        for k in (1, 3, 10):
            assert worst_journeys(kind, k) == jax_incident.worst_journeys(kind, k)
    top = worst_journeys("tbt-burn", 1)[0]
    assert top["offending_segment"] == "stream" and top["offending_ms"] > 0


def test_chaos_breach_captures_one_bundle_with_the_jax_keys(tmp_path):
    """The JAX chaos-breach workload (two allocator faults at the pool-grow
    seam inside one recovery window) on both engines: health goes degraded
    with the memory-pressure reason and exactly one ``shrink-pressure``
    bundle is captured; a second breach inside the cooldown is suppressed."""
    def cfg(package):
        return {**BASE, "incident-dir": str(tmp_path / package), "shrink-recovery-s": 5.0,
                "faults": [{"site": "pool-grow", "after": 3, "count": 2}]}

    async def breach(engine):
        outs = await asyncio.gather(*(
            engine.generate(f"chaos request {i} says hello", {"max-tokens": 16,
                                                               "temperature": 0})
            for i in range(6)))
        health = engine.health()
        engine._incident_capture("shrink-pressure", {"source": "second-breach"})
        stats = engine.incidents.stats()
        assert engine.incidents.flush()
        index = engine.incidents.list()
        bundle = engine.incidents.get(index[-1]["id"])
        return ([o["tokens"] for o in outs], health["state"], stats["captured"],
                stats["suppressed"], [b["id"] for b in index], bundle)

    want, got, _ = both(cfg("port"), breach, jax_cfg=cfg("jax"))
    assert got[:5] == want[:5]
    tokens, state, captured, suppressed, ids, bundle = got
    assert state == "degraded" and captured == 1 and suppressed == {"shrink-pressure": 1}
    assert ids == ["incident-000001-shrink-pressure"]
    jax_bundle = want[5]
    assert set(bundle) == set(jax_bundle)
    assert set(bundle["trigger"]) == set(jax_bundle["trigger"])
    assert bundle["trigger"]["kind"] == "shrink-pressure"
    assert any("memory pressure" in r for r in bundle["trigger"]["reasons"])
    assert set(bundle["config"]) == set(jax_bundle["config"])
    assert set(bundle["survival"]) == set(jax_bundle["survival"])
    assert set(bundle["kvtransfer"]) == set(jax_bundle["kvtransfer"])
    tail = [e["kind"] for e in bundle["events"]]
    assert tail.index("fault-injected") < tail.index("pool-shrink")
    assert bundle["worst_journeys"] and all(
        j["offending_segment"] == "decode" for j in bundle["worst_journeys"])
    on_disk = json.loads((tmp_path / "port" / f"{ids[0]}.json").read_text())
    assert on_disk["id"] == ids[0] and set(on_disk) == set(jax_bundle)


def test_slo_fast_burn_captures_on_both_engines(tmp_path):
    slo = {"objectives": {"ttft": {"target": 0.9, "threshold-ms": 0.001}},
           "fast-window-s": 60, "slow-window-s": 120, "fast-burn": 2}

    def cfg(package):
        return {**BASE, "slo": slo, "incident-dir": str(tmp_path / package)}

    async def burn(engine):
        await asyncio.gather(*(engine.generate(f"slow {i}", {"max-tokens": 4})
                               for i in range(3)))
        assert engine.incidents.flush()
        index = engine.incidents.list()
        return [b["id"] for b in index], engine.incidents.get(index[0]["id"])["trigger"]

    want, got, _ = both(cfg("port"), burn, jax_cfg=cfg("jax"))
    assert got[0] == want[0] == ["incident-000001-slo-fast-burn"]
    assert set(got[1]) == set(want[1])
    assert got[1]["objective"] == "ttft" and got[1]["source"] == "slo"


@pytest.mark.parametrize("incident_dir", [None, ""])
def test_no_incident_dir_no_incidents_key(incident_dir):
    cfg = {**BASE, **({} if incident_dir is None else {"incident-dir": incident_dir})}

    async def serve(engine):
        await engine.generate("no capture plane", {"max-tokens": 3})
        engine._incident_capture("health-degraded", {"source": "test"})
        return "incidents" in engine.stats(), engine.incidents is None

    want, got, _ = both(cfg, serve)
    assert got == want == (False, True)
    assert port_engine_module.incident_report() == []


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pod_incidents_list_a_port_engine_through_the_launcher(tmp_path, monkeypatch):
    import aiohttp

    import serve_torch
    from langstream_tpu.agents import services
    from langstream_tpu.k8s import operator as k8s_operator
    from langstream_tpu.runtime import pod
    from langstream_tpu.serving import engine as jax_engine
    from langstream_tpu.serving.engine import TpuServingEngine
    from langstream_tpu_torch.core import metrics as port_metrics
    from langstream_tpu_torch.core.tracing import SPANS
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    for name in serve_torch.POD_SEAM:
        monkeypatch.setattr(jax_engine, name, getattr(jax_engine, name))
    for name in serve_torch.SLICE_SEAM:
        monkeypatch.setattr(pod, name, getattr(pod, name))
    for name in serve_torch.OPERATOR_SEAM:
        monkeypatch.setattr(k8s_operator, name, getattr(k8s_operator, name))
    monkeypatch.setattr(services, "_provider_factories", dict(services._provider_factories))
    monkeypatch.setattr(SPANS, "mirror", SPANS.mirror)
    monkeypatch.setattr(port_metrics, "REPORTER", port_metrics.REPORTER)
    monkeypatch.setattr(TpuServingEngine, "_instances", {})
    monkeypatch.setattr(TorchServingEngine, "_instances", {})
    serve_torch.register(device="cpu")
    monkeypatch.setenv("LS_HTTP_PORT", str(_free_port()))

    async def main():
        engine = TorchServingEngine.get_or_create(ServingConfig.from_dict(
            {**BASE, "incident-dir": str(tmp_path / "incidents")}), device="cpu")
        server = await pod._serve_info(None, health=pod.PodHealth())
        base = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}"
        try:
            await engine.generate("incident endpoint probe", {"max-tokens": 6})
            engine._incident_capture("health-degraded", {"source": "test",
                                                         "reasons": ["probe"]})
            assert engine.incidents.flush()
            (bid,) = [b["id"] for b in engine.incidents.list()]
            async with aiohttp.ClientSession() as session:
                async with session.get(f"{base}/incidents") as resp:
                    index = (resp.status, await resp.json())
                async with session.get(f"{base}/incidents/{bid}") as resp:
                    detail = (resp.status, await resp.json())
                async with session.get(f"{base}/incidents/no-such-bundle") as resp:
                    missing = resp.status
                async with session.get(f"{base}/flight/summary") as resp:
                    summary = await resp.json()
            journeys = [j for j in ledger_of(engine).ids()]
            return bid, index, detail, missing, summary, journeys
        finally:
            server.close()
            TorchServingEngine.reset_instances()
            await engine.close()

    bid, index, detail, missing, summary, journeys = asyncio.run(main())
    assert index[0] == 200
    (entry,) = index[1]
    assert entry["model"] == "tiny" and [b["id"] for b in entry["incidents"]] == [bid]
    assert entry["incidents"][0]["kind"] == "health-degraded"
    assert detail[0] == 200 and detail[1][0]["bundle"]["trigger"]["reasons"] == ["probe"]
    assert detail[1][0]["bundle"]["worst_journeys"]
    assert missing == 404
    (flight,) = summary
    assert flight["incidents"]["live"] == 1 and flight["incidents"]["recent"][0]["id"] == bid
    assert journeys
