"""The health plane of the port against the JAX package's.

``EngineWatchdog``, the degradation predicates and ``SloTracker`` give the
JAX package's verdicts on the same sequences under one fake clock;
``SloSpec`` parses, validates and round-trips as there. The engine's
``stats()["health"]`` and ``stats()["slo"]`` carry the JAX engine's keys,
an objective's fast burn lands as an ``alert`` event, a class's
``tbt-p99-s`` burn degrades ``health()``, and a dispatch that blocks makes
``health()`` and :func:`health_report` report the engine ``wedged`` within
``wedge-window-s``, then ``ok`` again once it returns.
"""

import asyncio
import json
import threading
import time

import pytest

from langstream_tpu.serving import health as jax_health
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.serving import health
from langstream_tpu_torch.serving.engine import (
    ServingConfig,
    TorchServingEngine,
    health_report,
)

PACKAGES = {"port": health, "jax": jax_health}


class _Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------------------------
# watchdog and predicates, under one fake clock
# ---------------------------------------------------------------------------


def _watchdog_trace(h):
    clock = _Clock()
    wd = h.EngineWatchdog(wedge_window_s=5.0, clock=clock)
    hot = [{"kv_used": 0.99} for _ in range(10)]
    collapsed = [{"phase": "decode", "host_overlapped_ms": 0.0, "host_ms": 10.0,
                  "occupancy": 7, "slots": 8} for _ in range(12)]
    storm = [{"kind": "recompile", "m_s": t} for t in (100.0, 100.5, 101.0)]
    shrinks = [{"kind": "pool-shrink", "m_s": t, "recovery_s": 30.0} for t in (90.0, 100.0)]
    trace = [wd.evaluate(queued=0, occupancy=0)]
    for t in (1.0, 2.0, 3.0):
        clock.t = t
        wd.beat(queue_depth=2)
    for t, kw in (
        (7.0, {"queued": 2, "occupancy": 1}),
        (9.5, {"queued": 2, "occupancy": 1}),
        (10.0, {"queued": 2, "occupancy": 1}),
        (10.0, {"queued": 0, "occupancy": 0, "stopped": True}),
    ):
        clock.t = t
        trace.append(wd.evaluate(**kw))
    wd.beat(queue_depth=0)
    for kw in ({"samples": hot}, {"samples": collapsed}, {"events": storm},
               {"events": shrinks}, {"extra_reasons": ("tbt burn-rate alert: x",)}, {}):
        clock.t = 105.0
        wd.beat(queue_depth=0)
        trace.append(wd.evaluate(queued=0, occupancy=0, **kw))
    clock.t = 3600.0  # idle for an hour: not wedged
    trace.append(wd.evaluate(queued=0, occupancy=0))
    wd.queue_at_stamp = 3
    trace.append(wd.evaluate(queued=0, occupancy=0))
    return trace, wd.transitions


def test_watchdog_verdicts_match_jax():
    port, jax = _watchdog_trace(health), _watchdog_trace(jax_health)
    assert port == jax
    states = [v["state"] for v in port[0]]
    assert {"ok", "degraded", "wedged"} <= set(states)


@pytest.mark.parametrize("case", range(6))
def test_predicates_match_jax(case):
    samples = [
        [{"kv_used": 0.99} for _ in range(10)],
        [{"kv_used": 0.5 + 0.05 * (i % 10)} for i in range(40)],
        [{"phase": "decode", "host_overlapped_ms": 0.0, "host_ms": 10.0,
          "occupancy": 7, "slots": 8} for _ in range(12)],
        [{"phase": "decode", "host_overlapped_ms": 9.0, "host_ms": 1.0,
          "occupancy": 7, "slots": 8} for _ in range(12)],
        [{"phase": "decode", "host_ms": 10.0, "occupancy": 7, "slots": 8}] * 12,
        [],
    ][case]
    events = [
        [{"kind": "recompile", "m_s": t} for t in (100.0, 100.5, 101.0)],
        [{"kind": "recompile", "m_s": t} for t in (10.0, 50.0, 100.0)],
        [{"kind": "pool-shrink", "m_s": t, "recovery_s": 20.0} for t in (95.0, 105.0)],
        [{"kind": "pool-shrink", "m_s": 10.0}],
        [{"kind": "recompile"}] * 5,
        [],
    ][case]
    for fn in ("kv_saturation", "overlap_collapse"):
        assert getattr(health, fn)(samples) == getattr(jax_health, fn)(samples)
    for fn in ("recompile_storm", "shrink_pressure"):
        for now in (106.0, 1000.0):
            assert getattr(health, fn)(events, now) == getattr(jax_health, fn)(events, now)
    states = [["ok"], ["ok", "degraded"], ["wedged", "ok"], ["garbage"], [], ["degraded"]][case]
    assert health.worst_state(states) == jax_health.worst_state(states)


# ---------------------------------------------------------------------------
# SLO spec and tracker
# ---------------------------------------------------------------------------

GOOD_SLO = {
    "objectives": {"ttft": {"target": 0.99, "threshold-ms": 2000},
                   "queue-wait": {"target": 0.9, "threshold-ms": 500},
                   "shed-rate": {"target": 0.95}, "tbt": {"target": 0.99, "threshold-ms": 80},
                   "availability": {"target": 0.999}},
    "fast-window-s": 60, "slow-window-s": 600, "fast-burn": 6,
}


@pytest.mark.parametrize(
    "bad",
    [
        {"objectives": {}},
        {"objectives": {"latency": {"target": 0.99}}},
        {"objectives": {"ttft": {"target": 1.5, "threshold-ms": 100}}},
        {"objectives": {"ttft": {"target": 0.99}}},
        {"objectives": {"ttft": {"target": 0.99, "threshold-ms": 0}}},
        {"objectives": {"availability": {"target": 0.99, "threshold-ms": 5}}},
        {"objectives": {"availability": {}}},
        {"objectives": {"availability": {"target": 0.99}}, "fast-window-s": 600,
         "slow-window-s": 60},
        {"objectives": {"availability": {"target": 0.99}}, "fast-burn": 0.5},
        "fast",
    ],
)
def test_malformed_slo_specs_rejected_as_in_jax(bad):
    with pytest.raises(ValueError) as jax_err:
        jax_health.SloSpec.from_dict(bad)
    with pytest.raises(ValueError) as port_err:
        health.SloSpec.from_dict(bad)
    assert str(port_err.value) == str(jax_err.value)


def test_slo_spec_round_trips_and_rides_the_config():
    port = health.SloSpec.from_dict(GOOD_SLO)
    assert port.to_dict() == jax_health.SloSpec.from_dict(GOOD_SLO).to_dict()
    assert health.SloSpec.from_dict(port.to_dict()) == port
    config = ServingConfig.from_dict({"model": "tiny", "slo": GOOD_SLO, "wedge-window-s": 12,
                                      "qos": {}, "streaming": "true"})
    assert config.slo == port and config.wedge_window_s == 12.0 and config.streaming
    jax_config = JaxServingConfig.from_dict({"model": "tiny", "slo": GOOD_SLO,
                                             "wedge-window-s": 12, "qos": {}})
    assert config.slo.to_dict() == jax_config.slo.to_dict()
    assert config.qos.to_dict() == jax_config.qos.to_dict()
    hash(config)  # engines are shared by config


def _tracker_trace(h):
    clock = _Clock(1000.0)
    tracker = h.SloTracker(h.SloSpec.from_dict(GOOD_SLO), clock=clock)
    trace = []
    for i in range(100):
        trace.append(tracker.record("availability", good=i % 10 != 0))
        trace.append(tracker.record_latency("ttft", 100.0 * (i % 30)))
        trace.append(tracker.record_latency("tbt", 50.0 + i))
        trace.append(tracker.record("shed-rate", good=i % 3 != 0))
        if i % 25 == 0:
            clock.t += 40.0
            trace.append(tracker.status())
    trace += [tracker.record("queue-wait", True), tracker.record_latency("shed-rate", 5.0),
              tracker.record("bogus", False)]
    clock.t += 700.0
    trace.append(tracker.status())
    trace.append(tracker.record("availability", good=True))
    return trace, tracker.totals, tracker.alerting


def test_slo_tracker_verdicts_match_jax():
    port, jax = _tracker_trace(health), _tracker_trace(jax_health)
    assert port == jax
    assert any(v and v.get("transition") for v in port[0] if isinstance(v, dict))
    json.dumps(port[0][-2])


# ---------------------------------------------------------------------------
# the engine's sections
# ---------------------------------------------------------------------------

TINY = {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 64,
        "decode-chunk": 4}
ENGINE_SLO = {"objectives": {"ttft": {"target": 0.5, "threshold-ms": 60000},
                             "availability": {"target": 0.5},
                             "shed-rate": {"target": 0.5}},
              "fast-burn": 1.5}


def _keys(tree):
    """The nested key structure of a dict (values dropped)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


@pytest.mark.parametrize("streaming", [False, True])
def test_health_and_slo_sections_carry_the_jax_keys(streaming):
    cfg = {**TINY, "slo": ENGINE_SLO, "streaming": streaming,
           "qos": {"classes": {"interactive": {"tbt-p99-s": 0.5}}}}
    out = {}
    for name, make in (
        ("jax", lambda: TpuServingEngine(JaxServingConfig.from_dict(cfg))),
        ("port", lambda: TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")),
    ):
        engine = make()

        async def main(engine=engine):
            try:
                await engine.generate("slo probe", {"max-tokens": 4},
                                      on_chunk=lambda *a: None)
                stats = engine.stats()
                for _ in range(10):
                    engine._slo_record("availability", False)
                alerts = [e for e in engine.flight.recent_events(0) if e["kind"] == "alert"]
                return stats, engine.stats()["slo"], alerts
            finally:
                await engine.close()

        out[name] = asyncio.run(main())
    (jax_stats, jax_slo, jax_alerts), (stats, slo, alerts) = out["jax"], out["port"]
    assert _keys(stats["health"]) == _keys(jax_stats["health"])
    assert _keys(stats["slo"]) == _keys(jax_stats["slo"])
    assert _keys(stats["scheduler"]) == _keys(jax_stats["scheduler"])
    assert ("streaming" in stats) == ("streaming" in jax_stats) == streaming
    if streaming:
        assert _keys(stats["streaming"]) == _keys(jax_stats["streaming"])
        assert stats["health"]["tbt_burn"] == []
    h = stats["health"]
    assert h["state"] == "ok" and h["ready"] and h["warmup"] == "not-required"
    assert stats["slo"]["objectives"]["availability"]["window_good"] >= 1
    assert stats["slo"]["objectives"]["shed-rate"]["window_good"] >= 1
    assert stats["slo"]["objectives"]["ttft"]["total_good"] >= 1
    assert stats["slo"]["alerting"] == jax_stats["slo"]["alerting"] == []
    assert slo["alerting"] == jax_slo["alerting"] == ["availability"]
    assert [(a["objective"], a["state"]) for a in alerts] == [
        (a["objective"], a["state"]) for a in jax_alerts] == [("availability", "firing")]


def test_tbt_burn_degrades_health_as_in_jax():
    qos = {"classes": {"interactive": {"weight": 4, "tbt-p99-s": 0.05},
                       "batch": {"weight": 1}}}
    cfg = {**TINY, "streaming": True, "qos": qos}
    out = {}
    for name, engine in (
        ("jax", TpuServingEngine(JaxServingConfig.from_dict(cfg))),
        ("port", TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")),
    ):
        assert set(engine._stream_slo) == {"interactive"}
        thresholds = (engine._stream_stall_threshold("interactive"),
                      engine._stream_stall_threshold("batch"))
        before = engine.health()
        tracker = engine._stream_slo["interactive"]
        for _ in range(20):
            tracker.record_latency("tbt", 500.0)
        after = engine.health()
        out[name] = (thresholds, before["state"], before["tbt_burn"], after["state"],
                     after["tbt_burn"], after["reasons"])
        asyncio.run(engine.close())
    assert out["port"] == out["jax"]
    assert out["port"][0] == (0.05, 2.0)
    assert out["port"][3] == "degraded" and out["port"][4] == ["interactive"]


def test_blocked_dispatch_reports_wedged_then_recovers():
    """A prefill that blocks on the dispatch thread stops the heartbeat
    while a request is in flight: within ``wedge-window-s`` ``health()``
    and :func:`health_report` say ``wedged`` (answered while the dispatch
    is stuck), with a ``health`` event carrying the stall evidence; once
    the dispatch returns the request completes and the state is ``ok``."""
    cfg = ServingConfig.from_dict({**TINY, "wedge-window-s": 0.3})
    engine = TorchServingEngine.get_or_create(cfg, device="cpu")
    gate = threading.Event()
    real = engine._run_prefill
    blocked = []

    def blocking_prefill(*args, **kwargs):
        if not blocked:
            blocked.append(True)
            gate.wait(timeout=30)
        return real(*args, **kwargs)

    async def main():
        try:
            await engine.generate("healthy probe", {"max-tokens": 2})
            assert engine.health()["state"] == "ok"
            engine._run_prefill = blocking_prefill
            stuck = asyncio.ensure_future(engine.generate("stuck request", {"max-tokens": 2}))
            t0 = time.monotonic()
            state = "ok"
            while time.monotonic() - t0 < 10:
                state = engine.health()["state"]
                if state == "wedged":
                    break
                await asyncio.sleep(0.05)
            waited = time.monotonic() - t0
            report = [e for e in health_report() if e["model"] == "tiny"]
            gate.set()
            result = await asyncio.wait_for(stuck, timeout=60)
            recovered = engine.health()
            events = [e for e in engine.flight.recent_events(0) if e["kind"] == "health"]
            return state, waited, report, result, recovered, events
        finally:
            gate.set()
            TorchServingEngine.reset_instances()
            await engine.close()

    state, waited, report, result, recovered, events = asyncio.run(main())
    assert state == "wedged" and waited < 5.0
    assert any(e["state"] == "wedged" and not e["ready"] for e in report)
    assert result["tokens"]
    assert recovered["state"] == "ok"
    wedged = next(e for e in events if e["state"] == "wedged")
    assert "no step progress" in wedged["reasons"][0]
    assert wedged["last_step_age_s"] > 0.3 and wedged["queued"] + wedged["occupancy"] >= 1
    assert events[-1]["state"] == "ok" and events[-1]["previous"] == "wedged"
