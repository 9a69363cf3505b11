"""The port's flight recorder (``langstream_tpu_torch/serving/flight.py``)
against the JAX package's: the same ``sample`` / ``stall`` / ``event``
calls on the same clock give equal ``summary()``, ``bench_rollup()``,
``recent()`` and ``recent_events()``. The clock steps in whole
milliseconds, so the wall decomposition is checked for exact equality."""

import types

import pytest

from langstream_tpu.serving import flight as jax_flight
from langstream_tpu_torch.serving import flight as port_flight


class Clock:
    """A stand-in for the ``time`` module: monotonic and wall clocks that
    move only when told, in whole milliseconds."""

    def __init__(self):
        self.ms = 5_000_000

    def advance(self, ms: int) -> None:
        self.ms += ms

    def module(self):
        return types.SimpleNamespace(
            monotonic=lambda: self.ms / 1000.0,
            time=lambda: 1_700_000_000.0 + self.ms / 1000.0,
        )


# (milliseconds to advance, method, positional args, keyword args)
SCRIPT = [
    (20, "sample", ("prefill",), dict(
        device_s=0.005, tokens=2, occupancy=2, queue_depth=3,
        stall="no-free-slot", kv_used=0.25, prefix_hits=1,
        program="prefill:p32:b2:greedy")),
    (30, "sample", ("decode",), dict(
        device_s=0.010, overlapped_s=0.012, tokens=16, occupancy=4,
        queue_depth=1, kv_used=0.5, program="decode:w128:k8:greedy")),
    (0, "event", ("pool-grow",), dict(slots=2, blocks=3, bytes=96, phase="decode")),
    # the overlap credit is clamped to what the wait leaves of the wall
    (25, "sample", ("decode",), dict(device_s=0.015, overlapped_s=0.020, tokens=16,
                                     program="decode:w128:k8:greedy")),
    (15, "stall", ("queue-empty",), dict(occupancy=0, queue_depth=0)),
    (40, "sample", ("verify",), dict(
        device_s=0.008, tokens=9, spec_accepted=5, spec_rejected=3,
        program="specstep:nrb2:d4:greedy")),
    (0, "event", ("preempt",), dict(error="RuntimeError: boom", inflight=2)),
    (10, "stall", ("no-kv-blocks",), dict(occupancy=3, queue_depth=2, kv_used=1.0)),
    # a wait longer than the wall is clamped to it
    (12, "sample", ("decode",), dict(device_s=999.0, tokens=8)),
    (7, "sample", ("decode",), dict(device_s=0.002, overlapped_s=0.003, tokens=8,
                                    stall="prefill-in-flight")),
]


def replay(module, monkeypatch, maxlen=None):
    clock = Clock()
    monkeypatch.setattr(module, "time", clock.module())
    recorder = module.FlightRecorder(slots=4, maxlen=maxlen)
    for advance, method, args, kwargs in SCRIPT:
        clock.advance(advance)
        getattr(recorder, method)(*args, **kwargs)
    return recorder


@pytest.mark.parametrize("maxlen", [None, 4], ids=["ring-4096", "ring-4-evicting"])
def test_flight_recorder_matches_jax(monkeypatch, maxlen):
    port = replay(port_flight, monkeypatch, maxlen)
    ref = replay(jax_flight, monkeypatch, maxlen)
    assert port.summary() == ref.summary()
    assert port_flight.bench_rollup(port.summary()) == jax_flight.bench_rollup(ref.summary())
    assert port.recent(0) == ref.recent(0)
    assert port.recent_events(0) == ref.recent_events(0)
    assert port.dropped == ref.dropped == (4 if maxlen == 4 else 0)


def test_wall_decomposes_exactly_and_overlap_is_clamped(monkeypatch):
    recorder = replay(port_flight, monkeypatch)
    samples = recorder.recent(0)
    for s in samples:
        assert s["wall_ms"] == s["device_ms"] + s["host_ms"] + (
            s["wall_ms"] if s["phase"] == "stall" else 0.0)
        assert 0.0 <= s["host_overlapped_ms"] <= s["device_ms"] <= s["wall_ms"]
    totals = recorder.summary()["totals"]
    assert totals["wall_ms"] == totals["device_ms"] + totals["host_ms"] + totals["stall_ms"]
    assert totals["wall_ms"] == sum(a for a, *_ in SCRIPT)
    assert totals["host_overlapped_ms"] <= totals["device_ms"]
    # the third sample: 25 ms of wall, a 15 ms wait, 20 ms of overlap
    # claimed, 10 credited; the clamped one: 12 ms of wall, all device
    clamped, overrun = samples[2], samples[6]
    assert (clamped["device_ms"], clamped["host_overlapped_ms"], clamped["host_ms"]) == (
        25.0, 10.0, 0.0)
    assert (overrun["wall_ms"], overrun["device_ms"], overrun["host_ms"]) == (12.0, 12.0, 0.0)
    assert totals["stall_s_by_reason"] == {"queue-empty": 0.015, "no-kv-blocks": 0.01}
    assert set(totals["blocked_s_by_reason"]) == {"no-free-slot", "prefill-in-flight"}


@pytest.mark.parametrize("value,capacity", [("100", 100), ("10", 64), ("junk", 4096)])
def test_buffer_size_env_as_jax(monkeypatch, value, capacity):
    monkeypatch.setenv("LS_TPU_FLIGHT_BUFFER", value)
    assert port_flight.FlightRecorder().capacity == capacity
    assert jax_flight.FlightRecorder().capacity == capacity
