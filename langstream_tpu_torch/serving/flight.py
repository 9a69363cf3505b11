"""Engine flight recorder (port of ``langstream_tpu/serving/flight.py``,
pure Python, carried over rather than imported: importing the JAX package
loads JAX).

One :class:`FlightRecorder` per engine. The engine loop records a
**sample** per dispatched decode/prefill/verify burst and a **stall**
sample for every idle gap, so the samples tile the loop's timeline:

- ``wall_ms``: time since the previous recorded boundary;
- ``device_ms``: the blocked device wait (the chunk's fetch) plus
  ``host_overlapped_ms``, host work the pipelined loop ran while a later
  chunk was still executing on the card. Host time hidden behind device
  work is credited to the device share and reported on its own;
- ``host_ms``: ``wall - device``, the *exposed* host time;
- ``stall``: why queued work is not admitted at this boundary
  (``no-free-slot`` / ``no-kv-blocks`` / ``prefill-in-flight`` /
  ``queue-empty``), with occupancy, queue depth, tokens, KV-pool use and
  prefix hits.

The rollup therefore decomposes total wall time exactly into ``device +
host + stall``. ``stall_s_by_reason`` (idle time) and
``blocked_s_by_reason`` (busy wall during which queued work waited) are
kept apart, so a saturated engine never reads as stalled. Discrete
**events** (``pool-grow``, ``preempt``, ...) ride a second, smaller ring.

The record path appends to deques and bumps counters only: no locks, no
I/O, nothing that can block the engine loop; readers snapshot with
``list(deque)``. Ring size: ``LS_TPU_FLIGHT_BUFFER`` samples (default
4096, min 64); the totals are plain counters kept beside the ring, so the
rollup stays exact after the ring starts evicting. ``summary()`` is what a
pod's ``/flight/summary`` serves for the JAX engine.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Any

#: admission-stall reasons a sample may carry (the attribution vocabulary)
STALL_REASONS = (
    "no-free-slot",
    "no-kv-blocks",
    "prefill-in-flight",
    "queue-empty",
)

#: dispatch phases (a "stall" sample is the fifth, non-dispatch kind)
PHASES = ("prefill", "decode", "verify")


def _buffer_size() -> int:
    try:
        return max(64, int(os.environ.get("LS_TPU_FLIGHT_BUFFER", "4096")))
    except ValueError:
        return 4096


def _pct(sorted_values: list, q: float):
    """Nearest-rank percentile of an already-sorted list (None when empty)."""
    if not sorted_values:
        return None
    return sorted_values[min(len(sorted_values) - 1, int(q * len(sorted_values)))]


class FlightRecorder:
    """Bounded per-engine telemetry ring. Single writer (the engine loop;
    events may also arrive from the dispatch thread), many readers."""

    def __init__(self, slots: int = 0, maxlen: int | None = None):
        self.slots = slots
        self.capacity = maxlen if maxlen is not None else _buffer_size()
        self._samples: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self._events: deque[dict[str, Any]] = deque(maxlen=512)
        self._seq = 0
        self._event_seq = 0
        self._last_mark = time.monotonic()
        # cumulative counters: exact over the engine's whole life, immune
        # to ring eviction (plain attributes — engine loop is the only
        # sample writer, and CPython attribute updates don't interleave)
        self.recorded = 0
        self.wall_ms = 0.0
        self.device_ms = 0.0
        self.host_ms = 0.0
        self.host_overlapped_ms = 0.0
        self.stall_ms = 0.0
        self.tokens = 0
        self.recompiles = 0
        self.steps_by_phase: dict[str, int] = {}
        # two distinct attributions (they must not be conflated, or a
        # saturated engine reads as 100% stalled):
        # - stall_s_by_reason: engine-loop STALL time (stall samples only)
        #   — decomposes totals.stall_ms exactly;
        # - blocked_s_by_reason: wall time of dispatch samples annotated
        #   with an admission-stall reason — the engine was BUSY, but
        #   queued work waited that long for that reason (queue pressure)
        self.stall_s_by_reason: dict[str, float] = {}
        self.blocked_s_by_reason: dict[str, float] = {}
        self.events_by_type: dict[str, int] = {}
        self.spec_accepted = 0
        self.spec_rejected = 0

    # -- recording (engine hot path: appends + counter bumps only) -------

    def mark(self) -> None:
        """Reset the timeline boundary (e.g. when the engine loop starts
        after a long construction gap, so the gap isn't billed as host)."""
        self._last_mark = time.monotonic()

    def sample(
        self,
        phase: str,
        *,
        device_s: float = 0.0,
        overlapped_s: float = 0.0,
        tokens: int = 0,
        occupancy: int = 0,
        queue_depth: int = 0,
        stall: str | None = None,
        kv_used: float | None = None,
        prefix_hits: int = 0,
        spec_accepted: int = 0,
        spec_rejected: int = 0,
        queue_by_class: dict[str, int] | None = None,
        program: str | None = None,
    ) -> dict[str, Any]:
        """Record one dispatched burst. ``wall`` is the time since the
        previous boundary. ``overlapped_s`` is host work the pipelined
        loop ran under an in-flight dispatch's device shadow: it is
        credited to the device-busy share (``device = wait + overlapped``,
        clamped to wall) and reported per sample, so
        ``host = wall − device`` stays the *exposed* host time and the
        wall decomposition remains exact. ``queue_by_class`` (QoS engines
        only) keeps the sample schema unchanged for FIFO engines by being
        omitted when None. ``program`` keys the sample by the compiled
        program variant that ran (the attribution ledger's id,
        serving/attribution.py) — omitted when unknown so pre-attribution
        consumers see an unchanged schema."""
        now = time.monotonic()
        wall_ms = (now - self._last_mark) * 1000.0
        self._last_mark = now
        wait_ms = max(0.0, min(device_s * 1000.0, wall_ms))
        overlapped_ms = max(0.0, min(overlapped_s * 1000.0, wall_ms - wait_ms))
        device_ms = wait_ms + overlapped_ms
        host_ms = wall_ms - device_ms
        self._seq += 1
        entry: dict[str, Any] = {
            "seq": self._seq,
            # wall-clock anchor for display alignment across pods only;
            # every duration above is monotonic
            "t_ms": round(time.time() * 1000.0, 3),
            "phase": phase,
            "wall_ms": round(wall_ms, 3),
            "device_ms": round(device_ms, 3),
            "host_ms": round(host_ms, 3),
            "host_overlapped_ms": round(overlapped_ms, 3),
            "occupancy": occupancy,
            "slots": self.slots,
            "tokens": tokens,
            "queue_depth": queue_depth,
            "stall": stall,
            "kv_used": round(kv_used, 4) if kv_used is not None else None,
            "prefix_hits": prefix_hits,
        }
        if spec_accepted or spec_rejected:
            entry["spec_accepted"] = spec_accepted
            entry["spec_rejected"] = spec_rejected
        if queue_by_class is not None:
            entry["queue_by_class"] = dict(queue_by_class)
        if program is not None:
            entry["program"] = program
        self._samples.append(entry)
        self.recorded += 1
        self.wall_ms += wall_ms
        self.device_ms += device_ms
        self.host_ms += host_ms
        self.host_overlapped_ms += overlapped_ms
        self.tokens += tokens
        self.steps_by_phase[phase] = self.steps_by_phase.get(phase, 0) + 1
        if stall:
            # the engine dispatched work this slice, so this is BLOCKED
            # (queued work waiting while busy), not engine stall
            self.blocked_s_by_reason[stall] = (
                self.blocked_s_by_reason.get(stall, 0.0) + wall_ms / 1000.0
            )
        self.spec_accepted += spec_accepted
        self.spec_rejected += spec_rejected
        return entry

    def stall(
        self,
        reason: str,
        *,
        occupancy: int = 0,
        queue_depth: int = 0,
        kv_used: float | None = None,
        queue_by_class: dict[str, int] | None = None,
    ) -> dict[str, Any]:
        """Record an idle/blocked gap (no dispatch): its whole wall slice
        is stall time attributed to ``reason``."""
        now = time.monotonic()
        wall_ms = (now - self._last_mark) * 1000.0
        self._last_mark = now
        self._seq += 1
        entry: dict[str, Any] = {
            "seq": self._seq,
            "t_ms": round(time.time() * 1000.0, 3),
            "phase": "stall",
            "wall_ms": round(wall_ms, 3),
            "device_ms": 0.0,
            "host_ms": 0.0,
            "host_overlapped_ms": 0.0,
            "occupancy": occupancy,
            "slots": self.slots,
            "tokens": 0,
            "queue_depth": queue_depth,
            "stall": reason,
            "kv_used": round(kv_used, 4) if kv_used is not None else None,
            "prefix_hits": 0,
        }
        if queue_by_class is not None:
            entry["queue_by_class"] = dict(queue_by_class)
        self._samples.append(entry)
        self.recorded += 1
        self.wall_ms += wall_ms
        self.stall_ms += wall_ms
        self.stall_s_by_reason[reason] = (
            self.stall_s_by_reason.get(reason, 0.0) + wall_ms / 1000.0
        )
        return entry

    def event(self, kind: str, **detail: Any) -> None:
        """Record a discrete event (recompile / pool-grow / warmup /
        preempt / lockstep-divergence). Safe from any thread."""
        self.events_by_type[kind] = self.events_by_type.get(kind, 0) + 1
        if kind == "recompile":
            self.recompiles += 1
        # per-recorder monotonic event sequence: same-millisecond events
        # stay totally ordered, so tail consumers (the watchdog's 256-event
        # window, incident capture) dedup by seq instead of timestamp ties
        self._event_seq += 1
        self._events.append(
            {
                "seq": self._event_seq,
                    "t_ms": round(time.time() * 1000.0, 3),
                # monotonic stamp for the live health predicates
                # (serving/health.py recompile_storm): recency judgments
                # must survive NTP steps, which t_ms cannot
                "m_s": round(time.monotonic(), 3),
                "kind": kind,
                **detail,
            }
        )

    # -- reading (snapshots; never block the writer) ---------------------
    #
    # Cross-thread safety: readers snapshot with list(deque) / dict(d) —
    # single C-level copies of containers holding plain dicts, which never
    # release the GIL or call back into Python, so a concurrent append
    # from the engine loop or dispatch thread cannot interleave mid-copy.
    # All derived math then runs on the snapshot.

    def recent(self, n: int = 240) -> list[dict[str, Any]]:
        samples = list(self._samples)
        return samples[-n:] if n else samples

    def recent_events(self, n: int = 64) -> list[dict[str, Any]]:
        events = list(self._events)
        return events[-n:] if n else events

    @property
    def dropped(self) -> int:
        """Samples evicted from the ring (0 until ``recorded`` exceeds
        ``LS_TPU_FLIGHT_BUFFER``)."""
        return self.recorded - len(self._samples)

    def summary(self) -> dict[str, Any]:
        """Rollup: exact cumulative totals + window percentiles/rates.

        ``totals.device_ms + totals.host_ms + totals.stall_ms ==
        totals.wall_ms`` by construction — the decomposition the bench
        acceptance compares against its measured wall clock.
        """
        window = list(self._samples)
        dispatch = [s for s in window if s["phase"] != "stall"]
        walls = sorted(s["wall_ms"] for s in dispatch)
        hosts = sorted(s["host_ms"] for s in dispatch)
        devices = sorted(s["device_ms"] for s in dispatch)
        overlaps = sorted(
            s.get("host_overlapped_ms", 0.0) for s in dispatch
        )
        # window overlap ratio: the share of host work the pipelined loop
        # hid behind device compute (None when the window did no host work)
        overlapped_sum = sum(overlaps)
        host_sum = overlapped_sum + sum(hosts)
        overlap_ratio = (
            round(overlapped_sum / host_sum, 4) if host_sum > 0 else None
        )
        queue_depths = sorted(s["queue_depth"] for s in window)
        # the samples tile the timeline, so the retained window's span is
        # the (monotonic) sum of its wall slices — no wall-clock arithmetic
        span_s = sum(s["wall_ms"] for s in window) / 1000.0
        window_tokens = sum(s["tokens"] for s in dispatch)
        kv_last = next(
            (s["kv_used"] for s in reversed(window) if s["kv_used"] is not None),
            None,
        )
        out: dict[str, Any] = {
            "capacity": self.capacity,
            "recorded": self.recorded,
            "dropped": self.dropped,
            "totals": {
                "wall_ms": round(self.wall_ms, 3),
                "device_ms": round(self.device_ms, 3),
                "host_ms": round(self.host_ms, 3),
                "host_overlapped_ms": round(self.host_overlapped_ms, 3),
                "stall_ms": round(self.stall_ms, 3),
                "tokens": self.tokens,
                "steps_by_phase": dict(self.steps_by_phase),
                "stall_s_by_reason": {
                    k: round(v, 4) for k, v in self.stall_s_by_reason.items()
                },
                "blocked_s_by_reason": {
                    k: round(v, 4)
                    for k, v in self.blocked_s_by_reason.items()
                },
                "recompiles": self.recompiles,
                "events_by_type": dict(self.events_by_type),
                "spec_accepted": self.spec_accepted,
                "spec_rejected": self.spec_rejected,
            },
            "window": {
                "samples": len(window),
                "span_s": round(span_s, 3),
                "tokens": window_tokens,
                "tok_s": round(window_tokens / span_s, 1) if span_s else None,
                "step_ms_p50": _pct(walls, 0.50),
                "step_ms_p95": _pct(walls, 0.95),
                "host_overhead_ms_p50": _pct(hosts, 0.50),
                # the pipelined-loop naming of the same split: exposed =
                # host_ms (kept under its legacy key above for old
                # consumers), overlapped = host work under device shadow
                "host_exposed_ms_p50": _pct(hosts, 0.50),
                "host_overlapped_ms_p50": _pct(overlaps, 0.50),
                "overlap_ratio": overlap_ratio,
                "device_ms_p50": _pct(devices, 0.50),
                "queue_depth_p95": _pct(queue_depths, 0.95),
                "occupancy_mean": (
                    round(sum(s["occupancy"] for s in dispatch) / len(dispatch), 2)
                    if dispatch
                    else None
                ),
                "kv_used_ratio_last": kv_last,
            },
        }
        return out


def bench_rollup(summary: dict[str, Any]) -> dict[str, Any]:
    """The subset of a flight summary a bench record snapshots (BENCH_r06
    keys — enough for ``engine_top --analyze`` to decompose a run)."""
    totals = summary.get("totals", {})
    window = summary.get("window", {})
    return {
        "host_overhead_ms_p50": window.get("host_overhead_ms_p50"),
        "host_exposed_ms_p50": window.get("host_exposed_ms_p50"),
        "overlap_ratio": window.get("overlap_ratio"),
        "step_ms_p50": window.get("step_ms_p50"),
        "stall_s_by_reason": totals.get("stall_s_by_reason"),
        "blocked_s_by_reason": totals.get("blocked_s_by_reason"),
        "queue_depth_p95": window.get("queue_depth_p95"),
        "recompile_count": totals.get("recompiles"),
        "totals": {
            k: totals.get(k)
            for k in (
                "wall_ms",
                "device_ms",
                "host_ms",
                "host_overlapped_ms",
                "stall_ms",
                "tokens",
                "steps_by_phase",
            )
        },
    }
