"""Engine health plane: watchdog, degradation predicates, SLO burn rates
(the port's copy of ``langstream_tpu/serving/health.py``).

The flight recorder (``serving/flight.py``) measures; this module judges:

- :class:`EngineWatchdog` — a loop-side heartbeat (last-step-completed
  monotonic stamp and queue depth at stamp time, written by the engine
  loop at every flight boundary) plus a **wait-free** checker. An engine
  is ``wedged`` when no step progress has occurred for ``wedge_window_s``
  while work is queued or in flight: the loop is stuck awaiting a
  dispatch that will never return, so the heartbeat stops while the queue
  does not. It is ``degraded`` on sustained anomaly windows — live
  predicates over the flight ring (KV-reservation saturation, pipeline
  overlap collapse, recompile storms, pool-shrink pressure).
- :class:`SloTracker` — objectives (TTFT, queue wait, TBT, shed rate,
  availability) declared in the app's ``tpu-serving-configuration``
  resource, evaluated engine-side with **multi-window burn rates**: burn =
  (bad fraction in window) / (1 − target). An objective pages (``alert``
  flight event) when BOTH the fast and slow windows burn above
  ``fast_burn``.

``shrink_pressure`` reads the ``pool-shrink`` flight events the engine's
adaptive pool shrink emits: repeated shrinks inside one recovery window
turn the engine DEGRADED. ``recompile_storm`` reads ``recompile`` events;
it is carried unchanged, and the port's engine keeps its own ``recompile``
events (a shape's first eager dispatch, no compile) out of the verdict.

Wait-free contract: everything here is arithmetic over snapshots — deque
appends, attribute reads, list scans. **No device syncs, no blocking I/O,
no lock acquisition.** A liveness probe that itself touched the device
would hang exactly when the device does. Clocks are ``time.monotonic()``
throughout. The deploy-time validation of an application's ``slo``
sections belongs to the control plane, which keeps the JAX package's copy.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

#: health states, best → worst (rank order for fleet aggregation)
HEALTH_STATES = ("ok", "degraded", "wedged")

_STATE_RANK = {name: i for i, name in enumerate(HEALTH_STATES)}


def worst_state(states) -> str:
    """Fleet aggregate: the worst member state wins (unknown strings rank
    as ``wedged`` — a member reporting garbage is not healthy)."""
    worst = "ok"
    for state in states:
        rank = _STATE_RANK.get(state, _STATE_RANK["wedged"])
        if rank > _STATE_RANK[worst]:
            worst = HEALTH_STATES[rank]
    return worst


# ---------------------------------------------------------------------------
# degradation predicates: engine_top --analyze heuristics, live
# ---------------------------------------------------------------------------


def recompile_storm(
    events: list[dict[str, Any]],
    now_s: float,
    k: int = 3,
    span_s: float = 2.0,
    horizon_s: float = 60.0,
) -> str | None:
    """≥ ``k`` recompile events within ``span_s`` of each other, the
    newest within ``horizon_s`` of now — each compile is a potential
    multi-second convoy, and a *cluster* of them means the shape
    variety is unbounded (prompt buckets, sampler modes). Uses the
    events' monotonic ``m_s`` stamps (old payloads without them never
    flag — absence of evidence is not degradation)."""
    stamps = sorted(
        e["m_s"]
        for e in events
        if e.get("kind") == "recompile" and e.get("m_s") is not None
    )
    recent = [s for s in stamps if now_s - s <= horizon_s]
    for i in range(len(recent) - k + 1):
        if recent[i + k - 1] - recent[i] <= span_s:
            return (
                f"recompile storm: {len(recent)} compiles in the last "
                f"{horizon_s:.0f}s with >={k} inside {span_s:.0f}s"
            )
    return None


def shrink_pressure(
    events: list[dict[str, Any]],
    now_s: float,
    k: int = 2,
) -> str | None:
    """Sustained device memory pressure (docs/RESILIENCE.md): ≥ ``k``
    ``pool-shrink`` events inside one recovery window of now — the
    engine is adapting faster than it can recover, so the autoscaler
    and ``/healthz`` must see DEGRADED, not a quietly shrinking budget.
    The window comes from the events themselves (each carries its
    ``recovery_s``); payloads without ``m_s`` stamps never flag."""
    shrinks = [
        e
        for e in events
        if e.get("kind") == "pool-shrink" and e.get("m_s") is not None
    ]
    if not shrinks:
        return None
    window = max(float(e.get("recovery_s") or 30.0) for e in shrinks)
    recent = [e for e in shrinks if now_s - e["m_s"] <= window]
    if len(recent) >= k:
        last = max(e["m_s"] for e in recent)
        return (
            f"device memory pressure: {len(recent)} pool-shrink events "
            f"inside one {window:.0f}s recovery window (last "
            f"{now_s - last:.1f}s ago) — the KV budget is shrinking "
            f"faster than it recovers"
        )
    return None


def kv_saturation(
    samples: list[dict[str, Any]],
    frac: float = 0.95,
    share: float = 0.25,
    min_samples: int = 8,
) -> str | None:
    """KV-reservation pressure sustained across the sample window: more
    than ``share`` of the recent samples report the pool above ``frac``
    reserved — the regime where every admission stalls on
    ``no-kv-blocks`` and preemption churns."""
    vals = [s.get("kv_used") for s in samples if s.get("kv_used") is not None]
    if len(vals) < min_samples:
        return None
    hot = sum(1 for v in vals if v > frac)
    if hot > len(vals) * share:
        return (
            f"KV reservation saturation: pool >{frac:.0%} reserved in "
            f"{hot}/{len(vals)} recent samples"
        )
    return None


def overlap_collapse(samples: list[dict[str, Any]], min_decode: int = 8) -> str | None:
    """Pipeline overlap collapse, the live twin of the ``engine_top``
    post-mortem flag: a loaded engine (occupancy above half its slots)
    whose decode host work is overwhelmingly exposed (<5% overlapped)
    has lost the depth-2 pipeline. Light load is exempt — the sequential
    light-chunk regime is by design."""
    decode = [s for s in samples if s.get("phase") == "decode"]
    if len(decode) < min_decode:
        return None
    if not any("host_overlapped_ms" in s for s in decode):
        return None  # pre-pipeline samples never carried the split
    overlapped = sum(s.get("host_overlapped_ms") or 0.0 for s in decode)
    host = sum(s.get("host_ms") or 0.0 for s in decode)
    slots = max((s.get("slots") or 0) for s in decode)
    occ = sum(s.get("occupancy") or 0 for s in decode) / len(decode)
    if (
        host + overlapped > 0
        and overlapped / (host + overlapped) < 0.05
        and slots
        and occ > slots / 2
    ):
        return (
            f"pipeline overlap collapse: {overlapped:.1f}ms of "
            f"{host + overlapped:.1f}ms decode host time overlapped (<5%) "
            f"at occupancy {occ:.1f}/{slots}"
        )
    return None


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------


class EngineWatchdog:
    """Loop-side heartbeat + wait-free health checker for one engine.

    The engine loop calls :meth:`beat` at every flight-recorder boundary
    (every dispatched burst AND every idle stall sample — an idle engine
    beats about once a second, so idleness never reads as a wedge). The
    checker (:meth:`evaluate`) may run from any thread — probe handlers,
    ``stats()``, the flight report — and performs only snapshot reads
    and arithmetic. State lives on plain attributes: concurrent
    evaluations can at worst observe the same transition twice (benign
    duplicate ``health`` events), never block each other.

    ``wedge_window_s`` must exceed the engine's worst single
    loop-boundary gap — on the card that is a kernel's first build and
    load, or the longest prefill — which is why the default is 60 s and
    why ``warmup_on_start`` engines (that first cost moved into the
    warmup) can run it tighter.
    """

    def __init__(
        self,
        wedge_window_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.wedge_window_s = float(wedge_window_s)
        self._clock = clock
        self.last_step = clock()
        self.queue_at_stamp = 0
        self.state = "ok"
        self.transitions = 0

    def beat(self, queue_depth: int = 0) -> None:
        """Stamp step progress (engine loop only; two attribute writes —
        wait-free by construction)."""
        self.queue_at_stamp = queue_depth
        self.last_step = self._clock()

    def evaluate(
        self,
        queued: int,
        occupancy: int,
        samples: list[dict[str, Any]] | None = None,
        events: list[dict[str, Any]] | None = None,
        stopped: bool = False,
        extra_reasons: tuple = (),
    ) -> dict[str, Any]:
        """Judge the engine now. Returns the health verdict::

            {state, previous, transition, reasons, last_step_age_s,
             queued, occupancy, wedge_window_s}

        ``transition`` is True when the state changed since the last
        evaluation — the caller records it as a ``health`` flight event
        (the watchdog itself holds no reference to the recorder, so the
        predicates stay trivially pure)."""
        now = self._clock()
        age = now - self.last_step
        pending = max(queued, occupancy, self.queue_at_stamp)
        reasons: list[str] = []
        if stopped:
            # a stopped engine (lockstep group broken) can never serve
            # again in this process — report it wedged so the liveness
            # probe recycles the pod and the slice restarts as a unit
            state = "wedged"
            reasons.append(
                "engine stopped serving (lockstep group broken or closed "
                "mid-flight): only a pod restart recovers it"
            )
        elif age > self.wedge_window_s and pending > 0:
            state = "wedged"
            reasons.append(
                f"no step progress for {age:.1f}s (window "
                f"{self.wedge_window_s:.1f}s) with {queued} queued and "
                f"{occupancy} in flight"
            )
        else:
            for reason in (
                recompile_storm(events or [], now),
                kv_saturation(samples or []),
                overlap_collapse(samples or []),
                shrink_pressure(events or [], now),
            ):
                if reason:
                    reasons.append(reason)
            # caller-evaluated predicates (e.g. the engine's per-class
            # TBT burn trackers): pre-judged strings, appended so the
            # watchdog stays pure arithmetic over its own inputs
            reasons.extend(extra_reasons)
            state = "degraded" if reasons else "ok"
        previous = self.state
        transition = state != previous
        if transition:
            self.state = state
            self.transitions += 1
        return {
            "state": state,
            "previous": previous,
            "transition": transition,
            "reasons": reasons,
            "last_step_age_s": round(age, 3),
            "queued": queued,
            "occupancy": occupancy,
            "wedge_window_s": self.wedge_window_s,
        }


# ---------------------------------------------------------------------------
# SLO objectives + tracker
# ---------------------------------------------------------------------------

#: objective vocabulary: what the engine records against each name.
#: "tbt" is the streaming time-between-tokens objective (one event per
#: finished stream, measured as the request's p99 inter-chunk interval
#: — docs/OBSERVABILITY.md Streaming & TBT); per-QoS-class targets
#: (qos.classes.<name>.tbt-p99-s) build one tracker per class with this
#: same machinery.
OBJECTIVES = ("ttft", "queue-wait", "tbt", "shed-rate", "availability")

#: objectives whose good/bad split needs a latency threshold
LATENCY_OBJECTIVES = ("ttft", "queue-wait", "tbt")


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One objective: ``target`` is the required good fraction (0.99 =
    "99% of events good" — for latency objectives that IS the p99), and
    ``threshold_ms`` draws the good/bad line for latency events."""

    name: str
    target: float
    threshold_ms: float | None = None

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"target": self.target}
        if self.threshold_ms is not None:
            out["threshold-ms"] = self.threshold_ms
        return out


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """The declared SLO policy. Frozen and tuple-valued so a
    :class:`~langstream_tpu_torch.serving.engine.ServingConfig` carrying it
    stays hashable (engines are singleton-cached by config), and
    round-trips through the ``tpu-serving-configuration`` resource's
    ``slo`` section via :meth:`to_dict`/:meth:`from_dict`."""

    objectives: tuple[SloObjective, ...] = ()
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn: float = 14.4

    def to_dict(self) -> dict[str, Any]:
        return {
            "fast-window-s": self.fast_window_s,
            "slow-window-s": self.slow_window_s,
            "fast-burn": self.fast_burn,
            "objectives": {o.name: o.to_dict() for o in self.objectives},
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "SloSpec | None":
        """Parse (and validate) the ``slo:`` section. ``None``/missing →
        no SLO tracking. Raises :class:`ValueError` on malformed config —
        the control plane calls this at deploy validation so a bad policy
        fails the deploy (HTTP 400), not the first request."""
        if d is None:
            return None
        if isinstance(d, SloSpec):
            return d
        if not isinstance(d, dict):
            raise ValueError(
                f"slo section must be a mapping, got {type(d).__name__}"
            )
        raw_objectives = d.get("objectives")
        if not isinstance(raw_objectives, dict) or not raw_objectives:
            raise ValueError(
                "slo.objectives must be a non-empty mapping of objective "
                f"name → {{target, threshold-ms}}; known: {list(OBJECTIVES)}"
            )
        objectives: list[SloObjective] = []
        for name in OBJECTIVES:  # stable order regardless of config order
            if name not in raw_objectives:
                continue
            raw = raw_objectives[name] or {}
            if not isinstance(raw, dict):
                raise ValueError(f"slo.objectives.{name} must be a mapping")
            if "target" not in raw:
                raise ValueError(f"slo.objectives.{name}.target is required")
            target = float(raw["target"])
            if not 0.0 < target < 1.0:
                raise ValueError(
                    f"slo.objectives.{name}.target must be in (0, 1) — it "
                    f"is the required good fraction, e.g. 0.99"
                )
            threshold = raw.get("threshold-ms", raw.get("threshold_ms"))
            if name in LATENCY_OBJECTIVES:
                if threshold is None:
                    raise ValueError(
                        f"slo.objectives.{name}.threshold-ms is required "
                        f"(the latency that counts as good)"
                    )
                threshold = float(threshold)
                if threshold <= 0:
                    raise ValueError(
                        f"slo.objectives.{name}.threshold-ms must be > 0"
                    )
            elif threshold is not None:
                raise ValueError(
                    f"slo.objectives.{name} takes no threshold-ms (it is "
                    f"a rate objective)"
                )
            objectives.append(SloObjective(name, target, threshold))
        unknown = set(raw_objectives) - set(OBJECTIVES)
        if unknown:
            raise ValueError(
                f"slo.objectives: unknown objective(s) {sorted(unknown)}; "
                f"known: {list(OBJECTIVES)}"
            )
        fast = float(d.get("fast-window-s", d.get("fast_window_s", 300.0)))
        slow = float(d.get("slow-window-s", d.get("slow_window_s", 3600.0)))
        burn = float(d.get("fast-burn", d.get("fast_burn", 14.4)))
        if fast <= 0 or slow <= 0:
            raise ValueError("slo windows must be > 0 seconds")
        if fast >= slow:
            raise ValueError(
                f"slo.fast-window-s ({fast}) must be smaller than "
                f"slo.slow-window-s ({slow})"
            )
        if burn <= 1.0:
            raise ValueError(
                "slo.fast-burn must be > 1 (a burn rate of 1 exhausts the "
                "budget exactly at the window's end — alerting below it "
                "pages on compliant service)"
            )
        return cls(
            objectives=tuple(objectives),
            fast_window_s=fast,
            slow_window_s=slow,
            fast_burn=burn,
        )


class SloTracker:
    """Multi-window burn-rate evaluation over time-bucketed good/bad
    counts.

    Single writer (the engine loop records completions, sheds, and
    failures), many readers. Recording is a deque append plus integer
    bumps; evaluation sums a bounded bucket window (≤ ``slow_window_s /
    BUCKET_S`` entries) — arithmetic only, wait-free.

    Burn rate over a window = (bad / (good + bad)) / (1 − target): 1.0
    means the error budget is being consumed exactly at the rate that
    exhausts it at the window's end; ``fast_burn`` (default 14.4, the
    Google SRE page threshold for a 5m/1h pair against a 30-day budget)
    over BOTH windows fires the alert. ``budget_remaining`` is
    ``1 − burn_slow``: the slow window's budget left, negative when
    overspent.
    """

    BUCKET_S = 5.0

    def __init__(
        self,
        spec: SloSpec,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.spec = spec
        self._clock = clock
        depth = int(spec.slow_window_s // self.BUCKET_S) + 2
        # per objective: deque of [bucket_start_s, good, bad]
        self._buckets: dict[str, deque] = {
            o.name: deque(maxlen=depth) for o in spec.objectives
        }
        self._objectives = {o.name: o for o in spec.objectives}
        self.alerting: dict[str, bool] = {
            o.name: False for o in spec.objectives
        }
        self.totals: dict[str, dict[str, int]] = {
            o.name: {"good": 0, "bad": 0} for o in spec.objectives
        }

    def record(self, name: str, good: bool) -> dict[str, Any] | None:
        """Record one event against ``name`` and return the objective's
        fresh evaluation (None for names the spec doesn't declare — the
        engine records unconditionally and the spec decides what
        counts)."""
        obj = self._objectives.get(name)
        if obj is None:
            return None
        dq = self._buckets[name]
        now = self._clock()
        start = now - (now % self.BUCKET_S)
        if not dq or dq[-1][0] != start:
            dq.append([start, 0, 0])
        dq[-1][1 if good else 2] += 1
        self.totals[name]["good" if good else "bad"] += 1
        return self._evaluate(obj, now)

    def record_latency(self, name: str, ms: float) -> dict[str, Any] | None:
        """Record one latency event: good iff ``ms`` is within the
        objective's declared ``threshold-ms``. The good/bad line lives
        here with the spec — callers report what they measured, never
        what it means. No-op for undeclared or non-latency objectives."""
        obj = self._objectives.get(name)
        if obj is None or obj.threshold_ms is None:
            return None
        return self.record(name, ms <= obj.threshold_ms)

    @staticmethod
    def _window_counts(
        snapshot: list, now: float, window_s: float
    ) -> tuple[int, int]:
        cutoff = now - window_s
        good = bad = 0
        for start, g, b in snapshot:
            if start >= cutoff:
                good += g
                bad += b
        return good, bad

    @staticmethod
    def _burn(good: int, bad: int, target: float) -> float | None:
        total = good + bad
        if total == 0:
            return None  # no evidence, no burn
        return (bad / total) / (1.0 - target)

    def _evaluate(
        self, obj: SloObjective, now: float, commit: bool = True
    ) -> dict[str, Any]:
        """One objective's verdict. ``commit=True`` (the record path —
        the single writer) edge-detects against the committed alert
        state and updates it; read paths (:meth:`status`) pass
        ``commit=False`` so a scrape between records can never swallow
        a transition the next record would otherwise report."""
        snapshot = list(self._buckets[obj.name])
        gf, bf = self._window_counts(snapshot, now, self.spec.fast_window_s)
        gs, bs = self._window_counts(snapshot, now, self.spec.slow_window_s)
        burn_fast = self._burn(gf, bf, obj.target)
        burn_slow = self._burn(gs, bs, obj.target)
        budget = 1.0 - burn_slow if burn_slow is not None else 1.0
        alerting = (
            burn_fast is not None
            and burn_slow is not None
            and burn_fast >= self.spec.fast_burn
            and burn_slow >= self.spec.fast_burn
        )
        if commit:
            was = self.alerting[obj.name]
            self.alerting[obj.name] = alerting
            transition = alerting != was
        else:
            transition = False
        return {
            "objective": obj.name,
            "target": obj.target,
            "threshold_ms": obj.threshold_ms,
            "burn_rate_fast": (
                round(burn_fast, 4) if burn_fast is not None else None
            ),
            "burn_rate_slow": (
                round(burn_slow, 4) if burn_slow is not None else None
            ),
            "budget_remaining": round(budget, 4),
            "window_good": gs,
            "window_bad": bs,
            "alerting": alerting,
            "transition": transition,
        }

    def status(self) -> dict[str, Any]:
        """Full SLO section for ``stats()`` / ``/flight/summary`` — one
        evaluation per declared objective plus the window parameters."""
        now = self._clock()
        objectives = {}
        for name, obj in self._objectives.items():
            verdict = self._evaluate(obj, now, commit=False)
            verdict.pop("transition", None)
            verdict["total_good"] = self.totals[name]["good"]
            verdict["total_bad"] = self.totals[name]["bad"]
            objectives[name] = verdict
        return {
            "fast_window_s": self.spec.fast_window_s,
            "slow_window_s": self.spec.slow_window_s,
            "fast_burn": self.spec.fast_burn,
            "objectives": objectives,
            # the LIVE view (burn can age in or out of the fast window
            # between records); `alert` flight events stay edge-detected
            # at record time against the committed state
            "alerting": sorted(
                name
                for name, verdict in objectives.items()
                if verdict["alerting"]
            ),
        }

