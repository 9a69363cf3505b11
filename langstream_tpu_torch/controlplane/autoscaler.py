"""Fleet autoscaler: flight-driven replica reconciliation for serving apps
(the port's copy of ``langstream_tpu/controlplane/autoscaler.py``).

The serving planes produce the *signals* — per-pod ``/flight/summary``
telemetry, QoS queue depths, SLO burn rates, the health watchdog — and
this module is the subsystem that *consumes* them. One
:class:`FleetAutoscaler` runs per deployed serving application and drives a
plain reconcile cycle::

    observe -> decide -> apply

- **observe** (I/O): the backend fans in one observation per replica —
  queue depths, occupancy, KV reservation pressure, shed counters, health
  state, SLO alerts, draining flags, unreachable markers. Under the k8s
  compute runtime that is the pods' ``/flight/summary`` fan-in
  (``KubernetesComputeRuntime.fleet_observe``); tests feed fake fleets.
- **decide** (pure, wait-free — graftcheck FLEET602): per-signal thresholds
  from the app's ``autoscale:`` section produce *pressure* (scale-up
  evidence) or *idleness* (scale-down evidence). Hysteresis makes the
  decision windowed, not edge-triggered: pressure must persist for
  ``scale-up-window-s`` before a scale-up, idleness for
  ``scale-down-window-s`` before a scale-down, and either window resets the
  moment its condition breaks. The result is a :class:`Decision` carrying
  the full evidence that produced it.
- **apply** (I/O): replica-count writes are gated by the cooldown check
  (graftcheck FLEET601 makes this mechanical: an ungated
  ``set_replicas``/``scale_statefulset`` call in this module is a red
  gate). Scale-up just patches the StatefulSet. Scale-down is
  **drain-before-terminate**: the victim (highest ordinal — the pod the
  StatefulSet controller deletes first) is drained via its ``/drain``
  endpoint, which stops admission, preempts-and-requeues in-flight
  generations through the QoS machinery, and serves the backlog to
  completion; only after the pod reports drained (or the grace budget
  expires) does the replica count decrement.

Every decision — including refusals (cooldown holds, clamped at min/max) —
lands in a bounded ``scale`` event ring served by
``/api/applications/{tenant}/{name}/autoscaler`` and rendered by
``tools/engine_top.py --fleet`` (which also flags scale thrash post
mortem). See ``docs/FLEET.md``.

Stdlib-only (the control plane and tools import this module without
touching a device). The port's dev-mode control plane has no backend that
can scale replicas, so it starts no autoscaler; the k8s backend that feeds
one comes with the port's k8s compute runtime. Clocks are ``time.monotonic()``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
import logging
import time
from collections import deque
from typing import Any, Callable

log = logging.getLogger(__name__)

#: annotation stamped on StatefulSets whose replica count the autoscaler
#: owns — the operator's reconciler preserves the live count instead of
#: resetting it to the CR's parallelism every tick
AUTOSCALE_ANNOTATION = "langstream.tpu/autoscale"

#: disaggregated serving pool roles (docs/DISAGG.md)
POOL_ROLES = ("prefill", "decode")

#: per-pool signal defaults (docs/DISAGG.md): each pool scales on ITS
#: OWN bottleneck. The prefill pool is prompt-compute bound — queue
#: depth is its pressure, and KV reservation never fires (prefill slots
#: turn over per prompt; kv-reserved=1.0 can never be strictly
#: exceeded). The decode pool is KV-residency bound — reserved-fraction
#: is its pressure, and queue thresholds are parked out of reach (its
#: queue is fed by handoffs the prefill pool already admission-gated).
#: Any key may be overridden in the pool's declared autoscale section.
POOL_SIGNAL_DEFAULTS: dict[str, dict[str, Any]] = {
    "prefill": {"kv-reserved": 1.0},
    "decode": {
        "queue-depth-per-replica": 1e9,
        "interactive-depth-per-replica": 1e9,
        "kv-reserved": 0.85,
    },
}


@dataclasses.dataclass(frozen=True)
class AutoscaleSpec:
    """The declared fleet policy (``autoscale:`` section of a
    ``tpu-serving-configuration`` resource). Frozen and flat so it is
    hashable and round-trips through :meth:`to_dict`/:meth:`from_dict`
    like the ``qos``/``slo`` sections; malformed config fails the deploy
    with HTTP 400 via :func:`validate_application_autoscale`."""

    enabled: bool = True
    min_replicas: int = 1
    max_replicas: int = 4
    #: pressure must persist this long before a scale-up fires
    scale_up_window_s: float = 30.0
    #: idleness must persist this long before a scale-down fires
    scale_down_window_s: float = 300.0
    #: minimum seconds between replica-count writes (either direction)
    cooldown_s: float = 120.0
    #: grace budget handed to the victim pod's /drain on scale-down
    drain_grace_s: float = 60.0
    # -- scale-up pressure thresholds (any one sustained breach fires) --
    #: mean queued requests per *healthy* replica
    queue_depth_per_replica: float = 8.0
    #: interactive-class depth per healthy replica (the latency class
    #: backs up long before total depth does under a batch flood)
    interactive_depth_per_replica: float = 2.0
    #: KV block-pool reserved fraction on any replica
    kv_reserved: float = 0.95
    #: sheds observed across the fleet since the previous observation
    shed_delta: int = 1
    #: scale up while any declared SLO objective is in fast burn
    slo_fast_burn: bool = True
    #: scale up on sustained degraded health (recompile storm, KV
    #: saturation, pipeline overlap collapse — the watchdog's predicates)
    degraded: bool = True
    #: scale up while any replica is serving under a shrunken KV budget
    #: (adaptive pool-shrink after a device allocator failure,
    #: docs/RESILIENCE.md): the replica adapted instead of dying, but
    #: the fleet lost capacity it should get back elsewhere
    pool_shrink: bool = True
    # -- scale-down idleness thresholds (ALL must hold) --
    #: fleet-wide occupancy fraction below which replicas are idle
    idle_occupancy: float = 0.10
    #: total queued requests at or below this counts as an empty queue
    idle_queue: int = 0
    #: optional agent id naming the StatefulSet to scale when the app has
    #: several (defaults to the app's single scalable serving STS)
    agent: str | None = None
    #: disaggregated pool this policy scales ("prefill" / "decode", set
    #: by the ``pools:`` section — docs/DISAGG.md); None = the classic
    #: single-fleet policy. The backend resolves the pool's StatefulSet
    #: (the ``-prefill``/``-decode`` split the manifest factory emits).
    pool: str | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "enabled": self.enabled,
            "min-replicas": self.min_replicas,
            "max-replicas": self.max_replicas,
            "scale-up-window-s": self.scale_up_window_s,
            "scale-down-window-s": self.scale_down_window_s,
            "cooldown-s": self.cooldown_s,
            "drain-grace-s": self.drain_grace_s,
            "queue-depth-per-replica": self.queue_depth_per_replica,
            "interactive-depth-per-replica": (
                self.interactive_depth_per_replica
            ),
            "kv-reserved": self.kv_reserved,
            "shed-delta": self.shed_delta,
            "slo-fast-burn": self.slo_fast_burn,
            "degraded": self.degraded,
            "pool-shrink": self.pool_shrink,
            "idle-occupancy": self.idle_occupancy,
            "idle-queue": self.idle_queue,
            "agent": self.agent,
            "pool": self.pool,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "AutoscaleSpec | None":
        """Parse (and validate) the ``autoscale:`` section. ``None`` /
        missing → no autoscaling. Raises :class:`ValueError` on malformed
        config — the control plane calls this at deploy validation so a
        bad policy fails the deploy (HTTP 400), not the first reconcile."""
        if d is None:
            return None
        if isinstance(d, AutoscaleSpec):
            return d
        if not isinstance(d, dict):
            raise ValueError(
                f"autoscale section must be a mapping, got {type(d).__name__}"
            )

        def _get(key: str, default):
            return d.get(key, d.get(key.replace("-", "_"), default))

        known = {
            k.replace("_", "-") for k in cls.__dataclass_fields__
        }
        unknown = {str(k).replace("_", "-") for k in d} - known
        if unknown:
            raise ValueError(
                f"autoscale: unknown key(s) {sorted(unknown)}; known: "
                f"{sorted(known)}"
            )
        min_r = int(_get("min-replicas", 1))
        max_r = int(_get("max-replicas", 4))
        if min_r < 1:
            raise ValueError("autoscale.min-replicas must be >= 1")
        if max_r < min_r:
            raise ValueError(
                f"autoscale.max-replicas ({max_r}) must be >= "
                f"min-replicas ({min_r})"
            )
        up_w = float(_get("scale-up-window-s", 30.0))
        down_w = float(_get("scale-down-window-s", 300.0))
        cooldown = float(_get("cooldown-s", 120.0))
        grace = float(_get("drain-grace-s", 60.0))
        if up_w < 0 or down_w < 0:
            raise ValueError("autoscale windows must be >= 0 seconds")
        if cooldown < 0:
            raise ValueError("autoscale.cooldown-s must be >= 0")
        if grace <= 0:
            raise ValueError("autoscale.drain-grace-s must be > 0")
        kv = float(_get("kv-reserved", 0.95))
        if not 0.0 < kv <= 1.0:
            raise ValueError("autoscale.kv-reserved must be in (0, 1]")
        idle_occ = float(_get("idle-occupancy", 0.10))
        if not 0.0 <= idle_occ < 1.0:
            raise ValueError("autoscale.idle-occupancy must be in [0, 1)")
        queue_per = float(_get("queue-depth-per-replica", 8.0))
        inter_per = float(_get("interactive-depth-per-replica", 2.0))
        if queue_per <= 0 or inter_per <= 0:
            raise ValueError(
                "autoscale queue-depth thresholds must be > 0 (a zero "
                "threshold scales up on an empty queue)"
            )
        shed_delta = int(_get("shed-delta", 1))
        if shed_delta < 1:
            raise ValueError("autoscale.shed-delta must be >= 1")
        agent = _get("agent", None)
        pool = _get("pool", None)
        if pool is not None and pool not in POOL_ROLES:
            raise ValueError(
                f"autoscale.pool must be one of {list(POOL_ROLES)}, "
                f"got {pool!r}"
            )
        return cls(
            enabled=_parse_bool(_get("enabled", True)),
            min_replicas=min_r,
            max_replicas=max_r,
            scale_up_window_s=up_w,
            scale_down_window_s=down_w,
            cooldown_s=cooldown,
            drain_grace_s=grace,
            queue_depth_per_replica=queue_per,
            interactive_depth_per_replica=inter_per,
            kv_reserved=kv,
            shed_delta=shed_delta,
            slo_fast_burn=_parse_bool(_get("slo-fast-burn", True)),
            degraded=_parse_bool(_get("degraded", True)),
            pool_shrink=_parse_bool(_get("pool-shrink", True)),
            idle_occupancy=idle_occ,
            idle_queue=int(_get("idle-queue", 0)),
            agent=str(agent) if agent is not None else None,
            pool=str(pool) if pool is not None else None,
        )


def _parse_bool(v: Any) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def pool_autoscale_spec(role: str, declared: Any) -> "AutoscaleSpec | None":
    """Build one pool's :class:`AutoscaleSpec` from its declared
    ``pools.<role>.autoscale`` section, folding in the role's signal
    defaults (prefill scales on queue depth, decode on KV reserved
    fraction — docs/DISAGG.md). ``declared`` is the pool's entry (a
    mapping, possibly without an ``autoscale`` key → None: the pool
    exists but is not autoscaled). Raises ValueError on malformed
    config (the deploy-validation contract)."""
    if role not in POOL_ROLES:
        raise ValueError(
            f"unknown pool role {role!r}; known: {list(POOL_ROLES)}"
        )
    if declared is None:
        declared = {}
    if not isinstance(declared, dict):
        raise ValueError(
            f"pools.{role} must be a mapping, got {type(declared).__name__}"
        )
    section = declared.get("autoscale")
    if section is None:
        return None
    if not isinstance(section, dict):
        raise ValueError(
            f"pools.{role}.autoscale must be a mapping, "
            f"got {type(section).__name__}"
        )
    merged = dict(POOL_SIGNAL_DEFAULTS[role])
    merged.update(section)
    merged["pool"] = role
    return AutoscaleSpec.from_dict(merged)


def _serving_pools(res_configuration: dict | None) -> dict[str, Any] | None:
    """The ``pools:`` section of a tpu-serving-configuration resource
    (None when absent). Validates role names eagerly."""
    pools = (res_configuration or {}).get("pools")
    if pools is None:
        return None
    if not isinstance(pools, dict) or not pools:
        raise ValueError(
            "pools section must be a non-empty mapping of role -> config"
        )
    unknown = sorted(set(pools) - set(POOL_ROLES))
    if unknown:
        raise ValueError(
            f"pools: unknown role(s) {unknown}; known: {list(POOL_ROLES)}"
        )
    return pools


def validate_application_autoscale(application) -> None:
    """Deploy-time validation: parse every ``tpu-serving-configuration``
    resource's ``autoscale`` section AND its ``pools`` section (the
    disaggregated split's per-pool policies) so a malformed policy fails
    the deploy (HTTP 400) instead of the first reconcile — the same
    contract the qos/slo validators keep."""
    for name, res in (getattr(application, "resources", None) or {}).items():
        if getattr(res, "type", None) != "tpu-serving-configuration":
            continue
        try:
            AutoscaleSpec.from_dict((res.configuration or {}).get("autoscale"))
            pools = _serving_pools(res.configuration or {})
            for role, declared in (pools or {}).items():
                pool_autoscale_spec(role, declared)
        except ValueError as e:
            raise ValueError(
                f"resource {name!r}: invalid autoscale section: {e}"
            ) from e


def application_autoscale_spec(application) -> "AutoscaleSpec | None":
    """The app's enabled autoscale policy, or None (first declared
    serving resource wins — one fleet per app)."""
    specs = application_autoscale_specs(application)
    for spec in specs:
        if spec.pool is None:
            return spec
    return specs[0] if specs else None


def application_autoscale_specs(application) -> "list[AutoscaleSpec]":
    """Every enabled autoscale policy the app declares — one for a
    classic single fleet, one PER POOL for a disaggregated split
    (``pools.prefill.autoscale`` / ``pools.decode.autoscale``,
    docs/DISAGG.md). First declared serving resource wins."""
    for res in (getattr(application, "resources", None) or {}).values():
        if getattr(res, "type", None) != "tpu-serving-configuration":
            continue
        try:
            pools = _serving_pools(res.configuration or {})
            if pools is not None:
                specs = []
                for role in POOL_ROLES:  # stable order
                    if role not in pools:
                        continue
                    spec = pool_autoscale_spec(role, pools[role])
                    if spec is not None and spec.enabled:
                        specs.append(spec)
                if specs:
                    return specs
                continue
            spec = AutoscaleSpec.from_dict(
                (res.configuration or {}).get("autoscale")
            )
        except ValueError:
            continue  # deploy validation already rejected new configs
        if spec is not None and spec.enabled:
            return [spec]
    return []


# ---------------------------------------------------------------------------
# observations + decisions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplicaObservation:
    """One replica's state at observation time — built from the pod's
    ``/flight/summary`` entry (k8s fan-in) or straight from an in-process
    engine's stats (tests, dev mode)."""

    replica: str
    unreachable: bool = False
    queued: int = 0
    queue_interactive: int = 0
    occupancy: int = 0
    slots: int = 0
    kv_used: float | None = None
    shed_total: int = 0
    state: str = "ok"          # ok | degraded | wedged
    draining: bool = False
    slo_alerting: tuple = ()
    #: disaggregated pool role ("combined" / "prefill" / "decode") — the
    #: router's phase filter keys off this (docs/DISAGG.md)
    pool: str = "combined"
    #: device-survival posture (docs/RESILIENCE.md): cumulative adaptive
    #: pool-shrinks, and whether any KV budget is withheld RIGHT NOW —
    #: a shrunk replica serves degraded capacity the fleet must replace
    pool_shrinks: int = 0
    budget_withheld: bool = False

    def to_dict(self) -> dict[str, Any]:
        return {
            "replica": self.replica,
            "unreachable": self.unreachable,
            "queued": self.queued,
            "queue_interactive": self.queue_interactive,
            "occupancy": self.occupancy,
            "slots": self.slots,
            "kv_used": self.kv_used,
            "shed_total": self.shed_total,
            "state": self.state,
            "draining": self.draining,
            "slo_alerting": list(self.slo_alerting),
            "pool": self.pool,
            "pool_shrinks": self.pool_shrinks,
            "budget_withheld": self.budget_withheld,
        }


@dataclasses.dataclass
class Decision:
    """One decide() verdict. ``action`` is ``up`` / ``down`` / ``none``;
    ``reasons`` name the signals that produced it; ``evidence`` is the
    fleet snapshot the operator reads back from the scale event."""

    action: str
    current: int
    target: int
    reasons: list[str]
    evidence: dict[str, Any]


class FleetAutoscaler:
    """The per-application reconcile loop.

    ``backend`` is duck-typed (sync or async methods both work — sync
    ones run in a worker thread so the control plane's event loop never
    blocks on a pod HTTP round-trip):

    - ``observe() -> list[ReplicaObservation | dict]``
    - ``set_replicas(n: int) -> None``
    - ``drain(replica: str, grace_s: float) -> dict | None`` — blocks
      until the pod reports drained or the grace budget expires; the
      returned report (requeued/completed/shed counts) lands in the
      scale event's evidence.

    :meth:`decide` is pure arithmetic over the observations and the
    hysteresis state — wait-free by contract (graftcheck FLEET602), so a
    wedged pod HTTP fan-in can slow *observation*, never the judgment.
    Replica-count writes happen only in :meth:`step`, gated by the
    cooldown check (FLEET601).
    """

    #: decisions kept for /autoscaler + engine_top (scale + refusals)
    DECISION_RING = 64

    def __init__(
        self,
        spec: AutoscaleSpec,
        backend: Any,
        clock: Callable[[], float] = time.monotonic,
        interval_s: float = 5.0,
        on_observation: Callable[[list[dict[str, Any]]], None] | None = None,
    ):
        self.spec = spec
        self.backend = backend
        self.interval_s = interval_s
        #: called with each pass's observation dicts — the gateway's
        #: replica router consumes the same fleet snapshot the scaler
        #: judges (one fan-in, two consumers)
        self.on_observation = on_observation
        self._clock = clock
        # hysteresis state: when the current pressure/idle streak began
        # (None = the condition does not hold right now)
        self._pressure_since: float | None = None
        self._idle_since: float | None = None
        self._last_scale_t: float | None = None
        self._last_shed_total: int | None = None
        # a scale-down whose drain succeeded but whose replica write
        # failed: (decision, victim, drain_report) — retried next tick
        # so the already-drained pod doesn't linger as a zombie while a
        # fresh idle streak re-accumulates around its sheds
        self._pending_apply: tuple[Decision, str, Any] | None = None
        self.decisions: deque = deque(maxlen=self.DECISION_RING)
        self.scale_ups = 0
        self.scale_downs = 0
        self._last_observation: list[dict[str, Any]] = []
        self._task: asyncio.Task | None = None
        self._stop = asyncio.Event()

    # -- pure decision core (wait-free: FLEET602) -----------------------

    def _pressure_reasons(
        self, obs: list[ReplicaObservation], shed_delta: int
    ) -> list[str]:
        """Scale-up signals present *right now* (hysteresis is applied by
        the caller). Healthy replicas = reachable, not draining, not
        wedged — the denominator for per-replica thresholds, because a
        wedged pod serves nothing no matter what its queue says."""
        spec = self.spec
        healthy = [
            o for o in obs
            if not o.unreachable and not o.draining and o.state != "wedged"
        ]
        n = max(1, len(healthy))
        reasons: list[str] = []
        queued = sum(o.queued for o in healthy)
        if queued / n > spec.queue_depth_per_replica:
            reasons.append(
                f"queue depth {queued} over {len(healthy)} healthy replicas "
                f"(> {spec.queue_depth_per_replica:g}/replica)"
            )
        interactive = sum(o.queue_interactive for o in healthy)
        if interactive / n > spec.interactive_depth_per_replica:
            reasons.append(
                f"interactive queue depth {interactive} "
                f"(> {spec.interactive_depth_per_replica:g}/replica)"
            )
        hot = [
            o.replica
            for o in healthy
            if o.kv_used is not None and o.kv_used > spec.kv_reserved
        ]
        if hot:
            reasons.append(
                f"KV reservation saturation on {hot} "
                f"(> {spec.kv_reserved:.0%})"
            )
        if shed_delta >= spec.shed_delta:
            reasons.append(
                f"{shed_delta} requests shed since the last observation"
            )
        if spec.slo_fast_burn:
            burning = sorted(
                {name for o in healthy for name in o.slo_alerting}
            )
            if burning:
                reasons.append(f"SLO fast burn on {burning}")
        if spec.degraded:
            degraded = [o.replica for o in healthy if o.state == "degraded"]
            if degraded:
                reasons.append(
                    f"degraded replicas {degraded} (recompile storm / KV "
                    f"saturation / overlap collapse)"
                )
        if spec.pool_shrink:
            shrunk = [o.replica for o in healthy if o.budget_withheld]
            if shrunk:
                reasons.append(
                    f"KV budget withheld on {shrunk} (adaptive pool-shrink "
                    f"after a device allocator failure — the replica "
                    f"degraded instead of dying; replace its capacity)"
                )
        return reasons

    def _idle(self, obs: list[ReplicaObservation]) -> bool:
        """Scale-down eligibility *right now*: every reachable replica
        idle. Unreachable replicas block scale-down — the missing pod
        may hold work the observation cannot see."""
        spec = self.spec
        if any(o.unreachable for o in obs):
            return False
        live = [o for o in obs if not o.draining]
        if not live:
            return False
        if sum(o.queued for o in live) > spec.idle_queue:
            return False
        slots = sum(o.slots for o in live)
        occupancy = sum(o.occupancy for o in live)
        if slots and occupancy / slots > spec.idle_occupancy:
            return False
        return not any(o.slo_alerting for o in live)

    def decide(
        self, observations: list, now: float | None = None
    ) -> Decision:
        """Judge the fleet now. Pure in (observations, internal
        hysteresis state, clock): no I/O, no locks, no device work —
        graftcheck FLEET602 gates this section, because a decision path
        that can block turns one wedged pod into a frozen autoscaler."""
        now = self._clock() if now is None else now
        obs = [
            o if isinstance(o, ReplicaObservation)
            else ReplicaObservation(**o)
            for o in observations
        ]
        self._last_observation = [o.to_dict() for o in obs]
        current = len(obs)
        spec = self.spec

        shed_total = sum(o.shed_total for o in obs if not o.unreachable)
        shed_delta = (
            max(0, shed_total - self._last_shed_total)
            if self._last_shed_total is not None
            else 0
        )
        self._last_shed_total = shed_total

        pressure = self._pressure_reasons(obs, shed_delta)
        idle = self._idle(obs)
        # hysteresis: streaks start when their condition appears and
        # reset the moment it breaks — a decision needs a full window of
        # uninterrupted evidence, never one noisy sample
        if pressure:
            self._pressure_since = (
                self._pressure_since if self._pressure_since is not None
                else now
            )
        else:
            self._pressure_since = None
        if idle and not pressure:
            self._idle_since = (
                self._idle_since if self._idle_since is not None else now
            )
        else:
            self._idle_since = None

        evidence = {
            "replicas": self._last_observation,
            "pressure": pressure,
            "idle": idle,
            "shed_delta": shed_delta,
            "pressure_for_s": (
                round(now - self._pressure_since, 3)
                if self._pressure_since is not None
                else None
            ),
            "idle_for_s": (
                round(now - self._idle_since, 3)
                if self._idle_since is not None
                else None
            ),
        }

        if (
            self._pressure_since is not None
            and now - self._pressure_since >= spec.scale_up_window_s
        ):
            if current < spec.max_replicas:
                return Decision(
                    "up", current, current + 1, pressure, evidence
                )
            return Decision(
                "none", current, current,
                [f"pressure sustained but already at max-replicas "
                 f"({spec.max_replicas})"] + pressure,
                evidence,
            )
        if (
            self._idle_since is not None
            and now - self._idle_since >= spec.scale_down_window_s
        ):
            if current > spec.min_replicas:
                return Decision(
                    "down", current, current - 1,
                    [f"fleet idle for {now - self._idle_since:.1f}s "
                     f"(occupancy <= {spec.idle_occupancy:.0%}, queue <= "
                     f"{spec.idle_queue})"],
                    evidence,
                )
            return Decision("none", current, current, [], evidence)
        return Decision("none", current, current, [], evidence)

    def _cooldown_ok(self, now: float) -> bool:
        """True when enough time has passed since the last replica-count
        write. Every scale path checks this (FLEET601): without it, one
        noisy signal flip-flops the fleet — each flip paying a pod
        schedule + warmup on the way up and a drain on the way down."""
        return (
            self._last_scale_t is None
            or now - self._last_scale_t >= self.spec.cooldown_s
        )

    # -- reconcile step (I/O at the edges) -------------------------------

    async def _call(self, fn: Callable, *args):
        """Backend dispatch: async methods await on this loop, sync ones
        run in a worker thread — the k8s backend does blocking pod HTTP
        and API-server round-trips, which must never stall the control
        plane's event loop."""
        if inspect.iscoroutinefunction(fn):
            return await fn(*args)
        result = await asyncio.to_thread(fn, *args)
        if inspect.isawaitable(result):
            return await result
        return result

    def _record(self, decision: Decision, outcome: str, **extra) -> dict:
        if outcome in ("clamped", "cooldown") and self.decisions:
            tail = self.decisions[-1]
            if (
                tail["outcome"] == outcome
                and tail["action"] == decision.action
                and tail["to"] == decision.target
            ):
                # steady-state refusals collapse into their transition
                # entry (repeat count + freshness stamp): a fleet pinned
                # at max under sustained pressure records one tick per
                # 5 s, and 64 identical clamps would otherwise evict the
                # scale/drain history the bounded ring exists to keep
                tail["repeats"] = tail.get("repeats", 0) + 1
                tail["last_m_s"] = self._clock()
                tail.update(extra)
                return tail
        entry = {
            "m_s": self._clock(),
            "action": decision.action,
            "from": decision.current,
            "to": decision.target,
            "outcome": outcome,
            "reasons": decision.reasons,
            "evidence": decision.evidence,
            **extra,
        }
        self.decisions.append(entry)
        return entry

    async def step(self) -> dict[str, Any] | None:
        """One reconcile pass: observe, decide, apply. Returns the
        recorded decision entry when the pass scaled (or refused on
        cooldown), None on a quiet pass."""
        observations = await self._call(self.backend.observe)
        now = self._clock()
        # the observation hook and snapshot update run on EVERY pass —
        # including pending-apply retries, whose decision is already
        # made: the gateway router and the /autoscaler route live off
        # this feed, and a k8s-API flake must not starve them stale
        obs = [
            o if isinstance(o, ReplicaObservation)
            else ReplicaObservation(**o)
            for o in observations
        ]
        self._last_observation = [o.to_dict() for o in obs]
        if self.on_observation is not None:
            try:
                self.on_observation(self._last_observation)
            except Exception:
                log.exception("fleet observation hook failed")
        if self._pending_apply is not None:
            return await self._finish_pending_apply(now)
        decision = self.decide(obs, now)
        if decision.action == "none":
            if decision.reasons:
                # at-max pressure is worth surfacing even though nothing
                # was written (the operator's cue to raise max-replicas)
                return self._record(decision, "clamped")
            return None
        if not self._cooldown_ok(now):
            return self._record(
                decision, "cooldown",
                cooldown_remaining_s=round(
                    self.spec.cooldown_s - (now - self._last_scale_t), 3
                ),
            )
        if decision.action == "up":
            if self._cooldown_ok(now):
                await self._call(self.backend.set_replicas, decision.target)
            self._last_scale_t = self._clock()
            self.scale_ups += 1
            # a fresh streak must re-accumulate before the next step
            self._pressure_since = None
            log.info(
                "autoscaler: scale up %d -> %d (%s)",
                decision.current, decision.target, "; ".join(decision.reasons),
            )
            return self._record(decision, "scaled")
        # scale-down: drain-before-terminate. The victim is the highest
        # ordinal — the pod the StatefulSet controller deletes when
        # replicas decrement, so the drained pod and the terminated pod
        # are the same one. The replica count only decrements after the
        # pod reports drained (or its grace budget expired inside drain).
        victims = [
            o for o in decision.evidence["replicas"]
            if not o.get("unreachable")
        ]
        victim = max(victims, key=lambda o: _ordinal(o["replica"]))["replica"]
        drain_report = await self._call(
            self.backend.drain, victim, self.spec.drain_grace_s
        )
        try:
            if self._cooldown_ok(now):
                await self._call(self.backend.set_replicas, decision.target)
        except Exception as e:
            # the drain already happened and is terminal for admission:
            # record the evidence now, remember the decrement, and retry
            # the write next tick — without this, the drained pod sheds
            # every record it's still assigned, and those sheds read as
            # scale-UP pressure that resets the idle streak a fresh
            # decision would need
            self._pending_apply = (decision, victim, drain_report)
            self._record(
                decision, "apply-failed",
                victim=victim, drain=drain_report, error=str(e),
            )
            raise
        # stamped AFTER the write: backend.drain can block for the whole
        # grace budget, and the cooldown clock starts when the scale
        # landed, not when it was decided
        self._last_scale_t = self._clock()
        self.scale_downs += 1
        self._idle_since = None
        log.info(
            "autoscaler: scale down %d -> %d (drained %s: %s)",
            decision.current, decision.target, victim, drain_report,
        )
        return self._record(
            decision, "scaled", victim=victim, drain=drain_report
        )

    async def _finish_pending_apply(self, now: float) -> dict[str, Any]:
        """Complete a scale-down whose drain succeeded but whose replica
        write failed last tick. The cooldown stamp was withheld at the
        failure, so the gate re-passes here for the same decision."""
        decision, victim, drain_report = self._pending_apply
        if self._cooldown_ok(now):
            await self._call(self.backend.set_replicas, decision.target)
        self._pending_apply = None
        self._last_scale_t = self._clock()
        self.scale_downs += 1
        self._idle_since = None
        log.info(
            "autoscaler: scale down %d -> %d applied after retry "
            "(drained %s earlier)",
            decision.current, decision.target, victim,
        )
        return self._record(
            decision, "scaled", victim=victim, drain=drain_report,
            retried=True,
        )

    # -- loop + status ---------------------------------------------------

    async def run(self) -> None:
        """Reconcile until :meth:`stop` — failures are logged and retried
        next tick (level-triggered, like the operator)."""
        while not self._stop.is_set():
            try:
                await self.step()
            except Exception:
                log.exception("autoscaler reconcile failed; retrying")
            try:
                await asyncio.wait_for(
                    self._stop.wait(), timeout=self.interval_s
                )
            except asyncio.TimeoutError:
                pass

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._stop.clear()
            self._task = asyncio.ensure_future(self.run())

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def status(self) -> dict[str, Any]:
        """The ``/autoscaler`` route payload (also what ``engine_top
        --fleet`` renders): declared policy, the latest per-replica
        observations, and the decision ring newest-last."""
        now = self._clock()
        return {
            "enabled": True,
            "spec": self.spec.to_dict(),
            "replicas": list(self._last_observation),
            "decisions": list(self.decisions),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "cooldown_remaining_s": (
                round(
                    max(
                        0.0,
                        self.spec.cooldown_s - (now - self._last_scale_t),
                    ),
                    3,
                )
                if self._last_scale_t is not None
                else 0.0
            ),
            "pressure_for_s": (
                round(now - self._pressure_since, 3)
                if self._pressure_since is not None
                else None
            ),
            "idle_for_s": (
                round(now - self._idle_since, 3)
                if self._idle_since is not None
                else None
            ),
        }


def _ordinal(pod_name: str) -> int:
    tail = pod_name.rsplit("-", 1)[-1]
    return int(tail) if tail.isdigit() else -1


def observation_from_summary(
    pod: str, entries: Any, healthz: dict | None = None
) -> ReplicaObservation:
    """Fold one pod's ``/flight/summary`` payload (a list of per-engine
    entries — usually one) into a :class:`ReplicaObservation`. ``None``
    entries mean the fan-in timed out: the replica is ``unreachable``
    and counts against neither pressure denominators nor idleness."""
    if entries is None:
        return ReplicaObservation(replica=pod, unreachable=True)
    queued = interactive = occupancy = slots = shed = 0
    kv_used: float | None = None
    state = "ok"
    draining = False
    pool = "combined"
    pool_shrinks = 0
    budget_withheld = False
    alerting: set[str] = set()
    rank = {"ok": 0, "degraded": 1, "wedged": 2}
    for entry in entries if isinstance(entries, list) else []:
        if not isinstance(entry, dict):
            continue
        entry_pool = entry.get("pool_role")
        if entry_pool in ("prefill", "decode"):
            pool = entry_pool
        scheduler = entry.get("scheduler") or {}
        queued += int(
            scheduler.get("depth", scheduler.get("queued", 0)) or 0
        )
        classes = scheduler.get("classes") or {}
        interactive += int(
            (classes.get("interactive") or {}).get("depth", 0) or 0
        )
        health = entry.get("health") or {}
        occupancy += int(health.get("occupancy", 0) or 0)
        slots += int(entry.get("slots", 0) or 0)
        entry_state = health.get("state", "ok")
        if rank.get(entry_state, 2) > rank.get(state, 0):
            state = entry_state if entry_state in rank else "wedged"
        draining = draining or bool(health.get("draining"))
        slo = entry.get("slo") or {}
        alerting.update(slo.get("alerting") or [])
        summary = entry.get("summary") or {}
        window = summary.get("window") or {}
        kv = window.get("kv_used_ratio_last")
        if kv is not None:
            kv_used = max(kv_used or 0.0, float(kv))
        drain_section = entry.get("drain") or {}
        shed += int(drain_section.get("shed", 0) or 0)
        shed += int(scheduler.get("shed", 0) or 0)
        survival = entry.get("survival") or {}
        pool_shrinks += int(survival.get("shrinks", 0) or 0)
        budget_withheld = budget_withheld or bool(
            survival.get("withheld_blocks", 0) or 0
        )
    if healthz is not None and healthz.get("status") == "wedged":
        state = "wedged"
    return ReplicaObservation(
        replica=pod,
        queued=queued,
        queue_interactive=interactive,
        occupancy=occupancy,
        slots=slots,
        kv_used=kv_used,
        shed_total=shed,
        state=state,
        draining=draining,
        slo_alerting=tuple(sorted(alerting)),
        pool=pool,
        pool_shrinks=pool_shrinks,
        budget_withheld=budget_withheld,
    )
