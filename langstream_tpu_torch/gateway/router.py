"""Replica-aware routing for serving traffic (docs/FLEET.md).

The gateway produces into a topic; with one serving replica that is the
whole story, but a fleet needs the record to land on the replica best
placed to serve it. This module is the gateway's half of that loop:

- :class:`ReplicaRouter` tracks per-replica flight snapshots (the same
  observation dicts the autoscaler consumes — queue depth, occupancy,
  health/drain posture) and picks the **least-loaded eligible** replica:
  load = ``(1 + queue depth) × (1 + occupancy/slots)``, monotone in both
  axes so a deep queue and a full batch each push traffic away.
  Draining, wedged, and unreachable replicas are never eligible — a
  record routed into a dying pod's queue is a record the drain has to
  requeue right back.
- **Session affinity** on the QoS tenant (``langstream-qos-tenant``): a
  conversation keeps hitting the replica that already holds its
  prefix-cache blocks (ROADMAP item 3's warm-TTFT lever), for as long as
  the replica stays eligible and the affinity entry is fresh. Affinity
  is advisory: an ineligible replica breaks it immediately and the
  session re-pins to the new least-loaded pick.
- **Prefix affinity** on the chained prompt-prefix digest the gateway
  stamps (``langstream-prefix-digest``, serving/prefixstore.py): repeat
  traffic for one shared system prompt lands on the replica whose
  tiered prefix store already holds its blocks — across DIFFERENT
  tenants, which tenant affinity cannot see (N tenants sharing a
  preamble is exactly the shape the prefix tiers exist for,
  docs/PREFIX.md). More specific than the tenant pin, so it is
  consulted first; prefix-less traffic takes the pre-existing path
  bit for bit.
- The choice is stamped as the ``langstream-replica`` record header; the
  serving agent's consumer honors it (``runtime/runner.py``): a replica
  that reads a record stamped for a sibling re-produces it back to the
  input topic (bounce-capped) so partition assignment and routing intent
  converge instead of fighting.

Snapshots arrive via :meth:`observe` — pushed by whoever already has
them (the control plane's autoscaler loop, a gateway-side poller, tests)
— and go stale after ``fresh_s``: routing on stale evidence is worse
than no routing, so a router with no fresh snapshot stamps nothing and
the topic's normal partition spread applies.

Stdlib-only, no locks: the router lives on the gateway's event loop;
every method is dict arithmetic (the same wait-free posture the health
plane keeps, and for the same reason — routing runs on the produce hot
path).

The port's copy of ``langstream_tpu/gateway/router.py``; it imports only the port.
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Any, Callable

from langstream_tpu_torch.serving.handoff import (
    OPEN,
    BreakerSpec,
    CircuitBreaker,
)

#: record header carrying the routing choice; the serving agent's
#: consumer honors it (see runtime/runner.py)
REPLICA_HEADER = "langstream-replica"
#: reroute loop guard: bounces a stamped record may take before the
#: consumer serves it locally anyway (better the wrong replica than a
#: record orbiting the topic after its target vanished)
BOUNCE_HEADER = "langstream-replica-bounces"
MAX_BOUNCES = 2


class ReplicaRouter:
    """Least-loaded replica choice with tenant session affinity."""

    #: max tenants pinned before LRU eviction — tenant names can be
    #: client-chosen on unauthenticated gateways (same bound the QoS
    #: limiter keeps)
    MAX_AFFINITY = 4096

    def __init__(
        self,
        fresh_s: float = 15.0,
        affinity_ttl_s: float = 600.0,
        clock: Callable[[], float] = time.monotonic,
        breaker: BreakerSpec | None = None,
    ):
        self.fresh_s = fresh_s
        self.affinity_ttl_s = affinity_ttl_s
        self._clock = clock
        # circuit breakers (serving/handoff.py, docs/RESILIENCE.md):
        # one per replica, created lazily on the FIRST report_failure/
        # report_success — a router nobody reports outcomes to (the
        # classic produce-only gateway) carries an empty dict and routes
        # bit-for-bit as before
        self.breaker_spec = breaker or BreakerSpec()
        self._breakers: dict[str, CircuitBreaker] = {}
        # 503 Retry-After holds: replica -> monotonic release stamp. A
        # replica that shed WITH a hint is not re-offered until the hint
        # elapses (`exclude=` only ever lasted one pick)
        self._holds: dict[str, float] = {}
        self.holds_applied = 0
        # breaker transitions, newest last — stats() serves the tail and
        # on_breaker_event (when wired, e.g. by the handoff chainer)
        # mirrors each into a flight ring
        self.events: deque = deque(maxlen=64)
        self.on_breaker_event: Callable[[str, str, dict], None] | None = None
        # network fault seam (serving/faults.py `route` site): tests arm
        # an injector so a routing outage is a deterministic input
        self.fault_injector = None
        self._replicas: dict[str, dict[str, Any]] = {}
        self._observed_at: float | None = None
        # tenant -> [replica, pinned_at]
        self._affinity: "OrderedDict[str, list]" = OrderedDict()
        # prompt-prefix digest -> [replica, pinned_at] (docs/PREFIX.md):
        # bounded like the tenant map — digests derive from prompt text,
        # which clients control
        self._prefix_affinity: "OrderedDict[str, list]" = OrderedDict()
        # adapter name -> [replica, pinned_at] (docs/ADAPTERS.md): a
        # tenant's LoRA adapter rides the replica whose device/T1 tiers
        # already hold it — re-routing pays a T2 hydration, so the pin
        # sits beside the prefix pin and is bounded the same way
        self._adapter_affinity: "OrderedDict[str, list]" = OrderedDict()
        self.picks = 0
        self.affinity_hits = 0
        self.affinity_rerouted = 0
        self.prefix_hits = 0
        self.prefix_rerouted = 0
        self.adapter_hits = 0
        self.adapter_rerouted = 0
        # disaggregated pools (docs/DISAGG.md): the phase of the latest
        # pick ("prefill"/"decode"/"any") — engine_top's split-fleet view
        self.last_pick_phase: str | None = None

    # -- snapshot ingestion ---------------------------------------------

    def observe(self, snapshots: list[dict[str, Any]]) -> None:
        """Replace the fleet view with fresh per-replica observation
        dicts (the shape of ``ReplicaObservation`` in the JAX package's
        ``controlplane/autoscaler.py``: ``replica``/``queued``/``occupancy``/
        ``slots``/``state``/``draining``/``unreachable``)."""
        self._replicas = {
            s["replica"]: dict(s) for s in snapshots if s.get("replica")
        }
        self._observed_at = self._clock()

    def fresh(self) -> bool:
        return (
            self._observed_at is not None
            and self._clock() - self._observed_at <= self.fresh_s
        )

    # -- choice ----------------------------------------------------------

    @staticmethod
    def _eligible(snapshot: dict[str, Any]) -> bool:
        return not (
            snapshot.get("unreachable")
            or snapshot.get("draining")
            or snapshot.get("state") == "wedged"
        )

    # -- failure feedback: breakers + Retry-After holds ------------------

    def _emit_breaker(self, kind: str, replica: str, **detail: Any) -> None:
        detail["open_replicas"] = sum(
            1 for b in self._breakers.values() if b.state == OPEN
        )
        entry = {"kind": kind, "replica": replica, "m_s": self._clock(),
                 **detail}
        self.events.append(entry)
        if self.on_breaker_event is not None:
            self.on_breaker_event(kind, replica, detail)

    def report_failure(self, replica: str, kind: str = "error") -> None:
        """One failed call against ``replica`` (timeout / refused / bad
        HTTP): feeds its rolling breaker window; enough inside the
        window flip it OPEN and it leaves every subsequent ``pick``
        until a half-open probe proves it back (docs/RESILIENCE.md)."""
        breaker = self._breakers.get(replica)
        if breaker is None:
            breaker = self._breakers[replica] = CircuitBreaker(
                self.breaker_spec, clock=self._clock
            )
        before = breaker.state
        after = breaker.record_failure(kind)
        if after == OPEN and before != OPEN:
            self._emit_breaker(
                "breaker-open", replica,
                failures=breaker.stats()["window_failures"],
                last_kind=kind,
            )

    def report_success(self, replica: str) -> None:
        """One successful call: closes a half-open breaker (the probe
        proved the replica back) and clears the failure window."""
        breaker = self._breakers.get(replica)
        if breaker is None:
            return
        before = breaker.state
        after = breaker.record_success()
        if before != after:
            self._emit_breaker("breaker-close", replica)

    def hold(self, replica: str, retry_after_s: float) -> None:
        """503 ``Retry-After`` hold: the replica shed WITH a hint, so it
        is not re-offered until the hint elapses — a plain ``exclude=``
        only lasted one pick, and the next pick walked straight back
        into the saturated replica."""
        self._holds[replica] = self._clock() + max(0.0, retry_after_s)
        self.holds_applied += 1

    def _routable(self, name: str, now: float) -> bool:
        """Breaker + hold gate on top of snapshot eligibility. Expired
        holds are dropped here (the map self-cleans on the pick path)."""
        until = self._holds.get(name)
        if until is not None:
            if now < until:
                return False
            del self._holds[name]
        breaker = self._breakers.get(name)
        return breaker is None or breaker.can_serve(now)

    def _chosen(self, name: str) -> str:
        """Account the pick against a half-open breaker's probe budget
        (only a pick that actually routes traffic burns a probe)."""
        breaker = self._breakers.get(name)
        if breaker is not None:
            breaker.note_probe()
        return name

    @staticmethod
    def _pool(snapshot: dict[str, Any]) -> str:
        return snapshot.get("pool") or "combined"

    def _pooled(self) -> bool:
        """True once any replica declares a split pool role — the
        moment phase filtering engages. Combined-only fleets never see
        it, so today's behavior stays bit-for-bit."""
        return any(
            self._pool(snap) != "combined"
            for snap in self._replicas.values()
        )

    def _phase_ok(self, snapshot: dict[str, Any], phase: str | None) -> bool:
        """Phase filter (disaggregated fleets only): new requests go to
        the prefill pool, handoffs to the decode pool; a combined
        replica in a mixed fleet serves either phase."""
        if phase is None or not self._pooled():
            return True
        pool = self._pool(snapshot)
        return pool == phase or pool == "combined"

    @staticmethod
    def _load(snapshot: dict[str, Any]) -> float:
        """(1 + queue depth) × (1 + occupancy/slots): a replica with an
        empty queue and an empty batch scores 1.0; queue growth scales
        the score linearly, batch fullness up to 2×."""
        slots = snapshot.get("slots") or 0
        occ_frac = (snapshot.get("occupancy") or 0) / slots if slots else 0.0
        return (1.0 + (snapshot.get("queued") or 0)) * (1.0 + occ_frac)

    def eligible(self) -> list[str]:
        return sorted(
            name
            for name, snap in self._replicas.items()
            if self._eligible(snap)
        )

    def pick(
        self,
        tenant: str | None = None,
        phase: str | None = None,
        exclude: Any = (),
        prefix: str | None = None,
        adapter: str | None = None,
    ) -> str | None:
        """The replica for one record: the tenant's pinned replica while
        it stays eligible and fresh, else the least-loaded eligible
        replica (ties break on name for determinism). ``None`` when the
        fleet view is stale or empty — stamp nothing, let the topic's
        partition spread route.

        ``phase`` (disaggregated fleets, docs/DISAGG.md) restricts the
        choice to that pool — ``"prefill"`` for new requests,
        ``"decode"`` for KV handoff targets; it is a no-op while every
        replica is ``combined``, so a classic fleet's routing stays
        bit-for-bit. ``exclude`` names replicas the caller already tried
        (a decode replica that answered 503 — retry the next one).

        ``prefix`` (the gateway's chained prompt-prefix digest,
        docs/PREFIX.md) pins MORE specifically than the tenant: repeat
        traffic for one shared system prompt returns to the replica
        whose prefix tiers hold its blocks, whatever tenant sent it.
        Consulted before the tenant pin; ``None`` (prefix-less traffic)
        leaves the pre-existing choice bit for bit.

        ``adapter`` (the gateway's ``langstream-adapter`` stamp,
        docs/ADAPTERS.md) pins the tenant's LoRA adapter to the replica
        whose adapter tiers already hold it — a re-route costs a T2
        hydration plus a device-row load, which is the multi-LoRA
        analogue of a cold prefix. Consulted after the prefix pin
        (an exact shared-prompt match is stronger evidence) and before
        the tenant pin; adapter-less traffic is untouched."""
        if self.fault_injector is not None:
            # deterministic routing outage (serving/faults.py `route`
            # site): drop = no pick this pass, error = the registry blew
            # up — both shapes chaos tests aim at the chainer's
            # no-healthy-replica path
            action = self.fault_injector.fire("route")
            if action is not None:
                if action.shape == "error":
                    raise RuntimeError(action.message)
                if action.shape == "delay-ms":
                    time.sleep(action.hang_ms / 1000.0)  # injected routing stall (tests and chaos only)
                else:
                    return None
        if not self.fresh():
            return None
        now = self._clock()
        exclude = set(exclude or ())
        candidates = [
            (self._load(snap), name)
            for name, snap in self._replicas.items()
            if self._eligible(snap)
            and self._phase_ok(snap, phase)
            and name not in exclude
            and self._routable(name, now)
        ]
        if not candidates:
            return None
        self.last_pick_phase = phase or "any"
        if phase == "decode":
            # handoff targets are pure least-loaded: session affinity is
            # a prefix-cache-locality lever, and prefix blocks live on
            # the PREFILL pool — pinning decode picks under the tenant
            # would thrash the prefill pin instead
            self.picks += 1
            return self._chosen(min(candidates)[1])
        if prefix:
            pinned = self._prefix_affinity.get(prefix)
            if pinned is not None:
                replica, pinned_at = pinned
                snap = self._replicas.get(replica)
                if (
                    snap is not None
                    and self._eligible(snap)
                    and self._phase_ok(snap, phase)
                    and replica not in exclude
                    and self._routable(replica, now)
                    and now - pinned_at <= self.affinity_ttl_s
                ):
                    # the replica already holding this prompt's prefix
                    # blocks (T0/T1/T2 — docs/PREFIX.md): warm TTFT
                    # beats load spread for shared-preamble traffic
                    pinned[1] = now
                    self._prefix_affinity.move_to_end(prefix)
                    self.picks += 1
                    self.prefix_hits += 1
                    if tenant:
                        # keep the tenant pin converged on the same
                        # replica so the two affinity maps never fight
                        self._pin_tenant(tenant, replica, now)
                    if adapter:
                        self._pin_adapter(adapter, replica, now)
                    return self._chosen(replica)
                self.prefix_rerouted += 1
        if adapter:
            pinned = self._adapter_affinity.get(adapter)
            if pinned is not None:
                replica, pinned_at = pinned
                snap = self._replicas.get(replica)
                if (
                    snap is not None
                    and self._eligible(snap)
                    and self._phase_ok(snap, phase)
                    and replica not in exclude
                    and self._routable(replica, now)
                    and now - pinned_at <= self.affinity_ttl_s
                ):
                    # the replica whose adapter tiers already hold this
                    # fine-tune (device rows or T1 host RAM): warm
                    # adapter TTFT beats load spread (docs/ADAPTERS.md)
                    pinned[1] = now
                    self._adapter_affinity.move_to_end(adapter)
                    self.picks += 1
                    self.adapter_hits += 1
                    if tenant:
                        self._pin_tenant(tenant, replica, now)
                    return self._chosen(replica)
                self.adapter_rerouted += 1
        if tenant:
            pinned = self._affinity.get(tenant)
            if pinned is not None:
                replica, pinned_at = pinned
                snap = self._replicas.get(replica)
                if (
                    snap is not None
                    and self._eligible(snap)
                    and self._phase_ok(snap, phase)
                    and replica not in exclude
                    and self._routable(replica, now)
                    and now - pinned_at <= self.affinity_ttl_s
                ):
                    # refresh the pin: an active conversation keeps its
                    # prefix-cache locality for as long as it stays warm
                    pinned[1] = now
                    self._affinity.move_to_end(tenant)
                    self.picks += 1
                    self.affinity_hits += 1
                    if prefix:
                        self._pin_prefix(prefix, replica, now)
                    if adapter:
                        self._pin_adapter(adapter, replica, now)
                    return self._chosen(replica)
                self.affinity_rerouted += 1
        choice = min(candidates)[1]
        self.picks += 1
        if tenant:
            self._pin_tenant(tenant, choice, now)
        if prefix:
            self._pin_prefix(prefix, choice, now)
        if adapter:
            self._pin_adapter(adapter, choice, now)
        return self._chosen(choice)

    def _pin_tenant(self, tenant: str, replica: str, now: float) -> None:
        self._affinity[tenant] = [replica, now]
        self._affinity.move_to_end(tenant)
        while len(self._affinity) > self.MAX_AFFINITY:
            self._affinity.popitem(last=False)

    def _pin_prefix(self, prefix: str, replica: str, now: float) -> None:
        self._prefix_affinity[prefix] = [replica, now]
        self._prefix_affinity.move_to_end(prefix)
        while len(self._prefix_affinity) > self.MAX_AFFINITY:
            self._prefix_affinity.popitem(last=False)

    def _pin_adapter(self, adapter: str, replica: str, now: float) -> None:
        self._adapter_affinity[adapter] = [replica, now]
        self._adapter_affinity.move_to_end(adapter)
        while len(self._adapter_affinity) > self.MAX_AFFINITY:
            self._adapter_affinity.popitem(last=False)

    # -- introspection ---------------------------------------------------

    def stats(self) -> dict[str, Any]:
        # per-pool eligibility census: the split-fleet view engine_top's
        # pools panel renders (combined-only fleets report one
        # "combined" row — the pre-disaggregation shape, just grouped)
        pools: dict[str, dict[str, int]] = {}
        for snap in self._replicas.values():
            entry = pools.setdefault(
                self._pool(snap), {"replicas": 0, "eligible": 0}
            )
            entry["replicas"] += 1
            if self._eligible(snap):
                entry["eligible"] += 1
        return {
            "replicas": {
                name: {
                    "load": round(self._load(snap), 3),
                    "eligible": self._eligible(snap),
                    "queued": snap.get("queued", 0),
                    "occupancy": snap.get("occupancy", 0),
                    "draining": bool(snap.get("draining")),
                    "state": snap.get("state", "ok"),
                    "unreachable": bool(snap.get("unreachable")),
                    "pool": self._pool(snap),
                }
                for name, snap in sorted(self._replicas.items())
            },
            "pools": {k: pools[k] for k in sorted(pools)},
            "last_pick_phase": self.last_pick_phase,
            "fresh": self.fresh(),
            "picks": self.picks,
            "affinity_hits": self.affinity_hits,
            "affinity_rerouted": self.affinity_rerouted,
            "pinned_tenants": len(self._affinity),
            # prefix-affinity counters (docs/PREFIX.md): repeat shared-
            # preamble traffic landing back on the replica holding its
            # blocks vs pins broken by an ineligible/stale replica
            "prefix_hits": self.prefix_hits,
            "prefix_rerouted": self.prefix_rerouted,
            "pinned_prefixes": len(self._prefix_affinity),
            # adapter-affinity counters (docs/ADAPTERS.md): traffic naming
            # a LoRA adapter landing back on the replica whose tiers
            # already hold it vs pins broken by stale/ineligible replicas
            "adapter_hits": self.adapter_hits,
            "adapter_rerouted": self.adapter_rerouted,
            "pinned_adapters": len(self._adapter_affinity),
            # circuit-breaker posture (docs/RESILIENCE.md): per-replica
            # state machines + the transition tail the autoscaler/
            # engine_top read; breaker_open_replicas is the headline
            # pressure gauge (routable capacity lost to dead pods)
            "breakers": {
                name: b.stats() for name, b in sorted(self._breakers.items())
            },
            "breaker_open_replicas": sum(
                1 for b in self._breakers.values() if b.state == OPEN
            ),
            "breaker_events": list(self.events),
            # live Retry-After holds (replica -> seconds until release)
            "held_replicas": {
                name: round(max(0.0, until - self._clock()), 3)
                for name, until in sorted(self._holds.items())
                if until > self._clock()
            },
            "holds_applied": self.holds_applied,
        }


def split_replica_target(value: str) -> tuple[str, int | None]:
    """``(base, ordinal)`` of a routing stamp: ``'app-ai-2'`` →
    ``('app-ai', 2)``, a bare ordinal ``'2'`` → ``('', 2)``, no trailing
    ordinal → ``(value, None)``. The consumer honors a stamp only when
    the base names *its own* StatefulSet (or is empty): a stamp
    targeting a sibling agent's pods must pass through untouched, or a
    two-stage pipeline would bounce every record at its second hop."""
    head, _sep, tail = value.rpartition("-")
    if tail.isdigit():
        return head, int(tail)
    return value, None
