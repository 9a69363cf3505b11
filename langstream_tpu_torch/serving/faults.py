"""Deterministic fault-injection plane for the serving engine (the port's
copy of ``langstream_tpu/serving/faults.py``; the same sites, shapes,
validation messages and per-plan pass counters).

- :class:`FaultPlan`: one declared fault: the engine **site** it fires at,
  how many passes through the site to let through first (``after``), how
  many times it fires before disarming (``count``), and its **shape**:
  ``oom`` raises a synthetic allocator failure whose message the engine's
  ``_resource_exhausted`` classifier matches, ``hang`` stalls the calling
  thread for ``hang_ms`` (the dispatch goes quiet, the watchdog's
  heartbeat stops, ``health()`` must read WEDGED).
- :class:`FaultInjector`: the armed registry the engine's seams consult.
  Arming is explicit (``ServingConfig.faults`` or the ``LS_TPU_FAULTS``
  variable, tests and chaos drills only); a production engine carries
  ``None`` and every seam costs one attribute test. Every fired fault is
  handed back to the engine, which emits a ``fault-injected`` flight
  event: chaos assertions read the event ring.

Sites the port fires: ``pool-grow`` (decode and admission block growth),
``prefill`` (the prefill and chunked-continuation dispatches),
``scatter`` (host rows into the pool: imports and T1 promotions),
``fetch`` (a decode chunk's or speculative step's device-to-host copy) and
``t2-get`` (the prefix and adapter hydrators' object-storage reads).
The network sites fire on the cross-replica path: ``http-export`` at the
engine's ``take_export_entry``, ``http-import`` in the
:class:`~langstream_tpu_torch.serving.handoff.HandoffChainer`'s offers,
and ``route`` in a router that holds this injector (the platform's
``ReplicaRouter.fault_injector``).

Determinism: ``after``/``count`` are plain pass counters per plan, bumped
at the site, so a chaos test can aim a fault at exactly the N-th
pool-grow of a flood and get the same burst every run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any

#: engine seams a plan may target: four device seams, then the network
#: seams (``http-export``/``http-import``: the handoff chainer's pickup and
#: offer calls, ``t2-get``: the hydrators' object-storage fetch,
#: ``route``: the replica router's pick)
FAULT_SITES = (
    "pool-grow", "prefill", "scatter", "fetch",
    "http-export", "http-import", "t2-get", "route",
)

#: fault shapes: a synthetic allocator refusal, a stalled dispatch, and
#: the three network shapes — ``drop`` (connection refused/reset before
#: any HTTP answer), ``delay-ms`` (the call completes ``hang_ms`` late:
#: the deadline/timeout plane must absorb it), ``error`` (a synthetic
#: HTTP 500 — the pod answered, wrongly)
FAULT_SHAPES = ("oom", "hang", "drop", "delay-ms", "error")

#: shapes that stall for ``hang_ms`` and therefore require it > 0
_TIMED_SHAPES = ("hang", "delay-ms")

#: the default synthetic message, spelled like a real allocator failure so
#: the engine's ``_resource_exhausted`` classifier treats injected and
#: genuine faults alike
_DEFAULT_MESSAGE = "RESOURCE_EXHAUSTED: injected device allocator failure"


class InjectedFault(RuntimeError):
    """A synthetic device failure raised at an armed engine seam. Carries
    the site so the shrink machinery's evidence names where it fired."""

    def __init__(self, site: str, message: str):
        super().__init__(message)
        self.fault_site = site


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One declared fault (frozen/hashable: rides ``ServingConfig``)."""

    site: str
    shape: str = "oom"
    #: passes through the site to let through before the first fire
    after: int = 0
    #: times the fault fires before disarming (fail-then-recover)
    count: int = 1
    #: stall duration for ``shape="hang"`` (milliseconds)
    hang_ms: float = 0.0
    message: str = _DEFAULT_MESSAGE

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(
                f"fault site must be one of {list(FAULT_SITES)}, "
                f"got {self.site!r}"
            )
        if self.shape not in FAULT_SHAPES:
            raise ValueError(
                f"fault shape must be one of {list(FAULT_SHAPES)}, "
                f"got {self.shape!r}"
            )
        if self.after < 0:
            raise ValueError("fault after must be >= 0")
        if self.count < 1:
            raise ValueError("fault count must be >= 1")
        if self.shape in _TIMED_SHAPES and self.hang_ms <= 0:
            raise ValueError(f"{self.shape} faults need hang-ms > 0")

    def to_dict(self) -> dict[str, Any]:
        return {
            "site": self.site,
            "shape": self.shape,
            "after": self.after,
            "count": self.count,
            "hang-ms": self.hang_ms,
            "message": self.message,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultPlan":
        if isinstance(d, FaultPlan):
            return d
        if not isinstance(d, dict):
            raise ValueError(
                f"fault plan must be a mapping, got {type(d).__name__}"
            )
        return cls(
            site=str(d.get("site", "")),
            shape=str(d.get("shape", "oom")),
            after=int(d.get("after", 0)),
            count=int(d.get("count", 1)),
            hang_ms=float(d.get("hang-ms", d.get("hang_ms", 0.0))),
            message=str(d.get("message", _DEFAULT_MESSAGE)),
        )


def plans_from_env(env: dict | None = None) -> tuple[FaultPlan, ...]:
    """Parse ``LS_TPU_FAULTS`` (a JSON list of plan dicts), the arm path
    for chaos drills against a deployed pod. Malformed JSON raises: a
    chaos run whose faults silently failed to arm would assert against a
    healthy engine and "pass"."""
    raw = (env if env is not None else os.environ).get("LS_TPU_FAULTS", "")
    if not raw.strip():
        return ()
    parsed = json.loads(raw)
    if not isinstance(parsed, list):
        raise ValueError("LS_TPU_FAULTS must be a JSON list of fault plans")
    return tuple(FaultPlan.from_dict(p) for p in parsed)


@dataclasses.dataclass
class FaultAction:
    """What the engine must do for one fired fault."""

    site: str
    shape: str
    hang_ms: float
    message: str
    #: 1-based fire index within the plan (event evidence)
    seq: int


class FaultInjector:
    """The armed per-engine registry. ``fire(site)`` is consulted at each
    seam pass; the seams span the engine loop, the dispatch and fetch
    threads and the hydrators, so the pass and fire counters live under
    one lock. Returns the :class:`FaultAction` to perform or ``None``. One
    plan fires per pass even when several target the same site
    (declaration order)."""

    def __init__(self, plans: tuple[FaultPlan, ...]):
        self.plans = tuple(plans)
        self._lock = threading.Lock()
        self._seen = [0] * len(self.plans)
        self._fired = [0] * len(self.plans)

    def fire(self, site: str) -> FaultAction | None:
        with self._lock:
            for i, plan in enumerate(self.plans):
                if plan.site != site:
                    continue
                self._seen[i] += 1
                if self._seen[i] <= plan.after:
                    continue
                if self._fired[i] >= plan.count:
                    continue  # disarmed: fail-then-recover
                self._fired[i] += 1
                return FaultAction(
                    site=site,
                    shape=plan.shape,
                    hang_ms=plan.hang_ms,
                    message=plan.message,
                    seq=self._fired[i],
                )
        return None

    def stats(self) -> list[dict[str, Any]]:
        with self._lock:
            return [
                {
                    "site": plan.site,
                    "shape": plan.shape,
                    "after": plan.after,
                    "count": plan.count,
                    "seen": self._seen[i],
                    "fired": self._fired[i],
                    "armed": self._fired[i] < plan.count,
                }
                for i, plan in enumerate(self.plans)
            ]
