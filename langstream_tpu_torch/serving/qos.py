"""QoS policy types of the multi-tenant scheduler (the port's copy of
``langstream_tpu/serving/qos.py``; that package's ``serving`` import loads
JAX, so the port keeps its own).

The vocabulary the scheduler (``serving/scheduler.py``) and the engine
share:

- **Priority classes** — ``interactive`` / ``default`` / ``batch``, each
  with a WDRR weight (its guaranteed dequeue share under contention), a
  bounded engine-side queue (backpressure instead of unbounded growth),
  and a soft deadline that feeds the preemption cost model.
- **Token buckets** — per-tenant ``requests/s`` and ``generated
  tokens/s`` limits. Request admission is pre-debited (one token per
  request); generated tokens are post-debited on completion, so a tenant
  that just burned a large completion budget is throttled until the
  bucket refills.
- :class:`QosSpec` — the frozen, hashable config object that rides
  inside :class:`~langstream_tpu_torch.serving.engine.ServingConfig`
  (engines are keyed by their config, so every field bottoms out in
  tuples) and round-trips through the app's
  ``tpu-serving-configuration`` resource.

Stdlib only. Clocks are ``time.monotonic()``: these durations feed
throttle decisions and retry-after arithmetic. The deploy-time validation
of an application's ``qos`` sections belongs to the control plane, which
keeps the JAX package's copy. A tenant's ``adapter`` parses here; the
engine refuses a request naming an adapter until multi-LoRA is ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

#: priority classes, highest first — the WDRR visit order and the rank
#: order the preemption policy compares (lower index = more urgent)
PRIORITY_CLASSES = ("interactive", "default", "batch")

_RANK = {name: i for i, name in enumerate(PRIORITY_CLASSES)}

#: per-class defaults: (weight, queue_limit, deadline_s). Weights are the
#: guaranteed WDRR shares (8:4:1 → batch keeps ~8% of admissions under
#: full contention but can never push interactive out); deadlines feed
#: the preemption cost model, not a hard timeout.
_CLASS_DEFAULTS = {
    "interactive": (8, 256, 2.0),
    "default": (4, 256, 10.0),
    "batch": (1, 1024, 120.0),
}

#: the catch-all tenant policy name
DEFAULT_TENANT = "*"


def normalize_priority(value: Any) -> str:
    """Clamp an arbitrary client-supplied priority to a known class —
    unknown names degrade to ``default``, never to an error (a malformed
    header must not fail the request, only its special treatment)."""
    name = str(value or "").strip().lower()
    return name if name in _RANK else "default"


def priority_rank(name: str) -> int:
    """Lower rank = more urgent; unknown names rank as ``default``."""
    return _RANK.get(name, _RANK["default"])


class RateLimited(Exception):
    """Admission refused by QoS policy. ``reason`` is ``throttled`` (a
    tenant bucket is empty) or ``queue-full`` (the class queue hit its
    bound — load shedding); ``retry_after`` is the seconds until the
    refusal is expected to clear (the gateway's ``Retry-After``)."""

    def __init__(self, reason: str, retry_after: float, detail: str = ""):
        self.reason = reason
        self.retry_after = max(0.0, round(retry_after, 3))
        super().__init__(
            detail or f"{reason} (retry after {self.retry_after:.3f}s)"
        )


class TokenBucket:
    """Classic token bucket on the monotonic clock.

    ``debit`` may drive the level negative (post-debited generated
    tokens); ``available`` refills lazily at ``rate``/s up to ``burst``.
    A deterministic ``clock`` injects in tests.
    """

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._level = self.burst
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._level = min(
            self.burst, self._level + (now - self._last) * self.rate
        )
        self._last = now

    def available(self) -> float:
        self._refill()
        return self._level

    def try_acquire(self, n: float = 1.0) -> bool:
        self._refill()
        if self._level >= n:
            self._level -= n
            return True
        return False

    def debit(self, n: float) -> None:
        """Unconditional withdrawal (may go negative): the post-debit for
        costs only known after the fact (generated tokens)."""
        self._refill()
        self._level -= n

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0 when they
        already are; infinity-free: a zero rate reports one burst
        period's worth of seconds as a bounded backoff hint)."""
        self._refill()
        deficit = n - self._level
        if deficit <= 0:
            return 0.0
        if self.rate <= 0:
            return 60.0
        return deficit / self.rate


@dataclasses.dataclass(frozen=True)
class ClassPolicy:
    name: str
    weight: int
    queue_limit: int
    deadline_s: float
    # streaming time-between-tokens target (docs/OBSERVABILITY.md
    # Streaming & TBT): the p99 inter-chunk interval this class
    # promises. Opt-in like deadline_headers — None (the default) means
    # no TBT SLO for the class: no per-class burn tracker, the engine's
    # stream-stall-s default draws the stall line instead. A
    # streaming-configured engine builds one "tbt" burn-rate tracker
    # per declaring class and health() degrades on a fast burn
    # (tbt_burn).
    tbt_p99_s: float | None = None

    def to_dict(self) -> dict[str, Any]:
        out = {
            "weight": self.weight,
            "queue-limit": self.queue_limit,
            "deadline-s": self.deadline_s,
        }
        if self.tbt_p99_s is not None:
            out["tbt-p99-s"] = self.tbt_p99_s
        return out


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Rate limits for one tenant (or the ``*`` catch-all). ``None``
    means unlimited on that axis. ``adapter`` names the LoRA adapter
    this tenant's traffic decodes with (``serving/adapters.py``): the
    gateway stamps it as the ``langstream-adapter`` record header and
    the AI agents forward it into engine options — empty means base
    weights, byte-identical to a pre-adapter deploy."""

    name: str
    requests_per_s: float | None = None
    request_burst: float | None = None
    tokens_per_s: float | None = None
    token_burst: float | None = None
    adapter: str = ""

    def to_dict(self) -> dict[str, Any]:
        out = {
            "requests-per-s": self.requests_per_s,
            "request-burst": self.request_burst,
            "tokens-per-s": self.tokens_per_s,
            "token-burst": self.token_burst,
        }
        if self.adapter:
            out["adapter"] = self.adapter
        return out


@dataclasses.dataclass(frozen=True)
class QosSpec:
    """The engine/gateway QoS policy. Frozen and tuple-valued so a
    :class:`ServingConfig` carrying it stays hashable (engines are
    singleton-cached by config)."""

    enabled: bool = True
    classes: tuple[ClassPolicy, ...] = ()
    tenants: tuple[TenantPolicy, ...] = ()
    preempt: bool = True
    max_preemptions: int = 2
    # end-to-end deadline stamping (serving/handoff.py, docs/
    # RESILIENCE.md): when True the gateway stamps langstream-deadline
    # = now + the class's deadline-s on every produced record that did
    # not bring its own, and the engine's admission gate enforces it
    # 504-shaped. Opt-in: existing QoS deployments treat deadline-s as
    # the preemption cost model only, bit for bit.
    deadline_headers: bool = False

    def class_policy(self, name: str) -> ClassPolicy:
        for policy in self.classes:
            if policy.name == name:
                return policy
        w, q, d = _CLASS_DEFAULTS[normalize_priority(name)]
        return ClassPolicy(normalize_priority(name), w, q, d)

    def tenant_policy(self, tenant: str) -> TenantPolicy | None:
        fallback = None
        for policy in self.tenants:
            if policy.name == tenant:
                return policy
            if policy.name == DEFAULT_TENANT:
                fallback = policy
        return fallback

    def to_dict(self) -> dict[str, Any]:
        return {
            "enabled": self.enabled,
            "classes": {p.name: p.to_dict() for p in self.classes},
            "tenants": {p.name: p.to_dict() for p in self.tenants},
            "preempt": self.preempt,
            "max-preemptions": self.max_preemptions,
            "deadline-headers": self.deadline_headers,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "QosSpec | None":
        """Parse (and validate) the ``qos:`` section of a
        ``tpu-serving-configuration`` resource. ``None``/missing → no QoS
        (the engine keeps its FIFO scheduler). Raises :class:`ValueError`
        on malformed config — the control plane calls this at deploy
        validation so a bad policy fails the deploy, not the first
        request."""
        if d is None:
            return None
        if isinstance(d, QosSpec):
            return d
        if not isinstance(d, dict):
            raise ValueError(f"qos section must be a mapping, got {type(d).__name__}")
        enabled = _parse_bool(d.get("enabled", True))
        classes: list[ClassPolicy] = []
        raw_classes = d.get("classes") or {}
        if not isinstance(raw_classes, dict):
            raise ValueError("qos.classes must be a mapping of class name → policy")
        for name in raw_classes:
            if name not in _RANK:
                raise ValueError(
                    f"qos.classes: unknown priority class {name!r}; "
                    f"known: {list(PRIORITY_CLASSES)}"
                )
        for name in PRIORITY_CLASSES:
            w_def, q_def, d_def = _CLASS_DEFAULTS[name]
            raw = raw_classes.get(name) or {}
            if not isinstance(raw, dict):
                raise ValueError(f"qos.classes.{name} must be a mapping")
            weight = int(raw.get("weight", w_def))
            queue_limit = int(raw.get("queue-limit", raw.get("queue_limit", q_def)))
            deadline = float(raw.get("deadline-s", raw.get("deadline_s", d_def)))
            tbt = _opt_float(raw, "tbt-p99-s", "tbt_p99_s")
            if weight < 1:
                raise ValueError(
                    f"qos.classes.{name}.weight must be >= 1 (a zero weight "
                    f"starves the class — drop its traffic at the gateway "
                    f"instead)"
                )
            if queue_limit < 1:
                raise ValueError(f"qos.classes.{name}.queue-limit must be >= 1")
            if deadline <= 0:
                raise ValueError(f"qos.classes.{name}.deadline-s must be > 0")
            if tbt is not None and tbt <= 0:
                raise ValueError(
                    f"qos.classes.{name}.tbt-p99-s must be > 0 (omit it "
                    f"for no streaming TBT target)"
                )
            classes.append(
                ClassPolicy(name, weight, queue_limit, deadline, tbt)
            )
        tenants: list[TenantPolicy] = []
        raw_tenants = d.get("tenants") or {}
        if not isinstance(raw_tenants, dict):
            raise ValueError("qos.tenants must be a mapping of tenant → limits")
        for tenant in sorted(raw_tenants):
            raw = raw_tenants[tenant] or {}
            if not isinstance(raw, dict):
                raise ValueError(f"qos.tenants.{tenant} must be a mapping")
            rps = _opt_float(raw, "requests-per-s", "requests_per_s")
            tps = _opt_float(raw, "tokens-per-s", "tokens_per_s")
            rburst = _opt_float(raw, "request-burst", "request_burst", "burst")
            tburst = _opt_float(raw, "token-burst", "token_burst")
            for label, value in (("requests-per-s", rps), ("tokens-per-s", tps)):
                if value is not None and value <= 0:
                    raise ValueError(
                        f"qos.tenants.{tenant}.{label} must be > 0 (omit it "
                        f"for unlimited)"
                    )
            adapter = str(raw.get("adapter") or "")
            if adapter:
                # the adapter store's name check, kept inline so this
                # module stays stdlib-only
                if len(adapter) > 120 or not set(adapter) <= _ADAPTER_NAME_OK:
                    raise ValueError(
                        f"qos.tenants.{tenant}.adapter {adapter!r} may only "
                        f"contain [A-Za-z0-9_-] (max 120 chars)"
                    )
            tenants.append(
                TenantPolicy(
                    name=str(tenant),
                    requests_per_s=rps,
                    request_burst=rburst,
                    tokens_per_s=tps,
                    token_burst=tburst,
                    adapter=adapter,
                )
            )
        max_preemptions = int(d.get("max-preemptions", d.get("max_preemptions", 2)))
        if max_preemptions < 0:
            raise ValueError("qos.max-preemptions must be >= 0")
        return cls(
            enabled=enabled,
            classes=tuple(classes),
            tenants=tuple(tenants),
            preempt=_parse_bool(d.get("preempt", True)),
            max_preemptions=max_preemptions,
            deadline_headers=_parse_bool(
                d.get("deadline-headers", d.get("deadline_headers", False))
            ),
        )


#: legal characters in a tenant's adapter name (serving/adapters.py
#: check_adapter_name — adapter names are storage keys + metric labels)
_ADAPTER_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-"
)


def _parse_bool(v: Any) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def _opt_float(raw: dict, *keys: str) -> float | None:
    for key in keys:
        if raw.get(key) is not None:
            return float(raw[key])
    return None


class TenantLimiter:
    """Per-tenant token buckets built from a :class:`QosSpec`, shared by
    the gateway (pre-admission 429s) and the engine scheduler (the same
    policy enforced where the tokens are actually generated).

    Request admission pre-debits one request token and requires the
    tenant's *token* bucket to be non-negative (generated tokens are
    post-debited by :meth:`debit_tokens`, so a tenant that overdrew is
    refused until the refill catches up).

    Tenant names can be client-influenced on unauthenticated gateways
    (``param:tenant``), so every per-tenant map here is LRU-bounded: a
    client rotating random names cannot grow memory without bound. An
    evicted ``'*'``-fallback bucket resets that name's budget — the
    limit a hostile client dodges by rotating identities anyway; real
    per-tenant enforcement needs authenticated subjects (see
    ``docs/SCHEDULING.md``).
    """

    #: max distinct tenants tracked (buckets + counters) before LRU
    #: eviction — bounds client-chosen-identity cardinality
    MAX_TENANTS = 1024

    def __init__(
        self,
        spec: QosSpec,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.spec = spec
        self._clock = clock
        from collections import OrderedDict

        self._requests: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._tokens: "OrderedDict[str, TokenBucket]" = OrderedDict()
        # counters for /qos + engine_top: tenant → {submitted, throttled,
        # tokens-debited}
        self.counters: "OrderedDict[str, dict[str, int]]" = OrderedDict()

    @staticmethod
    def _touch(lru, key, factory):
        value = lru.get(key)
        if value is None:
            value = lru[key] = factory()
        lru.move_to_end(key)
        while len(lru) > TenantLimiter.MAX_TENANTS:
            lru.popitem(last=False)
        return value

    def _counter(self, tenant: str) -> dict[str, int]:
        return self._touch(
            self.counters, tenant,
            lambda: {"submitted": 0, "throttled": 0, "tokens_debited": 0},
        )

    def _buckets(
        self, tenant: str
    ) -> tuple[TokenBucket | None, TokenBucket | None]:
        policy = self.spec.tenant_policy(tenant)
        if policy is None:
            return None, None
        req = tok = None
        if policy.requests_per_s is not None:
            req = self._touch(
                self._requests, tenant,
                lambda: TokenBucket(
                    policy.requests_per_s,
                    policy.request_burst or max(1.0, policy.requests_per_s),
                    clock=self._clock,
                ),
            )
        if policy.tokens_per_s is not None:
            tok = self._touch(
                self._tokens, tenant,
                lambda: TokenBucket(
                    policy.tokens_per_s,
                    policy.token_burst or policy.tokens_per_s,
                    clock=self._clock,
                ),
            )
        return req, tok

    def retry_after(self, tenant: str) -> float | None:
        """Seconds until ``tenant`` could admit a request, or ``None``
        when it can right now. Read-only — debits nothing (the gateway's
        WS-upgrade gate peeks without consuming)."""
        req, tok = self._buckets(tenant)
        waits = []
        if req is not None and req.available() < 1.0:
            waits.append(req.retry_after(1.0))
        if tok is not None and tok.available() < 0.0:
            waits.append(tok.retry_after(0.0))
        return max(waits) if waits else None

    def admit_request(self, tenant: str) -> float | None:
        """Debit one request from ``tenant``'s bucket. ``None`` =
        admitted; a float = refused, retry after that many seconds."""
        self._counter(tenant)["submitted"] += 1
        req, tok = self._buckets(tenant)
        if tok is not None and tok.available() < 0.0:
            self._counter(tenant)["throttled"] += 1
            return tok.retry_after(0.0)
        if req is not None and not req.try_acquire(1.0):
            self._counter(tenant)["throttled"] += 1
            return req.retry_after(1.0)
        return None

    def debit_tokens(self, tenant: str, n: int) -> None:
        """Post-debit ``n`` generated tokens against the tenant's
        tokens/s bucket (no-op for unlimited tenants)."""
        if n <= 0:
            return
        _req, tok = self._buckets(tenant)
        if tok is not None:
            tok.debit(float(n))
            self._counter(tenant)["tokens_debited"] += n

    def stats(self) -> dict[str, dict[str, int]]:
        return {t: dict(c) for t, c in self.counters.items()}

