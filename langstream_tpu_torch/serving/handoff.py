"""Cross-replica failure domain: deadlines, retry and re-route, circuit
breakers and the handoff chainer (the port's copy of
``langstream_tpu/serving/handoff.py``, with the JAX engine's
``_deadline_from_options`` as :func:`deadline_from_options`).

- **End-to-end deadlines**: the ``langstream-deadline`` header value is an
  absolute wall-clock epoch stamp (seconds, decimal string), stamped at
  the gateway and carried through record headers, the KV handoff wire
  header and ``/kv/import``. :func:`remaining_s` clamps to non-negative (a
  skewed clock reads "expired now", never a negative timeout) and
  :func:`socket_timeout_s` derives every cross-replica call's timeout from
  the budget left.
- **Retry with re-route**: :class:`RetryPolicy` is capped exponential
  backoff with deterministic jitter, hashed from the request id and the
  attempt (a chaos run replays the same schedule, in either package).
- **Circuit breakers**: :class:`CircuitBreaker` is the
  CLOSED, OPEN, HALF_OPEN, CLOSED machine over a rolling failure window;
  a router holds one per replica, so a dead decode pod is left out of its
  picks until a half-open probe proves it back.
- **The handoff chainer**: :class:`HandoffChainer` drives one prefill
  export to a finished generation: it offers the payload to the router's
  decode pick, re-offers to the next healthy replica on 404, timeout or
  refusal with backoff, and past the cap imports the payload back into
  the prefill engine itself (``local_fallback``): the snapshot is the
  whole request state, so local decode equals the disaggregated path
  token for token.

Refusals (the ``/kv/import`` table): 409 (layout mismatch) and 504
(deadline exceeded) are terminal, since no sibling answers differently;
503 with Retry-After holds that replica until the hint lapses; timeouts
and connection errors are retried elsewhere and counted against the
replica's breaker.

Stdlib only but for the optional ``aiohttp`` transport, imported inside
:func:`http_transport` (the card's machine has none). Every synchronous
method is dict and float arithmetic: the breaker and the deadline helpers
run on admission paths.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import time
from typing import Any, Awaitable, Callable

log = logging.getLogger(__name__)

#: record/HTTP header carrying the absolute wall-clock deadline (epoch
#: seconds, decimal string). Wall clock, not monotonic: the value must
#: mean the same thing on every replica that reads it.
DEADLINE_HEADER = "langstream-deadline"

#: floor/cap for deadline-derived socket timeouts: the floor keeps a
#: nearly-expired budget from degenerating into a 0-second connect (the
#: refusal should come from the deadline check, not ECONNABORTED); the
#: cap bounds a deadline-less call, so no cross-replica call is
#: unbounded
SOCKET_TIMEOUT_FLOOR_S = 0.05
SOCKET_TIMEOUT_CAP_S = 30.0


class DeadlineExceeded(Exception):
    """The request's end-to-end budget is spent (or provably cannot
    cover the work about to be dispatched). 504-shaped by contract:
    the pod ``/kv/import`` handler maps it to HTTP 504 and the engine
    refuses BEFORE any device work — never a silent late completion."""

    def __init__(self, detail: str = "", overrun_s: float = 0.0):
        super().__init__(detail or "deadline exceeded")
        self.overrun_s = overrun_s


def parse_deadline(value: Any) -> float | None:
    """An epoch-seconds deadline out of a header/option value, or None.
    Malformed values are None, never an error — a garbage deadline must
    degrade to "no deadline", not refuse a request the budget allows."""
    if value is None:
        return None
    try:
        deadline = float(value)
    except (TypeError, ValueError):
        return None
    return deadline if deadline > 0 else None


def remaining_s(deadline: float | None, now: float | None = None) -> float | None:
    """Seconds of budget left (None = no deadline). Clamped to >= 0:
    clock skew between replicas can put a freshly-stamped deadline in
    this host's past, and a negative budget must read "expired now" —
    never flow into a timeout/backoff computation as a negative."""
    if deadline is None:
        return None
    return max(0.0, deadline - (time.time() if now is None else now))


def socket_timeout_s(
    deadline: float | None,
    now: float | None = None,
    floor: float = SOCKET_TIMEOUT_FLOOR_S,
    cap: float = SOCKET_TIMEOUT_CAP_S,
) -> float:
    """The socket timeout one cross-replica HTTP call may spend: the
    remaining deadline budget, floored (a near-expired budget still gets
    a real connect; the deadline check itself does the refusing) and
    capped (a deadline-less call still carries an explicit bound)."""
    left = remaining_s(deadline, now)
    if left is None:
        return cap
    return max(floor, min(left, cap))


def deadline_from_options(options: dict) -> float | None:
    """The request's absolute epoch deadline out of its options (the JAX
    engine's ``_deadline_from_options``): ``deadline`` (epoch seconds, the
    forwarded ``langstream-deadline`` header) wins over ``deadline-s`` (a
    budget relative to now; a non-positive one is expired on arrival).
    Malformed values are None."""
    deadline = parse_deadline(options.get("deadline"))
    if deadline is not None:
        return deadline
    rel = options.get("deadline-s")
    if rel is None:
        return None
    try:
        rel = float(rel)
    except (TypeError, ValueError):
        return None
    return time.time() + max(0.0, rel)


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter.

    ``attempts`` bounds the re-offers before the chainer falls back to
    local decode. Jitter is hashed from ``(key, attempt)`` instead of
    drawn from a PRNG so a chaos test replays the exact schedule —
    determinism is the whole fault plane's contract."""

    attempts: int = 3
    backoff_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError("retry attempts must be >= 1")
        if self.backoff_s <= 0 or self.backoff_cap_s < self.backoff_s:
            raise ValueError("need 0 < backoff-s <= backoff-cap-s")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def delay_s(self, attempt: int, key: str = "") -> float:
        """Backoff before re-offer ``attempt`` (0-based): base * 2^n,
        capped, +/- jitter derived from blake2b(key, attempt)."""
        base = min(self.backoff_s * (2.0 ** attempt), self.backoff_cap_s)
        if not self.jitter:
            return base
        h = hashlib.blake2b(
            f"{key}:{attempt}".encode(), digest_size=4
        ).digest()
        # uniform in [-jitter, +jitter], deterministic in (key, attempt)
        frac = (int.from_bytes(h, "little") / 0xFFFFFFFF) * 2.0 - 1.0
        return max(0.0, base * (1.0 + self.jitter * frac))


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BreakerSpec:
    """Rolling-window breaker tuning: ``failures`` inside ``window_s``
    flip OPEN; after ``open_s`` the breaker goes HALF_OPEN and grants
    ``half_open_probes`` probe picks — one success closes it, one
    failure re-opens it."""

    failures: int = 3
    window_s: float = 30.0
    open_s: float = 5.0
    half_open_probes: int = 1

    def __post_init__(self):
        if self.failures < 1:
            raise ValueError("breaker failures must be >= 1")
        if self.window_s <= 0 or self.open_s <= 0:
            raise ValueError("breaker window-s and open-s must be > 0")
        if self.half_open_probes < 1:
            raise ValueError("breaker half-open-probes must be >= 1")


CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Per-target failure breaker (CLOSED→OPEN→HALF_OPEN→CLOSED).

    Wait-free by construction (deque + float compares — it sits on the
    router's pick hot path). The caller owns the clock so the state
    machine is a pure function of the recorded history — the unit tests
    drive it with a fake clock."""

    def __init__(
        self,
        spec: BreakerSpec | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.spec = spec or BreakerSpec()
        self._clock = clock
        self.state = CLOSED
        # rolling failure stamps (monotonic seconds); successes clear it
        self._failures: list[float] = []
        self._opened_at: float | None = None
        self._probes_granted = 0
        self._probe_granted_at: float | None = None
        self.opens = 0
        self.closes = 0
        self.failure_count = 0
        self.timeout_count = 0
        self.last_kind: str | None = None

    def _trim(self, now: float) -> None:
        cutoff = now - self.spec.window_s
        self._failures = [t for t in self._failures if t >= cutoff]

    def record_failure(self, kind: str = "error") -> str:
        """Count one failure/timeout against the window; returns the
        state after the transition (the router turns OPEN edges into
        breaker-open events)."""
        now = self._clock()
        self.failure_count += 1
        if kind == "timeout":
            self.timeout_count += 1
        self.last_kind = kind
        if self.state == HALF_OPEN:
            # the probe failed: straight back to OPEN for a fresh window
            self.state = OPEN
            self._opened_at = now
            self.opens += 1
            self._failures = []
            return self.state
        self._failures.append(now)
        self._trim(now)
        if self.state == CLOSED and len(self._failures) >= self.spec.failures:
            self.state = OPEN
            self._opened_at = now
            self.opens += 1
        return self.state

    def record_success(self) -> str:
        """A call to the target succeeded: a half-open probe closes the
        breaker; in CLOSED the failure window clears (the window counts
        CONSECUTIVE trouble, not lifetime totals)."""
        if self.state in (HALF_OPEN, OPEN):
            # OPEN success = a call raced the transition; proof of life
            # either way
            self.state = CLOSED
            self.closes += 1
        self._failures = []
        self._probes_granted = 0
        self._probe_granted_at = None
        self._opened_at = None
        return self.state

    def can_serve(self, now: float | None = None) -> bool:
        """Non-consuming eligibility check: CLOSED serves; OPEN past its
        cooldown flips HALF_OPEN; HALF_OPEN serves while probe budget
        remains. Does NOT burn a probe — :meth:`note_probe` does, and
        only when the caller actually routed to the target (a stats poll
        must never eat the probe budget)."""
        now = self._clock() if now is None else now
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if (
                self._opened_at is not None
                and now - self._opened_at >= self.spec.open_s
            ):
                self.state = HALF_OPEN
                self._probes_granted = 0
                return True
            return False
        # HALF_OPEN: serve while probe budget remains. A granted probe
        # whose outcome never reports back (a picker with no feedback
        # path — the gateway's produce route — or a caller that died
        # mid-call) RELEASES after another open_s: a breaker must never
        # exclude forever (the zombie-exclusion refusal,
        # docs/RESILIENCE.md)
        if self._probes_granted >= self.spec.half_open_probes:
            if (
                self._probe_granted_at is not None
                and now - self._probe_granted_at >= self.spec.open_s
            ):
                self._probes_granted = 0
                self._probe_granted_at = None
                return True
            return False
        return True

    def note_probe(self) -> None:
        """The caller routed real traffic to a HALF_OPEN target: one
        probe slot is spent until its success/failure reports back (or
        its grant ages out after another ``open_s`` — see
        :meth:`can_serve`)."""
        if self.state == HALF_OPEN:
            self._probes_granted += 1
            self._probe_granted_at = self._clock()

    def stats(self) -> dict[str, Any]:
        return {
            "state": self.state,
            "window_failures": len(self._failures),
            "failures": self.failure_count,
            "timeouts": self.timeout_count,
            "opens": self.opens,
            "closes": self.closes,
            "last_kind": self.last_kind,
        }


# ---------------------------------------------------------------------------
# the handoff chainer
# ---------------------------------------------------------------------------

#: transport contract: ``await transport(replica, payload, headers,
#: timeout_s)`` → ``(status, body_dict, response_headers)``. Connection
#: failures raise ``(ConnectionError, OSError, asyncio.TimeoutError)``.
Transport = Callable[
    [str, bytes, dict[str, str], float],
    Awaitable[tuple[int, dict[str, Any], dict[str, str]]],
]


class HandoffLost(RuntimeError):
    """The export payload is gone (consumed, evicted, or never made) —
    nothing to re-offer AND nothing to decode locally. The journal (when
    configured) still holds the accepted request, so a restart replays
    it as fresh work; this error makes the loss loud in the meantime."""


def http_transport(
    resolve: Callable[[str], str],
    session_factory: Callable[[], Any] | None = None,
) -> Transport:
    """The production transport: POST the payload to the replica's
    ``/kv/import`` over aiohttp, socket timeout supplied per call by the
    chainer (derived from the deadline; never unbounded).
    ``resolve`` maps a replica name to its base URL (in-cluster: the
    headless-service pod DNS name the StatefulSet split publishes)."""
    import aiohttp

    async def _offer(
        session, replica: str, payload: bytes, headers: dict[str, str],
        timeout_s: float,
    ) -> tuple[int, dict[str, Any], dict[str, str]]:
        async with session.post(
            f"{resolve(replica).rstrip('/')}/kv/import",
            data=payload,
            headers=headers,
            timeout=aiohttp.ClientTimeout(total=timeout_s),
        ) as resp:
            try:
                body = await resp.json(content_type=None)
            except ValueError:
                body = {}
            return resp.status, body or {}, dict(resp.headers)

    async def _post(
        replica: str, payload: bytes, headers: dict[str, str], timeout_s: float
    ) -> tuple[int, dict[str, Any], dict[str, str]]:
        if session_factory is not None:
            # the caller OWNS the session (and its lifecycle): never
            # close it here — a shared session must survive the next
            # offer
            return await _offer(
                session_factory(), replica, payload, headers, timeout_s
            )
        async with aiohttp.ClientSession() as session:
            return await _offer(session, replica, payload, headers, timeout_s)

    return _post


class HandoffChainer:
    """Drives one prefill export to a completed generation, surviving
    the decode side (docs/RESILIENCE.md "Distributed failure domain").

    The chainer is the prefill side's consumer of handoff tickets:
    ``chain(ticket)`` re-offers the payload to
    the router's decode picks under :class:`RetryPolicy`, feeds the
    router's per-replica breakers with every outcome, honors 503
    ``Retry-After`` as a per-replica hold, derives every socket timeout
    from the deadline budget, and — when the cap is reached or no
    healthy decode replica remains — imports the payload back into the
    prefill engine itself (``local_fallback``): the serialized snapshot
    is the complete request state, so local decode is byte-identical to
    the disaggregated path. Every outcome lands in the engine's flight
    ring (``handoff-retry`` / ``handoff-fallback`` / ``breaker-*``
    events) and counters — a re-offer is never invisible."""

    def __init__(
        self,
        engine,
        router=None,
        transport: Transport | None = None,
        policy: RetryPolicy | None = None,
        sleep: Callable[[float], Awaitable[None]] = asyncio.sleep,
    ):
        self.engine = engine
        self.router = router
        self.transport = transport
        self.policy = policy or RetryPolicy()
        self._sleep = sleep
        self.completed = 0
        self.retries = 0
        self.fallbacks = 0
        if router is not None and getattr(router, "on_breaker_event", None) is None:
            # breaker transitions become flight events on the prefill
            # engine: the one ring chaos assertions already read
            router.on_breaker_event = self._breaker_event

    def _breaker_event(self, kind: str, replica: str, detail: dict) -> None:
        self.engine.flight.event(kind, replica=replica, **detail)
        self.engine.note_breaker_open(
            open_replicas=detail.get("open_replicas", 0)
        )

    async def _net_fault(self, site: str) -> tuple[int, dict, dict] | None:
        """Network fault seam (serving/faults.py): consult the engine's
        injector at the chainer's HTTP boundaries. ``drop`` raises the
        connection away, ``delay-ms`` stalls the call, ``error`` answers
        a synthetic HTTP 500 — each a deterministic chaos input."""
        injector = getattr(self.engine, "_faults", None)
        if injector is None:
            return None
        action = injector.fire(site)
        if action is None:
            return None
        self.engine.note_fault_fired(
            site=site, shape=action.shape, fire=action.seq,
            hang_ms=action.hang_ms if action.shape == "delay-ms" else None,
        )
        if action.shape == "drop":
            raise ConnectionError(action.message)
        if action.shape == "delay-ms":
            await self._sleep(action.hang_ms / 1000.0)
            return None
        if action.shape == "error":
            return 500, {"error": action.message}, {}
        return None

    @staticmethod
    def _retry_after(body: dict, headers: dict) -> float:
        for source in (headers.get("Retry-After"), headers.get("retry-after"),
                       body.get("retry_after_s")):
            try:
                if source is not None:
                    return max(0.0, float(source))
            except (TypeError, ValueError):
                continue
        return 1.0

    async def chain(self, ticket: dict[str, Any] | str) -> dict[str, Any]:
        """One handoff ticket (the ``finish_reason: "handoff"`` result
        of ``generate()`` on a prefill-role engine, or the bare request
        id) to a completed generation result."""
        rid = ticket if isinstance(ticket, str) else ticket.get("handoff")
        if not rid:
            raise ValueError("not a handoff ticket (no 'handoff' id)")
        # settle=False: the chainer's pickup is NOT the answer — the
        # journal entry stays live until the decode side's outcome
        # arrives (the pull-model pod pickup settles at take, where no
        # later feedback exists)
        entry = self.engine.take_export_entry(rid, settle=False)
        if entry is None:
            raise HandoffLost(
                f"export {rid!r} is gone (already taken or evicted); "
                f"the journal replay covers it on restart"
            )
        payload: bytes = entry["payload"]
        deadline = parse_deadline(entry.get("deadline"))
        headers: dict[str, str] = {}
        if entry.get("trace"):
            headers["langstream-trace"] = str(entry["trace"])
        if deadline is not None:
            headers[DEADLINE_HEADER] = repr(deadline)
        # exclusion is ONE pick deep (the replica that just failed):
        # durable exclusion belongs to the breaker/hold machinery, and a
        # replica whose breaker is still CLOSED deserves another offer
        # after the backoff — that second failure is what trips it
        exclude: set[str] = set()
        attempt = 0
        while attempt < self.policy.attempts:
            target = None
            if self.router is not None:
                target = self.router.pick(phase="decode", exclude=exclude)
                if target is None and exclude:
                    # the just-failed replica is the whole pool: after
                    # the backoff it deserves the re-offer itself
                    # (breaker/hold permitting) — a sole decode replica
                    # must not lose the handoff to one transient blip
                    target = self.router.pick(phase="decode")
            exclude = set()
            if target is None:
                break  # no healthy decode replica left: local decode
            if self.transport is None:
                # a local configuration error: raised OUTSIDE the offer
                # try, or it would be misread as a replica refusal and
                # poison healthy replicas' breakers
                raise ValueError(
                    f"HandoffChainer has no transport to offer "
                    f"{rid!r} to replica {target!r}"
                )
            terminal: Exception | None = None
            try:
                injected = await self._net_fault("http-import")
                if injected is not None:
                    status, body, resp_headers = injected
                else:
                    status, body, resp_headers = await self.transport(
                        target, payload, headers,
                        socket_timeout_s(deadline),
                    )
            except asyncio.TimeoutError:
                self.router.report_failure(target, "timeout")
                self._note_retry(rid, target, attempt, "timeout")
                exclude = {target}
                await self._sleep(self.policy.delay_s(attempt, rid))
                attempt += 1
                continue
            except (ConnectionError, OSError) as e:
                self.router.report_failure(target, "error")
                self._note_retry(rid, target, attempt, f"refused: {e}")
                exclude = {target}
                await self._sleep(self.policy.delay_s(attempt, rid))
                attempt += 1
                continue
            if status == 200:
                self.router.report_success(target)
                self.engine.handoff_settled(rid)
                self.completed += 1
                return body
            if status == 503:
                # an explicit shed with a hint: the replica ANSWERED —
                # alive, just saturated. Proof of life closes/feeds its
                # breaker (a half-open probe answered 503 must re-admit
                # the replica once the hold lapses, not strand it); the
                # hold, not the breaker, owns the backpressure
                self.router.report_success(target)
                hint = self._retry_after(body, resp_headers)
                self.router.hold(target, hint)
                self._note_retry(
                    rid, target, attempt, f"shed (retry-after {hint:g}s)"
                )
                exclude = {target}
                attempt += 1
                continue
            if status == 409:
                terminal = LookupError(
                    f"decode pool refused the handoff layout: "
                    f"{body.get('error')}"
                )
            elif status == 504:
                terminal = DeadlineExceeded(
                    str(body.get("error") or "deadline exceeded in transit")
                )
            if terminal is not None:
                # refusals no sibling will answer differently: the
                # decode side ANSWERED (409/504 + its own flight event),
                # so the journal entry retires — a replay would only
                # repeat the refusal later — and the answering replica
                # is alive (a probe that drew a refusal still closes
                # the breaker)
                self.router.report_success(target)
                self.engine.handoff_settled(rid)
                raise terminal
            # 404/5xx: the pod is up but wrong (restarted mid-handoff,
            # import route broken) — breaker food, try the next replica
            self.router.report_failure(target, "error")
            self._note_retry(rid, target, attempt, f"http {status}")
            exclude = {target}
            await self._sleep(self.policy.delay_s(attempt, rid))
            attempt += 1
        # ---- local-decode fallback -----------------------------------
        self.fallbacks += 1
        self.engine.note_handoff_fallback(rid, attempts=attempt)
        result = await self.engine.import_handoff(payload, local_fallback=True)
        # the local finish retires the journal entry by journey id; this
        # drops the rid mapping too so unsettled_handoffs reads true
        self.engine.handoff_settled(rid)
        self.completed += 1
        return result

    def _note_retry(self, rid: str, target: str, attempt: int, why: str) -> None:
        self.retries += 1
        self.engine.note_handoff_retry(
            rid, replica=target, attempt=attempt, reason=why
        )

    def stats(self) -> dict[str, Any]:
        return {
            "completed": self.completed,
            "retries": self.retries,
            "fallbacks": self.fallbacks,
            "policy_attempts": self.policy.attempts,
        }
