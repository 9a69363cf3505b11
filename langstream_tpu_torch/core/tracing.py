"""Request tracing: the propagated context, spans and their bounded buffer
(the port's copy of the parts of ``langstream_tpu/core/tracing.py`` that
the engine and the KV handoff wire use).

A record carries a ``langstream-trace`` header (W3C ``traceparent``
shape, ``00-<32 hex trace id>-<16 hex span id>-01``); the serving engine
reads it from the ambient context at ``generate()`` and, at completion,
records the request's ``engine.queue``/``engine.prefill``/
``engine.decode`` phases (and ``engine.kv-export``, ``engine.kv-import``,
``engine.preempt``, ``engine.resume`` where they happen) as child spans
under it. The handoff header carries the same value, so a prefill pool
and a decode pool of either package record under one trace id.

- **stdlib only**, importable from every layer;
- **cheap**: a span is one small object and one bounded deque append; ids
  come from ``os.urandom``, durations from ``time.monotonic()`` (wall time
  only anchors a span on a human timeline);
- **never raises** into the traced path;
- **bounded**: finished spans land in :data:`SPANS`, a process-global ring
  of ``LS_TPU_TRACE_BUFFER`` entries (default 2048, at least 64).

The ambient context is a :class:`contextvars.ContextVar`: ``asyncio``
tasks snapshot it at creation, which is the per-record task boundary the
platform's runner uses. The platform's own context class never reaches
this package: ``serve_torch.py`` and the provider hand it over as a header
string (:meth:`TraceContext.parse`).
"""

from __future__ import annotations

import contextvars
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

log = logging.getLogger(__name__)

#: the record header that carries the trace context across hops
TRACE_HEADER = "langstream-trace"

_VERSION = "00"
_FLAGS = "01"  # sampled


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def fresh_trace_id() -> str:
    """A new 32-hex trace-id-shaped identifier: the journey ledger keys an
    untraced request with one, so a journey id always has a trace id's
    shape, and the journal keys every accepted request by it."""
    return _hex_id(16)


@dataclass(frozen=True)
class TraceContext:
    """One (trace, parent span) coordinate: what the header encodes."""

    trace_id: str  # 32 hex chars
    span_id: str   # 16 hex chars

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(trace_id=_hex_id(16), span_id=_hex_id(8))

    @classmethod
    def parse(cls, header: Any) -> "TraceContext | None":
        """Parse a ``langstream-trace``/``traceparent`` value; None when it
        is absent or malformed (a bad client header starts no trace, it
        never refuses the request)."""
        if not isinstance(header, str):
            return None
        parts = header.strip().split("-")
        if len(parts) != 4:
            return None
        version, trace_id, span_id, _flags = parts
        if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
        except ValueError:
            return None
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        return cls(trace_id=trace_id, span_id=span_id)

    def to_header(self) -> str:
        return f"{_VERSION}-{self.trace_id}-{self.span_id}-{_FLAGS}"

    def child(self) -> "TraceContext":
        """The same trace with a fresh span id."""
        return TraceContext(trace_id=self.trace_id, span_id=_hex_id(8))


# ---------------------------------------------------------------------------
# ambient context (per record, task-scoped)
# ---------------------------------------------------------------------------

_current: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "langstream_torch_trace_context", default=None
)


def current_context() -> TraceContext | None:
    return _current.get()


def set_current(ctx: TraceContext | None) -> contextvars.Token:
    return _current.set(ctx)


def reset_current(token: contextvars.Token) -> None:
    try:
        _current.reset(token)
    except ValueError:
        # a token of another context (a callback crossed tasks)
        _current.set(None)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class Span:
    """One timed operation. ``end()`` is idempotent and never raises; an
    unfinished span never reaches the buffer."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "service",
        "attributes", "error", "_start_mono", "_start_wall_ms", "_ended",
    )

    def __init__(self, name: str, service: str, trace_id: str, span_id: str,
                 parent_id: str | None, attributes: dict[str, Any] | None = None):
        self.name = name
        self.service = service
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attributes = dict(attributes) if attributes else {}
        self.error: str | None = None
        self._start_mono = time.monotonic()
        # the wall clock anchors the span on a timeline; durations are
        # monotonic
        self._start_wall_ms = time.time() * 1000.0
        self._ended = False

    def context(self) -> TraceContext:
        """This span as a parent coordinate."""
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def end(self, error: BaseException | str | None = None) -> float:
        """Finish the span; returns its duration in seconds. A second end
        keeps the first timing."""
        duration_s = time.monotonic() - self._start_mono
        if self._ended:
            return duration_s
        self._ended = True
        if isinstance(error, BaseException):
            self.error = str(error) or error.__class__.__name__
        elif error is not None:
            self.error = str(error)
        try:
            SPANS.add(self._to_dict(duration_s))
        except Exception:  # tracing never breaks the traced path
            log.debug("span buffer append failed", exc_info=True)
        return duration_s

    def _to_dict(self, duration_s: float) -> dict[str, Any]:
        out: dict[str, Any] = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "service": self.service,
            "start_ms": round(self._start_wall_ms, 3),
            "duration_ms": round(duration_s * 1000.0, 3),
        }
        if self.attributes:
            out["attributes"] = self.attributes
        if self.error:
            out["error"] = self.error
        return out

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end(error=exc)


def start_span(name: str, service: str,
               parent: "TraceContext | Span | str | None" = None,
               attributes: dict[str, Any] | None = None) -> Span:
    """Open a span. ``parent`` is a context, a span, a raw header value or
    None; None (or a malformed header) falls back to the ambient context,
    then to a fresh root trace."""
    if isinstance(parent, Span):
        ctx: TraceContext | None = parent.context()
    elif isinstance(parent, TraceContext):
        ctx = parent
    else:
        ctx = TraceContext.parse(parent)
    if ctx is None:
        ctx = current_context()
    if ctx is None:
        return Span(name, service, trace_id=_hex_id(16), span_id=_hex_id(8),
                    parent_id=None, attributes=attributes)
    return Span(name, service, trace_id=ctx.trace_id, span_id=_hex_id(8),
                parent_id=ctx.span_id, attributes=attributes)


def record_span(name: str, service: str,
                parent: "TraceContext | Span | str | None",
                start_monotonic: float, end_monotonic: float,
                attributes: dict[str, Any] | None = None) -> None:
    """Record a span after the fact from monotonic stamps already taken (the
    engine's phases are timed by its own request stamps; their spans are
    made at completion). Never raises."""
    try:
        span = start_span(name, service, parent=parent, attributes=attributes)
        duration_s = max(0.0, end_monotonic - start_monotonic)
        # start_ms was stamped now: shift it back to the phase's start
        span._start_wall_ms -= (time.monotonic() - start_monotonic) * 1000.0
        span._ended = True
        SPANS.add(span._to_dict(duration_s))
    except Exception:
        log.debug("record_span failed", exc_info=True)


# ---------------------------------------------------------------------------
# the span ring
# ---------------------------------------------------------------------------


class SpanBuffer:
    """Bounded, thread-safe buffer of finished spans (plain dicts), one per
    process."""

    def __init__(self, maxlen: int = 2048):
        self._spans: deque[dict[str, Any]] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        #: another buffer every span is also added to (``None``: none);
        #: ``serve_torch.py`` points it at the JAX package's, so the pod's
        #: ``/traces`` routes list both packages' spans under one trace
        self.mirror = None

    def add(self, span: dict[str, Any]) -> None:
        with self._lock:
            self._spans.append(span)
        if self.mirror is not None:
            self.mirror.add(span)

    def snapshot(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def spans(self, trace_id: str) -> list[dict[str, Any]]:
        """Every buffered span of one trace, oldest first."""
        return [s for s in self.snapshot() if s.get("trace_id") == trace_id]

    def summaries(self) -> list[dict[str, Any]]:
        """Per-trace rollup for the ``/traces`` index: span count, services,
        the root-most span's name, total wall span and errors."""
        by_trace: dict[str, list[dict[str, Any]]] = {}
        for span in self.snapshot():
            by_trace.setdefault(span["trace_id"], []).append(span)
        out = []
        for trace_id, spans in by_trace.items():
            ids = {s["span_id"] for s in spans}
            roots = [s for s in spans if s.get("parent_id") not in ids]
            root = min(roots or spans, key=lambda s: s.get("start_ms", 0.0))
            start = min(s.get("start_ms", 0.0) for s in spans)
            end = max(s.get("start_ms", 0.0) + s.get("duration_ms", 0.0) for s in spans)
            out.append({
                "trace_id": trace_id,
                "spans": len(spans),
                "root": root.get("name"),
                "services": sorted({s.get("service", "") for s in spans}),
                "start_ms": start,
                "duration_ms": round(end - start, 3),
                "errors": sum(1 for s in spans if s.get("error")),
            })
        out.sort(key=lambda t: t["start_ms"])
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


def _buffer_size() -> int:
    try:
        return max(64, int(os.environ.get("LS_TPU_TRACE_BUFFER", "2048")))
    except ValueError:
        return 2048


#: the process-global span buffer
SPANS = SpanBuffer(maxlen=_buffer_size())
