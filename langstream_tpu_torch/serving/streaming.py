"""Streaming token delivery: the TBT digest and disconnect-as-cancellation
(the port's copy of ``langstream_tpu/serving/streaming.py``).

The engine's chunk-emission plane (``TorchServingEngine._flush_emits``)
delivers ``(new_token_ids, new_text, is_final)`` to a per-request
``on_chunk`` consumer at every decode-chunk boundary. This module holds
the two pieces that plane needs:

- :class:`TbtDigest` — a **bounded** inter-emit interval digest
  (log-spaced buckets, p50/p99/max/count). The per-request record in
  ``request_timings`` and the per-class aggregate behind
  ``stats()["streaming"]`` are both this shape; the raw interval list is
  never stored.
- :class:`StreamCancelRegistry` / :data:`STREAMS` — the bridge that turns
  a gateway-observed client disconnect into an engine-side cancellation.
  The engine registers each request's future under its ``stream-key``
  (the ``langstream-stream-id`` header the gateway stamped); the gateway
  calls :meth:`~StreamCancelRegistry.cancel` from its socket teardown.
  Cancellation lands via ``loop.call_soon_threadsafe``, so the gateway may
  live on another thread and loop than the engine; the engine's decode
  loop observes ``future.cancelled()`` at the next chunk boundary and
  frees the slot. Entries self-clean through a future done-callback, so
  an abandoned key never pins a request object.

The engine calls only :meth:`StreamCancelRegistry.register` on the
registry it is given, so a launcher that runs the port under the JAX
package's gateway hands in that package's registry (``serve_torch.py``);
:data:`STREAMS` is the port's own, the default.

:meth:`TbtDigest.add` is pure arithmetic — no locks, no I/O, no device
sync — because it runs inside ``_flush_emits`` between decode dispatches.
The registry's lock is taken only at request register/unregister and at
gateway teardown, never per token.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any

__all__ = ["TbtDigest", "StreamCancelRegistry", "STREAMS"]


def _log_bounds() -> tuple:
    """Bucket upper bounds: 1 ms growing ~1.33x per bucket out to ~200 s
    (48 buckets). Built once at import; quantiles interpolate nothing —
    they answer with the bucket bound, which at 1.33x spacing is within
    ~15% of the true value, plenty for an alerting digest."""
    bounds = []
    v = 0.001
    for _ in range(48):
        bounds.append(v)
        v *= 4.0 / 3.0
    return tuple(bounds)


class TbtDigest:
    """Bounded time-between-emissions digest: log-spaced bucket counts
    plus exact count/max/sum. ~50 ints per instance regardless of stream
    length; ``add`` is two comparisons, a scan-free bucket index, and
    three attribute bumps — wait-free by construction."""

    BOUNDS = _log_bounds()

    __slots__ = ("counts", "count", "max", "sum")

    def __init__(self) -> None:
        self.counts = [0] * (len(self.BOUNDS) + 1)
        self.count = 0
        self.max = 0.0
        self.sum = 0.0

    def add(self, interval_s: float) -> None:
        if interval_s < 0.0:
            interval_s = 0.0
        # inline binary search (≤6 probes over 48 bounds): no imports,
        # no allocation, nothing a hot emit path has to wait on
        lo, hi = 0, len(self.BOUNDS)
        while lo < hi:
            mid = (lo + hi) // 2
            if interval_s <= self.BOUNDS[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.sum += interval_s
        if interval_s > self.max:
            self.max = interval_s

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile observation
        (0 with no observations). The overflow bucket answers with the
        exact observed max — an off-scale stall must not be clipped to
        the last bound."""
        if self.count == 0:
            return 0.0
        rank = max(1, int(q * self.count + 0.999999))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i < len(self.BOUNDS):
                    return min(self.BOUNDS[i], self.max)
                return self.max
        return self.max

    def summary(self) -> dict[str, Any]:
        return {
            "count": self.count,
            "p50": round(self.quantile(0.50), 6),
            "p99": round(self.quantile(0.99), 6),
            "max": round(self.max, 6),
            "mean": round(self.sum / self.count, 6) if self.count else 0.0,
        }


class StreamCancelRegistry:
    """stream-key → in-flight request futures, with cross-loop cancel.

    One process-wide instance (:data:`STREAMS`). The engine registers at
    admission (``generate(options={"stream-key": ...})``) and entries
    remove themselves when the future resolves either way; the gateway
    cancels from its disconnect teardown. A key may map to several
    futures (a client can produce many records on one socket before any
    finishes) — cancel sweeps them all.
    """

    #: bound on the cancelled-key memory below — old keys fall off LRU
    CANCELLED_KEYS_MAX = 1024

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # key -> {future: loop}
        self._streams: dict[str, dict[Any, Any]] = {}
        # keys cancel() has seen, kept (bounded) so the agent layer can
        # tell a disconnect-driven CancelledError apart from a shutdown
        # cancel — and so a record that reaches the engine AFTER its
        # client disconnected is cancelled at registration instead of
        # decoding to a dead socket. Values are unused (ordered-set).
        self._cancelled: "OrderedDict[str, None]" = OrderedDict()

    def register(self, key: str, future, loop) -> None:
        with self._lock:
            late_cancel = key in self._cancelled
            self._streams.setdefault(key, {})[future] = loop
        # self-clean on resolution (result, cancel, exception): the
        # callback runs on the engine's loop, after which the key no
        # longer holds the request object
        future.add_done_callback(lambda f: self.unregister(key, f))
        if late_cancel:
            # the disconnect arrived before this record did (the produce
            # sat in the topic behind a queue): every token it would
            # decode is waste, so cancel it the same way cancel() would
            try:
                loop.call_soon_threadsafe(future.cancel)
            except RuntimeError:
                pass

    def unregister(self, key: str, future) -> None:
        with self._lock:
            entry = self._streams.get(key)
            if entry is not None:
                entry.pop(future, None)
                if not entry:
                    self._streams.pop(key, None)

    def cancel(self, key: str) -> int:
        """Cancel every in-flight future registered under ``key``;
        returns how many were signalled. Safe from any thread — the
        cancel itself is marshalled onto each future's own loop."""
        with self._lock:
            entry = dict(self._streams.get(key) or {})
            self._cancelled[key] = None
            self._cancelled.move_to_end(key)
            while len(self._cancelled) > self.CANCELLED_KEYS_MAX:
                self._cancelled.popitem(last=False)
        for future, loop in entry.items():
            try:
                loop.call_soon_threadsafe(future.cancel)
            except RuntimeError:
                # loop already closed: the engine is gone, nothing to free
                pass
        return len(entry)

    def consume_cancelled(self, key: str) -> bool:
        """True exactly once per cancelled key: the agent layer calls
        this when ``engine.generate`` raises ``CancelledError`` to decide
        whether the cancel was a client disconnect (terminal for the
        record — commit it, emit nothing) or a process shutdown (must
        keep propagating). Consuming removes the key."""
        with self._lock:
            if key in self._cancelled:
                del self._cancelled[key]
                return True
            return False

    def active(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._streams.values())


#: process-wide registry: the engine writes, the gateway cancels
STREAMS = StreamCancelRegistry()
