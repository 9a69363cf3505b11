"""Ordered async micro-batching.

Parity: ``OrderedAsyncBatchExecutor`` (``langstream-api/.../util/
OrderedAsyncBatchExecutor.java:39``): N hash buckets preserve per-key order
while batching expensive calls (embeddings, completions) by size and flush
interval. This is the shim between per-record topic consumption and the
batched, TPU-efficient forward passes of the serving engine — keeping batches
large for the MXU while per-key ordering survives.

The port's copy of ``langstream_tpu/api/batching.py``; it imports only the port.
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable, Generic, TypeVar

T = TypeVar("T")

BatchProcessor = Callable[[list[T]], Awaitable[None]]


class OrderedAsyncBatchExecutor(Generic[T]):
    """Batches items into up to ``num_buckets`` independent ordered lanes.

    - Items with the same key always land in the same bucket, and a bucket
      never has two batches in flight: per-key processing order is preserved.
    - A bucket flushes when it reaches ``batch_size`` or when
      ``flush_interval`` seconds elapse with pending items (0 = flush on
      every add, i.e. effectively unbatched).
    """

    def __init__(
        self,
        batch_size: int,
        processor: BatchProcessor,
        flush_interval: float = 0.0,
        num_buckets: int = 4,
        key_fn: Callable[[T], Any] | None = None,
    ):
        self.batch_size = max(1, batch_size)
        self.processor = processor
        self.flush_interval = flush_interval
        self.num_buckets = max(1, num_buckets)
        self.key_fn = key_fn or (lambda item: None)
        self._buckets: list[_Bucket] = [
            _Bucket(self) for _ in range(self.num_buckets)
        ]

    async def add(self, item: T) -> None:
        key = self.key_fn(item)
        bucket = self._buckets[hash(key) % self.num_buckets if key is not None else 0]
        await bucket.add(item)

    async def flush(self) -> None:
        await asyncio.gather(*(b.flush() for b in self._buckets))

    async def close(self) -> None:
        await self.flush()
        for b in self._buckets:
            b.cancel_timer()


class _Bucket:
    def __init__(self, parent: OrderedAsyncBatchExecutor):
        self.parent = parent
        self.pending: list[Any] = []
        self._lock = asyncio.Lock()
        self._in_flight: asyncio.Task | None = None
        self._timer: asyncio.TimerHandle | None = None

    async def add(self, item: Any) -> None:
        async with self._lock:
            self.pending.append(item)
            if len(self.pending) >= self.parent.batch_size or (
                self.parent.flush_interval == 0
            ):
                await self._drain_locked()
            elif self._timer is None and self.parent.flush_interval > 0:
                loop = asyncio.get_running_loop()
                self._timer = loop.call_later(
                    self.parent.flush_interval,
                    lambda: asyncio.ensure_future(self.flush()),
                )

    async def flush(self) -> None:
        async with self._lock:
            await self._drain_locked()

    async def _drain_locked(self) -> None:
        self.cancel_timer()
        while self.pending:
            batch, self.pending = self.pending, []
            # One batch in flight per bucket: awaiting here serialises the
            # bucket while other buckets proceed concurrently.
            await self.parent.processor(batch)

    def cancel_timer(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
