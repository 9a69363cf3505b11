"""Source-record tracker: ties async sink completions back to source commits.

Parity: ``SourceRecordTracker``
(``langstream-runtime-impl/.../agent/SourceRecordTracker.java:17,30``): when a
processor emits N result records for one source record, the source record is
committed only after all N are durably written by the sink. Combined with the
consumer's contiguous-prefix commit this yields at-least-once end-to-end.

The port's copy of ``langstream_tpu/runtime/tracker.py``; it imports only the port.
One repair over it: a commit still awaited counts as pending, so the drain
(:meth:`SourceRecordTracker.wait_for_no_pending`) cannot return, and the
runner cannot close the source, while a commit is on its way to the broker.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable

from langstream_tpu_torch.api.record import Record


class SourceRecordTracker:
    def __init__(self, commit: Callable[[list[Record]], Awaitable[None]]):
        self._commit = commit
        self._remaining: dict[int, int] = {}
        self._records: dict[int, Record] = {}
        self._in_flight = 0  # commits awaited (popped from _remaining already)
        self._all_done = asyncio.Event()
        self._all_done.set()

    def track(self, source_record: Record, num_results: int) -> None:
        rid = id(source_record)
        self._records[rid] = source_record
        if num_results <= 0:
            # nothing to write: commit immediately
            self._remaining[rid] = 0
        else:
            self._remaining[rid] = num_results
            self._all_done.clear()

    async def commit_if_tracked_empty(self, source_record: Record) -> None:
        rid = id(source_record)
        if self._remaining.get(rid) == 0:
            await self._finish(rid)

    async def record_written(self, source_record: Record) -> None:
        rid = id(source_record)
        if rid not in self._remaining:
            return
        self._remaining[rid] -= 1
        if self._remaining[rid] <= 0:
            await self._finish(rid)

    async def record_failed(self, source_record: Record) -> None:
        """Drop tracking without committing (error path decides the fate)."""
        rid = id(source_record)
        self._remaining.pop(rid, None)
        self._records.pop(rid, None)
        self._maybe_set_done()

    async def commit_now(self, source_record: Record) -> None:
        """Force-commit (skip / dead-letter paths)."""
        rid = id(source_record)
        self._remaining.pop(rid, None)
        await self._commit_counted(self._records.pop(rid, source_record))

    async def _finish(self, rid: int) -> None:
        self._remaining.pop(rid, None)
        record = self._records.pop(rid, None)
        if record is not None:
            await self._commit_counted(record)
        else:
            self._maybe_set_done()

    async def _commit_counted(self, record: Record) -> None:
        self._in_flight += 1
        self._all_done.clear()
        try:
            await self._commit([record])
        finally:
            self._in_flight -= 1
            self._maybe_set_done()

    def _maybe_set_done(self) -> None:
        if not self._in_flight and not any(v > 0 for v in self._remaining.values()):
            self._all_done.set()

    def pending_count(self) -> int:
        return self._in_flight + sum(1 for v in self._remaining.values() if v > 0)

    async def wait_for_no_pending(self, timeout: float | None = None) -> bool:
        """Graceful drain (parity: ``AgentRunner.waitForNoPendingRecords``,
        ``AgentRunner.java:562``)."""
        try:
            await asyncio.wait_for(self._all_done.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False
