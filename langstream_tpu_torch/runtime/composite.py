"""Composite (fused) agent execution.

Parity: ``CompositeAgentProcessor``
(``langstream-runtime-impl/.../agent/CompositeAgentProcessor.java:36,150``):
the planner fuses consecutive composable stages into one node; at runtime the
stages chain in-memory — each source record flows through every stage, fan-out
included, with per-source-record error attribution preserved.

The port's copy of ``langstream_tpu/runtime/composite.py``; it imports only the port.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

from langstream_tpu_torch.api.agent import (
    AgentContext,
    AgentProcessor,
    ComponentType,
    RecordSink,
    SourceRecordAndResult,
)
from langstream_tpu_torch.api.record import Record
from langstream_tpu_torch.core.asyncutil import spawn_retained

log = logging.getLogger(__name__)


class _CollectorSink:
    """RecordSink that resolves a future once all expected source records
    have reported a result."""

    def __init__(self, expected: int):
        self.expected = expected
        self.results: list[SourceRecordAndResult] = []
        self.future: asyncio.Future[list[SourceRecordAndResult]] = (
            asyncio.get_running_loop().create_future()
        )

    def emit(self, result: SourceRecordAndResult) -> None:
        self.results.append(result)
        if len(self.results) >= self.expected and not self.future.done():
            self.future.set_result(self.results)

    def emit_error(self, source_record: Record, error: Exception) -> None:
        self.emit(SourceRecordAndResult(source_record, [], error))


async def process_await(
    processor: AgentProcessor, records: list[Record]
) -> list[SourceRecordAndResult]:
    """Drive one processor call to completion and gather its emissions."""
    if not records:
        return []
    collector = _CollectorSink(len(records))
    processor.process(records, collector)
    return await collector.future


class CompositeAgentProcessor(AgentProcessor):
    """Chains N processors; emits final results attributed to the original
    source record. Any stage error fails the source record as a whole."""

    def __init__(self, processors: list[AgentProcessor]):
        self.processors = processors
        # strong refs to in-flight per-record chains: the event loop keeps
        # only a weak reference, so an unretained task can be collected
        # mid-chain and its error never reaches the sink (FLOW1003)
        self._chains: set[asyncio.Task] = set()

    async def init(self, configuration: dict[str, Any]) -> None:
        self.configuration = configuration

    async def setup(self, context: AgentContext) -> None:
        self.context = context
        for p in self.processors:
            await p.setup(context)

    async def start(self) -> None:
        for p in self.processors:
            await p.start()

    async def close(self) -> None:
        for p in self.processors:
            await p.close()

    def component_type(self) -> ComponentType:
        return ComponentType.PROCESSOR

    def agent_info(self) -> dict[str, Any]:
        return {
            "composite": [
                {"type": p.agent_type, "info": p.agent_info()} for p in self.processors
            ]
        }

    def process(self, records: list[Record], sink: RecordSink) -> None:
        for record in records:
            # the sink emit below is the real error report — the
            # spawn_retained log line is a DEBUG audit trail, not a
            # second ERROR for a failure the framework already handles
            task = spawn_retained(
                self._chain_one(record), self._chains, log,
                "composite chain task failed", level=logging.DEBUG,
            )

            def _done(t: "asyncio.Task", r: Record = record) -> None:
                if t.cancelled():
                    return  # loop shutdown: no result to attribute
                err = t.exception()
                if err is not None:
                    sink.emit(
                        SourceRecordAndResult(
                            r, [], err if isinstance(err, Exception) else Exception(str(err))
                        )
                    )
                else:
                    sink.emit(SourceRecordAndResult(r, t.result(), None))

            task.add_done_callback(_done)

    async def _chain_one(self, record: Record) -> list[Record]:
        from langstream_tpu_torch.core.tracing import TRACE_HEADER, start_span

        parent = record.header(TRACE_HEADER)
        service = getattr(
            getattr(self, "context", None), "global_agent_id", ""
        ) or "composite"
        current: list[Record] = [record]
        for stage in self.processors:
            if not current:
                return []
            next_records: list[Record] = []
            span = start_span(
                f"stage.{stage.agent_id or stage.agent_type}",
                service=service,
                parent=parent,
                attributes={"stage-type": stage.agent_type},
            )
            try:
                results = await process_await(stage, current)
                for res in results:
                    if res.error is not None:
                        raise res.error
                    next_records.extend(res.results)
            except Exception as e:
                span.end(error=e)
                raise
            span.set_attribute("records-out", len(next_records))
            span.end()
            current = next_records
        return current
