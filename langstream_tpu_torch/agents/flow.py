"""Flow-control agents.

Parity: ``langstream-agents-flow-control`` — ``dispatch`` (expression-routed
to topics or drop, ``agents/flow/DispatchAgent.java:34-36``), ``timer-source``
(``TimerSource.java``), ``trigger-event`` (``TriggerEventProcessor.java``),
``log-event`` (``LogEventProcessor.java``).

The port's copy of ``langstream_tpu/agents/flow.py``; it imports only the port.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from langstream_tpu_torch.api.agent import AgentSource, SingleRecordProcessor
from langstream_tpu_torch.api.record import MutableRecord, Record, make_record
from langstream_tpu_torch.core.expressions import evaluate, render_template
from langstream_tpu_torch.runtime.runner import DESTINATION_TOPIC_HEADER

log = logging.getLogger(__name__)


class DispatchAgent(SingleRecordProcessor):
    """``dispatch``: route each record to the first matching route's
    destination topic (or drop it)."""

    async def process_record(self, record: Record) -> list[Record]:
        mutable = MutableRecord.from_record(record)
        for route in self.configuration.get("routes", []):
            when = route.get("when")
            if when is None or evaluate(when, mutable):
                action = route.get("action", "dispatch")
                if action == "drop":
                    return []
                destination = route.get("destination")
                if destination:
                    return [record.with_headers({DESTINATION_TOPIC_HEADER: destination})]
                return [record]
        return [record]  # no route matched → default output


class TimerSource(AgentSource):
    """``timer-source``: emits a templated record every ``period-seconds``."""

    async def start(self) -> None:
        self._next_fire = time.monotonic() + self._period()

    def _period(self) -> float:
        return float(self.configuration.get("period-seconds", 60))

    async def read(self) -> list[Record]:
        now = time.monotonic()
        if now < self._next_fire:
            await asyncio.sleep(min(0.2, self._next_fire - now))
            return []
        self._next_fire = time.monotonic() + self._period()
        fields = {}
        for f in self.configuration.get("fields", []):
            fields[f["name"].removeprefix("value.")] = evaluate(
                str(f["expression"]), None, extra={"now": time.time()}
            )
        return [make_record(value=fields or {"fired-at": time.time()})]


class TriggerEventProcessor(SingleRecordProcessor):
    """``trigger-event``: when the guard matches, emit a derived event record
    to a destination topic (continue-processing semantics preserved)."""

    async def process_record(self, record: Record) -> list[Record]:
        mutable = MutableRecord.from_record(record)
        when = self.configuration.get("when")
        out = [record]
        if when is None or evaluate(when, mutable):
            destination = self.configuration.get("destination")
            fields = {}
            for f in self.configuration.get("fields", []):
                fields[f["name"].removeprefix("value.")] = evaluate(
                    str(f["expression"]), mutable
                )
            event = make_record(
                value=fields or mutable.value,
                key=record.key,
                headers={DESTINATION_TOPIC_HEADER: destination} if destination else {},
            )
            if self.configuration.get("continue-processing", True):
                out.append(event)
            else:
                out = [event]
        return out


class LogEventProcessor(SingleRecordProcessor):
    """``log-event``: log a templated message per record, pass through."""

    async def process_record(self, record: Record) -> list[Record]:
        mutable = MutableRecord.from_record(record)
        when = self.configuration.get("when")
        if when is None or evaluate(when, mutable):
            message = self.configuration.get("message", "{{ value }}")
            log.info("[%s] %s", self.agent_id, render_template(message, mutable))
        return [record]
