"""Agent contracts: the code every pipeline stage implements.

Parity: the reference's ``AgentCode`` hierarchy —
``AgentCode``/``AgentSource``/``AgentProcessor``/``AgentSink``/``AgentService``
(``langstream-api/src/main/java/ai/langstream/api/runner/code/*.java``) and
``AgentContext`` (topic access, persistent state dir, metrics, criticalFailure;
``AgentContext.java:25-66``), plus ``ComponentType``
(``api/runtime/ComponentType.java:18``).

All contracts are asyncio-native: the runtime's hot loop is a single asyncio
task per agent replica, with concurrency inside agents expressed via futures
(matching the reference's async-processor + ordered-commit design).

The port's copy of ``langstream_tpu/api/agent.py``; it imports only the port.
"""

from __future__ import annotations

import abc
import asyncio
import enum
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Protocol

from langstream_tpu_torch.api.record import Record


class ComponentType(enum.Enum):
    SOURCE = "source"
    PROCESSOR = "processor"
    SINK = "sink"
    SERVICE = "service"


@dataclass
class SourceRecordAndResult:
    """One processed source record: its results or its failure.

    Parity: ``AgentProcessor.SourceRecordAndResult`` — the unit the processor
    hands to the runtime's :class:`RecordSink`.
    """

    source_record: Record
    results: list[Record] = field(default_factory=list)
    error: Exception | None = None


class RecordSink(Protocol):
    """Where processors emit results (the runtime's write-side)."""

    def emit(self, result: SourceRecordAndResult) -> None: ...

    def emit_error(self, source_record: Record, error: Exception) -> None: ...


class MetricsReporter:
    """Minimal metrics SPI (counter/gauge/histogram), label-scoped per agent.

    Parity: ``MetricsReporter`` SPI (``api/runner/code/MetricsReporter.java``)
    with the Prometheus implementation provided by the runtime layer.
    """

    def with_prefix(self, prefix: str) -> "MetricsReporter":
        return self

    def counter(self, name: str, help: str = "") -> Callable[[int], None]:
        def _inc(n: int = 1) -> None:
            pass

        return _inc

    def gauge(self, name: str, help: str = "") -> Callable[[float], None]:
        def _set(v: float) -> None:
            pass

        return _set

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: tuple[float, ...] | None = None,
    ) -> Callable[[float], None]:
        """Observe a distribution (latencies). Returns ``observe(value)``."""

        def _observe(v: float) -> None:
            pass

        return _observe


class TopicProducerHandle(Protocol):
    async def write(self, record: Record) -> None: ...


class AgentContext:
    """What the runtime hands each agent at init.

    Parity: ``AgentContext.java:25-66`` — persistent state directory (the
    reference's agent-disk PVCs), access to arbitrary topic producers (used by
    streaming completions), metrics, and ``critical_failure`` to abort the
    replica (which the orchestration layer then restarts).
    """

    def __init__(
        self,
        agent_id: str = "",
        global_agent_id: str = "",
        persistent_state_dir: Path | None = None,
        metrics: MetricsReporter | None = None,
        topic_producer_factory: Callable[[str], Any] | None = None,
        critical_failure_handler: Callable[[Exception], None] | None = None,
        bad_record_handler: Callable[[Record, Exception], None] | None = None,
    ):
        self.agent_id = agent_id
        self.global_agent_id = global_agent_id
        self._persistent_state_dir = persistent_state_dir
        self.metrics = metrics or MetricsReporter()
        self._topic_producer_factory = topic_producer_factory
        self._critical_failure_handler = critical_failure_handler
        self._bad_record_handler = bad_record_handler

    def get_persistent_state_directory(self) -> Path | None:
        """Per-agent durable directory (``AgentContext.java:64``)."""
        if self._persistent_state_dir is not None:
            self._persistent_state_dir.mkdir(parents=True, exist_ok=True)
        return self._persistent_state_dir

    def get_topic_producer(self, topic: str):
        """A producer to an arbitrary topic (used by stream-to-topic)."""
        if self._topic_producer_factory is None:
            raise RuntimeError("no topic producer factory configured")
        return self._topic_producer_factory(topic)

    def critical_failure(self, error: Exception) -> None:
        """Fatal, non-record-scoped failure: abort the replica."""
        if self._critical_failure_handler is not None:
            self._critical_failure_handler(error)
        else:
            raise error


class AgentCode(abc.ABC):
    """Base lifecycle contract (``AgentCode.java:25``)."""

    agent_id: str = ""
    agent_type: str = ""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.configuration = configuration

    async def setup(self, context: AgentContext) -> None:
        self.context = context

    async def start(self) -> None:
        pass

    async def close(self) -> None:
        pass

    @abc.abstractmethod
    def component_type(self) -> ComponentType: ...

    def agent_info(self) -> dict[str, Any]:
        """Introspection payload for the /info endpoint."""
        return {}


class AgentSource(AgentCode):
    """Reads records from an external system (``AgentSource.java:22``)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SOURCE

    @abc.abstractmethod
    async def read(self) -> list[Record]: ...

    async def commit(self, records: list[Record]) -> None:
        """At-least-once acknowledgement of fully-processed records."""

    async def permanent_failure(self, record: Record, error: Exception) -> None:
        """A record failed all retries and the policy is not skip: default
        behavior is to surface the error (→ replica restart)."""
        raise error


class AgentProcessor(AgentCode):
    """Transforms records, possibly async and out-of-order
    (``AgentProcessor.java:23``): results are emitted per-source-record into
    the :class:`RecordSink`; the runtime's tracker restores commit order."""

    def component_type(self) -> ComponentType:
        return ComponentType.PROCESSOR

    @abc.abstractmethod
    def process(self, records: list[Record], sink: RecordSink) -> None: ...


class SingleRecordProcessor(AgentProcessor):
    """Convenience: synchronous record→records mapping."""

    async def process_record(self, record: Record) -> list[Record]:
        raise NotImplementedError

    def process(self, records: list[Record], sink: RecordSink) -> None:
        from langstream_tpu_torch.core.tracing import (
            TRACE_HEADER,
            TraceContext,
            reset_current,
            set_current,
        )

        for record in records:
            # bind the record's trace context for the per-record task: the
            # task snapshots contextvars at creation, so deep callees (the
            # serving engine) parent their spans under this record's hop
            # without any signature plumbing
            ctx = TraceContext.parse(record.header(TRACE_HEADER))
            token = set_current(ctx) if ctx is not None else None
            try:
                task = asyncio.ensure_future(self._process_one(record))
            finally:
                if token is not None:
                    reset_current(token)
            task.add_done_callback(lambda t, r=record, s=sink: _deliver(t, r, s))

    async def _process_one(self, record: Record) -> list[Record]:
        return await self.process_record(record)


def _deliver(task: "asyncio.Task[list[Record]]", record: Record, sink: RecordSink) -> None:
    err = task.exception()
    if err is not None:
        sink.emit(SourceRecordAndResult(record, [], err if isinstance(err, Exception) else Exception(str(err))))
    else:
        sink.emit(SourceRecordAndResult(record, task.result(), None))


class AgentSink(AgentCode):
    """Writes records to an external system (``AgentSink.java:22``)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SINK

    @abc.abstractmethod
    async def write(self, record: Record) -> None:
        """Complete when durably written; raise to trigger error policy."""


class AgentService(AgentCode):
    """A long-running service with no record I/O (``AgentService.java``)."""

    def component_type(self) -> ComponentType:
        return ComponentType.SERVICE

    @abc.abstractmethod
    async def run(self) -> None:
        """Run until cancelled."""
