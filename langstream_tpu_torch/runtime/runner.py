"""The agent runner: one replica's hot loop.

Parity: ``AgentRunner`` (``langstream-runtime-impl/.../agent/AgentRunner.java``)
— wiring (``:138``): resolve the streaming runtime, build
consumer/producer/dead-letter, wrap defaults ``TopicConsumerSource`` /
``TopicProducerSink`` (``:338,354``); hot loop (``runMainLoop``, ``:651-730``):
``source.read() → processor.process(records, sink) → write results``, with the
:class:`~langstream_tpu_torch.runtime.tracker.SourceRecordTracker` committing source
offsets only after all derived writes land, retry/skip/dead-letter per
``ErrorsSpec``, and graceful drain on shutdown (``:562``).

The loop is a single asyncio task; processors may resolve results out of
order (the GPU/TPU-serving agents do), commit contiguity is preserved by the
consumer.

The port's copy of ``langstream_tpu/runtime/runner.py``; it imports only the port.
"""

from __future__ import annotations

import asyncio
import logging
import os
from pathlib import Path
from typing import Any

from langstream_tpu_torch.api.agent import (
    AgentCode,
    AgentContext,
    AgentProcessor,
    AgentService,
    AgentSink,
    AgentSource,
    RecordSink,
    SourceRecordAndResult,
)
from langstream_tpu_torch.api.application import ErrorsSpec
from langstream_tpu_torch.api.execution_plan import AgentNode, ExecutionPlan
from langstream_tpu_torch.core.metrics import PrometheusMetricsReporter
from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.api.registry import AgentCodeRegistry
from langstream_tpu_torch.api.topics import (
    TopicConnectionsRuntime,
    TopicConsumer,
    TopicProducer,
)
from langstream_tpu_torch.core.asyncutil import spawn_retained
from langstream_tpu_torch.core.tracing import TRACE_HEADER, TraceContext, start_span
from langstream_tpu_torch.gateway.router import (
    BOUNCE_HEADER,
    MAX_BOUNCES,
    REPLICA_HEADER,
    split_replica_target,
)
from langstream_tpu_torch.runtime.composite import CompositeAgentProcessor
from langstream_tpu_torch.runtime.errors_handler import (
    FailureAction,
    StandardErrorsHandler,
    deadletter_record,
)
from langstream_tpu_torch.runtime.tracker import SourceRecordTracker

log = logging.getLogger(__name__)

DESTINATION_TOPIC_HEADER = "langstream-destination-topic"


class TopicConsumerSource(AgentSource):
    """Default source: reads the node's input topic
    (parity: ``AgentRunner.java:338``)."""

    def __init__(self, consumer: TopicConsumer):
        self.consumer = consumer

    async def start(self) -> None:
        await self.consumer.start()

    async def close(self) -> None:
        await self.consumer.close()

    async def read(self) -> list[Record]:
        return await self.consumer.read()

    async def commit(self, records: list[Record]) -> None:
        await self.consumer.commit(records)


class TopicProducerSink(AgentSink):
    """Default sink: writes to the node's output topic, honoring per-record
    destination-topic routing (used by the ``dispatch`` agent)."""

    def __init__(
        self,
        producer: TopicProducer | None,
        runtime: TopicConnectionsRuntime,
        agent_id: str,
    ):
        self.producer = producer
        self.runtime = runtime
        self.agent_id = agent_id
        self._extra_producers: dict[str, TopicProducer] = {}

    async def start(self) -> None:
        if self.producer:
            await self.producer.start()

    async def close(self) -> None:
        if self.producer:
            await self.producer.close()
        for p in self._extra_producers.values():
            await p.close()

    async def write(self, record: Record) -> None:
        destination = record.header(DESTINATION_TOPIC_HEADER)
        if destination:
            # strip the routing header so downstream nodes fall back to their
            # own configured outputs instead of re-routing forever
            routed = SimpleRecord(
                value=record.value,
                key=record.key,
                headers=tuple(
                    (k, v)
                    for k, v in record.headers
                    if k != DESTINATION_TOPIC_HEADER
                ),
                origin=record.origin,
                timestamp=record.timestamp,
            )
            producer = await self._producer_for(destination)
            await producer.write(routed)
            return
        if self.producer is None:
            # terminal agent without output: drop (the reference logs these)
            return
        await self.producer.write(record)

    async def _producer_for(self, topic: str) -> TopicProducer:
        if topic not in self._extra_producers:
            producer = self.runtime.create_producer(self.agent_id, {"topic": topic})
            await producer.start()
            self._extra_producers[topic] = producer
        return self._extra_producers[topic]


class _PassthroughProcessor(AgentProcessor):
    def process(self, records: list[Record], sink: RecordSink) -> None:
        for r in records:
            sink.emit(SourceRecordAndResult(r, [r], None))


class _RunnerRecordSink:
    """The RecordSink handed to the processor: applies the error policy and
    drives the write side + tracker."""

    def __init__(self, runner: "AgentRunner"):
        self.runner = runner
        self._tasks: set = set()

    def emit(self, result: SourceRecordAndResult) -> None:
        # a failed _handle_result must not vanish with its record un-acked
        spawn_retained(
            self.runner._handle_result(result),
            self._tasks,
            log,
            "result handling failed",
        )

    def emit_error(self, source_record: Record, error: Exception) -> None:
        self.emit(SourceRecordAndResult(source_record, [], error))


class AgentRunner:
    """Runs one replica of one (possibly composite) agent node."""

    def __init__(
        self,
        plan: ExecutionPlan,
        node: AgentNode,
        replica: int = 0,
        state_dir: Path | None = None,
    ):
        self.plan = plan
        self.node = node
        self.replica = replica
        self.state_dir = state_dir
        self.agent_id = f"{plan.application_id}-{node.id}"
        self._running = False
        self._stop_requested = asyncio.Event()
        self._fatal: Exception | None = None
        self.records_in = 0
        self.records_out = 0
        self.errors_total = 0
        # backpressure: max records read-but-not-terminal before the loop
        # stops polling (parity: the reference loop awaits processing; we
        # allow a bounded pipeline depth instead so TPU batches can fill)
        self.max_pending = int(
            (node.configuration or {}).get("max-pending-records", 512)
        )
        self._inflight = 0
        self._loop_task: asyncio.Task | None = None
        self._service_task: asyncio.Task | None = None
        # replica routing (gateway/router.py): the gateway stamps a
        # `langstream-replica` target; this consumer honors stamps whose
        # base names ITS StatefulSet (in-cluster the pod name carries
        # both base and ordinal; dev/test mode falls back to the
        # replica index) and bounces mismatches back to the input topic
        pod_name = os.environ.get("LS_POD_NAME")
        if pod_name:
            base, ordinal = split_replica_target(pod_name)
            self._routing_base = base
            self._routing_ordinal = (
                ordinal if ordinal is not None else replica
            )
        else:
            self._routing_base = ""
            self._routing_ordinal = replica
        self._reroute_producer: TopicProducer | None = None
        # the producers agents asked the context for (``stream-to-topic``):
        # closed at stop, so no socket of a network transport outlives the
        # runner (the JAX runner leaves them open)
        self._context_producers: list[Any] = []
        self.records_rerouted = 0
        # per-record trace spans, opened at read and closed when the record
        # reaches a terminal state (written / committed / dead-lettered);
        # keyed by id() like the tracker (record values may be dicts)
        self._record_spans: dict[int, Any] = {}
        # the trace-stamped copy of each read record -> (the copy, the
        # record the source read): commits and permanent failures hand the
        # source back its own records (the JAX runner hands it the copies,
        # so a source that knows its records by identity,
        # ``grpc-python-source``, never sees either)
        self._read_records: dict[int, tuple[Record, Record]] = {}

    # ---- wiring ----------------------------------------------------------

    async def start(self) -> None:
        streaming = self.plan.application.instance.streaming_cluster
        from langstream_tpu_torch.api.topics import TopicConnectionsRuntimeRegistry

        self.topics_runtime = TopicConnectionsRuntimeRegistry.get_runtime(
            {"type": streaming.type, "configuration": streaming.configuration}
        )

        node = self.node
        consumer: TopicConsumer | None = None
        producer: TopicProducer | None = None
        self.deadletter_producer: TopicProducer | None = None

        if node.input is not None:
            consumer = self.topics_runtime.create_consumer(
                self.agent_id,
                {
                    "topic": node.input.topic,
                    "group": self.agent_id,
                    # replica identity: runtimes with static partition
                    # assignment (wire kafka) split partitions on these;
                    # group-rebalance runtimes ignore them
                    "replica-index": self.replica,
                    "num-replicas": max(1, node.resources.parallelism),
                },
            )
            if node.input.deadletter_enabled:
                self.deadletter_producer = (
                    self.topics_runtime.create_deadletter_producer(
                        self.agent_id, {"topic": node.input.topic}
                    )
                )
        if node.output is not None:
            producer = self.topics_runtime.create_producer(
                self.agent_id, {"topic": node.output.topic}
            )

        # agent instantiation (composite → chain of processors)
        agents = [
            await self._instantiate(cfg.type, cfg.configuration, cfg.id)
            for cfg in node.agents
        ]

        self.source: AgentSource
        self.sink: AgentSink
        self.service: AgentService | None = None
        processors: list[AgentProcessor] = []

        first, last = agents[0], agents[-1]
        if isinstance(first, AgentService):
            self.service = first
            self.source = _NullSource()
            self.sink = TopicProducerSink(None, self.topics_runtime, self.agent_id)
            self.processor = _PassthroughProcessor()
        else:
            if isinstance(first, AgentSource):
                self.source = first
                middles = agents[1:]
            else:
                if consumer is None:
                    raise RuntimeError(
                        f"agent {node.id} is not a source and has no input topic"
                    )
                self.source = TopicConsumerSource(consumer)
                middles = agents
            if middles and isinstance(middles[-1], AgentSink):
                self.sink = middles[-1]
                middles = middles[:-1]
            else:
                self.sink = TopicProducerSink(
                    producer, self.topics_runtime, self.agent_id
                )
            for a in middles:
                if not isinstance(a, AgentProcessor):
                    raise RuntimeError(
                        f"agent {a.agent_type!r} cannot sit mid-pipeline "
                        f"(component type {a.component_type().value})"
                    )
                processors.append(a)
            self.processor = (
                processors[0]
                if len(processors) == 1
                else CompositeAgentProcessor(processors)
                if processors
                else _PassthroughProcessor()
            )

        # context + lifecycle
        metrics = PrometheusMetricsReporter(agent_id=self.agent_id)
        # runtime counters on /metrics (parity: the reference's per-agent
        # Prometheus counters; scraped by deploy/metrics/prometheus.yml)
        self._m_records_in = metrics.counter(
            "records_in", "records read from the source"
        )
        self._m_records_out = metrics.counter(
            "records_out", "records written to the sink"
        )
        self._m_errors = metrics.counter("record_errors", "record failures")
        self._m_pending = metrics.gauge("records_pending", "in-flight records")
        self._m_latency = metrics.histogram(
            "record_process_seconds",
            "per-record latency from source read to terminal write/commit",
        )
        context = AgentContext(
            agent_id=self.node.id,
            global_agent_id=self.agent_id,
            persistent_state_dir=(
                self.state_dir / f"{self.node.id}-{self.replica}"
                if self.state_dir
                else None
            ),
            metrics=metrics,
            topic_producer_factory=self._make_producer,
            critical_failure_handler=self._on_critical_failure,
        )
        self.context = context
        self.tracker = SourceRecordTracker(self._commit_read)
        self.errors_handler = StandardErrorsHandler(self.node.errors or ErrorsSpec())
        self.record_sink = _RunnerRecordSink(self)

        # note: a CompositeAgentProcessor propagates setup/start/close to its
        # children, so only the top-level trio is driven here.
        for a in dict.fromkeys(
            [self.source, self.processor, self.sink]
            + ([self.service] if self.service else [])
        ):
            await a.setup(context)
        await self.source.start()
        await self.sink.start()
        await self.processor.start()
        if self.deadletter_producer:
            await self.deadletter_producer.start()
        if self.service:
            await self.service.start()
            self._service_task = asyncio.ensure_future(self.service.run())

        self._running = True
        self._loop_task = asyncio.ensure_future(self._main_loop())

    async def _instantiate(self, agent_type: str, configuration: dict[str, Any], agent_id: str) -> AgentCode:
        agent = AgentCodeRegistry.get_agent_code(agent_type)
        agent.agent_id = agent_id
        cfg = dict(configuration)
        # ambient application context for agents that reference shared
        # resources (model providers, datasources) or globals
        cfg["__resources__"] = {
            rid: {"type": r.type, "name": r.name, **r.configuration}
            for rid, r in self.plan.application.resources.items()
        }
        cfg["__globals__"] = self.plan.application.instance.globals_
        cfg["__application_id__"] = self.plan.application_id
        if self.plan.application.directory:
            # custom python/sidecar agents resolve their code relative to
            # the application package (its python/ dir)
            cfg.setdefault(
                "__application_directory__", self.plan.application.directory
            )
        await agent.init(cfg)
        return agent

    def _make_producer(self, topic: str):
        producer = self.topics_runtime.create_producer(self.agent_id, {"topic": topic})

        class _Handle:
            def __init__(self, producer: TopicProducer):
                self._producer = producer
                self._started = False

            async def write(self, record: Record) -> None:
                if not self._started:
                    await self._producer.start()
                    self._started = True
                await self._producer.write(record)

            async def close(self) -> None:
                if self._started:
                    self._started = False
                    await self._producer.close()

        handle = _Handle(producer)
        self._context_producers.append(handle)
        return handle

    def _on_critical_failure(self, error: Exception) -> None:
        log.error("agent %s critical failure: %s", self.agent_id, error)
        self._fatal = error
        self._stop_requested.set()

    # ---- hot loop --------------------------------------------------------

    async def _main_loop(self) -> None:
        try:
            while not self._stop_requested.is_set():
                while (
                    self._inflight >= self.max_pending
                    and not self._stop_requested.is_set()
                ):
                    await asyncio.sleep(0.002)
                records = await self.source.read()
                if self._stop_requested.is_set():
                    break
                if records and self.node.input is not None:
                    records = await self._honor_replica_routing(records)
                if not records:
                    await asyncio.sleep(0)
                    continue
                self.records_in += len(records)
                self._m_records_in(len(records))
                self._inflight += len(records)
                self._m_pending(self._inflight)
                records = [self._begin_record_trace(r) for r in records]
                self.processor.process(records, self.record_sink)
                await asyncio.sleep(0)
        except Exception as e:  # loop-level failure is fatal for the replica
            self._fatal = e
            log.exception("agent %s main loop failed", self.agent_id)

    async def _honor_replica_routing(self, records: list[Record]) -> list[Record]:
        """Filter one read batch against `langstream-replica` stamps
        (docs/FLEET.md): records addressed to THIS replica (or to no one,
        or to a different agent's pods) pass through; records addressed
        to a sibling replica of this StatefulSet re-produce back onto
        the input topic and commit here, so consumer-group partition
        spread and the gateway's routing intent converge. Bounces are
        capped: once a record has hopped ``MAX_BOUNCES`` times its
        target is evidently gone (scaled away mid-flight) and serving it
        on the wrong replica — a cold prefix cache, nothing worse —
        beats letting it orbit the topic."""
        kept: list[Record] = []
        for record in records:
            target = record.header(REPLICA_HEADER)
            if not target:
                kept.append(record)
                continue
            base, ordinal = split_replica_target(str(target))
            addressed_here = ordinal is not None and (
                base == "" or base == self._routing_base
            )
            if not addressed_here or ordinal == self._routing_ordinal:
                kept.append(record)
                continue
            if record.key is not None:
                # keyed records hash back to the SAME partition — this
                # consumer — so a bounce is two broker writes that land
                # the record right back here; serving it locally is the
                # only move that terminates
                kept.append(record)
                continue
            try:
                # the bounce header rides client-suppliable gateway
                # payloads: garbage reads as over the cap, never as a
                # loop-killing ValueError
                bounces = int(record.header(BOUNCE_HEADER) or 0)
            except (TypeError, ValueError):
                bounces = MAX_BOUNCES
            if bounces >= MAX_BOUNCES:
                kept.append(record)
                continue
            if not await self._reroute(record, bounces + 1):
                kept.append(record)
        return kept

    async def _reroute(self, record: Record, bounces: int) -> bool:
        try:
            producer = self._reroute_producer
            if producer is None:
                producer = self.topics_runtime.create_producer(
                    f"{self.agent_id}-reroute",
                    {"topic": self.node.input.topic},
                )
                await producer.start()
                self._reroute_producer = producer
            await producer.write(
                record.with_headers({BOUNCE_HEADER: str(bounces)})
            )
        except Exception:
            # a transient broker failure must not kill the main loop the
            # way a processing error never would: serve the record here
            # (cold prefix cache, nothing worse) and rebuild the producer
            # on the next bounce
            log.exception(
                "agent %s reroute produce failed; serving locally",
                self.agent_id,
            )
            dead, self._reroute_producer = self._reroute_producer, None
            if dead is not None:
                try:
                    await dead.close()
                except Exception as close_err:
                    log.debug(
                        "closing broken reroute producer failed: %s",
                        close_err,
                    )
            return False
        self.records_rerouted += 1
        # journey ledger (serving/journey.py): a replica bounce is a
        # lifecycle edge an operator must be able to SEE when a request's
        # TTFT decomposes — keyed by the record's trace id, like every
        # other edge of the journey
        ctx = TraceContext.parse(record.header(TRACE_HEADER))
        if ctx is not None:
            from langstream_tpu_torch.serving.journey import JOURNEYS

            JOURNEYS.record(
                ctx.trace_id, "bounce",
                agent=self.agent_id, replica=self.replica, bounces=bounces,
            )
        # the re-produced copy is this record's continuation: commit the
        # original (zero local results) so the source offset advances
        self.tracker.track(record, 0)
        await self.tracker.commit_if_tracked_empty(record)
        return True

    def _begin_record_trace(self, record: Record) -> Record:
        """Open the per-record hop span and stamp its context into the
        record's ``langstream-trace`` header (creating a root trace when the
        record arrived without one), so composite stages, the serving
        engine, and every downstream hop parent under this one."""
        ctx = TraceContext.parse(record.header(TRACE_HEADER))
        span = start_span(
            "agent.process",
            service=self.agent_id,
            parent=ctx,
            attributes={"agent": self.node.id, "replica": self.replica},
        )
        traced = record.with_headers({TRACE_HEADER: span.context().to_header()})
        self._record_spans[id(traced)] = span
        self._read_records[id(traced)] = (traced, record)
        return traced

    def _take_read_record(self, traced: Record) -> Record:
        """The record the source read, for its trace-stamped copy, which
        reaches its end here (committed or failed for good)."""
        return self._read_records.pop(id(traced), (traced, traced))[1]

    async def _commit_read(self, records: list[Record]) -> None:
        """Commit the records the source read, for their traced copies."""
        await self.source.commit([self._take_read_record(r) for r in records])

    def _finish_record_trace(
        self, record: Record, error: Exception | None = None, **attributes: Any
    ) -> None:
        span = self._record_spans.pop(id(record), None)
        if span is None:
            return
        for key, value in attributes.items():
            span.set_attribute(key, value)
        self._m_latency(span.end(error=error))

    async def _handle_result(self, result: SourceRecordAndResult) -> None:
        if result.error is not None:
            await self._handle_error(result.source_record, result.error)
            return
        self.errors_handler.clear(result.source_record)
        self._inflight = max(0, self._inflight - 1)
        self._m_pending(self._inflight)
        self.tracker.track(result.source_record, len(result.results))
        if not result.results:
            await self.tracker.commit_if_tracked_empty(result.source_record)
            self._finish_record_trace(result.source_record, results=0)
            return
        src_trace = result.source_record.header(TRACE_HEADER)
        for record in result.results:
            if src_trace is not None and record.header(TRACE_HEADER) is None:
                # processors that rebuild records from scratch must not
                # break the trace chain mid-pipeline
                record = record.with_headers({TRACE_HEADER: src_trace})
            try:
                await self.sink.write(record)
                self.records_out += 1
                self._m_records_out(1)
                await self.tracker.record_written(result.source_record)
            except Exception as e:
                await self.tracker.record_failed(result.source_record)
                self._inflight += 1  # re-enters error handling below
                await self._handle_error(result.source_record, e)
                return
        self._finish_record_trace(
            result.source_record, results=len(result.results)
        )

    async def _handle_error(self, source_record: Record, error: Exception) -> None:
        self.errors_total += 1
        self._m_errors(1)
        action = self.errors_handler.handle(source_record, error)
        if action == FailureAction.RETRY:
            # single-record retry, documented out-of-order; stays in flight
            # (and its span stays open — retries are one logical attempt)
            span = self._record_spans.get(id(source_record))
            if span is not None:
                span.set_attribute(
                    "retries", int(span.attributes.get("retries", 0)) + 1
                )
            self.processor.process([source_record], self.record_sink)
            return
        self._inflight = max(0, self._inflight - 1)
        self._m_pending(self._inflight)
        self._finish_record_trace(
            source_record, error=error, outcome=action.value
        )
        if action == FailureAction.SKIP:
            await self.tracker.commit_now(source_record)
        elif action == FailureAction.DEAD_LETTER:
            if self.deadletter_producer is not None:
                await self.deadletter_producer.write(
                    deadletter_record(source_record, error)
                )
            await self.tracker.commit_now(source_record)
        else:  # FAIL
            if isinstance(self.source, AgentSource):
                try:
                    await self.source.permanent_failure(
                        self._take_read_record(source_record), error)
                except Exception as e:
                    self._fatal = e
            self._stop_requested.set()

    # ---- lifecycle -------------------------------------------------------

    async def stop(self, drain_timeout: float = 10.0) -> None:
        self._stop_requested.set()
        if self._loop_task is not None:
            await self._loop_task
        await self.tracker.wait_for_no_pending(drain_timeout)
        if self._service_task is not None:
            self._service_task.cancel()
            try:
                await self._service_task
            except asyncio.CancelledError:
                pass
            except Exception as e:
                log.debug("service task errored at stop: %s", e)
        for closer in (self.processor, self.sink, self.source):
            try:
                await closer.close()
            except Exception:
                log.exception("error closing %s", closer)
        if self.deadletter_producer:
            await self.deadletter_producer.close()
        if self._reroute_producer is not None:
            await self._reroute_producer.close()
        for handle in self._context_producers:
            await handle.close()
        await self.topics_runtime.close()
        self._running = False
        if self._fatal is not None:
            raise self._fatal

    def info(self) -> dict[str, Any]:
        return {
            "agent-id": self.agent_id,
            "type": self.node.agent_type,
            "component-type": self.node.component_type,
            "replica": self.replica,
            "records-in": self.records_in,
            "records-out": self.records_out,
            "records-rerouted": self.records_rerouted,
            "errors": self.errors_total,
            "pending": self.tracker.pending_count() if hasattr(self, "tracker") else 0,
            "agent-info": self.processor.agent_info() if hasattr(self, "processor") else {},
        }


class _NullSource(AgentSource):
    async def read(self) -> list[Record]:
        await asyncio.sleep(0.2)
        return []
