"""Kafka streaming runtime (gated on a client library).

Parity: ``langstream-kafka-runtime`` — consumer wrapper with out-of-order
acknowledgement and contiguous-prefix offset commits
(``KafkaConsumerWrapper.java:41,52,203``), producer wrapper with serializer
inference (``KafkaProducerWrapper.java``), position-addressed reader for the
gateway (``KafkaReaderWrapper.java``), dead-letter producer
(``KafkaTopicConnectionsRuntime.java:123``) and topic admin.

The broker-facing calls go through ``confluent_kafka``, which the ``type:
kafka`` selector picks only when it is importable (``client: auto|sdk``).
All commit *semantics* live in :class:`ContiguousOffsetTracker`, pure
Python, held against the JAX package's on a fake client in
``tests/test_torch_kafka_runtime.py``.

The port serves over this transport without the client library too: the
``type: kafka`` selector (:mod:`.kafka_wire_runtime`) falls back to the
wire client written in the repository. Nothing below the topic SPI reaches
the serving path, whose tensors stay on the card.

The port's copy of ``langstream_tpu/runtime/kafka_broker.py``; it imports
only the port, and ``confluent_kafka`` only when a consumer, producer,
reader or admin is built.
"""

from __future__ import annotations

import asyncio
import json
import logging
import uuid
from typing import Any, Callable

from langstream_tpu_torch.api.record import Record, SimpleRecord, now_millis
from langstream_tpu_torch.api.topics import (
    OFFSET_HEADER,
    TopicAdmin,
    TopicConsumer,
    TopicConnectionsRuntime,
    TopicOffset,
    TopicProducer,
    TopicReader,
)

logger = logging.getLogger(__name__)


def _kafka():
    import confluent_kafka

    return confluent_kafka


# ---------------------------------------------------------------------------
# Commit semantics (pure)
# ---------------------------------------------------------------------------


class _PartitionState:
    __slots__ = ("position", "acked", "delivered_max")

    def __init__(self, position: int) -> None:
        self.position = position  # next offset the broker should resume at
        self.acked: set[int] = set()
        self.delivered_max = position - 1

    def deliver(self, offset: int) -> None:
        if offset > self.delivered_max:
            self.delivered_max = offset

    def ack(self, offset: int) -> int | None:
        """Mark ``offset`` processed; return the new commit position if the
        contiguous prefix advanced, else None."""
        if offset < self.position:
            return None
        self.acked.add(offset)
        advanced = False
        while self.position in self.acked:
            self.acked.discard(self.position)
            self.position += 1
            advanced = True
        return self.position if advanced else None


class ContiguousOffsetTracker:
    """Out-of-order acks, contiguous commits — the at-least-once backbone.

    Mirrors the reference's per-partition ``TreeSet`` of uncommitted offsets:
    records may complete in any order (async sinks, retries), but the offset
    committed to the broker only ever advances over the longest contiguous
    prefix of acknowledged offsets, so a crash redelivers every unacked
    record (``KafkaConsumerWrapper.java:194-203``).
    """

    def __init__(self) -> None:
        self._parts: dict[tuple[str, int], _PartitionState] = {}

    def start_partition(self, topic: str, partition: int, position: int) -> None:
        self._parts[(topic, partition)] = _PartitionState(position)

    def drop_partition(self, topic: str, partition: int) -> None:
        self._parts.pop((topic, partition), None)

    def delivered(self, topic: str, partition: int, offset: int) -> None:
        state = self._parts.get((topic, partition))
        if state is None:
            state = _PartitionState(offset)
            self._parts[(topic, partition)] = state
        state.deliver(offset)

    def acknowledge(self, topic: str, partition: int, offset: int) -> int | None:
        """Returns the new commit position for the partition when the
        contiguous prefix advanced, else None."""
        state = self._parts.get((topic, partition))
        if state is None:
            return None
        return state.ack(offset)

    def pending(self, topic: str, partition: int) -> int:
        """Delivered-but-unacked count (gap width + tail)."""
        state = self._parts.get((topic, partition))
        if state is None:
            return 0
        return (state.delivered_max - state.position + 1) - len(state.acked)


# ---------------------------------------------------------------------------
# Serde inference (KafkaProducerWrapper parity)
# ---------------------------------------------------------------------------


# Wire headers carrying the inferred serializers, so structured datums
# (dict/list/numbers, incl. header values) round-trip through the
# byte-oriented broker the way the reference's schema-aware Kafka serdes do.
VALUE_KIND_HEADER = "__ls_vkind"
KEY_KIND_HEADER = "__ls_kkind"
HEADER_KINDS_HEADER = "__ls_hkinds"  # JSON map: header name -> kind
_KIND_HEADERS = (VALUE_KIND_HEADER, KEY_KIND_HEADER, HEADER_KINDS_HEADER)


def serialize_datum(value: Any) -> bytes | None:
    """Infer the wire encoding from the Python type, like the reference's
    producer picks a Kafka serializer from the record's class."""
    data, _ = serialize_datum_kind(value)
    return data


def serialize_datum_kind(value: Any) -> tuple[bytes | None, str | None]:
    if value is None:
        return None, None
    if isinstance(value, bytes):
        return value, None
    if isinstance(value, str):
        return value.encode("utf-8"), None
    if isinstance(value, (dict, list, bool, int, float)):
        return json.dumps(value).encode("utf-8"), "json"
    return str(value).encode("utf-8"), None


def deserialize_datum(raw: bytes | None, kind: Any = None) -> Any:
    if raw is None:
        return None
    if kind is not None:
        kind = kind.decode() if isinstance(kind, bytes) else kind
    if kind == "json":
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            pass
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError:
        return raw


def record_headers_to_kafka(record: Record) -> list[tuple[str, bytes]]:
    out: list[tuple[str, bytes]] = []
    kinds: dict[str, str] = {}
    for k, v in record.headers:
        if k == OFFSET_HEADER:
            continue  # transport-local, never re-published
        data, kind = serialize_datum_kind(v)
        if data is None:
            data, kind = b"", "null"
        if kind:
            kinds[k] = kind
        out.append((k, data))
    if kinds:
        out.append((HEADER_KINDS_HEADER, json.dumps(kinds).encode()))
    return out


def record_wire_payload(
    record: Record,
) -> tuple[bytes | None, bytes | None, list[tuple[str, bytes]]]:
    """(key, value, headers) in the on-wire form BOTH kafka lanes share —
    serializer inference plus the kind headers that make deserialization
    reversible. One implementation so the SDK and wire runtimes can never
    diverge on the format of the same ``type: kafka`` topic."""
    value, vkind = serialize_datum_kind(record.value)
    key, kkind = serialize_datum_kind(record.key)
    headers = record_headers_to_kafka(record)
    if vkind:
        headers.append((VALUE_KIND_HEADER, vkind.encode()))
    if kkind:
        headers.append((KEY_KIND_HEADER, kkind.encode()))
    return key, value, headers


def kafka_message_to_record(msg: Any) -> Record:
    raw_headers = list(msg.headers() or [])
    kinds = {k: v for k, v in raw_headers if k in _KIND_HEADERS}
    hkinds_raw = kinds.get(HEADER_KINDS_HEADER)
    hkinds: dict[str, str] = {}
    if hkinds_raw is not None:
        try:
            hkinds = json.loads(
                hkinds_raw.decode() if isinstance(hkinds_raw, bytes) else hkinds_raw
            )
        except (json.JSONDecodeError, UnicodeDecodeError):
            pass
    headers = tuple(
        (k, None if hkinds.get(k) == "null" else deserialize_datum(v, hkinds.get(k)))
        for k, v in raw_headers
        if k not in _KIND_HEADERS
    ) + ((OFFSET_HEADER, TopicOffset(msg.topic(), msg.partition(), msg.offset())),)
    ts = None
    try:
        ts_type, ts_value = msg.timestamp()
        if ts_value and ts_value > 0:
            ts = ts_value
    except Exception as e:
        logger.debug("message has no usable timestamp: %s", e)
    return SimpleRecord(
        value=deserialize_datum(msg.value(), kinds.get(VALUE_KIND_HEADER)),
        key=deserialize_datum(msg.key(), kinds.get(KEY_KIND_HEADER)),
        headers=headers,
        origin=msg.topic(),
        timestamp=ts if ts is not None else now_millis(),
    )


# ---------------------------------------------------------------------------
# Consumer / producer / reader / admin
# ---------------------------------------------------------------------------


class KafkaTopicConsumer(TopicConsumer):
    """Group consumer; blocking client calls run on the default executor.

    The runner's loop serializes read/commit, and rebalance callbacks fire
    inside ``poll`` on the same thread, so client access is single-threaded
    as the client requires.
    """

    def __init__(
        self,
        bootstrap: dict[str, Any],
        topic: str,
        group: str,
        poll_batch: int = 64,
        poll_timeout: float = 0.5,
        consumer_factory: Callable[[dict], Any] | None = None,
    ):
        self.topic = topic
        self.group = group
        self.poll_batch = poll_batch
        self.poll_timeout = poll_timeout
        self.tracker = ContiguousOffsetTracker()
        self._conf = {
            **bootstrap,
            "group.id": group,
            "enable.auto.commit": False,
            "auto.offset.reset": "earliest",
        }
        self._factory = consumer_factory
        self._consumer: Any = None
        self._total_out = 0

    def _build(self) -> Any:
        if self._factory is not None:
            return self._factory(self._conf)
        return _kafka().Consumer(self._conf)

    async def start(self) -> None:
        if self._consumer is not None:
            return
        self._consumer = self._build()
        self._consumer.subscribe(
            [self.topic], on_assign=self._on_assign, on_revoke=self._on_revoke
        )

    # Rebalance listeners (parity: KafkaConsumerWrapper.java:82-112) — a
    # newly-assigned partition resumes at its committed position, so any
    # delivered-but-uncommitted records are redelivered (at-least-once).
    def _on_assign(self, consumer: Any, partitions: list[Any]) -> None:
        for tp in partitions:
            if tp.offset >= 0:
                self.tracker.start_partition(tp.topic, tp.partition, tp.offset)
            # tp.offset is OFFSET_INVALID (-1001) in normal rebalances: the
            # broker resumes delivery at the group's committed position, so
            # the tracker adopts the first *delivered* offset as its start
            # (ContiguousOffsetTracker.delivered creates the partition state
            # lazily). Seeding 0 here would wedge commits forever on any
            # partition resumed past offset 0.
            logger.info(
                "partition assigned %s[%d] at %s", tp.topic, tp.partition, tp.offset
            )

    def _on_revoke(self, consumer: Any, partitions: list[Any]) -> None:
        for tp in partitions:
            pending = self.tracker.pending(tp.topic, tp.partition)
            if pending:
                logger.warning(
                    "partition %s[%d] revoked with %d in-flight records; "
                    "they will be redelivered to the next assignee",
                    tp.topic, tp.partition, pending,
                )
            self.tracker.drop_partition(tp.topic, tp.partition)

    async def close(self) -> None:
        if self._consumer is None:
            return
        consumer, self._consumer = self._consumer, None
        await asyncio.get_running_loop().run_in_executor(None, consumer.close)

    async def read(self) -> list[Record]:
        loop = asyncio.get_running_loop()
        msgs = await loop.run_in_executor(
            None, self._consumer.consume, self.poll_batch, self.poll_timeout
        )
        batch: list[Record] = []
        for msg in msgs or []:
            if msg.error():
                err = msg.error()
                if getattr(err, "retriable", lambda: False)():
                    logger.warning("retriable consumer error: %s", err)
                    continue
                if self._is_partition_eof(err):
                    continue
                raise RuntimeError(f"kafka consumer error: {err}")
            self.tracker.delivered(msg.topic(), msg.partition(), msg.offset())
            batch.append(kafka_message_to_record(msg))
        self._total_out += len(batch)
        return batch

    @staticmethod
    def _is_partition_eof(err: Any) -> bool:
        try:
            return err.code() == _kafka().KafkaError._PARTITION_EOF
        except Exception:
            return False

    async def commit(self, records: list[Record]) -> None:
        to_commit: dict[tuple[str, int], int] = {}
        for record in records:
            offset: TopicOffset | None = record.header(OFFSET_HEADER)
            if offset is None:
                continue
            position = self.tracker.acknowledge(
                offset.topic, offset.partition, offset.offset
            )
            if position is not None:
                to_commit[(offset.topic, offset.partition)] = position
        if not to_commit:
            return
        kafka = _kafka()
        tps = [
            kafka.TopicPartition(topic, partition, position)
            for (topic, partition), position in to_commit.items()
        ]
        loop = asyncio.get_running_loop()
        # captured on the loop thread: close() nulls the field, and the
        # executor closure must not re-read it mid-flight (RACE801)
        consumer = self._consumer
        await loop.run_in_executor(
            None, lambda: consumer.commit(offsets=tps, asynchronous=False)
        )

    def total_out(self) -> int:
        return self._total_out


class KafkaTopicProducer(TopicProducer):
    def __init__(
        self,
        bootstrap: dict[str, Any],
        topic: str,
        producer_factory: Callable[[dict], Any] | None = None,
    ):
        self.topic = topic
        self._conf = dict(bootstrap)
        self._factory = producer_factory
        self._producer: Any = None
        self._total_in = 0

    async def start(self) -> None:
        if self._producer is None:
            if self._factory is not None:
                self._producer = self._factory(self._conf)
            else:
                self._producer = _kafka().Producer(self._conf)

    async def close(self) -> None:
        if self._producer is None:
            return
        producer, self._producer = self._producer, None
        await asyncio.get_running_loop().run_in_executor(None, producer.flush)

    async def write(self, record: Record) -> None:
        loop = asyncio.get_running_loop()
        done: asyncio.Future = loop.create_future()

        def _on_delivery(err: Any, msg: Any) -> None:
            # runs on the producer's poll thread
            if err is not None:
                loop.call_soon_threadsafe(
                    done.set_exception, RuntimeError(f"kafka produce failed: {err}")
                )
            else:
                loop.call_soon_threadsafe(done.set_result, None)

        key, value, headers = record_wire_payload(record)
        self._producer.produce(
            self.topic,
            value=value,
            key=key,
            headers=headers,
            on_delivery=_on_delivery,
        )
        # serve delivery callbacks until this write acks (durable append)
        while not done.done():
            await loop.run_in_executor(None, self._producer.poll, 0.05)
        await done
        self._total_in += 1

    def total_in(self) -> int:
        return self._total_in


class KafkaTopicReader(TopicReader):
    """Groupless reader: assigns all partitions at earliest/latest, never
    commits — each gateway session reads independently."""

    def __init__(
        self,
        bootstrap: dict[str, Any],
        topic: str,
        initial_position: str = "latest",
        consumer_factory: Callable[[dict], Any] | None = None,
    ):
        self.topic = topic
        self.initial_position = initial_position
        self._conf = {
            **bootstrap,
            "group.id": f"reader-{uuid.uuid4().hex}",
            "enable.auto.commit": False,
            "auto.offset.reset": (
                "earliest" if initial_position == "earliest" else "latest"
            ),
        }
        self._factory = consumer_factory
        self._consumer: Any = None

    async def start(self) -> None:
        kafka = _kafka()
        self._consumer = (
            self._factory(self._conf) if self._factory else kafka.Consumer(self._conf)
        )
        loop = asyncio.get_running_loop()
        # captured on the loop thread: close() nulls the field, and the
        # executor closure must not re-read it mid-flight (RACE801)
        consumer = self._consumer

        def _assign() -> None:
            md = consumer.list_topics(self.topic, timeout=10)
            topic_md = md.topics.get(self.topic)
            partitions = sorted(topic_md.partitions) if topic_md else [0]
            tps = []
            for p in partitions:
                lo, hi = consumer.get_watermark_offsets(
                    kafka.TopicPartition(self.topic, p), timeout=10
                )
                start = lo if self.initial_position == "earliest" else hi
                tps.append(kafka.TopicPartition(self.topic, p, start))
            consumer.assign(tps)

        await loop.run_in_executor(None, _assign)

    async def close(self) -> None:
        if self._consumer is None:
            return
        consumer, self._consumer = self._consumer, None
        await asyncio.get_running_loop().run_in_executor(None, consumer.close)

    async def read(self, timeout: float | None = None) -> list[Record]:
        loop = asyncio.get_running_loop()
        msgs = await loop.run_in_executor(
            None, self._consumer.consume, 64, timeout if timeout is not None else 0.5
        )
        out: list[Record] = []
        for msg in msgs or []:
            err = msg.error()
            if err:
                if KafkaTopicConsumer._is_partition_eof(err):
                    continue
                if getattr(err, "retriable", lambda: False)():
                    logger.warning("retriable reader error: %s", err)
                    continue
                raise RuntimeError(f"kafka reader error: {err}")
            out.append(kafka_message_to_record(msg))
        return out


class KafkaTopicAdmin(TopicAdmin):
    def __init__(self, bootstrap: dict[str, Any], admin_factory=None):
        self._conf = dict(bootstrap)
        self._factory = admin_factory

    def _admin(self) -> Any:
        if self._factory is not None:
            return self._factory(self._conf)
        from confluent_kafka.admin import AdminClient

        return AdminClient(self._conf)

    async def create_topic(
        self, name: str, partitions: int = 1, options: dict[str, Any] | None = None
    ) -> None:
        from confluent_kafka.admin import NewTopic

        admin = self._admin()
        replication = int((options or {}).get("replication-factor", 1))
        futures = admin.create_topics(
            [NewTopic(name, num_partitions=partitions, replication_factor=replication)]
        )
        await self._await_futures(futures, ignore="TOPIC_ALREADY_EXISTS")

    async def delete_topic(self, name: str) -> None:
        admin = self._admin()
        futures = admin.delete_topics([name])
        await self._await_futures(futures, ignore="UNKNOWN_TOPIC_OR_PART")

    @staticmethod
    async def _await_futures(futures: dict[str, Any], ignore: str) -> None:
        loop = asyncio.get_running_loop()
        for name, fut in futures.items():
            try:
                await loop.run_in_executor(None, fut.result)
            except Exception as e:  # noqa: BLE001 - client raises KafkaException
                if ignore not in str(e):
                    raise


class KafkaTopicConnectionsRuntime(TopicConnectionsRuntime):
    """``type: kafka`` streaming cluster.

    Configuration layout follows the reference's ``instance.yaml``
    (``examples/instances/kafka-docker.yaml:21-30``)::

        streamingCluster:
          type: kafka
          configuration:
            admin: {bootstrap.servers: "..."}
            consumer: {...}   # optional overrides
            producer: {...}   # optional overrides
    """

    def init(self, streaming_cluster_configuration: dict[str, Any]) -> None:
        super().init(streaming_cluster_configuration)
        conf = streaming_cluster_configuration or {}
        self.admin_conf = dict(conf.get("admin", {}))
        self.consumer_conf = {**self.admin_conf, **conf.get("consumer", {})}
        self.producer_conf = {**self.admin_conf, **conf.get("producer", {})}

    def create_consumer(self, agent_id: str, config: dict[str, Any]) -> TopicConsumer:
        return KafkaTopicConsumer(
            self.consumer_conf,
            topic=config["topic"],
            group=config.get("group", agent_id),
            poll_batch=int(config.get("poll-batch", 64)),
            poll_timeout=float(config.get("poll-timeout", 0.5)),
        )

    def create_producer(self, agent_id: str, config: dict[str, Any]) -> TopicProducer:
        return KafkaTopicProducer(self.producer_conf, topic=config["topic"])

    def create_reader(
        self, config: dict[str, Any], initial_position: str = "latest"
    ) -> TopicReader:
        return KafkaTopicReader(
            self.consumer_conf, config["topic"], initial_position
        )

    def create_topic_admin(self) -> TopicAdmin:
        return KafkaTopicAdmin(self.admin_conf)
