"""Kafka topic runtime over the in-tree wire protocol (no client library).

The ``type: kafka`` streaming cluster resolves here when
``confluent_kafka`` is not importable (or when ``client: wire`` is forced):
the same topic SPI — consumer with contiguous-prefix commits, producer with
serializer inference, position-addressed reader, admin, dead-letter via the
base class — backed by :mod:`.kafka_wire` instead of an SDK.

Partition ownership defaults to STATIC: replica ``i`` of ``n`` owns
partitions ``p ≡ i (mod n)`` (``replica-index`` / ``num-replicas`` in the
consumer config, or the pod's ordinal env). Under the k8s runtime each
replica is a StatefulSet ordinal, so assignment is exact and
rebalance-free. ``assignment: dynamic`` opts into the wire-spoken consumer
group protocol instead — JoinGroup/SyncGroup/Heartbeat/LeaveGroup with the
leader-side range assignor and generation-fenced commits
(:class:`GroupMembership`) — matching the Java client's group membership
the reference rides (``KafkaConsumerWrapper.java:41`` implements
``ConsumerRebalanceListener``). The contiguous-commit semantics are
identical in both modes and shared via :class:`ContiguousOffsetTracker`.

The port's copy of ``langstream_tpu/runtime/kafka_wire_runtime.py``; it
imports only the port (the StatefulSet ordinal from
:func:`langstream_tpu_torch.runtime.pod.pod_ordinal`), and
``confluent_kafka`` only when ``client: auto|sdk`` asks for it.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any

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
from langstream_tpu_torch.runtime.kafka_broker import (
    ContiguousOffsetTracker,
    HEADER_KINDS_HEADER,
    KEY_KIND_HEADER,
    VALUE_KIND_HEADER,
    _KIND_HEADERS,
    deserialize_datum,
    record_wire_payload,
)
from langstream_tpu_torch.runtime.kafka_wire import (
    ERR_ILLEGAL_GENERATION,
    ERR_OFFSET_OUT_OF_RANGE,
    ERR_REBALANCE_IN_PROGRESS,
    ERR_UNKNOWN_MEMBER_ID,
    KafkaProtocolError,
    KafkaSecurity,
    KafkaWireClient,
    WireRecord,
    range_assign,
)

logger = logging.getLogger(__name__)

_GROUP_ERRORS = (
    ERR_ILLEGAL_GENERATION,
    ERR_REBALANCE_IN_PROGRESS,
    ERR_UNKNOWN_MEMBER_ID,
)


def _wire_record_to_record(topic: str, rec: WireRecord) -> Record:
    import json

    kinds = {k: v for k, v in rec.headers if k in _KIND_HEADERS}
    hkinds: dict[str, str] = {}
    raw = kinds.get(HEADER_KINDS_HEADER)
    if raw is not None:
        try:
            hkinds = json.loads(raw.decode())
        except (json.JSONDecodeError, UnicodeDecodeError):
            pass
    headers = tuple(
        (k, None if hkinds.get(k) == "null" else deserialize_datum(v, hkinds.get(k)))
        for k, v in rec.headers
        if k not in _KIND_HEADERS
    ) + ((OFFSET_HEADER, TopicOffset(topic, 0, rec.offset)),)
    return SimpleRecord(
        value=deserialize_datum(rec.value, kinds.get(VALUE_KIND_HEADER)),
        key=deserialize_datum(rec.key, kinds.get(KEY_KIND_HEADER)),
        headers=headers,
        origin=topic,
        timestamp=rec.timestamp if rec.timestamp > 0 else now_millis(),
    )




class GroupMembership:
    """Client half of the consumer group protocol: join → (leader computes
    the range assignment) → sync → heartbeat cadence; rejoin on the group
    error codes. This is the dynamic-rebalance lane the reference rides the
    Java client for (``KafkaConsumerWrapper.java:41`` implements
    ``ConsumerRebalanceListener``) — here it is spoken on the wire."""

    def __init__(
        self,
        client: KafkaWireClient,
        group: str,
        topics: list[str],
        session_timeout_ms: int = 10000,
        heartbeat_interval_s: float = 0.5,
    ):
        self.client = client
        self.group = group
        self.topics = topics
        self.session_timeout_ms = session_timeout_ms
        self.heartbeat_interval_s = heartbeat_interval_s
        self.member_id = ""
        self.generation = -1
        self.assignment: dict[str, list[int]] = {}
        self._last_heartbeat = 0.0
        self.rebalance_needed = False
        self._hb_task: asyncio.Task | None = None

    def _ensure_heartbeat_task(self) -> None:
        """Heartbeats must keep flowing while the owner is busy processing
        a batch — a session-timeout's worth of silence gets the member
        evicted by a real coordinator (the Java client heartbeats from a
        background thread for the same reason). ``_Conn.call`` serializes
        on a lock, so this task can share the coordinator connection."""
        if self._hb_task is not None and not self._hb_task.done():
            return

        async def beat() -> None:
            while True:
                await asyncio.sleep(self.heartbeat_interval_s)
                if self.rebalance_needed or not self.member_id:
                    continue                   # owner must rejoin first
                self._last_heartbeat = time.monotonic()
                try:
                    await self.client.heartbeat(
                        self.group, self.generation, self.member_id
                    )
                except KafkaProtocolError as e:
                    if e.code in _GROUP_ERRORS:
                        if e.code == ERR_UNKNOWN_MEMBER_ID:
                            self.member_id = ""
                        self.rebalance_needed = True
                    # other codes: transient — next beat retries
                except (ConnectionError, OSError):
                    pass                       # redial happens on next call

        self._hb_task = asyncio.get_running_loop().create_task(beat())

    async def join(self) -> dict[str, list[int]]:
        """Run join+sync rounds until the group is stable; returns this
        member's {topic: [partitions]}."""
        while True:
            try:
                info = await self.client.join_group(
                    self.group, self.member_id, self.topics,
                    session_timeout_ms=self.session_timeout_ms,
                )
            except KafkaProtocolError as e:
                if e.code == ERR_UNKNOWN_MEMBER_ID:
                    self.member_id = ""      # fenced: restart as a new member
                    continue
                raise
            self.member_id = info["member_id"]
            self.generation = info["generation"]
            assignments = None
            if info["leader"] == self.member_id:
                subscribed = sorted(
                    {t for topics in info["members"].values() for t in topics}
                )
                partitions = {
                    t: await self.client.partitions_for(t) for t in subscribed
                }
                assignments = range_assign(info["members"], partitions)
            try:
                self.assignment = await self.client.sync_group(
                    self.group, self.generation, self.member_id, assignments
                )
            except KafkaProtocolError as e:
                if e.code in _GROUP_ERRORS:
                    if e.code == ERR_UNKNOWN_MEMBER_ID:
                        self.member_id = ""
                    continue                 # another round started — rejoin
                raise
            self._last_heartbeat = time.monotonic()
            self.rebalance_needed = False
            self._ensure_heartbeat_task()
            return self.assignment

    async def heartbeat_if_due(self) -> bool:
        """False → the group is rebalancing and the caller must rejoin."""
        if self.rebalance_needed:
            return False
        now = time.monotonic()
        if now - self._last_heartbeat < self.heartbeat_interval_s:
            return True
        self._last_heartbeat = now
        try:
            await self.client.heartbeat(self.group, self.generation, self.member_id)
            return True
        except KafkaProtocolError as e:
            if e.code in _GROUP_ERRORS:
                if e.code == ERR_UNKNOWN_MEMBER_ID:
                    self.member_id = ""
                return False
            raise

    async def leave(self) -> None:
        if self._hb_task is not None:
            self._hb_task.cancel()
            try:
                await self._hb_task
            except asyncio.CancelledError:
                pass
            except Exception as e:  # noqa: BLE001
                logger.debug("heartbeat task errored at leave: %s", e)
            self._hb_task = None
        if self.member_id:
            try:
                await self.client.leave_group(self.group, self.member_id)
            except (KafkaProtocolError, ConnectionError, OSError):
                pass
            self.member_id = ""
            self.generation = -1


class WireKafkaTopicConsumer(TopicConsumer):
    """Group consumer with contiguous-prefix commits. Two assignment modes:
    ``static`` (replica ``i`` of ``n`` owns partitions ``p ≡ i mod n`` —
    exact under StatefulSet ordinals, rebalance-free) and ``dynamic`` (the
    wire group protocol: join/sync/heartbeat with generation-fenced
    commits, reference parity with the Java client's group membership)."""

    def __init__(
        self,
        bootstrap: str,
        topic: str,
        group: str,
        replica_index: int = 0,
        num_replicas: int = 1,
        poll_timeout_ms: int = 500,
        assignment: str = "static",
        session_timeout_ms: int = 10000,
        security: KafkaSecurity | None = None,
    ):
        self.topic = topic
        self.group = group
        self.replica_index = replica_index
        self.num_replicas = max(1, num_replicas)
        self.poll_timeout_ms = poll_timeout_ms
        self.client = KafkaWireClient(bootstrap, security=security)
        self.tracker = ContiguousOffsetTracker()
        self.membership = (
            GroupMembership(
                self.client, group, [topic],
                session_timeout_ms=session_timeout_ms,
            )
            if assignment == "dynamic"
            else None
        )
        self._positions: dict[int, int] = {}
        self._committed: dict[int, int] = {}
        self._out = 0
        self._rebalances = 0

    async def start(self) -> None:
        if self.membership is not None:
            assignment = await self.membership.join()
            await self._adopt_partitions(assignment.get(self.topic, []))
        else:
            partitions = await self.client.partitions_for(self.topic)
            mine = [
                p for p in partitions
                if p % self.num_replicas == self.replica_index % self.num_replicas
            ]
            await self._adopt_partitions(mine)

    async def _adopt_partitions(self, mine: list[int]) -> None:
        """(Re)initialize positions from the committed offsets. On a
        rebalance, in-flight uncommitted records of lost partitions are
        simply redelivered to their new owner — the at-least-once contract
        (parity: ``KafkaConsumerWrapper.java:82-112`` logs exactly this)."""
        self._positions = {}
        self._committed = {}
        self.tracker = ContiguousOffsetTracker()
        committed = await self.client.offset_fetch(self.group, self.topic, mine)
        for p in mine:
            start = committed.get(p, -1)
            if start < 0:
                start = await self.client.list_offsets(self.topic, p, -2)
            self._positions[p] = start
            self._committed[p] = start
            self.tracker.start_partition(self.topic, p, start)

    async def close(self) -> None:
        if self.membership is not None:
            await self.membership.leave()
        await self.client.close()

    async def read(self) -> list[Record]:
        if self.membership is not None:
            if not await self.membership.heartbeat_if_due():
                # group is rebalancing: rejoin and adopt the new assignment;
                # uncommitted in-flight records of partitions that moved are
                # redelivered to their new owner (at-least-once)
                assignment = await self.membership.join()
                await self._adopt_partitions(assignment.get(self.topic, []))
                self._rebalances += 1
        out: list[Record] = []
        partitions = sorted(self._positions)
        if not partitions:
            # owning no partitions is a normal group state (more members
            # than partitions): sleep a poll instead of busy-spinning the
            # caller's read loop at 100% CPU
            await asyncio.sleep(self.poll_timeout_ms / 1000.0)
            return out
        # every owned partition is polled every read — no partition can
        # starve behind a busy sibling (per-key ordering is per-partition,
        # so interleaving partitions in one batch is safe); the wait budget
        # splits across partitions so an empty one can't eat the whole poll
        wait_ms = max(50, self.poll_timeout_ms // max(1, len(partitions)))
        for p in partitions:
            pos = self._positions[p]
            try:
                recs, _hw = await self.client.fetch(
                    self.topic, p, pos, max_wait_ms=wait_ms
                )
            except KafkaProtocolError as e:
                if e.code == ERR_OFFSET_OUT_OF_RANGE:
                    # log truncated under us (retention): resume from the
                    # new earliest AND re-seed the commit tracker — a stale
                    # tracker position would wedge the contiguous prefix
                    # and no commit would ever be written again
                    new_start = await self.client.list_offsets(
                        self.topic, p, -2
                    )
                    self._positions[p] = new_start
                    self._committed[p] = new_start
                    self.tracker.start_partition(self.topic, p, new_start)
                    continue
                raise
            for rec in recs:
                record = _wire_record_to_record(self.topic, rec)
                # rewrite the offset header with the true partition
                headers = tuple(
                    (k, TopicOffset(self.topic, p, rec.offset))
                    if k == OFFSET_HEADER else (k, v)
                    for k, v in record.headers
                )
                record = SimpleRecord(
                    value=record.value, key=record.key, headers=headers,
                    origin=self.topic, timestamp=record.timestamp,
                )
                self.tracker.delivered(self.topic, p, rec.offset)
                out.append(record)
                self._positions[p] = rec.offset + 1
        self._out += len(out)
        return out

    async def commit(self, records: list[Record]) -> None:
        to_commit: dict[tuple[str, int], int] = {}
        for record in records:
            offset = record.header(OFFSET_HEADER)
            if not isinstance(offset, TopicOffset):
                continue
            next_pos = self.tracker.acknowledge(
                offset.topic, offset.partition, offset.offset
            )
            if next_pos is not None and next_pos > self._committed.get(
                offset.partition, -1
            ):
                self._committed[offset.partition] = next_pos
                to_commit[(offset.topic, offset.partition)] = next_pos
        if not to_commit:
            return
        if self.membership is not None:
            try:
                await self.client.offset_commit_grouped(
                    self.group,
                    self.membership.generation,
                    self.membership.member_id,
                    to_commit,
                )
            except KafkaProtocolError as e:
                if e.code in _GROUP_ERRORS:
                    # fenced: these partitions moved in a rebalance this
                    # member hasn't processed yet. Dropping the commit is
                    # the correct at-least-once outcome — the new owner
                    # resumes from the last successful commit and the
                    # records are redelivered there; the next read()
                    # rejoins.
                    return
                raise
        else:
            await self.client.offset_commit(self.group, to_commit)

    def total_out(self) -> int:
        return self._out


class WireKafkaTopicProducer(TopicProducer):
    def __init__(self, bootstrap: str, topic: str,
                 security: KafkaSecurity | None = None,
                 compression: str | None = None):
        self.topic = topic
        self.client = KafkaWireClient(bootstrap, security=security)
        self.compression = compression
        self._partitions: list[int] = []
        self._rr = 0
        self._in = 0

    async def start(self) -> None:
        self._partitions = await self.client.partitions_for(self.topic)

    async def close(self) -> None:
        await self.client.close()

    def _partition_for(self, key: bytes | None) -> int:
        if not self._partitions:
            return 0
        if key is not None:
            # stable key → partition mapping preserves per-key ordering
            import zlib

            return self._partitions[
                zlib.crc32(key) % len(self._partitions)
            ]
        self._rr += 1
        return self._partitions[self._rr % len(self._partitions)]

    async def write(self, record: Record) -> None:
        key, value, headers = record_wire_payload(record)
        partition = self._partition_for(key)
        await self.client.produce(
            self.topic, partition, [(key, value, headers)],
            timestamp_ms=record.timestamp or now_millis(),
            compression=self.compression,
        )
        self._in += 1

    def total_in(self) -> int:
        return self._in


class WireKafkaTopicReader(TopicReader):
    """Position-addressed reader (gateway consume side); no group."""

    def __init__(self, bootstrap: str, topic: str, initial_position: str,
                 security: KafkaSecurity | None = None):
        self.topic = topic
        self.initial_position = initial_position
        self.client = KafkaWireClient(bootstrap, security=security)
        self._positions: dict[int, int] = {}

    async def start(self) -> None:
        ts = -2 if self.initial_position == "earliest" else -1
        for p in await self.client.partitions_for(self.topic):
            self._positions[p] = await self.client.list_offsets(
                self.topic, p, ts
            )

    async def close(self) -> None:
        await self.client.close()

    async def read(self, timeout: float | None = None) -> list[Record]:
        out: list[Record] = []
        wait_ms = int((timeout or 0.2) * 1000)
        for p, pos in list(self._positions.items()):
            recs, _hw = await self.client.fetch(
                self.topic, p, pos, max_wait_ms=wait_ms
            )
            for rec in recs:
                out.append(_wire_record_to_record(self.topic, rec))
                self._positions[p] = rec.offset + 1
        return out


class WireKafkaTopicAdmin(TopicAdmin):
    def __init__(self, bootstrap: str,
                 security: KafkaSecurity | None = None):
        self.bootstrap = bootstrap
        self.security = security

    async def create_topic(
        self, name: str, partitions: int = 1,
        options: dict[str, Any] | None = None,
    ) -> None:
        opts = options or {}
        client = KafkaWireClient(self.bootstrap, security=self.security)
        try:
            await client.create_topic(
                name,
                partitions=int(opts.get("partitions", partitions)),
                # same option the SDK-backed admin honors — dropping it
                # would silently create RF-1 topics on production clusters
                replication=int(opts.get("replication-factor", 1)),
                exist_ok=True,
            )
        finally:
            await client.close()

    async def delete_topic(self, name: str) -> None:
        client = KafkaWireClient(self.bootstrap, security=self.security)
        try:
            await client.delete_topic(name)
        finally:
            await client.close()


def _replica_hints(config: dict[str, Any]) -> tuple[int, int]:
    """Replica identity for static assignment. The agent runner passes
    ``replica-index``/``num-replicas`` explicitly; the env fallback mirrors
    the pod entrypoint's identity derivation (``runtime/pod.py``:
    ``LS_LOGICAL_REPLICA``, else the StatefulSet ordinal in
    ``LS_POD_NAME``)."""
    replica = config.get("replica-index")
    replicas = config.get("num-replicas")
    if replica is None:
        logical = os.environ.get("LS_LOGICAL_REPLICA")
        if logical is not None:
            replica = logical
        else:
            from langstream_tpu_torch.runtime.pod import pod_ordinal

            replica = pod_ordinal(os.environ.get("LS_POD_NAME"))
    if replicas is None:
        replicas = os.environ.get("LS_NUM_REPLICAS", "1")
    return int(replica), int(replicas)


class KafkaTopicConnectionsRuntimeSelector(TopicConnectionsRuntime):
    """The ``type: kafka`` front door: picks the backend from the
    ``client`` config key — ``wire`` (in-tree protocol, static
    assignment), ``sdk`` (confluent_kafka, dynamic group rebalance), or
    the default ``auto`` (sdk when importable, else wire)."""

    def init(self, streaming_cluster_configuration: dict[str, Any]) -> None:
        super().init(streaming_cluster_configuration)
        conf = streaming_cluster_configuration or {}
        choice = str(conf.get("client", "auto")).lower()
        if choice not in ("auto", "wire", "sdk"):
            raise ValueError(
                f"streamingCluster kafka client {choice!r} not supported "
                "(auto|wire|sdk)"
            )
        use_sdk = False
        if choice in ("auto", "sdk"):
            try:
                import confluent_kafka  # noqa: F401

                use_sdk = True
            except ImportError:
                if choice == "sdk":
                    raise RuntimeError(
                        "streamingCluster requests client: sdk but "
                        "confluent_kafka is not installed; use client: wire"
                    ) from None
        if use_sdk:
            from langstream_tpu_torch.runtime.kafka_broker import (
                KafkaTopicConnectionsRuntime,
            )

            self._backend: TopicConnectionsRuntime = (
                KafkaTopicConnectionsRuntime()
            )
        else:
            self._backend = WireKafkaTopicConnectionsRuntime()
        self._backend.init(conf)

    def create_consumer(self, agent_id: str, config: dict[str, Any]) -> TopicConsumer:
        return self._backend.create_consumer(agent_id, config)

    def create_producer(self, agent_id: str, config: dict[str, Any]) -> TopicProducer:
        return self._backend.create_producer(agent_id, config)

    def create_reader(
        self, config: dict[str, Any], initial_position: str = "latest"
    ) -> TopicReader:
        return self._backend.create_reader(config, initial_position)

    def create_topic_admin(self) -> TopicAdmin:
        return self._backend.create_topic_admin()

    def create_deadletter_producer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicProducer | None:
        return self._backend.create_deadletter_producer(agent_id, config)

    async def close(self) -> None:
        await self._backend.close()


class WireKafkaTopicConnectionsRuntime(TopicConnectionsRuntime):
    """``type: kafka`` over the in-tree wire client. Same configuration
    layout as the SDK-backed runtime (``admin: {bootstrap.servers: ...}``)."""

    def init(self, streaming_cluster_configuration: dict[str, Any]) -> None:
        super().init(streaming_cluster_configuration)
        conf = streaming_cluster_configuration or {}
        admin = conf.get("admin", {})
        self.bootstrap = (
            admin.get("bootstrap.servers")
            or conf.get("bootstrap")
            or "127.0.0.1:9092"
        ).split(",")[0]
        # SASL/TLS: the reference's cloud instances put the Java client
        # security properties in the same admin/consumer/producer maps
        # (examples/instances/astra.yaml) — merge, admin lowest precedence
        props = {
            **admin,
            **conf.get("consumer", {}),
            **conf.get("producer", {}),
        }
        self.security = KafkaSecurity.from_client_properties(props)
        ctype = str(
            conf.get("producer", {}).get("compression.type", "none")
        ).lower()
        if ctype in ("none", ""):
            self.compression = None
        elif ctype == "gzip":
            self.compression = "gzip"
        else:
            raise ValueError(
                f"wire lane produce compression.type {ctype!r} not "
                "supported (none|gzip); consumption decompresses "
                "gzip/zstd regardless"
            )

    def create_consumer(self, agent_id: str, config: dict[str, Any]) -> TopicConsumer:
        replica, replicas = _replica_hints(config)
        return WireKafkaTopicConsumer(
            self.bootstrap,
            topic=config["topic"],
            group=config.get("group", agent_id),
            replica_index=replica,
            num_replicas=replicas,
            poll_timeout_ms=int(float(config.get("poll-timeout", 0.5)) * 1000),
            assignment=str(config.get("assignment", "static")).lower(),
            session_timeout_ms=int(config.get("session-timeout-ms", 10000)),
            security=self.security,
        )

    def create_producer(self, agent_id: str, config: dict[str, Any]) -> TopicProducer:
        return WireKafkaTopicProducer(
            self.bootstrap, topic=config["topic"], security=self.security,
            compression=self.compression,
        )

    def create_reader(
        self, config: dict[str, Any], initial_position: str = "latest"
    ) -> TopicReader:
        return WireKafkaTopicReader(
            self.bootstrap, config["topic"], initial_position,
            security=self.security,
        )

    def create_topic_admin(self) -> TopicAdmin:
        return WireKafkaTopicAdmin(self.bootstrap, security=self.security)
