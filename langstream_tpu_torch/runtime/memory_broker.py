"""In-process partitioned broker with Kafka-class offset semantics.

This is the first-party streaming substrate (the reference embeds a real
Kafka for its dev mode; our dev/default transport is in-tree). Semantics
mirror what the agent runtime relies on in the reference:

- partitioned topics; records hash-routed by key (sticky round-robin when
  keyless);
- consumer *groups* with partition assignment and rebalance on member
  join/leave (parity: ``KafkaConsumerWrapper`` implements
  ``ConsumerRebalanceListener``, ``KafkaConsumerWrapper.java:41``);
- **out-of-order acknowledgement with contiguous-prefix commit**: a consumer
  may commit delivered offsets in any order; the group's committed position
  on a partition only advances over the longest contiguous prefix
  (``KafkaConsumerWrapper.java:203``) — uncommitted gaps are redelivered to
  the next consumer after a restart/rebalance (at-least-once);
- position-addressed *readers* for the gateway consume path (no group).

The port's copy of ``langstream_tpu/runtime/memory_broker.py``; it imports only the port.
"""

from __future__ import annotations

import asyncio
import itertools
import threading
from typing import Any

from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.api.topics import (
    OFFSET_HEADER,
    TopicAdmin,
    TopicConsumer,
    TopicConnectionsRuntime,
    TopicOffset,
    TopicProducer,
    TopicReader,
)


class _Partition:
    def __init__(self, topic: str, index: int):
        self.topic = topic
        self.index = index
        self.records: list[Record] = []

    def append(self, record: Record) -> int:
        self.records.append(record)
        return len(self.records) - 1


class _GroupPartitionState:
    """Per (group, partition): committed position + in-flight offsets."""

    def __init__(self) -> None:
        self.committed = 0  # next offset to deliver after restart
        self.delivered = 0  # next offset to hand out
        self.acked: set[int] = set()

    def ack(self, offset: int) -> None:
        self.acked.add(offset)
        while self.committed in self.acked:
            self.acked.discard(self.committed)
            self.committed += 1

    def reset_to_committed(self) -> None:
        self.delivered = self.committed
        self.acked.clear()


class MemoryTopic:
    def __init__(self, name: str, partitions: int = 1):
        self.name = name
        self.partitions = [_Partition(name, i) for i in range(partitions)]
        self._rr = itertools.cycle(range(partitions))
        self.groups: dict[str, dict[int, _GroupPartitionState]] = {}
        self.memberships: dict[str, "_GroupMembership"] = {}
        self.cond = asyncio.Condition()

    def group_state(self, group: str, partition: int) -> _GroupPartitionState:
        g = self.groups.setdefault(group, {})
        if partition not in g:
            g[partition] = _GroupPartitionState()
        return g[partition]

    def route(self, record: Record) -> _Partition:
        if record.key is not None:
            key = record.key
            if isinstance(key, (dict, list)):
                key = str(key)
            return self.partitions[hash(key) % len(self.partitions)]
        return self.partitions[next(self._rr)]


class MemoryBroker:
    """One named broker cluster: a set of topics shared by every runtime
    instance in this process that names the same cluster."""

    _clusters: dict[str, "MemoryBroker"] = {}
    _clusters_lock = threading.Lock()

    def __init__(self) -> None:
        self.topics: dict[str, MemoryTopic] = {}
        self._lock = threading.Lock()

    @classmethod
    def get(cls, cluster_name: str) -> "MemoryBroker":
        with cls._clusters_lock:
            if cluster_name not in cls._clusters:
                cls._clusters[cluster_name] = cls()
            return cls._clusters[cluster_name]

    @classmethod
    def reset(cls, cluster_name: str | None = None) -> None:
        with cls._clusters_lock:
            if cluster_name is None:
                cls._clusters.clear()
            else:
                cls._clusters.pop(cluster_name, None)

    def topic(self, name: str, create: bool = True, partitions: int = 1) -> MemoryTopic:
        with self._lock:
            if name not in self.topics:
                if not create:
                    raise KeyError(f"unknown topic {name!r}")
                self.topics[name] = MemoryTopic(name, partitions)
            return self.topics[name]

    async def publish(self, topic_name: str, record: Record) -> TopicOffset:
        topic = self.topic(topic_name)
        async with topic.cond:
            partition = topic.route(record)
            stamped = SimpleRecord(
                value=record.value,
                key=record.key,
                headers=record.headers,
                origin=topic_name,
                timestamp=record.timestamp,
            )
            offset = partition.append(stamped)
            topic.cond.notify_all()
        return TopicOffset(topic_name, partition.index, offset)


class _GroupMembership:
    """Static round-robin partition assignment among live group members."""

    def __init__(self, topic: MemoryTopic, group: str):
        self.topic = topic
        self.group = group
        self.members: list["MemoryTopicConsumer"] = []

    def join(self, consumer: "MemoryTopicConsumer") -> None:
        self.members.append(consumer)
        self._rebalance()

    def leave(self, consumer: "MemoryTopicConsumer") -> None:
        if consumer in self.members:
            self.members.remove(consumer)
        self._rebalance()

    def _rebalance(self) -> None:
        n = len(self.members)
        for m in self.members:
            m.assigned = []
        if n == 0:
            return
        for i, partition in enumerate(self.topic.partitions):
            member = self.members[i % n]
            member.assigned.append(partition.index)
            # redelivery from the committed position for newly-assigned parts
            self.topic.group_state(self.group, partition.index).reset_to_committed()


def _membership(topic: MemoryTopic, group: str) -> _GroupMembership:
    # stored on the topic itself, so dropping the broker drops everything
    if group not in topic.memberships:
        topic.memberships[group] = _GroupMembership(topic, group)
    return topic.memberships[group]


class MemoryTopicConsumer(TopicConsumer):
    def __init__(self, broker: MemoryBroker, topic_name: str, group: str,
                 poll_batch: int = 64, poll_timeout: float = 0.5):
        self.broker = broker
        self.topic_name = topic_name
        self.group = group
        self.poll_batch = poll_batch
        self.poll_timeout = poll_timeout
        self.assigned: list[int] = []
        self._total_out = 0
        self._started = False

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        topic = self.broker.topic(self.topic_name)
        async with topic.cond:
            _membership(topic, self.group).join(self)

    async def close(self) -> None:
        if not self._started:
            return
        topic = self.broker.topic(self.topic_name)
        async with topic.cond:
            _membership(topic, self.group).leave(self)
        self._started = False

    async def read(self) -> list[Record]:
        topic = self.broker.topic(self.topic_name)
        async with topic.cond:
            batch = self._poll_locked(topic)
            if batch:
                return batch
            try:
                await asyncio.wait_for(topic.cond.wait(), timeout=self.poll_timeout)
            except asyncio.TimeoutError:
                return []
            return self._poll_locked(topic)

    def _poll_locked(self, topic: MemoryTopic) -> list[Record]:
        batch: list[Record] = []
        for pi in self.assigned:
            partition = topic.partitions[pi]
            state = topic.group_state(self.group, pi)
            while state.delivered < len(partition.records) and len(batch) < self.poll_batch:
                record = partition.records[state.delivered]
                stamped = record.with_headers(
                    {OFFSET_HEADER: TopicOffset(self.topic_name, pi, state.delivered)}
                )
                batch.append(stamped)
                state.delivered += 1
        self._total_out += len(batch)
        return batch

    async def commit(self, records: list[Record]) -> None:
        topic = self.broker.topic(self.topic_name)
        async with topic.cond:
            for record in records:
                offset: TopicOffset | None = record.header(OFFSET_HEADER)
                if offset is None or offset.topic != self.topic_name:
                    continue
                topic.group_state(self.group, offset.partition).ack(offset.offset)

    def total_out(self) -> int:
        return self._total_out


class MemoryTopicProducer(TopicProducer):
    def __init__(self, broker: MemoryBroker, topic_name: str):
        self.broker = broker
        self.topic_name = topic_name
        self._total_in = 0

    async def write(self, record: Record) -> None:
        # strip transport headers before re-publishing
        if record.header(OFFSET_HEADER) is not None:
            record = SimpleRecord(
                value=record.value,
                key=record.key,
                headers=tuple(
                    (k, v) for k, v in record.headers if k != OFFSET_HEADER
                ),
                origin=record.origin,
                timestamp=record.timestamp,
            )
        await self.broker.publish(self.topic_name, record)
        self._total_in += 1

    def total_in(self) -> int:
        return self._total_in


class MemoryTopicReader(TopicReader):
    """Position-addressed reader over all partitions (gateway consume)."""

    def __init__(self, broker: MemoryBroker, topic_name: str, initial_position: str):
        self.broker = broker
        self.topic_name = topic_name
        self.initial_position = initial_position
        self.positions: dict[int, int] = {}

    async def start(self) -> None:
        topic = self.broker.topic(self.topic_name)
        async with topic.cond:
            for p in topic.partitions:
                self.positions[p.index] = (
                    0 if self.initial_position == "earliest" else len(p.records)
                )

    async def read(self, timeout: float | None = 0.5) -> list[Record]:
        topic = self.broker.topic(self.topic_name)
        async with topic.cond:
            batch = self._poll_locked(topic)
            if batch or timeout == 0:
                return batch
            try:
                await asyncio.wait_for(topic.cond.wait(), timeout=timeout)
            except asyncio.TimeoutError:
                return []
            return self._poll_locked(topic)

    def _poll_locked(self, topic: MemoryTopic) -> list[Record]:
        batch: list[Record] = []
        for p in topic.partitions:
            pos = self.positions.setdefault(p.index, len(p.records))
            while pos < len(p.records):
                batch.append(
                    p.records[pos].with_headers(
                        {OFFSET_HEADER: TopicOffset(self.topic_name, p.index, pos)}
                    )
                )
                pos += 1
            self.positions[p.index] = pos
        return batch


class MemoryTopicAdmin(TopicAdmin):
    def __init__(self, broker: MemoryBroker):
        self.broker = broker

    async def create_topic(
        self, name: str, partitions: int = 1, options: dict[str, Any] | None = None
    ) -> None:
        self.broker.topic(name, create=True, partitions=partitions)

    async def delete_topic(self, name: str) -> None:
        with self.broker._lock:
            self.broker.topics.pop(name, None)


class MemoryTopicConnectionsRuntime(TopicConnectionsRuntime):
    def init(self, streaming_cluster_configuration: dict[str, Any]) -> None:
        super().init(streaming_cluster_configuration)
        cluster = (streaming_cluster_configuration or {}).get("cluster", "default")
        self.broker = MemoryBroker.get(cluster)

    def create_consumer(self, agent_id: str, config: dict[str, Any]) -> TopicConsumer:
        return MemoryTopicConsumer(
            self.broker,
            topic_name=config["topic"],
            group=config.get("group", agent_id),
            poll_batch=int(config.get("poll-batch", 64)),
            poll_timeout=float(config.get("poll-timeout", 0.5)),
        )

    def create_producer(self, agent_id: str, config: dict[str, Any]) -> TopicProducer:
        return MemoryTopicProducer(self.broker, topic_name=config["topic"])

    def create_reader(
        self, config: dict[str, Any], initial_position: str = "latest"
    ) -> TopicReader:
        return MemoryTopicReader(self.broker, config["topic"], initial_position)

    def create_topic_admin(self) -> TopicAdmin:
        return MemoryTopicAdmin(self.broker)
