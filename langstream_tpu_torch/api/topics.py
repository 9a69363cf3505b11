"""Topic contracts: the pluggable streaming substrate.

Parity: ``TopicConsumer``/``TopicProducer``/``TopicReader``/``TopicAdmin`` and
``TopicConnectionsRuntime`` (``langstream-api/.../runner/topics/*.java``) —
the SPI behind which Kafka/Pulsar/Pravega live in the reference. Here the
first-party implementation is the in-memory partitioned broker
(``langstream_tpu/runtime/memory_broker.py``); external brokers plug in via
the same registry.

Offset semantics (the at-least-once backbone): consumers track delivered but
uncommitted offsets per partition and commit only the longest contiguous
prefix, exactly like the reference's ``KafkaConsumerWrapper``
(``langstream-kafka-runtime/.../KafkaConsumerWrapper.java:41,203``).

The port's copy of ``langstream_tpu/api/topics.py``; it imports only the port.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any

from langstream_tpu_torch.api.record import Record


@dataclass(frozen=True)
class TopicOffset:
    """Position of a record on a partitioned topic."""

    topic: str
    partition: int
    offset: int


#: Header under which brokers attach each record's :class:`TopicOffset`
#: (the cross-module wire constant used by brokers, the runtime tracker and
#: the gateway's consume push messages).
OFFSET_HEADER = "__offset"


class TopicConsumer(abc.ABC):
    """Group-managed consumer with contiguous-prefix commit."""

    async def start(self) -> None: ...

    async def close(self) -> None: ...

    @abc.abstractmethod
    async def read(self) -> list[Record]:
        """Poll a batch of records (may be empty). Records carry their
        :class:`TopicOffset` in the header ``__offset``."""

    @abc.abstractmethod
    async def commit(self, records: list[Record]) -> None:
        """Mark records processed; the broker position advances only over
        contiguous prefixes of delivered offsets."""

    def total_out(self) -> int:
        return 0


class TopicProducer(abc.ABC):
    async def start(self) -> None: ...

    async def close(self) -> None: ...

    @abc.abstractmethod
    async def write(self, record: Record) -> None:
        """Durably append; returns when acknowledged."""

    def total_in(self) -> int:
        return 0


class TopicReader(abc.ABC):
    """Position-addressed reader (no group) — used by the gateway's consume
    path so each WebSocket session reads independently."""

    async def start(self) -> None: ...

    async def close(self) -> None: ...

    @abc.abstractmethod
    async def read(self, timeout: float | None = None) -> list[Record]: ...


class TopicAdmin(abc.ABC):
    @abc.abstractmethod
    async def create_topic(
        self, name: str, partitions: int = 1, options: dict[str, Any] | None = None
    ) -> None: ...

    @abc.abstractmethod
    async def delete_topic(self, name: str) -> None: ...


class TopicConnectionsRuntime(abc.ABC):
    """Factory for consumers/producers/readers/admin against one streaming
    cluster (``TopicConnectionsRuntime`` SPI in the reference)."""

    def init(self, streaming_cluster_configuration: dict[str, Any]) -> None:
        self.configuration = streaming_cluster_configuration

    @abc.abstractmethod
    def create_consumer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicConsumer: ...

    @abc.abstractmethod
    def create_producer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicProducer: ...

    @abc.abstractmethod
    def create_reader(
        self,
        config: dict[str, Any],
        initial_position: str = "latest",
    ) -> TopicReader: ...

    @abc.abstractmethod
    def create_topic_admin(self) -> TopicAdmin: ...

    def create_deadletter_producer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicProducer | None:
        """Producer to ``<topic>-deadletter`` (parity:
        ``KafkaTopicConnectionsRuntime.java:123``)."""
        cfg = dict(config)
        topic = cfg.get("topic")
        if not topic:
            return None
        cfg["topic"] = f"{topic}-deadletter"
        return self.create_producer(agent_id, cfg)

    async def close(self) -> None: ...


#: the transports that register only when their client library imports,
#: with that library (named when such a transport is asked for without it)
CLIENT_LIBRARIES = {"pulsar": "pulsar", "pravega": "pravega_client"}


class TopicConnectionsRuntimeRegistry:
    """Maps streaming-cluster ``type`` → runtime factory.

    Built-ins are registered by the runtime package on import: ``memory``,
    ``tpustream`` and ``kafka`` always, ``pulsar`` and ``pravega`` when
    their client libraries import (:data:`CLIENT_LIBRARIES`).
    """

    _factories: dict[str, type[TopicConnectionsRuntime]] = {}

    @classmethod
    def register(cls, type_name: str, factory: type[TopicConnectionsRuntime]) -> None:
        cls._factories[type_name] = factory

    @classmethod
    def get_runtime(cls, streaming_cluster: dict[str, Any]) -> TopicConnectionsRuntime:
        type_name = (streaming_cluster or {}).get("type", "memory")
        if type_name not in cls._factories:
            # Built-in runtimes self-register on package import.
            import langstream_tpu_torch.runtime  # noqa: F401

        if type_name not in cls._factories:
            library = CLIENT_LIBRARIES.get(type_name)
            if library is not None:
                raise ValueError(
                    f"streaming cluster type {type_name!r} needs the {library!r} "
                    f"client library, which is not installed "
                    f"(known: {sorted(cls._factories)})"
                )
            raise ValueError(
                f"no TopicConnectionsRuntime for type {type_name!r}; "
                f"known: {sorted(cls._factories)}"
            )
        runtime = cls._factories[type_name]()
        runtime.init((streaming_cluster or {}).get("configuration", {}))
        return runtime
