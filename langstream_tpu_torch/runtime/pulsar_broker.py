"""Pulsar streaming runtime (gated on the ``pulsar`` client library).

Parity: ``langstream-pulsar-runtime`` —
``PulsarTopicConnectionsRuntimeProvider.java`` (shared-subscription
consumers with per-message acks, producers with serializer inference,
position-addressed readers for the gateway, admin topic create/delete) —
registered for streamingCluster ``type: pulsar`` when the client library is
importable (``langstream_tpu_torch/runtime/__init__.py``), exactly like the kafka
runtime gates on ``confluent_kafka``.

Pulsar semantics vs Kafka: acknowledgement is per *message id*, not a
contiguous offset prefix — so there is no offset tracker here; the consumer
holds unacked message handles and acks them individually on commit
(redelivery of unacked messages after reconnect is the broker's job).
Topic auto-creation is a Pulsar broker default, so the admin only calls the
REST API when an ``admin-url`` is configured.

Cluster configuration (both the reference's pulsar instance shape and flat
keys are accepted)::

    streamingCluster:
      type: pulsar
      configuration:
        service-url: "pulsar://localhost:6650"
        admin-url: "http://localhost:8080"     # optional (topic admin REST)
        tenant: "public"
        namespace: "default"

The wire encoding mirrors the kafka runtime (shared helpers): values/keys
pick an encoding from the Python type; Pulsar *properties* are strings, so
header payloads travel as UTF-8 with a ``__ls_kinds`` JSON property naming
any non-string kinds.

The port's copy of ``langstream_tpu/runtime/pulsar_broker.py``; it imports
only the port and the standard library (the admin's REST calls go through
``urllib``), and ``pulsar`` only when a client is built.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Any

from langstream_tpu_torch.api.record import Record, SimpleRecord, now_millis
from langstream_tpu_torch.api.topics import (
    OFFSET_HEADER,
    TopicAdmin,
    TopicConnectionsRuntime,
    TopicConsumer,
    TopicOffset,
    TopicProducer,
    TopicReader,
)
from langstream_tpu_torch.runtime.kafka_broker import (
    deserialize_datum,
    serialize_datum_kind,
)

logger = logging.getLogger(__name__)

KINDS_PROP = "__ls_kinds"


def _pulsar():
    import pulsar

    return pulsar


def _cluster_config(configuration: dict[str, Any]) -> dict[str, Any]:
    cfg = configuration.get("configuration", configuration) or {}
    return {
        "service_url": cfg.get("service-url")
        or cfg.get("serviceUrl")
        or cfg.get("brokerServiceUrl")
        or "pulsar://localhost:6650",
        "admin_url": cfg.get("admin-url") or cfg.get("webServiceUrl"),
        "tenant": cfg.get("tenant", "public"),
        "namespace": cfg.get("namespace", "default"),
    }


def _to_property(value: Any) -> tuple[str, str | None]:
    """Encode one header/key value into a Pulsar string property + kind.
    Bytes travel base64 (properties are strings; lossy UTF-8 decoding would
    corrupt binary header values the kafka runtime preserves exactly)."""
    if value is None:
        return "", "null"
    if isinstance(value, bytes):
        return base64.b64encode(value).decode("ascii"), "b64"
    data, kind = serialize_datum_kind(value)
    return (data or b"").decode("utf-8"), kind


def _from_property(raw: str, kind: str | None) -> Any:
    if kind == "null":
        return None
    if kind == "b64":
        return base64.b64decode(raw)
    return deserialize_datum(raw.encode("utf-8"), kind)


def record_to_payload(record: Record) -> tuple[bytes, dict[str, str], str | None]:
    """→ (payload bytes, properties, partition key)."""
    data, value_kind = serialize_datum_kind(record.value)
    kinds: dict[str, str] = {}
    if value_kind:
        kinds["__value"] = value_kind
    properties: dict[str, str] = {}
    for k, v in record.headers:
        if k == OFFSET_HEADER:
            continue  # transport-local
        properties[k], hkind = _to_property(v)
        if hkind:
            kinds[k] = hkind
    partition_key: str | None = None
    if record.key is not None:
        partition_key, kkind = _to_property(record.key)
        if kkind:
            kinds["__key"] = kkind
    if kinds:
        properties[KINDS_PROP] = json.dumps(kinds)
    return data or b"", properties, partition_key


def message_to_record(msg: Any, topic: str) -> Record:
    properties = dict(msg.properties() or {})
    kinds: dict[str, str] = {}
    raw_kinds = properties.pop(KINDS_PROP, None)
    if raw_kinds:
        try:
            kinds = json.loads(raw_kinds)
        except json.JSONDecodeError:
            pass
    headers = tuple(
        (k, _from_property(v, kinds.get(k))) for k, v in properties.items()
    ) + ((OFFSET_HEADER, TopicOffset(topic, 0, str(msg.message_id()))),)
    partition_key = msg.partition_key() if hasattr(msg, "partition_key") else None
    key = (
        _from_property(partition_key, kinds.get("__key"))
        if partition_key
        else None
    )
    ts = None
    if hasattr(msg, "publish_timestamp"):
        ts = msg.publish_timestamp() or None
    return SimpleRecord(
        value=deserialize_datum(msg.data(), kinds.get("__value")),
        key=key,
        headers=headers,
        origin=topic,
        timestamp=ts if ts else now_millis(),
    )


class PulsarTopicConsumer(TopicConsumer):
    """Shared-subscription consumer; blocking client calls run on the
    default executor. Unacked message handles are kept by message-id string
    so ``commit`` acks exactly the records the runner processed."""

    def __init__(self, client_factory, topic: str, subscription: str):
        self._client_factory = client_factory
        self.topic = topic
        self.subscription = subscription
        self._consumer = None
        self._unacked: dict[str, Any] = {}
        self._total_out = 0

    async def start(self) -> None:
        pulsar = _pulsar()
        loop = asyncio.get_running_loop()
        client = self._client_factory()

        def _subscribe():
            return client.subscribe(
                self.topic,
                subscription_name=self.subscription,
                consumer_type=pulsar.ConsumerType.Shared,
                negative_ack_redelivery_delay_ms=1000,
            )

        self._consumer = await loop.run_in_executor(None, _subscribe)

    async def close(self) -> None:
        if self._consumer is not None:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._consumer.close)
            self._consumer = None

    async def read(self) -> list[Record]:
        pulsar = _pulsar()
        loop = asyncio.get_running_loop()
        # captured on the loop thread: close() nulls the field, and the
        # executor closure must not re-read it mid-flight (RACE801)
        consumer = self._consumer

        def _receive():
            try:
                return consumer.receive(timeout_millis=500)
            except pulsar.Timeout:
                return None
            except Exception as e:  # pulsar maps timeouts to generic errors
                if "imeout" in str(e):
                    return None
                raise

        msg = await loop.run_in_executor(None, _receive)
        if msg is None:
            return []
        record = message_to_record(msg, self.topic)
        offset = record.header(OFFSET_HEADER)
        self._unacked[str(offset.offset)] = msg
        self._total_out += 1
        return [record]

    async def commit(self, records: list[Record]) -> None:
        loop = asyncio.get_running_loop()
        for record in records:
            offset = record.header(OFFSET_HEADER)
            if offset is None:
                continue
            msg = self._unacked.pop(str(offset.offset), None)
            if msg is not None:
                await loop.run_in_executor(
                    None, self._consumer.acknowledge, msg
                )

    def total_out(self) -> int:
        return self._total_out


class PulsarTopicProducer(TopicProducer):
    def __init__(self, client_factory, topic: str):
        self._client_factory = client_factory
        self.topic = topic
        self._producer = None
        self._total_in = 0

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        client = self._client_factory()
        self._producer = await loop.run_in_executor(
            None, lambda: client.create_producer(self.topic)
        )

    async def close(self) -> None:
        if self._producer is not None:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._producer.close)
            self._producer = None

    async def write(self, record: Record) -> None:
        payload, properties, partition_key = record_to_payload(record)
        loop = asyncio.get_running_loop()
        # captured on the loop thread — see PulsarTopicConsumer.read
        producer = self._producer

        def _send():
            kwargs: dict[str, Any] = {"properties": properties}
            if partition_key is not None:
                kwargs["partition_key"] = partition_key
            producer.send(payload, **kwargs)

        await loop.run_in_executor(None, _send)
        self._total_in += 1

    def total_in(self) -> int:
        return self._total_in


class PulsarTopicReader(TopicReader):
    """Position-addressed reader (gateway consume side)."""

    def __init__(self, client_factory, topic: str, position: str):
        self._client_factory = client_factory
        self.topic = topic
        self.position = position
        self._reader = None

    async def start(self) -> None:
        pulsar = _pulsar()
        loop = asyncio.get_running_loop()
        client = self._client_factory()
        start = (
            pulsar.MessageId.earliest
            if self.position == "earliest"
            else pulsar.MessageId.latest
        )
        self._reader = await loop.run_in_executor(
            None, lambda: client.create_reader(self.topic, start)
        )

    async def close(self) -> None:
        if self._reader is not None:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._reader.close)
            self._reader = None

    async def read(self, timeout: float | None = None) -> list[Record]:
        pulsar = _pulsar()
        loop = asyncio.get_running_loop()
        millis = int((timeout if timeout is not None else 0.5) * 1000)
        # captured on the loop thread — see PulsarTopicConsumer.read
        reader = self._reader

        def _read():
            try:
                return reader.read_next(timeout_millis=millis)
            except pulsar.Timeout:
                return None
            except Exception as e:
                if "imeout" in str(e):
                    return None
                raise

        msg = await loop.run_in_executor(None, _read)
        return [message_to_record(msg, self.topic)] if msg is not None else []


class PulsarTopicAdmin(TopicAdmin):
    """Admin REST calls when ``admin-url`` is configured; otherwise a no-op
    (Pulsar brokers auto-create topics by default)."""

    def __init__(self, admin_url: str | None, tenant: str, namespace: str):
        self.admin_url = admin_url.rstrip("/") if admin_url else None
        self.tenant = tenant
        self.namespace = namespace

    def _topic_path(self, name: str) -> str:
        if "/" in name:  # already tenant/ns/topic
            return name
        return f"{self.tenant}/{self.namespace}/{name}"

    async def create_topic(
        self, name: str, partitions: int = 1, config: dict[str, Any] | None = None
    ) -> None:
        if not self.admin_url:
            logger.debug("no admin-url; relying on broker topic auto-create")
            return
        path = f"/admin/v2/persistent/{self._topic_path(name)}"
        if partitions > 1:
            status, text = await _admin_request(
                "PUT", f"{self.admin_url}{path}/partitions",
                json.dumps(partitions).encode(),
            )
        else:
            status, text = await _admin_request("PUT", f"{self.admin_url}{path}", b"")
        if status not in (200, 204, 409):
            raise RuntimeError(f"pulsar admin create {name}: {status} {text}")

    async def delete_topic(self, name: str) -> None:
        if not self.admin_url:
            return
        path = f"/admin/v2/persistent/{self._topic_path(name)}"
        status, text = await _admin_request(
            "DELETE", f"{self.admin_url}{path}?force=true", None
        )
        if status not in (200, 204, 404):
            raise RuntimeError(f"pulsar admin delete {name}: {status} {text}")


async def _admin_request(method: str, url: str, body: bytes | None) -> tuple[int, str]:
    """One admin REST call through ``urllib`` on a worker thread (the JAX
    package's admin uses ``aiohttp``, which the port does not import): a
    JSON body when ``body`` is given. Returns (status, body text); an HTTP
    error status is returned, not raised, so the caller tolerates its own."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"} if body else {}
    request = urllib.request.Request(url, data=body, method=method, headers=headers)

    def call() -> tuple[int, str]:
        try:
            with urllib.request.urlopen(request, timeout=30) as resp:
                return resp.status, resp.read().decode("utf-8", "replace")
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode("utf-8", "replace")

    return await asyncio.to_thread(call)


class PulsarTopicConnectionsRuntime(TopicConnectionsRuntime):
    """One shared ``pulsar.Client`` per runtime instance."""

    def __init__(self) -> None:
        self._config: dict[str, Any] = {}
        self._client = None

    def init(self, streaming_cluster_configuration: dict[str, Any]) -> None:
        self._config = _cluster_config(streaming_cluster_configuration)

    def _client_factory(self):
        if self._client is None:
            pulsar = _pulsar()
            self._client = pulsar.Client(self._config["service_url"])
        return self._client

    def create_consumer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicConsumer:
        subscription = (
            config.get("subscription")
            or config.get("group")
            or f"langstream-{agent_id}"
        )
        return PulsarTopicConsumer(
            self._client_factory, config["topic"], subscription
        )

    def create_producer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicProducer:
        return PulsarTopicProducer(self._client_factory, config["topic"])

    def create_reader(
        self,
        config: dict[str, Any],
        initial_position: str = "latest",
    ) -> TopicReader:
        return PulsarTopicReader(
            self._client_factory, config["topic"], initial_position
        )

    def create_topic_admin(self) -> TopicAdmin:
        return PulsarTopicAdmin(
            self._config.get("admin_url"),
            self._config.get("tenant", "public"),
            self._config.get("namespace", "default"),
        )

    async def close(self) -> None:
        if self._client is not None:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._client.close)
            self._client = None
