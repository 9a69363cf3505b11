"""Kafka-Connect-style bridge agents (types ``sink`` and ``source``).

Parity: ``langstream-kafka-runtime/.../kafkaconnect/KafkaConnectSinkAgent.java``
and ``KafkaConnectSourceAgent.java`` (registered for agent types ``sink`` /
``source`` by ``KafkaConnectCodeProvider.java:26``, configured with
``connector.class`` + passthrough connector properties + ``adapterConfig``).

The reference embeds real Java Connect connectors in the JVM. A Python
framework cannot host Java jars, so this bridge adapts the *Connect data
model* onto the topic SPI for connectors written as Python classes — same
config surface, same record envelopes (the JSON-converter
``{"schema": ..., "payload": ...}`` shape, ``SinkRecord``-style dicts with
topic/partition/offset, source offsets persisted to the agent state dir the
way Connect persists them to its offsets topic):

    class MySinkConnector:          # config: connector.class: mod.MySinkConnector
        def start(self, props): ...
        def put(self, records):     # [{topic, kafkaPartition, kafkaOffset,
            ...                     #   key, value, timestamp, headers}]
        def flush(self): ...
        def stop(self): ...

    class MySourceConnector:
        def start(self, props): ...
        def poll(self):             # → [{value, key?, sourcePartition?,
            ...                     #     sourceOffset?, headers?}]
            # (records go to the pipeline's configured output topic; the
            # topic SPI's source lane has no per-record topic routing)
        def commit(self, offsets): ...
        def stop(self): ...

``props`` receives every configuration key except the bridge's own
(``connector.class``, ``adapterConfig``) — connectors keep their native
property names, so a config written for a real Connect deployment drops in.

The port's copy of ``langstream_tpu/agents/connect.py``; it imports only the port.
"""

from __future__ import annotations

import asyncio
import json
import logging
from pathlib import Path
from typing import Any

from langstream_tpu_torch.agents.python_custom import _load_user_class
from langstream_tpu_torch.api.agent import AgentSink, AgentSource
from langstream_tpu_torch.api.record import Record, make_record

log = logging.getLogger(__name__)

_BRIDGE_KEYS = {
    "connector.class", "adapterConfig", "className",
    "__application_directory__", "__resources__",
    "__persistent_state_directory__",
}


def connect_schema(value: Any) -> dict[str, Any] | None:
    """Infer a Connect schema for a Python value (the JSON converter's
    ``schemas.enable`` envelope half)."""
    if value is None:
        return None
    if isinstance(value, bool):
        return {"type": "boolean", "optional": True}
    if isinstance(value, int):
        return {"type": "int64", "optional": True}
    if isinstance(value, float):
        return {"type": "double", "optional": True}
    if isinstance(value, bytes):
        return {"type": "bytes", "optional": True}
    if isinstance(value, str):
        return {"type": "string", "optional": True}
    if isinstance(value, (list, tuple)):
        item = connect_schema(value[0]) if value else {"type": "string"}
        return {"type": "array", "items": item, "optional": True}
    if isinstance(value, dict):
        return {
            "type": "struct",
            "fields": [
                {"field": k, **(connect_schema(v) or {"type": "string"})}
                for k, v in value.items()
            ],
            "optional": True,
        }
    return {"type": "string", "optional": True}


def envelope(value: Any) -> dict[str, Any]:
    """``{"schema": ..., "payload": ...}`` — the JSON-converter wire shape."""
    return {"schema": connect_schema(value), "payload": value}


def _unwrap_envelope(value: Any) -> Any:
    """Unwrap a converter envelope — only when it actually is one (exactly
    the two keys AND a structural Connect schema), so a business payload
    that merely has 'schema'/'payload' fields passes through untouched."""
    if (
        isinstance(value, dict)
        and set(value) == {"schema", "payload"}
        and (
            value["schema"] is None
            or (isinstance(value["schema"], dict) and "type" in value["schema"])
        )
    ):
        return value["payload"]
    return value


def _connector_props(configuration: dict[str, Any]) -> dict[str, Any]:
    return {
        k: v for k, v in configuration.items() if k not in _BRIDGE_KEYS
    }


async def _maybe_async(result):
    if hasattr(result, "__await__"):
        return await result
    return result


def _load_connector(configuration: dict[str, Any]):
    class_name = configuration.get("connector.class")
    if not class_name:
        raise ValueError(
            "connect bridge requires 'connector.class' (module.Class of a "
            "Python connector)"
        )
    return _load_user_class({**configuration, "className": class_name})()


class ConnectSinkBridge(AgentSink):
    """Agent type ``sink``: topic records → Connect ``SinkRecord`` dicts →
    the connector's ``put``.

    Durability: ``AgentSink.write`` must complete only once the record is
    durably written (the runner acks upstream on return), so every write
    flushes through to the connector before returning and ``put`` errors
    propagate into the error policy. ``adapterConfig.batchSize`` caps how
    many records one ``put`` carries — batches form naturally when several
    upstream records are in flight concurrently (a single flusher drains
    the shared queue). ``lingerTimeMs`` is accepted for reference-config
    compatibility but cannot defer acknowledgement under this SPI.
    """

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        adapter = configuration.get("adapterConfig") or {}
        self.batch_size = int(adapter.get("batchSize", 16))
        self.connector = _load_connector(configuration)
        self._batch: list[dict[str, Any]] = []
        self._offset = 0
        self._flush_lock = asyncio.Lock()

    async def start(self) -> None:
        if hasattr(self.connector, "start"):
            await _maybe_async(
                self.connector.start(_connector_props(self.configuration))
            )

    async def close(self) -> None:
        await self._flush()
        if hasattr(self.connector, "stop"):
            await _maybe_async(self.connector.stop())

    def _sink_record(self, record: Record) -> dict[str, Any]:
        self._offset += 1
        return {
            "topic": record.origin or "",
            "kafkaPartition": 0,
            "kafkaOffset": self._offset,
            "key": envelope(record.key),
            "value": envelope(record.value),
            "timestamp": record.timestamp,
            "headers": {k: v for k, v in record.headers},
        }

    async def write(self, record: Record) -> None:
        self._batch.append(self._sink_record(record))
        await self._flush()

    async def _flush(self) -> None:
        # one flusher at a time; records appended while a put is in flight
        # ride the next put (that's where multi-record batches come from).
        # Records leave the pending batch only AFTER the connector accepted
        # them: a failed put leaves them queued, so a concurrent writer's
        # flush retries them instead of silently dropping them (duplicates
        # on retry are the at-least-once contract, loss is not)
        async with self._flush_lock:
            while self._batch:
                batch = self._batch[: self.batch_size]
                await _maybe_async(self.connector.put(batch))
                if hasattr(self.connector, "flush"):
                    await _maybe_async(self.connector.flush())
                del self._batch[: len(batch)]


class ConnectSourceBridge(AgentSource):
    """Agent type ``source``: the connector's ``poll`` → topic records, with
    source offsets checkpointed to the agent state dir on commit (the role
    Connect's offsets topic plays)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.connector = _load_connector(configuration)
        self._offsets: dict[str, Any] = {}
        self._offsets_path: Path | None = None

    async def setup(self, context) -> None:
        await super().setup(context)
        state = context.get_persistent_state_directory()
        if state:
            self._offsets_path = Path(state) / "connect-source-offsets.json"
            if self._offsets_path.exists():
                self._offsets = json.loads(self._offsets_path.read_text())

    async def start(self) -> None:
        props = _connector_props(self.configuration)
        if self._offsets:
            props["__offsets__"] = self._offsets  # resume point for connectors
        if hasattr(self.connector, "start"):
            await _maybe_async(self.connector.start(props))

    async def close(self) -> None:
        if hasattr(self.connector, "stop"):
            await _maybe_async(self.connector.stop())

    async def read(self) -> list[Record]:
        polled = await _maybe_async(self.connector.poll())
        if not polled:
            await asyncio.sleep(0.05)
            return []
        out: list[Record] = []
        for item in polled:
            value = _unwrap_envelope(item.get("value"))
            key = _unwrap_envelope(item.get("key"))
            headers = dict(item.get("headers") or {})
            if item.get("sourcePartition") is not None:
                headers["__source_partition"] = json.dumps(
                    item["sourcePartition"]
                )
            if item.get("sourceOffset") is not None:
                headers["__source_offset"] = json.dumps(item["sourceOffset"])
            out.append(make_record(value=value, key=key, headers=headers))
        return out

    async def commit(self, records: list[Record]) -> None:
        changed = False
        for record in records:
            partition = record.header("__source_partition")
            offset = record.header("__source_offset")
            if partition is not None and offset is not None:
                self._offsets[partition] = json.loads(offset)
                changed = True
        if changed and self._offsets_path is not None:
            self._offsets_path.parent.mkdir(parents=True, exist_ok=True)
            self._offsets_path.write_text(json.dumps(self._offsets))
        if hasattr(self.connector, "commit"):
            await _maybe_async(self.connector.commit(dict(self._offsets)))
