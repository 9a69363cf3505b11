"""Pravega streaming runtime (gated on the ``pravega_client`` binding).

Parity: ``langstream-pravega-runtime`` —
``PravegaTopicConnectionsRuntimeProvider.java`` (writers with routing keys,
per-consumer reader groups, position-addressed readers, scope/stream admin)
— registered for streamingCluster ``type: pravega`` when the client binding
is importable, the same gating as kafka/pulsar.

Cluster configuration (reference keys, ``PravegaClientUtils.java:37-57``)::

    streamingCluster:
      type: pravega
      configuration:
        client:
          controller-uri: "tcp://localhost:9090"
          scope: "langstream"

Event encoding: Pravega events are opaque byte payloads with no headers, so
one JSON envelope carries the whole record (``value``/``key``/``headers``
with kind tags; raw bytes base64) — the same role the reference's
ObjectMapper serialization plays. Delivery semantics: the binding hands out
segment *slices*; a reader that dies before releasing a slice gets its
events redelivered to the group — at-least-once at slice granularity, which
the contiguity tracker upstream already tolerates (duplicates allowed,
loss not).

The port's copy of ``langstream_tpu/runtime/pravega_broker.py``; it imports
only the port, and ``pravega_client`` only when a stream manager is built.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import uuid
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

logger = logging.getLogger(__name__)


def _pravega():
    import pravega_client

    return pravega_client


def _cluster_config(configuration: dict[str, Any]) -> dict[str, Any]:
    cfg = configuration.get("configuration", configuration) or {}
    client = cfg.get("client", cfg)
    return {
        "controller_uri": client.get("controller-uri", "tcp://localhost:9090"),
        "scope": client.get("scope", "langstream"),
    }


def record_to_event(record: Record) -> tuple[bytes, str | None]:
    """→ (event payload bytes, routing key)."""

    def enc(value: Any) -> Any:
        if isinstance(value, bytes):
            return {"__b64__": base64.b64encode(value).decode("ascii")}
        return value

    envelope = {
        "value": enc(record.value),
        "key": enc(record.key),
        "headers": {
            k: enc(v) for k, v in record.headers if k != OFFSET_HEADER
        },
        "timestamp": record.timestamp,
    }
    routing_key = None
    if record.key is not None:
        routing_key = (
            record.key if isinstance(record.key, str) else json.dumps(record.key)
        )
    return json.dumps(envelope).encode("utf-8"), routing_key


def event_to_record(data: bytes, stream: str, position: Any) -> Record:
    def dec(value: Any) -> Any:
        if isinstance(value, dict) and set(value) == {"__b64__"}:
            return base64.b64decode(value["__b64__"])
        return value

    envelope = json.loads(data)
    headers = tuple(
        (k, dec(v)) for k, v in (envelope.get("headers") or {}).items()
    ) + ((OFFSET_HEADER, TopicOffset(stream, 0, str(position))),)
    return SimpleRecord(
        value=dec(envelope.get("value")),
        key=dec(envelope.get("key")),
        headers=headers,
        origin=stream,
        timestamp=envelope.get("timestamp") or now_millis(),
    )


class PravegaTopicConsumer(TopicConsumer):
    """One reader in a per-agent reader group (parity: the reference's
    ``reader-{uuid}`` groups). Slice events buffer locally; ``commit``
    releases fully-consumed slices back to the group."""

    def __init__(self, manager_factory, scope: str, stream: str, group: str,
                 track_pending: bool = True):
        self._manager_factory = manager_factory
        self.scope = scope
        self.stream = stream
        self.group = group
        # TopicReaders never commit, so tracking their pending events would
        # grow without bound and pin slices forever — they run untracked
        # (drained slices release immediately)
        self._track_pending = track_pending
        self._reader = None
        self._slice = None
        self._slice_future = None  # in-flight get_segment_slice, if any
        self._timed_out = False  # last empty read was a timeout, not a drain
        self._slices_received = 0  # slices the broker has handed out
        self._pending: dict[str, Any] = {}  # position → slice holding it
        self._counter = 0
        self._total_out = 0

    async def start(self) -> None:
        loop = asyncio.get_running_loop()

        def _open():
            manager = self._manager_factory()
            rg = manager.create_reader_group(self.group, self.scope, self.stream)
            return rg.create_reader(f"reader-{uuid.uuid4()}")

        self._reader = await loop.run_in_executor(None, _open)

    async def close(self) -> None:
        if self._slice_future is not None and not self._slice_future.done():
            # don't block shutdown on the blocked call, but don't abandon
            # its result either: release a late slice, swallow a late error
            reader = self._reader
            loop = asyncio.get_running_loop()

            def _dispose(fut) -> None:
                # runs on the event loop when the abandoned blocking call
                # finally resolves: route the (blocking) release back to an
                # executor thread, never run broker RPCs on the loop
                try:
                    late = fut.result()
                except Exception as e:
                    logger.debug("abandoned acquire resolved with error: %s", e)
                    return
                if late is not None and reader is not None:
                    def _release() -> None:
                        try:
                            reader.release_segment(late)
                        except Exception as e:
                            logger.debug(
                                "late segment release skipped "
                                "(reader already offline): %s", e,
                            )

                    try:
                        loop.run_in_executor(None, _release)
                    except RuntimeError:
                        pass  # loop already closed at shutdown

            self._slice_future.add_done_callback(_dispose)
            self._slice_future = None
        if self._reader is not None:
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._reader.reader_offline)
            self._reader = None

    def last_empty_was_timeout(self) -> bool:
        """True when the most recent empty ``read`` hit its timeout (nothing
        available) rather than a slice boundary (more may follow at once)."""
        return self._timed_out

    async def read(self, timeout: float | None = None) -> list[Record]:
        loop = asyncio.get_running_loop()
        # default every path to "not a timeout"; only the timeout return
        # flips it — new empty-return paths then fail safe (drain keeps
        # going on deadline rather than breaking early)
        self._timed_out = False
        if self._slice is None:
            # get_segment_slice blocks until the broker hands a slice out; a
            # bounded read must NOT abandon the blocked call (a second call
            # would double-consume), so the in-flight future is kept and
            # re-awaited on the next read
            if self._slice_future is None:
                # the bound method is captured on the loop thread: close()
                # nulls _reader, and the (possibly abandoned) blocking call
                # must not re-read the field mid-flight (RACE801)
                reader = self._reader
                self._slice_future = loop.run_in_executor(
                    None, reader.get_segment_slice
                )
            if timeout is not None:
                done, _ = await asyncio.wait(
                    {self._slice_future}, timeout=timeout
                )
                if not done:
                    self._timed_out = True
                    return []
            try:
                self._slice = await self._slice_future
                if self._slice is not None:
                    self._slices_received += 1
            finally:
                # a failed call is safe to retry (nothing was consumed);
                # clearing here keeps a transient broker error from wedging
                # every later read on the same cached exception
                self._slice_future = None
            if self._slice is None:
                return []
        # captured on the loop thread (same RACE801 discipline as _reader)
        current_slice = self._slice
        event = await loop.run_in_executor(
            None, lambda: next(iter(current_slice), None)
        )
        if event is None:
            # slice drained; release once everything it held is committed
            if not any(s is self._slice for s in self._pending.values()):
                await loop.run_in_executor(
                    None, self._reader.release_segment, self._slice
                )
            self._slice = None
            return []
        self._counter += 1
        position = f"{self.stream}:{self._counter}"
        record = event_to_record(event.data(), self.stream, position)
        if self._track_pending:
            self._pending[position] = self._slice
        self._total_out += 1
        return [record]

    async def commit(self, records: list[Record]) -> None:
        loop = asyncio.get_running_loop()
        for record in records:
            offset = record.header(OFFSET_HEADER)
            if offset is None:
                continue
            done_slice = self._pending.pop(str(offset.offset), None)
            # release a drained slice whose last pending event just committed
            if (
                done_slice is not None
                and done_slice is not self._slice
                and not any(s is done_slice for s in self._pending.values())
            ):
                await loop.run_in_executor(
                    None, self._reader.release_segment, done_slice
                )

    def total_out(self) -> int:
        return self._total_out


class PravegaTopicProducer(TopicProducer):
    def __init__(self, manager_factory, scope: str, stream: str):
        self._manager_factory = manager_factory
        self.scope = scope
        self.stream = stream
        self._writer = None
        self._total_in = 0

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._writer = await loop.run_in_executor(
            None,
            lambda: self._manager_factory().create_writer(self.scope, self.stream),
        )

    async def close(self) -> None:  # durable shutdown: flush buffered writes
        if self._writer is not None and hasattr(self._writer, "flush"):
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._writer.flush)
        self._writer = None

    async def write(self, record: Record) -> None:
        payload, routing_key = record_to_event(record)
        loop = asyncio.get_running_loop()
        # captured on the loop thread: close() nulls the field, and the
        # executor closure must not re-read it mid-flight (RACE801)
        writer = self._writer

        def _write():
            if routing_key is not None:
                result = writer.write_event_bytes(
                    payload, routing_key=routing_key
                )
            else:
                result = writer.write_event_bytes(payload)
            # the binding queues writes and returns a future; durability =
            # the broker acked, and the tracker upstream commits the source
            # offset when this returns — so block on the ack here
            if hasattr(result, "result"):
                result.result()

        await loop.run_in_executor(None, _write)
        self._total_in += 1

    def total_in(self) -> int:
        return self._total_in


class PravegaTopicReader(TopicReader):
    """Ephemeral reader group per reader (the reference does the same for
    gateway consumers, ``PravegaTopicConnectionsRuntimeProvider.java:112``).
    ``latest`` readers skip whatever is already in the stream."""

    def __init__(self, manager_factory, scope: str, stream: str, position: str):
        self._consumer = PravegaTopicConsumer(
            manager_factory, scope, stream, f"reader-{uuid.uuid4()}",
            track_pending=False,  # readers never commit
        )
        self.position = position

    async def start(self) -> None:
        await self._consumer.start()
        if self.position == "latest":
            # drain the backlog so only new events surface. Empty reads come
            # in two flavors the streak must distinguish: a SLICE-DRAIN
            # empty (more backlog may follow immediately) and a TIMEOUT
            # empty (nothing available right now). The drain ends on a
            # timeout *after data has flowed* (backlog consumed) — a slow
            # first slice delivery must not end it early, or history would
            # replay as live events. An entirely idle stream exits on the
            # deadline; under continuous writes the deadline also bounds
            # the wait ("latest" means roughly-now, not writers-paused).
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 5.0
            while loop.time() < deadline:
                if await self._consumer.read(timeout=0.25):
                    continue
                if not self._consumer.last_empty_was_timeout():
                    continue  # slice boundary: more backlog may follow
                if self._consumer._slices_received > 0:
                    # the broker HAS delivered slices and now nothing more
                    # is immediately available: drained. Before any slice
                    # arrives, a timeout is ambiguous (slow backlog delivery
                    # vs idle stream) — correctness wins, so only the
                    # deadline ends that wait (history must never replay as
                    # live events; an idle stream pays the deadline once at
                    # connect).
                    break

    async def close(self) -> None:
        await self._consumer.close()

    async def read(self, timeout: float | None = None) -> list[Record]:
        return await self._consumer.read(
            timeout=timeout if timeout is not None else 0.5
        )


class PravegaTopicAdmin(TopicAdmin):
    def __init__(self, manager_factory, scope: str):
        self._manager_factory = manager_factory
        self.scope = scope

    async def create_topic(
        self, name: str, partitions: int = 1, config: dict[str, Any] | None = None
    ) -> None:
        loop = asyncio.get_running_loop()

        def _create():
            manager = self._manager_factory()
            manager.create_scope(self.scope)
            manager.create_stream(self.scope, name, max(1, partitions))

        await loop.run_in_executor(None, _create)

    async def delete_topic(self, name: str) -> None:
        loop = asyncio.get_running_loop()

        def _delete():
            manager = self._manager_factory()
            manager.seal_stream(self.scope, name)
            manager.delete_stream(self.scope, name)

        await loop.run_in_executor(None, _delete)


class PravegaTopicConnectionsRuntime(TopicConnectionsRuntime):
    def __init__(self) -> None:
        self._config: dict[str, Any] = {}
        self._manager = None

    def init(self, streaming_cluster_configuration: dict[str, Any]) -> None:
        self._config = _cluster_config(streaming_cluster_configuration)

    def _manager_factory(self):
        if self._manager is None:
            self._manager = _pravega().StreamManager(
                self._config["controller_uri"]
            )
        return self._manager

    def create_consumer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicConsumer:
        group = config.get("group") or f"langstream-{agent_id}"
        return PravegaTopicConsumer(
            self._manager_factory, self._config["scope"], config["topic"], group
        )

    def create_producer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicProducer:
        return PravegaTopicProducer(
            self._manager_factory, self._config["scope"], config["topic"]
        )

    def create_reader(
        self,
        config: dict[str, Any],
        initial_position: str = "latest",
    ) -> TopicReader:
        return PravegaTopicReader(
            self._manager_factory, self._config["scope"], config["topic"],
            initial_position,
        )

    def create_topic_admin(self) -> TopicAdmin:
        return PravegaTopicAdmin(self._manager_factory, self._config["scope"])

    async def close(self) -> None:
        self._manager = None
