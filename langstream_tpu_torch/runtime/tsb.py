"""tpustream broker client: the native-broker TopicConnectionsRuntime (the
port's copy of ``langstream_tpu/runtime/tsb.py``, over the port's records;
the wire bytes are the JAX client's, so either package's producer feeds the
other's consumer on one broker).

Speaks the tsbroker wire protocol (``langstream_tpu_torch/native/tsbroker.cc``)
over asyncio TCP. Semantics mirror the reference's Kafka runtime:

- consumer groups with broker-driven partition assignment and rebalance
  (parity: ``KafkaConsumerWrapper`` implementing ``ConsumerRebalanceListener``,
  ``langstream-kafka-runtime/.../runner/KafkaConsumerWrapper.java:41``);
- out-of-order ack tracking committing only the longest contiguous prefix
  per partition (parity: ``KafkaConsumerWrapper.java:194-203`` — TreeSet of
  uncommitted offsets);
- position-addressed readers for the gateway (``KafkaReaderWrapper.java``);
- dead-letter producers on ``<topic>-deadletter``
  (``KafkaTopicConnectionsRuntime.java:123``).

Registered as streaming-cluster ``type: tpustream``; config:
``{"bootstrap": "host:port"}`` (or separate host/port keys).
"""

from __future__ import annotations

import asyncio
import base64
import itertools
import json
import socket
import struct
from typing import Any

from langstream_tpu_torch.api.record import Record, SimpleRecord
from langstream_tpu_torch.api.topics import (
    OFFSET_HEADER,
    TopicAdmin,
    TopicConnectionsRuntime,
    TopicConnectionsRuntimeRegistry,
    TopicConsumer,
    TopicOffset,
    TopicProducer,
    TopicReader,
)

OP_PRODUCE = 1
OP_FETCH = 2
OP_COMMIT = 3
OP_COMMITTED = 4
OP_CREATE_TOPIC = 5
OP_DELETE_TOPIC = 6
OP_LIST_TOPICS = 7
OP_JOIN_GROUP = 8
OP_LEAVE_GROUP = 9
OP_PING = 10
OP_OFFSETS = 11

STATUS_OK = 0
STATUS_ERROR = 1
STATUS_REBALANCED = 2

_FETCH_WAIT_MS = 10_000
_MAX_FETCH_RECORDS = 64


# ---------------------------------------------------------------------------
# wire codec


def _p_str(s: str) -> bytes:
    raw = s.encode()
    return struct.pack(">H", len(raw)) + raw


def _p_blob(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        (v,) = struct.unpack_from(">H", self.buf, self.pos)
        self.pos += 2
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from(">I", self.buf, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from(">Q", self.buf, self.pos)
        self.pos += 8
        return v

    def i64(self) -> int:
        v = self.u64()
        return v - (1 << 64) if v >= (1 << 63) else v

    def str(self) -> str:
        n = self.u16()
        v = self.buf[self.pos : self.pos + n].decode()
        self.pos += n
        return v

    def blob(self) -> bytes:
        n = self.u32()
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return v


# ---------------------------------------------------------------------------
# record <-> wire. The full record rides as a JSON envelope in the wire value;
# the wire key carries only the routing key bytes (stable partition hashing
# happens broker-side).


def _tag(value: Any) -> Any:
    if isinstance(value, bytes):
        return {"__b64__": base64.b64encode(value).decode()}
    if isinstance(value, TopicOffset):
        return None  # transport-internal, never serialized
    return value


def _untag(value: Any) -> Any:
    if isinstance(value, dict) and set(value) == {"__b64__"}:
        return base64.b64decode(value["__b64__"])
    return value


def _walk(value: Any, fn) -> Any:
    value = fn(value)
    if isinstance(value, dict):
        return {k: _walk(v, fn) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_walk(v, fn) for v in value]
    return value


def encode_record(record: Record) -> tuple[bytes, bytes]:
    headers = [
        [k, _walk(v, _tag)]
        for k, v in record.headers
        if k != OFFSET_HEADER and not isinstance(v, TopicOffset)
    ]
    envelope = {
        "key": _walk(record.key, _tag),
        "value": _walk(record.value, _tag),
        "headers": headers,
        "origin": record.origin,
        "timestamp": record.timestamp,
    }
    if record.key is None:
        routing = b""
    elif isinstance(record.key, bytes):
        routing = record.key
    elif isinstance(record.key, str):
        routing = record.key.encode()
    else:
        routing = json.dumps(record.key, sort_keys=True).encode()
    return routing, json.dumps(envelope).encode()


def decode_record(value: bytes) -> SimpleRecord:
    env = json.loads(value.decode())
    return SimpleRecord(
        value=_walk(env.get("value"), _untag),
        key=_walk(env.get("key"), _untag),
        headers=tuple((k, _walk(v, _untag)) for k, v in env.get("headers", [])),
        origin=env.get("origin"),
        timestamp=env.get("timestamp"),
    )


def _read_wire_record(cur: "_Cursor") -> tuple[int, SimpleRecord]:
    """Parse one record from a FETCH reply: offset, routing key (the
    authoritative copy lives in the envelope), envelope, wire headers."""
    offset = cur.u64()
    cur.blob()  # routing key
    record = decode_record(cur.blob())
    for _ in range(cur.u16()):  # wire-level headers (unused by this client)
        cur.str()
        cur.blob()
    return offset, record


# ---------------------------------------------------------------------------
# connection


class TsbError(RuntimeError):
    pass


class Rebalanced(Exception):
    """Raised to a fetch waiter when its group generation went stale."""


class TsbConnection:
    """One TCP connection; concurrent requests multiplexed by request id."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._ids = itertools.count(1)
        self._pump: asyncio.Task | None = None
        self._closed = False

    async def connect(self) -> "TsbConnection":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        sock = self._writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._pump = asyncio.ensure_future(self._pump_loop())
        return self

    async def _pump_loop(self) -> None:
        try:
            while True:
                header = await self._reader.readexactly(4)
                (length,) = struct.unpack(">I", header)
                payload = await self._reader.readexactly(length)
                cur = _Cursor(payload)
                rid = cur.u64()
                status = cur.u8()
                fut = self._pending.pop(rid, None)
                if fut is None or fut.done():
                    continue
                if status == STATUS_ERROR:
                    fut.set_exception(TsbError(cur.str()))
                elif status == STATUS_REBALANCED:
                    fut.set_exception(Rebalanced())
                else:
                    fut.set_result(cur)
        except (asyncio.IncompleteReadError, ConnectionError, OSError) as exc:
            err = ConnectionError(f"tsbroker connection lost: {exc}")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
        except asyncio.CancelledError:
            pass

    async def request(self, opcode: int, body: bytes = b"") -> _Cursor:
        if self._writer is None:
            raise TsbError("not connected")
        rid = next(self._ids)
        payload = struct.pack(">BQ", opcode, rid) + body
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[rid] = fut
        self._writer.write(struct.pack(">I", len(payload)) + payload)
        await self._writer.drain()
        return await fut

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._pump is not None:
            self._pump.cancel()
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass


# ---------------------------------------------------------------------------
# consumer


class _PartitionState:
    """Offset bookkeeping for one assigned partition.

    ``next_fetch`` advances as records are delivered; ``outstanding`` holds
    delivered-but-unacked offsets. The committable watermark is the smallest
    outstanding offset (or ``next_fetch`` when none) — the longest contiguous
    acked prefix, exactly the reference's TreeSet rule
    (``KafkaConsumerWrapper.java:194-203``).
    """

    __slots__ = ("next_fetch", "outstanding", "committed")

    def __init__(self, start: int):
        self.next_fetch = start
        self.outstanding: set[int] = set()
        self.committed = start

    def watermark(self) -> int:
        return min(self.outstanding) if self.outstanding else self.next_fetch


class TsbTopicConsumer(TopicConsumer):
    def __init__(
        self,
        host: str,
        port: int,
        topic: str,
        group: str,
        client_id: str,
        poll_timeout: float = 1.0,
        max_poll_records: int = _MAX_FETCH_RECORDS,
    ):
        self.topic = topic
        self.group = group
        self.client_id = client_id
        self.poll_timeout = poll_timeout
        self.max_poll_records = max_poll_records
        self._conn = TsbConnection(host, port)
        self._generation = 0
        self._parts: dict[int, _PartitionState] = {}
        self._fetches: dict[int, asyncio.Task] = {}
        self._started = False
        self._total_out = 0

    async def start(self) -> None:
        await self._conn.connect()
        await self._join()
        self._started = True

    async def _join(self) -> None:
        cur = await self._conn.request(
            OP_JOIN_GROUP,
            _p_str(self.group) + _p_str(self.topic) + _p_str(self.client_id),
        )
        self._generation = cur.u32()
        assigned = [cur.u32() for _ in range(cur.u32())]
        # Redelivery-on-rebalance: positions reset to the committed offset,
        # in-flight work for revoked partitions is simply dropped.
        for task in self._fetches.values():
            task.cancel()
        self._fetches.clear()
        self._parts = {}
        for pi in assigned:
            cur = await self._conn.request(
                OP_COMMITTED,
                _p_str(self.group) + _p_str(self.topic) + struct.pack(">I", pi),
            )
            committed = cur.i64()
            self._parts[pi] = _PartitionState(max(0, committed))

    def _fetch_body(self, pi: int, state: _PartitionState) -> bytes:
        return (
            _p_str(self.topic)
            + struct.pack(
                ">IQII",
                pi,
                state.next_fetch,
                self.max_poll_records,
                _FETCH_WAIT_MS,
            )
            + _p_str(self.group)
            + struct.pack(">I", self._generation)
        )

    async def read(self) -> list[Record]:
        if not self._started:
            raise TsbError("consumer not started")
        # Keep one long-poll fetch in flight per assigned partition; return
        # as soon as any partition yields records.
        for pi, state in self._parts.items():
            if pi not in self._fetches or self._fetches[pi].done():
                if pi in self._fetches and self._fetches[pi].done():
                    continue  # completed result is harvested below
                self._fetches[pi] = asyncio.ensure_future(
                    self._conn.request(OP_FETCH, self._fetch_body(pi, state))
                )
        if not self._fetches:
            await asyncio.sleep(self.poll_timeout)
            return []
        done, _ = await asyncio.wait(
            self._fetches.values(),
            timeout=self.poll_timeout,
            return_when=asyncio.FIRST_COMPLETED,
        )
        if not done:
            return []
        batch: list[Record] = []
        rebalanced = False
        for pi in list(self._fetches):
            task = self._fetches[pi]
            if not task.done():
                continue
            del self._fetches[pi]
            try:
                cur = task.result()
            except Rebalanced:
                rebalanced = True
                continue
            except asyncio.CancelledError:
                continue
            state = self._parts.get(pi)
            if state is None:
                continue
            for _ in range(cur.u32()):
                offset, record = _read_wire_record(cur)
                if offset < state.next_fetch:
                    continue
                state.next_fetch = offset + 1
                state.outstanding.add(offset)
                batch.append(
                    record.with_headers(
                        {OFFSET_HEADER: TopicOffset(self.topic, pi, offset)}
                    )
                )
        if rebalanced:
            await self._join()
        self._total_out += len(batch)
        return batch

    async def commit(self, records: list[Record]) -> None:
        touched: set[int] = set()
        for record in records:
            offset: TopicOffset | None = record.header(OFFSET_HEADER)
            if offset is None or offset.topic != self.topic:
                continue
            state = self._parts.get(offset.partition)
            if state is None:
                continue  # partition revoked by a rebalance; will redeliver
            state.outstanding.discard(offset.offset)
            touched.add(offset.partition)
        for pi in touched:
            state = self._parts[pi]
            watermark = state.watermark()
            if watermark > state.committed:
                state.committed = watermark
                await self._conn.request(
                    OP_COMMIT,
                    _p_str(self.group)
                    + _p_str(self.topic)
                    + struct.pack(">IQ", pi, watermark),
                )

    async def close(self) -> None:
        if not self._started:
            return
        self._started = False
        for task in self._fetches.values():
            task.cancel()
        self._fetches.clear()
        try:
            await self._conn.request(
                OP_LEAVE_GROUP,
                _p_str(self.group) + _p_str(self.topic) + _p_str(self.client_id),
            )
        except (TsbError, ConnectionError):
            pass
        await self._conn.close()

    def total_out(self) -> int:
        return self._total_out


class TsbTopicProducer(TopicProducer):
    def __init__(self, host: str, port: int, topic: str):
        self.topic = topic
        self._conn = TsbConnection(host, port)
        self._total_in = 0

    async def start(self) -> None:
        await self._conn.connect()

    async def write(self, record: Record) -> None:
        routing, value = encode_record(record)
        await self._conn.request(
            OP_PRODUCE,
            _p_str(self.topic)
            + _p_blob(routing)
            + _p_blob(value)
            + struct.pack(">H", 0),
        )
        self._total_in += 1

    async def close(self) -> None:
        await self._conn.close()

    def total_in(self) -> int:
        return self._total_in


class TsbTopicReader(TopicReader):
    """Position-addressed reader over all partitions (gateway consume path)."""

    def __init__(self, host: str, port: int, topic: str,
                 initial_position: str = "latest"):
        self.topic = topic
        self.initial_position = initial_position
        self._conn = TsbConnection(host, port)
        self._positions: dict[int, int] = {}

    async def start(self) -> None:
        await self._conn.connect()
        cur = await self._conn.request(OP_LIST_TOPICS)
        nparts = 1
        for _ in range(cur.u32()):
            name = cur.str()
            n = cur.u32()
            if name == self.topic:
                nparts = n
        for pi in range(nparts):
            cur = await self._conn.request(
                OP_OFFSETS, _p_str(self.topic) + struct.pack(">I", pi)
            )
            earliest, end = cur.u64(), cur.u64()
            if self.initial_position == "earliest":
                self._positions[pi] = earliest
            elif isinstance(self.initial_position, int):
                self._positions[pi] = self.initial_position
            else:
                self._positions[pi] = end

    async def read(self, timeout: float | None = None) -> list[Record]:
        wait_ms = int((timeout or 0.5) * 1000)
        tasks = {
            pi: asyncio.ensure_future(
                self._conn.request(
                    OP_FETCH,
                    _p_str(self.topic)
                    + struct.pack(
                        ">IQII", pi, pos, _MAX_FETCH_RECORDS, wait_ms
                    )
                    + _p_str("")
                    + struct.pack(">I", 0),
                )
            )
            for pi, pos in self._positions.items()
        }
        if not tasks:
            return []
        await asyncio.wait(tasks.values(), return_when=asyncio.ALL_COMPLETED)
        batch: list[Record] = []
        for pi, task in tasks.items():
            try:
                cur = task.result()
            except (TsbError, Rebalanced):
                continue
            for _ in range(cur.u32()):
                offset, record = _read_wire_record(cur)
                batch.append(record)
                self._positions[pi] = offset + 1
        return batch

    async def close(self) -> None:
        await self._conn.close()


class TsbTopicAdmin(TopicAdmin):
    def __init__(self, host: str, port: int):
        self._conn = TsbConnection(host, port)
        self._connected = False

    async def _ensure(self) -> None:
        if not self._connected:
            await self._conn.connect()
            self._connected = True

    async def create_topic(self, name: str, partitions: int = 1,
                           options: dict | None = None) -> None:
        await self._ensure()
        await self._conn.request(
            OP_CREATE_TOPIC, _p_str(name) + struct.pack(">I", partitions)
        )

    async def delete_topic(self, name: str) -> None:
        await self._ensure()
        await self._conn.request(OP_DELETE_TOPIC, _p_str(name))

    async def close(self) -> None:
        await self._conn.close()


class TsbTopicConnectionsRuntime(TopicConnectionsRuntime):
    """streamingCluster ``type: tpustream``."""

    def __init__(self) -> None:
        self.host = "127.0.0.1"
        self.port = 0
        self._client_seq = itertools.count()

    def init(self, streaming_cluster_configuration: dict[str, Any]) -> None:
        config = streaming_cluster_configuration or {}
        bootstrap = config.get("bootstrap")
        if bootstrap:
            host, _, port = str(bootstrap).rpartition(":")
            self.host, self.port = host or "127.0.0.1", int(port)
        else:
            self.host = config.get("host", "127.0.0.1")
            self.port = int(config.get("port", 0))
        if not self.port:
            raise TsbError(
                "tpustream streaming cluster requires configuration.bootstrap "
                '("host:port") or host/port'
            )

    def create_consumer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicConsumer:
        topic = config["topic"]
        group = config.get("group", agent_id or f"group-{topic}")
        client_id = f"{group}-{next(self._client_seq)}"
        return TsbTopicConsumer(self.host, self.port, topic, group, client_id)

    def create_producer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicProducer:
        return TsbTopicProducer(self.host, self.port, config["topic"])

    def create_reader(
        self, config: dict[str, Any], initial_position: str = "latest"
    ) -> TopicReader:
        return TsbTopicReader(
            self.host, self.port, config["topic"], initial_position
        )

    def create_topic_admin(self) -> TopicAdmin:
        return TsbTopicAdmin(self.host, self.port)

    def create_deadletter_producer(
        self, agent_id: str, config: dict[str, Any]
    ) -> TopicProducer:
        return TsbTopicProducer(
            self.host, self.port, config["topic"] + "-deadletter"
        )

    async def close(self) -> None:
        pass


TopicConnectionsRuntimeRegistry.register("tpustream", TsbTopicConnectionsRuntime)
