"""A fake Kafka broker speaking the server side of the wire protocol: the
port's copy of ``tests/fake_kafka.py``, importing only the standard library.

No Kafka broker runs on the machines that test the port, so the port's
client (``langstream_tpu_torch/runtime/kafka_wire.py``) is proven against
this server, and so is the JAX package's. The request parsing, the
record-batch decoding and the CRC-32C are written apart from both clients
here (own field-by-field parsing, own checksum over the wire bytes), so a
client-side encoding bug surfaces as a server-side parse or CRC failure
rather than a round trip that agrees with itself.

Single-node cluster (node id 0 = this server); supports the same
non-flexible API versions the clients speak (:data:`SUPPORTED_APIS`).
Beyond the JAX fake it keeps what a check of a run reads from the
broker's side: each connection's requests in order (``connections``), and
it holds an empty Fetch until a record arrives or the request's
``max_wait_ms`` passes, as a broker does with ``min_bytes`` 1 (the JAX
fake answers at once, so a consumer polls it in a busy loop).

Run it alone: ``python tests/torch_fake_kafka.py [--port P] [--scram USER
PASSWORD]`` serves until interrupted and prints its address.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import secrets
import struct
import threading
from dataclasses import dataclass, field

# API keys and error codes, kept here rather than imported from either
# package's client, so the server's reading of the protocol is its own
API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_FIND_COORDINATOR = 10
API_JOIN_GROUP = 11
API_HEARTBEAT = 12
API_LEAVE_GROUP = 13
API_SYNC_GROUP = 14
API_SASL_HANDSHAKE = 17
API_API_VERSIONS = 18
API_CREATE_TOPICS = 19
API_DELETE_TOPICS = 20
API_SASL_AUTHENTICATE = 36

ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER_ID = 25
ERR_REBALANCE_IN_PROGRESS = 27
ERR_UNSUPPORTED_SASL_MECHANISM = 33
ERR_TOPIC_ALREADY_EXISTS = 36
ERR_SASL_AUTHENTICATION_FAILED = 58

#: (api key, lowest version, highest version) this broker answers, as its
#: ApiVersions response lists them
SUPPORTED_APIS = (
    (API_PRODUCE, 0, 3), (API_FETCH, 0, 4),
    (API_LIST_OFFSETS, 0, 1), (API_METADATA, 0, 1),
    (API_OFFSET_COMMIT, 0, 2), (API_OFFSET_FETCH, 0, 1),
    (API_FIND_COORDINATOR, 0, 1), (API_JOIN_GROUP, 0, 2),
    (API_HEARTBEAT, 0, 1), (API_LEAVE_GROUP, 0, 1),
    (API_SYNC_GROUP, 0, 1), (API_API_VERSIONS, 0, 0),
    (API_CREATE_TOPICS, 0, 1), (API_DELETE_TOPICS, 0, 1),
    (API_SASL_HANDSHAKE, 0, 1), (API_SASL_AUTHENTICATE, 0, 0),
)


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), bit by bit over the reflected polynomial: the
    server's own checksum, written apart from either client's table."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
    return crc ^ 0xFFFFFFFF


class Writer:
    """Big-endian request/response writer (the protocol's primitive types
    and the record format's zigzag varints)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def raw(self, b: bytes) -> "Writer":
        self._buf += b
        return self

    def i8(self, v: int) -> "Writer":
        return self.raw(struct.pack(">b", v))

    def i16(self, v: int) -> "Writer":
        return self.raw(struct.pack(">h", v))

    def i32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">i", v))

    def i64(self, v: int) -> "Writer":
        return self.raw(struct.pack(">q", v))

    def u32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">I", v))

    def string(self, s: str | None) -> "Writer":
        if s is None:
            return self.i16(-1)
        data = s.encode("utf-8")
        return self.i16(len(data)).raw(data)

    def bytes_(self, b: bytes | None) -> "Writer":
        if b is None:
            return self.i32(-1)
        return self.i32(len(b)).raw(b)

    def array(self, items, write_item) -> "Writer":
        self.i32(len(items))
        for item in items:
            write_item(self, item)
        return self

    def varint(self, v: int) -> "Writer":
        z = (v << 1) if v >= 0 else ((-v) << 1) - 1
        while True:
            if z < 0x80:
                return self.raw(bytes([z]))
            self.raw(bytes([(z & 0x7F) | 0x80]))
            z >>= 7

    def done(self) -> bytes:
        return bytes(self._buf)


class Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def raw(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"truncated frame: want {n} at {self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str, n: int) -> int:
        return struct.unpack(fmt, self.raw(n))[0]

    def i8(self) -> int:
        return self._unpack(">b", 1)

    def i16(self) -> int:
        return self._unpack(">h", 2)

    def i32(self) -> int:
        return self._unpack(">i", 4)

    def i64(self) -> int:
        return self._unpack(">q", 8)

    def string(self) -> str | None:
        n = self.i16()
        return None if n < 0 else self.raw(n).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self.raw(n)

    def array(self, read_item) -> list:
        return [read_item(self) for _ in range(max(self.i32(), 0))]

    def varint(self) -> int:
        z, shift = 0, 0
        while True:
            b = self.raw(1)[0]
            z |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                break
        return (z >> 1) if not z & 1 else -((z + 1) >> 1)

    def remaining(self) -> int:
        return len(self.data) - self.pos


class _ScramServerState:
    """Independent server side of SCRAM-SHA-256/-512 (own derivation — a
    client bug shows up as a proof-verification failure here, not a
    self-consistent round trip)."""

    def __init__(self, mechanism: str, username: str, password: str):
        self.hash = {
            "SCRAM-SHA-256": hashlib.sha256,
            "SCRAM-SHA-512": hashlib.sha512,
        }[mechanism]
        self.username = username
        self.password = password
        self.stage = "first"
        self.salt = secrets.token_bytes(16)
        self.iterations = 4096
        self.client_first_bare = ""
        self.server_first = ""

    def handle_first(self, token: bytes) -> bytes:
        text = token.decode("utf-8")
        assert text.startswith("n,,"), f"unexpected GS2 header in {text!r}"
        self.client_first_bare = text[3:]
        fields = dict(p.split("=", 1) for p in self.client_first_bare.split(","))
        user = fields["n"].replace("=2C", ",").replace("=3D", "=")
        if user != self.username:
            raise PermissionError(f"unknown user {user!r}")
        server_nonce = fields["r"] + secrets.token_urlsafe(18)
        self.server_first = (
            f"r={server_nonce},"
            f"s={base64.b64encode(self.salt).decode()},i={self.iterations}"
        )
        self.stage = "final"
        return self.server_first.encode("utf-8")

    def handle_final(self, token: bytes) -> bytes:
        text = token.decode("utf-8")
        without_proof, _, proof_b64 = text.rpartition(",p=")
        fields = dict(p.split("=", 1) for p in without_proof.split(","))
        server_nonce = dict(
            p.split("=", 1) for p in self.server_first.split(",")
        )["r"]
        if fields.get("r") != server_nonce:
            raise PermissionError("nonce mismatch")
        salted = hashlib.pbkdf2_hmac(
            self.hash().name, self.password.encode(), self.salt,
            self.iterations,
        )
        client_key = hmac.new(salted, b"Client Key", self.hash).digest()
        stored_key = self.hash(client_key).digest()
        auth_message = ",".join(
            [self.client_first_bare, self.server_first, without_proof]
        ).encode("utf-8")
        signature = hmac.new(stored_key, auth_message, self.hash).digest()
        recovered = bytes(
            a ^ b for a, b in zip(base64.b64decode(proof_b64), signature)
        )
        if self.hash(recovered).digest() != stored_key:
            raise PermissionError("SCRAM proof invalid (bad password)")
        server_key = hmac.new(salted, b"Server Key", self.hash).digest()
        server_sig = hmac.new(server_key, auth_message, self.hash).digest()
        self.stage = "done"
        return b"v=" + base64.b64encode(server_sig)


@dataclass
class _StoredRecord:
    offset: int
    timestamp: int
    key: bytes | None
    value: bytes | None
    headers: list[tuple[str, bytes | None]]


@dataclass
class _Partition:
    records: list[_StoredRecord] = field(default_factory=list)

    @property
    def log_end(self) -> int:
        return self.records[-1].offset + 1 if self.records else 0


@dataclass
class _Group:
    """Group-coordinator state machine: Empty → Joining ⇄ AwaitingSync →
    Stable, mirroring the real coordinator's generations. A join round
    completes when every member expected to rejoin has, or when
    ``join_window`` elapses after the first joiner (dropping laggards —
    the session-expiry analogue a test can rely on)."""

    generation: int = 0
    state: str = "Empty"
    protocol: str = ""
    leader: str = ""
    members: dict[str, bytes] = field(default_factory=dict)
    assignments: dict[str, bytes] = field(default_factory=dict)
    joiners: dict[str, bytes] = field(default_factory=dict)
    expected: set[str] = field(default_factory=set)
    join_event: asyncio.Event = field(default_factory=asyncio.Event)
    sync_event: asyncio.Event = field(default_factory=asyncio.Event)
    member_seq: int = 0
    round_id: int = 0


class FakeKafkaBroker:
    def __init__(self, join_window: float = 1.0,
                 sasl: dict[str, tuple[str, str]] | None = None,
                 ssl_context=None) -> None:
        """``sasl``: mechanism -> (username, password); when set, every
        connection must SaslHandshake+SaslAuthenticate before any other
        API (pre-auth requests close the connection, like a real broker).
        ``ssl_context``: server-side ``ssl.SSLContext`` for TLS listeners.
        """
        self.topics: dict[str, dict[int, _Partition]] = {}
        self.offsets: dict[tuple[str, str, int], int] = {}
        self.groups: dict[str, _Group] = {}
        self.join_window = join_window
        self.sasl = sasl
        self.ssl_context = ssl_context
        self.requests: list[tuple[int, int]] = []  # (api_key, version) seen
        #: each connection's (api_key, version) requests, in order
        self.connections: list[list[tuple[int, int]]] = []
        self._open: dict[asyncio.StreamWriter, list[tuple[int, int]]] = {}
        self.auth_failures = 0
        self._data_event: asyncio.Event | None = None  # set when a record lands
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self.host = "127.0.0.1"
        self.port = 0

    @property
    def open_connections(self) -> list[list[tuple[int, int]]]:
        """The requests of each connection still open, in order."""
        return list(self._open.values())

    # -- lifecycle (runs its own loop thread so tests can drive a client
    #    loop independently) ----------------------------------------------

    def start(self) -> "FakeKafkaBroker":
        started = threading.Event()

        def _run() -> None:
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def _serve():
                self._data_event = asyncio.Event()
                self._server = await asyncio.start_server(
                    self._client, self.host, self.port, ssl=self.ssl_context
                )
                self.port = self._server.sockets[0].getsockname()[1]
                started.set()

            self._loop.run_until_complete(_serve())
            self._loop.run_forever()

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        started.wait(10)
        return self

    def stop(self) -> None:
        if self._loop is not None:
            loop = self._loop

            async def _close() -> None:
                self._server.close()
                for writer in list(self._open):
                    writer.close()
                await self._server.wait_closed()

            try:
                asyncio.run_coroutine_threadsafe(_close(), loop).result(5)
            except Exception:  # noqa: BLE001 - stopping regardless
                pass
            loop.call_soon_threadsafe(loop.stop)
            self._thread.join(5)
            self._loop = None

    def __enter__(self) -> "FakeKafkaBroker":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- independent server-side record-batch codec ------------------------

    @staticmethod
    def _parse_batches(data: bytes) -> list[tuple[int, bytes | None, bytes | None, list]]:
        """Own parser: header field by field, CRC verified over the raw
        bytes following the crc field."""
        out = []
        pos = 0
        while pos + 61 <= len(data):
            (base_offset,) = struct.unpack_from(">q", data, pos)
            (batch_len,) = struct.unpack_from(">i", data, pos + 8)
            body = data[pos + 12 : pos + 12 + batch_len]
            pos += 12 + batch_len
            magic = body[4]
            assert magic == 2, f"client must send magic 2, got {magic}"
            (crc,) = struct.unpack_from(">I", body, 5)
            assert crc32c(body[9:]) == crc, "client batch CRC invalid"
            r = Reader(body, 9)
            attributes = r.i16()
            codec = attributes & 0x07
            assert codec in (0, 1), f"server only speaks gzip, got codec {codec}"
            r.i32()                       # lastOffsetDelta
            base_ts = r.i64()
            r.i64(); r.i64(); r.i16(); r.i32()
            count = r.i32()
            if codec == 1:
                # independent decompression: stdlib gzip (the client uses
                # zlib.compressobj — a framing bug would fail here)
                import gzip as _gzip

                r = Reader(_gzip.decompress(r.raw(r.remaining())))
            for _ in range(count):
                length = r.varint()
                rec = Reader(r.raw(length))
                rec.i8()
                ts_delta = rec.varint()
                offset_delta = rec.varint()
                klen = rec.varint()
                key = rec.raw(klen) if klen >= 0 else None
                vlen = rec.varint()
                value = rec.raw(vlen) if vlen >= 0 else None
                headers = []
                for _h in range(rec.varint()):
                    hklen = rec.varint()
                    hk = rec.raw(hklen).decode()
                    hvlen = rec.varint()
                    hv = rec.raw(hvlen) if hvlen >= 0 else None
                    headers.append((hk, hv))
                out.append((base_ts + ts_delta, key, value, headers))
        return out

    @staticmethod
    def _encode_batch(records: list[_StoredRecord]) -> bytes:
        """Own encoder for fetch responses (one batch per contiguous run)."""
        if not records:
            return b""
        base = records[0].offset
        base_ts = records[0].timestamp
        body = Writer()
        for rec in records:
            r = Writer()
            r.i8(0)
            r.varint(rec.timestamp - base_ts)
            r.varint(rec.offset - base)
            r.varint(-1 if rec.key is None else len(rec.key))
            if rec.key is not None:
                r.raw(rec.key)
            r.varint(-1 if rec.value is None else len(rec.value))
            if rec.value is not None:
                r.raw(rec.value)
            r.varint(len(rec.headers))
            for hk, hv in rec.headers:
                hkb = hk.encode()
                r.varint(len(hkb))
                r.raw(hkb)
                r.varint(-1 if hv is None else len(hv))
                if hv is not None:
                    r.raw(hv)
            encoded = r.done()
            body.varint(len(encoded)).raw(encoded)
        crc_part = (
            Writer()
            .i16(0)
            .i32(records[-1].offset - base)
            .i64(base_ts)
            .i64(records[-1].timestamp)
            .i64(-1).i16(-1).i32(-1)
            .i32(len(records))
            .raw(body.done())
            .done()
        )
        return (
            Writer()
            .i64(base)
            .i32(4 + 1 + 4 + len(crc_part))
            .i32(-1)
            .i8(2)
            .u32(crc32c(crc_part))
            .raw(crc_part)
            .done()
        )

    # -- group coordinator -------------------------------------------------

    @staticmethod
    def _begin_round(g: _Group, expected: set[str]) -> None:
        g.state = "Joining"
        g.round_id += 1
        g.expected = set(expected)
        g.joiners = {}
        g.join_event = asyncio.Event()
        g.sync_event = asyncio.Event()

    @staticmethod
    def _complete_join(g: _Group) -> None:
        g.generation += 1
        g.members = dict(g.joiners)
        g.leader = sorted(g.members)[0]
        g.state = "AwaitingSync"
        g.assignments = {}
        g.join_event.set()

    async def _join_group(
        self, group: str, member_id: str, protocols: list[tuple[str, bytes]]
    ) -> bytes:
        g = self.groups.setdefault(group, _Group())
        if member_id == "":
            g.member_seq += 1
            member_id = f"member-{g.member_seq}"
        if g.state != "Joining":
            self._begin_round(g, set(g.members) | {member_id})
        else:
            g.expected.add(member_id)
        g.protocol = protocols[0][0] if protocols else "range"
        g.joiners[member_id] = protocols[0][1] if protocols else b""
        if g.expected <= set(g.joiners):
            self._complete_join(g)
        else:
            # wait for the stragglers; on window expiry whoever is present
            # forms the generation (the session-expiry analogue). The round
            # id pins the timeout to THIS round — a stale waiter must never
            # cut a newer round short before its members assembled.
            round_id = g.round_id
            event = g.join_event
            try:
                await asyncio.wait_for(event.wait(), self.join_window)
            except asyncio.TimeoutError:
                if g.state == "Joining" and g.round_id == round_id:
                    self._complete_join(g)
        w = (
            Writer().i32(0).i16(ERR_NONE).i32(g.generation)
            .string(g.protocol).string(g.leader).string(member_id)
        )
        if member_id == g.leader:
            w.array(
                sorted(g.members.items()),
                lambda wr, p: (wr.string(p[0]), wr.bytes_(p[1])),
            )
        else:
            w.i32(0)
        return w.done()

    async def _sync_group(
        self, group: str, generation: int, member_id: str,
        assignments: dict[str, bytes],
    ) -> bytes:
        def _fail(err: int) -> bytes:
            return Writer().i32(0).i16(err).bytes_(b"").done()

        g = self.groups.get(group)
        if g is None or member_id not in g.members:
            return _fail(ERR_UNKNOWN_MEMBER_ID)
        if g.state == "Joining":
            return _fail(ERR_REBALANCE_IN_PROGRESS)
        if generation != g.generation:
            return _fail(ERR_ILLEGAL_GENERATION)
        if member_id == g.leader:
            g.assignments = dict(assignments)
            g.state = "Stable"
            g.sync_event.set()
        else:
            try:
                await asyncio.wait_for(
                    g.sync_event.wait(), self.join_window + 5.0
                )
            except asyncio.TimeoutError:
                return _fail(ERR_REBALANCE_IN_PROGRESS)
        # a new round may have started while this follower waited
        if g.state != "Stable" or generation != g.generation:
            return _fail(ERR_REBALANCE_IN_PROGRESS)
        return (
            Writer().i32(0).i16(ERR_NONE)
            .bytes_(g.assignments.get(member_id, b""))
            .done()
        )

    # -- fetch long-poll -----------------------------------------------------

    def _wake_fetches(self) -> None:
        event, self._data_event = self._data_event, asyncio.Event()
        event.set()

    def _fetch_ready(self, wanted) -> bool:
        """Whether any asked-for partition has a record at or past its
        fetch offset, or cannot be answered with records at all."""
        for topic, parts in wanted:
            for partition, fetch_offset in parts:
                part = self.topics.get(topic, {}).get(partition)
                if part is None or fetch_offset >= 0 and part.log_end > fetch_offset \
                        or fetch_offset > part.log_end:
                    return True
        return False

    async def _hold_fetch(self, wanted, max_wait_ms: int) -> None:
        deadline = self._loop.time() + max(max_wait_ms, 0) / 1000.0
        while not self._fetch_ready(wanted):
            remaining = deadline - self._loop.time()
            if remaining <= 0:
                return
            try:
                await asyncio.wait_for(self._data_event.wait(), remaining)
            except asyncio.TimeoutError:
                return

    # -- request handling --------------------------------------------------

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        # per-connection SASL session: mechanism chosen by handshake, then
        # token exchange, then (and only then) the normal APIs
        session = {"authenticated": self.sasl is None, "scram": None,
                   "mechanism": None}
        seen: list[tuple[int, int]] = []
        self.connections.append(seen)
        self._open[writer] = seen
        try:
            while True:
                size_raw = await reader.readexactly(4)
                (size,) = struct.unpack(">i", size_raw)
                frame = await reader.readexactly(size)
                r = Reader(frame)
                api_key = r.i16()
                version = r.i16()
                correlation = r.i32()
                r.string()  # client id
                self.requests.append((api_key, version))
                seen.append((api_key, version))
                if api_key in (API_SASL_HANDSHAKE, API_SASL_AUTHENTICATE):
                    payload = self._dispatch_sasl(api_key, r, session)
                elif not session["authenticated"]:
                    # real brokers drop unauthenticated connections that
                    # send normal APIs — the client sees a reset
                    self.auth_failures += 1
                    return
                else:
                    payload = await self._dispatch(api_key, version, r)
                body = Writer().i32(correlation).raw(payload).done()
                writer.write(struct.pack(">i", len(body)) + body)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._open.pop(writer, None)
            writer.close()

    def _dispatch_sasl(self, api_key: int, r: Reader, session: dict) -> bytes:
        if api_key == API_SASL_HANDSHAKE:
            mechanism = r.string()
            if self.sasl is None or mechanism not in self.sasl:
                supported = sorted(self.sasl or {})
                w = Writer().i16(ERR_UNSUPPORTED_SASL_MECHANISM)
                w.array(supported, lambda wr, m: wr.string(m))
                return w.done()
            session["mechanism"] = mechanism
            if mechanism.startswith("SCRAM"):
                user, pw = self.sasl[mechanism]
                session["scram"] = _ScramServerState(mechanism, user, pw)
            return (
                Writer().i16(ERR_NONE)
                .array([mechanism], lambda wr, m: wr.string(m)).done()
            )
        # SaslAuthenticate v0: auth_bytes in, (error, message, bytes) out
        token = r.bytes_() or b""

        def _fail(msg: str) -> bytes:
            self.auth_failures += 1
            return (
                Writer().i16(ERR_SASL_AUTHENTICATION_FAILED)
                .string(msg).bytes_(b"").done()
            )

        mechanism = session.get("mechanism")
        if mechanism is None:
            return _fail("SaslAuthenticate before SaslHandshake")
        if mechanism == "PLAIN":
            parts = token.split(b"\x00")
            user, pw = self.sasl["PLAIN"]
            if len(parts) != 3 or parts[1].decode() != user \
                    or parts[2].decode() != pw:
                return _fail("invalid PLAIN credentials")
            session["authenticated"] = True
            return Writer().i16(ERR_NONE).string(None).bytes_(b"").done()
        scram: _ScramServerState = session["scram"]
        try:
            if scram.stage == "first":
                out = scram.handle_first(token)
            else:
                out = scram.handle_final(token)
                session["authenticated"] = True
            return Writer().i16(ERR_NONE).string(None).bytes_(out).done()
        except (PermissionError, KeyError, ValueError, AssertionError) as e:
            return _fail(str(e))

    async def _dispatch(self, api_key: int, version: int, r: Reader) -> bytes:
        if api_key == API_API_VERSIONS:
            w = Writer().i16(ERR_NONE)
            keys = SUPPORTED_APIS
            w.i32(len(keys))
            for k, lo, hi in keys:
                w.i16(k).i16(lo).i16(hi)
            return w.done()

        if api_key == API_METADATA:
            assert version == 1
            n = r.i32()
            wanted = [r.string() for _ in range(n)] if n >= 0 else None
            w = Writer()
            w.i32(1).i32(0).string(self.host).i32(self.port).string(None)
            w.i32(0)  # controller id
            names = sorted(self.topics) if wanted is None else wanted
            w.i32(len(names))
            for name in names:
                parts = self.topics.get(name)
                w.i16(ERR_NONE if parts is not None
                      else ERR_UNKNOWN_TOPIC_OR_PARTITION)
                w.string(name)
                w.raw(b"\x00")  # is_internal
                if parts is None:
                    w.i32(0)
                    continue
                w.i32(len(parts))
                for pid in sorted(parts):
                    w.i16(ERR_NONE).i32(pid).i32(0)
                    w.i32(1).i32(0)   # replicas [0]
                    w.i32(1).i32(0)   # isr [0]
            return w.done()

        if api_key == API_PRODUCE:
            assert version == 3
            r.string()               # transactional id
            r.i16()                  # acks
            r.i32()                  # timeout
            w_topics = Writer()
            topic_count = r.i32()
            w_topics.i32(topic_count)
            for _ in range(topic_count):
                topic = r.string()
                w_topics.string(topic)
                part_count = r.i32()
                w_topics.i32(part_count)
                for _p in range(part_count):
                    partition = r.i32()
                    record_set = r.bytes_() or b""
                    part = self.topics.get(topic, {}).get(partition)
                    if part is None:
                        w_topics.i32(partition).i16(
                            ERR_UNKNOWN_TOPIC_OR_PARTITION
                        ).i64(-1).i64(-1)
                        continue
                    base = part.log_end
                    for i, (ts, key, value, headers) in enumerate(
                        self._parse_batches(record_set)
                    ):
                        part.records.append(_StoredRecord(
                            offset=base + i, timestamp=ts, key=key,
                            value=value, headers=headers,
                        ))
                    w_topics.i32(partition).i16(ERR_NONE).i64(base).i64(-1)
            self._wake_fetches()
            return w_topics.done()

        if api_key == API_FETCH:
            assert version == 4
            r.i32()                  # replica id
            max_wait_ms = r.i32()
            r.i32(); r.i32(); r.i8()  # min bytes, max bytes, isolation
            wanted = []
            for _ in range(r.i32()):
                topic = r.string()
                parts = []
                for _p in range(r.i32()):
                    partition = r.i32()
                    fetch_offset = r.i64()
                    r.i32()          # partition max bytes
                    parts.append((partition, fetch_offset))
                wanted.append((topic, parts))
            await self._hold_fetch(wanted, max_wait_ms)
            w = Writer().i32(0)      # throttle
            w.i32(len(wanted))
            for topic, parts in wanted:
                w.string(topic)
                w.i32(len(parts))
                for partition, fetch_offset in parts:
                    part = self.topics.get(topic, {}).get(partition)
                    if part is None:
                        w.i32(partition).i16(ERR_UNKNOWN_TOPIC_OR_PARTITION)
                        w.i64(-1).i64(-1).i32(0).bytes_(b"")
                        continue
                    if fetch_offset > part.log_end:
                        w.i32(partition).i16(ERR_OFFSET_OUT_OF_RANGE)
                        w.i64(part.log_end).i64(part.log_end).i32(0).bytes_(b"")
                        continue
                    pending = [
                        rec for rec in part.records if rec.offset >= fetch_offset
                    ]
                    w.i32(partition).i16(ERR_NONE)
                    w.i64(part.log_end).i64(part.log_end)
                    w.i32(0)         # aborted transactions
                    w.bytes_(self._encode_batch(pending))
            return w.done()

        if api_key == API_LIST_OFFSETS:
            assert version == 1
            r.i32()
            topic_count = r.i32()
            w = Writer().i32(topic_count)
            for _ in range(topic_count):
                topic = r.string()
                w.string(topic)
                part_count = r.i32()
                w.i32(part_count)
                for _p in range(part_count):
                    partition = r.i32()
                    ts = r.i64()
                    part = self.topics.get(topic, {}).get(partition)
                    if part is None:
                        w.i32(partition).i16(ERR_UNKNOWN_TOPIC_OR_PARTITION)
                        w.i64(-1).i64(-1)
                        continue
                    first = part.records[0].offset if part.records else 0
                    offset = first if ts == -2 else part.log_end
                    w.i32(partition).i16(ERR_NONE).i64(-1).i64(offset)
            return w.done()

        if api_key == API_FIND_COORDINATOR:
            assert version == 1
            r.string()               # group
            r.i8()                   # type
            return (
                Writer().i32(0).i16(ERR_NONE).string(None)
                .i32(0).string(self.host).i32(self.port).done()
            )

        if api_key == API_OFFSET_COMMIT:
            assert version == 2
            group = r.string()
            generation = r.i32()
            member = r.string()
            r.i64()                  # retention
            # simple-consumer commits (generation -1, empty member) are
            # always accepted; dynamic-member commits are FENCED against
            # the coordinator's generation so a zombie that missed a
            # rebalance cannot clobber the new owner's progress
            group_err = ERR_NONE
            if generation != -1 or member != "":
                g = self.groups.get(group)
                if g is None or member not in g.members:
                    group_err = ERR_UNKNOWN_MEMBER_ID
                elif generation != g.generation:
                    group_err = ERR_ILLEGAL_GENERATION
            topic_count = r.i32()
            w = Writer().i32(topic_count)
            for _ in range(topic_count):
                topic = r.string()
                w.string(topic)
                part_count = r.i32()
                w.i32(part_count)
                for _p in range(part_count):
                    partition = r.i32()
                    offset = r.i64()
                    r.string()       # metadata
                    if group_err == ERR_NONE:
                        self.offsets[(group, topic, partition)] = offset
                    w.i32(partition).i16(group_err)
            return w.done()

        if api_key == API_JOIN_GROUP:
            assert version == 2
            group = r.string()
            r.i32()                  # session timeout
            r.i32()                  # rebalance timeout
            member_id = r.string()
            r.string()               # protocol type ("consumer")
            protocols = []
            for _ in range(r.i32()):
                protocols.append((r.string(), r.bytes_() or b""))
            return await self._join_group(group, member_id, protocols)

        if api_key == API_SYNC_GROUP:
            assert version == 1
            group = r.string()
            generation = r.i32()
            member_id = r.string()
            assignments = {}
            for _ in range(r.i32()):
                mid = r.string()
                assignments[mid] = r.bytes_() or b""
            return await self._sync_group(group, generation, member_id, assignments)

        if api_key == API_HEARTBEAT:
            assert version == 1
            group = r.string()
            generation = r.i32()
            member_id = r.string()
            g = self.groups.get(group)
            if g is None or member_id not in (set(g.members) | set(g.joiners)):
                err = ERR_UNKNOWN_MEMBER_ID
            elif g.state == "Joining":
                err = ERR_REBALANCE_IN_PROGRESS
            elif generation != g.generation:
                err = ERR_ILLEGAL_GENERATION
            else:
                err = ERR_NONE
            return Writer().i32(0).i16(err).done()

        if api_key == API_LEAVE_GROUP:
            assert version == 1
            group = r.string()
            member_id = r.string()
            g = self.groups.get(group)
            if g is None or member_id not in (set(g.members) | set(g.joiners)):
                return Writer().i32(0).i16(ERR_UNKNOWN_MEMBER_ID).done()
            g.members.pop(member_id, None)
            g.joiners.pop(member_id, None)
            g.expected.discard(member_id)
            if not g.members and not g.joiners:
                g.state = "Empty"
                g.leader = ""
                g.join_event.set()
                g.sync_event.set()
            elif g.state == "Joining":
                if g.expected and g.expected <= set(g.joiners):
                    self._complete_join(g)
            else:
                # survivors discover the rebalance via heartbeat errors
                self._begin_round(g, set(g.members))
            return Writer().i32(0).i16(ERR_NONE).done()

        if api_key == API_OFFSET_FETCH:
            assert version == 1
            group = r.string()
            topic_count = r.i32()
            w = Writer().i32(topic_count)
            for _ in range(topic_count):
                topic = r.string()
                w.string(topic)
                part_count = r.i32()
                w.i32(part_count)
                for _p in range(part_count):
                    partition = r.i32()
                    offset = self.offsets.get((group, topic, partition), -1)
                    w.i32(partition).i64(offset).string(None).i16(ERR_NONE)
            return w.done()

        if api_key == API_CREATE_TOPICS:
            assert version == 1
            topic_count = r.i32()
            results = []
            for _ in range(topic_count):
                topic = r.string()
                partitions = r.i32()
                r.i16()              # replication
                for _a in range(r.i32()):
                    r.i32()
                    r.array(lambda rr: rr.i32())
                for _c in range(r.i32()):
                    r.string(); r.string()
                if topic in self.topics:
                    results.append((topic, ERR_TOPIC_ALREADY_EXISTS))
                else:
                    self.topics[topic] = {
                        p: _Partition() for p in range(max(partitions, 1))
                    }
                    results.append((topic, ERR_NONE))
            r.i32()                  # timeout
            r.i8()                   # validate_only
            w = Writer().i32(len(results))
            for topic, err in results:
                w.string(topic).i16(err).string(None)
            return w.done()

        if api_key == API_DELETE_TOPICS:
            assert version == 1
            names = r.array(lambda rr: rr.string())
            r.i32()                  # timeout
            w = Writer().i32(0).i32(len(names))
            for name in names:
                err = ERR_NONE if self.topics.pop(name, None) is not None \
                    else ERR_UNKNOWN_TOPIC_OR_PARTITION
                w.string(name).i16(err)
            return w.done()

        raise AssertionError(f"unsupported api key {api_key} v{version}")


def main(argv=None) -> int:
    import argparse
    import time

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--scram", nargs=2, metavar=("USER", "PASSWORD"),
                        help="require SASL SCRAM-SHA-256 with these credentials")
    args = parser.parse_args(argv)
    sasl = {"SCRAM-SHA-256": tuple(args.scram)} if args.scram else None
    broker = FakeKafkaBroker(sasl=sasl)
    if args.port:
        broker.port = args.port
    broker.start()
    print(f"fake kafka broker at {broker.host}:{broker.port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        broker.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
