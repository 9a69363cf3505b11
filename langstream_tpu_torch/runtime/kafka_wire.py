"""Kafka wire protocol, SDK-free — the broker-facing half of the Kafka
runtime without ``confluent_kafka``.

Precedent: the JAX package's hand-rolled S3 sigv4 (``agents/s3_impl.py``) and CQL
v4 (``agents/cassandra_cql.py``) lanes — when the client library is the
missing piece, the wire protocol is our responsibility. Reference parity:
``langstream-kafka-runtime`` reaches real brokers through the Java client;
this module gives the Python runtime the same reach through the protocol
itself.

Scope (deliberate, documented): the NON-flexible protocol versions (no
compact/tagged fields — simple fixed structs), record batches v2 (magic 2,
CRC32C, zigzag-varint records — what every broker ≥ 0.11 speaks), and the
both consumer group modes: the "simple consumer" (OffsetCommit/OffsetFetch
with ``generation_id = -1`` + empty member id, static partition assignment
— replica i of n owns partitions ≡ i mod n, exact under StatefulSet
ordinals) and full dynamic membership (JoinGroup/SyncGroup/Heartbeat/
LeaveGroup with the leader-side range assignor and generation-fenced
commits — see :class:`~langstream_tpu_torch.runtime.kafka_wire_runtime.GroupMembership`).

Security (what the reference's cloud instances need — e.g. its Astra
example sets ``security.protocol: SASL_SSL`` + ``sasl.mechanism: PLAIN``,
``examples/instances/astra.yaml:27-29``): TLS via ``ssl.SSLContext`` on the
connection, SASL PLAIN and SCRAM-SHA-256/-512 (RFC 5802, stdlib hmac/
hashlib) over SaslHandshake(v1) + SaslAuthenticate(v0). Fetch
decompression: gzip (stdlib) and zstd (when ``zstandard`` imports; else a
named error); snappy always too — a pure-Python raw-block decoder
(:func:`_snappy_decompress_raw`) handles xerial-framed and bare blocks
when python-snappy is absent; lz4 raises a clear error naming the
missing codec library. Produce-side compression: optional gzip.

APIs: ApiVersions(0) Metadata(1) Produce(3) Fetch(4) ListOffsets(1)
FindCoordinator(1) OffsetCommit(2) OffsetFetch(1) JoinGroup(2)
Heartbeat(1) LeaveGroup(1) SyncGroup(1) SaslHandshake(1) ApiVersions(0)
CreateTopics(1) DeleteTopics(1) SaslAuthenticate(0) (:data:`API_VERSIONS_SPOKEN`).

The port's copy of ``langstream_tpu/runtime/kafka_wire.py``; it imports
only the standard library, and ``zstandard``, ``snappy`` and ``lz4`` only
when a batch in their codec arrives.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import logging
import re
import secrets
import ssl as ssl_module
import struct
import zlib
from dataclasses import dataclass, field
from typing import Any

logger = logging.getLogger(__name__)

# api keys
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

# error codes (subset)
ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3
ERR_NOT_LEADER = 6
ERR_COORDINATOR_NOT_AVAILABLE = 15
ERR_NOT_COORDINATOR = 16
ERR_ILLEGAL_GENERATION = 22
ERR_UNKNOWN_MEMBER_ID = 25
ERR_REBALANCE_IN_PROGRESS = 27
ERR_UNSUPPORTED_SASL_MECHANISM = 33
ERR_ILLEGAL_SASL_STATE = 34
ERR_TOPIC_ALREADY_EXISTS = 36
ERR_SASL_AUTHENTICATION_FAILED = 58

#: the one version of each API that this client sends
API_VERSIONS_SPOKEN = {
    API_PRODUCE: 3,
    API_FETCH: 4,
    API_LIST_OFFSETS: 1,
    API_METADATA: 1,
    API_OFFSET_COMMIT: 2,
    API_OFFSET_FETCH: 1,
    API_FIND_COORDINATOR: 1,
    API_JOIN_GROUP: 2,
    API_HEARTBEAT: 1,
    API_LEAVE_GROUP: 1,
    API_SYNC_GROUP: 1,
    API_SASL_HANDSHAKE: 1,
    API_API_VERSIONS: 0,
    API_CREATE_TOPICS: 1,
    API_DELETE_TOPICS: 1,
    API_SASL_AUTHENTICATE: 0,
}

ERROR_NAMES = {
    ERR_OFFSET_OUT_OF_RANGE: "OFFSET_OUT_OF_RANGE",
    ERR_UNKNOWN_TOPIC_OR_PARTITION: "UNKNOWN_TOPIC_OR_PARTITION",
    ERR_NOT_LEADER: "NOT_LEADER_FOR_PARTITION",
    ERR_COORDINATOR_NOT_AVAILABLE: "COORDINATOR_NOT_AVAILABLE",
    ERR_NOT_COORDINATOR: "NOT_COORDINATOR",
    ERR_ILLEGAL_GENERATION: "ILLEGAL_GENERATION",
    ERR_UNKNOWN_MEMBER_ID: "UNKNOWN_MEMBER_ID",
    ERR_REBALANCE_IN_PROGRESS: "REBALANCE_IN_PROGRESS",
    ERR_TOPIC_ALREADY_EXISTS: "TOPIC_ALREADY_EXISTS",
}


class KafkaProtocolError(RuntimeError):
    def __init__(self, code: int, context: str):
        name = ERROR_NAMES.get(code, f"error {code}")
        super().__init__(f"kafka {name} ({code}): {context}")
        self.code = code


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — record batches checksum with this, not CRC32
# ---------------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78
_CRC32C_TABLE: list[int] = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc = ~crc & 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return ~crc & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


class Writer:
    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(b)
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
        b = s.encode("utf-8")
        return self.i16(len(b)).raw(b)

    def bytes_(self, b: bytes | None) -> "Writer":
        if b is None:
            return self.i32(-1)
        return self.i32(len(b)).raw(b)

    def array(self, items: list, write_item) -> "Writer":
        self.i32(len(items))
        for item in items:
            write_item(self, item)
        return self

    def varint(self, v: int) -> "Writer":
        # zigzag (python's arbitrary-precision >> keeps the sign, so the
        # classic (v << 1) ^ (v >> 63) works for any 64-bit value)
        z = ((v << 1) ^ (v >> 63)) & 0xFFFFFFFFFFFFFFFF
        while (z & ~0x7F) != 0:
            self.raw(bytes([(z & 0x7F) | 0x80]))
            z >>= 7
        return self.raw(bytes([z]))

    def done(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise EOFError(f"truncated kafka frame (want {n})")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self.raw(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.raw(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.raw(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.raw(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.raw(4))[0]

    def string(self) -> str | None:
        n = self.i16()
        return None if n < 0 else self.raw(n).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self.raw(n)

    def array(self, read_item) -> list:
        n = self.i32()
        return [read_item(self) for _ in range(max(n, 0))]

    def varint(self) -> int:
        shift = 0
        z = 0
        while True:
            b = self.raw(1)[0]
            z |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        # un-zigzag
        return (z >> 1) ^ -(z & 1)

    def remaining(self) -> int:
        return len(self.data) - self.pos


# ---------------------------------------------------------------------------
# record batch v2 (magic 2)
# ---------------------------------------------------------------------------


@dataclass
class WireRecord:
    offset: int
    timestamp: int
    key: bytes | None
    value: bytes | None
    headers: list[tuple[str, bytes | None]] = field(default_factory=list)


def encode_record_batch(
    records: list[tuple[bytes | None, bytes | None, list[tuple[str, bytes | None]]]],
    base_timestamp: int,
    compression: str | None = None,
) -> bytes:
    """``records``: (key, value, headers) triples → one batch with base
    offset 0 (the broker rewrites offsets on append).

    ``compression``: None or ``"gzip"`` (the codec every broker and every
    client decompresses; producers wanting snappy/lz4/zstd on the wire
    should use the SDK lane)."""
    if compression not in (None, "gzip"):
        raise ValueError(
            f"produce compression {compression!r} not supported (gzip only)"
        )
    body = Writer()
    for i, (key, value, headers) in enumerate(records):
        rec = Writer()
        rec.raw(b"\x00")                      # attributes
        rec.varint(0)                         # timestampDelta
        rec.varint(i)                         # offsetDelta
        rec.varint(-1 if key is None else len(key))
        if key is not None:
            rec.raw(key)
        rec.varint(-1 if value is None else len(value))
        if value is not None:
            rec.raw(value)
        rec.varint(len(headers))
        for hk, hv in headers:
            hkb = hk.encode("utf-8")
            rec.varint(len(hkb))
            rec.raw(hkb)
            rec.varint(-1 if hv is None else len(hv))
            if hv is not None:
                rec.raw(hv)
        encoded = rec.done()
        body.varint(len(encoded)).raw(encoded)

    records_part = body.done()
    attributes = 0
    if compression == "gzip":
        attributes = 1
        records_part = _gzip_compress(records_part)
    # the part the CRC covers: attributes .. records
    crc_part = (
        Writer()
        .i16(attributes)                      # compression codec in bits 0-2
        .i32(len(records) - 1)                # lastOffsetDelta
        .i64(base_timestamp)                  # baseTimestamp
        .i64(base_timestamp)                  # maxTimestamp
        .i64(-1).i16(-1).i32(-1)              # producer id/epoch/baseSequence
        .i32(len(records))
        .raw(records_part)
        .done()
    )
    head = (
        Writer()
        .i64(0)                               # baseOffset (broker-assigned)
        .i32(4 + 1 + 4 + len(crc_part))       # batchLength from pLE onward
        .i32(-1)                              # partitionLeaderEpoch
        .i8(2)                                # magic
        .u32(crc32c(crc_part))
        .raw(crc_part)
    )
    return head.done()


def _gzip_compress(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
    return co.compress(data) + co.flush()


_CODEC_NAMES = {1: "gzip", 2: "snappy", 3: "lz4", 4: "zstd"}

#: xerial block-stream magic java snappy producers prepend
XERIAL_MAGIC = b"\x82SNAPPY\x00"


def _snappy_decompress_raw(data: bytes) -> bytes:
    """One raw snappy block, pure Python: a varint32 preamble with the
    uncompressed length, then tagged literal/copy elements (the format's
    only two element kinds). Fetch-path only — slow next to the C codec,
    but a consumer must read whatever an upstream java producer wrote,
    and python-snappy may be absent."""
    total = 0
    shift = 0
    i = 0
    while True:
        if i >= len(data):
            raise KafkaProtocolError(-1, "truncated snappy preamble")
        byte = data[i]
        i += 1
        total |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    out = bytearray()
    while i < len(data):
        tag = data[i]
        i += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:  # 60..63: length-1 in the next 1..4 LE bytes
                extra = length - 59
                length = int.from_bytes(data[i : i + extra], "little")
                i += extra
            length += 1
            if i + length > len(data):
                raise KafkaProtocolError(-1, "truncated snappy literal")
            out += data[i : i + length]
            i += length
            continue
        extra = 1 if kind == 1 else 2 if kind == 2 else 4
        if i + extra > len(data):
            raise KafkaProtocolError(-1, "truncated snappy copy")
        if kind == 1:  # copy, 1-byte offset: len 4..11, offset 11 bits
            length = ((tag >> 2) & 0x07) + 4
            offset = ((tag >> 5) << 8) | data[i]
        elif kind == 2:  # copy, 2-byte LE offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[i : i + 2], "little")
        else:  # copy, 4-byte LE offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[i : i + 4], "little")
        i += extra
        if offset == 0 or offset > len(out):
            raise KafkaProtocolError(-1, "corrupt snappy copy offset")
        start = len(out) - offset
        if offset >= length:
            out += out[start : start + length]
        else:  # overlapping copy = run-length repeat, byte at a time
            for j in range(length):
                out.append(out[start + j])
    if len(out) != total:
        raise KafkaProtocolError(
            -1, f"snappy length mismatch: got {len(out)}, preamble {total}"
        )
    return bytes(out)


_SNAPPY_BLOCK: list = []  # the block decoder, resolved at the first snappy batch


def _snappy_block():
    """python-snappy's block decoder when it imports, else the pure-Python
    one. Resolved once, at the first snappy batch (a failed import is not
    cached by Python, and re-attempting it per fetch batch costs a
    ``sys.path`` scan in the consumer hot path), never at module import."""
    if not _SNAPPY_BLOCK:
        try:
            import snappy as _python_snappy

            _SNAPPY_BLOCK.append(_python_snappy.decompress)
        except ImportError:
            _SNAPPY_BLOCK.append(_snappy_decompress_raw)
    return _SNAPPY_BLOCK[0]


def _snappy_decompress(data: bytes) -> bytes:
    """Snappy as Kafka ships it: java producers wrap raw blocks in xerial
    stream framing (magic + two version ints, then length-prefixed
    blocks); plain raw blocks also occur. python-snappy accelerates the
    per-block decode when present; the pure-Python decoder is the
    always-available fallback."""
    block = _snappy_block()
    if data[:8] == XERIAL_MAGIC:
        r = Reader(data, 16)  # skip magic + version + compat
        chunks = []
        while r.remaining() > 0:
            chunks.append(block(r.raw(r.i32())))
        return b"".join(chunks)
    return block(data)


def decompress_records(codec: int, data: bytes) -> bytes:
    """Decompress a batch's records section. gzip rides stdlib zlib; zstd
    the ``zstandard`` package (a named error without it); snappy the
    pure-Python raw-block decoder (python-snappy accelerates when
    installed); lz4 needs a library absent here — the error names the
    codec and the library so the operator knows exactly what the
    producer must change (or install)."""
    if codec == 1:  # gzip
        return zlib.decompress(data, 16 + zlib.MAX_WBITS)
    if codec == 4:  # zstd
        try:
            import zstandard
        except ImportError:
            raise KafkaProtocolError(
                -1, "zstd-compressed batch but the 'zstandard' package is "
                    "not installed"
            ) from None
        # streaming decompress: real producers (zstd-jni's output stream)
        # emit frames WITHOUT the content-size header field, which the
        # one-shot decompress() refuses
        return zstandard.ZstdDecompressor().decompressobj().decompress(data)
    if codec == 2:  # snappy (xerial framing or bare raw blocks)
        return _snappy_decompress(data)
    if codec == 3:  # lz4 (frame format)
        try:
            import lz4.frame
        except ImportError:
            raise KafkaProtocolError(
                -1,
                "lz4-compressed batch but the 'lz4' package is not "
                "installed; reconfigure the producing side "
                "to gzip/zstd/snappy/none or install lz4",
            ) from None
        return lz4.frame.decompress(data)
    raise KafkaProtocolError(-1, f"unknown compression codec {codec}")


def decode_record_batches(data: bytes) -> list[WireRecord]:
    """Decode a record set (possibly several batches back to back);
    validates each batch's CRC32C. Compressed batches (gzip/zstd here;
    snappy/lz4 with the libraries installed) are decompressed before
    record parsing — see :func:`decompress_records`."""
    out: list[WireRecord] = []
    r = Reader(data)
    while r.remaining() >= 61:  # batch header floor
        base_offset = r.i64()
        batch_length = r.i32()
        if r.remaining() < batch_length:
            break  # broker may truncate the final batch mid-frame
        batch = Reader(r.raw(batch_length))
        batch.i32()                           # partitionLeaderEpoch
        magic = batch.i8()
        if magic != 2:
            raise KafkaProtocolError(-1, f"unsupported magic {magic}")
        crc = batch.u32()
        crc_part = batch.data[batch.pos:]
        if crc32c(crc_part) != crc:
            raise KafkaProtocolError(-1, "record batch CRC mismatch")
        attributes = batch.i16()
        if attributes & 0x20:
            # control batch (transaction commit/abort markers from other
            # producers on a shared cluster) — never application records
            continue
        batch.i32()                           # lastOffsetDelta
        base_ts = batch.i64()
        batch.i64()                           # maxTimestamp
        batch.i64(); batch.i16(); batch.i32() # producer id/epoch/seq
        count = batch.i32()
        codec = attributes & 0x07
        if codec:
            batch = Reader(
                decompress_records(codec, batch.raw(batch.remaining()))
            )
        for _ in range(count):
            length = batch.varint()
            rec = Reader(batch.raw(length))
            rec.i8()                          # attributes
            ts_delta = rec.varint()
            offset_delta = rec.varint()
            klen = rec.varint()
            key = rec.raw(klen) if klen >= 0 else None
            vlen = rec.varint()
            value = rec.raw(vlen) if vlen >= 0 else None
            headers = []
            for _h in range(rec.varint()):
                hklen = rec.varint()
                hk = rec.raw(hklen).decode("utf-8")
                hvlen = rec.varint()
                hv = rec.raw(hvlen) if hvlen >= 0 else None
                headers.append((hk, hv))
            out.append(WireRecord(
                offset=base_offset + offset_delta,
                timestamp=base_ts + ts_delta,
                key=key, value=value, headers=headers,
            ))
    return out


# ---------------------------------------------------------------------------
# consumer group protocol payloads ("consumer" embedded protocol v0) +
# the range assignor. These are the opaque bytes carried inside
# JoinGroup/SyncGroup — the broker never interprets them; the group LEADER
# member computes the assignment client-side, exactly like the Java client
# the reference's KafkaConsumerWrapper rides on.
# ---------------------------------------------------------------------------


def encode_subscription(topics: list[str]) -> bytes:
    """ConsumerProtocolSubscription v0: version, topics, user_data."""
    return (
        Writer()
        .i16(0)
        .array(sorted(topics), lambda w, t: w.string(t))
        .bytes_(None)
        .done()
    )


def decode_subscription(data: bytes) -> list[str]:
    r = Reader(data)
    r.i16()                                   # version
    return [r.string() for _ in range(r.i32())]


def encode_assignment(parts: dict[str, list[int]]) -> bytes:
    """ConsumerProtocolAssignment v0: version, [(topic, [partition])],
    user_data."""
    w = Writer().i16(0)

    def _topic(wr: Writer, item) -> None:
        topic, plist = item
        wr.string(topic)
        wr.array(sorted(plist), lambda w2, p: w2.i32(p))

    w.array(sorted(parts.items()), _topic)
    return w.bytes_(None).done()


def decode_assignment(data: bytes) -> dict[str, list[int]]:
    if not data:
        return {}
    r = Reader(data)
    r.i16()                                   # version
    out: dict[str, list[int]] = {}
    for _ in range(r.i32()):
        topic = r.string()
        out[topic] = [r.i32() for _ in range(r.i32())]
    return out


def range_assign(
    subscriptions: dict[str, list[str]],
    partitions_by_topic: dict[str, list[int]],
) -> dict[str, dict[str, list[int]]]:
    """The Java client's RangeAssignor: per topic, subscribed members in
    member-id order each take a contiguous range of the partition list,
    with the first ``parts % members`` members taking one extra."""
    out: dict[str, dict[str, list[int]]] = {m: {} for m in subscriptions}
    for topic, partitions in sorted(partitions_by_topic.items()):
        members = sorted(m for m, topics in subscriptions.items() if topic in topics)
        if not members:
            continue
        parts = sorted(partitions)
        quotient, remainder = divmod(len(parts), len(members))
        pos = 0
        for index, member in enumerate(members):
            take = quotient + (1 if index < remainder else 0)
            if take:
                out[member][topic] = parts[pos : pos + take]
            pos += take
    return out


# ---------------------------------------------------------------------------
# connection + client
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# security: TLS + SASL (PLAIN, SCRAM-SHA-256/-512)
# ---------------------------------------------------------------------------


_JAAS_FIELD = re.compile(r'(\w+)\s*=\s*"((?:[^"\\]|\\.)*)"')


@dataclass
class KafkaSecurity:
    """Connection security for the wire client, mirroring the Java client
    properties the reference's instances carry (``security.protocol``,
    ``sasl.mechanism``, ``sasl.jaas.config``)."""

    protocol: str = "PLAINTEXT"  # PLAINTEXT | SSL | SASL_PLAINTEXT | SASL_SSL
    mechanism: str = "PLAIN"     # PLAIN | SCRAM-SHA-256 | SCRAM-SHA-512
    username: str | None = None
    password: str | None = None
    ssl_cafile: str | None = None
    ssl_verify: bool = True           # False → CERT_NONE (+ no hostname)
    ssl_check_hostname: bool = True   # False → chain verified, name not
                                      # (Java: empty endpoint-identification
                                      # algorithm disables ONLY the name check)
    ssl_context: ssl_module.SSLContext | None = None  # overrides the above

    @property
    def use_tls(self) -> bool:
        return self.protocol in ("SSL", "SASL_SSL")

    @property
    def use_sasl(self) -> bool:
        return self.protocol in ("SASL_PLAINTEXT", "SASL_SSL")

    def build_ssl_context(self) -> ssl_module.SSLContext:
        if self.ssl_context is not None:
            return self.ssl_context
        ctx = ssl_module.create_default_context(cafile=self.ssl_cafile)
        if not self.ssl_check_hostname or not self.ssl_verify:
            ctx.check_hostname = False
        if not self.ssl_verify:
            ctx.verify_mode = ssl_module.CERT_NONE
        return ctx

    @classmethod
    def from_client_properties(
        cls, props: dict[str, Any]
    ) -> "KafkaSecurity | None":
        """Java-client-style properties → KafkaSecurity (None = plaintext).

        Credentials come from ``sasl.jaas.config`` (the reference's style:
        ``PlainLoginModule required username="..." password="...";``) or
        the flatter ``sasl.username``/``sasl.password`` pair."""
        protocol = str(props.get("security.protocol", "PLAINTEXT")).upper()
        if protocol == "PLAINTEXT":
            return None
        if protocol not in ("SSL", "SASL_PLAINTEXT", "SASL_SSL"):
            raise ValueError(
                f"security.protocol {protocol!r} not supported "
                "(PLAINTEXT|SSL|SASL_PLAINTEXT|SASL_SSL)"
            )
        username = props.get("sasl.username")
        password = props.get("sasl.password")
        jaas = props.get("sasl.jaas.config")
        if jaas and (username is None or password is None):
            fields = {
                # JAAS quoted values escape \" and \\ — unescape them, as
                # the Java client does
                k: re.sub(r"\\(.)", r"\1", v)
                for k, v in _JAAS_FIELD.findall(str(jaas))
            }
            username = username or fields.get("username")
            password = password or fields.get("password")
        mechanism = str(props.get("sasl.mechanism", "PLAIN")).upper()
        if protocol.startswith("SASL"):
            if mechanism not in ("PLAIN", "SCRAM-SHA-256", "SCRAM-SHA-512"):
                raise ValueError(
                    f"sasl.mechanism {mechanism!r} not supported "
                    "(PLAIN|SCRAM-SHA-256|SCRAM-SHA-512)"
                )
            if username is None or password is None:
                raise ValueError(
                    f"{protocol} requires credentials: set sasl.jaas.config "
                    "(username=\"..\" password=\"..\") or "
                    "sasl.username/sasl.password"
                )
        # "" disables endpoint identification (the HOSTNAME check only —
        # the chain is still verified) in the Java client; honour it
        ident = props.get("ssl.endpoint.identification.algorithm")
        verify = str(props.get("ssl.verify", "true")).lower() not in (
            "false", "0", "no"
        )
        return cls(
            protocol=protocol,
            mechanism=mechanism,
            username=username,
            password=password,
            ssl_cafile=props.get("ssl.ca.location"),
            ssl_verify=verify,
            ssl_check_hostname=ident != "",
        )


def _scram_escape(name: str) -> str:
    return name.replace("=", "=3D").replace(",", "=2C")


class ScramClient:
    """RFC 5802 client for SCRAM-SHA-256/-512 (stdlib only). Stateful over
    the three-message exchange; verifies the server signature so a broker
    that doesn't know the password is detected, not just the reverse."""

    def __init__(self, mechanism: str, username: str, password: str,
                 nonce: str | None = None):
        self._hash = {
            "SCRAM-SHA-256": hashlib.sha256,
            "SCRAM-SHA-512": hashlib.sha512,
        }[mechanism]
        self._hash_name = self._hash().name
        self.username = username
        self.password = password.encode("utf-8")
        self.nonce = nonce or secrets.token_urlsafe(24)
        self._client_first_bare = ""
        self._auth_message = b""
        self._salted = b""

    def client_first(self) -> bytes:
        self._client_first_bare = (
            f"n={_scram_escape(self.username)},r={self.nonce}"
        )
        return ("n,," + self._client_first_bare).encode("utf-8")

    def client_final(self, server_first: bytes) -> bytes:
        text = server_first.decode("utf-8")
        fields = dict(p.split("=", 1) for p in text.split(","))
        server_nonce, salt, iters = fields["r"], fields["s"], int(fields["i"])
        if not server_nonce.startswith(self.nonce):
            raise KafkaProtocolError(
                ERR_SASL_AUTHENTICATION_FAILED,
                "SCRAM server nonce does not extend the client nonce",
            )
        self._salted = hashlib.pbkdf2_hmac(
            self._hash_name, self.password, base64.b64decode(salt), iters
        )
        client_key = hmac.new(self._salted, b"Client Key", self._hash).digest()
        stored_key = self._hash(client_key).digest()
        without_proof = f"c=biws,r={server_nonce}"
        self._auth_message = ",".join(
            [self._client_first_bare, text, without_proof]
        ).encode("utf-8")
        signature = hmac.new(stored_key, self._auth_message, self._hash).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, signature))
        final = f"{without_proof},p={base64.b64encode(proof).decode()}"
        return final.encode("utf-8")

    def verify_server_final(self, server_final: bytes) -> None:
        fields = dict(
            p.split("=", 1) for p in server_final.decode("utf-8").split(",")
        )
        if "e" in fields:
            raise KafkaProtocolError(
                ERR_SASL_AUTHENTICATION_FAILED, f"SCRAM: {fields['e']}"
            )
        server_key = hmac.new(self._salted, b"Server Key", self._hash).digest()
        expected = hmac.new(server_key, self._auth_message, self._hash).digest()
        if not hmac.compare_digest(
            base64.b64decode(fields["v"]), expected
        ):
            raise KafkaProtocolError(
                ERR_SASL_AUTHENTICATION_FAILED,
                "SCRAM server signature mismatch (broker does not know "
                "the password?)",
            )


CLOSE_WAIT_S = 5.0  # the longest a close waits for a call on its socket


class _Conn:
    """One broker connection; requests are serialized (correlation ids
    still checked). The runtime's per-agent access pattern is sequential."""

    def __init__(self, host: str, port: int, client_id: str,
                 security: KafkaSecurity | None = None):
        self.host, self.port = host, port
        self.client_id = client_id
        self.security = security
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._correlation = 0
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        sec = self.security
        if sec is not None and sec.use_tls:
            ctx = sec.build_ssl_context()
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port, ssl=ctx,
                server_hostname=self.host if ctx.check_hostname else None,
            )
        else:
            self._reader, self._writer = await asyncio.open_connection(
                self.host, self.port
            )
        if sec is not None and sec.use_sasl:
            try:
                await self._sasl_authenticate(sec)
            except BaseException:
                self._writer.close()
                self._writer = self._reader = None
                raise

    async def _roundtrip(self, api_key: int, version: int,
                         payload: bytes) -> Reader:
        """One request/response WITHOUT the lock (connect-time SASL runs
        inside ``call``'s lock already)."""
        self._correlation += 1
        cid = self._correlation
        header = (
            Writer()
            .i16(api_key).i16(version).i32(cid)
            .string(self.client_id)
            .done()
        )
        frame = header + payload
        self._writer.write(struct.pack(">i", len(frame)) + frame)
        await self._writer.drain()
        (size,) = struct.unpack(">i", await self._reader.readexactly(4))
        body = await self._reader.readexactly(size)
        r = Reader(body)
        got = r.i32()
        if got != cid:
            raise KafkaProtocolError(
                -1, f"correlation mismatch (sent {cid}, got {got})"
            )
        return r

    async def _sasl_call(self, token: bytes) -> bytes:
        """SaslAuthenticate v0 exchange; raises on broker auth errors."""
        r = await self._roundtrip(
            API_SASL_AUTHENTICATE, 0, Writer().bytes_(token).done()
        )
        error = r.i16()
        message = r.string()
        auth_bytes = r.bytes_() or b""
        if error:
            raise KafkaProtocolError(
                error, f"SASL authentication failed: {message or 'denied'}"
            )
        return auth_bytes

    async def _sasl_authenticate(self, sec: KafkaSecurity) -> None:
        r = await self._roundtrip(
            API_SASL_HANDSHAKE, 1, Writer().string(sec.mechanism).done()
        )
        error = r.i16()
        if error:
            supported = r.array(lambda rr: rr.string())
            raise KafkaProtocolError(
                error,
                f"broker rejected SASL mechanism {sec.mechanism} "
                f"(supports: {supported})",
            )
        if sec.mechanism == "PLAIN":
            token = (
                b"\x00" + sec.username.encode("utf-8")
                + b"\x00" + sec.password.encode("utf-8")
            )
            await self._sasl_call(token)
        else:  # SCRAM
            scram = ScramClient(sec.mechanism, sec.username, sec.password)
            server_first = await self._sasl_call(scram.client_first())
            server_final = await self._sasl_call(
                scram.client_final(server_first)
            )
            scram.verify_server_final(server_final)

    async def close(self) -> None:
        """Close the socket once no call is on it: a call in flight (a
        commit at stop) ends before its socket does. A call still on it
        after ``CLOSE_WAIT_S`` (a broker that never answers) has the socket
        closed under it, and fails, so a close never waits longer than that."""
        try:
            await asyncio.wait_for(self._lock.acquire(), CLOSE_WAIT_S)
            locked = True
        except asyncio.TimeoutError:
            locked = False
            logger.warning("closing the connection to %s:%s under a call "
                           "unanswered after %.1f s", self.host, self.port, CLOSE_WAIT_S)
        try:
            if self._writer is not None:
                self._writer.close()
                try:
                    await self._writer.wait_closed()
                except (OSError, ConnectionError):
                    pass
                self._writer = None
        finally:
            if locked:
                self._lock.release()

    async def call(self, api_key: int, version: int, payload: bytes) -> Reader:
        async with self._lock:
            if self._writer is None:
                await self.connect()
            try:
                return await self._roundtrip(api_key, version, payload)
            except (OSError, asyncio.IncompleteReadError, ConnectionError):
                # brokers drop idle connections (connections.max.idle.ms):
                # a dead socket must not poison every later call — drop it
                # so the next call redials (and re-authenticates)
                try:
                    self._writer.close()
                except Exception as e:
                    logger.debug("closing dead broker socket failed: %s", e)
                self._writer = self._reader = None
                raise


@dataclass
class PartitionMeta:
    leader: int
    error: int = 0


class KafkaWireClient:
    """Metadata-aware client: routes produce/fetch to partition leaders,
    refreshes metadata on NOT_LEADER / UNKNOWN_TOPIC errors."""

    def __init__(self, bootstrap: str, client_id: str = "langstream-tpu",
                 security: KafkaSecurity | None = None):
        host, _, port = bootstrap.partition(":")
        self.bootstrap = (host, int(port or 9092))
        self.client_id = client_id
        self.security = security
        self._conns: dict[int, _Conn] = {}
        self._bootstrap_conn: _Conn | None = None
        self.brokers: dict[int, tuple[str, int]] = {}
        self.topics: dict[str, dict[int, PartitionMeta]] = {}
        self._group_coordinators: dict[str, int] = {}  # group -> node id

    async def _boot(self) -> _Conn:
        if self._bootstrap_conn is None:
            self._bootstrap_conn = _Conn(
                *self.bootstrap, self.client_id, security=self.security
            )
            await self._bootstrap_conn.connect()
        return self._bootstrap_conn

    async def close(self) -> None:
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()
        if self._bootstrap_conn is not None:
            await self._bootstrap_conn.close()
            self._bootstrap_conn = None

    async def _node(self, node_id: int) -> _Conn:
        if node_id not in self._conns:
            host, port = self.brokers.get(node_id, self.bootstrap)
            conn = _Conn(host, port, self.client_id, security=self.security)
            await conn.connect()
            self._conns[node_id] = conn
        return self._conns[node_id]

    # -- apis --------------------------------------------------------------

    async def api_versions(self) -> dict[int, tuple[int, int]]:
        conn = await self._boot()
        r = await conn.call(API_API_VERSIONS, 0, b"")
        error = r.i16()
        if error:
            raise KafkaProtocolError(error, "ApiVersions")
        out = {}
        for _ in range(r.i32()):
            key, lo, hi = r.i16(), r.i16(), r.i16()
            out[key] = (lo, hi)
        return out

    async def refresh_metadata(self, topics: list[str] | None = None) -> None:
        conn = await self._boot()
        w = Writer()
        if topics is None:
            w.i32(-1)
        else:
            w.array(topics, lambda wr, t: wr.string(t))
        r = await conn.call(API_METADATA, 1, w.done())
        self.brokers = {}
        for _ in range(r.i32()):
            node, host, port = r.i32(), r.string(), r.i32()
            r.string()  # rack
            self.brokers[node] = (host, port)
        r.i32()  # controller id
        for _ in range(r.i32()):
            terr = r.i16()
            tname = r.string()
            r.raw(1)  # is_internal bool
            parts: dict[int, PartitionMeta] = {}
            for _p in range(r.i32()):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                r.array(lambda rr: rr.i32())  # replicas
                r.array(lambda rr: rr.i32())  # isr
                parts[pid] = PartitionMeta(leader=leader, error=perr)
            if terr == ERR_NONE:
                self.topics[tname] = parts
            elif tname in self.topics:
                del self.topics[tname]

    async def partitions_for(self, topic: str) -> list[int]:
        if topic not in self.topics:
            await self.refresh_metadata([topic])
        if topic not in self.topics:
            raise KafkaProtocolError(ERR_UNKNOWN_TOPIC_OR_PARTITION, topic)
        return sorted(self.topics[topic])

    async def _leader_conn(self, topic: str, partition: int) -> _Conn:
        if topic not in self.topics or partition not in self.topics[topic]:
            await self.refresh_metadata([topic])
        meta = self.topics.get(topic, {}).get(partition)
        if meta is None:
            raise KafkaProtocolError(
                ERR_UNKNOWN_TOPIC_OR_PARTITION, f"{topic}[{partition}]"
            )
        return await self._node(meta.leader)

    async def produce(
        self,
        topic: str,
        partition: int,
        records: list[tuple[bytes | None, bytes | None, list[tuple[str, bytes | None]]]],
        timestamp_ms: int,
        acks: int = -1,
        timeout_ms: int = 30000,
        compression: str | None = None,
    ) -> int:
        """→ base offset assigned by the broker."""
        batch = encode_record_batch(records, timestamp_ms, compression)
        for attempt in range(2):
            conn = await self._leader_conn(topic, partition)
            w = (
                Writer()
                .string(None)                 # transactional id
                .i16(acks)
                .i32(timeout_ms)
            )

            def _topic(wr: Writer, t: str) -> None:
                wr.string(t)
                wr.array([partition], lambda w2, p: (
                    w2.i32(p), w2.bytes_(batch)
                ))

            w.array([topic], _topic)
            r = await conn.call(API_PRODUCE, 3, w.done())
            # exactly one topic/partition was sent; parse linearly
            r.i32()                           # topic count (1)
            r.string()
            r.i32()                           # partition count (1)
            r.i32()                           # partition
            error = r.i16()
            base_offset = r.i64()
            r.i64()                           # log append time
            if (
                error in (ERR_NOT_LEADER, ERR_UNKNOWN_TOPIC_OR_PARTITION)
                and attempt == 0
            ):
                await self.refresh_metadata([topic])
                continue
            if error:
                raise KafkaProtocolError(error, f"produce {topic}[{partition}]")
            return base_offset
        raise KafkaProtocolError(-1, f"produce {topic}[{partition}] kept failing")

    async def fetch(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_wait_ms: int = 500,
        max_bytes: int = 4 * 1024 * 1024,
    ) -> tuple[list[WireRecord], int]:
        """→ (records from ``offset`` onward, high watermark)."""
        conn = await self._leader_conn(topic, partition)
        w = (
            Writer()
            .i32(-1)                          # replica id
            .i32(max_wait_ms)
            .i32(1)                           # min bytes
            .i32(max_bytes)
            .i8(0)                            # isolation: read uncommitted
        )

        def _topic(wr: Writer, t: str) -> None:
            wr.string(t)
            wr.array([partition], lambda w2, p: (
                w2.i32(p), w2.i64(offset), w2.i32(max_bytes)
            ))

        w.array([topic], _topic)
        r = await conn.call(API_FETCH, 4, w.done())
        r.i32()                               # throttle
        records: list[WireRecord] = []
        high_watermark = -1
        for _ in range(r.i32()):
            r.string()
            for _p in range(r.i32()):
                r.i32()                       # partition
                error = r.i16()
                high_watermark = r.i64()
                r.i64()                       # last stable offset
                r.array(lambda rr: (rr.i64(), rr.i64()))  # aborted txns
                record_set = r.bytes_() or b""
                if error:
                    raise KafkaProtocolError(
                        error, f"fetch {topic}[{partition}] @{offset}"
                    )
                records.extend(
                    rec for rec in decode_record_batches(record_set)
                    if rec.offset >= offset
                )
        return records, high_watermark

    async def list_offsets(
        self, topic: str, partition: int, timestamp: int
    ) -> int:
        """timestamp -1 = latest (log end), -2 = earliest."""
        conn = await self._leader_conn(topic, partition)
        w = Writer().i32(-1)

        def _topic(wr: Writer, t: str) -> None:
            wr.string(t)
            wr.array([partition], lambda w2, p: (w2.i32(p), w2.i64(timestamp)))

        w.array([topic], _topic)
        r = await conn.call(API_LIST_OFFSETS, 1, w.done())
        for _ in range(r.i32()):
            r.string()
            for _p in range(r.i32()):
                r.i32()
                error = r.i16()
                r.i64()                       # timestamp
                off = r.i64()
                if error:
                    raise KafkaProtocolError(
                        error, f"list_offsets {topic}[{partition}]"
                    )
                return off
        raise KafkaProtocolError(-1, "empty ListOffsets response")

    async def find_coordinator(self, group: str) -> _Conn:
        """Group-coordinator connection, cached per group: the heartbeat
        hot path must not pay a FindCoordinator round trip every beat.
        Invalidated by :meth:`_call_coordinator` on NOT_COORDINATOR or a
        dead connection."""
        node = self._group_coordinators.get(group)
        if node is not None:
            return await self._node(node)
        conn = await self._boot()
        w = Writer().string(group).i8(0)
        r = await conn.call(API_FIND_COORDINATOR, 1, w.done())
        r.i32()                               # throttle
        error = r.i16()
        r.string()                            # error message
        node, host, port = r.i32(), r.string(), r.i32()
        if error:
            raise KafkaProtocolError(error, f"find_coordinator {group}")
        self.brokers.setdefault(node, (host, port))
        self._group_coordinators[group] = node
        return await self._node(node)

    async def _call_coordinator(
        self, group: str, api_key: int, version: int, payload: bytes
    ) -> Reader:
        """One coordinator RPC with a single re-lookup retry when the
        cached coordinator moved or the connection died (the group-API
        analogue of the NOT_LEADER metadata refresh on produce/fetch). The
        lookup is inside the retry: a dead bootstrap connection redials."""
        for attempt in (0, 1):
            try:
                conn = await self.find_coordinator(group)
                return await conn.call(api_key, version, payload)
            except (ConnectionError, OSError, asyncio.IncompleteReadError):
                self._group_coordinators.pop(group, None)
                if attempt:
                    raise
        raise AssertionError("unreachable")

    @staticmethod
    def _check_coordinator_error(error: int, group: str, context: str) -> None:
        if error:
            raise KafkaProtocolError(error, context)

    def _invalidate_coordinator_on(self, group: str, error: int) -> None:
        if error in (ERR_NOT_COORDINATOR, ERR_COORDINATOR_NOT_AVAILABLE):
            self._group_coordinators.pop(group, None)

    async def offset_commit(
        self, group: str, offsets: dict[tuple[str, int], int]
    ) -> None:
        """Simple-consumer commit — exactly the grouped commit with
        generation -1 and an empty member id."""
        await self.offset_commit_grouped(group, -1, "", offsets)

    async def offset_fetch(
        self, group: str, topic: str, partitions: list[int]
    ) -> dict[int, int]:
        """→ {partition: committed offset} (-1 = no commit)."""
        w = Writer().string(group)

        def _topic(wr: Writer, t: str) -> None:
            wr.string(t)
            wr.array(partitions, lambda w2, p: w2.i32(p))

        w.array([topic], _topic)
        r = await self._call_coordinator(group, API_OFFSET_FETCH, 1, w.done())
        out: dict[int, int] = {}
        for _ in range(r.i32()):
            r.string()
            for _p in range(r.i32()):
                partition = r.i32()
                offset = r.i64()
                r.string()                    # metadata
                error = r.i16()
                if error:
                    raise KafkaProtocolError(
                        error, f"offset_fetch {group} {topic}[{partition}]"
                    )
                out[partition] = offset
        return out

    # -- consumer group membership (JoinGroup v2 / SyncGroup v1 /
    #    Heartbeat v1 / LeaveGroup v1 — the non-flexible versions, like
    #    every other API here) ----------------------------------------------

    async def join_group(
        self,
        group: str,
        member_id: str,
        topics: list[str],
        session_timeout_ms: int = 10000,
        rebalance_timeout_ms: int = 30000,
    ) -> dict[str, Any]:
        """One JoinGroup round trip. Returns {generation, member_id, leader,
        protocol, members: {member_id: [topics]} (leader only)}."""
        w = (
            Writer()
            .string(group)
            .i32(session_timeout_ms)
            .i32(rebalance_timeout_ms)
            .string(member_id)
            .string("consumer")
            .array(
                [("range", encode_subscription(topics))],
                lambda wr, p: (wr.string(p[0]), wr.bytes_(p[1])),
            )
        )
        r = await self._call_coordinator(group, API_JOIN_GROUP, 2, w.done())
        r.i32()                               # throttle
        error = r.i16()
        generation = r.i32()
        protocol = r.string()
        leader = r.string()
        own_id = r.string()
        members: dict[str, list[str]] = {}
        for _ in range(r.i32()):
            mid = r.string()
            meta = r.bytes_()
            members[mid] = decode_subscription(meta) if meta else []
        if error:
            self._invalidate_coordinator_on(group, error)
            raise KafkaProtocolError(error, f"join_group {group}")
        return {
            "generation": generation,
            "member_id": own_id,
            "leader": leader,
            "protocol": protocol,
            "members": members,
        }

    async def sync_group(
        self,
        group: str,
        generation: int,
        member_id: str,
        assignments: dict[str, dict[str, list[int]]] | None = None,
    ) -> dict[str, list[int]]:
        """Leader passes the computed assignments; followers pass None.
        Returns this member's own {topic: [partitions]}."""
        encoded = [
            (mid, encode_assignment(parts))
            for mid, parts in (assignments or {}).items()
        ]
        w = (
            Writer()
            .string(group)
            .i32(generation)
            .string(member_id)
            .array(encoded, lambda wr, p: (wr.string(p[0]), wr.bytes_(p[1])))
        )
        r = await self._call_coordinator(group, API_SYNC_GROUP, 1, w.done())
        r.i32()                               # throttle
        error = r.i16()
        assignment = r.bytes_()
        if error:
            self._invalidate_coordinator_on(group, error)
            raise KafkaProtocolError(error, f"sync_group {group}")
        return decode_assignment(assignment or b"")

    async def heartbeat(self, group: str, generation: int, member_id: str) -> None:
        w = Writer().string(group).i32(generation).string(member_id)
        r = await self._call_coordinator(group, API_HEARTBEAT, 1, w.done())
        r.i32()                               # throttle
        error = r.i16()
        if error:
            self._invalidate_coordinator_on(group, error)
            raise KafkaProtocolError(error, f"heartbeat {group}")

    async def leave_group(self, group: str, member_id: str) -> None:
        w = Writer().string(group).string(member_id)
        r = await self._call_coordinator(group, API_LEAVE_GROUP, 1, w.done())
        r.i32()                               # throttle
        error = r.i16()
        if error and error != ERR_UNKNOWN_MEMBER_ID:
            raise KafkaProtocolError(error, f"leave_group {group}")

    async def offset_commit_grouped(
        self,
        group: str,
        generation: int,
        member_id: str,
        offsets: dict[tuple[str, int], int],
    ) -> None:
        """Commit as a dynamic group member: the coordinator fences stale
        generations (ILLEGAL_GENERATION) so a zombie replica that missed a
        rebalance cannot clobber the new owner's progress."""
        by_topic: dict[str, list[tuple[int, int]]] = {}
        for (topic, partition), offset in offsets.items():
            by_topic.setdefault(topic, []).append((partition, offset))
        w = (
            Writer()
            .string(group)
            .i32(generation)
            .string(member_id)
            .i64(-1)                          # retention
        )

        def _topic(wr: Writer, item) -> None:
            topic, parts = item
            wr.string(topic)
            wr.array(parts, lambda w2, po: (
                w2.i32(po[0]), w2.i64(po[1]), w2.string(None)
            ))

        w.array(list(by_topic.items()), _topic)
        r = await self._call_coordinator(group, API_OFFSET_COMMIT, 2, w.done())
        for _ in range(r.i32()):
            topic = r.string()
            for _p in range(r.i32()):
                partition = r.i32()
                error = r.i16()
                if error:
                    self._invalidate_coordinator_on(group, error)
                    raise KafkaProtocolError(
                        error, f"offset_commit {group} {topic}[{partition}]"
                    )

    async def create_topic(
        self, topic: str, partitions: int = 1, replication: int = 1,
        exist_ok: bool = True,
    ) -> None:
        conn = await self._boot()
        w = Writer()

        def _topic(wr: Writer, t: str) -> None:
            wr.string(t)
            wr.i32(partitions)
            wr.i16(replication)
            wr.i32(0)                         # assignments
            wr.i32(0)                         # configs
        w.array([topic], _topic)
        w.i32(30000)                          # timeout
        w.raw(b"\x00")                        # validate_only = false
        r = await conn.call(API_CREATE_TOPICS, 1, w.done())
        for _ in range(r.i32()):
            r.string()
            error = r.i16()
            r.string()                        # error message
            if error == ERR_TOPIC_ALREADY_EXISTS and exist_ok:
                continue
            if error:
                raise KafkaProtocolError(error, f"create_topic {topic}")
        await self.refresh_metadata([topic])

    async def delete_topic(self, topic: str) -> None:
        conn = await self._boot()
        w = Writer().array([topic], lambda wr, t: wr.string(t)).i32(30000)
        r = await conn.call(API_DELETE_TOPICS, 1, w.done())
        r.i32()                               # throttle
        for _ in range(r.i32()):
            r.string()
            error = r.i16()
            if error and error != ERR_UNKNOWN_TOPIC_OR_PARTITION:
                raise KafkaProtocolError(error, f"delete_topic {topic}")
        self.topics.pop(topic, None)
