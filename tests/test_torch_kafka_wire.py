"""The port's Kafka wire protocol against the JAX package's: every case of
``tests/test_kafka_wire.py`` on the port (codec vectors, the client and
the wire runtime against a fake broker, a pipeline over ``type: kafka``),
each client case run against both fake brokers (``tests/torch_fake_kafka.py``,
the port's, and ``tests/fake_kafka.py``, the JAX package's); then the
cross-checks: record batches byte for byte equal across the packages with
and without gzip, each package decoding the other's; the JAX client
against the port's fake; the versions the client sends against what it
declares; the port's fake holding an empty fetch; a zstd batch without
``zstandard`` refused by name; the same pipeline through both packages'
runners over both wire runtimes."""

from __future__ import annotations

import asyncio

import pytest

import fake_kafka as jax_fake
import torch_fake_kafka
from langstream_tpu.runtime import kafka_wire as jax_wire
from langstream_tpu_torch.runtime import kafka_wire as port_wire
from torch_fake_kafka import FakeKafkaBroker
from langstream_tpu_torch.runtime.kafka_wire import (
    KafkaProtocolError,
    KafkaWireClient,
    Reader,
    Writer,
    crc32c,
    decode_record_batches,
    encode_record_batch,
)

#: the two fake brokers a client case runs against
FAKES = {"torch-fake": torch_fake_kafka.FakeKafkaBroker, "jax-fake": jax_fake.FakeKafkaBroker}


# ---------------------------------------------------------------------------
# codec vectors
# ---------------------------------------------------------------------------


def test_crc32c_known_vector():
    # the canonical Castagnoli check vector
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0


@pytest.mark.parametrize(
    "v", [0, 1, -1, 63, 64, -64, -65, 300, -300, 2**31, -(2**31), 2**62]
)
def test_varint_zigzag_roundtrip(v):
    data = Writer().varint(v).done()
    assert Reader(data).varint() == v


def test_varint_known_encodings():
    # zigzag: 0→0, -1→1, 1→2, -2→3 ...
    assert Writer().varint(0).done() == b"\x00"
    assert Writer().varint(-1).done() == b"\x01"
    assert Writer().varint(1).done() == b"\x02"
    assert Writer().varint(150).done() == b"\xac\x02"


# -- snappy (pure-Python raw-block decoder + xerial framing) ---------------
#
# fixtures are hand-assembled from the format spec, NOT produced by a
# compressor: [varint uncompressed-length][literal/copy elements]


def _raw_literal(payload: bytes) -> bytes:
    """One raw snappy block that stores ``payload`` as a single literal."""
    assert len(payload) < 61
    preamble = bytes([len(payload)])  # varint, single byte for < 128
    tag = bytes([(len(payload) - 1) << 2])  # kind 0, length-1 in tag
    return preamble + tag + payload


def test_snappy_raw_literal_block():
    from langstream_tpu_torch.runtime.kafka_wire import _snappy_decompress_raw

    assert _snappy_decompress_raw(_raw_literal(b"langstream")) == b"langstream"


def test_snappy_copy_elements_and_overlap():
    from langstream_tpu_torch.runtime.kafka_wire import _snappy_decompress_raw

    # "abcd" literal + kind-1 copy (offset 4, len 8): overlapping copy
    # repeats the 4-byte pattern → "abcd" * 3
    block = bytes(
        [12]            # preamble: 12 uncompressed bytes
        + [(4 - 1) << 2]  # literal, len 4
    ) + b"abcd" + bytes(
        [((8 - 4) << 2) | (0 << 5) | 1, 4]  # copy1: len 8, offset 4
    )
    assert _snappy_decompress_raw(block) == b"abcd" * 3

    # kind-2 copy with a 2-byte little-endian offset
    block = bytes([8, (4 - 1) << 2]) + b"wxyz" + bytes(
        [((4 - 1) << 2) | 2]
    ) + (4).to_bytes(2, "little")
    assert _snappy_decompress_raw(block) == b"wxyzwxyz"


def test_snappy_long_literal_uses_extra_length_byte():
    from langstream_tpu_torch.runtime.kafka_wire import _snappy_decompress_raw

    payload = bytes(range(256)) * 2  # 512 bytes: needs the 2-byte form
    preamble = bytes([0x80 | (512 & 0x7F), 512 >> 7])  # varint 512
    tag = bytes([61 << 2]) + (len(payload) - 1).to_bytes(2, "little")
    assert _snappy_decompress_raw(preamble + tag + payload) == payload


def test_snappy_corrupt_blocks_raise():
    from langstream_tpu_torch.runtime.kafka_wire import _snappy_decompress_raw

    with pytest.raises(KafkaProtocolError, match="truncated snappy"):
        _snappy_decompress_raw(_raw_literal(b"short")[:-1])
    with pytest.raises(KafkaProtocolError, match="length mismatch"):
        # preamble claims 10 uncompressed bytes, block only yields 5
        _snappy_decompress_raw(bytes([10]) + _raw_literal(b"short")[1:])
    with pytest.raises(KafkaProtocolError, match="copy offset"):
        # copy back 200 bytes when only 4 exist
        bad = bytes([8, (4 - 1) << 2]) + b"abcd" + bytes(
            [((4 - 1) << 2) | 2]
        ) + (200).to_bytes(2, "little")
        _snappy_decompress_raw(bad)
    with pytest.raises(KafkaProtocolError, match="truncated snappy copy"):
        # block ends right after a kind-1 copy tag, before its offset byte
        _snappy_decompress_raw(
            bytes([8, (4 - 1) << 2]) + b"abcd"
            + bytes([((8 - 4) << 2) | 1])
        )
    with pytest.raises(KafkaProtocolError, match="truncated snappy copy"):
        # kind-2 copy with only one of its two offset bytes present
        _snappy_decompress_raw(
            bytes([8, (4 - 1) << 2]) + b"abcd"
            + bytes([((4 - 1) << 2) | 2, 4])
        )


def test_snappy_xerial_framed_fetch_decompression():
    """decompress_records(codec=2) on a hand-built xerial stream: magic +
    version/compat ints, then length-prefixed raw blocks — the shape java
    producers actually put on the wire."""
    from langstream_tpu_torch.runtime.kafka_wire import (
        XERIAL_MAGIC,
        decompress_records,
    )

    blocks = [_raw_literal(b"hello "), _raw_literal(b"kafka")]
    framed = XERIAL_MAGIC + (1).to_bytes(4, "big") + (1).to_bytes(4, "big")
    for b in blocks:
        framed += len(b).to_bytes(4, "big") + b
    assert decompress_records(2, framed) == b"hello kafka"
    # bare (unframed) raw block also accepted
    assert decompress_records(2, _raw_literal(b"bare")) == b"bare"


def test_record_batch_roundtrip_and_crc():
    records = [
        (b"k1", b"v1", [("h", b"x"), ("n", None)]),
        (None, b"v2", []),
        (b"k3", None, [("a", b"")]),
    ]
    batch = encode_record_batch(records, base_timestamp=1234)
    decoded = decode_record_batches(batch)
    assert [(r.key, r.value, r.headers) for r in decoded] == [
        (b"k1", b"v1", [("h", b"x"), ("n", None)]),
        (None, b"v2", []),
        (b"k3", None, [("a", b"")]),
    ]
    assert [r.offset for r in decoded] == [0, 1, 2]
    assert all(r.timestamp == 1234 for r in decoded)
    # flip one payload byte: CRC must catch it
    corrupt = bytearray(batch)
    corrupt[-1] ^= 0xFF
    with pytest.raises(KafkaProtocolError, match="CRC"):
        decode_record_batches(bytes(corrupt))


@pytest.mark.parametrize("fake", sorted(FAKES))
def test_server_side_parser_agrees_with_client_encoder(fake):
    """Each fake broker's independent parser accepts the client's batches
    byte-for-byte (CRC verified server-side)."""
    records = [(b"key", b"value", [("h1", b"v1")])]
    batch = encode_record_batch(records, base_timestamp=99)
    parsed = FAKES[fake]._parse_batches(batch)
    assert parsed == [(99, b"key", b"value", [("h1", b"v1")])]


# ---------------------------------------------------------------------------
# client against the fake broker
# ---------------------------------------------------------------------------


@pytest.fixture(params=sorted(FAKES))
def broker(request):
    """The port's client meets each package's fake broker."""
    with FAKES[request.param]() as b:
        yield b


def _run(coro):
    return asyncio.run(coro)


def test_client_topic_lifecycle_and_produce_fetch(broker):
    async def main():
        client = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            versions = await client.api_versions()
            assert versions[0][1] >= 3  # produce v3 supported
            await client.create_topic("t1", partitions=2)
            assert await client.partitions_for("t1") == [0, 1]
            base = await client.produce(
                "t1", 0,
                [(b"k", b"hello", [("h", b"1")])], timestamp_ms=1000,
            )
            assert base == 0
            base2 = await client.produce(
                "t1", 0, [(None, b"world", [])], timestamp_ms=2000,
            )
            assert base2 == 1
            records, hw = await client.fetch("t1", 0, 0)
            assert hw == 2
            assert [(r.offset, r.value) for r in records] == [
                (0, b"hello"), (1, b"world"),
            ]
            # positioned fetch skips the prefix
            records, _ = await client.fetch("t1", 0, 1)
            assert [(r.offset, r.value) for r in records] == [(1, b"world")]
            assert await client.list_offsets("t1", 0, -2) == 0
            assert await client.list_offsets("t1", 0, -1) == 2
            await client.delete_topic("t1")
            with pytest.raises(KafkaProtocolError):
                await client.partitions_for("t1")
        finally:
            await client.close()

    _run(main())


def test_client_offset_commit_fetch(broker):
    async def main():
        client = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            await client.create_topic("t2", partitions=3)
            await client.offset_commit("g1", {("t2", 0): 5, ("t2", 2): 9})
            got = await client.offset_fetch("g1", "t2", [0, 1, 2])
            assert got == {0: 5, 1: -1, 2: 9}
            # another group is independent
            assert await client.offset_fetch("g2", "t2", [0]) == {0: -1}
        finally:
            await client.close()

    _run(main())


def test_unknown_topic_raises(broker):
    async def main():
        client = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            with pytest.raises(KafkaProtocolError, match="UNKNOWN_TOPIC"):
                await client.produce("ghost", 0, [(None, b"x", [])], 0)
        finally:
            await client.close()

    _run(main())


# ---------------------------------------------------------------------------
# runtime SPI over the wire
# ---------------------------------------------------------------------------


def _wire_runtime(broker):
    from langstream_tpu_torch.runtime.kafka_wire_runtime import (
        WireKafkaTopicConnectionsRuntime,
    )

    rt = WireKafkaTopicConnectionsRuntime()
    rt.init({"admin": {"bootstrap.servers": f"127.0.0.1:{broker.port}"}})
    return rt


def test_consumer_contiguous_commit_and_restart(broker):
    """Out-of-order acks commit only the contiguous prefix; a restarted
    consumer resumes from the committed offset (at-least-once)."""
    from langstream_tpu_torch.api.record import SimpleRecord

    async def main():
        rt = _wire_runtime(broker)
        admin = rt.create_topic_admin()
        await admin.create_topic("jobs", partitions=1)
        producer = rt.create_producer("p", {"topic": "jobs"})
        await producer.start()
        for i in range(5):
            await producer.write(SimpleRecord(value={"i": i}))
        await producer.close()

        consumer = rt.create_consumer("agent", {"topic": "jobs", "group": "g"})
        await consumer.start()
        got = []
        while len(got) < 5:
            got.extend(await consumer.read())
        assert [r.value["i"] for r in got] == [0, 1, 2, 3, 4]
        # ack 0, 2, 3: contiguous prefix is just offset 0 → commit 1
        await consumer.commit([got[0], got[2], got[3]])
        await consumer.close()

        consumer2 = rt.create_consumer("agent", {"topic": "jobs", "group": "g"})
        await consumer2.start()
        redelivered = []
        while len(redelivered) < 4:
            redelivered.extend(await consumer2.read())
        # records 1..4 redeliver (1 was never acked; 2,3 were beyond the gap)
        assert [r.value["i"] for r in redelivered] == [1, 2, 3, 4]
        # acking the gap releases the whole prefix
        await consumer2.commit(redelivered)
        await consumer2.close()

        consumer3 = rt.create_consumer("agent", {"topic": "jobs", "group": "g"})
        await consumer3.start()
        assert await consumer3.read() == []
        await consumer3.close()

    _run(main())


def test_static_partition_assignment_splits_work(broker):
    from langstream_tpu_torch.api.record import SimpleRecord

    async def main():
        rt = _wire_runtime(broker)
        await rt.create_topic_admin().create_topic("fan", partitions=4)
        producer = rt.create_producer("p", {"topic": "fan"})
        await producer.start()
        for i in range(20):
            await producer.write(SimpleRecord(key=f"key-{i}", value=i))
        await producer.close()

        async def drain(replica):
            consumer = rt.create_consumer(
                "agent",
                {"topic": "fan", "group": "g", "replica-index": replica,
                 "num-replicas": 2},
            )
            await consumer.start()
            out = []
            idle = 0
            while idle < 3:
                batch = await consumer.read()
                if batch:
                    out.extend(batch)
                    idle = 0
                else:
                    idle += 1
            await consumer.commit(out)
            await consumer.close()
            return out

        got0 = await drain(0)
        got1 = await drain(1)
        values0 = {r.value for r in got0}
        values1 = {r.value for r in got1}
        assert values0 | values1 == set(range(20))
        assert values0.isdisjoint(values1)
        assert values0 and values1  # both replicas own live partitions

        # same key always lands on the same partition (per-key ordering)
        producer2 = rt.create_producer("p", {"topic": "fan"})
        await producer2.start()
        for _ in range(3):
            await producer2.write(SimpleRecord(key="sticky", value="x"))
        await producer2.close()
        parts_with_sticky = {
            pid
            for pid, part in broker.topics["fan"].items()
            if any(r.key == b"sticky" for r in part.records)
        }
        assert len(parts_with_sticky) == 1

    _run(main())


def test_reader_positions(broker):
    from langstream_tpu_torch.api.record import SimpleRecord

    async def main():
        rt = _wire_runtime(broker)
        await rt.create_topic_admin().create_topic("stream", partitions=1)
        producer = rt.create_producer("p", {"topic": "stream"})
        await producer.start()
        await producer.write(SimpleRecord(value="old"))

        latest = rt.create_reader({"topic": "stream"}, initial_position="latest")
        await latest.start()
        earliest = rt.create_reader(
            {"topic": "stream"}, initial_position="earliest"
        )
        await earliest.start()
        await producer.write(SimpleRecord(value="new"))
        await producer.close()

        got_latest = await latest.read(timeout=0.3)
        got_earliest = []
        while len(got_earliest) < 2:
            got_earliest.extend(await earliest.read(timeout=0.3))
        assert [r.value for r in got_latest] == ["new"]
        assert [r.value for r in got_earliest] == ["old", "new"]
        await latest.close()
        await earliest.close()

    _run(main())


# ---------------------------------------------------------------------------
# full pipeline over `type: kafka` (wire runtime registers when no SDK)
# ---------------------------------------------------------------------------

PIPELINE = """
topics:
  - name: "input-topic"
    creation-mode: create-if-not-exists
  - name: "output-topic"
    creation-mode: create-if-not-exists
pipeline:
  - name: "convert"
    type: "document-to-json"
    input: "input-topic"
    output: "output-topic"
    configuration:
      text-field: "question"
"""


def _kafka_instance(port: int) -> str:
    return f"""
instance:
  streamingCluster:
    type: "kafka"
    configuration:
      client: "wire"
      admin:
        bootstrap.servers: "127.0.0.1:{port}"
"""


async def _pipeline_over_kafka(runner_cls, app_dir, port):
    runner = runner_cls.from_directory(app_dir, instance=_kafka_instance(port))
    async with runner:
        await runner.produce("input-topic", "hello wire kafka", headers={"s": "1"})
        msgs = await runner.wait_for_messages("output-topic", 1, timeout=30)
    return [(m.value, [h for h in m.headers if h[0] == "s"]) for m in msgs]


def test_end_to_end_pipeline_over_wire_kafka(tmp_path, broker, run_async):
    """The dev-mode pipeline over the port's kafka wire runtime, its topics
    made by the runner's setup (the JAX case's ``compute`` step is not
    ported: ``document-to-json`` alone)."""
    from langstream_tpu_torch.runtime import LocalApplicationRunner

    (tmp_path / "pipeline.yaml").write_text(PIPELINE)
    got = run_async(_pipeline_over_kafka(LocalApplicationRunner, tmp_path, broker.port))
    assert got == [({"question": "hello wire kafka"}, [("s", "1")])]
    assert "input-topic" in broker.topics and "output-topic" in broker.topics


def test_pipeline_equals_the_jax_runner_over_kafka(tmp_path, run_async):
    """The same pipeline through each package's runner over its own wire
    runtime, each on its own fake broker: equal outputs and equal topics."""
    from langstream_tpu.runtime import LocalApplicationRunner as JaxRunner
    from langstream_tpu_torch.runtime import LocalApplicationRunner as PortRunner

    (tmp_path / "pipeline.yaml").write_text(PIPELINE)
    out = {}
    for name, runner_cls, fake in (("jax", JaxRunner, jax_fake.FakeKafkaBroker),
                                   ("port", PortRunner, FakeKafkaBroker)):
        with fake() as b:
            out[name] = (run_async(_pipeline_over_kafka(runner_cls, tmp_path, b.port)),
                         {t: len(parts) for t, parts in b.topics.items()})
    assert out["port"] == out["jax"]


def test_client_selection_knob(broker):
    """`client:` picks the backend: wire forced, sdk unavailable errors,
    bad values rejected (the registry always routes type: kafka here)."""
    from langstream_tpu_torch.api.topics import TopicConnectionsRuntimeRegistry
    from langstream_tpu_torch.runtime.kafka_wire_runtime import (
        KafkaTopicConnectionsRuntimeSelector,
        WireKafkaTopicConnectionsRuntime,
    )

    assert (
        TopicConnectionsRuntimeRegistry._factories["kafka"]
        is KafkaTopicConnectionsRuntimeSelector
    )
    base = {"admin": {"bootstrap.servers": f"127.0.0.1:{broker.port}"}}

    rt = KafkaTopicConnectionsRuntimeSelector()
    rt.init({**base, "client": "wire"})
    assert isinstance(rt._backend, WireKafkaTopicConnectionsRuntime)

    # auto without confluent_kafka installed → wire
    rt2 = KafkaTopicConnectionsRuntimeSelector()
    rt2.init(base)
    assert isinstance(rt2._backend, WireKafkaTopicConnectionsRuntime)

    with pytest.raises(RuntimeError, match="confluent_kafka"):
        KafkaTopicConnectionsRuntimeSelector().init({**base, "client": "sdk"})
    with pytest.raises(ValueError, match="not supported"):
        KafkaTopicConnectionsRuntimeSelector().init({**base, "client": "zzz"})


def test_conn_redials_after_broker_drops_idle_connection():
    """Brokers close idle connections (connections.max.idle.ms): a dead
    socket must fail the in-flight call but never poison the connection —
    the next call redials and succeeds."""
    from langstream_tpu_torch.runtime.kafka_wire import API_API_VERSIONS, _Conn

    async def main():
        calls = {"n": 0}

        async def serve(reader, writer):
            # serve exactly one request per connection, then slam it shut
            import struct as _s

            try:
                (size,) = _s.unpack(">i", await reader.readexactly(4))
                frame = await reader.readexactly(size)
                r = Reader(frame)
                r.i16(); r.i16()
                cid = r.i32()
                calls["n"] += 1
                body = Writer().i32(cid).i16(0).i32(0).done()
                writer.write(_s.pack(">i", len(body)) + body)
                await writer.drain()
            finally:
                writer.close()

        server = await asyncio.start_server(serve, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        conn = _Conn("127.0.0.1", port, "t")
        r1 = await conn.call(API_API_VERSIONS, 0, b"")
        assert r1.i16() == 0
        # the server closed the socket after responding; this call hits the
        # dead connection, fails, AND drops the writer
        with pytest.raises((OSError, asyncio.IncompleteReadError, ConnectionError)):
            await conn.call(API_API_VERSIONS, 0, b"")
        assert conn._writer is None  # poisoned socket was dropped
        # redial transparently
        r3 = await conn.call(API_API_VERSIONS, 0, b"")
        assert r3.i16() == 0
        assert calls["n"] >= 2
        await conn.close()
        server.close()
        await server.wait_closed()

    _run(main())


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

BATCHES = [
    [(b"k1", b"v1", [("h", b"x"), ("n", None)]), (None, b"v2", []), (b"k3", None, [("a", b"")])],
    [(None, b"", [])],
    [(f"key-{i}".encode(), bytes(range(i % 256)) * 3, [("i", str(i).encode())])
     for i in range(40)],
]


@pytest.mark.parametrize("compression", [None, "gzip"])
@pytest.mark.parametrize("case", range(len(BATCHES)))
def test_record_batch_bytes_equal_the_jax_encoder(case, compression):
    records = BATCHES[case]
    ours = port_wire.encode_record_batch(records, 1_700_000_000_123, compression)
    theirs = jax_wire.encode_record_batch(records, 1_700_000_000_123, compression)
    assert ours == theirs

    def fields(decoded):
        return [(r.offset, r.timestamp, r.key, r.value, r.headers) for r in decoded]

    # each package decodes the other's batch (two back to back: a record set)
    assert fields(port_wire.decode_record_batches(theirs + theirs)) == fields(
        jax_wire.decode_record_batches(ours + ours))
    assert [(r.key, r.value, r.headers) for r in port_wire.decode_record_batches(theirs)] == [
        (k, v, h) for k, v, h in records]


def test_group_codecs_and_assignor_equal_the_jax_ones():
    topics = ["b", "a", "c"]
    assert port_wire.encode_subscription(topics) == jax_wire.encode_subscription(topics)
    parts = {"a": [2, 0, 1], "b": [5]}
    assert port_wire.encode_assignment(parts) == jax_wire.encode_assignment(parts)
    assert port_wire.decode_assignment(jax_wire.encode_assignment(parts)) == \
        jax_wire.decode_assignment(port_wire.encode_assignment(parts))
    subs = {"m-2": ["a", "b"], "m-1": ["a"], "m-3": ["a", "b"]}
    partitions = {"a": list(range(7)), "b": [0, 1]}
    assert port_wire.range_assign(subs, partitions) == jax_wire.range_assign(subs, partitions)


def test_the_jax_client_against_the_port_fake():
    """The JAX package's client on the port's fake broker: topic lifecycle,
    produce and fetch, commit and fetch of offsets."""
    async def main():
        client = jax_wire.KafkaWireClient(f"127.0.0.1:{b.port}")
        try:
            await client.create_topic("x", partitions=2)
            assert await client.partitions_for("x") == [0, 1]
            for i in range(3):
                assert await client.produce(
                    "x", 1, [(b"k", f"v{i}".encode(), [("h", b"1")])], 1000 + i,
                    compression="gzip" if i else None) == i
            records, hw = await client.fetch("x", 1, 1)
            assert hw == 3
            assert [(r.offset, r.value, r.headers) for r in records] == [
                (1, b"v1", [("h", b"1")]), (2, b"v2", [("h", b"1")])]
            await client.offset_commit("g", {("x", 0): 4, ("x", 1): 2})
            assert await client.offset_fetch("g", "x", [0, 1]) == {0: 4, 1: 2}
            await client.delete_topic("x")
        finally:
            await client.close()

    with FakeKafkaBroker() as b:
        _run(main())
        # the batches went through the port fake's own parser and CRC check
        assert (port_wire.API_PRODUCE, 3) in b.requests


def test_the_client_sends_only_the_versions_it_declares(broker):
    """Every (api key, version) the broker saw from a client exercising
    every API is one of ``API_VERSIONS_SPOKEN``, which both fakes answer."""
    from langstream_tpu_torch.runtime.kafka_wire_runtime import GroupMembership

    async def main():
        client = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            await client.api_versions()
            await client.create_topic("v", partitions=1)
            await client.produce("v", 0, [(None, b"x", [])], 0)
            await client.fetch("v", 0, 0, max_wait_ms=10)
            await client.list_offsets("v", 0, -1)
            await client.offset_commit("g", {("v", 0): 1})
            await client.offset_fetch("g", "v", [0])
            member = GroupMembership(client, "dyn", ["v"])
            await member.join()
            await client.heartbeat("dyn", member.generation, member.member_id)
            await member.leave()
            await client.delete_topic("v")
        finally:
            await client.close()

    _run(main())
    seen = set(broker.requests)
    assert seen <= set(port_wire.API_VERSIONS_SPOKEN.items())
    assert {k for k, _ in seen} == set(port_wire.API_VERSIONS_SPOKEN) - {
        port_wire.API_SASL_HANDSHAKE, port_wire.API_SASL_AUTHENTICATE}
    for key, version in port_wire.API_VERSIONS_SPOKEN.items():
        assert any(k == key and lo <= version <= hi
                   for k, lo, hi in torch_fake_kafka.SUPPORTED_APIS)


def test_the_port_fake_holds_an_empty_fetch_until_a_record_lands():
    async def main(port):
        client = KafkaWireClient(f"127.0.0.1:{port}")
        writer = KafkaWireClient(f"127.0.0.1:{port}")
        try:
            await client.create_topic("w", partitions=1)
            loop = asyncio.get_running_loop()
            t = loop.time()
            assert (await client.fetch("w", 0, 0, max_wait_ms=300))[0] == []
            held = loop.time() - t
            t = loop.time()
            fetch = asyncio.ensure_future(client.fetch("w", 0, 0, max_wait_ms=5000))
            await asyncio.sleep(0.2)
            await writer.produce("w", 0, [(None, b"now", [])], 0)
            records, _ = await fetch
            woke = loop.time() - t
        finally:
            await client.close()
            await writer.close()
        return held, woke, [r.value for r in records]

    with FakeKafkaBroker() as b:
        held, woke, values = _run(main(b.port))
    assert held >= 0.25
    assert values == [b"now"] and woke < 2.0


def test_a_zstd_batch_without_zstandard_is_refused_by_name(monkeypatch):
    """The card's machine has no ``zstandard``: a zstd batch must fail with
    the JAX package's named error, in both packages alike."""
    import sys

    monkeypatch.setitem(sys.modules, "zstandard", None)
    for wire in (port_wire, jax_wire):
        with pytest.raises(wire.KafkaProtocolError,
                           match="zstd-compressed batch but the 'zstandard' package is "
                                 "not installed"):
            wire.decompress_records(4, b"\x28\xb5\x2f\xfd")
        with pytest.raises(wire.KafkaProtocolError, match="'lz4' package is not installed"):
            wire.decompress_records(3, b"\x04\x22\x4d\x18")
