"""The port's tpustream broker and client against the JAX package's: the
cases of ``tests/test_tsb.py`` (contiguous commits, headers and bytes,
keyed partitions, rebalance failover, persistence across a restart, an
end-to-end pipeline) run once on each package's broker built from its own
copy of ``tsbroker.cc`` with that package's client; then one package's
producer feeds the other's consumer on one broker, both ways, and
``encode_record`` gives equal bytes for the same record."""

import asyncio
import shutil
import types

import pytest

import langstream_tpu.api.record as jax_record
import langstream_tpu.native as jax_native
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu.runtime.tsb as jax_tsb
import langstream_tpu_torch.api.record as port_record
import langstream_tpu_torch.native as port_native
import langstream_tpu_torch.runtime.local_runner as port_local
import langstream_tpu_torch.runtime.tsb as port_tsb

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

PACKAGES = {
    "jax": types.SimpleNamespace(make_record=jax_record.make_record, native=jax_native,
                                 tsb=jax_tsb, Runner=jax_local.LocalApplicationRunner,
                                 agent="compute"),
    "port": types.SimpleNamespace(make_record=port_record.make_record, native=port_native,
                                  tsb=port_tsb, Runner=port_local.LocalApplicationRunner,
                                  agent="document-to-json"),
}
SIDES = sorted(PACKAGES)


@pytest.fixture(params=SIDES)
def side(request):
    return request.param


@pytest.fixture
def pkg(side):
    return PACKAGES[side]


@pytest.fixture
def broker(pkg):
    with pkg.native.BrokerProcess() as b:
        yield b


def make_runtime(pkg, port):
    rt = pkg.tsb.TsbTopicConnectionsRuntime()
    rt.init({"bootstrap": f"127.0.0.1:{port}"})
    return rt


def test_the_port_builds_its_own_broker_from_its_own_source(tmp_path, monkeypatch):
    """The port's copy of the source is the JAX package's byte for byte; it
    builds under the port's build tree (``LS_TORCH_BUILD_DIR`` moves it),
    cached by the source's hash, and builds racing in one directory each
    get the binary (a build's prune removes stale builds, never another
    build's output in flight); a failed build raises with the compiler's
    error."""
    assert port_native.BROKER_SOURCE.read_bytes() == jax_native.BROKER_SOURCE.read_bytes()
    assert port_native.BROKER_SOURCE != jax_native.BROKER_SOURCE
    monkeypatch.setenv("LS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    binary = port_native.ensure_broker_binary()
    assert binary.parent == tmp_path / "build" / "tsbroker" and binary.exists()
    assert port_native.ensure_broker_binary() == binary  # cached
    binary.unlink()
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(lambda _: port_native.ensure_broker_binary(), range(4)))
    assert built == [binary] * 4 and binary.exists()
    assert sorted(p.name for p in binary.parent.iterdir()) == [binary.name]
    bad = tmp_path / "bad.cc"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(port_native, "BROKER_SOURCE", bad)
    with pytest.raises(port_native.NativeBuildError, match="tsbroker build failed"):
        port_native.ensure_broker_binary()


def test_produce_fetch_commit_contiguity(pkg, broker):
    async def main():
        rt = make_runtime(pkg, broker.port)
        admin = rt.create_topic_admin()
        await admin.create_topic("t", partitions=1)
        producer = rt.create_producer("p", {"topic": "t"})
        await producer.start()
        for i in range(5):
            await producer.write(pkg.make_record(value={"i": i}))
        consumer = rt.create_consumer("agent", {"topic": "t", "group": "g"})
        await consumer.start()
        records = []
        while len(records) < 5:
            records.extend(await consumer.read())
        assert [r.value["i"] for r in records] == [0, 1, 2, 3, 4]
        await consumer.commit([records[1], records[2]])  # watermark stays 0
        await consumer.commit([records[0]])  # contiguous prefix 0..2
        await consumer.close()
        consumer2 = rt.create_consumer("agent", {"topic": "t", "group": "g"})
        await consumer2.start()
        redelivered = []
        while len(redelivered) < 2:
            redelivered.extend(await consumer2.read())
        assert [r.value["i"] for r in redelivered] == [3, 4]
        await consumer2.close()
        await producer.close()
        await admin.close()

    asyncio.run(main())


def test_headers_and_bytes_roundtrip(pkg, broker):
    async def main():
        rt = make_runtime(pkg, broker.port)
        producer = rt.create_producer("p", {"topic": "rt"})
        await producer.start()
        await producer.write(pkg.make_record(value=b"\x00\x01binary", key="k1",
                                             headers={"h": b"\xff", "n": 3}))
        consumer = rt.create_consumer("agent", {"topic": "rt", "group": "g"})
        await consumer.start()
        got = []
        while not got:
            got.extend(await consumer.read())
        assert (got[0].value, got[0].key) == (b"\x00\x01binary", "k1")
        assert (got[0].header("h"), got[0].header("n")) == (b"\xff", 3)
        await consumer.close()
        await producer.close()

    asyncio.run(main())


def test_keyed_records_stable_partition(pkg, broker):
    async def main():
        rt = make_runtime(pkg, broker.port)
        admin = rt.create_topic_admin()
        await admin.create_topic("keyed", partitions=4)
        producer = rt.create_producer("p", {"topic": "keyed"})
        await producer.start()
        for i in range(12):
            await producer.write(pkg.make_record(value=i, key=f"user-{i % 3}"))
        consumer = rt.create_consumer("agent", {"topic": "keyed", "group": "g"})
        await consumer.start()
        records = []
        while len(records) < 12:
            records.extend(await consumer.read())
        by_key = {}
        for r in records:
            by_key.setdefault(r.key, []).append(r.value)
        assert all(values == sorted(values) for values in by_key.values()), by_key
        await consumer.close()
        await producer.close()
        await admin.close()

    asyncio.run(main())


def test_group_rebalance_failover(pkg, broker):
    async def main():
        rt = make_runtime(pkg, broker.port)
        admin = rt.create_topic_admin()
        await admin.create_topic("rb", partitions=2)
        c1 = rt.create_consumer("agent", {"topic": "rb", "group": "g"})
        await c1.start()
        assert len(c1._parts) == 2
        c2 = rt.create_consumer("agent", {"topic": "rb", "group": "g"})
        await c2.start()
        producer = rt.create_producer("p", {"topic": "rb"})
        await producer.start()
        for i in range(8):
            await producer.write(pkg.make_record(value=i, key=f"k{i}"))
        seen = []
        for _ in range(40):
            seen.extend(await c1.read())
            seen.extend(await c2.read())
            if len(seen) >= 8:
                break
        assert sorted(r.value for r in seen) == list(range(8))
        assert len(c1._parts) == 1 and len(c2._parts) == 1
        await c2.close()
        for _ in range(10):
            await c1.read()
            if len(c1._parts) == 2:
                break
        assert len(c1._parts) == 2
        await c1.close()
        await producer.close()
        await admin.close()

    asyncio.run(main())


def test_persistence_across_restart(pkg, tmp_path):
    data_dir = str(tmp_path / "broker-data")

    async def phase1(port):
        rt = make_runtime(pkg, port)
        admin = rt.create_topic_admin()
        await admin.create_topic("durable", partitions=2)
        producer = rt.create_producer("p", {"topic": "durable"})
        await producer.start()
        for i in range(6):
            await producer.write(pkg.make_record(value=i, key=f"k{i}"))
        consumer = rt.create_consumer("agent", {"topic": "durable", "group": "g"})
        await consumer.start()
        records = []
        while len(records) < 6:
            records.extend(await consumer.read())
        await consumer.commit(records)
        await consumer.close()
        await producer.close()
        await admin.close()

    async def phase2(port):
        rt = make_runtime(pkg, port)
        consumer = rt.create_consumer("agent", {"topic": "durable", "group": "g"})
        await consumer.start()
        assert await consumer.read() == []  # the commits survived
        await consumer.close()
        reader = rt.create_reader({"topic": "durable"}, initial_position="earliest")
        await reader.start()
        got = []
        for _ in range(10):
            got.extend(await reader.read(timeout=0.2))
            if len(got) >= 6:
                break
        assert sorted(r.value for r in got) == list(range(6))  # and the log
        await reader.close()

    with pkg.native.BrokerProcess(data_dir=data_dir) as b1:
        asyncio.run(phase1(b1.port))
    with pkg.native.BrokerProcess(data_dir=data_dir) as b2:
        asyncio.run(phase2(b2.port))


PIPELINES = {
    "compute": """
topics:
  - name: "input-topic"
    creation-mode: create-if-not-exists
  - name: "output-topic"
    creation-mode: create-if-not-exists
pipeline:
  - name: "upper"
    type: "compute"
    input: "input-topic"
    output: "output-topic"
    configuration:
      fields:
        - name: "value.upper"
          expression: "fn:uppercase(value.question)"
""",
    "document-to-json": """
topics:
  - name: "input-topic"
    creation-mode: create-if-not-exists
  - name: "output-topic"
    creation-mode: create-if-not-exists
pipeline:
  - name: "to-json"
    type: "document-to-json"
    input: "input-topic"
    output: "output-topic"
    configuration:
      text-field: "question"
""",
}


def test_end_to_end_pipeline_over_native_broker(pkg, tmp_path, broker):
    """The package's runner over its broker: an agent's output reaches the
    output topic (the JAX package's ``compute``; the port carries
    ``document-to-json`` among its agents)."""
    instance = f"""
instance:
  streamingCluster:
    type: "tpustream"
    configuration:
      bootstrap: "127.0.0.1:{broker.port}"
"""

    async def main():
        (tmp_path / "pipeline.yaml").write_text(PIPELINES[pkg.agent])
        runner = pkg.Runner.from_directory(tmp_path, instance=instance)
        async with runner:
            await runner.produce("input-topic", "hello tpu" if pkg.agent != "compute"
                                 else {"question": "hello tpu"})
            (msg,) = await runner.wait_for_messages("output-topic", 1)
        return msg.value

    value = asyncio.run(main())
    if pkg.agent == "compute":
        assert value["upper"] == "HELLO TPU"
    else:
        assert value == {"question": "hello tpu"}


RECORDS = [
    {"value": {"question": "q", "n": [1, 2.5, None]}, "key": "k",
     "headers": {"langstream-client-session-id": "s1", "stream-index": "3"}},
    {"value": b"\x00\xffraw", "key": b"\x01", "headers": {"h": b"\xfe"}},
    {"value": "text", "key": {"a": 1, "b": [2]}, "headers": {}},
    {"value": None, "key": None, "headers": {"n": 7}},
]


@pytest.mark.parametrize("case", range(len(RECORDS)))
def test_encode_record_gives_the_jax_bytes(case):
    spec = RECORDS[case]
    args = dict(value=spec["value"], key=spec["key"], headers=spec["headers"],
                origin="agent-1", timestamp=1_700_000_000_123)
    jax_rec = jax_record.make_record(**args)
    port_rec = port_record.make_record(**args)
    assert port_tsb.encode_record(port_rec) == jax_tsb.encode_record(jax_rec)
    routing, wire = jax_tsb.encode_record(jax_rec)
    back = port_tsb.decode_record(wire)
    assert (back.value, back.key, back.headers) == (jax_rec.value, jax_rec.key,
                                                     tuple(jax_rec.headers))


@pytest.mark.parametrize("producer_side,consumer_side", [("jax", "port"), ("port", "jax")])
def test_one_packages_producer_feeds_the_others_consumer(producer_side, consumer_side):
    """On one broker (the producer's package's), one package's producer and
    the other's consumer group and reader: the records, keys, headers and
    bytes arrive as written, and the consumer's commits hold."""
    prod, cons = PACKAGES[producer_side], PACKAGES[consumer_side]

    async def main(port):
        admin = make_runtime(cons, port).create_topic_admin()
        await admin.create_topic("x", partitions=2)
        producer = make_runtime(prod, port).create_producer("p", {"topic": "x"})
        await producer.start()
        for i in range(6):
            await producer.write(prod.make_record(
                value={"i": i, "raw": b"\x00" * i}, key=f"k{i % 2}",
                headers={"session": f"s{i}", "b": b"\xff"}))
        rt = make_runtime(cons, port)
        consumer = rt.create_consumer("agent", {"topic": "x", "group": "g"})
        await consumer.start()
        got = []
        while len(got) < 6:
            got.extend(await consumer.read())
        await consumer.commit(got)
        await consumer.close()
        again = rt.create_consumer("agent", {"topic": "x", "group": "g"})
        await again.start()
        assert await again.read() == []
        await again.close()
        reader = rt.create_reader({"topic": "x"}, initial_position="earliest")
        await reader.start()
        seen = []
        for _ in range(10):
            seen.extend(await reader.read(timeout=0.2))
            if len(seen) >= 6:
                break
        await reader.close()
        await producer.close()
        await admin.close()
        return got, seen

    with prod.native.BrokerProcess() as b:
        got, seen = asyncio.run(main(b.port))
    for records in (got, seen):
        by_i = {r.value["i"]: r for r in records}
        assert sorted(by_i) == list(range(6))
        for i, r in by_i.items():
            assert r.value["raw"] == b"\x00" * i and r.key == f"k{i % 2}"
            assert (r.header("session"), r.header("b")) == (f"s{i}", b"\xff")
