"""The port's Kafka SDK runtime against a fake client, every case of
``tests/test_kafka_runtime.py``: a fake ``confluent_kafka`` in
``sys.modules`` (no Kafka client library is installed) and the adapter's
*semantics*, the part the reference unit-tests in ``KafkaConsumerTest.java``:
out-of-order acknowledgement with contiguous-prefix commits, serializer
inference, rebalance redelivery accounting. Then across the packages: the
on-wire form of a record (``record_wire_payload`` and
``kafka_message_to_record``) read back by the other package, both ways;
the trace header kept (``tests/test_tracing.py``'s Kafka case); the
selector's ``client: sdk`` with the client importable; and the mini-chat
example served by each package's runner and engine over Kafka at the tiny
model in f32, whose greedy answers must be equal.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
import types
from pathlib import Path

import pytest
import yaml

import fake_kafka as jax_fake
import torch_fake_kafka


# ---------------------------------------------------------------------------
# Fake confluent_kafka
# ---------------------------------------------------------------------------


class FakeTopicPartition:
    def __init__(self, topic, partition, offset=-1001):
        self.topic = topic
        self.partition = partition
        self.offset = offset

    def __repr__(self):
        return f"TP({self.topic}[{self.partition}]@{self.offset})"


class FakeMessage:
    def __init__(self, topic, partition, offset, value=None, key=None, headers=None):
        self._topic, self._partition, self._offset = topic, partition, offset
        self._value, self._key, self._headers = value, key, headers or []

    def topic(self):
        return self._topic

    def partition(self):
        return self._partition

    def offset(self):
        return self._offset

    def value(self):
        return self._value

    def key(self):
        return self._key

    def headers(self):
        return self._headers

    def timestamp(self):
        return (1, 1700000000000)

    def error(self):
        return None


class FakeConsumer:
    def __init__(self, conf):
        self.conf = conf
        self.queue: list[FakeMessage] = []
        self.commits: list[list[FakeTopicPartition]] = []
        self.on_assign = None
        self.on_revoke = None
        self.assigned = []
        self.closed = False

    def subscribe(self, topics, on_assign=None, on_revoke=None):
        self.on_assign = on_assign
        self.on_revoke = on_revoke
        tps = [FakeTopicPartition(t, 0, -1001) for t in topics]
        self.assigned = tps
        if on_assign:
            on_assign(self, tps)

    def consume(self, num, timeout):
        batch, self.queue = self.queue[:num], self.queue[num:]
        return batch

    def commit(self, offsets=None, asynchronous=True):
        self.commits.append(offsets)

    def close(self):
        self.closed = True

    # reader API
    def list_topics(self, topic, timeout=None):
        md = types.SimpleNamespace(
            topics={topic: types.SimpleNamespace(partitions={0: None, 1: None})}
        )
        return md

    def get_watermark_offsets(self, tp, timeout=None):
        return (2, 7)

    def assign(self, tps):
        self.assigned = tps


class FakeProducer:
    def __init__(self, conf):
        self.conf = conf
        self.sent = []
        self._pending = []

    def produce(self, topic, value=None, key=None, headers=None, on_delivery=None):
        self.sent.append((topic, value, key, headers))
        if on_delivery:
            self._pending.append(on_delivery)

    def poll(self, timeout):
        pending, self._pending = self._pending, []
        for cb in pending:
            cb(None, None)
        return len(pending)

    def flush(self):
        self.poll(0)


class FakeKafkaError(Exception):
    _PARTITION_EOF = -191


@pytest.fixture()
def fake_kafka(monkeypatch):
    mod = types.ModuleType("confluent_kafka")
    mod.Consumer = FakeConsumer
    mod.Producer = FakeProducer
    mod.TopicPartition = FakeTopicPartition
    mod.KafkaError = FakeKafkaError
    admin = types.ModuleType("confluent_kafka.admin")

    class FakeAdminClient:
        created, deleted = [], []

        def __init__(self, conf):
            pass

        def create_topics(self, topics):
            FakeAdminClient.created.extend(topics)
            fut = types.SimpleNamespace(result=lambda: None)
            return {t.topic: fut for t in topics}

        def delete_topics(self, names):
            FakeAdminClient.deleted.extend(names)
            fut = types.SimpleNamespace(result=lambda: None)
            return {n: fut for n in names}

    class FakeNewTopic:
        def __init__(self, topic, num_partitions=1, replication_factor=1):
            self.topic = topic
            self.num_partitions = num_partitions
            self.replication_factor = replication_factor

    admin.AdminClient = FakeAdminClient
    admin.NewTopic = FakeNewTopic
    mod.admin = admin
    monkeypatch.setitem(sys.modules, "confluent_kafka", mod)
    monkeypatch.setitem(sys.modules, "confluent_kafka.admin", admin)
    return mod


# ---------------------------------------------------------------------------
# Pure tracker semantics
# ---------------------------------------------------------------------------


def test_tracker_contiguous_prefix_only():
    from langstream_tpu_torch.runtime.kafka_broker import ContiguousOffsetTracker

    t = ContiguousOffsetTracker()
    t.start_partition("in", 0, 0)
    for off in range(5):
        t.delivered("in", 0, off)
    # acks arrive out of order: 2, 1 → no commit yet (0 still pending)
    assert t.acknowledge("in", 0, 2) is None
    assert t.acknowledge("in", 0, 1) is None
    assert t.pending("in", 0) == 3
    # ack 0 → prefix [0,1,2] done → position 3
    assert t.acknowledge("in", 0, 0) == 3
    # ack 4 → gap at 3 → no advance
    assert t.acknowledge("in", 0, 4) is None
    assert t.acknowledge("in", 0, 3) == 5
    assert t.pending("in", 0) == 0


def test_tracker_duplicate_and_stale_acks():
    from langstream_tpu_torch.runtime.kafka_broker import ContiguousOffsetTracker

    t = ContiguousOffsetTracker()
    t.start_partition("in", 0, 10)
    t.delivered("in", 0, 10)
    assert t.acknowledge("in", 0, 9) is None  # below committed position
    assert t.acknowledge("in", 0, 10) == 11
    assert t.acknowledge("in", 0, 10) is None  # duplicate ack is a no-op


# ---------------------------------------------------------------------------
# Consumer wrapper
# ---------------------------------------------------------------------------


def _consumer(fake_kafka, **kw):
    from langstream_tpu_torch.runtime.kafka_broker import KafkaTopicConsumer

    return KafkaTopicConsumer(
        {"bootstrap.servers": "fake:9092"}, topic="in", group="app-agent", **kw
    )


def test_consumer_out_of_order_commit(fake_kafka):
    async def run():
        c = _consumer(fake_kafka)
        await c.start()
        fake = c._consumer
        fake.queue = [
            FakeMessage("in", 0, i, value=f"v{i}".encode()) for i in range(4)
        ]
        records = await c.read()
        assert [r.value for r in records] == ["v0", "v1", "v2", "v3"]

        # commit 2 and 3 first: no broker commit (0,1 outstanding)
        await c.commit([records[2], records[3]])
        assert fake.commits == []
        # commit 0: prefix [0] → broker commit at position 1
        await c.commit([records[0]])
        assert len(fake.commits) == 1
        (tp,) = fake.commits[0]
        assert (tp.topic, tp.partition, tp.offset) == ("in", 0, 1)
        # commit 1: closes the gap → position 4
        await c.commit([records[1]])
        (tp,) = fake.commits[1]
        assert tp.offset == 4
        await c.close()
        assert fake.closed

    asyncio.run(run())


def test_consumer_resume_past_offset_zero(fake_kafka):
    """On a normal rebalance tp.offset is OFFSET_INVALID (-1001); the tracker
    must adopt the first delivered offset (the group's committed position),
    not 0 — otherwise commits wedge forever after a restart."""

    async def run():
        c = _consumer(fake_kafka)
        await c.start()
        fake = c._consumer
        # group resumes at committed offset 100
        fake.queue = [FakeMessage("in", 0, off) for off in (100, 101)]
        records = await c.read()
        await c.commit([records[1]])  # out of order: no commit yet
        assert fake.commits == []
        await c.commit([records[0]])
        (tp,) = fake.commits[0]
        assert tp.offset == 102

    asyncio.run(run())


def test_consumer_rebalance_redelivery_accounting(fake_kafka):
    async def run():
        c = _consumer(fake_kafka)
        await c.start()
        fake = c._consumer
        fake.queue = [FakeMessage("in", 0, i) for i in range(3)]
        records = await c.read()
        await c.commit([records[0]])
        assert c.tracker.pending("in", 0) == 2
        # revoke: in-flight records are dropped from tracking (they will be
        # redelivered from the committed position to the next assignee)
        fake.on_revoke(fake, [FakeTopicPartition("in", 0)])
        assert c.tracker.pending("in", 0) == 0

    asyncio.run(run())


# ---------------------------------------------------------------------------
# Producer serde inference
# ---------------------------------------------------------------------------


def test_producer_serializer_inference(fake_kafka):
    from langstream_tpu_torch.api.record import make_record
    from langstream_tpu_torch.api.topics import OFFSET_HEADER, TopicOffset
    from langstream_tpu_torch.runtime.kafka_broker import KafkaTopicProducer

    async def run():
        p = KafkaTopicProducer({"bootstrap.servers": "fake:9092"}, topic="out")
        await p.start()
        rec = make_record(
            value={"answer": 42},
            key="k1",
            headers={
                "session": "s-1",
                OFFSET_HEADER: TopicOffset("in", 0, 7),
            },
        )
        await p.write(rec)
        topic, value, key, headers = p._producer.sent[0]
        assert topic == "out"
        assert json.loads(value) == {"answer": 42}
        assert key == b"k1"
        hdr_names = [h[0] for h in headers]
        assert "session" in hdr_names and OFFSET_HEADER not in hdr_names
        assert p.total_in() == 1
        await p.close()

    asyncio.run(run())


def test_structured_values_and_headers_roundtrip(fake_kafka):
    """dict values, typed headers and None headers survive the byte wire."""
    from langstream_tpu_torch.api.record import make_record
    from langstream_tpu_torch.runtime.kafka_broker import (
        kafka_message_to_record,
        record_headers_to_kafka,
        serialize_datum_kind,
        HEADER_KINDS_HEADER,
        KEY_KIND_HEADER,
        VALUE_KIND_HEADER,
    )

    rec = make_record(
        value={"q": "hi"},
        key=7,
        headers={"retries": 3, "meta": {"a": 1}, "empty": None, "s": "x"},
    )
    value, vkind = serialize_datum_kind(rec.value)
    key, kkind = serialize_datum_kind(rec.key)
    headers = record_headers_to_kafka(rec)
    headers.append((VALUE_KIND_HEADER, vkind.encode()))
    headers.append((KEY_KIND_HEADER, kkind.encode()))
    msg = FakeMessage("t", 0, 5, value=value, key=key, headers=headers)
    out = kafka_message_to_record(msg)
    assert out.value == {"q": "hi"}
    assert out.key == 7
    hdrs = out.header_map()
    assert hdrs["retries"] == 3
    assert hdrs["meta"] == {"a": 1}
    assert hdrs["empty"] is None
    assert hdrs["s"] == "x"
    assert HEADER_KINDS_HEADER not in hdrs


def test_serde_roundtrip_types():
    from langstream_tpu_torch.runtime.kafka_broker import (
        deserialize_datum,
        serialize_datum,
    )

    assert serialize_datum(None) is None
    assert serialize_datum(b"\x00\x01") == b"\x00\x01"
    assert serialize_datum("hi") == b"hi"
    assert json.loads(serialize_datum([1, 2])) == [1, 2]
    assert deserialize_datum(b"text") == "text"
    assert deserialize_datum(b"\xff\xfe") == b"\xff\xfe"


# ---------------------------------------------------------------------------
# Reader + admin + registry
# ---------------------------------------------------------------------------


def test_reader_assigns_at_watermarks(fake_kafka):
    from langstream_tpu_torch.runtime.kafka_broker import KafkaTopicReader

    async def run():
        r = KafkaTopicReader(
            {"bootstrap.servers": "fake:9092"}, "out", initial_position="latest"
        )
        await r.start()
        offsets = {(tp.partition): tp.offset for tp in r._consumer.assigned}
        assert offsets == {0: 7, 1: 7}  # high watermark
        await r.close()

        r2 = KafkaTopicReader(
            {"bootstrap.servers": "fake:9092"}, "out", initial_position="earliest"
        )
        await r2.start()
        offsets = {(tp.partition): tp.offset for tp in r2._consumer.assigned}
        assert offsets == {0: 2, 1: 2}  # low watermark
        await r2.close()

    asyncio.run(run())


def test_admin_create_delete(fake_kafka):
    from langstream_tpu_torch.runtime.kafka_broker import KafkaTopicAdmin

    async def run():
        admin = KafkaTopicAdmin({"bootstrap.servers": "fake:9092"})
        await admin.create_topic("t1", partitions=4)
        created = fake_kafka.admin.AdminClient.created
        assert created[-1].topic == "t1" and created[-1].num_partitions == 4
        await admin.delete_topic("t1")
        assert fake_kafka.admin.AdminClient.deleted[-1] == "t1"

    asyncio.run(run())


def test_runtime_wires_configuration(fake_kafka):
    from langstream_tpu_torch.runtime.kafka_broker import KafkaTopicConnectionsRuntime

    rt = KafkaTopicConnectionsRuntime()
    rt.init(
        {
            "admin": {"bootstrap.servers": "broker:9092"},
            "consumer": {"max.poll.records": 10},
        }
    )
    c = rt.create_consumer("app-agent1", {"topic": "in"})
    assert c._conf["bootstrap.servers"] == "broker:9092"
    assert c._conf["max.poll.records"] == 10
    assert c._conf["group.id"] == "app-agent1"
    p = rt.create_producer("app-agent1", {"topic": "out"})
    assert p._conf["bootstrap.servers"] == "broker:9092"
    # dead-letter producer targets <topic>-deadletter
    dl = rt.create_deadletter_producer("app-agent1", {"topic": "in"})
    assert dl.topic == "in-deadletter"


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

RECORDS = [
    ({"q": "hi", "n": [1, 2]}, "k", {"s": "x", "retries": 3, "meta": {"a": 1}, "empty": None}),
    ("plain", None, {}),
    (b"\x00\xff raw", b"\x80", {"b": b"\x01\x02", "f": 1.5, "t": True}),
    (None, 7, {"langstream-client-session-id": "s1"}),
    ([1, "two"], {"k": 1}, {"n": -4}),
]


def _as_message(payload, offset=3):
    key, value, headers = payload
    return FakeMessage("t", 2, offset, value=value, key=key, headers=list(headers))


def _fields(record):
    """(value, key, headers but the offset, origin, the offset as a tuple)."""
    headers = record.header_map()
    offset = headers.pop("__offset")
    return (record.value, record.key, headers, record.origin,
            (offset.topic, offset.partition, offset.offset))


@pytest.mark.parametrize("case", range(len(RECORDS)))
def test_wire_form_equals_the_jax_one_both_ways(case):
    from langstream_tpu.api.record import make_record as jax_make_record
    from langstream_tpu.runtime import kafka_broker as jax_kb
    from langstream_tpu_torch.api.record import make_record
    from langstream_tpu_torch.runtime import kafka_broker as port_kb

    value, key, headers = RECORDS[case]
    ours = port_kb.record_wire_payload(make_record(value=value, key=key, headers=headers))
    theirs = jax_kb.record_wire_payload(jax_make_record(value=value, key=key, headers=headers))
    assert ours == theirs
    back_ours = port_kb.kafka_message_to_record(_as_message(theirs))
    back_theirs = jax_kb.kafka_message_to_record(_as_message(ours))
    assert _fields(back_ours) == _fields(back_theirs)
    assert _fields(back_ours)[3:] == ("t", ("t", 2, 3))
    # bytes that are UTF-8 come back as text, in both packages
    assert _fields(back_ours)[:3] == (value, key, {
        k: v.decode() if isinstance(v, bytes) and v.isascii() else v
        for k, v in headers.items()})


def test_kafka_wire_format_preserves_trace_header():
    """``tests/test_tracing.py``'s Kafka case on the port: the shared
    on-wire form round-trips the ``langstream-trace`` header like any
    string header, and keeps dropping the transport-local ``__offset``."""
    from langstream_tpu_torch.api.record import make_record
    from langstream_tpu_torch.core.tracing import TRACE_HEADER, TraceContext
    from langstream_tpu_torch.runtime.kafka_broker import (
        kafka_message_to_record,
        record_wire_payload,
    )

    ctx = TraceContext.new()
    record = make_record(value={"q": "hi"}, headers={TRACE_HEADER: ctx.to_header(),
                                                    "__offset": "dropped"})
    key, value, headers = record_wire_payload(record)
    assert "__offset" not in dict(headers)
    back = kafka_message_to_record(FakeMessage("t", 0, 7, value=value, key=key,
                                               headers=headers))
    assert back.header(TRACE_HEADER) == ctx.to_header()
    assert back.value == {"q": "hi"}
    assert back.header("__offset").offset == 7


def test_selector_takes_the_sdk_when_it_imports(fake_kafka):
    from langstream_tpu_torch.runtime.kafka_broker import KafkaTopicConnectionsRuntime
    from langstream_tpu_torch.runtime.kafka_wire_runtime import (
        KafkaTopicConnectionsRuntimeSelector,
        WireKafkaTopicConnectionsRuntime,
    )

    base = {"admin": {"bootstrap.servers": "broker:9092"}}
    for client, backend in (("sdk", KafkaTopicConnectionsRuntime),
                            ("auto", KafkaTopicConnectionsRuntime),
                            ("wire", WireKafkaTopicConnectionsRuntime)):
        selector = KafkaTopicConnectionsRuntimeSelector()
        selector.init({**base, "client": client})
        assert type(selector._backend) is backend
        assert selector.create_consumer("a", {"topic": "in"}).topic == "in"


# -- the mini-chat example on both packages over Kafka ----------------------

REPO = Path(__file__).resolve().parents[1]
MINI_CHAT = REPO / "examples" / "applications" / "mini-chat"
TINY = {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 128,
        "checkpoint": str(REPO / "tests" / "fixtures" / "llama_tiny_golden"),
        "decode-chunk": 4, "decode-chunk-light": 2}
QUESTIONS = {"s1": "what is it?", "s2": "tell me a story"}


def _mini_chat_at_tiny(target: Path) -> Path:
    target.mkdir(parents=True, exist_ok=True)
    for name in ("pipeline.yaml", "gateways.yaml"):
        (target / name).write_text((MINI_CHAT / name).read_text())
    (target / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {
        "resources": [{"type": "tpu-serving-configuration", "name": "tpu",
                       "configuration": TINY}]}}))
    return target


async def _mini_chat_over_kafka(runner_cls, app_dir, port):
    from langstream_tpu.serving.engine import TpuServingEngine
    from langstream_tpu_torch.serving.engine import TorchServingEngine

    instance = yaml.safe_dump({"instance": {"streamingCluster": {"type": "kafka", "configuration": {
        "client": "wire", "admin": {"bootstrap.servers": f"127.0.0.1:{port}"}}}}})
    runner = runner_cls.from_directory(app_dir, instance=instance)
    try:
        async with runner:
            for session, question in QUESTIONS.items():
                await runner.produce("questions-topic", question,
                                     headers={"langstream-client-session-id": session})
            answers = await runner.wait_for_messages("answers-topic", len(QUESTIONS),
                                                     timeout=120)
            chunks = []
            for _ in range(200):
                chunks = await runner.wait_for_messages("stream-topic", 1)
                if sum(c.header("stream-last-message") == "true" for c in chunks) == \
                        len(QUESTIONS):
                    break
                await asyncio.sleep(0.05)
    finally:
        for cls in (TorchServingEngine, TpuServingEngine):
            engines = list(cls._instances.values())
            cls.reset_instances()
            for engine in engines:
                await engine.close()
    streams = {}
    for c in chunks:
        streams.setdefault(c.header("langstream-client-session-id"), []).append(
            (int(c.header("stream-index")), c.value, c.header("stream-last-message")))
    return ({a.header("langstream-client-session-id"): a.value["answer"] for a in answers},
            {k: sorted(v) for k, v in streams.items()})


def test_mini_chat_over_kafka_equals_the_jax_runner_and_engine(tmp_path, monkeypatch):
    """Each package's runner, engine and wire runtime, each on its own fake
    broker; the same HF fixture weights in f32, greedy: the answers and
    every stream chunk equal."""
    from langstream_tpu.runtime import LocalApplicationRunner as JaxRunner
    from langstream_tpu_torch.agents import services as port_services
    from langstream_tpu_torch.runtime import LocalApplicationRunner as PortRunner

    monkeypatch.setattr(port_services, "SERVING_DEVICE", "cpu")
    app_dir = _mini_chat_at_tiny(tmp_path / "mini-chat")
    out = {}
    for name, runner_cls, fake in (("jax", JaxRunner, jax_fake.FakeKafkaBroker),
                                   ("port", PortRunner, torch_fake_kafka.FakeKafkaBroker)):
        with fake() as b:
            out[name] = asyncio.run(_mini_chat_over_kafka(runner_cls, app_dir, b.port))
            if name == "port":
                # the stopped runner closed every client it opened, the
                # stream-to-topic producer too (the JAX runner leaves that
                # one open)
                for _ in range(100):
                    if not b.open_connections:
                        break
                    time.sleep(0.05)
                assert not b.open_connections, b.open_connections
    assert out["port"] == out["jax"]
    answers, streams = out["port"]
    assert set(answers) == set(QUESTIONS)
    for session, answer in answers.items():
        assert answer and answer == "".join(v for _, v, _ in streams[session])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_run_serves_mini_chat_over_the_fake_broker_process(tmp_path):
    """What the port's docs tell a user to run on the CPU: the fake broker
    as its own process (SCRAM-SHA-256), then ``python -m
    langstream_tpu_torch.cli run`` over a Kafka instance naming it; one
    question through the gateway; both processes exit 0 on SIGINT."""
    import os
    import signal
    import subprocess

    from langstream_tpu_torch.gateway.wire import WebSocketClient

    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONUNBUFFERED="1")
    broker_port, gateway_port = _free_port(), _free_port()
    broker = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_fake_kafka.py"), "--port",
         str(broker_port), "--scram", "cli-user", "cli-secret"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    run = None
    try:
        assert f"127.0.0.1:{broker_port}" in broker.stdout.readline()
        app = _mini_chat_at_tiny(tmp_path / "app")
        instance = tmp_path / "instance.yaml"
        instance.write_text(yaml.safe_dump({"instance": {"streamingCluster": {
            "type": "kafka", "configuration": {"client": "wire", "admin": {
                "bootstrap.servers": f"127.0.0.1:{broker_port}",
                "security.protocol": "SASL_PLAINTEXT", "sasl.mechanism": "SCRAM-SHA-256",
                "sasl.jaas.config": 'x required username="cli-user" password="cli-secret";',
            }}}}}))
        run = subprocess.Popen(
            [sys.executable, "-m", "langstream_tpu_torch.cli", "run", "mini", "-app", str(app),
             "-i", str(instance), "--device", "cpu", "--gateway-port", str(gateway_port),
             "--api-port", "0"],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        line = run.stdout.readline()
        assert "deployed" in line, (line, run.stderr.read() if run.poll() is not None else "")

        async def ask():
            base = f"ws://127.0.0.1:{gateway_port}/v1/%s/default/mini/%s?param:sessionId=c1"
            consumer = await WebSocketClient.connect(base % ("consume", "bot-output"))
            producer = await WebSocketClient.connect(base % ("produce", "user-input"))
            await producer.send_json({"value": "what is it?"})
            ack = await producer.receive_json(30)
            chunks = []
            while True:
                frame = await consumer.receive_json(60)
                chunks.append(frame["record"]["value"])
                if frame["record"]["headers"]["stream-last-message"] == "true":
                    break
            await producer.close()
            await consumer.close()
            return ack, "".join(chunks)

        ack, answer = asyncio.run(ask())
        assert ack["status"] == "OK" and answer
        run.send_signal(signal.SIGINT)
        out, err = run.communicate(timeout=60)
        assert run.returncode == 0, err[-4000:]
        assert "stopped" in out
    finally:
        for proc in (run, broker):
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGINT)
                try:
                    proc.communicate(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.communicate()
    assert broker.returncode == 0


COMMIT_AGENT = '''
class Upper:
    def process(self, record):
        if record.value == "bad":
            raise ValueError("a bad record")
        return [(record.value.upper(), record.key, None)]
'''
COMMIT_PIPELINE = """
topics:
  - name: "commit-in"
    creation-mode: create-if-not-exists
  - name: "commit-out"
    creation-mode: create-if-not-exists
errors:
  on-failure: skip
pipeline:
  - name: "upper"
    type: "python-processor"
    input: "commit-in"
    output: "commit-out"
    configuration: {className: "commit_agent.Upper"}
"""


async def _commits_over_kafka(runner_cls, app_dir, broker, values):
    instance = yaml.safe_dump({"instance": {"streamingCluster": {"type": "kafka", "configuration": {
        "client": "wire", "admin": {"bootstrap.servers": f"127.0.0.1:{broker.port}"}}}}})
    async with runner_cls.from_directory(app_dir, instance=instance) as runner:
        for value in values:
            await runner.produce("commit-in", value)
        out = await runner.wait_for_messages("commit-out", len(values) - 1, timeout=60)
        for _ in range(200):  # the commit follows the write
            if any(v == len(values) for k, v in broker.offsets.items() if k[1] == "commit-in"):
                break
            await asyncio.sleep(0.05)
    return sorted(m.value for m in out), dict(broker.offsets)


def test_a_kafka_source_commits_the_offsets_the_jax_runner_commits(tmp_path):
    """The port's runner hands a source back the records it read, not their
    trace-stamped copies: a Kafka source, which knows a record by its
    offset header, commits through it what it commits through the JAX
    runner, written and skipped records alike."""
    from langstream_tpu.runtime import LocalApplicationRunner as JaxRunner
    from langstream_tpu_torch.runtime import LocalApplicationRunner as PortRunner

    app = tmp_path / "app"
    (app / "python").mkdir(parents=True)
    (app / "python" / "commit_agent.py").write_text(COMMIT_AGENT)
    (app / "pipeline.yaml").write_text(COMMIT_PIPELINE)
    values = ["a", "b", "bad", "c", "d", "e"]
    out = {}
    for name, runner_cls, fake in (("jax", JaxRunner, jax_fake.FakeKafkaBroker),
                                   ("port", PortRunner, torch_fake_kafka.FakeKafkaBroker)):
        with fake() as broker:
            out[name] = asyncio.run(_commits_over_kafka(runner_cls, app, broker, values))
    assert out["port"] == out["jax"]
    written, offsets = out["port"]
    assert written == ["A", "B", "C", "D", "E"]
    assert [v for k, v in offsets.items() if k[1] == "commit-in"] == [len(values)]
