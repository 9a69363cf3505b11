"""The port's runtime against the JAX package's, on the same inputs: the
in-memory broker's offsets (contiguous commits, redelivery, rebalance,
key routing), the agent runner's delivery through composite nodes, its
error policies (retries, skip, dead-letter, fail) and the mock provider's
agents, and the slice end to end: the chat-completions example under each
package's runner and engine at the tiny model in f32, whose answers-topic
values and stream-topic chunks must be equal (greedy f32: exact).

Partitions are picked by ``hash(key)``, which Python salts per process, so
records are compared per topic, never by the partition they landed in."""

import asyncio
import itertools
import types
from pathlib import Path

import pytest
import yaml

import langstream_tpu.api.agent as jax_agent
import langstream_tpu.api.record as jax_record
import langstream_tpu.api.registry as jax_registry
import langstream_tpu.core.planner as jax_planner
import langstream_tpu.runtime.local_runner as jax_local
import langstream_tpu.runtime.memory_broker as jax_broker
import langstream_tpu_torch.api.agent as port_agent
import langstream_tpu_torch.api.record as port_record
import langstream_tpu_torch.api.registry as port_registry
import langstream_tpu_torch.core.planner as port_planner
import langstream_tpu_torch.runtime.local_runner as port_local
import langstream_tpu_torch.runtime.memory_broker as port_broker
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.serving.engine import TorchServingEngine

REPO = Path(__file__).resolve().parents[1]
CHAT_APP = REPO / "examples" / "applications" / "chat-completions"
FIXTURE = str(REPO / "tests" / "fixtures" / "llama_tiny_golden")

PACKAGES = {
    "jax": types.SimpleNamespace(
        make_record=jax_record.make_record, Runtime=jax_broker.MemoryTopicConnectionsRuntime,
        Broker=jax_broker.MemoryBroker, Runner=jax_local.LocalApplicationRunner,
        registry=jax_registry.AgentCodeRegistry, planner=jax_planner,
        SingleRecordProcessor=jax_agent.SingleRecordProcessor),
    "port": types.SimpleNamespace(
        make_record=port_record.make_record, Runtime=port_broker.MemoryTopicConnectionsRuntime,
        Broker=port_broker.MemoryBroker, Runner=port_local.LocalApplicationRunner,
        registry=port_registry.AgentCodeRegistry, planner=port_planner,
        SingleRecordProcessor=port_agent.SingleRecordProcessor),
}
_CLUSTERS = itertools.count()


def _instance(cluster: str) -> str:
    return yaml.safe_dump({"instance": {"streamingCluster": {
        "type": "memory", "configuration": {"cluster": cluster}}}})


def _runtime(pkg, cluster):
    rt = pkg.Runtime()
    rt.init({"cluster": cluster})
    return rt


def on_both(scenario):
    """Run ``scenario(pkg, cluster)`` under each package on its own broker
    cluster; return ``(jax_result, port_result)``."""
    out = []
    for name in ("jax", "port"):
        cluster = f"rt-{name}-{next(_CLUSTERS)}"
        try:
            out.append(asyncio.run(scenario(PACKAGES[name], cluster)))
        finally:
            PACKAGES[name].Broker.reset(cluster)
    return tuple(out)


# ---------------------------------------------------------------------------
# the broker
# ---------------------------------------------------------------------------

async def _read(consumer, n):
    records = []
    for _ in range(200):
        if len(records) >= n:
            break
        records.extend(await consumer.read())
    return records


async def _contiguous_commit(pkg, cluster):
    rt = _runtime(pkg, cluster)
    await rt.create_topic_admin().create_topic("t", partitions=1)
    producer = rt.create_producer("p", {"topic": "t"})
    for i in range(6):
        await producer.write(pkg.make_record(value=i))
    consumer = rt.create_consumer("g", {"topic": "t", "group": "g"})
    await consumer.start()
    records = await _read(consumer, 6)
    state = pkg.Broker.get(cluster).topic("t").group_state("g", 0)
    steps = []
    for acked in ([1, 2], [0], [5], [3, 4]):
        await consumer.commit([records[i] for i in acked])
        steps.append(state.committed)
    await consumer.close()
    return [r.value for r in records], steps


async def _redelivery(pkg, cluster):
    rt = _runtime(pkg, cluster)
    producer = rt.create_producer("p", {"topic": "t"})
    for i in range(4):
        await producer.write(pkg.make_record(value=i))
    consumer = rt.create_consumer("g", {"topic": "t", "group": "g"})
    await consumer.start()
    records = await _read(consumer, 4)
    await consumer.commit([records[0], records[2]])
    await consumer.close()
    again = rt.create_consumer("g", {"topic": "t", "group": "g"})
    await again.start()
    redelivered = await _read(again, 3)
    await again.close()
    return [r.value for r in redelivered]


async def _rebalance(pkg, cluster):
    rt = _runtime(pkg, cluster)
    await rt.create_topic_admin().create_topic("t", partitions=4)
    c1 = rt.create_consumer("g", {"topic": "t", "group": "g"})
    c2 = rt.create_consumer("g", {"topic": "t", "group": "g"})
    await c1.start()
    sizes = [(len(c1.assigned), len(c2.assigned))]
    await c2.start()
    sizes.append((len(c1.assigned), len(c2.assigned)))
    await c2.close()
    sizes.append((len(c1.assigned), len(c2.assigned)))
    await c1.close()
    return sizes


async def _key_routing(pkg, cluster):
    rt = _runtime(pkg, cluster)
    await rt.create_topic_admin().create_topic("t", partitions=4)
    producer = rt.create_producer("p", {"topic": "t"})
    for i in range(24):
        await producer.write(pkg.make_record(value=i, key=f"k{i % 3}"))
    for i in range(8):
        await producer.write(pkg.make_record(value=100 + i))
    topic = pkg.Broker.get(cluster).topic("t")
    by_key = {}
    for p in topic.partitions:
        for r in p.records:
            if r.key is not None:
                by_key.setdefault(r.key, set()).add(p.index)
    keyless = sorted(len([r for r in p.records if r.key is None]) for p in topic.partitions)
    reader = rt.create_reader({"topic": "t"}, initial_position="earliest")
    await reader.start()
    everything = await reader.read(timeout=0)
    return ({k: len(v) for k, v in by_key.items()}, keyless,
            sorted(r.value for r in everything))


@pytest.mark.parametrize("scenario", [_contiguous_commit, _redelivery, _rebalance, _key_routing],
                         ids=["contiguous-commit", "redelivery", "rebalance", "key-routing"])
def test_broker_equals_the_jax_broker(scenario):
    jax_result, port_result = on_both(scenario)
    assert port_result == jax_result


# ---------------------------------------------------------------------------
# the runner: delivery, composites, error policies
# ---------------------------------------------------------------------------

ATTEMPTS: dict = {}


def _flaky_class(pkg):
    class Flaky(pkg.SingleRecordProcessor):
        """``test-flaky``: fails a record whose ``value.fail`` is above its
        attempt count so far, then passes it on, doubled."""

        async def process_record(self, record):
            value = record.value
            key = (id(pkg), value["id"])
            ATTEMPTS[key] = ATTEMPTS.get(key, 0) + 1
            if ATTEMPTS[key] <= value.get("fail", 0):
                raise ValueError(f"record {value['id']} failed")
            return [record.with_value({**value, "doubled": value["id"] * 2})]

    return Flaky


@pytest.fixture(scope="module", autouse=True)
def _flaky_agent_type():
    """``test-flaky`` registered with both packages for this module only."""
    saved = {}
    for name, pkg in PACKAGES.items():
        pkg.registry.known_types()  # the built-ins first
        saved[name] = list(pkg.registry._providers)
        pkg.registry.register("test-flaky", _flaky_class(pkg))
        pkg.planner.register_agent_type(
            "test-flaky", pkg.planner.get_metadata("document-to-json").component_type)
    yield
    for name, pkg in PACKAGES.items():
        pkg.registry._reset_for_tests(saved[name])
        pkg.planner.AGENT_TYPE_METADATA.pop("test-flaky", None)


ERROR_APP = """
topics:
  - name: "input-topic"
    creation-mode: create-if-not-exists
  - name: "output-topic"
    creation-mode: create-if-not-exists
errors:
  on-failure: "{policy}"
  retries: {retries}
pipeline:
  - name: "detect"
    type: "language-detector"
    input: "input-topic"
  - name: "flaky"
    type: "test-flaky"
    output: "output-topic"
"""


def _records(records):
    return sorted(
        (repr(r.value), tuple(sorted((k, v) for k, v in r.headers
                                     if k.startswith("langstream-error"))))
        for r in records
    )


def _app_scenario(app_dir, inputs, topics, stop_raises=False):
    async def scenario(pkg, cluster):
        runner = pkg.Runner.from_directory(app_dir, instance=_instance(cluster))
        await runner.start()
        error = None
        got = {}
        try:
            for value in inputs:
                await runner.produce("input-topic", value)
            for topic, n in topics.items():
                got[topic] = _records(await runner.wait_for_messages(topic, n, timeout=20))
            await asyncio.sleep(0.2)
            info = [{k: i[k] for k in ("type", "records-in", "records-out", "errors",
                                       "pending")} for i in runner.agent_info()]
        finally:
            try:
                await runner.stop()
            except Exception as e:  # the fail policy surfaces here
                error = type(e).__name__, str(e)
        assert (error is not None) == stop_raises
        return got, info, error

    return scenario


POLICIES = [
    # policy, retries, inputs, expected topic counts
    ("skip", 0, [{"id": 1, "fail": 1}, {"id": 2}], {"output-topic": 1}),
    ("skip", 2, [{"id": 1, "fail": 2}, {"id": 2, "fail": 3}, {"id": 3}], {"output-topic": 2}),
    ("dead-letter", 0, [{"id": 1, "fail": 1}, {"id": 2}],
     {"output-topic": 1, "input-topic-deadletter": 1}),
    ("dead-letter", 1, [{"id": 1, "fail": 1}, {"id": 2, "fail": 5}, {"id": 3}],
     {"output-topic": 2, "input-topic-deadletter": 1}),
]


@pytest.mark.parametrize("policy,retries,inputs,topics", POLICIES,
                         ids=[f"{p}-{r}" for p, r, _, _ in POLICIES])
def test_error_policies_equal_the_jax_runner(tmp_path, policy, retries, inputs, topics):
    (tmp_path / "pipeline.yaml").write_text(ERROR_APP.format(policy=policy, retries=retries))
    ATTEMPTS.clear()
    jax_result, port_result = on_both(_app_scenario(tmp_path, inputs, topics))
    assert port_result == jax_result
    got, info, _ = port_result
    assert info[0]["type"] == "composite" and info[0]["pending"] == 0


def test_fail_policy_stops_the_replica_as_the_jax_runner_does(tmp_path):
    (tmp_path / "pipeline.yaml").write_text(ERROR_APP.format(policy="fail", retries=0))
    ATTEMPTS.clear()
    jax_result, port_result = on_both(_app_scenario(
        tmp_path, [{"id": 1}, {"id": 2, "fail": 1}], {"output-topic": 1}, stop_raises=True))
    assert port_result == jax_result
    assert port_result[2] == ("ValueError", "record 2 failed")


MOCK_APP = """
topics:
  - name: "input-topic"
    creation-mode: create-if-not-exists
  - name: "output-topic"
    creation-mode: create-if-not-exists
  - name: "embeddings-topic"
    creation-mode: create-if-not-exists
  - name: "stream-topic"
    creation-mode: create-if-not-exists
pipeline:
  - name: "split"
    type: "text-splitter"
    input: "input-topic"
    configuration:
      chunk-size: 12
      chunk-overlap: 0
  - name: "convert"
    type: "document-to-json"
    configuration:
      text-field: "text"
  - name: "embed"
    type: "compute-ai-embeddings"
    output: "embeddings-topic"
    configuration:
      text: "{{ value.text }}"
      embeddings-field: "value.vector"
      batch-size: 3
      flush-interval: 5
  - name: "complete"
    type: "ai-text-completions"
    input: "embeddings-topic"
    output: "output-topic"
    configuration:
      prompt: ["Say: {{ value.text }}"]
      completion-field: "value.answer"
      stream-to-topic: "stream-topic"
      min-chunks-per-message: 2
"""


def test_mock_provider_agents_equal_the_jax_runner(tmp_path):
    """document-to-json, text-splitter (fan-out), batched embeddings and
    streamed text completions through two nodes and the mock provider."""
    (tmp_path / "pipeline.yaml").write_text(MOCK_APP)
    (tmp_path / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {
        "resources": [{"type": "mock-serving-configuration", "name": "mock",
                       "configuration": {"dimensions": 4}}]}}))
    from langstream_tpu.agents.text import RecursiveCharacterTextSplitter

    inputs = ["alpha beta gamma delta epsilon", "one two three"]
    splitter = RecursiveCharacterTextSplitter(chunk_size=12, chunk_overlap=0)
    n = sum(len(splitter.split_text(text)) for text in inputs)
    jax_result, port_result = on_both(_app_scenario(
        tmp_path, inputs, {"embeddings-topic": n, "output-topic": n}))
    assert port_result == jax_result
    assert n > len(inputs)
    assert [i["records-out"] for i in port_result[1]] == [n, n]


def test_local_run_serves_one_application_at_a_time(tmp_path):
    """The port's in-process ``run``: it serves on the device it was given
    and puts the process's serving device back when it stops, also when
    its start fails; a second run is refused while one is serving. The
    ``grpc-sidecar-agent`` example (refused at planning until the sidecar
    lane was ported) runs through a sidecar
    interpreter, its records equal to the JAX runner's; an app whose agent
    type no registry knows fails at its start."""
    from langstream_tpu_torch.agents import services as port_services
    from langstream_tpu_torch.cli.main import LocalRun

    app = tmp_path / "app"
    app.mkdir()
    (app / "pipeline.yaml").write_text(MOCK_APP)
    (app / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {
        "resources": [{"type": "mock-serving-configuration", "name": "mock"}]}}))
    unknown = tmp_path / "unknown"
    unknown.mkdir()
    (unknown / "pipeline.yaml").write_text(MOCK_APP.replace('"document-to-json"',
                                                            '"no-such-agent"', 1))
    sidecar = REPO / "examples" / "applications" / "grpc-sidecar-agent"
    instance = tmp_path / "instance.yaml"
    instance.write_text(_instance(f"local-run-{next(_CLUSTERS)}"))
    before = port_services.SERVING_DEVICE
    values = ["ping", "pong", "é"]

    async def main():
        run = await LocalRun("a", app, instance, device="cpu", gateway_port=0).start()
        try:
            serving = port_services.SERVING_DEVICE
            with pytest.raises(RuntimeError, match="'a' is already served in this process"):
                await LocalRun("b", app, instance, device="cpu", gateway_port=0).start()
            await run.runner.produce("input-topic", "one two three")
            out = await run.runner.wait_for_messages("output-topic", 1, timeout=30)
        finally:
            await run.stop()
        after_stop = port_services.SERVING_DEVICE
        run = await LocalRun("c", sidecar, instance, device="cpu", gateway_port=0).start()
        try:
            for value in values:
                await run.runner.produce("in-topic", value)
            side = await run.runner.wait_for_messages("out-topic", len(values), timeout=60)
        finally:
            await run.stop()
        with pytest.raises(ValueError, match="no agent implementation for type 'no-such-agent'"):
            await LocalRun("d", unknown, instance, device="cpu", gateway_port=0).start()
        return serving, out, after_stop, side, LocalRun._active

    async def jax_side():
        runner = jax_local.LocalApplicationRunner.from_directory(
            sidecar, instance=_instance(f"local-run-{next(_CLUSTERS)}"))
        async with runner:
            for value in values:
                await runner.produce("in-topic", value)
            return await runner.wait_for_messages("out-topic", len(values), timeout=60)

    serving, out, after_stop, side, active = asyncio.run(main())
    jax_out = asyncio.run(jax_side())
    assert serving == "cpu" and out[0].value["answer"]
    assert after_stop == before == port_services.SERVING_DEVICE
    assert active is None
    assert sorted(r.value for r in side) == sorted(r.value for r in jax_out) == \
        sorted(v + "!" for v in values)


# ---------------------------------------------------------------------------
# the slice end to end: the chat example on both engines, f32 tiny
# ---------------------------------------------------------------------------

TINY = {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 128,
        "checkpoint": FIXTURE, "decode-chunk": 4, "decode-chunk-light": 2,
        "warmup-on-start": True}
QUESTIONS = {"s1": "what is it?", "s2": "tell me a story", "s3": "why?"}


def chat_example_at_tiny(target: Path) -> Path:
    """The chat-completions example with its resource at the tiny model
    (the in-repo HF fixture) in f32; pipeline and gateways as they are."""
    target.mkdir(parents=True, exist_ok=True)
    for name in ("pipeline.yaml", "gateways.yaml"):
        (target / name).write_text((CHAT_APP / name).read_text())
    (target / "configuration.yaml").write_text(yaml.safe_dump({"configuration": {
        "resources": [{"type": "tpu-serving-configuration", "name": "tpu",
                       "configuration": TINY}]}}))
    return target


async def _close_engines():
    for cls in (TorchServingEngine, TpuServingEngine):
        engines = list(cls._instances.values())
        cls.reset_instances()
        for engine in engines:
            await engine.close()


async def _chat(pkg, cluster, app_dir, sequential):
    instance = (REPO / "examples" / "instances" / "memory.yaml").read_text()
    instance = instance.replace('type: "memory"', f'type: "memory"\n    configuration: {{cluster: "{cluster}"}}')
    runner = pkg.Runner.from_directory(app_dir, instance=instance)
    try:
        async with runner:
            for i, (session, question) in enumerate(QUESTIONS.items()):
                await runner.produce("questions-topic", question,
                                     headers={"langstream-client-session-id": session})
                if sequential:
                    await runner.wait_for_messages("answers-topic", i + 1, timeout=120)
            answers = await runner.wait_for_messages("answers-topic", len(QUESTIONS), timeout=120)
            chunks = []
            for _ in range(400):
                chunks = await runner.wait_for_messages("stream-topic", 1)
                if sum(c.header("stream-last-message") == "true" for c in chunks) == len(QUESTIONS):
                    break
                await asyncio.sleep(0.05)
    finally:
        await _close_engines()
    by_session = {a.header("langstream-client-session-id"): a.value for a in answers}
    streams = {}
    for c in chunks:
        streams.setdefault(c.header("langstream-client-session-id"), []).append(
            (int(c.header("stream-index")), c.value, c.header("stream-last-message")))
    return by_session, {k: sorted(v) for k, v in streams.items()}


@pytest.mark.parametrize("sequential", [True, False], ids=["one-at-a-time", "a-wave"])
def test_chat_example_equals_the_jax_runner_and_engine(tmp_path, monkeypatch, sequential):
    """Each package's runner with its own engine: the answers-topic values
    (answer, question, logged prompt) and every stream chunk equal."""
    from langstream_tpu_torch.agents import services as port_services

    monkeypatch.setattr(port_services, "SERVING_DEVICE", "cpu")
    app_dir = chat_example_at_tiny(tmp_path / "chat")

    async def scenario(pkg, cluster):
        return await _chat(pkg, cluster, app_dir, sequential)

    jax_result, port_result = on_both(scenario)
    assert port_result == jax_result
    answers, streams = port_result
    assert set(answers) == set(QUESTIONS)
    for session, value in answers.items():
        assert value["question"] == QUESTIONS[session]
        assert value["answer"] and value["answer"] == "".join(v for _, v, _ in streams[session])
        assert streams[session][-1][2] == "true"
