"""The port's consumer-group protocol over the wire client (dynamic
rebalance lane), every case of ``tests/test_kafka_group.py``: JoinGroup,
SyncGroup, Heartbeat and LeaveGroup spoken by the port's client
(``langstream_tpu_torch/runtime/kafka_wire.py``) against each fake
broker's coordinator state machine (``tests/torch_fake_kafka.py`` and
``tests/fake_kafka.py``), with the leader-side range assignor and
generation-fenced offset commits. Then across the packages: the JAX
client's two members on the port's fake; the port's setup Job making a
Kafka instance's topics with their partitions; two pods of one StatefulSet
splitting the partitions as the JAX wire runtime does, and serving them
through the pod entrypoint's runner.
"""

import asyncio
import json
import time

import pytest
import yaml

import fake_kafka as jax_fake
import torch_fake_kafka

from langstream_tpu_torch.runtime.kafka_wire import (
    ERR_ILLEGAL_GENERATION,
    KafkaProtocolError,
    KafkaWireClient,
    decode_assignment,
    decode_subscription,
    encode_assignment,
    encode_subscription,
    range_assign,
)
from langstream_tpu_torch.runtime.kafka_wire_runtime import (
    GroupMembership,
    WireKafkaTopicConsumer,
    WireKafkaTopicProducer,
)
from torch_fake_kafka import FakeKafkaBroker


FAKES = {"torch-fake": torch_fake_kafka.FakeKafkaBroker, "jax-fake": jax_fake.FakeKafkaBroker}


@pytest.fixture(params=sorted(FAKES))
def broker(request):
    with FAKES[request.param](join_window=0.4) as b:
        yield b


def _run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# pure pieces
# ---------------------------------------------------------------------------


def test_subscription_and_assignment_codecs_roundtrip():
    sub = encode_subscription(["b-topic", "a-topic"])
    assert decode_subscription(sub) == ["a-topic", "b-topic"]
    parts = {"t": [2, 0, 1], "u": [0]}
    assert decode_assignment(encode_assignment(parts)) == {
        "t": [0, 1, 2], "u": [0],
    }
    assert decode_assignment(b"") == {}


def test_range_assignor_matches_java_semantics():
    # 5 partitions over 2 members: first member takes the extra one
    out = range_assign(
        {"m1": ["t"], "m2": ["t"]}, {"t": [0, 1, 2, 3, 4]}
    )
    assert out == {"m1": {"t": [0, 1, 2]}, "m2": {"t": [3, 4]}}
    # member not subscribed to a topic gets none of it
    out = range_assign(
        {"m1": ["t", "u"], "m2": ["t"]}, {"t": [0, 1], "u": [0, 1]}
    )
    assert out["m2"] == {"t": [1]}
    assert out["m1"] == {"t": [0], "u": [0, 1]}


# ---------------------------------------------------------------------------
# protocol against the fake coordinator
# ---------------------------------------------------------------------------


def test_single_member_lifecycle(broker):
    async def main():
        client = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            await client.create_topic("t", partitions=3)
            m = GroupMembership(client, "g1", ["t"])
            assignment = await m.join()
            assert assignment == {"t": [0, 1, 2]}  # sole member takes all
            assert m.generation == 1
            await client.heartbeat("g1", m.generation, m.member_id)
            await m.leave()
            assert broker.groups["g1"].state == "Empty"
        finally:
            await client.close()

    _run(main())


def test_two_members_converge_to_a_split(broker):
    async def main():
        c1 = KafkaWireClient(f"127.0.0.1:{broker.port}")
        c2 = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            await c1.create_topic("t", partitions=4)
            m1 = GroupMembership(c1, "g", ["t"], heartbeat_interval_s=0.05)
            m2 = GroupMembership(c2, "g", ["t"], heartbeat_interval_s=0.05)
            a1 = await m1.join()

            async def run_m2():
                return await m2.join()

            async def pump_m1():
                # m1 discovers the rebalance via heartbeat and rejoins
                nonlocal a1
                for _ in range(100):
                    await asyncio.sleep(0.05)
                    if not await m1.heartbeat_if_due():
                        a1 = await m1.join()
                        return
                raise AssertionError("m1 never saw the rebalance")

            a2, _ = await asyncio.gather(run_m2(), pump_m1())
            assert m1.generation == m2.generation
            owned = sorted(a1.get("t", []) + a2.get("t", []))
            assert owned == [0, 1, 2, 3]         # disjoint cover
            assert set(a1.get("t", [])) & set(a2.get("t", [])) == set()
        finally:
            await c1.close()
            await c2.close()

    _run(main())


def test_leave_triggers_rebalance_and_survivor_takes_all(broker):
    async def main():
        c1 = KafkaWireClient(f"127.0.0.1:{broker.port}")
        c2 = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            await c1.create_topic("t", partitions=2)
            m1 = GroupMembership(c1, "g", ["t"], heartbeat_interval_s=0.05)
            m2 = GroupMembership(c2, "g", ["t"], heartbeat_interval_s=0.05)
            await m1.join()

            async def converge(m):
                for _ in range(100):
                    await asyncio.sleep(0.05)
                    if not await m.heartbeat_if_due():
                        return await m.join()
                raise AssertionError("no rebalance seen")

            joined2, rejoined1 = await asyncio.gather(m2.join(), converge(m1))
            assert sorted(
                rejoined1.get("t", []) + joined2.get("t", [])
            ) == [0, 1]
            # m2 leaves; m1 rejoins and owns both partitions again
            await m2.leave()
            assignment = await converge(m1)
            assert assignment == {"t": [0, 1]}
        finally:
            await c1.close()
            await c2.close()

    _run(main())


def test_commit_is_generation_fenced(broker):
    async def main():
        client = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            await client.create_topic("t", partitions=1)
            m = GroupMembership(client, "g", ["t"])
            await m.join()
            # a commit at a stale generation must be rejected AND not stored
            with pytest.raises(KafkaProtocolError) as e:
                await client.offset_commit_grouped(
                    "g", m.generation + 7, m.member_id, {("t", 0): 5}
                )
            assert e.value.code == ERR_ILLEGAL_GENERATION
            assert ("g", "t", 0) not in broker.offsets
            # the real generation commits fine
            await client.offset_commit_grouped(
                "g", m.generation, m.member_id, {("t", 0): 5}
            )
            assert broker.offsets[("g", "t", 0)] == 5
        finally:
            await client.close()

    _run(main())


def test_background_heartbeats_flow_while_owner_is_busy(broker):
    """A batch that takes longer than the heartbeat interval must not
    silence the member: the membership heartbeats from a background task
    (the Java client's heartbeat-thread analogue)."""

    async def main():
        client = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            await client.create_topic("t", partitions=1)
            m = GroupMembership(
                client, "g", ["t"], heartbeat_interval_s=0.05
            )
            await m.join()
            from langstream_tpu_torch.runtime.kafka_wire import API_HEARTBEAT

            def beats():
                return sum(1 for k, _ in broker.requests if k == API_HEARTBEAT)

            before = beats()
            await asyncio.sleep(0.5)          # "processing" — no read() calls
            assert beats() - before >= 3      # the task kept beating
            await m.leave()
            after_leave = beats()
            await asyncio.sleep(0.3)
            assert beats() == after_leave     # task cancelled with leave()
        finally:
            await client.close()

    _run(main())


def test_unassigned_member_read_sleeps_instead_of_spinning(broker):
    """5th member on a 4-partition topic owns nothing: read() must yield
    for a poll interval, not return [] in a hot loop."""

    async def main():
        admin = KafkaWireClient(f"127.0.0.1:{broker.port}")
        await admin.create_topic("t", partitions=1)
        c = WireKafkaTopicConsumer(
            f"127.0.0.1:{broker.port}", "t", "g",
            assignment="dynamic", poll_timeout_ms=200,
        )
        await c.start()
        # steal the only partition away to simulate an empty assignment
        c._positions = {}
        import time as _time

        t0 = _time.monotonic()
        assert await c.read() == []
        assert _time.monotonic() - t0 >= 0.15
        await c.close()
        await admin.close()

    _run(main())


def test_coordinator_lookup_is_cached(broker):
    async def main():
        client = KafkaWireClient(f"127.0.0.1:{broker.port}")
        try:
            await client.create_topic("t", partitions=1)
            m = GroupMembership(client, "g", ["t"])
            await m.join()
            from langstream_tpu_torch.runtime.kafka_wire import API_FIND_COORDINATOR

            def lookups():
                return sum(
                    1 for k, _ in broker.requests if k == API_FIND_COORDINATOR
                )

            before = lookups()
            for _ in range(5):
                await client.heartbeat("g", m.generation, m.member_id)
            await client.offset_commit_grouped(
                "g", m.generation, m.member_id, {("t", 0): 1}
            )
            assert lookups() == before        # all rode the cached conn
            await m.leave()
        finally:
            await client.close()

    _run(main())


# ---------------------------------------------------------------------------
# dynamic consumers end to end
# ---------------------------------------------------------------------------


def test_dynamic_consumers_split_then_failover(broker):
    # the join window must outlast one empty-poll read (~0.5s with the
    # default poll budget): a member mid-poll must still make the round
    broker.join_window = 1.0

    async def main():
        admin = KafkaWireClient(f"127.0.0.1:{broker.port}")
        await admin.create_topic("jobs", partitions=4)

        producer = WireKafkaTopicProducer(f"127.0.0.1:{broker.port}", "jobs")
        await producer.start()
        from langstream_tpu_torch.api.record import make_record

        for i in range(16):
            await producer.write(make_record(value=f"job-{i}", key=f"k{i}"))

        def consumer():
            c = WireKafkaTopicConsumer(
                f"127.0.0.1:{broker.port}", "jobs", "workers",
                assignment="dynamic",
            )
            c.membership.heartbeat_interval_s = 0.05
            return c

        c1, c2 = consumer(), consumer()

        # each consumer runs in its OWN task, like its own pod: while one
        # waits inside a join round the other must keep heartbeating or no
        # round can ever assemble both members
        sinks = {1: [], 2: []}
        stops = {1: asyncio.Event(), 2: asyncio.Event()}

        async def run(consumer, idx):
            await consumer.start()
            while not stops[idx].is_set():
                records = await consumer.read()
                if records:
                    await consumer.commit(records)
                    sinks[idx].extend(records)

        t1 = asyncio.create_task(run(c1, 1))
        t2 = asyncio.create_task(run(c2, 2))

        async def wait_for(predicate, seconds, what):
            deadline = asyncio.get_event_loop().time() + seconds
            while not predicate():
                assert asyncio.get_event_loop().time() < deadline, what
                await asyncio.sleep(0.1)

        def converged():
            return (
                {r.value for r in sinks[1] + sinks[2]}
                >= {f"job-{i}" for i in range(16)}
                and c1.membership.generation == c2.membership.generation
                and not (set(c1._positions) & set(c2._positions))
                and set(c1._positions) | set(c2._positions) == {0, 1, 2, 3}
            )

        await wait_for(converged, 30, "two members never split the topic")

        # failover: c2 leaves; c1 must adopt all 4 partitions and see
        # records produced afterwards
        stops[2].set()
        await t2
        await c2.close()
        for i in range(16, 24):
            await producer.write(make_record(value=f"job-{i}", key=f"k{i}"))

        def took_over():
            return (
                {r.value for r in sinks[1]}
                >= {f"job-{i}" for i in range(16, 24)}
                and set(c1._positions) == {0, 1, 2, 3}
            )

        await wait_for(took_over, 30, "survivor never took over")
        assert c1._rebalances >= 1

        stops[1].set()
        await t1
        await c1.close()
        await producer.close()
        await admin.close()

    _run(main())


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def test_the_jax_client_group_converges_on_the_port_fake():
    """Two JAX-package members on the port's fake coordinator: one
    generation, a disjoint cover of the partitions, then a leave hands the
    survivor everything."""
    from langstream_tpu.runtime.kafka_wire import KafkaWireClient as JaxClient
    from langstream_tpu.runtime.kafka_wire_runtime import GroupMembership as JaxMembership

    async def main(port):
        c1, c2 = JaxClient(f"127.0.0.1:{port}"), JaxClient(f"127.0.0.1:{port}")
        try:
            await c1.create_topic("t", partitions=4)
            m1 = JaxMembership(c1, "g", ["t"], heartbeat_interval_s=0.05)
            m2 = JaxMembership(c2, "g", ["t"], heartbeat_interval_s=0.05)
            a1 = await m1.join()

            async def pump_m1():
                nonlocal a1
                for _ in range(100):
                    await asyncio.sleep(0.05)
                    if not await m1.heartbeat_if_due():
                        a1 = await m1.join()
                        return
                raise AssertionError("m1 never saw the rebalance")

            a2, _ = await asyncio.gather(m2.join(), pump_m1())
            split = (m1.generation == m2.generation, a1.get("t", []), a2.get("t", []))
            await m2.leave()
            for _ in range(100):
                await asyncio.sleep(0.05)
                if not await m1.heartbeat_if_due():
                    a1 = await m1.join()
                    break
            await m1.leave()
            return split, a1
        finally:
            await c1.close()
            await c2.close()

    with torch_fake_kafka.FakeKafkaBroker(join_window=0.4) as b:
        (same_generation, p1, p2), survivor = _run(main(b.port))
        assert b.groups["g"].state == "Empty"
    assert same_generation and sorted(p1 + p2) == [0, 1, 2, 3] and not set(p1) & set(p2)
    assert survivor == {"t": [0, 1, 2, 3]}


def _setup_config(tmp_path, port: int):
    app = {
        "pipeline.yaml": yaml.safe_dump({
            "topics": [{"name": "wide", "creation-mode": "create-if-not-exists",
                        "partitions": 4},
                       {"name": "narrow", "creation-mode": "create-if-not-exists"}],
            "pipeline": [{"name": "split", "type": "document-to-json", "input": "wide",
                          "output": "narrow", "configuration": {"text-field": "q"}}]}),
    }
    config = tmp_path / "setup.json"
    config.write_text(json.dumps({
        "applicationId": "kafka-app", "tenant": "t1", "files": app, "secrets": None,
        "instance": yaml.safe_dump({"instance": {"streamingCluster": {
            "type": "kafka", "configuration": {
                "client": "wire", "admin": {"bootstrap.servers": f"127.0.0.1:{port}"}}}}})}))
    return config


def test_the_port_setup_job_makes_a_kafka_instances_topics(tmp_path):
    """``run_setup`` (the setup Job's command) of both packages on the
    same application and a Kafka instance: the same topics with the same
    partitions, each on its own fake broker."""
    import langstream_tpu.runtime.pod as jax_pod
    import langstream_tpu_torch.runtime.pod as port_pod

    made = {}
    for name, pod, fake in (("jax", jax_pod, jax_fake.FakeKafkaBroker),
                            ("port", port_pod, torch_fake_kafka.FakeKafkaBroker)):
        with fake() as b:
            asyncio.run(pod.run_setup(str(_setup_config(tmp_path, b.port))))
            made[name] = {t: sorted(parts) for t, parts in b.topics.items()}
    assert made["port"] == made["jax"] == {"wide": [0, 1, 2, 3], "narrow": [0]}


@pytest.mark.parametrize("hint", ["env", "config"])
def test_two_pods_split_the_partitions_as_the_jax_runtime_does(hint, monkeypatch):
    """Static assignment: the pods ``<sts>-0`` and ``<sts>-1`` of one
    StatefulSet (``LS_POD_NAME``, ``LS_NUM_REPLICAS``), or the runner's
    ``replica-index``/``num-replicas``, own the same partitions in both
    packages, disjoint and covering the topic."""
    from langstream_tpu.runtime.kafka_wire_runtime import (
        WireKafkaTopicConnectionsRuntime as JaxRuntime,
    )
    from langstream_tpu_torch.runtime.kafka_wire_runtime import (
        WireKafkaTopicConnectionsRuntime as PortRuntime,
    )

    monkeypatch.delenv("LS_LOGICAL_REPLICA", raising=False)

    async def owned(runtime_cls, port, ordinal):
        if hint == "env":
            monkeypatch.setenv("LS_POD_NAME", f"kafka-app-split-{ordinal}")
            monkeypatch.setenv("LS_NUM_REPLICAS", "2")
            config = {"topic": "wide"}
        else:
            config = {"topic": "wide", "replica-index": ordinal, "num-replicas": 2}
        runtime = runtime_cls()
        runtime.init({"admin": {"bootstrap.servers": f"127.0.0.1:{port}"}})
        consumer = runtime.create_consumer("split", config)
        await consumer.start()
        await consumer.close()
        return sorted(consumer._positions)

    with torch_fake_kafka.FakeKafkaBroker() as b:
        asyncio.run(KafkaWireClient(f"127.0.0.1:{b.port}").create_topic("wide", partitions=5))
        ours = [asyncio.run(owned(PortRuntime, b.port, i)) for i in (0, 1)]
        theirs = [asyncio.run(owned(JaxRuntime, b.port, i)) for i in (0, 1)]
    assert ours == theirs == [[0, 2, 4], [1, 3]]


def test_two_pods_serve_a_kafka_apps_partitions(tmp_path, monkeypatch):
    """The pod entrypoint's runner (``build_agent_runner`` over the pod
    configuration the k8s runtime writes) for the pods ``<sts>-0`` and
    ``<sts>-1`` of one agent at ``parallelism: 2`` over a Kafka instance:
    each consumes its half of the input's partitions, every record is
    answered once, and the group's commits reach the input's end."""
    from langstream_tpu_torch.core.deployer import ApplicationDeployer
    from langstream_tpu_torch.core.parser import build_application_from_files
    from langstream_tpu_torch.k8s.podconfig import pod_configuration
    from langstream_tpu_torch.runtime.pod import build_agent_runner

    monkeypatch.delenv("LS_LOGICAL_REPLICA", raising=False)
    files = {"pipeline.yaml": yaml.safe_dump({
        "topics": [{"name": "in", "creation-mode": "create-if-not-exists", "partitions": 4},
                   {"name": "out", "creation-mode": "create-if-not-exists"}],
        "pipeline": [{"name": "json", "type": "document-to-json", "input": "in",
                      "output": "out", "resources": {"parallelism": 2},
                      "configuration": {"text-field": "q"}}]})}

    async def main(port):
        instance = yaml.safe_dump({"instance": {"streamingCluster": {"type": "kafka",
            "configuration": {"client": "wire",
                              "admin": {"bootstrap.servers": f"127.0.0.1:{port}"}}}}})
        deployer = ApplicationDeployer()
        plan = deployer.create_implementation("app", build_application_from_files(
            files, instance, None))
        await deployer.setup(plan)
        (node,) = plan.agents.values()
        config = pod_configuration(plan, node)
        runners = []
        for ordinal in (0, 1):
            monkeypatch.setenv("LS_POD_NAME", f"app-json-{ordinal}")
            runner = build_agent_runner(config)
            await runner.start()
            runners.append(runner)
        client = KafkaWireClient(f"127.0.0.1:{port}")
        try:
            for i in range(12):
                await client.produce("in", i % 4, [(f"k{i}".encode(), f"q{i}".encode(), [])],
                                     timestamp_ms=1)
            for _ in range(200):
                if sum(len(p.records) for p in b.topics["out"].values()) >= 12:
                    break
                await asyncio.sleep(0.05)
        finally:
            owned = [sorted(r.source.consumer._positions) for r in runners]
            for runner in runners:
                await runner.stop()
            await client.close()
        return owned

    with torch_fake_kafka.FakeKafkaBroker() as b:
        owned = asyncio.run(main(b.port))
        out = sorted(json.loads(rec.value)["q"] for p in b.topics["out"].values()
                     for rec in p.records)
        ends = {p: part.log_end for p, part in b.topics["in"].items()}
        committed = {p: off for (g, t, p), off in b.offsets.items() if t == "in"}
        for _ in range(100):  # the broker's thread reads each close
            if not b.open_connections:
                break
            time.sleep(0.05)
        assert not b.open_connections, b.open_connections
    assert owned == [[0, 2], [1, 3]]
    assert out == sorted(f"q{i}" for i in range(12))
    assert committed == ends == {0: 3, 1: 3, 2: 3, 3: 3}
