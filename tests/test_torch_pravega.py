"""The port's Pravega runtime against a fake client binding, the roundtrip
case of ``tests/test_pravega_admin_isolation.py`` (the other cases of that
file test the JAX package's admin client and per-app virtual environments,
not the transport); the registration when the binding imports; and the
event codec read back by the other package, both ways."""

from __future__ import annotations

import sys
import types

import pytest

from langstream_tpu_torch.api.record import make_record


# ---------------------------------------------------------------------------
# fake pravega_client binding
# ---------------------------------------------------------------------------


class _FakeEvent:
    def __init__(self, payload: bytes):
        self._payload = payload

    def data(self) -> bytes:
        return self._payload


class _FakeSlice:
    def __init__(self, events):
        self._events = list(events)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._events:
            raise StopIteration
        return self._events.pop(0)


def install_fake_pravega():
    mod = types.ModuleType("pravega_client")
    streams: dict[tuple[str, str], list[bytes]] = {}
    groups: dict[str, dict] = {}
    released: list = []

    class _Reader:
        def __init__(self, state, key):
            self.state = state
            self.key = key

        def get_segment_slice(self):
            backlog = streams.get(self.key, [])
            if self.state["cursor"] >= len(backlog):
                return _FakeSlice([])
            events = [
                _FakeEvent(p) for p in backlog[self.state["cursor"]:]
            ]
            self.state["cursor"] = len(backlog)
            return _FakeSlice(events)

        def release_segment(self, sl):
            released.append(sl)

        def reader_offline(self):
            pass

    class _ReaderGroup:
        def __init__(self, name, scope, stream):
            self.state = groups.setdefault(name, {"cursor": 0})
            self.key = (scope, stream)

        def create_reader(self, reader_id):
            return _Reader(self.state, self.key)

    class _Writer:
        def __init__(self, scope, stream):
            self.key = (scope, stream)

        def write_event_bytes(self, payload, routing_key=None):
            streams.setdefault(self.key, []).append(bytes(payload))

    class StreamManager:
        def __init__(self, uri):
            self.uri = uri
            self.scopes: set[str] = set()
            self.created: list[tuple[str, str, int]] = []

        def create_scope(self, scope):
            self.scopes.add(scope)

        def create_stream(self, scope, stream, segments):
            self.created.append((scope, stream, segments))
            streams.setdefault((scope, stream), [])

        def seal_stream(self, scope, stream):
            pass

        def delete_stream(self, scope, stream):
            streams.pop((scope, stream), None)

        def create_reader_group(self, name, scope, stream):
            return _ReaderGroup(name, scope, stream)

        def create_writer(self, scope, stream):
            return _Writer(scope, stream)

    mod.StreamManager = StreamManager
    mod._streams = streams
    mod._released = released
    return mod


@pytest.fixture()
def fake_pravega(monkeypatch):
    mod = install_fake_pravega()
    monkeypatch.setitem(sys.modules, "pravega_client", mod)
    return mod


def test_pravega_roundtrip_and_admin(fake_pravega, run_async):
    from langstream_tpu_torch.runtime.pravega_broker import (
        PravegaTopicConnectionsRuntime,
    )

    async def main():
        runtime = PravegaTopicConnectionsRuntime()
        runtime.init(
            {
                "configuration": {
                    "client": {"controller-uri": "tcp://fake:9090",
                               "scope": "ls"}
                }
            }
        )
        admin = runtime.create_topic_admin()
        await admin.create_topic("events", partitions=2)
        assert ("ls", "events", 2) in runtime._manager.created

        producer = runtime.create_producer("a", {"topic": "events"})
        await producer.start()
        await producer.write(
            make_record(value={"n": 1}, key="k", headers={"raw": b"\x00\x01"})
        )
        await producer.write(make_record(value="text"))

        consumer = runtime.create_consumer("a", {"topic": "events"})
        await consumer.start()
        first = (await consumer.read())[0]
        assert first.value == {"n": 1}
        assert first.key == "k"
        assert first.header("raw") == b"\x00\x01"  # bytes survive the envelope
        second = (await consumer.read())[0]
        assert second.value == "text"
        await consumer.commit([first, second])
        # drained slice with everything committed gets released to the group
        assert await consumer.read() == []
        assert fake_pravega._released

        # reader positions
        reader = runtime.create_reader(
            {"topic": "events"}, initial_position="earliest"
        )
        await reader.start()
        got = []
        for _ in range(3):
            got += [r.value for r in await reader.read(timeout=0.01)]
        assert got == [{"n": 1}, "text"]
        latest = runtime.create_reader(
            {"topic": "events"}, initial_position="latest"
        )
        await latest.start()
        assert await latest.read(timeout=0.01) == []
        await producer.write(make_record(value="new"))
        assert [r.value for r in await latest.read(timeout=0.01)] == ["new"]
        await runtime.close()

    run_async(main())


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

EVENTS = [
    ({"n": 1}, "k", {"raw": b"\x00\x01", "s": "x"}),
    ("text", None, {}),
    (b"\xff\xfe", {"compound": 1}, {"n": 3, "none": None}),
]


@pytest.mark.parametrize("case", range(len(EVENTS)))
def test_event_codec_equals_the_jax_one_both_ways(case):
    from langstream_tpu.api.record import make_record as jax_make_record
    from langstream_tpu.runtime import pravega_broker as jax_pb
    from langstream_tpu_torch.runtime import pravega_broker as port_pb

    value, key, headers = EVENTS[case]
    record = make_record(value=value, key=key, headers=headers, timestamp=1_700_000_000_000)
    jax_record = jax_make_record(value=value, key=key, headers=headers,
                                 timestamp=1_700_000_000_000)
    ours = port_pb.record_to_event(record)
    theirs = jax_pb.record_to_event(jax_record)
    assert ours == theirs

    def fields(r):
        hdrs = r.header_map()
        offset = hdrs.pop("__offset")
        return r.value, r.key, hdrs, r.timestamp, (offset.topic, offset.offset)

    back_ours = port_pb.event_to_record(theirs[0], "events", 5)
    back_theirs = jax_pb.event_to_record(ours[0], "events", 5)
    assert fields(back_ours) == fields(back_theirs) == (
        value, key, headers, record.timestamp, ("events", "5"))


def test_pravega_registers_when_importable(fake_pravega):
    import importlib

    import langstream_tpu_torch.runtime as runtime_pkg
    from langstream_tpu_torch.api.topics import TopicConnectionsRuntimeRegistry
    from langstream_tpu_torch.runtime.pravega_broker import PravegaTopicConnectionsRuntime

    try:
        importlib.reload(runtime_pkg)
        made = TopicConnectionsRuntimeRegistry.get_runtime({"type": "pravega", "configuration": {
            "client": {"controller-uri": "tcp://fake:9090", "scope": "ls"}}})
        assert isinstance(made, PravegaTopicConnectionsRuntime)
    finally:
        TopicConnectionsRuntimeRegistry._factories.pop("pravega", None)
