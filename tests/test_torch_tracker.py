"""The source-record tracker's drain with a commit in flight, in the port and
in the JAX package: a source whose first commit is slow tracks two records;
the second record's commit ends first. The drain
(``wait_for_no_pending``) may return only once both commits have ended, and
the runner's ``stop()`` may close the source only after that.

The JAX tracker pops a record before it awaits its commit and counts only
records still waiting for writes, so its drain returns while the first
commit is on its way and its runner closes the source under it. The port
keeps the commit counted until it returns. The JAX half is the reference's
trait, kept as it is (ROADMAP Queue 3), and is marked to fail.

The drain is bounded all the same: a commit that a broker never answers
holds its connection's lock, and the close that follows the drain's timeout
takes that socket from under it within ``CLOSE_WAIT_S``."""

import asyncio
import types

import pytest

import langstream_tpu.api.record as jax_record
import langstream_tpu.runtime.runner as jax_runner
import langstream_tpu.runtime.tracker as jax_tracker
import langstream_tpu_torch.api.record as port_record
import langstream_tpu_torch.runtime.kafka_wire as port_kafka_wire
import langstream_tpu_torch.runtime.runner as port_runner
import langstream_tpu_torch.runtime.tracker as port_tracker

PACKAGES = {
    "port": types.SimpleNamespace(make_record=port_record.make_record,
                                  Tracker=port_tracker.SourceRecordTracker,
                                  Runner=port_runner.AgentRunner),
    "jax": types.SimpleNamespace(make_record=jax_record.make_record,
                                 Tracker=jax_tracker.SourceRecordTracker,
                                 Runner=jax_runner.AgentRunner),
}
SLOW_S = 0.3
BOTH = ["port", pytest.param("jax", marks=pytest.mark.xfail(
    strict=True, reason="the JAX tracker's drain returns while a commit is in flight "
                        "(a kept reference trait)"))]


class SlowFirstCommitSource:
    """Records what happens, in order: each commit's start and end, and the
    close. The commit of the record valued ``first`` takes ``SLOW_S``."""

    def __init__(self):
        self.events: list[tuple] = []

    async def commit(self, records):
        value = records[0].value
        self.events.append(("commit-start", value))
        if value == "first":
            await asyncio.sleep(SLOW_S)
        self.events.append(("commit-end", value))

    async def close(self):
        self.events.append(("close",))


class SilentBrokerSource:
    """A source whose commit is one call on a Kafka connection to a broker
    that reads requests and never answers; its close closes the connection."""

    def __init__(self, conn):
        self.conn = conn
        self.events: list[str] = []

    async def commit(self, records):
        self.events.append("commit-start")
        await self.conn.call(port_kafka_wire.API_OFFSET_COMMIT, 2, b"")

    async def close(self):
        await self.conn.close()
        self.events.append("close")


class _Closable:
    async def close(self):
        pass


async def _two_records(pkg, source):
    """Track two records, finish the slow one's writes, then the fast one's;
    returns the tracker and the slow commit's task."""
    tracker = pkg.Tracker(source.commit)
    first, second = pkg.make_record(value="first"), pkg.make_record(value="second")
    tracker.track(first, 1)
    tracker.track(second, 1)
    slow = asyncio.ensure_future(tracker.record_written(first))
    await asyncio.sleep(0)  # the slow commit starts
    await tracker.record_written(second)
    assert source.events[:3] == [("commit-start", "first"), ("commit-start", "second"),
                                 ("commit-end", "second")]
    return tracker, slow


def _runner_past_its_loop(pkg, tracker, source):
    runner = pkg.Runner.__new__(pkg.Runner)
    runner.__dict__.update(
        _stop_requested=asyncio.Event(), _loop_task=None, _service_task=None,
        tracker=tracker, processor=_Closable(), sink=_Closable(), source=source,
        deadletter_producer=None, _reroute_producer=None, _context_producers=[],
        topics_runtime=_Closable(), _running=True, _fatal=None)
    return runner


@pytest.mark.parametrize("package", BOTH)
def test_the_drain_waits_for_a_commit_in_flight(package):
    pkg = PACKAGES[package]

    async def scenario():
        source = SlowFirstCommitSource()
        tracker, slow = await _two_records(pkg, source)
        drained = await tracker.wait_for_no_pending(5 * SLOW_S)
        at_drain = list(source.events)
        await slow
        return drained, at_drain, tracker.pending_count()

    drained, at_drain, pending = asyncio.run(scenario())
    assert drained
    assert ("commit-end", "first") in at_drain
    assert pending == 0


@pytest.mark.parametrize("package", BOTH)
def test_stop_closes_the_source_after_every_commit(package):
    pkg = PACKAGES[package]

    async def scenario():
        source = SlowFirstCommitSource()
        tracker, slow = await _two_records(pkg, source)
        # stop() drains the tracker, then closes
        runner = _runner_past_its_loop(pkg, tracker, source)
        await runner.stop(drain_timeout=5 * SLOW_S)
        await slow
        return source.events

    events = asyncio.run(scenario())
    assert events[-2:] == [("commit-end", "first"), ("close",)]


def test_stop_is_bounded_when_a_commit_is_never_answered(monkeypatch):
    """The broker never answers the commit: ``stop()`` returns within the
    drain's timeout plus the close's bound, and the commit fails on its
    closed socket instead of waiting for ever."""
    drain_s, close_s = 0.3, 0.3
    monkeypatch.setattr(port_kafka_wire, "CLOSE_WAIT_S", close_s)
    pkg = PACKAGES["port"]

    async def scenario():
        async def silent(reader, writer):
            await reader.read()  # to the client's close; nothing is answered
            writer.close()

        server = await asyncio.start_server(silent, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            source = SilentBrokerSource(port_kafka_wire._Conn("127.0.0.1", port, "test"))
            tracker = pkg.Tracker(source.commit)
            record = pkg.make_record(value="first")
            tracker.track(record, 1)
            commit = asyncio.ensure_future(tracker.record_written(record))
            await asyncio.sleep(0.05)  # the commit is on the wire
            runner = _runner_past_its_loop(pkg, tracker, source)
            loop = asyncio.get_running_loop()
            started = loop.time()
            await asyncio.wait_for(runner.stop(drain_timeout=drain_s), drain_s + close_s + 5)
            took = loop.time() - started
            outcome = (await asyncio.gather(commit, return_exceptions=True))[0]
        finally:
            server.close()
        return source.events, took, outcome

    events, took, outcome = asyncio.run(scenario())
    assert events == ["commit-start", "close"]
    assert drain_s + close_s - 0.05 <= took < drain_s + close_s + 1.0
    assert isinstance(outcome, (asyncio.IncompleteReadError, ConnectionError, OSError))
