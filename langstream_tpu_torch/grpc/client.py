"""Runtime-side agents that drive an external (sidecar) agent process (the
port's copy of ``langstream_tpu/grpc/client.py``, on the port's HTTP/2
channel, :mod:`langstream_tpu_torch.grpc.h2`, in place of ``grpc.aio``; the
sidecar runs ``python -m langstream_tpu_torch.grpc.server``).

Parity: the Java half of ``langstream-agent-grpc`` —
``AbstractGrpcAgent`` (bidi stream management, out-of-order results by
record-id correlation, ``AbstractGrpcAgent.java:54``,
``GrpcAgentProcessor.java:31``) and ``PythonGrpcServer`` (spawns
``python -m langstream_grpc`` on a free localhost port with PYTHONPATH set
to the app's ``python/`` dirs, ``PythonGrpcServer.java:53-77``), including
restart-on-exit.

Config: ``className`` spawns a sidecar interpreter; ``endpoint`` connects to
an already-running external agent (any language implementing
``agent.proto``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any

from langstream_tpu_torch.api.agent import (
    AgentProcessor,
    AgentSink,
    AgentSource,
    RecordSink,
    SourceRecordAndResult,
)
from langstream_tpu_torch.api.record import Record
from langstream_tpu_torch.grpc import h2
from langstream_tpu_torch.grpc.codec import record_from_proto, record_to_proto
from langstream_tpu_torch.grpc.proto import SERVICE_NAME, load_messages, method_table

log = logging.getLogger("langstream_tpu_torch.grpc.client")


class SidecarProcess:
    """Spawns and supervises the external agent interpreter."""

    #: max seconds for the child to report its port (covers interpreter boot
    #: + user-code imports); a wedged boot must fail, not hang the deploy
    START_TIMEOUT = 60.0

    def __init__(self, config: dict[str, Any]):
        self.config = config
        self.process: subprocess.Popen | None = None
        self.port: int | None = None
        self._config_file: Path | None = None

    def start(self) -> int:
        fd, path = tempfile.mkstemp(prefix="ls-sidecar-", suffix=".json")
        self._config_file = Path(path)
        with os.fdopen(fd, "w") as f:
            json.dump(self.config, f)
        env = dict(os.environ)
        python_paths = [str(Path(__file__).resolve().parents[2])]
        app_dir = self.config.get("__application_directory__")
        if app_dir:
            python_paths += [
                str(Path(app_dir) / "python"),
                str(Path(app_dir) / "python" / "lib"),
            ]
        if env.get("PYTHONPATH"):
            python_paths.append(env["PYTHONPATH"])
        env["PYTHONPATH"] = os.pathsep.join(python_paths)
        # NAR-equivalent dependency isolation: an app that pins
        # requirements.txt gets its own venv, and its sidecars run on that
        # interpreter (runtime/isolation.py)
        from langstream_tpu_torch.runtime.isolation import ensure_app_interpreter

        interpreter = ensure_app_interpreter(app_dir)
        self.process = subprocess.Popen(
            [interpreter, "-m", "langstream_tpu_torch.grpc.server", path],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL if os.environ.get(
                "LS_SIDECAR_QUIET") else None,
            env=env,
            text=True,
        )
        # watchdog: kill the child if it never reports its port, so the
        # blocking readline below is guaranteed to return
        import threading

        booted = threading.Event()

        def watchdog() -> None:
            if not booted.wait(self.START_TIMEOUT) and self.process.poll() is None:
                log.error("sidecar boot timed out; killing it")
                self.process.kill()

        threading.Thread(target=watchdog, daemon=True).start()
        for line in self.process.stdout:  # type: ignore[union-attr]
            if line.startswith("PORT="):
                booted.set()
                self.port = int(line.strip().split("=", 1)[1])
                self._start_stdout_drain()
                return self.port
        booted.set()
        raise RuntimeError(
            "sidecar process exited (or timed out) before reporting its "
            f"port (rc={self.process.poll()})"
        )

    def _start_stdout_drain(self) -> None:
        """Keep reading the child's stdout forever — user code that print()s
        would otherwise fill the pipe buffer and deadlock the sidecar."""
        import threading

        def drain(stream):
            try:
                for line in stream:
                    log.debug("sidecar: %s", line.rstrip())
            except (ValueError, OSError):
                pass

        threading.Thread(
            target=drain, args=(self.process.stdout,), daemon=True
        ).start()

    def alive(self) -> bool:
        return self.process is not None and self.process.poll() is None

    def stop(self) -> None:
        if self.process is not None:
            if self.process.poll() is None:
                self.process.terminate()
                try:
                    self.process.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    self.process.kill()
                    self.process.wait(timeout=10)
            # the child is gone, so the drain thread is at the pipe's end:
            # close it here (the JAX copy leaves one pipe open per restart)
            if self.process.stdout is not None:
                self.process.stdout.close()
        if self._config_file is not None:
            self._config_file.unlink(missing_ok=True)


class _GrpcAgentBase:
    """Channel + stubs + optional sidecar lifecycle shared by the roles."""

    async def init(self, configuration: dict[str, Any]) -> None:
        self.configuration = dict(configuration)
        self.pb2 = load_messages()
        self.sidecar: SidecarProcess | None = None
        self._tp_task: asyncio.Task | None = None
        self.context = None
        # cleared while a restart is in flight: writers wait instead of
        # erroring records into a dead RPC
        self._transport_ready = asyncio.Event()

    async def _connect(self) -> None:
        endpoint = self.configuration.get("endpoint")
        if not endpoint:
            self.sidecar = SidecarProcess(self.configuration)
            loop = asyncio.get_running_loop()
            port = await loop.run_in_executor(None, self.sidecar.start)
            endpoint = f"127.0.0.1:{port}"
        self.channel = h2.insecure_channel(endpoint)
        self.stubs = {}
        for name, spec in method_table(self.pb2).items():
            path = f"/{SERVICE_NAME}/{name}"
            if spec["kind"] == "unary_unary":
                self.stubs[name] = self.channel.unary_unary(
                    path,
                    request_serializer=spec["request"].SerializeToString,
                    response_deserializer=spec["response"].FromString,
                )
            else:
                self.stubs[name] = self.channel.stream_stream(
                    path,
                    request_serializer=spec["request"].SerializeToString,
                    response_deserializer=spec["response"].FromString,
                )

    async def setup(self, context) -> None:
        self.context = context

    async def start(self) -> None:
        await self._connect()
        # records the sidecar asks us to publish on arbitrary topics
        self._tp_task = asyncio.ensure_future(self._pump_topic_producers())
        self._transport_ready.set()

    async def _await_transport(self, timeout: float = 60.0) -> None:
        await asyncio.wait_for(self._transport_ready.wait(), timeout)

    async def _pump_topic_producers(self) -> None:
        call = self.stubs["topic_producer_records"]()
        producers: dict[str, Any] = {}
        try:
            async for msg in call:
                ack = self.pb2.TopicProducerAck(record_id=msg.record_id)
                try:
                    # decode inside the guarded block: a malformed record
                    # must become a failed ack, not a dead pump (a dead pump
                    # leaves the sidecar's write awaiting forever)
                    record = record_from_proto(msg.record)
                    if self.context is None:
                        raise RuntimeError("agent context not set")
                    if msg.topic not in producers:
                        producers[msg.topic] = self.context.get_topic_producer(
                            msg.topic
                        )
                    await producers[msg.topic].write(record)
                except Exception as e:
                    log.warning(
                        "topic-producer publish to %s failed: %s", msg.topic, e
                    )
                    ack.error = str(e)
                await call.write(ack)
        except (asyncio.CancelledError, h2.RpcError):
            pass
        finally:
            # end the stream on any exit so the server fails still-pending
            # writes instead of leaving them suspended on a silent channel
            try:
                call.cancel()
            except Exception as e:
                log.debug("topic-producer stream cancel failed: %s", e)

    async def _restart_transport(self) -> bool:
        """Respawn a dead sidecar and reconnect (parity: the reference's
        restart support in ``PythonGrpcServer``). Bounded attempts; on
        exhaustion the caller escalates via ``context.critical_failure`` so
        the replica restarts (kubelet / local runner)."""
        if self.sidecar is None:  # external endpoint: nothing to respawn
            return False
        self._restarts = getattr(self, "_restarts", 0) + 1
        if self._restarts > 3:
            return False
        log.warning("sidecar died; restart attempt %d/3", self._restarts)
        self._transport_ready.clear()
        loop = asyncio.get_running_loop()
        if self._tp_task is not None:
            self._tp_task.cancel()
        try:
            await self.channel.close()
        except Exception as e:  # noqa: BLE001
            log.debug("closing dead channel failed: %s", e)
        await loop.run_in_executor(None, self.sidecar.stop)
        try:
            await self._connect()
        except Exception as e:  # noqa: BLE001
            log.error("sidecar restart failed: %s", e)
            return False
        self._tp_task = asyncio.ensure_future(self._pump_topic_producers())
        return True

    def _escalate(self, error: Exception) -> None:
        """No transport left: abort the replica (pod restart recovers)."""
        if self.context is not None:
            self.context.critical_failure(error)
        else:
            log.error("external agent transport lost: %s", error)

    async def fetch_agent_info(self) -> dict[str, Any]:
        """Query the remote agent's info blob (async; the sync
        ``agent_info()`` inherited from AgentCode stays cheap)."""
        try:
            response = await self.stubs["agent_info"](self.pb2.InfoRequest())
            info = json.loads(response.info_json or "{}")
            self._last_info = info
            return info
        except Exception as e:  # noqa: BLE001
            return {"error": str(e)}

    def agent_info(self) -> dict[str, Any]:
        info = dict(getattr(self, "_last_info", {}))
        info["execution"] = "sidecar" if self.sidecar else "external-endpoint"
        return info

    async def close(self) -> None:
        if self._tp_task is not None:
            self._tp_task.cancel()
        if getattr(self, "channel", None) is not None:
            await self.channel.close()
        if self.sidecar is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self.sidecar.stop
            )


class GrpcAgentProcessor(_GrpcAgentBase, AgentProcessor):
    """``grpc-python-processor`` — results may complete out of order; the
    record_id correlation maps them back to source records."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self._ids = iter(range(1, 1 << 62))
        self._inflight: dict[int, tuple[Record, RecordSink]] = {}
        self._call = None
        self._reader: asyncio.Task | None = None
        # strong refs: the loop only weak-refs tasks, and a GC'd _send task
        # would strand its records in _inflight forever
        self._send_tasks: set[asyncio.Task] = set()

    async def start(self) -> None:
        await super().start()
        self._call = self.stubs["process"]()
        # a stream takes one in-flight write at a time; the runner emits
        # batches concurrently, so writes serialize behind a lock
        self._write_lock = asyncio.Lock()
        self._reader = asyncio.ensure_future(self._read_results())

    async def _read_results(self) -> None:
        try:
            async for response in self._call:
                for result in response.results:
                    entry = self._inflight.pop(result.record_id, None)
                    if entry is None:
                        log.warning(
                            "orphan result for record id %d", result.record_id
                        )
                        continue
                    source, sink = entry
                    if result.error:
                        sink.emit_error(source, RuntimeError(result.error))
                    else:
                        sink.emit(
                            SourceRecordAndResult(
                                source,
                                [record_from_proto(m) for m in result.records],
                                None,
                            )
                        )
        except asyncio.CancelledError:
            return
        except h2.RpcError as e:
            # a dead sidecar fails every in-flight record; the runtime's
            # error policy (retry/dead-letter/fail) takes it from there
            inflight, self._inflight = self._inflight, {}
            for source, sink in inflight.values():
                sink.emit_error(source, RuntimeError(f"sidecar stream lost: {e}"))
            if await self._restart_transport():
                self._call = self.stubs["process"]()
                self._reader = asyncio.ensure_future(self._read_results())
                self._transport_ready.set()
            else:
                self._escalate(RuntimeError(f"sidecar process lost: {e}"))

    def process(self, records: list[Record], sink: RecordSink) -> None:
        task = asyncio.ensure_future(self._send(records, sink))
        self._send_tasks.add(task)
        task.add_done_callback(self._send_tasks.discard)

    async def _send(self, records: list[Record], sink: RecordSink) -> None:
        try:
            await self._await_transport()
        except asyncio.TimeoutError as e:
            for record in records:
                sink.emit_error(record, e)
            return
        request = self.pb2.ProcessRequest()
        rids = []
        for record in records:
            rid = next(self._ids)
            rids.append(rid)
            self._inflight[rid] = (record, sink)
            request.records.append(record_to_proto(self.pb2, record, rid))
        try:
            async with self._write_lock:
                await self._call.write(request)
        except Exception as e:  # stream write failed → all records error
            for rid, record in zip(rids, records):
                # drop from in-flight FIRST: the reader's stream-lost cleanup
                # must not error the same records a second time
                self._inflight.pop(rid, None)
                sink.emit_error(record, e)

    async def close(self) -> None:
        if self._reader is not None:
            self._reader.cancel()
        await super().close()


class GrpcAgentSource(_GrpcAgentBase, AgentSource):
    """``grpc-python-source`` — the sidecar's reads stream in; commits and
    permanent failures stream back.

    Correlation uses an instance-identity map (the runner commits the very
    record objects it read), not a header: transport ids must never leak
    into downstream topics."""

    async def start(self) -> None:
        await super().start()
        self._call = self.stubs["read"]()
        self._queue: asyncio.Queue = asyncio.Queue()
        self._write_lock = asyncio.Lock()
        # id(record) → (record, sidecar id); holding the record ref keeps
        # the object alive so CPython can't reuse its id while in flight
        self._ids_by_obj: dict[int, tuple[Record, int]] = {}
        self._reader = asyncio.ensure_future(self._read_batches())

    async def _read_batches(self) -> None:
        try:
            async for response in self._call:
                batch = []
                for msg in response.records:
                    record = record_from_proto(msg)
                    self._ids_by_obj[id(record)] = (record, msg.record_id)
                    batch.append(record)
                await self._queue.put(batch)
        except asyncio.CancelledError:
            return
        except h2.RpcError as e:
            # uncommitted reads die with the sidecar; the restarted user
            # source resumes from its own checkpoint (at-least-once)
            self._ids_by_obj.clear()
            if await self._restart_transport():
                self._call = self.stubs["read"]()
                self._reader = asyncio.ensure_future(self._read_batches())
                self._transport_ready.set()
            else:
                self._escalate(RuntimeError(f"sidecar source lost: {e}"))

    async def read(self) -> list[Record]:
        try:
            return await asyncio.wait_for(self._queue.get(), timeout=0.5)
        except asyncio.TimeoutError:
            return []

    def _pop_sidecar_id(self, record: Record) -> int | None:
        entry = self._ids_by_obj.pop(id(record), None)
        return entry[1] if entry else None

    async def commit(self, records: list[Record]) -> None:
        ids = [
            rid
            for rid in (self._pop_sidecar_id(r) for r in records)
            if rid is not None
        ]
        if ids:
            await self._await_transport()
            async with self._write_lock:
                await self._call.write(
                    self.pb2.SourceRequest(committed_ids=ids)
                )

    async def permanent_failure(self, record: Record, error: Exception) -> None:
        rid = self._pop_sidecar_id(record)
        if rid is not None:
            await self._await_transport()
            async with self._write_lock:
                await self._call.write(
                    self.pb2.SourceRequest(
                        failed_id=rid, failure_error=str(error)
                    )
                )
        raise error

    async def close(self) -> None:
        if getattr(self, "_reader", None) is not None:
            self._reader.cancel()
        await super().close()


class GrpcAgentSink(_GrpcAgentBase, AgentSink):
    """``grpc-python-sink`` — writes await the sidecar's per-record ack."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self._ids = iter(range(1, 1 << 62))
        self._acks: dict[int, asyncio.Future] = {}

    async def start(self) -> None:
        await super().start()
        self._call = self.stubs["write"]()
        self._write_lock = asyncio.Lock()
        self._reader = asyncio.ensure_future(self._read_acks())

    async def _read_acks(self) -> None:
        try:
            async for response in self._call:
                future = self._acks.pop(response.record_id, None)
                if future is None or future.done():
                    continue
                if response.error:
                    future.set_exception(RuntimeError(response.error))
                else:
                    future.set_result(None)
        except asyncio.CancelledError:
            return
        except h2.RpcError as e:
            acks, self._acks = self._acks, {}
            for future in acks.values():
                if not future.done():
                    future.set_exception(RuntimeError(f"sidecar lost: {e}"))
            if await self._restart_transport():
                self._call = self.stubs["write"]()
                self._reader = asyncio.ensure_future(self._read_acks())
                self._transport_ready.set()
            else:
                self._escalate(RuntimeError(f"sidecar sink lost: {e}"))

    async def write(self, record: Record) -> None:
        await self._await_transport()
        rid = next(self._ids)
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._acks[rid] = future
        request = self.pb2.SinkRequest()
        request.record.CopyFrom(record_to_proto(self.pb2, record, rid))
        try:
            async with self._write_lock:
                await self._call.write(request)
        except Exception:
            self._acks.pop(rid, None)  # nobody will await it
            future.cancel()
            raise
        await future

    async def close(self) -> None:
        if getattr(self, "_reader", None) is not None:
            self._reader.cancel()
        await super().close()
