"""The external-agent server: hosts user agent code behind gRPC (the port's
copy of ``langstream_tpu/grpc/server.py``, on the port's HTTP/2 server,
:mod:`langstream_tpu_torch.grpc.h2`, in place of ``grpc.aio``).

Parity: the reference's Python sidecar ``grpc_service.py`` (asyncio
``AgentService(AgentServiceServicer)`` implementing bidi ``read`` /
``process`` / ``write`` / ``get_topic_producer_records``; ``AgentServer``
binds a localhost port and loads the user class from ``className`` config,
``grpc_service.py:75-229,415``).

Run: ``python -m langstream_tpu_torch.grpc.server <config.json>`` — prints
``PORT=<n>`` on stdout once bound (the runtime's process manager reads it).

The user-code contract is the same duck-typed one the in-process lane
accepts (``init``/``read``/``process``/``write``/``commit``/``agent_info``,
sync or async — see :mod:`langstream_tpu_torch.agents.python_custom`), so moving
an agent between in-process and sidecar execution is a config change, not a
code change.
"""

from __future__ import annotations

import asyncio
import json
import logging
import signal
import sys
from typing import Any

from langstream_tpu_torch.api.record import Record
from langstream_tpu_torch.grpc import h2
from langstream_tpu_torch.grpc.codec import record_from_proto, record_to_proto
from langstream_tpu_torch.grpc.proto import SERVICE_NAME, load_messages, method_table

log = logging.getLogger("langstream_tpu_torch.grpc.server")


async def _maybe_await(result):
    if hasattr(result, "__await__"):
        return await result
    if asyncio.isfuture(result):
        return await result
    return result


class _TopicProducerHandle:
    """Handed to user code as context.get_topic_producer(topic): queues
    records for the runtime to publish (the topic_producer_records stream)."""

    def __init__(self, service: "ExternalAgentService", topic: str):
        self.service = service
        self.topic = topic

    async def write(self, record: Any) -> None:
        await self.service.queue_topic_producer_record(self.topic, record)


class _SidecarContext:
    def __init__(self, service: "ExternalAgentService", config: dict[str, Any]):
        self.service = service
        self.config = config

    def get_topic_producer(self, topic: str) -> _TopicProducerHandle:
        return _TopicProducerHandle(self.service, topic)

    def get_persistent_state_directory(self) -> str | None:
        return self.config.get("__persistent_state_directory__")


class ExternalAgentService:
    """The servicer: one user agent instance behind the five RPCs."""

    def __init__(self, config: dict[str, Any]):
        self.pb2 = load_messages()
        self.config = config
        self.delegate: Any = None
        self._read_ids = iter(range(1, 1 << 62))
        self._inflight_source: dict[int, Record] = {}
        self._producer_queue: asyncio.Queue = asyncio.Queue()
        self._producer_id = iter(range(1, 1 << 62))
        # writes awaiting their runtime ack, keyed by record_id — the
        # at-least-once half of the topic-producer lane (parity: the
        # reference returns TopicProducerWriteResult per write,
        # ``agent.proto:73-76`` there)
        self._producer_pending: dict[int, asyncio.Future] = {}

    async def start(self) -> None:
        from langstream_tpu_torch.agents.python_custom import _load_user_class

        cls = _load_user_class(self.config)
        self.delegate = cls()
        if hasattr(self.delegate, "init"):
            await _maybe_await(self.delegate.init(self.config))
        if hasattr(self.delegate, "set_context"):
            await _maybe_await(
                self.delegate.set_context(_SidecarContext(self, self.config))
            )

    async def close(self) -> None:
        if self.delegate is not None and hasattr(self.delegate, "close"):
            await _maybe_await(self.delegate.close())

    async def queue_topic_producer_record(self, topic: str, record: Any) -> None:
        """Queue a record for the runtime to publish and wait for its ack —
        user code's ``await producer.write(record)`` returns only once the
        runtime confirmed the write (raises on a failed one). Blocks until a
        runtime is connected, exactly like a broker producer awaiting its
        broker."""
        from langstream_tpu_torch.agents.python_custom import _coerce_result
        from langstream_tpu_torch.api.record import make_record

        coerced = _coerce_result(record, make_record())
        rid = next(self._producer_id)
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._producer_pending[rid] = future
        await self._producer_queue.put((rid, topic, coerced))
        try:
            await future
        finally:
            self._producer_pending.pop(rid, None)

    # ---- RPC handlers ----------------------------------------------------

    async def agent_info(self, request, context):
        info: dict[str, Any] = {"className": self.config.get("className", "")}
        if hasattr(self.delegate, "agent_info"):
            info.update(await _maybe_await(self.delegate.agent_info()) or {})
        return self.pb2.InfoResponse(info_json=json.dumps(info))

    async def read(self, request_iterator, context):
        """Bidi: we push record batches; requests carry commits/failures."""

        async def consume_requests():
            async for request in request_iterator:
                records = [
                    self._inflight_source.pop(rid)
                    for rid in request.committed_ids
                    if rid in self._inflight_source
                ]
                if records and hasattr(self.delegate, "commit"):
                    await _maybe_await(self.delegate.commit(records))
                if request.failed_id:
                    failed = self._inflight_source.pop(request.failed_id, None)
                    if hasattr(self.delegate, "permanent_failure"):
                        await _maybe_await(
                            self.delegate.permanent_failure(
                                failed, RuntimeError(request.failure_error)
                            )
                        )

        consumer = asyncio.ensure_future(consume_requests())
        try:
            while not context.cancelled():
                batch = await _maybe_await(self.delegate.read())
                if not batch:
                    await asyncio.sleep(0.05)
                    continue
                from langstream_tpu_torch.agents.python_custom import _coerce_result
                from langstream_tpu_torch.api.record import make_record

                response = self.pb2.SourceResponse()
                for item in batch:
                    record = _coerce_result(item, make_record())
                    rid = next(self._read_ids)
                    self._inflight_source[rid] = record
                    response.records.append(
                        record_to_proto(self.pb2, record, rid)
                    )
                yield response
        finally:
            consumer.cancel()

    async def process(self, request_iterator, context):
        """Bidi with out-of-order completion: each record is processed in
        its own task; results stream back as they finish, correlated by
        record_id (parity: ``GrpcAgentProcessor`` correlation)."""
        results: asyncio.Queue = asyncio.Queue()
        pending: set[asyncio.Task] = set()

        async def run_one(msg):
            record = record_from_proto(msg)
            result = self.pb2.ProcessResult(record_id=msg.record_id)
            try:
                out = await _maybe_await(self.delegate.process(record))
                if out is None:
                    out = []
                if not isinstance(out, list):
                    out = [out]
                from langstream_tpu_torch.agents.python_custom import _coerce_result

                for item in out:
                    coerced = _coerce_result(item, record)
                    result.records.append(
                        record_to_proto(self.pb2, coerced, msg.record_id)
                    )
            except Exception as e:  # error travels back, policy is runtime-side
                result.error = f"{type(e).__name__}: {e}"
            await results.put(result)

        async def consume_requests():
            async for request in request_iterator:
                for msg in request.records:
                    task = asyncio.ensure_future(run_one(msg))
                    pending.add(task)
                    task.add_done_callback(pending.discard)
            await asyncio.gather(*list(pending), return_exceptions=True)
            await results.put(None)  # sentinel: input closed and drained

        consumer = asyncio.ensure_future(consume_requests())
        try:
            while True:
                result = await results.get()
                if result is None:
                    break
                response = self.pb2.ProcessResponse()
                response.results.append(result)
                yield response
        finally:
            consumer.cancel()

    async def write(self, request_iterator, context):
        async for request in request_iterator:
            msg = request.record
            response = self.pb2.SinkResponse(record_id=msg.record_id)
            try:
                await _maybe_await(self.delegate.write(record_from_proto(msg)))
            except Exception as e:
                response.error = f"{type(e).__name__}: {e}"
            yield response

    async def topic_producer_records(self, request_iterator, context):
        async def consume_acks():
            async for ack in request_iterator:
                future = self._producer_pending.get(ack.record_id)
                if future is None or future.done():
                    continue
                if ack.error:
                    future.set_exception(
                        RuntimeError(f"topic producer write failed: {ack.error}")
                    )
                else:
                    future.set_result(None)

        consumer = asyncio.ensure_future(consume_acks())
        try:
            while not context.cancelled():
                rid, topic, record = await self._producer_queue.get()
                msg = self.pb2.TopicProducerRecord(record_id=rid, topic=topic)
                msg.record.CopyFrom(record_to_proto(self.pb2, record, rid))
                yield msg
        finally:
            consumer.cancel()
            # the runtime went away: in-flight writes must not hang — fail
            # them so user code can retry once the stream is re-established
            for future in list(self._producer_pending.values()):
                if not future.done():
                    future.set_exception(
                        RuntimeError(
                            "runtime disconnected before acking the write"
                        )
                    )


class AgentServer:
    """Binds the servicer on localhost (parity: ``AgentServer``,
    ``grpc_service.py:415``)."""

    def __init__(self, config: dict[str, Any], port: int = 0):
        self.service = ExternalAgentService(config)
        self.requested_port = port
        self.port: int | None = None
        self._server: h2.Server | None = None

    async def start(self) -> int:
        await self.service.start()
        pb2 = self.service.pb2
        handlers = {}
        for name, spec in method_table(pb2).items():
            handlers[f"/{SERVICE_NAME}/{name}"] = h2.rpc_method_handler(
                spec["kind"],
                getattr(self.service, name),
                request_deserializer=spec["request"].FromString,
                response_serializer=spec["response"].SerializeToString,
            )
        self._server = h2.Server(handlers)
        self.port = await self._server.start("127.0.0.1", self.requested_port)
        return self.port

    async def stop(self, grace: float = 5.0) -> None:
        if self._server is not None:
            await self._server.stop(grace)
        await self.service.close()


async def _main(config_path: str) -> None:
    config = json.loads(
        sys.stdin.read() if config_path == "-" else open(config_path).read()
    )
    server = AgentServer(config)
    port = await server.start()
    print(f"PORT={port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    asyncio.run(_main(sys.argv[1] if len(sys.argv) > 1 else "-"))
