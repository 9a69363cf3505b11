"""The port's gateway (``langstream_tpu_torch/gateway``, on its stdlib
HTTP/WebSocket server) against the JAX package's aiohttp gateway: the same
application deployed behind each, the same client script, through aiohttp's
client and through the port's own (``gateway/wire.py``), and the frames
equal apart from ids, offsets and times.

Covered: produce and consume with session filters, ``/v1/chat`` on the
``chatbot-gateway`` example's unauthenticated gateway, HTTP produce and its
server-sent-events variant, QoS 429s (HTTP, the WebSocket upgrade, and per
message), a disconnect that cancels the stream and frees the engine's slot,
records longer than 125 and 65,535 bytes both ways, fragmented client frames
with a ping between them, and the close handshake. An authenticated
gateway refuses a socket without credentials (401), and the service route
answers over the topics (the JAX comparison of both is in
``tests/test_torch_gateway_auth.py``)."""

import asyncio
import contextlib
import itertools
import json
import socket
import struct
from pathlib import Path

import aiohttp
import pytest
import yaml

from langstream_tpu.controlplane.server import LocalComputeRuntime as JaxCompute
from langstream_tpu.controlplane.stores import StoredApplication as JaxStored
from langstream_tpu.gateway.server import GatewayRegistry as JaxRegistry
from langstream_tpu.gateway.server import GatewayServer as JaxGateway
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu.serving.streaming import STREAMS as JAX_STREAMS
from langstream_tpu_torch.controlplane.server import LocalComputeRuntime
from langstream_tpu_torch.controlplane.stores import StoredApplication
from langstream_tpu_torch.gateway import wire
from langstream_tpu_torch.gateway.server import GatewayRegistry, GatewayServer
from langstream_tpu_torch.serving.engine import TorchServingEngine
from langstream_tpu_torch.serving.streaming import STREAMS as PORT_STREAMS

REPO = Path(__file__).resolve().parents[1]
APPS = REPO / "examples" / "applications"
FIXTURE = str(REPO / "tests" / "fixtures" / "llama_tiny_golden")
_CLUSTERS = itertools.count()
TIMEOUT = 30.0
SECRETS = (REPO / "examples" / "secrets" / "secrets.yaml").read_text()

MOCK = {"configuration": {"resources": [{
    "type": "mock-serving-configuration", "name": "mock",
    "configuration": {"chunk-delay": 0.002}}]}}

EXTRA_GATEWAYS = [
    {"id": "user-input-stream", "type": "produce", "topic": "questions-topic",
     "stream-topic": "stream-topic", "parameters": ["sessionId"],
     "produce-options": {"headers": [{"key": "langstream-client-session-id",
                                      "value-from-parameters": "sessionId"}]}},
    {"id": "raw-questions", "type": "consume", "topic": "questions-topic"},
    {"id": "answers", "type": "consume", "topic": "answers-topic", "parameters": ["sessionId"],
     "consume-options": {"filters": {"headers": [{"key": "langstream-client-session-id",
                                                   "value-from-parameters": "sessionId"}]}}},
    {"id": "service", "type": "service",
     "service-options": {"input-topic": "questions-topic", "output-topic": "answers-topic"}},
]


def chat_files(configuration=MOCK):
    """The chat-completions example: its pipeline, its gateways plus a
    streaming produce gateway, consumers of the raw questions and of the
    answers, and a service gateway; the given resource."""
    gateways = yaml.safe_load((APPS / "chat-completions" / "gateways.yaml").read_text())
    gateways["gateways"] += EXTRA_GATEWAYS
    return {"pipeline.yaml": (APPS / "chat-completions" / "pipeline.yaml").read_text(),
            "gateways.yaml": yaml.safe_dump(gateways),
            "configuration.yaml": yaml.safe_dump(configuration)}


def chatbot_files():
    return {"pipeline.yaml": (APPS / "chatbot-gateway" / "pipeline.yaml").read_text(),
            "gateways.yaml": (APPS / "chatbot-gateway" / "gateways.yaml").read_text(),
            "configuration.yaml": yaml.safe_dump(MOCK)}


QOS_FILES = {
    "pipeline.yaml": """
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
""",
    "configuration.yaml": """
configuration:
  resources:
    - type: "tpu-serving-configuration"
      name: "tpu"
      configuration:
        model: "tiny"
        qos:
          tenants:
            alice:
              requests-per-s: 0.02
              burst: 1
            bob:
              requests-per-s: 0.02
              burst: 2
""",
    "gateways.yaml": """
gateways:
  - id: "produce-input"
    type: produce
    topic: "input-topic"
    parameters: [sessionId]
""",
}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _instance():
    return yaml.safe_dump({"instance": {
        "streamingCluster": {"type": "memory",
                             "configuration": {"cluster": f"gw-{next(_CLUSTERS)}"}},
        "globals": {"chat-model": "tiny"}}})


@contextlib.asynccontextmanager
async def deployed(side, files, name="app"):
    """``files`` deployed as ``t1/<name>`` behind ``side``'s gateway; yields
    the gateway's base URL."""
    if side == "jax":
        registry = JaxRegistry()
        compute = JaxCompute(gateway_registry=registry)
        gateway = JaxGateway(registry=registry, port=free_port())
        stored = JaxStored(tenant="t1", name=name, files=files, instance=_instance(),
                           secrets=SECRETS)
    else:
        registry = GatewayRegistry()
        compute = LocalComputeRuntime(gateway_registry=registry)
        gateway = GatewayServer(registry=registry, port=0)
        stored = StoredApplication(tenant="t1", name=name, files=files, instance=_instance(),
                                   secrets=SECRETS)
    await gateway.start()
    try:
        await compute.deploy(stored)
        yield f"127.0.0.1:{gateway.port}"
    finally:
        await gateway.stop()
        await compute.close()
        for cls in (TorchServingEngine, TpuServingEngine):
            engines = list(cls._instances.values())
            cls.reset_instances()
            for engine in engines:
                await engine.close()


# ---------------------------------------------------------------------------
# two clients behind one interface
# ---------------------------------------------------------------------------

class Refused(Exception):
    def __init__(self, status, headers):
        super().__init__(status)
        self.status = status
        self.headers = {k.lower(): v for k, v in headers.items()}


class AiohttpClient:
    name = "aiohttp"

    async def __aenter__(self):
        self.session = aiohttp.ClientSession()
        return self

    async def __aexit__(self, *exc):
        await self.session.close()

    async def ws(self, url):
        try:
            ws = await self.session.ws_connect(f"ws://{url}")
        except aiohttp.WSServerHandshakeError as e:
            raise Refused(e.status, dict(e.headers or {})) from None
        return _AiohttpSocket(ws)

    async def post(self, url, payload):
        async with self.session.post(f"http://{url}", json=payload) as resp:
            body = await resp.read()
            return resp.status, {k.lower(): v for k, v in resp.headers.items()}, body

    async def sse(self, url, payload, until):
        events = []
        async with self.session.post(f"http://{url}", json=payload) as resp:
            async for line in resp.content:
                text = line.decode().rstrip("\r\n")
                if text.startswith("data: "):
                    events.append(json.loads(text[6:]))
                    if until(events[-1]):
                        break
            resp.close()  # an unfinished stream: the connection goes away
            return resp.status, events


class _AiohttpSocket:
    def __init__(self, ws):
        self.ws = ws

    async def send_json(self, data):
        await self.ws.send_json(data)

    async def receive_json(self):
        return await self.ws.receive_json(timeout=TIMEOUT)

    async def close(self):
        await self.ws.close()


class PortClient:
    name = "port"

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        pass

    async def ws(self, url):
        try:
            ws = await wire.WebSocketClient.connect(f"ws://{url}")
        except wire.HandshakeError as e:
            raise Refused(e.status, {}) from None
        return _PortSocket(ws)

    async def post(self, url, payload):
        status, _, headers, body = await wire.http_request("POST", f"http://{url}", payload)
        return status, headers, body

    async def sse(self, url, payload, until):
        status, _, events = await wire.sse_events(f"http://{url}", payload, until=until,
                                                  timeout=TIMEOUT)
        return status, events


class _PortSocket:
    def __init__(self, ws):
        self.ws = ws

    async def send_json(self, data):
        await self.ws.send_json(data)

    async def receive_json(self):
        return await self.ws.receive_json(TIMEOUT)

    async def close(self):
        await self.ws.close()


CLIENTS = {"aiohttp": AiohttpClient, "port": PortClient}

VOLATILE = {"trace", "stream-id", "offset", "langstream-trace", "langstream-stream-id",
            "retry-after"}


def norm(obj):
    """A frame without its ids, offsets and times."""
    if isinstance(obj, dict):
        return {k: ("<volatile>" if k in VOLATILE else norm(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [norm(v) for v in obj]
    return obj


def _last(frame):
    return frame.get("record", {}).get("headers", {}).get("stream-last-message") == "true"


async def _until(sock, stop):
    frames = []
    while True:
        frames.append(await sock.receive_json())
        if stop(frames[-1]):
            return frames


def run_everywhere(files, script):
    """``script(client, base)`` against both gateways with both clients;
    the four normalised results."""
    results = {}
    for side in ("jax", "port"):
        for client_name, client_cls in CLIENTS.items():
            async def main():
                async with deployed(side, files) as base, client_cls() as client:
                    return await script(client, base)

            results[(side, client_name)] = norm(asyncio.run(main()))
    return results


def assert_all_equal(results):
    reference = results[("jax", "aiohttp")]
    for key, value in results.items():
        assert value == reference, key


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------

async def produce_consume(client, base):
    """Two sessions' consumers; each session's question streams back to its
    own socket only (the session filter)."""
    app = f"{base}/v1/%s/t1/app/%s?param:sessionId=%s"
    out = []
    consumers = {s: await client.ws(app % ("consume", "bot-output", s)) for s in ("s1", "s2")}
    for session, question in (("s1", "first question"), ("s2", "second one")):
        producer = await client.ws(app % ("produce", "user-input", session))
        await producer.send_json({"value": question, "headers": {"extra": "h"}})
        out.append(await producer.receive_json())
        out.append(await _until(consumers[session], _last))
        await producer.close()
    for sock in consumers.values():
        await sock.close()
    return out


async def http_produce_and_sse(client, base):
    out = []
    consumer = await client.ws(f"{base}/v1/consume/t1/app/bot-output?param:sessionId=h1")
    status, headers, body = await client.post(
        f"{base}/api/gateways/produce/t1/app/user-input?param:sessionId=h1",
        {"value": "over http"})
    out.append((status, json.loads(body), "langstream-trace" in headers))
    out.append(await _until(consumer, _last))
    await consumer.close()
    status, events = await client.sse(
        f"{base}/api/gateways/produce/t1/app/user-input-stream"
        "?param:sessionId=h2&option:streaming=true", {"value": "streamed over sse"}, _last)
    out.append((status, events))
    status, _, body = await client.post(
        f"{base}/api/gateways/produce/t1/app/user-input?param:sessionId=h1", ["not", "a", "map"])
    out.append((status, body.decode()))
    status, _, _ = await client.post(f"{base}/api/gateways/produce/t1/app/user-input", {})
    out.append(status)
    status, _, _ = await client.post(f"{base}/api/gateways/produce/t1/nope/user-input", {})
    out.append(status)
    return out


async def streaming_produce(client, base):
    """``option:streaming=true`` on a produce socket: the chunks come back
    on the same socket, matched by the stream id the ack names."""
    sock = await client.ws(f"{base}/v1/produce/t1/app/user-input-stream"
                           "?param:sessionId=w1&option:streaming=true")
    await sock.send_json({"value": "stream it"})
    ack = await sock.receive_json()
    frames = await _until(sock, _last)
    await sock.close()
    assert all(f["record"]["headers"]["langstream-stream-id"] == ack["stream-id"]
               for f in frames)
    return [ack, frames]


async def long_records(client, base):
    """Values of 200 and 70,000 bytes: client frames with 16- and 64-bit
    lengths in, the consumer's frames out."""
    raw = await client.ws(f"{base}/v1/consume/t1/app/raw-questions")
    producer = await client.ws(f"{base}/v1/produce/t1/app/user-input?param:sessionId=big")
    out = []
    for n in (200, 70_000):
        await producer.send_json({"value": "x" * n})
        out.append(await producer.receive_json())
        frame = await raw.receive_json()
        out.append(len(frame["record"]["value"]))
    await producer.close()
    await raw.close()
    return out


async def chat(client, base):
    sock = await client.ws(f"{base}/v1/chat/t1/app/chat?param:sessionId=c1")
    out = []
    for question in ("hello chat", "and again"):
        await sock.send_json({"value": question})
        out.append(await _until(sock, lambda f: isinstance(
            f.get("record", {}).get("value"), dict)))
    await sock.close()
    return out


async def throttled(client, base):
    app = f"{base}/%s/t1/app/produce-input?param:sessionId=s1&param:tenant=%s"
    out = []
    status, headers, body = await client.post(app % ("api/gateways/produce", "alice"),
                                              {"value": "hello"})
    out.append(status)
    status, headers, body = await client.post(app % ("api/gateways/produce", "alice"),
                                              {"value": "again"})
    out.append((status, headers["langstream-throttled"], int(headers["retry-after"]) >= 1,
                json.loads(body)))
    with pytest.raises(Refused) as info:
        await client.ws(app % ("v1/produce", "alice"))
    out.append(info.value.status)
    sock = await client.ws(app % ("v1/produce", "bob"))
    for _ in range(3):
        await sock.send_json({"value": "ws message"})
        out.append(await sock.receive_json())
    await sock.close()
    return out


async def many_sessions(client, base):
    """24 sessions at once on one gateway loop, each its own produce and
    consume socket: every session gets its own answer, whole."""
    app = f"{base}/v1/%s/t1/app/%s?param:sessionId=m%d"

    async def session(i):
        consumer = await client.ws(app % ("consume", "bot-output", i))
        producer = await client.ws(app % ("produce", "user-input", i))
        await producer.send_json({"value": f"question number {i}"})
        ack = await producer.receive_json()
        frames = await _until(consumer, _last)
        await producer.close()
        await consumer.close()
        return ack["status"], "".join(f["record"]["value"] for f in frames)

    return await asyncio.gather(*(session(i) for i in range(24)))


SCRIPTS = {
    "many-sessions": (chat_files, many_sessions),
    "produce-consume": (chat_files, produce_consume),
    "http-produce-and-sse": (chat_files, http_produce_and_sse),
    "streaming-produce": (chat_files, streaming_produce),
    "long-records": (chat_files, long_records),
    "chat": (chatbot_files, chat),
    "throttled": (lambda: QOS_FILES, throttled),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_frames_equal_the_jax_gateway(name):
    files, script = SCRIPTS[name]
    results = run_everywhere(files(), script)
    assert_all_equal(results)
    assert results[("port", "port")]


def test_throttled_frames_carry_retry_hints():
    results = run_everywhere(QOS_FILES, throttled)
    for key, (first, second, upgrade, *acks) in results.items():
        assert first == 200 and second[:3] == [429, "alice", True], key
        assert second[3]["status"] == "THROTTLED" and upgrade == 429, key
        assert [a["status"] for a in acks] == ["OK", "OK", "THROTTLED"], key


# ---------------------------------------------------------------------------
# disconnect as cancellation, on the engines
# ---------------------------------------------------------------------------

SLOW_TINY = {"configuration": {"resources": [{
    "type": "tpu-serving-configuration", "name": "tpu",
    "configuration": {"model": "tiny", "model-dtype": "float32", "slots": 2,
                      "max-seq-len": 2048, "checkpoint": FIXTURE, "decode-chunk": 1,
                      "decode-chunk-light": 1, "max-tokens": 2000}}]}}


async def _ws_then_leave(client, url):
    sock = await client.ws(url)
    await sock.send_json({"value": "a long answer please"})
    ack = await sock.receive_json()
    first = await sock.receive_json()
    await sock.close()
    return ack["status"], first


async def _sse_then_leave(client, url):
    status, events = await client.sse(url.replace("/v1/produce/", "/api/gateways/produce/"),
                                      {"value": "a long answer please"}, lambda e: True)
    return status, events[0]


@pytest.mark.parametrize("route", ["websocket", "sse"])
@pytest.mark.parametrize("client_name", sorted(CLIENTS))
def test_disconnect_cancels_the_stream_and_frees_the_slot(monkeypatch, client_name, route):
    """A streaming produce socket, or a server-sent-events response, that
    goes away mid-answer cancels the engine's request under its stream id:
    the slot frees, the stream registry empties, and the record ends with
    no answer, on both."""
    from langstream_tpu_torch.agents import services as port_services

    monkeypatch.setattr(port_services, "SERVING_DEVICE", "cpu")
    files = chat_files(SLOW_TINY)
    leave = _ws_then_leave if route == "websocket" else _sse_then_leave
    seen = {}
    for side, engines, streams in (("jax", TpuServingEngine, JAX_STREAMS),
                                   ("port", TorchServingEngine, PORT_STREAMS)):
        async def main():
            async with deployed(side, files) as base, CLIENTS[client_name]() as client:
                ack, first = await leave(client, f"{base}/v1/produce/t1/app/user-input-stream"
                                                 "?param:sessionId=d1&option:streaming=true")
                (engine,) = engines._instances.values()
                for _ in range(400):
                    stats = engine.stats()
                    if stats["active"] == 0 and streams.active() == 0:
                        break
                    await asyncio.sleep(0.05)
                answers = await client.ws(f"{base}/v1/consume/t1/app/answers"
                                          "?param:sessionId=d1&option:position=earliest")
                with pytest.raises((asyncio.TimeoutError, TimeoutError)):
                    await asyncio.wait_for(answers.receive_json(), 1.0)
                await answers.close()
                return (ack, first["record"]["headers"]["stream-index"],
                        stats["active"], streams.active(),
                        0 < stats["total-generated"] < 2000)

        seen[side] = asyncio.run(main())
    assert seen["port"] == seen["jax"] == ("OK" if route == "websocket" else 200, "0", 0, 0, True)


# ---------------------------------------------------------------------------
# what the port refuses, and the wire itself
# ---------------------------------------------------------------------------

def test_authenticated_and_service_gateways_answer_501():
    """Named for the check it replaced, when both answered 501. Since gateway
    authentication and the service gateways are ported, neither answers
    501: the authenticated chat refuses a socket without
    valid credentials with 401 (both clients), and the service route makes
    its round trip over the topics (``tests/test_torch_gateway_auth.py``
    holds both against the JAX gateway)."""
    async def main():
        async with deployed("port", chatbot_files()) as base, aiohttp.ClientSession() as session:
            with pytest.raises(aiohttp.WSServerHandshakeError) as info:
                await session.ws_connect(
                    f"ws://{base}/v1/chat/t1/app/authenticated-chat?credentials=x")
            assert info.value.status == 401
            with pytest.raises(wire.HandshakeError) as port_info:
                await wire.WebSocketClient.connect(
                    f"ws://{base}/v1/chat/t1/app/authenticated-chat")
            assert port_info.value.status == 401
            assert port_info.value.body == b"401: missing bearer token"
        async with deployed("port", chat_files()) as base:
            status, reason, _, body = await wire.http_request(
                "POST", f"http://{base}/api/gateways/service/t1/app/service",
                {"value": "a question"})
            assert status == 200, (reason, body)
            assert json.loads(body)["record"]["value"]["question"] == "a question"
            status, *_ = await wire.http_request(
                "GET", f"http://{base}/api/gateways/service/t1/app/nope")
            assert status == 404
            status, *_ = await wire.http_request("GET", f"http://{base}/v1/produce/t1/app")
            assert status == 404
            status, *_ = await wire.http_request("GET", f"http://{base}/v1/produce/t1/app/user-input"
                                                 "?param:sessionId=x")
            assert status == 400  # not an upgrade request

    asyncio.run(main())


@pytest.mark.parametrize("side", ["jax", "port"])
def test_fragments_pings_and_the_close_handshake(side):
    """The port's client against both servers: a text message in three
    fragments with a ping between them is one produce; the ping's pong
    comes first; a close is answered with the same code."""
    async def main():
        async with deployed(side, chat_files()) as base:
            ws = await wire.WebSocketClient.connect(
                f"ws://{base}/v1/produce/t1/app/user-input?param:sessionId=f1")
            raw = await wire.WebSocketClient.connect(f"ws://{base}/v1/consume/t1/app/raw-questions")
            message = b'{"value": "fragmented ' + b"y" * 300 + b'"}'
            await ws.send_frame(wire.WSMsgType.TEXT, message[:10], fin=False)
            await ws.send_frame(wire.WSMsgType.PING, b"are you there")
            await ws.send_frame(wire.WSMsgType.CONTINUATION, message[10:200], fin=False)
            await ws.send_frame(wire.WSMsgType.CONTINUATION, message[200:], fin=True)
            fin, opcode, payload = await ws._read_frame()
            assert (fin, opcode, payload) == (True, wire.WSMsgType.PONG, b"are you there")
            ack = await ws.receive_json(TIMEOUT)
            record = await raw.receive_json(TIMEOUT)
            await ws.send_frame(wire.WSMsgType.CLOSE, struct.pack("!H", 1000))
            closing = await ws.receive(TIMEOUT)
            await raw.close()
            return ack["status"], record["record"]["value"], closing.type, closing.data

    status, value, kind, code = asyncio.run(main())
    assert (status, kind, code) == ("OK", wire.WSMsgType.CLOSE, 1000)
    assert value == "fragmented " + "y" * 300


def test_frame_codec_round_trips_every_length_class():
    """7-, 16- and 64-bit lengths, masked and not; the accept key of the
    RFC's own example."""
    assert wire.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="

    async def main():
        out = []
        for n in (0, 125, 126, 65535, 65536, 200_000):
            for masked in (False, True):
                reader = asyncio.StreamReader()
                reader.feed_data(wire.encode_frame(wire.WSMsgType.BINARY, b"z" * n, True, masked))
                ws = wire.WebSocketClient()
                ws._reader = reader
                out.append(await ws._read_frame() == (True, wire.WSMsgType.BINARY, b"z" * n))
        return out

    assert all(asyncio.run(main()))


CHUNKED_BODIES = {
    "well-formed": (b'f\r\n{"value": "hi"}\r\n0\r\n\r\n', 200),
    "size-not-hex": (b'zz\r\n{"value": "hi"}\r\n0\r\n\r\n', 400),
    "no-crlf-after-chunk": (b'2\r\n{}XX0\r\n\r\n', 400),
    "size-line-too-long": (b"f" * 70_000 + b"\r\n", 400),
}


@pytest.mark.parametrize("case", sorted(CHUNKED_BODIES))
def test_a_chunked_body_is_read_or_refused_with_400(case):
    """A chunked HTTP produce over a raw socket: a well-formed body is
    produced, a malformed one is answered 400 (not a dropped connection),
    and the connection is served to its end."""
    body, expected = CHUNKED_BODIES[case]

    async def main():
        async with deployed("port", chat_files()) as base:
            host, port = base.split(":")
            reader, writer = await asyncio.open_connection(host, int(port))
            writer.write(b"POST /api/gateways/produce/t1/app/user-input?param:sessionId=c1 "
                         b"HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                         b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n" + body)
            await writer.drain()
            status_line = await asyncio.wait_for(reader.readline(), TIMEOUT)
            writer.close()
            return status_line

    status_line = asyncio.run(main())
    assert status_line.split(b" ")[1] == str(expected).encode(), status_line
