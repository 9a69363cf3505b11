"""The port's HTTP agents and model providers against the JAX package's
(aiohttp), on one stdlib HTTP fake that records what it is sent:

- ``http-request``: GET and POST through 301, 302, 303 and 307 redirects,
  a query string from ``query-string`` on a URL that has one already,
  ``allow-redirects: false``, a text and a JSON answer, a 4xx answer, and a
  run of redirects past the limit;
- ``langserve-invoke``: ``/invoke``, and ``/stream`` answered as a chunked
  SSE stream whose chunks split lines, streamed to ``stream-to-topic``;
- the OpenAI-compatible provider: chat completions whole and streamed (a
  chunked SSE stream ending in ``data: [DONE]``), text completions,
  embeddings, and a 4xx answer;
- the port's client alone: the ``Host`` it sends and the SigV4 signature
  over exactly the request it sends (the default https port left out, as
  aiohttp leaves it out and the JAX signer signs it).

Both packages must send equal requests (method, path, query, body and
``Content-Type``; aiohttp's own default headers are not compared) and give
equal records, streamed chunks and results."""

import asyncio
import datetime
import hashlib
import hmac
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

import pytest

from langstream_tpu.agents import http as jax_http
from langstream_tpu.agents import http_providers as jax_providers
from langstream_tpu.api.record import make_record as jax_make_record
from langstream_tpu_torch.agents import http as port_http
from langstream_tpu_torch.agents import http_providers as port_providers
from langstream_tpu_torch.api.record import make_record
from langstream_tpu_torch.gateway import wire
from langstream_tpu_torch.serving import s3 as port_s3

SSE_OPENAI = [b'data: {"choices": [{"delta": {"role": "assistant"}}]}\n\n',
              b'data: {"choices": [{"delta": {"content": "Hel"}}]}\n\n'
              b'data: {"choices": [{"delta": {"content": "lo, "}}]}\n',
              b'\ndata:{"choices": [{"delta": {"content": "wor"}}]}\n\ndata: {"choi',
              b'ces": [{"delta": {"content": "ld"}}]}\n\n: keep-alive\n\n',
              b"data: [DONE]\n\n", b'data: {"choices": [{"delta": {"content": "late"}}]}\n\n']
SSE_LANGSERVE = [b"event: metadata\ndata: {\"run_id\": \"r1\"}\n\n",
                 b'event: data\ndata: "The "\n\nevent: data\nda', b'ta: {"output": "quick"}\n\n',
                 b'event: data\ndata: " brown fox"\n\ndata: \n\n',
                 b"event: data\ndata: not json\n\nevent: end\n\n"]


class Fake(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    log: list = []

    def log_message(self, *args):
        pass

    def _body(self) -> bytes:
        if "chunked" in self.headers.get("Transfer-Encoding", ""):
            raise AssertionError("the clients send lengths")
        return self.rfile.read(int(self.headers.get("Content-Length") or 0))

    def _answer(self, status, body: bytes = b"", ctype="application/json", headers=()):
        self.send_response(status)
        for k, v in headers:
            self.send_header(k, v)
        if ctype:
            self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _chunked(self, pieces, ctype="text/event-stream"):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Connection", "close")
        self.end_headers()
        for piece in pieces:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(piece), piece))
            self.wfile.flush()
        self.wfile.write(b"0\r\n\r\n")

    def _handle(self):
        body = self._body()
        parts = urlsplit(self.path)
        self.log.append({"method": self.command, "path": parts.path, "query": parts.query,
                         "body": body.decode("latin-1"),
                         "content-type": self.headers.get("Content-Type"),
                         "authorization": self.headers.get("Authorization")})
        path = parts.path
        if path.startswith("/r") and path[2:5].isdigit():
            code, rest = int(path[2:5]), path[5:] or "/echo"
            return self._answer(code, b"moved", "text/plain",
                                [("Location", rest + (f"?{parts.query}" if parts.query else ""))])
        if path == "/loop":
            return self._answer(302, b"", "text/plain", [("Location", "/loop")])
        if path == "/echo":
            return self._answer(200, json.dumps(self.log[-1]).encode())
        if path == "/text":
            return self._answer(200, "café plain".encode("latin-1"),
                                "text/plain; charset=iso-8859-1")
        if path == "/missing":
            return self._answer(404, b'{"error": "no such thing"}')
        if path == "/chain/invoke":
            return self._answer(200, json.dumps({"output": {"answer": json.loads(body)}}).encode())
        if path == "/chain/stream":
            return self._chunked(SSE_LANGSERVE)
        if path == "/v1/chat/completions":
            request = json.loads(body)
            if request.get("stream"):
                return self._chunked(SSE_OPENAI)
            return self._answer(200, json.dumps({
                "choices": [{"message": {"content": f"echo {request['messages'][-1]['content']}"},
                             "finish_reason": "length"}],
                "usage": {"prompt_tokens": 7, "completion_tokens": 3}}).encode())
        if path == "/v1/completions":
            request = json.loads(body)
            return self._answer(200, json.dumps({"choices": [
                {"text": request["prompt"][::-1]}]}).encode())
        if path == "/v1/embeddings":
            request = json.loads(body)
            return self._answer(200, json.dumps({"data": [
                {"embedding": [float(len(t)), 0.5]} for t in request["input"]]}).encode())
        if path == "/bad/v1/chat/completions":
            return self._answer(400, b'{"error": {"message": "bad request"}}')
        return self._answer(404, b"", "text/plain")

    do_GET = do_POST = do_PUT = do_DELETE = _handle


@pytest.fixture(scope="module")
def fake():
    server = ThreadingHTTPServer(("127.0.0.1", 0), Fake)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def _sent(run):
    """What ``run()`` made the fake see."""
    start = len(Fake.log)
    result = run()
    return result, [{k: v for k, v in r.items() if k != "authorization"} for r in Fake.log[start:]]


class Producer:
    def __init__(self):
        self.records = []

    async def write(self, record):
        self.records.append(record)


class Context:
    def __init__(self):
        self.producer = Producer()

    def get_topic_producer(self, topic):
        return self.producer


def _agent(module, make, cls, config, value, context=None):
    async def main():
        agent = getattr(module, cls)()
        await agent.init(config)
        if context is not None:
            await agent.setup(context)
        await agent.start()
        try:
            out = await agent.process_record(make(value=value, key="k", headers={"s": "1"}))
            return [(r.value, r.key, list(r.headers)) for r in out]
        except Exception as e:  # noqa: BLE001  (compared between the packages)
            return ("raised", type(e).__name__, str(e))
        finally:
            await agent.close()

    return asyncio.run(main())


HTTP_CASES = {
    "get-json": {"url": "{base}/echo?a=1", "query-string": {"q": "{{ value.q }}", "x": "a b&c"}},
    "get-301": {"url": "{base}/r301/echo?keep=1", "query-string": {"q": "{{ value.q }}"}},
    "post-302": {"url": "{base}/r302", "method": "POST", "body": "{{ value.q }}"},
    "post-303": {"url": "{base}/r303", "method": "POST", "body": "q={{ value.q }}",
                 "headers": {"X-Trace": "{{ key }}"}},
    "put-307": {"url": "{base}/r307/echo", "method": "PUT", "body": "kept {{ value.q }}",
                "headers": {"Content-Type": "application/json"}},
    "post-301": {"url": "{base}/r301", "method": "POST", "body": "dropped"},
    "no-redirects": {"url": "{base}/r302", "allow-redirects": False,
                     "output-field": "value.moved"},
    "text": {"url": "{base}/text", "output-field": "value.text"},
    "404": {"url": "{base}/missing"},
    "too-many": {"url": "{base}/loop"},
}


@pytest.mark.parametrize("case", sorted(HTTP_CASES))
def test_http_request_equals_the_jax_agent(fake, case):
    config = json.loads(json.dumps(HTTP_CASES[case]).replace("{base}", fake))
    value = {"q": "what? ünï"}
    jax, jax_sent = _sent(lambda: _agent(jax_http, jax_make_record, "HttpRequestAgent", config,
                                         value))
    port, port_sent = _sent(lambda: _agent(port_http, make_record, "HttpRequestAgent", config,
                                           value))
    if case == "too-many":
        assert jax[:2] == ("raised", "TooManyRedirects") and port[:2] == jax[:2]
        assert len(port_sent) == len(jax_sent) == 10
    else:
        assert port == jax
    assert port_sent == jax_sent
    if case == "post-303":
        assert [r["method"] for r in port_sent] == ["POST", "GET"]
        assert port_sent[0]["content-type"] == "text/plain; charset=utf-8"
    if case == "404":
        assert port[0] == "raised" and "404" in port[2]


@pytest.mark.parametrize("endpoint", ["invoke", "stream"])
def test_langserve_invoke_equals_the_jax_agent(fake, endpoint):
    config = {"url": f"{fake}/chain/{endpoint}", "stream-to-topic": "chunks",
              "min-chunks-per-message": 2, "output-field": "value.answer",
              "fields": [{"name": "topic", "expression": "value.topic"},
                         {"name": "n", "expression": "value.n + 1"}]}
    value = {"topic": "foxes", "n": 1}
    results = {}
    for name, module, make in (("jax", jax_http, jax_make_record),
                               ("port", port_http, make_record)):
        context = Context()
        out, sent = _sent(lambda: _agent(module, make, "LangServeInvokeAgent", config, value,
                                         context))
        streamed = [(r.value, r.key, [(k, v) for k, v in r.headers if k != "stream-id"])
                    for r in context.producer.records]
        results[name] = (out, sent, streamed)
    assert results["port"] == results["jax"]
    if endpoint == "stream":
        out, _, streamed = results["port"]
        assert out[0][0]["answer"] == "The quick brown foxnot json"
        assert [s[0] for s in streamed] == ["", "The quick", " brown foxnot json", ""]


def _provider_calls(module, base):
    async def main():
        provider = module.OpenAICompatProvider({"url": f"{base}/v1", "access-key": "sk-1",
                                                "model": "emb-1"})
        completions = provider.get_completions_service({})
        chunks = []

        async def consumer(chunk):
            chunks.append((chunk.text, chunk.index, chunk.last))

        out = {}
        messages = [{"role": "user", "content": "hello there"}]
        options = {"model": "m", "max-tokens": 5, "temperature": 0.0, "stop": ["\n"],
                   "ignored": 1}
        for name, call in (
                ("chat", lambda: completions.chat_completions(messages, options)),
                ("stream", lambda: completions.chat_completions(messages, options, consumer)),
                ("text", lambda: completions.text_completions("abc", options)),
                ("text-consumer", lambda: completions.text_completions("xyz", {}, consumer))):
            result = await call()
            out[name] = {k: getattr(result, k) for k in ("text", "num_prompt_tokens",
                                                         "num_completion_tokens",
                                                         "finish_reason")}
        out["chunks"] = chunks
        out["embeddings"] = await provider.get_embeddings_service({}).compute_embeddings(
            ["a", "bcd"])
        bad = module.OpenAICompatProvider({"url": f"{base}/bad/v1"}).get_completions_service({})
        try:
            await bad.chat_completions(messages, {})
        except Exception as e:  # noqa: BLE001  (compared between the packages)
            out["bad"] = (type(e).__name__, str(e))
        return out

    return asyncio.run(main())


def test_the_openai_provider_equals_the_jax_provider(fake):
    start = len(Fake.log)
    jax = _provider_calls(jax_providers, fake)
    jax_sent = Fake.log[start:]
    start = len(Fake.log)
    port = _provider_calls(port_providers, fake)
    port_sent = Fake.log[start:]
    assert port == jax
    assert port_sent == jax_sent
    assert port["stream"]["text"] == "Hello, world"
    assert port["chunks"][:5] == [("Hel", 0, False), ("lo, ", 1, False), ("wor", 2, False),
                                  ("ld", 3, False), ("", 4, True)]
    assert port["bad"] == ("KeyError", "'choices'")
    assert {r["authorization"] for r in port_sent[:-1]} == {"Bearer sk-1"}


def test_the_services_resolve_the_http_providers():
    from langstream_tpu_torch.agents import services

    for kind in ("open-ai-configuration", "ollama-configuration"):
        provider = services.resolve_service_provider(
            {"r": {"type": kind, "name": "r", "url": "http://127.0.0.1:1/v1"}})
        assert isinstance(provider, port_providers.OpenAICompatProvider)
        assert provider.get_completions_service({}).base_url == "http://127.0.0.1:1/v1"


# ---------------------------------------------------------------------------
# what the port's client sends: Host, and SigV4 over exactly that
# ---------------------------------------------------------------------------


class _Capture:
    def __init__(self):
        self.data = b""

    def write(self, data):
        self.data += data

    async def drain(self):
        pass

    def close(self):
        pass


def _send(monkeypatch, method, url, **kwargs) -> bytes:
    """What the client writes for one request (answered 200, empty)."""
    captured = _Capture()

    async def fake_connection(host, port, **kw):
        reader = asyncio.StreamReader()
        reader.feed_data(b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n")
        reader.feed_eof()
        return reader, captured

    monkeypatch.setattr(wire.asyncio, "open_connection", fake_connection)

    async def main():
        async with await wire.open_response(method, url, **kwargs) as resp:
            await resp.read()

    asyncio.run(main())
    return captured.data


@pytest.mark.parametrize("url,host", [
    ("https://bucket.s3.amazonaws.com/a%20b.txt?list-type=2&prefix=x%2Fy", "bucket.s3.amazonaws.com"),
    ("https://bucket.s3.amazonaws.com:443/k", "bucket.s3.amazonaws.com"),
    ("http://minio:80/b/k", "minio"),
    ("http://127.0.0.1:9000/b/k", "127.0.0.1:9000"),
    ("https://[::1]:8443/b", "[::1]:8443")])
def test_host_and_the_sigv4_signature_cover_what_is_sent(monkeypatch, url, host):
    """The ``Host`` follows aiohttp's rule, and a request signed by the
    port's SigV4 carries a signature that a server recomputing it over the
    request line and headers it received accepts: the signed ``host`` is the
    ``Host`` sent, also where the URL names the default port."""
    assert wire.host_header(url) == host
    plain = _send(monkeypatch, "GET", url).decode("latin-1").split("\r\n")
    assert f"Host: {host}" in plain
    now = datetime.datetime(2024, 1, 2, 3, 4, 5, tzinfo=datetime.timezone.utc)
    signed = port_s3.sigv4_headers("PUT", url, access_key="AK", secret_key="SK", payload=b"xy",
                                   now=now)
    head, _, body = _send(monkeypatch, "PUT", url, data=b"xy", headers=signed).partition(
        b"\r\n\r\n")
    assert body == b"xy"
    lines = head.decode("latin-1").split("\r\n")
    method, target, _ = lines[0].split(" ")
    sent = {}
    for line in lines[1:]:
        k, _, v = line.partition(": ")
        assert k.lower() not in sent, f"{k} sent twice"
        sent[k.lower()] = v
    path, _, query = target.partition("?")
    pairs = sorted(tuple(p.split("=", 1)) for p in query.split("&") if p)
    names = "host;x-amz-content-sha256;x-amz-date"
    canonical = "\n".join([method, path, "&".join(f"{k}={v}" for k, v in pairs),
                           "".join(f"{n}:{sent[n]}\n" for n in names.split(";")), names,
                           hashlib.sha256(body).hexdigest()])
    scope = f"{now:%Y%m%d}/us-east-1/s3/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", sent["x-amz-date"], scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
    key = b"AWS4SK"
    for part in (f"{now:%Y%m%d}", "us-east-1", "s3", "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    expected = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
    assert sent["authorization"].endswith(f"Signature={expected}")
    assert sent["content-type"] == "application/octet-stream"
    if urlsplit(url).port is None:  # the JAX signer signs the same host for such a URL
        from langstream_tpu.agents.s3_impl import sigv4_headers

        assert sigv4_headers("PUT", url, access_key="AK", secret_key="SK", payload=b"xy",
                             now=now) == signed


def test_query_and_bodies_are_sent_as_aiohttp_sends_them(monkeypatch):
    head = _send(monkeypatch, "POST", "http://h/p a?x=1#frag",
                 params={"q": "a b&c=d+e/f?~%", "n": 2}, data="text").decode()
    assert head.startswith("POST /p%20a?x=1&q=a+b%26c%3Dd%2Be/f?~%25&n=2 HTTP/1.1\r\n")
    assert "Content-Type: text/plain; charset=utf-8\r\n" in head
    assert "Content-Length: 4\r\n" in head and head.endswith("\r\n\r\ntext")
    put = _send(monkeypatch, "PUT", "http://h/c", headers={"host": "other"}).decode()
    assert "Content-Length: 0\r\n" in put and "Content-Type" not in put
    assert "host: other\r\n" in put and "Host:" not in put
    get = _send(monkeypatch, "GET", "http://h/c", json_body={"a": 1}).decode()
    assert "Content-Type: application/json\r\n" in get and get.endswith('{"a": 1}')
