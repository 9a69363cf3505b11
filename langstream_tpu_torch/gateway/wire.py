"""HTTP/1.1 and WebSocket (RFC 6455) on the standard library's asyncio, for
the port's gateway; a small client beside the server.

The server side is the subset of ``aiohttp.web`` the gateway uses, under
the same names, so the gateway's handlers read as the JAX package's:

- :class:`HttpServer` routes ``METHOD /path/{name}/...`` patterns to
  ``async def handler(request)``; a handler returns a :class:`Response`
  (:func:`json_response`), or prepares a :class:`StreamResponse` (server-
  sent events) or a :class:`WebSocketResponse` on the request's connection;
  it refuses with :class:`HTTPException` (status, reason, headers), which
  answers ``"<status>: <reason>"`` as aiohttp does.
- Requests: the request line, headers, ``Content-Length`` and chunked
  bodies, keep-alive, the query string (:class:`Query`, every pair in
  order), percent-decoded path parameters.
- WebSocket: the upgrade answers ``Sec-WebSocket-Accept`` = base64(SHA-1(key
  + the RFC's GUID)); the client's masked frames are unmasked on receipt,
  the server's frames go out unmasked; 7-, 16- and 64-bit payload lengths; fragmented messages are
  reassembled from continuation frames (control frames may come between
  them); a ping is answered with a pong; a close frame is answered with a
  close frame carrying its code, after which the socket ends. A message
  over :data:`MAX_MESSAGE` bytes closes with 1009, bad UTF-8 in a text
  message with 1007, a protocol error with 1002.
- A client that goes away while a stream response is open cancels its
  handler (as aiohttp does), so a handler's ``CancelledError`` branch is
  its disconnect branch.

Each frame is one ``write`` on the transport, so frames from concurrent
tasks of one socket never interleave.

The client (:class:`WebSocketClient`, :func:`open_response`, with
:func:`http_request` and :func:`sse_events` on it) speaks the same protocol
from the other side: masked frames, optional fragmentation, ping and
close, over TCP or TLS (https and wss); every request is written by one
function and every response body read by :class:`ClientResponse`. Tests
and the smoke drive the gateway with it where aiohttp is not installed,
and the port's agents and stores reach their services through it.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import os
import re
import struct
from typing import Any, Awaitable, Callable
from urllib.parse import parse_qsl, quote, unquote, urlsplit

log = logging.getLogger(__name__)

#: what aiohttp (yarl) leaves unquoted in a request's path
_PATH_SAFE = "/%:@!$&'()*+,;=~"
#: the RFC 6455 GUID the accept hash appends to the client's key
WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
#: largest WebSocket message (reassembled) either side accepts
MAX_MESSAGE = 4 * 1024 * 1024
#: largest request head (request line plus headers) and body
MAX_HEAD = 64 * 1024
MAX_BODY = 16 * 1024 * 1024

_REASONS = {
    101: "Switching Protocols", 200: "OK", 201: "Created", 400: "Bad Request",
    401: "Unauthorized", 404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    413: "Payload Too Large",
    429: "Too Many Requests", 500: "Internal Server Error", 501: "Not Implemented",
    502: "Bad Gateway", 504: "Gateway Timeout",
}


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + WS_GUID).encode()).digest()).decode()


def _reason_phrase(text: str) -> str:
    return re.sub(r"[\r\n]+", " ", text)


# ---------------------------------------------------------------------------
# requests and responses
# ---------------------------------------------------------------------------


class Query:
    """The query string's pairs in order (``items``), ``get`` the first
    value of a name."""

    def __init__(self, pairs: list[tuple[str, str]]):
        self._pairs = pairs

    def items(self) -> list[tuple[str, str]]:
        return list(self._pairs)

    def get(self, name: str, default: Any = None) -> Any:
        for k, v in self._pairs:
            if k == name:
                return v
        return default


class Request:
    def __init__(self, method: str, target: str, version: str,
                 headers: dict[str, str], body: bytes,
                 reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.method = method
        self.version = version
        parts = urlsplit(target)
        self.path = unquote(parts.path)
        self.raw_path = parts.path
        self.query_string = parts.query
        self.query = Query(parse_qsl(parts.query, keep_blank_values=True))
        self.headers = headers
        self.body = body
        self.match_info: dict[str, str] = {}
        self._reader = reader
        self._writer = writer
        #: set when a handler took the connection over (101, a stream)
        self.taken_over: "StreamResponse | WebSocketResponse | None" = None
        self._server: "HttpServer | None" = None
        self._handler_task: asyncio.Task | None = None
        self._watcher: asyncio.Task | None = None

    def _watch_disconnect(self) -> None:
        """Cancel the handler when the client's side of the connection
        ends (it sends nothing more once a stream response is open)."""
        async def watch() -> None:
            try:
                while await self._reader.read(1024):
                    pass
            except ConnectionError:
                pass
            if self._handler_task is not None and not self._handler_task.done():
                self._handler_task.cancel()

        self._watcher = asyncio.ensure_future(watch())

    async def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))

    @property
    def can_read_body(self) -> bool:
        """Whether the request carried a body (aiohttp's name)."""
        return bool(self.body)

    async def read(self) -> bytes:
        return self.body

    @property
    def content_type(self) -> str:
        """The body's media type, without parameters (aiohttp's name)."""
        return self.headers.get("content-type", "").split(";")[0].strip().lower()

    def keep_alive(self) -> bool:
        connection = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in connection
        return "close" not in connection


def multipart_parts(body: bytes, content_type: str) -> list[tuple[str | None, bytes]]:
    """A ``multipart/form-data`` body's parts in order: each part's
    ``Content-Disposition`` ``name`` and its payload with any
    ``Content-Transfer-Encoding`` undone (aiohttp's ``part.read(decode=
    True)``). A body that is not multipart, or has no boundary, raises
    :class:`HTTPException` 400."""
    from email.parser import BytesParser
    from email.policy import HTTP

    if "multipart/" not in content_type.lower() or "boundary=" not in content_type.lower():
        raise HTTPException(400, "expected a multipart body with a boundary")
    message = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body)
    if not message.is_multipart():
        raise HTTPException(400, "malformed multipart body")
    parts = []
    for part in message.iter_parts():
        payload = part.get_payload(decode=True)
        parts.append((part.get_param("name", header="content-disposition"),
                      payload if payload is not None else b""))
    return parts


class Response:
    def __init__(self, status: int = 200, body: bytes | str = b"",
                 headers: dict[str, str] | None = None,
                 content_type: str = "text/plain; charset=utf-8"):
        self.status = status
        self.body = body.encode() if isinstance(body, str) else body
        self.headers = {"Content-Type": content_type, **(headers or {})}

    def head(self, keep_alive: bool) -> bytes:
        lines = [f"HTTP/1.1 {self.status} {_REASONS.get(self.status, 'Unknown')}"]
        for k, v in self.headers.items():
            lines.append(f"{k}: {v}")
        lines.append(f"Content-Length: {len(self.body)}")
        lines.append("Connection: " + ("keep-alive" if keep_alive else "close"))
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def json_response(data: Any, status: int = 200,
                  headers: dict[str, str] | None = None) -> Response:
    return Response(status, json.dumps(data), headers, "application/json; charset=utf-8")


class HTTPException(Exception):
    """A refusal: answered ``<status>: <reason>`` as plain text, the reason
    also on the status line, ``headers`` added."""

    def __init__(self, status: int, reason: str = "",
                 headers: dict[str, str] | None = None):
        super().__init__(reason)
        self.status = status
        self.reason = reason or _REASONS.get(status, "")
        self.headers = dict(headers or {})

    def response(self) -> Response:
        return _ReasonResponse(self.status, f"{self.status}: {self.reason}",
                               self.headers, self.reason)


class _ReasonResponse(Response):
    def __init__(self, status: int, body: str, headers: dict[str, str], reason: str):
        super().__init__(status, body, headers)
        self.reason = reason

    def head(self, keep_alive: bool) -> bytes:
        head = super().head(keep_alive).decode("latin-1")
        first, rest = head.split("\r\n", 1)
        phrase = _reason_phrase(self.reason).encode("latin-1", "replace").decode("latin-1")
        return (f"HTTP/1.1 {self.status} {phrase}\r\n" + rest).encode("latin-1")


class StreamResponse:
    """A response written in pieces (server-sent events): the head goes out
    at :meth:`prepare` without a length, the connection closes after
    :meth:`write_eof`. While it is open, a client that goes away cancels
    the handler."""

    def __init__(self, status: int = 200, headers: dict[str, str] | None = None):
        self.status = status
        self.headers = dict(headers or {})
        self._writer: asyncio.StreamWriter | None = None

    async def prepare(self, request: Request) -> None:
        lines = [f"HTTP/1.1 {self.status} {_REASONS.get(self.status, 'Unknown')}"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        lines.append("Connection: close")
        self._writer = request._writer
        request.taken_over = self
        self._writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        await self._writer.drain()
        request._watch_disconnect()

    async def write(self, data: bytes) -> None:
        if self._writer is None or self._writer.is_closing():
            raise ConnectionResetError("client went away")
        self._writer.write(data)
        await self._writer.drain()

    async def write_eof(self) -> None:
        if self._writer is not None and not self._writer.is_closing():
            await self._writer.drain()
            self._writer.close()


# ---------------------------------------------------------------------------
# WebSocket frames
# ---------------------------------------------------------------------------


class WSMsgType:
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    CLOSE = 0x8
    PING = 0x9
    PONG = 0xA
    CLOSED = 0x101
    ERROR = 0x102


class WSMessage:
    __slots__ = ("type", "data", "extra")

    def __init__(self, type: int, data: Any = None, extra: Any = None):
        self.type = type
        self.data = data
        self.extra = extra

    def json(self) -> Any:
        return json.loads(self.data)

    def __repr__(self) -> str:
        return f"WSMessage({self.type}, {self.data!r}, {self.extra!r})"


def _xor(payload: bytes, mask: bytes) -> bytes:
    n = len(payload)
    if not n:
        return payload
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(payload, "big") ^ int.from_bytes(key, "big")).to_bytes(n, "big")


def encode_frame(opcode: int, payload: bytes, fin: bool = True, masked: bool = False) -> bytes:
    """One frame: FIN and opcode, the length in 7, 16 or 64 bits, then the
    payload (masked with a random key when ``masked``, as a client must)."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    mask_bit = 0x80 if masked else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < 65536:
        head.append(mask_bit | 126)
        head += struct.pack("!H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack("!Q", n)
    if masked:
        key = os.urandom(4)
        return bytes(head) + key + _xor(payload, key)
    return bytes(head) + payload


class _ProtocolError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class _WebSocket:
    """One side of a WebSocket connection; subclasses set ``_masked`` (a
    client masks what it sends) and the streams."""

    _masked = False

    def __init__(self) -> None:
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._closed = False
        self._close_sent = False
        self.close_code: int | None = None

    @property
    def closed(self) -> bool:
        return self._closed or self._close_sent

    def _send(self, opcode: int, payload: bytes, fin: bool = True) -> None:
        if self._writer is None or self._writer.is_closing():
            raise ConnectionResetError("websocket connection lost")
        self._writer.write(encode_frame(opcode, payload, fin, self._masked))

    async def _flush(self) -> None:
        try:
            await self._writer.drain()
        except (ConnectionError, RuntimeError) as e:
            raise ConnectionResetError(str(e)) from None

    async def send_str(self, data: str) -> None:
        if self._close_sent:
            raise ConnectionResetError("websocket is closing")
        self._send(WSMsgType.TEXT, data.encode("utf-8"))
        await self._flush()

    async def send_json(self, data: Any) -> None:
        await self.send_str(json.dumps(data))

    async def send_frame(self, opcode: int, payload: bytes, fin: bool = True) -> None:
        """One raw frame (a fragment, a ping): for protocol tests."""
        self._send(opcode, payload, fin)
        await self._flush()

    async def close(self, code: int = 1000, message: bytes = b"") -> None:
        """Send a close frame (once) and end the connection."""
        if not self._close_sent and self._writer is not None and not self._writer.is_closing():
            self._close_sent = True
            try:
                self._send(WSMsgType.CLOSE, struct.pack("!H", code) + message)
                await self._flush()
            except ConnectionResetError:
                pass
        self._close_sent = True
        self._closed = True
        if self._writer is not None and not self._writer.is_closing():
            self._writer.close()

    async def _read_frame(self) -> tuple[bool, int, bytes]:
        b1, b2 = await self._reader.readexactly(2)
        if b1 & 0x70:
            raise _ProtocolError(1002, "reserved bits set")
        fin, opcode = bool(b1 & 0x80), b1 & 0x0F
        masked, n = bool(b2 & 0x80), b2 & 0x7F
        if n == 126:
            (n,) = struct.unpack("!H", await self._reader.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await self._reader.readexactly(8))
        if opcode >= 0x8 and (n > 125 or not fin):
            raise _ProtocolError(1002, "bad control frame")
        if n > MAX_MESSAGE:
            raise _ProtocolError(1009, "message too big")
        mask = await self._reader.readexactly(4) if masked else None
        payload = await self._reader.readexactly(n)
        return fin, opcode, _xor(payload, mask) if mask else payload

    async def receive(self, timeout: float | None = None) -> WSMessage:
        """The next message: TEXT (str), BINARY (bytes), CLOSE (code) or
        CLOSED (the connection ended without a close frame). Pings are
        answered and pongs dropped on the way."""
        if timeout is not None:
            return await asyncio.wait_for(self.receive(), timeout)
        if self._closed:
            return WSMessage(WSMsgType.CLOSED)
        fragments: list[bytes] = []
        first_opcode = None
        try:
            while True:
                fin, opcode, payload = await self._read_frame()
                if opcode == WSMsgType.PING:
                    if not self._close_sent:
                        self._send(WSMsgType.PONG, payload)
                        await self._flush()
                    continue
                if opcode == WSMsgType.PONG:
                    continue
                if opcode == WSMsgType.CLOSE:
                    code = struct.unpack("!H", payload[:2])[0] if len(payload) >= 2 else 1005
                    self.close_code = code
                    if not self._close_sent:
                        await self.close(code if code != 1005 else 1000)
                    self._closed = True
                    if self._writer is not None and not self._writer.is_closing():
                        self._writer.close()
                    return WSMessage(WSMsgType.CLOSE, code, payload[2:].decode("utf-8", "replace"))
                if opcode == WSMsgType.CONTINUATION:
                    if first_opcode is None:
                        raise _ProtocolError(1002, "continuation frame without a start")
                elif opcode in (WSMsgType.TEXT, WSMsgType.BINARY):
                    if first_opcode is not None:
                        raise _ProtocolError(1002, "new message inside a fragmented one")
                    first_opcode = opcode
                else:
                    raise _ProtocolError(1002, f"unknown opcode {opcode}")
                fragments.append(payload)
                if sum(len(f) for f in fragments) > MAX_MESSAGE:
                    raise _ProtocolError(1009, "message too big")
                if fin:
                    data = b"".join(fragments)
                    if first_opcode == WSMsgType.TEXT:
                        try:
                            return WSMessage(WSMsgType.TEXT, data.decode("utf-8"))
                        except UnicodeDecodeError:
                            raise _ProtocolError(1007, "text message is not UTF-8") from None
                    return WSMessage(WSMsgType.BINARY, data)
        except _ProtocolError as e:
            await self.close(e.code, str(e).encode())
            return WSMessage(WSMsgType.ERROR, e)
        except (asyncio.IncompleteReadError, ConnectionError):
            self._closed = True
            return WSMessage(WSMsgType.CLOSED)

    async def receive_json(self, timeout: float | None = None) -> Any:
        msg = await self.receive(timeout)
        if msg.type != WSMsgType.TEXT:
            raise ConnectionResetError(f"websocket ended: {msg!r}")
        return json.loads(msg.data)

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSED, WSMsgType.ERROR):
            raise StopAsyncIteration
        return msg


class WebSocketResponse(_WebSocket):
    """The server side: :meth:`prepare` answers the upgrade with 101."""

    async def prepare(self, request: Request) -> None:
        headers = request.headers
        key = headers.get("sec-websocket-key", "")
        if (headers.get("upgrade", "").lower() != "websocket"
                or "upgrade" not in headers.get("connection", "").lower()
                or request.method != "GET" or not key):
            raise HTTPException(400, "expected a WebSocket upgrade request")
        if headers.get("sec-websocket-version", "") != "13":
            raise HTTPException(400, "unsupported WebSocket version",
                                {"Sec-WebSocket-Version": "13"})
        self._reader = request._reader
        self._writer = request._writer
        request.taken_over = self
        if request._server is not None:
            request._server._sockets.add(self)
        self._writer.write((
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n"
        ).encode("latin-1"))
        await self._flush()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

Handler = Callable[[Request], Awaitable[Any]]


def _compile(pattern: str) -> re.Pattern:
    """``/a/{name}/{tail:.*}`` as a regex with named groups."""
    out = ""
    for part in re.split(r"(\{[^}]+\})", pattern):
        if part.startswith("{"):
            name, _, rx = part[1:-1].partition(":")
            out += f"(?P<{name}>{rx or '[^/]+'})"
        else:
            out += re.escape(part)
    return re.compile(f"^{out}$")


async def _read_head(reader: asyncio.StreamReader) -> bytes | None:
    try:
        return await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if e.partial.strip():
            raise HTTPException(400, "incomplete request head") from None
        return None
    except asyncio.LimitOverrunError:
        raise HTTPException(400, "request head too large") from None


def _parse_headers(lines: list[str]) -> dict[str, str]:
    headers: dict[str, str] = {}
    for line in lines:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise HTTPException(400, f"bad header line {line!r}")
        name = name.strip().lower()
        value = value.strip()
        headers[name] = f"{headers[name]}, {value}" if name in headers else value
    return headers


async def _chunks(reader: asyncio.StreamReader, max_body: int | None = None):
    """The pieces of a chunked body as they arrive; a malformed one raises
    ValueError (or the reader's LimitOverrunError for an overlong size
    line), one that would pass ``max_body`` bytes HTTPException 413 before
    its chunk is read."""
    total = 0
    while True:
        size_line = await reader.readuntil(b"\r\n")
        size = int(size_line.split(b";")[0].strip() or b"0", 16)
        if size < 0:
            raise ValueError(f"negative chunk size {size}")
        if size == 0:
            while (await reader.readuntil(b"\r\n")) != b"\r\n":
                pass  # trailers
            return
        total += size
        if max_body is not None and total > max_body:
            raise HTTPException(413, "request body too large")
        yield await reader.readexactly(size)
        if await reader.readexactly(2) != b"\r\n":
            raise ValueError("chunk not followed by CRLF")


async def _read_body(reader: asyncio.StreamReader, headers: dict[str, str],
                     max_body: int = MAX_BODY) -> bytes:
    if "chunked" in headers.get("transfer-encoding", "").lower():
        try:
            return b"".join([piece async for piece in _chunks(reader, max_body)])
        except (ValueError, asyncio.LimitOverrunError):
            raise HTTPException(400, "malformed chunked body") from None
    length = headers.get("content-length")
    if not length:
        return b""
    try:
        n = int(length)
    except ValueError:
        raise HTTPException(400, "bad Content-Length") from None
    if n > max_body:
        raise HTTPException(413, "request body too large")
    return await reader.readexactly(n)


class HttpServer:
    """Routes (``method``, path pattern) to handlers on one asyncio listener.
    ``method`` ``"*"`` matches any. ``port=0`` binds a free port; ``port``
    holds the bound one after :meth:`start`. ``middleware``, when given, is
    ``async def middleware(request, handler)`` around every matched
    handler (aiohttp's middleware shape); ``max_body`` bounds a request's
    body (413 above it)."""

    def __init__(self, routes: list[tuple[str, str, Handler]], host: str = "127.0.0.1",
                 port: int = 0, middleware: Callable[[Request, Handler], Awaitable[Any]]
                 | None = None, max_body: int = MAX_BODY):
        self.routes = [(m, _compile(p), h) for m, p, h in routes]
        self.host = host
        self.port = port
        self.middleware = middleware
        self.max_body = max_body
        self._server: asyncio.base_events.Server | None = None
        self._connections: set[asyncio.Task] = set()
        self._sockets: set[_WebSocket] = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port, limit=MAX_HEAD)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for ws in list(self._sockets):
            try:
                await asyncio.wait_for(ws.close(1001), 1.0)
            except (asyncio.TimeoutError, ConnectionError):
                pass
        for task in list(self._connections):
            task.cancel()
        if self._connections:
            await asyncio.gather(*self._connections, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    def _match(self, request: Request) -> Handler:
        allowed = False
        for method, rx, handler in self.routes:
            m = rx.match(request.raw_path)
            if m is None:
                continue
            if method not in ("*", request.method):
                allowed = True
                continue
            request.match_info = {k: unquote(v) for k, v in m.groupdict().items()}
            return handler
        if allowed:
            raise HTTPException(405)
        raise HTTPException(404)

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        try:
            while True:
                try:
                    head = await _read_head(reader)
                    if head is None:
                        return
                    lines = head.decode("latin-1").split("\r\n")
                    parts = lines[0].split(" ")
                    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
                        raise HTTPException(400, "bad request line")
                    headers = _parse_headers(lines[1:])
                    body = await _read_body(reader, headers, self.max_body)
                except HTTPException as e:
                    writer.write(e.response().head(False) + e.response().body)
                    await writer.drain()
                    return
                request = Request(parts[0], parts[1], parts[2], headers, body, reader, writer)
                response = await self._dispatch(request)
                if request.taken_over is not None:
                    return
                keep = request.keep_alive()
                writer.write(response.head(keep) + response.body)
                await writer.drain()
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            pass
        finally:
            self._connections.discard(task)
            if not writer.is_closing():
                writer.close()

    async def _dispatch(self, request: Request) -> Response:
        try:
            handler = self._match(request)
        except HTTPException as e:
            return e.response()
        request._server = self
        call = handler(request) if self.middleware is None else self.middleware(request, handler)
        request._handler_task = handler_task = asyncio.ensure_future(call)
        try:
            await asyncio.wait({handler_task})
            result = None if handler_task.cancelled() else handler_task.result()
        except HTTPException as e:
            result = e.response()
        except asyncio.CancelledError:
            handler_task.cancel()
            await asyncio.gather(handler_task, return_exceptions=True)
            raise
        except Exception:
            log.exception("handler for %s %s failed", request.method, request.path)
            result = HTTPException(500).response()
        finally:
            if request._watcher is not None:
                request._watcher.cancel()
            taken = request.taken_over
            if isinstance(taken, _WebSocket):
                self._sockets.discard(taken)
                await taken.close()
        if request.taken_over is not None:
            return result
        if not isinstance(result, Response):
            log.error("handler for %s %s returned %r", request.method, request.path, result)
            return HTTPException(500).response()
        return result


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------


class HandshakeError(Exception):
    """The server answered the upgrade with another status than 101."""

    def __init__(self, status: int, reason: str, body: bytes):
        super().__init__(f"{status} {reason}")
        self.status = status
        self.reason = reason
        self.body = body


class ConnectError(ConnectionError):
    """The connection could not be opened: nothing of the request was sent
    (a caller may retry any method after it)."""


def host_header(url: str) -> str:
    """The ``Host`` a request to ``url`` sends: the host, and its port only
    when it is not the scheme's default (aiohttp's rule; an explicit
    ``:443`` on https is left out as well)."""
    parts = urlsplit(url)
    host = parts.hostname or ""
    if ":" in host:
        host = f"[{host}]"
    default = 443 if parts.scheme in ("https", "wss") else 80
    return host if parts.port in (None, default) else f"{host}:{parts.port}"


def _merge_headers(base: dict[str, str], extra: dict[str, str] | None) -> dict[str, str]:
    """``base`` updated by ``extra``, header names compared without case
    (a caller's ``host`` replaces the default ``Host``, never doubles it)."""
    out = dict(base)
    for name, value in (extra or {}).items():
        for old in [k for k in out if k.lower() == name.lower()]:
            del out[old]
        out[name] = value
    return out


async def _open(url: str, timeout: float):
    """Connect for ``url``: plain for http and ws, TLS for https and wss
    (``ssl.create_default_context``: the certificate chain and the host name
    verified against the default trust store, which ``SSL_CERT_FILE`` can
    name). Returns the streams, the ``Host`` to send (:func:`host_header`)
    and the request target, its path quoted as aiohttp quotes it."""
    parts = urlsplit(url)
    ctx = None
    if parts.scheme in ("https", "wss"):
        import ssl

        ctx = ssl.create_default_context()
    port = parts.port or (443 if ctx is not None else 80)
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(parts.hostname, port, limit=MAX_MESSAGE + MAX_HEAD,
                                    ssl=ctx,
                                    server_hostname=parts.hostname if ctx is not None else None),
            timeout)
    except (OSError, asyncio.TimeoutError) as e:
        raise ConnectError(f"cannot connect to {parts.hostname}:{port}: {e!r}") from e
    target = quote(parts.path or "/", safe=_PATH_SAFE) + (f"?{parts.query}" if parts.query else "")
    return reader, writer, host_header(url), target


async def _read_response_head(reader: asyncio.StreamReader) -> tuple[int, str, dict[str, str]]:
    head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
    version, _, rest = head[0].partition(" ")
    status, _, reason = rest.partition(" ")
    return int(status), reason, _parse_headers(head[1:])


class WebSocketClient(_WebSocket):
    """The client side (frames masked). ``await WebSocketClient.connect(url)``."""

    _masked = True

    @classmethod
    async def connect(cls, url: str, headers: dict[str, str] | None = None,
                      timeout: float = 10.0) -> "WebSocketClient":
        reader, writer, host, target = await _open(url, timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        hdrs = _merge_headers({"Host": host, "Upgrade": "websocket", "Connection": "Upgrade",
                               "Sec-WebSocket-Key": key, "Sec-WebSocket-Version": "13"},
                              headers)
        lines = [f"GET {target} HTTP/1.1"] + [f"{k}: {v}" for k, v in hdrs.items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        await writer.drain()
        status, reason, resp_headers = await asyncio.wait_for(_read_response_head(reader), timeout)
        if status != 101:
            n = int(resp_headers.get("content-length", "0") or 0)
            body = await reader.readexactly(n) if n else b""
            writer.close()
            raise HandshakeError(status, reason, body)
        if resp_headers.get("sec-websocket-accept") != accept_key(key):
            writer.close()
            raise HandshakeError(status, "bad Sec-WebSocket-Accept", b"")
        ws = cls()
        ws._reader, ws._writer = reader, writer
        return ws


# ---------------------------------------------------------------------------
# the client's requests: aiohttp's query, redirects and streamed bodies
# ---------------------------------------------------------------------------

_QUERY_SAFE = "/?:@!$'()*,~"
#: redirects that are followed, and how many at most (aiohttp's defaults)
_REDIRECTS = (301, 302, 303, 307, 308)
MAX_REDIRECTS = 10
#: methods that go without a ``Content-Length`` when they carry no body
_BODYLESS = ("GET", "HEAD", "OPTIONS", "CONNECT", "TRACE")


class TooManyRedirects(Exception):
    """The server redirected ``MAX_REDIRECTS`` times in a row."""


def with_query(url: str, params: dict[str, Any] | None) -> str:
    """``url`` with ``params`` appended to the query it already has,
    encoded as aiohttp encodes its ``params=`` (space as ``+``; ``&``,
    ``=``, ``+``, ``;`` and ``%`` escaped)."""
    from urllib.parse import quote_plus

    if not params:
        return url
    base, sep, fragment = url.partition("#")
    query = "&".join(f"{quote_plus(str(k), safe=_QUERY_SAFE)}={quote_plus(str(v), safe=_QUERY_SAFE)}"
                     for k, v in params.items())
    return base + ("&" if "?" in base else "?") + query + sep + fragment


class ClientResponse:
    """A response whose body is read as it arrives: :meth:`read`,
    :meth:`text`, :meth:`json`, or ``async for line in response`` (each line
    with its ``\n``, the last one without when the body does not end in
    one), as aiohttp's ``resp.content`` gives them. Chunked transfer
    encoding is undone, and (unless ``decompress`` is false) a gzip or
    deflate ``Content-Encoding`` too. Close it, or use it as an async
    context manager."""

    def __init__(self, method: str, url: str, status: int, reason: str,
                 headers: dict[str, str], reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, timeout: float, decompress: bool = True):
        self.method, self.url, self.status, self.reason = method, url, status, reason
        self.headers = headers
        self._reader, self._writer, self._timeout = reader, writer, timeout
        self._decompress = decompress
        self._buffer = b""
        self._pieces = self._body_pieces()

    async def _raw_pieces(self):
        reader, headers = self._reader, self.headers
        if self.method.upper() == "HEAD" or self.status in (204, 304) or 100 <= self.status < 200:
            return
        if "chunked" in headers.get("transfer-encoding", "").lower():
            async for piece in _chunks(reader):
                yield piece
            return
        length = headers.get("content-length")
        if length is not None:
            left = int(length)
            while left > 0:
                piece = await reader.read(min(left, 65536))
                if not piece:
                    raise asyncio.IncompleteReadError(b"", left)
                left -= len(piece)
                yield piece
            return
        while piece := await reader.read(65536):
            yield piece

    async def _body_pieces(self):
        import zlib

        encoding = self.headers.get("content-encoding", "").lower()
        inflate = None
        if self._decompress and encoding in ("gzip", "deflate"):
            inflate = zlib.decompressobj(16 + zlib.MAX_WBITS if encoding == "gzip"
                                         else zlib.MAX_WBITS)
        pieces = self._raw_pieces()
        while True:
            try:
                piece = await asyncio.wait_for(pieces.__anext__(), self._timeout)
            except StopAsyncIteration:
                break
            piece = inflate.decompress(piece) if inflate is not None else piece
            if piece:
                yield piece
        if inflate is not None and (tail := inflate.flush()):
            yield tail

    async def readline(self) -> bytes:
        """The next line with its ``\n``; ``b""`` at the body's end."""
        while b"\n" not in self._buffer:
            try:
                self._buffer += await self._pieces.__anext__()
            except StopAsyncIteration:
                line, self._buffer = self._buffer, b""
                return line
        line, _, self._buffer = self._buffer.partition(b"\n")
        return line + b"\n"

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        line = await self.readline()
        if not line:
            raise StopAsyncIteration
        return line

    async def read(self) -> bytes:
        data = [self._buffer]
        self._buffer = b""
        async for piece in self._pieces:
            data.append(piece)
        return b"".join(data)

    async def text(self, errors: str = "strict") -> str:
        """The body decoded by the ``Content-Type``'s charset, else UTF-8."""
        match = re.search(r"charset=\"?([^\";\s]+)", self.headers.get("content-type", ""), re.I)
        return (await self.read()).decode(match.group(1) if match else "utf-8", errors=errors)

    async def json(self) -> Any:
        return json.loads(await self.read())

    def close(self) -> None:
        self._writer.close()

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.close()


async def _send(method: str, url: str, headers: dict[str, str], body: bytes | None,
                timeout: float, decompress: bool = True) -> ClientResponse:
    """Write one request on a connection of its own (``Host`` and
    ``Connection: close`` first, ``headers`` over them) and return its
    response once the head has come. A connection that cannot be opened
    raises :class:`ConnectError` before anything is sent; a failure after
    that raises what the stream raised."""
    reader, writer, host, target = await _open(url, timeout)
    hdrs = _merge_headers({"Host": host, "Connection": "close"}, headers)
    head = [f"{method} {target} HTTP/1.1"] + [f"{k}: {v}" for k, v in hdrs.items()]
    try:
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + (body or b""))
        await writer.drain()
        status, reason, resp_headers = await asyncio.wait_for(_read_response_head(reader), timeout)
    except BaseException:
        writer.close()
        raise
    return ClientResponse(method, url, status, reason, resp_headers, reader, writer, timeout,
                          decompress)


async def open_response(method: str, url: str, *, params: dict[str, Any] | None = None,
                        data: str | bytes | None = None, json_body: Any = None,
                        headers: dict[str, str] | None = None, allow_redirects: bool = True,
                        timeout: float = 300.0) -> ClientResponse:
    """Send one request and return its response once the head has come,
    the body left to read (``async with await open_response(...) as
    resp:``). As aiohttp does it:

    - ``params`` are appended to the URL's query (:func:`with_query`);
    - a ``str`` body goes as ``text/plain; charset=utf-8``, ``bytes`` as
      ``application/octet-stream``, ``json_body`` as ``application/json``,
      unless ``headers`` name a ``Content-Type``;
    - ``Host`` leaves out the scheme's default port (:func:`host_header`);
    - a request of another method than GET, HEAD, OPTIONS, CONNECT or
      TRACE without a body says ``Content-Length: 0``;
    - 301, 302, 303, 307 and 308 are followed to their ``Location`` (a
      303 as GET, or HEAD; a POST as GET after 301 and 302; the method and
      body kept otherwise), ``Authorization`` dropped when the origin
      changes, up to :data:`MAX_REDIRECTS` (:class:`TooManyRedirects`).

    ``timeout`` bounds the connection, the head and each read of the body."""
    from urllib.parse import urljoin

    url = with_query(url, params)
    headers = dict(headers or {})
    body: bytes | None = None
    content_type = None
    if json_body is not None:
        body, content_type = json.dumps(json_body).encode(), "application/json"
    elif isinstance(data, str):
        body, content_type = data.encode(), "text/plain; charset=utf-8"
    elif data is not None:
        body, content_type = bytes(data), "application/octet-stream"
    if any(k.lower() == "content-type" for k in headers):
        content_type = None
    redirects = 0
    while True:
        hdrs = dict(headers)
        if body is not None:
            if content_type is not None:
                hdrs["Content-Type"] = content_type
            hdrs = _merge_headers(hdrs, {"Content-Length": str(len(body))})
        elif method.upper() not in _BODYLESS and not any(
                k.lower() == "content-length" for k in hdrs):
            hdrs["Content-Length"] = "0"
        response = await _send(method, url, hdrs, body, timeout)
        location = response.headers.get("location") or response.headers.get("uri")
        if response.status not in _REDIRECTS or not allow_redirects or location is None:
            return response
        response.close()
        redirects += 1
        if redirects >= MAX_REDIRECTS:
            raise TooManyRedirects(f"{method} {url}: {redirects} redirects")
        if (response.status == 303 and method.upper() != "HEAD") or (
                response.status in (301, 302) and method.upper() == "POST"):
            method, body = "GET", None
            headers = {k: v for k, v in headers.items() if k.lower() != "content-length"}
        target_url = urljoin(url, location)
        if urlsplit(target_url).scheme not in ("http", "https"):
            raise ValueError(f"{method} {url}: redirected to {location!r}, not http(s)")
        old, new = urlsplit(url), urlsplit(target_url)
        if (old.scheme, old.hostname, old.port) != (new.scheme, new.hostname, new.port):
            headers = {k: v for k, v in headers.items() if k.lower() != "authorization"}
        url = target_url


async def http_request(method: str, url: str, json_body: Any = None,
                       body: bytes | None = b"", headers: dict[str, str] | None = None,
                       timeout: float = 30.0, decompress: bool = False,
                       ) -> tuple[int, str, dict[str, str], bytes]:
    """One request, its body read whole: ``(status, reason, headers,
    body)``. Redirects are not followed; ``body`` goes with its
    ``Content-Length`` (``b""`` too; ``None`` sends none) and no
    ``Content-Type`` of its own; ``decompress`` undoes a gzip or deflate
    ``Content-Encoding``. A connection that cannot be opened raises
    :class:`ConnectError` before anything is sent."""
    hdrs = dict(headers or {})
    if json_body is not None:
        body = json.dumps(json_body).encode()
        hdrs = _merge_headers(hdrs, {"Content-Type": "application/json"})
    if body is not None:
        hdrs = _merge_headers(hdrs, {"Content-Length": str(len(body))})
    async with await _send(method, url, hdrs, body, timeout, decompress) as resp:
        data = await resp.read()
    return resp.status, resp.reason, resp.headers, data


async def sse_events(url: str, json_body: Any, headers: dict[str, str] | None = None,
                     until: Callable[[Any], bool] | None = None,
                     timeout: float = 60.0) -> tuple[int, dict[str, str], list[Any]]:
    """POST ``json_body`` and read a ``text/event-stream`` answer: the status,
    the headers and every ``data: `` event parsed as JSON, up to the one
    ``until`` accepts (or the stream's end), all within ``timeout``."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    events: list[Any] = []
    async with await open_response("POST", url, json_body=json_body, headers=headers,
                                   allow_redirects=False, timeout=timeout) as resp:
        if resp.status != 200:
            return resp.status, resp.headers, events
        while line := await asyncio.wait_for(resp.readline(),
                                             max(0.0, deadline - loop.time())):
            text = line.decode("utf-8").rstrip("\r\n")
            if text.startswith("data: "):
                events.append(json.loads(text[6:]))
                if until is not None and until(events[-1]):
                    break
    return resp.status, resp.headers, events
