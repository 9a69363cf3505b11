"""HTTP/2 over asyncio streams, and the gRPC call layer on it.

The port's own gRPC transport (the card's machine has no grpcio), in
prior-knowledge cleartext ("h2c", RFC 9113 3.3), wire-compatible with
grpcio and any other gRPC stack in both directions.

HTTP/2 (:class:`Connection`, one per TCP connection, client or server):

- the connection preface, SETTINGS and their ACK;
- HEADERS and CONTINUATION (padding and priority read past), decoded by one
  HPACK context per connection (:mod:`.hpack`);
- DATA split at the peer's ``MAX_FRAME_SIZE`` and sent within the peer's
  connection and stream windows, waiting for ``WINDOW_UPDATE`` while the
  peer answers PINGs;
- received DATA credited back with ``WINDOW_UPDATE``: the connection's
  window as the bytes are taken off the socket, a stream's as the
  application takes each message (:meth:`Stream.receive`), so a peer that
  sends faster than the handler or caller reads is held to one window of
  unread messages. The bytes of a message still arriving are credited at
  once, so a message larger than a window never stalls;
- PING answered with an ACK; a keepalive PING when a connection with open
  streams has been silent for ``KEEPALIVE_S``, and the connection dropped
  when its ACK does not come within ``PING_TIMEOUT_S``;
- RST_STREAM both ways (a cancelled call is ``CANCEL``) and GOAWAY (no new
  streams; streams past its last id fail as unavailable).

gRPC (the PROTOCOL-HTTP2 document): ``content-type: application/grpc``,
``te: trailers``, 5-byte length-prefixed messages (a compressed one is
refused: the port never asks for compression), ``grpc-status`` and a
percent-encoded ``grpc-message`` in the trailers (or a trailers-only
response), ``-bin`` metadata in base64, ``grpc-timeout`` on unary calls.

:class:`Server` offers what the sidecar's server uses of ``grpc.aio``: a
handler per method (:func:`rpc_method_handler`), ``context.cancelled()``,
an async iterator of requests, ``start`` and ``stop(grace)``.
:func:`insecure_channel` offers what its client uses: ``unary_unary``,
``stream_stream`` with ``write`` and ``async for``, ``cancel`` and
``close``. A call lost to a dead peer, reset, or ended with a status other
than OK raises :class:`RpcError`. Every wait of the transport is bounded.
"""

from __future__ import annotations

import asyncio
import base64
import enum
import logging
import os
from typing import Any, Callable

from langstream_tpu_torch.grpc import hpack

log = logging.getLogger("langstream_tpu_torch.grpc.h2")

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS = 0x0, 0x1, 0x2, 0x3, 0x4
PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 0x5, 0x6, 0x7, 0x8, 0x9
# flags
END_STREAM = ACK = 0x1
END_HEADERS, PADDED, PRIORITY_FLAG = 0x4, 0x8, 0x20
# settings
HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS = 0x1, 0x2, 0x3
INITIAL_WINDOW_SIZE, MAX_FRAME_SIZE, MAX_HEADER_LIST_SIZE = 0x4, 0x5, 0x6
# error codes
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR = 0x0, 0x1, 0x2, 0x3
STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL = 0x5, 0x6, 0x7, 0x8
COMPRESSION_ERROR, ENHANCE_YOUR_CALM, INADEQUATE_SECURITY = 0x9, 0xB, 0xC

DEFAULT_WINDOW = 65_535
DEFAULT_MAX_FRAME = 16_384
MAX_WINDOW = (1 << 31) - 1
#: what we receive per frame and per header list
RECV_MAX_FRAME = DEFAULT_MAX_FRAME
RECV_MAX_HEADER_LIST = 64 * 1024
#: the largest gRPC message read (grpcio's default is 4 MiB)
MAX_MESSAGE_BYTES = 64 * 1024 * 1024

#: bounds on every wait of the transport (seconds)
CONNECT_TIMEOUT_S = 10.0
PREFACE_TIMEOUT_S = 10.0
WINDOW_TIMEOUT_S = 60.0
WRITE_TIMEOUT_S = 60.0
CLOSE_TIMEOUT_S = 5.0
#: a connection with open streams that has received nothing for this long
#: is pinged (above grpcio's 300 s floor for pings without data)
KEEPALIVE_S = 330.0
PING_TIMEOUT_S = 20.0
#: a unary call's deadline when the caller gives none
DEFAULT_UNARY_TIMEOUT_S = 60.0

USER_AGENT = "langstream-tpu-torch-h2/1"


class StatusCode(enum.IntEnum):
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


#: RST_STREAM error code -> gRPC status (PROTOCOL-HTTP2, "Errors")
_RST_STATUS = {REFUSED_STREAM: StatusCode.UNAVAILABLE, CANCEL: StatusCode.CANCELLED,
               ENHANCE_YOUR_CALM: StatusCode.RESOURCE_EXHAUSTED,
               INADEQUATE_SECURITY: StatusCode.PERMISSION_DENIED}


class RpcError(Exception):
    """A call that ended with a status other than OK: the peer's status, a
    reset stream, a lost connection or a missed deadline (the port's
    ``grpc.aio.AioRpcError``)."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"<RpcError {code.name}: {details}>")
        self._code = StatusCode(code)
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class ProtocolError(Exception):
    """A connection error: the connection ends with GOAWAY(code)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.error_code = code


# ---------------------------------------------------------------------------
# gRPC framing helpers
# ---------------------------------------------------------------------------


def frame_message(payload: bytes) -> bytes:
    """One gRPC length-prefixed message, uncompressed."""
    return b"\x00" + len(payload).to_bytes(4, "big") + payload


def percent_encode(text: str) -> str:
    out = []
    for byte in text.encode("utf-8"):
        if 0x20 <= byte <= 0x7E and byte != 0x25:
            out.append(chr(byte))
        else:
            out.append(f"%{byte:02X}")
    return "".join(out)


_HEX = b"0123456789abcdefABCDEF"


def percent_decode(text: str) -> str:
    raw = text.encode("latin-1")
    out = bytearray()
    i = 0
    while i < len(raw):
        pair = raw[i + 1:i + 3]
        if raw[i] == 0x25 and len(pair) == 2 and all(c in _HEX for c in pair):
            out.append(int(pair, 16))
            i += 3
            continue
        out.append(raw[i])
        i += 1
    return out.decode("utf-8", errors="replace")


def metadata_to_headers(metadata) -> list[tuple[str, str]]:
    """Custom metadata as header fields: names lower-cased, ``-bin`` values
    (bytes) in unpadded base64."""
    headers = []
    for key, value in metadata or ():
        key = key.lower()
        if key.endswith("-bin"):
            raw = value if isinstance(value, bytes) else str(value).encode("utf-8")
            headers.append((key, base64.b64encode(raw).decode("ascii").rstrip("=")))
        else:
            headers.append((key, value.decode("latin-1") if isinstance(value, bytes) else value))
    return headers


_RESERVED = {"content-type", "te", "user-agent", "grpc-timeout", "grpc-encoding",
             "grpc-accept-encoding", "grpc-status", "grpc-message", "grpc-status-details-bin"}


def headers_to_metadata(headers) -> tuple[tuple[str, Any], ...]:
    """The custom metadata of a header list: pseudo-headers and gRPC's own
    left out, ``-bin`` values decoded from base64 (padded or not; several
    values joined by commas each decoded)."""
    out = []
    for name, value in headers:
        if name.startswith(":") or name in _RESERVED:
            continue
        if name.endswith("-bin"):
            decoded = b"".join(base64.b64decode(part + "=" * (-len(part) % 4))
                               for part in value.split(",") if part.strip())
            out.append((name, decoded))
        else:
            out.append((name, value))
    return tuple(out)


def _timeout_header(seconds: float) -> str:
    for unit, scale in (("n", 1e9), ("u", 1e6), ("m", 1e3), ("S", 1.0), ("M", 1 / 60)):
        value = int(seconds * scale + 0.999)
        if value < 100_000_000:
            return f"{max(value, 1)}{unit}"
    return "99999999H"


# ---------------------------------------------------------------------------
# streams and the connection
# ---------------------------------------------------------------------------

_END = object()  # the end of a stream's messages


class Stream:
    """One HTTP/2 stream carrying one gRPC call: its windows, its initial
    headers and trailers, and its reassembled messages."""

    def __init__(self, conn: "Connection", stream_id: int):
        self.conn = conn
        self.id = stream_id
        self.send_window = conn.peer_initial_window
        #: received bytes released to the peer but not yet sent as credit
        self.recv_unacked = 0
        self.headers: list | None = None
        self.trailers: list | None = None
        #: (message, its bytes still owed to the peer's window) or _END
        self.messages: asyncio.Queue = asyncio.Queue()
        self._buf = bytearray()
        self.remote_closed = False
        self.local_closed = False
        self.error: BaseException | None = None
        self.write_lock = asyncio.Lock()
        #: called once when the peer resets the stream or the connection is lost
        self.on_abort: Callable[[], None] | None = None

    # -- events from the connection --------------------------------------

    def on_headers(self, headers: list, end_stream: bool) -> None:
        if self.headers is None:
            self.headers = headers
            if end_stream:  # trailers-only
                self.trailers = headers
        else:
            self.trailers = headers
        if end_stream:
            self._remote_end()

    def on_data(self, data: bytes, padding: int, end_stream: bool) -> None:
        """``data`` of a DATA frame whose ``padding`` bytes (length byte
        included) were stripped. Every byte is owed to the stream's window
        until it is released: padding and a message still arriving at once,
        a whole message when :meth:`receive` hands it out."""
        if self.remote_closed or self.error is not None:
            return
        released = len(self._buf)  # a partial message's bytes: credited on arrival
        self._buf += data
        self.release(padding)
        while len(self._buf) >= 5:
            length = int.from_bytes(self._buf[1:5], "big")
            if length > MAX_MESSAGE_BYTES:
                self._fail(RpcError(StatusCode.RESOURCE_EXHAUSTED,
                                    f"message of {length} bytes over {MAX_MESSAGE_BYTES}"))
                self.conn.reset(self, CANCEL)
                return
            if len(self._buf) < 5 + length:
                break
            if self._buf[0] & 1:
                self._fail(RpcError(StatusCode.UNIMPLEMENTED,
                                    "a compressed message (this side asks for none)"))
                self.conn.reset(self, CANCEL)
                return
            credited = min(released, 5 + length)
            released -= credited
            self.messages.put_nowait((bytes(self._buf[5:5 + length]), 5 + length - credited))
            del self._buf[:5 + length]
        self.release(len(self._buf) - released)
        if end_stream:
            self._remote_end()

    def _remote_end(self) -> None:
        if self.remote_closed:
            return
        self.remote_closed = True
        if self._buf and self.error is None:
            self.error = RpcError(StatusCode.INTERNAL, "stream ended inside a message")
        self.messages.put_nowait(_END)
        if self.local_closed:
            self.conn.forget(self)

    def _fail(self, error: BaseException) -> None:
        if self.error is None:
            self.error = error
        self.messages.put_nowait(_END)
        abort, self.on_abort = self.on_abort, None
        if abort is not None:
            abort()

    def on_reset(self, code: int) -> None:
        if self.remote_closed and self.error is None:
            self.local_closed = True  # the peer ended the call already; it stops our side
            return
        status = _RST_STATUS.get(code, StatusCode.INTERNAL)
        self._fail(RpcError(status, f"stream reset by the peer (error code {code})"))

    def on_lost(self, reason: str) -> None:
        # a client's call whose trailers arrived is complete; a server's call
        # is not until it has sent its own
        if not self.remote_closed or not (self.conn.client or self.local_closed):
            self._fail(RpcError(StatusCode.UNAVAILABLE, reason))

    # -- the application's side -------------------------------------------

    def release(self, size: int) -> None:
        """Credit ``size`` received bytes back to the peer's stream window,
        in updates of at least half a default window; none once the peer
        has ended its side or the stream is gone."""
        self.recv_unacked += size
        if self.recv_unacked < DEFAULT_WINDOW // 2 or self.remote_closed:
            return
        if self.error is None and self.conn.streams.get(self.id) is self:
            try:
                self.conn._frame(WINDOW_UPDATE, 0, self.id, self.recv_unacked.to_bytes(4, "big"))
            except ConnectionError:
                pass
        self.recv_unacked = 0

    async def receive(self) -> bytes | None:
        """The next message, or None at the stream's end (check ``error``):
        a wait bounded by the peer's liveness (the keepalive). Taking a
        message credits its bytes back to the peer."""
        item = await self.messages.get()
        if item is _END:
            self.messages.put_nowait(_END)  # later reads see the end too
            return None
        message, owed = item
        self.release(owed)
        return message


class Connection:
    """One HTTP/2 connection, either side. ``on_stream(conn, stream,
    headers)`` is called for each stream a client opens (server side)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, *,
                 client: bool, on_stream=None, name: str = ""):
        self.reader, self.writer = reader, writer
        self.client = client
        self.on_stream = on_stream
        self.name = name
        self.streams: dict[int, Stream] = {}
        self.next_stream_id = 1 if client else 2
        self.last_peer_stream = 0
        self.decoder = hpack.Decoder(4096)
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.send_window = DEFAULT_WINDOW
        self.recv_unacked = 0
        self.closed = False
        self.goaway_received: int | None = None  # the peer's last stream id
        self.goaway_sent = False
        self.close_reason = ""
        self._pings: dict[bytes, asyncio.Future] = {}
        self._window_waiters: set[asyncio.Event] = set()
        self._block: tuple[int, int, bytearray] | None = None  # stream, flags, fragments
        self._reader_task: asyncio.Task | None = None
        self._keepalive_task: asyncio.Task | None = None
        self._done = asyncio.Event()
        self._last_recv = 0.0

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._last_recv = loop.time()
        if self.client:
            self.writer.write(PREFACE)
        settings = [(MAX_HEADER_LIST_SIZE, RECV_MAX_HEADER_LIST)]
        if self.client:
            settings.insert(0, (ENABLE_PUSH, 0))
        self._frame(SETTINGS, 0, 0, b"".join(
            k.to_bytes(2, "big") + v.to_bytes(4, "big") for k, v in settings))
        await self._drain()
        self._reader_task = asyncio.ensure_future(self._read_loop())
        self._keepalive_task = asyncio.ensure_future(self._keepalive())

    async def wait_closed(self) -> None:
        await self._done.wait()

    async def close(self, code: int = NO_ERROR) -> None:
        if not self.closed:
            self.send_goaway(code)
            try:
                await asyncio.wait_for(self.writer.drain(), CLOSE_TIMEOUT_S)
            except (OSError, asyncio.TimeoutError, ConnectionError):
                pass
        self._lost("connection closed")
        for task in (self._reader_task, self._keepalive_task):
            if task is not None and task is not asyncio.current_task():
                task.cancel()
        try:
            self.writer.close()
            await asyncio.wait_for(self.writer.wait_closed(), CLOSE_TIMEOUT_S)
        except (OSError, asyncio.TimeoutError, ConnectionError):
            pass

    def send_goaway(self, code: int = NO_ERROR) -> None:
        if self.closed or self.goaway_sent:
            return
        self.goaway_sent = True
        try:
            self._frame(GOAWAY, 0, 0, self.last_peer_stream.to_bytes(4, "big")
                        + code.to_bytes(4, "big"))
        except ConnectionError:
            pass

    def _lost(self, reason: str) -> None:
        if self.closed:
            return
        self.closed = True
        self.close_reason = reason
        for stream in list(self.streams.values()):
            stream.on_lost(reason)
        self.streams.clear()
        for future in self._pings.values():
            if not future.done():
                future.set_exception(ConnectionError(reason))
        self._pings.clear()
        self._wake_windows()
        self._done.set()
        try:
            self.writer.close()
        except (OSError, RuntimeError):
            pass

    # -- writing -------------------------------------------------------------

    def _frame(self, ftype: int, flags: int, stream_id: int, payload=b"") -> None:
        if self.closed:
            raise ConnectionError(f"connection closed: {self.close_reason}")
        self.writer.write(len(payload).to_bytes(3, "big") + bytes((ftype, flags))
                          + stream_id.to_bytes(4, "big") + bytes(payload))

    async def _drain(self) -> None:
        try:
            await asyncio.wait_for(self.writer.drain(), WRITE_TIMEOUT_S)
        except asyncio.TimeoutError:
            self._lost(f"a write stalled for {WRITE_TIMEOUT_S} s")
            raise ConnectionError("write stalled")

    def open_stream(self) -> Stream:
        if self.closed or self.goaway_received is not None:
            raise ConnectionError("connection is going away")
        stream = Stream(self, self.next_stream_id)
        self.next_stream_id += 2
        self.streams[stream.id] = stream
        return stream

    def forget(self, stream: Stream) -> None:
        self.streams.pop(stream.id, None)

    def send_headers(self, stream: Stream, headers, end_stream: bool = False) -> None:
        block = hpack.encode(headers)
        size = self.peer_max_frame
        first, rest = block[:size], block[size:]
        flags = (END_STREAM if end_stream else 0) | (0 if rest else END_HEADERS)
        self._frame(HEADERS, flags, stream.id, first)
        while rest:
            chunk, rest = rest[:size], rest[size:]
            self._frame(CONTINUATION, 0 if rest else END_HEADERS, stream.id, chunk)
        if end_stream:
            self._local_end(stream)

    def _local_end(self, stream: Stream) -> None:
        stream.local_closed = True
        if stream.remote_closed:
            self.forget(stream)

    async def send_data(self, stream: Stream, data: bytes, end_stream: bool = False) -> None:
        """``data`` in DATA frames within the peer's frame size and windows;
        waits (at most ``WINDOW_TIMEOUT_S`` at a time) for window credit."""
        view = memoryview(data)
        offset = 0
        while True:
            if stream.error is not None:
                raise stream.error
            remaining = len(view) - offset
            n = min(remaining, self.peer_max_frame, self.send_window, stream.send_window)
            if remaining and n <= 0:
                await self._wait_window(stream)
                continue
            last = offset + n == len(view)
            self._frame(DATA, END_STREAM if last and end_stream else 0, stream.id,
                        view[offset:offset + n])
            self.send_window -= n
            stream.send_window -= n
            offset += n
            if last:
                break
        if end_stream:
            self._local_end(stream)
        await self._drain()

    async def _wait_window(self, stream: Stream) -> None:
        """Wait for window credit, at most ``WINDOW_TIMEOUT_S``; then a PING
        tells a reader that is slow (its ACK comes: the caller waits again)
        from a peer that is gone (the stream fails)."""
        event = asyncio.Event()
        self._window_waiters.add(event)
        try:
            await asyncio.wait_for(event.wait(), WINDOW_TIMEOUT_S)
        except asyncio.TimeoutError:
            try:
                await self.ping()
            except (ConnectionError, asyncio.TimeoutError):
                self.reset(stream, CANCEL)
                stream._fail(RpcError(
                    StatusCode.DEADLINE_EXCEEDED,
                    f"no flow-control credit in {WINDOW_TIMEOUT_S} s and no PING answered"))
        finally:
            self._window_waiters.discard(event)
        if self.closed and stream.error is None:
            stream.on_lost(self.close_reason)

    def _wake_windows(self) -> None:
        for event in self._window_waiters:
            event.set()

    def reset(self, stream: Stream, code: int) -> None:
        """RST_STREAM for one stream (no-op once the connection is gone)."""
        self.forget(stream)
        stream.local_closed = stream.remote_closed = True
        if not self.closed:
            try:
                self._frame(RST_STREAM, 0, stream.id, code.to_bytes(4, "big"))
            except ConnectionError:
                pass

    async def ping(self, timeout: float = PING_TIMEOUT_S) -> float:
        """A PING and its ACK's round trip, in seconds."""
        loop = asyncio.get_running_loop()
        payload = os.urandom(8)
        future = loop.create_future()
        self._pings[payload] = future
        start = loop.time()
        try:
            self._frame(PING, 0, 0, payload)
            await self._drain()
            await asyncio.wait_for(future, timeout)
        finally:
            self._pings.pop(payload, None)
        return loop.time() - start

    # -- reading -------------------------------------------------------------

    async def _read_loop(self) -> None:
        reason = "connection closed by the peer"
        try:
            if not self.client:
                preface = await asyncio.wait_for(self.reader.readexactly(len(PREFACE)),
                                                 PREFACE_TIMEOUT_S)
                if preface != PREFACE:
                    raise ProtocolError(PROTOCOL_ERROR, "bad connection preface")
            loop = asyncio.get_running_loop()
            while True:
                head = await self.reader.readexactly(9)
                length = int.from_bytes(head[:3], "big")
                ftype, flags = head[3], head[4]
                stream_id = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
                if length > RECV_MAX_FRAME:
                    raise ProtocolError(FRAME_SIZE_ERROR, f"frame of {length} bytes")
                payload = await self.reader.readexactly(length) if length else b""
                self._last_recv = loop.time()
                self._on_frame(ftype, flags, stream_id, payload)
                if self.writer.transport.get_write_buffer_size() > 256 * 1024:
                    await self._drain()
        except asyncio.CancelledError:
            reason = "connection closed"
        except ProtocolError as e:
            reason = f"protocol error: {e}"
            log.warning("h2 %s: %s", self.name, reason)
            self.send_goaway(e.error_code)
        except hpack.HpackError as e:
            reason = f"header compression error: {e}"
            self.send_goaway(COMPRESSION_ERROR)
        except (asyncio.IncompleteReadError, ConnectionError, OSError, asyncio.TimeoutError) as e:
            reason = f"connection lost: {type(e).__name__}: {e}"
        finally:
            self._lost(reason)

    def _on_frame(self, ftype: int, flags: int, stream_id: int, payload: bytes) -> None:
        if self._block is not None and (ftype != CONTINUATION or stream_id != self._block[0]):
            raise ProtocolError(PROTOCOL_ERROR, "header block interrupted")
        if ftype == DATA:
            self._on_data(flags, stream_id, payload)
        elif ftype in (HEADERS, CONTINUATION):
            self._on_header_fragment(ftype, flags, stream_id, payload)
        elif ftype == RST_STREAM:
            if stream_id == 0 or len(payload) != 4:
                raise ProtocolError(PROTOCOL_ERROR, "bad RST_STREAM")
            stream = self.streams.pop(stream_id, None)
            if stream is not None:
                stream.on_reset(int.from_bytes(payload, "big"))
        elif ftype == SETTINGS:
            self._on_settings(flags, stream_id, payload)
        elif ftype == PING:
            if stream_id != 0 or len(payload) != 8:
                raise ProtocolError(PROTOCOL_ERROR, "bad PING")
            if flags & ACK:
                future = self._pings.get(payload)
                if future is not None and not future.done():
                    future.set_result(None)
            else:
                self._frame(PING, ACK, 0, payload)
        elif ftype == GOAWAY:
            last = int.from_bytes(payload[:4], "big") & 0x7FFFFFFF
            code = int.from_bytes(payload[4:8], "big")
            self.goaway_received = last
            for sid, stream in list(self.streams.items()):
                if sid > last and (sid % 2 == 1) == self.client:
                    self.streams.pop(sid)
                    stream._fail(RpcError(StatusCode.UNAVAILABLE,
                                          f"the peer went away (GOAWAY {code})"))
        elif ftype == WINDOW_UPDATE:
            if len(payload) != 4:
                raise ProtocolError(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
            increment = int.from_bytes(payload, "big") & 0x7FFFFFFF
            if stream_id == 0:
                if increment == 0:
                    raise ProtocolError(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
                self.send_window += increment
                if self.send_window > MAX_WINDOW:
                    raise ProtocolError(FLOW_CONTROL_ERROR, "connection window overflow")
            else:
                stream = self.streams.get(stream_id)
                if stream is not None:
                    stream.send_window += increment
                    if increment == 0 or stream.send_window > MAX_WINDOW:
                        self.reset(stream, FLOW_CONTROL_ERROR)
                        stream._fail(RpcError(StatusCode.INTERNAL, "bad stream window update"))
            self._wake_windows()
        elif ftype == PUSH_PROMISE:
            raise ProtocolError(PROTOCOL_ERROR, "push is disabled")
        # PRIORITY and unknown frame types are ignored

    def _on_data(self, flags: int, stream_id: int, payload: bytes) -> None:
        if stream_id == 0:
            raise ProtocolError(PROTOCOL_ERROR, "DATA on stream 0")
        size = len(payload)
        if flags & PADDED:
            pad = payload[0] if payload else 0
            if pad + 1 > len(payload):
                raise ProtocolError(PROTOCOL_ERROR, "bad padding")
            payload = payload[1:len(payload) - pad]
        # credit the connection window as the bytes leave the socket (a
        # stream's window waits for its reader: Stream.release)
        self.recv_unacked += size
        if self.recv_unacked >= DEFAULT_WINDOW // 2:
            self._frame(WINDOW_UPDATE, 0, 0, self.recv_unacked.to_bytes(4, "big"))
            self.recv_unacked = 0
        stream = self.streams.get(stream_id)
        if stream is not None:
            stream.on_data(payload, size - len(payload), bool(flags & END_STREAM))

    def _on_header_fragment(self, ftype: int, flags: int, stream_id: int, payload: bytes) -> None:
        if stream_id == 0:
            raise ProtocolError(PROTOCOL_ERROR, "HEADERS on stream 0")
        if ftype == HEADERS:
            if flags & PADDED:
                pad = payload[0] if payload else 0
                payload = payload[1:]
                if pad > len(payload):
                    raise ProtocolError(PROTOCOL_ERROR, "bad padding")
                payload = payload[:len(payload) - pad]
            if flags & PRIORITY_FLAG:
                payload = payload[5:]
            self._block = (stream_id, flags, bytearray(payload))
        else:
            if self._block is None:
                raise ProtocolError(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
            self._block[2].extend(payload)
        if len(self._block[2]) > RECV_MAX_HEADER_LIST * 2:
            raise ProtocolError(ENHANCE_YOUR_CALM, "header block too large")
        if not flags & END_HEADERS:
            return
        stream_id, first_flags, block = self._block
        self._block = None
        headers = self.decoder.decode(bytes(block))
        end_stream = bool(first_flags & END_STREAM)
        stream = self.streams.get(stream_id)
        if stream is not None:
            stream.on_headers(headers, end_stream)
            return
        if self.client or stream_id % 2 == 0 or stream_id <= self.last_peer_stream:
            return  # a closed or unknown stream's late headers
        self.last_peer_stream = stream_id
        stream = Stream(self, stream_id)
        if self.goaway_sent or self.on_stream is None:
            self.reset(stream, REFUSED_STREAM)
            return
        self.streams[stream_id] = stream
        stream.headers = headers
        if end_stream:
            stream._remote_end()
        self.on_stream(self, stream, headers)

    def _on_settings(self, flags: int, stream_id: int, payload: bytes) -> None:
        if stream_id != 0:
            raise ProtocolError(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & ACK:
            return
        if len(payload) % 6:
            raise ProtocolError(FRAME_SIZE_ERROR, "bad SETTINGS")
        for i in range(0, len(payload), 6):
            key = int.from_bytes(payload[i:i + 2], "big")
            value = int.from_bytes(payload[i + 2:i + 6], "big")
            if key == INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise ProtocolError(FLOW_CONTROL_ERROR, "initial window too large")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for stream in self.streams.values():
                    stream.send_window += delta
            elif key == MAX_FRAME_SIZE:
                if not DEFAULT_MAX_FRAME <= value <= (1 << 24) - 1:
                    raise ProtocolError(PROTOCOL_ERROR, "bad MAX_FRAME_SIZE")
                self.peer_max_frame = value
            # the encoder indexes nothing, so HEADER_TABLE_SIZE needs nothing
        self._frame(SETTINGS, ACK, 0)
        self._wake_windows()

    async def _keepalive(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while not self.closed:
                await asyncio.sleep(max(1.0, KEEPALIVE_S / 4))
                if self.streams and loop.time() - self._last_recv > KEEPALIVE_S:
                    try:
                        await self.ping(PING_TIMEOUT_S)
                    except (asyncio.TimeoutError, ConnectionError):
                        log.warning("h2 %s: keepalive PING unanswered; closing", self.name)
                        await self.close(PROTOCOL_ERROR)
                        return
        except asyncio.CancelledError:
            pass


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class RpcMethodHandler:
    def __init__(self, kind: str, behavior, request_deserializer=None,
                 response_serializer=None):
        if kind not in ("unary_unary", "stream_stream"):
            raise ValueError(f"unsupported RPC kind {kind!r}")
        self.kind = kind
        self.behavior = behavior
        self.request_deserializer = request_deserializer or (lambda b: b)
        self.response_serializer = response_serializer or (lambda m: m)


def rpc_method_handler(kind: str, behavior, *, request_deserializer=None,
                       response_serializer=None) -> RpcMethodHandler:
    return RpcMethodHandler(kind, behavior, request_deserializer, response_serializer)


class ServicerContext:
    """What a handler sees of its call (``grpc.aio.ServicerContext``'s
    ``cancelled`` and ``invocation_metadata``)."""

    def __init__(self, stream: Stream, headers: list):
        self._stream = stream
        self._metadata = headers_to_metadata(headers)
        self._cancelled = False

    def cancelled(self) -> bool:
        return self._cancelled or self._stream.error is not None

    def invocation_metadata(self) -> tuple:
        return self._metadata


class Server:
    """A gRPC server on the port's HTTP/2: ``handlers`` maps a method's
    path (``/package.Service/method``) to its :class:`RpcMethodHandler`."""

    def __init__(self, handlers: dict[str, RpcMethodHandler]):
        self.handlers = dict(handlers)
        self._server: asyncio.base_events.Server | None = None
        self._conns: set[Connection] = set()
        self._calls: dict[asyncio.Task, Connection] = {}
        self.port: int | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._accept, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _accept(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")
        conn = Connection(reader, writer, client=False, on_stream=self._on_stream,
                          name=f"server:{self.port} <- {peer}")
        self._conns.add(conn)
        try:
            await conn.start()
            await conn.wait_closed()
        except (ConnectionError, OSError):
            pass
        finally:
            self._conns.discard(conn)
            for task, owner in list(self._calls.items()):
                if owner is conn:
                    task.cancel()
            await conn.close()

    def _on_stream(self, conn: Connection, stream: Stream, headers: list) -> None:
        task = asyncio.ensure_future(self._serve(conn, stream, headers))
        self._calls[task] = conn
        task.add_done_callback(lambda t: self._calls.pop(t, None))

        def abort() -> None:
            if not task.done():
                task.cancel()

        stream.on_abort = abort

    async def _serve(self, conn: Connection, stream: Stream, headers: list) -> None:
        fields = dict(headers)
        handler = self.handlers.get(fields.get(":path", ""))
        context = ServicerContext(stream, headers)
        state = {"headers_sent": False}
        try:
            if fields.get(":method") != "POST" or not fields.get(
                    "content-type", "").startswith("application/grpc"):
                raise RpcError(StatusCode.INTERNAL, "not a gRPC request")
            if handler is None:
                raise RpcError(StatusCode.UNIMPLEMENTED, "Method not found!")
            if handler.kind == "unary_unary":
                payload = await stream.receive()
                if payload is None:
                    raise stream.error or RpcError(StatusCode.INTERNAL, "no request message")
                response = await handler.behavior(handler.request_deserializer(payload), context)
                await self._send(conn, stream, handler.response_serializer(response), state)
            else:
                responses = handler.behavior(self._requests(stream, handler), context)
                try:
                    async for response in responses:
                        await self._send(conn, stream, handler.response_serializer(response),
                                         state)
                finally:
                    await responses.aclose()
            self._trailers(conn, stream, StatusCode.OK, "", state)
        except asyncio.CancelledError:
            context._cancelled = True
            if stream.error is None and not conn.closed:
                conn.reset(stream, CANCEL)
        except RpcError as e:
            self._trailers(conn, stream, e.code(), e.details(), state)
        except Exception as e:  # noqa: BLE001  (the handler's failure is the call's status)
            log.exception("handler of %s failed", fields.get(":path"))
            self._trailers(conn, stream, StatusCode.UNKNOWN,
                           f"Unexpected {type(e)}: {e}", state)

    async def _requests(self, stream: Stream, handler: RpcMethodHandler):
        while True:
            payload = await stream.receive()
            if payload is None:
                if stream.error is not None:
                    raise asyncio.CancelledError()
                return
            yield handler.request_deserializer(payload)

    async def _send(self, conn: Connection, stream: Stream, payload: bytes, state: dict) -> None:
        async with stream.write_lock:
            if not state["headers_sent"]:
                conn.send_headers(stream, [(":status", "200"),
                                           ("content-type", "application/grpc")])
                state["headers_sent"] = True
            await conn.send_data(stream, frame_message(payload))

    def _trailers(self, conn: Connection, stream: Stream, code: StatusCode, message: str,
                  state: dict) -> None:
        if conn.closed or stream.error is not None or stream.local_closed:
            return
        trailers = [("grpc-status", str(int(code)))]
        if message:
            trailers.append(("grpc-message", percent_encode(message)))
        if not state["headers_sent"]:  # trailers-only
            trailers = [(":status", "200"), ("content-type", "application/grpc")] + trailers
        try:
            conn.send_headers(stream, trailers, end_stream=True)
            if not stream.remote_closed:  # the client may stop sending
                conn.reset(stream, NO_ERROR)
        except ConnectionError:
            pass

    async def stop(self, grace: float | None = None) -> None:
        """No new calls; the running ones get ``grace`` seconds to end, then
        are cancelled; every connection is closed."""
        if self._server is not None:
            self._server.close()
        for conn in list(self._conns):
            conn.send_goaway(NO_ERROR)
        calls = list(self._calls)
        if calls and grace:
            await asyncio.wait(calls, timeout=grace)
        for task in list(self._calls):
            task.cancel()
        if self._calls:
            await asyncio.wait(list(self._calls), timeout=CLOSE_TIMEOUT_S)
        for conn in list(self._conns):
            await conn.close()
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), CLOSE_TIMEOUT_S)
            except asyncio.TimeoutError:
                pass


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------


class Channel:
    """A channel to one ``host:port``: one connection at a time, opened at
    the first call and again after the old one went away."""

    def __init__(self, target: str):
        for prefix in ("ipv4:", "dns:///", "dns:"):
            if target.startswith(prefix):
                target = target[len(prefix):]
        host, _, port = target.rpartition(":")
        self.host = host.strip("[]") or "127.0.0.1"
        self.port = int(port)
        self.target = target
        self._conn: Connection | None = None
        self._lock: asyncio.Lock | None = None
        self._calls: set = set()
        self._closed = False

    async def connection(self) -> Connection:
        if self._closed:
            raise RpcError(StatusCode.CANCELLED, "the channel is closed")
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            conn = self._conn
            if conn is None or conn.closed or conn.goaway_received is not None:
                try:
                    reader, writer = await asyncio.wait_for(
                        asyncio.open_connection(self.host, self.port), CONNECT_TIMEOUT_S)
                except (OSError, asyncio.TimeoutError) as e:
                    raise RpcError(StatusCode.UNAVAILABLE,
                                   f"failed to connect to {self.target}: {e}")
                conn = Connection(reader, writer, client=True, name=f"client -> {self.target}")
                await conn.start()
                self._conn = conn
            return conn

    def unary_unary(self, method: str, request_serializer=None, response_deserializer=None):
        return UnaryUnaryMultiCallable(self, method, request_serializer, response_deserializer)

    def stream_stream(self, method: str, request_serializer=None, response_deserializer=None):
        return StreamStreamMultiCallable(self, method, request_serializer, response_deserializer)

    def _request_headers(self, method: str, timeout: float | None, metadata) -> list:
        headers = [(":method", "POST"), (":scheme", "http"), (":path", method),
                   (":authority", self.target), ("content-type", "application/grpc"),
                   ("te", "trailers"), ("user-agent", USER_AGENT)]
        if timeout is not None:
            headers.append(("grpc-timeout", _timeout_header(timeout)))
        return headers + metadata_to_headers(metadata)

    async def close(self, grace: float | None = None) -> None:
        self._closed = True
        for call in list(self._calls):
            call.cancel()
        if self._conn is not None:
            await self._conn.close()


def insecure_channel(target: str) -> Channel:
    return Channel(target)


def _status_error(stream: Stream) -> RpcError | None:
    """The call's outcome from its trailers (None when OK)."""
    trailers = stream.trailers or []
    fields = dict(trailers)
    status = fields.get("grpc-status")
    if status is None:
        http = (stream.headers and dict(stream.headers).get(":status")) or "?"
        return RpcError(StatusCode.UNKNOWN if http == "200" else StatusCode.UNAVAILABLE,
                        f"call ended without grpc-status (HTTP status {http})")
    try:
        code = StatusCode(int(status))
    except ValueError:
        code = StatusCode.UNKNOWN
    if code == StatusCode.OK:
        return None
    return RpcError(code, percent_decode(fields.get("grpc-message", "")))


class UnaryUnaryMultiCallable:
    def __init__(self, channel: Channel, method: str, serializer, deserializer):
        self.channel = channel
        self.method = method
        self.serializer = serializer or (lambda m: m)
        self.deserializer = deserializer or (lambda b: b)

    async def __call__(self, request, *, timeout: float | None = None, metadata=None):
        timeout = DEFAULT_UNARY_TIMEOUT_S if timeout is None else timeout
        try:
            return await asyncio.wait_for(self._call(request, timeout, metadata), timeout)
        except asyncio.TimeoutError:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")

    async def _call(self, request, timeout, metadata):
        conn = await self.channel.connection()
        try:
            stream = conn.open_stream()
        except ConnectionError as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e))
        try:
            conn.send_headers(stream, self.channel._request_headers(self.method, timeout,
                                                                    metadata))
            await conn.send_data(stream, frame_message(self.serializer(request)),
                                 end_stream=True)
            payload = await stream.receive()
            while await stream.receive() is not None:
                pass
        except ConnectionError as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e))
        except asyncio.CancelledError:
            conn.reset(stream, CANCEL)
            raise
        if stream.error is not None:
            raise stream.error
        error = _status_error(stream)
        if error is not None:
            raise error
        if payload is None:
            raise RpcError(StatusCode.INTERNAL, "no response message")
        return self.deserializer(payload)


class StreamStreamMultiCallable:
    def __init__(self, channel: Channel, method: str, serializer, deserializer):
        self.channel = channel
        self.method = method
        self.serializer = serializer or (lambda m: m)
        self.deserializer = deserializer or (lambda b: b)

    def __call__(self, *, metadata=None) -> "StreamStreamCall":
        return StreamStreamCall(self, metadata)


class StreamStreamCall:
    """A bidi call: it starts at once (as ``grpc.aio``'s), ``write`` sends a
    request, ``done_writing`` half-closes, ``async for`` reads the responses
    and raises :class:`RpcError` when the call ends badly (``CancelledError``
    after a local ``cancel``)."""

    def __init__(self, callable_: StreamStreamMultiCallable, metadata):
        self._callable = callable_
        self._channel = callable_.channel
        self._stream: Stream | None = None
        self._conn: Connection | None = None
        self._cancelled = False
        self._done = False
        self._channel._calls.add(self)
        self._opened = asyncio.ensure_future(self._open(metadata))

    async def _open(self, metadata) -> None:
        try:
            conn = await self._channel.connection()
            stream = conn.open_stream()
        except ConnectionError as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e))
        self._conn, self._stream = conn, stream
        conn.send_headers(stream, self._channel._request_headers(
            self._callable.method, None, metadata))
        await conn._drain()

    async def _ready(self) -> Stream:
        if self._cancelled:
            raise asyncio.CancelledError()
        try:
            await asyncio.shield(self._opened)
        except ConnectionError as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e))
        return self._stream

    async def write(self, request) -> None:
        stream = await self._ready()
        if self._done:
            raise asyncio.InvalidStateError("RPC already finished.")
        if stream.error is not None:
            raise stream.error
        if stream.local_closed:
            raise asyncio.InvalidStateError("writes are done")
        payload = frame_message(self._callable.serializer(request))
        try:
            async with stream.write_lock:
                await self._conn.send_data(stream, payload)
        except ConnectionError as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e))

    async def done_writing(self) -> None:
        stream = await self._ready()
        if stream.local_closed or stream.error is not None:
            return
        async with stream.write_lock:
            try:
                await self._conn.send_data(stream, b"", end_stream=True)
            except ConnectionError as e:
                raise RpcError(StatusCode.UNAVAILABLE, str(e))

    def cancel(self) -> bool:
        if self._done or self._cancelled:
            return False
        self._cancelled = True
        self._channel._calls.discard(self)
        stream = self._stream
        if stream is not None:
            self._conn.reset(stream, CANCEL)
            stream._fail(asyncio.CancelledError())
        else:
            self._opened.cancel()
        return True

    def __aiter__(self):
        return self._responses()

    async def _responses(self):
        stream = await self._ready()
        while True:
            payload = await stream.receive()
            if payload is None:
                break
            yield self._callable.deserializer(payload)
        self._done = True
        self._channel._calls.discard(self)
        if self._cancelled:
            raise asyncio.CancelledError()
        if stream.error is not None:
            raise stream.error
        error = _status_error(stream)
        if error is not None:
            raise error
