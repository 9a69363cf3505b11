"""The port's gRPC wire (``langstream_tpu_torch/grpc``) against protobuf,
RFC 7541 and itself:

- the 14 messages of ``agent.proto``: for hypothesis-drawn values the
  port's encoding equals the JAX package's protobuf encoding byte for byte,
  and each side decodes the other's bytes to the same message; packed and
  unpacked ``committed_ids``, negative int64 values (ten-byte varints), a
  oneof member at its default, unknown fields of every wire type, refused
  bad input; the port's field table equals each JAX message's
  ``DESCRIPTOR``;
- HPACK: RFC 7541 Appendix C.2–C.6 decoded (the dynamic table's entries
  and size after each block, eviction included), the Huffman code complete
  (the Kraft sum of its 257 lengths is 1), bad Huffman padding and EOS
  refused, the encoder's blocks read back;
- h2, the port's client and server: a 1 MiB record through a bidi call
  and through the sidecar server's ``process`` both ways, past the 64 KiB
  windows and the 16 KiB frame size; a PING
  acked; a cancelled call arriving as RST_STREAM(CANCEL), the handler
  cancelled; a status and a percent-encoded message in the trailers; an
  unknown method; a dead peer as ``RpcError(UNAVAILABLE)``.
"""

import asyncio
from fractions import Fraction

import pytest
from google.protobuf import descriptor
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from langstream_tpu.grpc.proto import load_messages as jax_load_messages
from langstream_tpu_torch.grpc import h2, hpack, proto

JAX = jax_load_messages()
PORT = proto.load_messages()
NAMES = list(proto.SCHEMA)

INT64 = st.integers(min_value=-(1 << 63), max_value=(1 << 63) - 1)
TEXT = st.text(max_size=12)
BLOB = st.binary(max_size=12)


def _scalar(ftype: str):
    return {"int64": INT64, "bool": st.booleans(), "string": TEXT, "bytes": BLOB}[ftype]


def spec_of(name: str, depth: int = 0):
    """A strategy for the field assignments of message ``name``: a dict of
    field name -> value, a nested dict for a sub-message, a list for a
    repeated field."""
    fields = proto.SCHEMA[name]
    oneofs = {f.oneof for f in fields if f.oneof}
    parts = {}
    for field in fields:
        if field.oneof:
            continue
        if field.type == "message":
            inner = spec_of(field.message, depth + 1) if depth < 2 else st.just({})
            value = st.lists(inner, max_size=2) if field.repeated else inner
        else:
            value = st.lists(_scalar(field.type), max_size=4) if field.repeated else \
                _scalar(field.type)
        parts[field.name] = st.one_of(st.none(), value)
    base = st.fixed_dictionaries(parts).map(
        lambda d: {k: v for k, v in d.items() if v is not None})
    if not oneofs:
        return base
    members = [f for f in fields if f.oneof]
    choice = st.one_of(st.none(), st.sampled_from(members).flatmap(
        lambda f: _scalar(f.type).map(lambda v, f=f: {f.name: v})))
    return st.tuples(base, choice).map(lambda t: {**t[0], **(t[1] or {})})


def build(pb2, name: str, spec: dict):
    """The same message in either package, set field by field."""
    message = getattr(pb2, name)()
    fields = {f.name: f for f in proto.SCHEMA[name]}
    for key, value in spec.items():
        field = fields[key]
        if field.type == "message":
            if field.repeated:
                for item in value:
                    getattr(message, key).append(build(pb2, field.message, item))
            else:
                getattr(message, key).CopyFrom(build(pb2, field.message, value))
        elif field.repeated:
            getattr(message, key).extend(value)
        else:
            setattr(message, key, value)
    return message


def as_data(message) -> dict:
    """A message of either package as plain data (presence included)."""
    out = {}
    for field in proto.SCHEMA[type(message).__name__]:
        value = getattr(message, field.name)
        if field.repeated:
            out[field.name] = [as_data(v) for v in value] if field.type == "message" \
                else list(value)
        elif field.type == "message":
            out[field.name] = as_data(value) if message.HasField(field.name) else None
        elif field.oneof:
            out[field.name] = value if message.WhichOneof(field.oneof) == field.name else None
        else:
            out[field.name] = value
    return out


@pytest.mark.parametrize("name", NAMES)
@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_every_message_encodes_as_protobuf_and_decodes_either_way(name, data):
    spec = data.draw(spec_of(name))
    jax_msg, port_msg = build(JAX, name, spec), build(PORT, name, spec)
    jax_bytes, port_bytes = jax_msg.SerializeToString(), port_msg.SerializeToString()
    assert port_bytes == jax_bytes
    assert as_data(port_msg) == as_data(jax_msg)
    from_jax = getattr(PORT, name).FromString(jax_bytes)
    assert from_jax == port_msg and as_data(from_jax) == as_data(jax_msg)
    from_port = getattr(JAX, name).FromString(port_bytes)
    assert from_port == jax_msg and as_data(from_port) == as_data(port_msg)


def _repeated(field) -> bool:
    if hasattr(field, "is_repeated"):
        return field.is_repeated
    return field.label == descriptor.FieldDescriptor.LABEL_REPEATED


@pytest.mark.parametrize("name", NAMES)
def test_the_field_table_equals_the_protobuf_descriptor(name):
    types = {descriptor.FieldDescriptor.TYPE_INT64: "int64",
             descriptor.FieldDescriptor.TYPE_BOOL: "bool",
             descriptor.FieldDescriptor.TYPE_STRING: "string",
             descriptor.FieldDescriptor.TYPE_BYTES: "bytes",
             descriptor.FieldDescriptor.TYPE_MESSAGE: "message"}
    want = sorted(
        (f.name, f.number, types[f.type], _repeated(f),
         f.message_type.name if f.message_type else None,
         f.containing_oneof.name if f.containing_oneof else None)
        for f in getattr(JAX, name).DESCRIPTOR.fields)
    got = sorted(tuple(f) for f in getattr(PORT, name).FIELDS)
    assert got == want
    assert getattr(JAX, name).DESCRIPTOR.full_name == f"langstream_tpu.{name}"
    assert proto.SERVICE_NAME == "langstream_tpu.ExternalAgent"


def test_committed_ids_packed_and_unpacked_and_negative_int64():
    ids = [1, -1, 0, (1 << 63) - 1, -(1 << 63), 300]
    packed = PORT.SourceRequest(committed_ids=ids, failed_id=-2).SerializeToString()
    assert packed == JAX.SourceRequest(committed_ids=ids, failed_id=-2).SerializeToString()
    assert packed[0] == 0x0A  # field 1, length-delimited: packed
    unpacked = bytearray()
    for value in ids:
        unpacked.append(0x08)  # field 1, varint: one value per tag
        proto.write_varint(unpacked, value)
    unpacked.append(0x10)
    proto.write_varint(unpacked, -2)
    for data in (packed, bytes(unpacked)):
        port_msg = PORT.SourceRequest.FromString(data)
        jax_msg = JAX.SourceRequest.FromString(data)
        assert list(port_msg.committed_ids) == list(jax_msg.committed_ids) == ids
        assert port_msg.failed_id == jax_msg.failed_id == -2
    # a negative int64 is a ten-byte varint
    assert len(PORT.SinkResponse(record_id=-1).SerializeToString()) == 1 + 10
    # a mix of packed runs and single values appends in order
    mixed = bytes(unpacked[:2]) + packed[:2 + packed[1]]
    assert list(PORT.SourceRequest.FromString(mixed).committed_ids) == \
        list(JAX.SourceRequest.FromString(mixed).committed_ids)


def test_a_oneof_member_at_its_default_is_written():
    for pb2 in (PORT, JAX):
        datum = pb2.Datum(null_value=False)
        assert datum.WhichOneof("kind") == "null_value"
        assert datum.SerializeToString() == b"\x08\x00"
        datum.string_value = "x"
        assert datum.WhichOneof("kind") == "string_value" and not datum.null_value
    record = PORT.WireRecord()
    record.key.CopyFrom(PORT.Datum())
    assert record.SerializeToString() == b"\x12\x00"  # present, even empty
    assert not PORT.WireRecord().HasField("key")


UNKNOWN = [b"\x98\x06\x96\x01",                   # field 99 varint
           b"\x99\x06" + bytes(range(8)),          # field 99 fixed64
           b"\x9a\x06\x03abc",                     # field 99 length-delimited
           b"\x9d\x06\x01\x02\x03\x04",            # field 99 fixed32
           b"\x9b\x06\x08\x01\x9c\x06",            # field 99 group with a varint inside
           b"\x19" + bytes(8)]                     # field 3 of Header with a wrong wire type


@pytest.mark.parametrize("extra", UNKNOWN, ids=["varint", "i64", "len", "i32", "group",
                                                "wrong-wire-type"])
def test_unknown_fields_are_skipped_by_both(extra):
    for name, pb2_spec in (("Header", {"name": "h", "value": {"string_value": "v"}}),
                           ("WireRecord", {"record_id": 7, "origin": "o",
                                           "headers": [{"name": "a"}]})):
        base = build(PORT, name, pb2_spec).SerializeToString()
        for data in (extra + base, base + extra):
            port_msg = getattr(PORT, name).FromString(data)
            jax_msg = getattr(JAX, name).FromString(data)
            assert as_data(port_msg) == as_data(jax_msg)
            jax_msg.DiscardUnknownFields()
            assert port_msg.SerializeToString() == jax_msg.SerializeToString() == base


@pytest.mark.parametrize("data", [b"\x0a\x05ab", b"\x08", b"\x0a\x02\xff\xfe", b"\x07",
                                  b"\x08\xff\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01"],
                         ids=["truncated-len", "truncated-varint", "bad-utf8",
                              "bad-wire-type", "varint-over-ten-bytes"])
def test_bad_input_is_refused_by_both(data):
    name = "InfoResponse" if data.startswith(b"\x0a") else "SinkResponse"
    with pytest.raises(Exception) as jax_error:
        getattr(JAX, name).FromString(data)
    assert type(jax_error.value).__name__ == "DecodeError"
    with pytest.raises(proto.DecodeError):
        getattr(PORT, name).FromString(data)


def test_message_api_as_the_client_and_server_use_it():
    response = PORT.ProcessResponse()
    result = PORT.ProcessResult(record_id=3)
    result.records.append(PORT.WireRecord(record_id=3))
    response.results.append(result)
    result.error = "changed after append"  # append stored a copy
    assert response.results[0].error == ""
    header = response.results[0].records[0].headers.add()
    header.name = "k"
    header.value.bytes_value = b"\x00"
    assert as_data(PORT.ProcessResponse.FromString(response.SerializeToString())) == \
        as_data(response)
    with pytest.raises(AttributeError):
        response.results = []
    with pytest.raises(TypeError):
        PORT.Datum().bytes_value = "text"
    with pytest.raises(ValueError):
        PORT.Datum(no_such_field=1)
    sink = PORT.SinkRequest()
    sink.record.record_id = 0  # setting a field makes the sub-message present
    assert sink.HasField("record") and sink.SerializeToString() == b"\x0a\x00"


# ---------------------------------------------------------------------------
# HPACK
# ---------------------------------------------------------------------------


def test_the_huffman_code_is_complete_and_canonical():
    lengths = [length for length, symbols in hpack.HUFFMAN_SYMBOLS_BY_LENGTH.items()
               for _ in symbols]
    assert len(lengths) == 257
    assert sorted(s for symbols in hpack.HUFFMAN_SYMBOLS_BY_LENGTH.values()
                  for s in symbols) == list(range(257))
    assert sum(Fraction(1, 1 << n) for n in lengths) == 1  # Kraft: complete
    assert hpack.HUFFMAN_CODES[hpack.EOS] == ((1 << 30) - 1, 30)
    # RFC 7541 Appendix B's rows for a few symbols
    assert hpack.HUFFMAN_CODES[ord("0")] == (0x0, 5)
    assert hpack.HUFFMAN_CODES[ord("a")] == (0x3, 5)
    assert hpack.HUFFMAN_CODES[ord(" ")] == (0x14, 6)
    assert hpack.HUFFMAN_CODES[ord("\\")] == (0x7FFF0, 19)
    assert hpack.HUFFMAN_CODES[0] == (0x1FF8, 13)
    assert hpack.HUFFMAN_CODES[255] == (0x3FFFFEE, 26)


@pytest.mark.parametrize("data", [bytes(range(256)), b"", b"a" * 100, b"\xff\x00" * 7])
def test_huffman_round_trip(data):
    assert hpack.huffman_decode(hpack.huffman_encode(data)) == data


@pytest.mark.parametrize("bad", [
    hpack.huffman_encode(b"www") + b"\xff",    # padding of 8 ones or more
    bytes.fromhex("f1e3c2e5f23a6ba0ab90f4fe"),  # padding ends in a zero bit
    b"\xff\xff\xff\xfc",                        # EOS in the string
], ids=["padding-over-7-bits", "padding-not-eos", "eos"])
def test_bad_huffman_is_refused(bad):
    with pytest.raises(hpack.HpackError):
        hpack.huffman_decode(bad)


def _hx(text: str) -> bytes:
    return bytes.fromhex("".join(text.split()))


C3_REQUESTS = [
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com")],
    [(":method", "GET"), (":scheme", "http"), (":path", "/"),
     (":authority", "www.example.com"), ("cache-control", "no-cache")],
    [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
     (":authority", "www.example.com"), ("custom-key", "custom-value")],
]
C3_TABLES = [
    ([(":authority", "www.example.com")], 57),
    ([("cache-control", "no-cache"), (":authority", "www.example.com")], 110),
    ([("custom-key", "custom-value"), ("cache-control", "no-cache"),
      (":authority", "www.example.com")], 164),
]
_DATE1, _DATE2 = "Mon, 21 Oct 2013 20:13:21 GMT", "Mon, 21 Oct 2013 20:13:22 GMT"
_COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
_LOC = "https://www.example.com"
C5_RESPONSES = [
    [(":status", "302"), ("cache-control", "private"), ("date", _DATE1), ("location", _LOC)],
    [(":status", "307"), ("cache-control", "private"), ("date", _DATE1), ("location", _LOC)],
    [(":status", "200"), ("cache-control", "private"), ("date", _DATE2), ("location", _LOC),
     ("content-encoding", "gzip"), ("set-cookie", _COOKIE)],
]
C5_TABLES = [
    ([("location", _LOC), ("date", _DATE1), ("cache-control", "private"),
      (":status", "302")], 222),
    ([(":status", "307"), ("location", _LOC), ("date", _DATE1),
      ("cache-control", "private")], 222),
    ([("set-cookie", _COOKIE), ("content-encoding", "gzip"), ("date", _DATE2)], 215),
]
RFC_C = {
    "C.3": ([_hx("8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d"),
             _hx("8286 84be 5808 6e6f 2d63 6163 6865"),
             _hx("8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661 6c75 65")],
            C3_REQUESTS, C3_TABLES, 4096),
    "C.4": ([_hx("8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff"),
             _hx("8286 84be 5886 a8eb 1064 9cbf"),
             _hx("8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf")],
            C3_REQUESTS, C3_TABLES, 4096),
    "C.5": ([_hx("4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63 7420"
                 "3230 3133 2032 303a 3133 3a32 3120 474d 546e 1768 7474 7073 3a2f 2f77"
                 "7777 2e65 7861 6d70 6c65 2e63 6f6d"),
             _hx("4803 3330 37c1 c0bf"),
             _hx("88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133 3a32"
                 "3220 474d 54c0 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48 514b 425a"
                 "584f 5157 454f 5049 5541 5851 5745 4f49 553b 206d 6178 2d61 6765 3d33"
                 "3630 303b 2076 6572 7369 6f6e 3d31")],
            C5_RESPONSES, C5_TABLES, 256),
    "C.6": ([_hx("4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81"
                 "66e0 82a6 2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3"),
             _hx("4883 640e ffc1 c0bf"),
             _hx("88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a"
                 "839b d9ab 77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36"
                 "72c1 ab27 0fb5 291f 9587 3160 65c0 03ed 4ee5 b106 3d50 07")],
            C5_RESPONSES, C5_TABLES, 256),
}


@pytest.mark.parametrize("example", sorted(RFC_C))
def test_rfc7541_appendix_c_sequences_decode(example):
    blocks, headers, tables, size = RFC_C[example]
    decoder = hpack.Decoder(4096)
    decoder.max_size = size
    for block, want, (entries, table_size) in zip(blocks, headers, tables):
        assert decoder.decode(block) == want
        assert list(decoder.table) == entries
        assert decoder.size == table_size


C2 = [  # (block, headers, dynamic table after)
    (_hx("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572"),
     [("custom-key", "custom-header")], [("custom-key", "custom-header")]),
    (_hx("040c 2f73 616d 706c 652f 7061 7468"), [(":path", "/sample/path")], []),
    (_hx("1008 7061 7373 776f 7264 0673 6563 7265 74"), [("password", "secret")], []),
    (_hx("82"), [(":method", "GET")], []),
]


@pytest.mark.parametrize("case", range(len(C2)), ids=["C.2.1", "C.2.2", "C.2.3", "C.2.4"])
def test_rfc7541_c2_literal_and_indexed_fields(case):
    block, want, table = C2[case]
    decoder = hpack.Decoder()
    assert decoder.decode(block) == want
    assert list(decoder.table) == table


def test_table_size_updates_and_the_encoder():
    decoder = hpack.Decoder(4096)
    decoder.decode(C2[0][0])
    assert decoder.size == 55
    assert decoder.decode(b"\x20") == [] and decoder.size == 0  # size update to 0 evicts
    with pytest.raises(hpack.HpackError):
        decoder.decode(hpack.encode_integer(8192, 5, 0x20))  # over our SETTINGS
    with pytest.raises(hpack.HpackError):
        decoder.decode(b"\x82\x20")  # an update after a field
    with pytest.raises(hpack.HpackError):
        decoder.decode(b"\xc0")  # index past both tables
    headers = [(":status", "200"), ("grpc-message", "x" * 300), ("trace-bin", "AAE")]
    block = hpack.encode(headers)
    assert hpack.Decoder().decode(block) == headers and block[0] == 0x00
    assert hpack.decode_integer(hpack.encode_integer(1337, 5), 0, 5) == (1337, 3)


# ---------------------------------------------------------------------------
# h2: the port's client and server
# ---------------------------------------------------------------------------


async def _echo_server(**extra):
    seen: dict = {"cancelled": 0}

    async def echo(requests, context):
        seen["metadata"] = context.invocation_metadata()
        try:
            async for request in requests:
                yield request
        except asyncio.CancelledError:
            seen["cancelled"] += 1
            raise

    async def fail(request, context):
        raise h2.RpcError(h2.StatusCode.FAILED_PRECONDITION, "nope: 100% ünicode\n")

    async def hang(requests, context):
        seen["context"] = context
        try:
            await asyncio.sleep(60)
        except asyncio.CancelledError:
            seen["cancelled"] += 1
            raise
        yield b""

    handlers = {"/t.S/echo": h2.rpc_method_handler("stream_stream", echo),
                "/t.S/fail": h2.rpc_method_handler("unary_unary", fail),
                "/t.S/hang": h2.rpc_method_handler("stream_stream", hang), **extra}
    server = h2.Server(handlers)
    port = await server.start("127.0.0.1", 0)
    return server, port, seen


def test_a_1mib_record_crosses_both_ways_past_the_window_and_frame_size():
    async def main():
        server, port, seen = await _echo_server()
        channel = h2.insecure_channel(f"127.0.0.1:{port}")
        call = channel.stream_stream("/t.S/echo")(metadata=[("trace-bin", b"\x00\xff"),
                                                            ("tenant", "t1")])
        big = bytes(range(256)) * 4096  # 1 MiB
        await call.write(big)
        await call.write(b"small")
        await call.done_writing()
        got = [m async for m in call]
        conn = await channel.connection()
        rtt = await conn.ping()
        await channel.close()
        await server.stop(1)
        return got, seen, rtt

    got, seen, rtt = asyncio.run(main())
    assert got == [bytes(range(256)) * 4096, b"small"]
    assert dict(seen["metadata"]) == {"trace-bin": b"\x00\xff", "tenant": "t1"}
    assert 0 <= rtt < 5  # ping() returns only once its ACK is in


def test_a_reader_that_does_not_read_holds_the_sender_to_one_window(monkeypatch):
    """A stream's window is credited as its handler takes messages: while
    the handler reads nothing, the client's writes stop once one default
    window of messages is unread, and go on (no error) when it reads, even
    past ``WINDOW_TIMEOUT_S``, since the server answers the PING that
    follows the timeout."""
    monkeypatch.setattr(h2, "WINDOW_TIMEOUT_S", 0.3)
    chunk = b"x" * 16_000  # 16,005 bytes framed: four fit a window, the fifth waits
    gate = asyncio.Event

    async def main():
        opened = gate()

        async def slow(requests, context):
            await opened.wait()
            async for request in requests:
                yield bytes([len(request) % 251])

        server, port, _ = await _echo_server(
            **{"/t.S/slow": h2.rpc_method_handler("stream_stream", slow)})
        channel = h2.insecure_channel(f"127.0.0.1:{port}")
        call = channel.stream_stream("/t.S/slow")()
        written = []

        async def writer():
            for i in range(12):
                await call.write(chunk)
                written.append(i)
            await call.done_writing()

        task = asyncio.ensure_future(writer())
        await asyncio.sleep(1.0)  # three window timeouts, each answered by a PING
        stalled = (len(written), call._stream.send_window, call._stream.error)
        opened.set()
        got = [m async for m in call]
        await asyncio.wait_for(task, 10)
        await channel.close()
        await server.stop(1)
        return stalled, got, written

    (stalled_at, window, error), got, written = asyncio.run(main())
    assert stalled_at == h2.DEFAULT_WINDOW // 16_005 == 4
    assert window == 0 and error is None
    assert got == [bytes([16_000 % 251])] * 12 and written == list(range(12))


def test_a_1mib_record_through_process_both_ways(tmp_path):
    """The sidecar server's ``process`` RPC, port to port: a 1 MiB value in
    one ``ProcessRequest`` and its 1 MiB result back, each crossing 16
    windows of 64 KiB in 16 KiB frames."""
    from langstream_tpu_torch.grpc.server import AgentServer

    (tmp_path / "python").mkdir()
    (tmp_path / "python" / "wire_agents.py").write_text(
        "class Reverse:\n    def process(self, record):\n"
        "        return [(record.value[::-1], record.key, None)]\n")
    value = "".join(chr(97 + i % 26) for i in range(1 << 20))

    async def main():
        server = AgentServer({"className": "wire_agents.Reverse",
                              "__application_directory__": str(tmp_path)})
        port = await server.start()
        channel = h2.insecure_channel(f"127.0.0.1:{port}")
        call = channel.stream_stream(
            f"/{proto.SERVICE_NAME}/process",
            request_serializer=PORT.ProcessRequest.SerializeToString,
            response_deserializer=PORT.ProcessResponse.FromString)()
        request = PORT.ProcessRequest()
        record = request.records.add(record_id=-7)
        record.value.string_value = value
        record.key.bytes_value = b"\x00k"
        await call.write(request)
        await call.done_writing()
        responses = [r async for r in call]
        await channel.close()
        await server.stop(1)
        return responses

    (response,) = asyncio.run(main())
    (result,) = response.results
    (out,) = result.records
    assert result.record_id == out.record_id == -7 and not result.error
    assert out.value.string_value == value[::-1] and out.key.bytes_value == b"\x00k"


def test_a_cancelled_call_resets_its_stream_and_cancels_the_handler():
    async def main():
        server, port, seen = await _echo_server()
        channel = h2.insecure_channel(f"127.0.0.1:{port}")
        call = channel.stream_stream("/t.S/hang")()
        await call.write(b"x")
        for _ in range(100):
            if "context" in seen:
                break
            await asyncio.sleep(0.01)
        assert call.cancel() and not call.cancel()
        with pytest.raises(asyncio.CancelledError):
            async for _ in call:
                pass
        for _ in range(100):
            if seen["cancelled"]:
                break
            await asyncio.sleep(0.01)
        cancelled = seen["context"].cancelled()
        # the channel carries on: a new call on the same connection works
        echo = channel.stream_stream("/t.S/echo")()
        await echo.write(b"after")
        await echo.done_writing()
        after = [m async for m in echo]
        await channel.close()
        await server.stop(1)
        return seen["cancelled"], cancelled, after

    assert asyncio.run(main()) == (1, True, [b"after"])


def test_statuses_in_trailers_and_a_dead_peer():
    async def main():
        server, port, _ = await _echo_server()
        channel = h2.insecure_channel(f"127.0.0.1:{port}")
        errors = []
        for path in ("/t.S/fail", "/t.S/nothing"):
            try:
                await channel.unary_unary(path)(b"")
            except h2.RpcError as e:
                errors.append((e.code(), e.details()))
        call = channel.stream_stream("/t.S/echo")()
        await call.write(b"one")
        first = await call.__aiter__().__anext__()
        for conn in list(server._conns):  # the peer dies mid-call
            conn.writer.transport.abort()
        try:
            async for _ in call:
                pass
            lost = None
        except h2.RpcError as e:
            lost = e.code()
        await channel.close()
        await server.stop(0)
        dead = h2.insecure_channel(f"127.0.0.1:{port}")
        try:
            await dead.unary_unary("/t.S/fail")(b"")
        except h2.RpcError as e:
            refused = e.code()
        return errors, first, lost, refused

    errors, first, lost, refused = asyncio.run(main())
    assert errors == [(h2.StatusCode.FAILED_PRECONDITION, "nope: 100% ünicode\n"),
                      (h2.StatusCode.UNIMPLEMENTED, "Method not found!")]
    assert first == b"one"
    assert lost == h2.StatusCode.UNAVAILABLE and refused == h2.StatusCode.UNAVAILABLE


def test_percent_encoding_and_timeouts():
    text = "a%b ü\n"
    assert h2.percent_encode(text) == "a%25b %C3%BC%0A"
    assert h2.percent_decode(h2.percent_encode(text)) == text
    assert h2.percent_decode("bad %zz and %4") == "bad %zz and %4"
    assert h2._timeout_header(1.5) == "1500000u" and h2._timeout_header(60.0) == "60000000u"
    assert h2._timeout_header(1e6) == "1000000S"
