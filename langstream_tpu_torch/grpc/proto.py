"""The messages of ``agent.proto`` as plain Python classes, with their
protobuf wire codec, and the gRPC method table.

The port's answer to ``protoc`` and the protobuf runtime (neither is on
the card's machine): the 14 messages of ``agent.proto`` with the JAX
package's field names, numbers and types (``SCHEMA``), encoded and decoded
by proto3's rules, byte for byte what protobuf writes:

- fields in number order; a scalar only when it is not its default, a oneof
  member whenever it is the set one (``Datum.null_value = False`` is
  written), a sub-message whenever it is present, even empty;
- ``repeated int64`` packed (proto3's default), and read packed or not;
- int64 as the 64-bit two's complement varint (a negative value takes ten
  bytes);
- unknown fields skipped; a string that is not UTF-8 refused.

The classes offer what the client, server and codec call of protobuf's:
keyword constructors, ``SerializeToString``/``FromString``,
``CopyFrom``/``MergeFrom``, ``HasField``/``ClearField``,
``WhichOneof("kind")``, and repeated fields with ``append``, ``add`` and
``extend``. Presence follows protobuf's: reading a sub-message does not make
it present; setting any field inside it, ``CopyFrom`` (even of an empty
message) or a constructor argument does.
"""

from __future__ import annotations

import types
from pathlib import Path
from typing import Any, NamedTuple

PROTO_FILE = Path(__file__).parent / "agent.proto"

#: the service's wire name: ``/<SERVICE_NAME>/<method>`` (kept from the JAX
#: package's ``package langstream_tpu;`` so both lanes interoperate)
SERVICE_NAME = "langstream_tpu.ExternalAgent"

_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5
_MASK64 = (1 << 64) - 1
_DEFAULTS = {"bool": False, "int64": 0, "string": "", "bytes": b""}
_WIRE = {"bool": _VARINT, "int64": _VARINT, "string": _LEN, "bytes": _LEN, "message": _LEN}


class DecodeError(ValueError):
    """Bytes that are not a message of the expected type."""


class Field(NamedTuple):
    name: str
    number: int
    type: str            # bool, int64, string, bytes or message
    repeated: bool
    message: str | None  # the message type's name
    oneof: str | None


def _f(name, number, ftype, repeated=False, message=None, oneof=None) -> Field:
    return Field(name, number, ftype, repeated, message, oneof)


#: ``agent.proto``, message by message (the JAX fallback schema's entries)
SCHEMA: dict[str, tuple[Field, ...]] = {
    "Datum": (
        _f("null_value", 1, "bool", oneof="kind"),
        _f("bytes_value", 2, "bytes", oneof="kind"),
        _f("string_value", 3, "string", oneof="kind"),
        _f("json_value", 4, "string", oneof="kind"),
    ),
    "Header": (
        _f("name", 1, "string"),
        _f("value", 2, "message", message="Datum"),
    ),
    "WireRecord": (
        _f("record_id", 1, "int64"),
        _f("key", 2, "message", message="Datum"),
        _f("value", 3, "message", message="Datum"),
        _f("headers", 4, "message", True, "Header"),
        _f("origin", 5, "string"),
        _f("timestamp", 6, "int64"),
    ),
    "InfoRequest": (),
    "InfoResponse": (_f("info_json", 1, "string"),),
    "SourceRequest": (
        _f("committed_ids", 1, "int64", True),
        _f("failed_id", 2, "int64"),
        _f("failure_error", 3, "string"),
    ),
    "SourceResponse": (_f("records", 1, "message", True, "WireRecord"),),
    "ProcessRequest": (_f("records", 1, "message", True, "WireRecord"),),
    "ProcessResult": (
        _f("record_id", 1, "int64"),
        _f("records", 2, "message", True, "WireRecord"),
        _f("error", 3, "string"),
    ),
    "ProcessResponse": (_f("results", 1, "message", True, "ProcessResult"),),
    "SinkRequest": (_f("record", 1, "message", message="WireRecord"),),
    "SinkResponse": (
        _f("record_id", 1, "int64"),
        _f("error", 2, "string"),
    ),
    "TopicProducerRecord": (
        _f("record_id", 1, "int64"),
        _f("topic", 2, "string"),
        _f("record", 3, "message", message="WireRecord"),
    ),
    "TopicProducerAck": (
        _f("record_id", 1, "int64"),
        _f("error", 2, "string"),
    ),
}


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------


def write_varint(out: bytearray, value: int) -> None:
    value &= _MASK64
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def read_varint(data, pos: int, end: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end:
            raise DecodeError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _skip(data, pos: int, end: int, wire: int, number: int) -> int:
    """Past one unknown field's value."""
    if wire == _VARINT:
        return read_varint(data, pos, end)[1]
    if wire == _I64:
        pos += 8
    elif wire == _I32:
        pos += 4
    elif wire == _LEN:
        length, pos = read_varint(data, pos, end)
        pos += length
    elif wire == _SGROUP:
        while True:
            tag, pos = read_varint(data, pos, end)
            if tag & 7 == _EGROUP:
                if tag >> 3 != number:
                    raise DecodeError("mismatched end group")
                return pos
            pos = _skip(data, pos, end, tag & 7, tag >> 3)
    else:
        raise DecodeError(f"invalid wire type {wire}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


def _check_scalar(field: Field, value: Any, owner: str):
    kind = field.type
    if kind == "int64":
        if not isinstance(value, int):
            raise TypeError(f"{value!r} has type {type(value).__name__}, but expected one of: int")
        value = int(value)
        if not -(1 << 63) <= value < 1 << 63:
            raise ValueError(f"Value out of range: {value}")
        return value
    if kind == "bool":
        if not isinstance(value, int):
            raise TypeError(f"{value!r} has type {type(value).__name__}, but expected one of: bool")
        return bool(value)
    if kind == "string":
        if isinstance(value, bytes):
            return value.decode("utf-8")
        if not isinstance(value, str):
            raise TypeError(f"{value!r} has type {type(value).__name__}, but expected one of: "
                            "bytes, str")
        return value
    if isinstance(value, (bytearray, memoryview)):
        return bytes(value)
    if not isinstance(value, bytes):
        raise TypeError(f"expected bytes, {type(value).__name__} found")
    return value


# ---------------------------------------------------------------------------
# repeated fields
# ---------------------------------------------------------------------------


class RepeatedScalarContainer:
    """A repeated scalar field (``committed_ids``)."""

    __slots__ = ("_items", "_owner", "_field")

    def __init__(self, owner: "Message", field: Field):
        self._items: list = []
        self._owner = owner
        self._field = field

    def append(self, value) -> None:
        self._items.append(_check_scalar(self._field, value, type(self._owner).__name__))
        self._owner._touch()

    def extend(self, values) -> None:
        checked = [_check_scalar(self._field, v, type(self._owner).__name__) for v in values]
        self._items.extend(checked)
        self._owner._touch()

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, index):
        return self._items[index]

    def __eq__(self, other) -> bool:
        if isinstance(other, RepeatedScalarContainer):
            return self._items == other._items
        return self._items == list(other)

    def __repr__(self) -> str:
        return repr(self._items)


class RepeatedCompositeContainer:
    """A repeated message field (``records``, ``headers``, ``results``):
    ``add`` makes an element in place, ``append`` stores a copy, as
    protobuf does."""

    __slots__ = ("_items", "_owner", "_cls")

    def __init__(self, owner: "Message", cls: type):
        self._items: list = []
        self._owner = owner
        self._cls = cls

    def add(self, **kwargs) -> "Message":
        item = self._cls(**kwargs)
        item._parent = (self._owner, None)
        self._items.append(item)
        self._owner._touch()
        return item

    def append(self, message: "Message") -> None:
        if not isinstance(message, self._cls):
            raise TypeError(f"expected {self._cls.__name__}, got {type(message).__name__}")
        self.add().CopyFrom(message)

    def extend(self, messages) -> None:
        for message in messages:
            self.append(message)

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, index):
        return self._items[index]

    def __eq__(self, other) -> bool:
        if isinstance(other, RepeatedCompositeContainer):
            return self._items == other._items
        return self._items == list(other)

    def __repr__(self) -> str:
        return repr(self._items)


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------


class Message:
    """One message of ``SCHEMA``: its fields are properties built from
    ``FIELDS`` (see :func:`_build`)."""

    __slots__ = ("_values", "_has", "_case", "_parent")
    FIELDS: tuple[Field, ...] = ()
    ONEOFS: dict[str, tuple[str, ...]] = {}
    _BY_NAME: dict[str, Field] = {}
    _BY_NUMBER: dict[int, Field] = {}
    _CLASSES: dict[str, type] = {}

    def __init__(self, **kwargs):
        self._values: dict[str, Any] = {}
        self._has: set[str] = set()          # present sub-messages
        self._case: dict[str, str] = {}      # oneof -> its set member
        self._parent: tuple | None = None    # (owner, field name or None)
        for name, value in kwargs.items():
            field = self._BY_NAME.get(name)
            if field is None:
                raise ValueError(f'Protocol message {type(self).__name__} has no "{name}" field.')
            if value is None:
                continue
            if field.repeated:
                getattr(self, name).extend(value)
            elif field.type == "message":
                getattr(self, name).CopyFrom(value)
            else:
                setattr(self, name, value)

    # -- presence ------------------------------------------------------------

    def _touch(self) -> None:
        """This message changed: it is present in its owner, and so on up."""
        link = self._parent
        while link is not None:
            owner, name = link
            if name is not None:
                owner._has.add(name)
            link = owner._parent

    def HasField(self, name: str) -> bool:  # noqa: N802 (protobuf's names)
        if name in self.ONEOFS:
            return name in self._case
        field = self._BY_NAME.get(name)
        if field is None:
            raise ValueError(f'Protocol message {type(self).__name__} has no field {name}.')
        if field.oneof is not None:
            return self._case.get(field.oneof) == name
        if field.type == "message" and not field.repeated:
            return name in self._has
        raise ValueError(f'Can\'t test non-optional, non-submessage field "{name}" for presence.')

    def WhichOneof(self, oneof: str) -> str | None:  # noqa: N802
        if oneof not in self.ONEOFS:
            raise ValueError(f'Protocol message has no oneof "{oneof}" field.')
        return self._case.get(oneof)

    def ClearField(self, name: str) -> None:  # noqa: N802
        if name in self.ONEOFS:
            member = self._case.pop(name, None)
            if member is not None:
                self._values.pop(member, None)
            return
        field = self._BY_NAME[name]
        child = self._values.pop(name, None)
        if field.type == "message" and not field.repeated and child is not None:
            child._parent = None
        self._has.discard(name)
        if field.oneof is not None and self._case.get(field.oneof) == name:
            del self._case[field.oneof]

    def Clear(self) -> None:  # noqa: N802
        for field in self.FIELDS:
            self.ClearField(field.name)

    # -- copy and merge ------------------------------------------------------

    def MergeFrom(self, other: "Message") -> None:  # noqa: N802
        if type(other) is not type(self):
            raise TypeError(f"Parameter to MergeFrom() must be instance of same class: expected "
                            f"{type(self).__name__} got {type(other).__name__}.")
        for field in self.FIELDS:
            name = field.name
            if field.repeated:
                items = other._values.get(name)
                if items:
                    getattr(self, name).extend(items._items)
            elif field.type == "message":
                if name in other._has:
                    getattr(self, name).MergeFrom(other._values[name])
            elif field.oneof is not None:
                if other._case.get(field.oneof) == name:
                    setattr(self, name, other._values[name])
            elif name in other._values:
                setattr(self, name, other._values[name])
        self._touch()

    def CopyFrom(self, other: "Message") -> None:  # noqa: N802
        if other is self:
            return
        self.Clear()
        self.MergeFrom(other)

    # -- the wire ------------------------------------------------------------

    def _write(self, out: bytearray) -> None:
        for field in self.FIELDS:
            name = field.name
            if field.repeated:
                items = self._values.get(name)
                if not items:
                    continue
                if field.type == "message":
                    for item in items._items:
                        body = item.SerializeToString()
                        write_varint(out, field.number << 3 | _LEN)
                        write_varint(out, len(body))
                        out += body
                else:  # packed
                    packed = bytearray()
                    for value in items._items:
                        write_varint(packed, value)
                    write_varint(out, field.number << 3 | _LEN)
                    write_varint(out, len(packed))
                    out += packed
                continue
            if field.type == "message":
                if name not in self._has:
                    continue
                body = self._values[name].SerializeToString()
                write_varint(out, field.number << 3 | _LEN)
                write_varint(out, len(body))
                out += body
                continue
            if field.oneof is not None:
                if self._case.get(field.oneof) != name:
                    continue
                value = self._values[name]
            else:
                value = self._values.get(name)
                if value is None or value == _DEFAULTS[field.type]:
                    continue
            write_varint(out, field.number << 3 | _WIRE[field.type])
            if field.type in ("int64", "bool"):
                write_varint(out, int(value))
            else:
                raw = value.encode("utf-8") if field.type == "string" else value
                write_varint(out, len(raw))
                out += raw

    def SerializeToString(self, deterministic: bool | None = None) -> bytes:  # noqa: N802
        out = bytearray()
        self._write(out)
        return bytes(out)

    def _merge_bytes(self, data, pos: int, end: int) -> None:
        while pos < end:
            tag, pos = read_varint(data, pos, end)
            number, wire = tag >> 3, tag & 7
            if number == 0:
                raise DecodeError("field number 0")
            field = self._BY_NUMBER.get(number)
            if field is None or not (wire == _WIRE[field.type] or (
                    field.repeated and field.type == "int64" and wire == _LEN)):
                if wire == _EGROUP:
                    raise DecodeError("unexpected end group")
                pos = _skip(data, pos, end, wire, number)
                continue
            if wire == _VARINT:
                raw, pos = read_varint(data, pos, end)
                if field.type == "bool":
                    setattr(self, field.name, raw != 0)
                elif field.repeated:
                    getattr(self, field.name).append(_signed64(raw))
                else:
                    setattr(self, field.name, _signed64(raw))
                continue
            length, pos = read_varint(data, pos, end)
            stop = pos + length
            if stop > end:
                raise DecodeError("truncated length-delimited field")
            if field.type == "message":
                if field.repeated:
                    child = getattr(self, field.name).add()
                else:
                    child = getattr(self, field.name)
                    child._touch()
                child._merge_bytes(data, pos, stop)
            elif field.repeated:  # packed int64
                container = getattr(self, field.name)
                values = []
                while pos < stop:
                    raw, pos = read_varint(data, pos, stop)
                    values.append(_signed64(raw))
                container.extend(values)
            elif field.type == "string":
                try:
                    setattr(self, field.name, bytes(data[pos:stop]).decode("utf-8"))
                except UnicodeDecodeError as e:
                    raise DecodeError(f"{type(self).__name__}.{field.name}: not UTF-8: {e}")
            else:
                setattr(self, field.name, bytes(data[pos:stop]))
            pos = stop

    def MergeFromString(self, data: bytes) -> int:  # noqa: N802
        try:
            self._merge_bytes(data, 0, len(data))
        except DecodeError as e:
            raise DecodeError(f"Error parsing message with type "
                              f"'langstream_tpu.{type(self).__name__}': {e}") from None
        return len(data)

    @classmethod
    def FromString(cls, data: bytes) -> "Message":  # noqa: N802
        message = cls()
        message.MergeFromString(data)
        return message

    # -- value semantics -----------------------------------------------------

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return self.SerializeToString() == other.SerializeToString()

    __hash__ = None  # mutable, as protobuf's messages

    def __repr__(self) -> str:
        parts = []
        for field in self.FIELDS:
            name = field.name
            if field.repeated:
                items = self._values.get(name)
                if items:
                    parts.append(f"{name}={items!r}")
            elif field.type == "message":
                if name in self._has:
                    parts.append(f"{name}={self._values[name]!r}")
            elif field.oneof is not None:
                if self._case.get(field.oneof) == name:
                    parts.append(f"{name}={self._values[name]!r}")
            elif self._values.get(name, _DEFAULTS[field.type]) != _DEFAULTS[field.type]:
                parts.append(f"{name}={self._values[name]!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _property(field: Field) -> property:
    name = field.name
    if field.repeated:
        def get_repeated(self):
            items = self._values.get(name)
            if items is None:
                if field.type == "message":
                    items = RepeatedCompositeContainer(self, self._CLASSES[field.message])
                else:
                    items = RepeatedScalarContainer(self, field)
                self._values[name] = items
            return items

        def refuse(self, value):
            raise AttributeError(f'Assignment not allowed to repeated field "{name}" in '
                                 "protocol message object.")

        return property(get_repeated, refuse)
    if field.type == "message":
        def get_message(self):
            child = self._values.get(name)
            if child is None:
                child = self._CLASSES[field.message]()
                child._parent = (self, name)
                self._values[name] = child
            return child

        def refuse_message(self, value):
            raise AttributeError(f'Assignment not allowed to field "{name}" in protocol '
                                 "message object.")

        return property(get_message, refuse_message)
    default = _DEFAULTS[field.type]

    def get_scalar(self):
        return self._values.get(name, default)

    def set_scalar(self, value):
        value = _check_scalar(field, value, type(self).__name__)
        if field.oneof is not None:
            previous = self._case.get(field.oneof)
            if previous is not None and previous != name:
                self._values.pop(previous, None)
            self._case[field.oneof] = name
        self._values[name] = value
        self._touch()

    return property(get_scalar, set_scalar)


def _build() -> dict[str, type]:
    classes: dict[str, type] = {}
    for message_name, fields in SCHEMA.items():
        oneofs: dict[str, tuple[str, ...]] = {}
        for field in fields:
            if field.oneof is not None:
                oneofs[field.oneof] = oneofs.get(field.oneof, ()) + (field.name,)
        namespace = {
            "__slots__": (),
            "__module__": __name__,
            "__qualname__": message_name,
            "FIELDS": tuple(sorted(fields, key=lambda f: f.number)),
            "ONEOFS": oneofs,
            "_BY_NAME": {f.name: f for f in fields},
            "_BY_NUMBER": {f.number: f for f in fields},
            "_CLASSES": classes,
        }
        for field in fields:
            namespace[field.name] = _property(field)
        classes[message_name] = type(message_name, (Message,), namespace)
    return classes


_MESSAGES = types.SimpleNamespace(**_build())


def load_messages():
    """The 14 message classes, as the JAX ``load_messages()``'s module
    offers them (``pb2.Datum``, ``pb2.WireRecord``, ...)."""
    return _MESSAGES


def method_table(pb2) -> dict[str, dict]:
    """Every RPC of the ExternalAgent service: name → kind + message types.
    The single source both sides build handlers/stubs from."""
    return {
        "agent_info": {
            "kind": "unary_unary",
            "request": pb2.InfoRequest,
            "response": pb2.InfoResponse,
        },
        "read": {
            "kind": "stream_stream",
            "request": pb2.SourceRequest,
            "response": pb2.SourceResponse,
        },
        "process": {
            "kind": "stream_stream",
            "request": pb2.ProcessRequest,
            "response": pb2.ProcessResponse,
        },
        "write": {
            "kind": "stream_stream",
            "request": pb2.SinkRequest,
            "response": pb2.SinkResponse,
        },
        "topic_producer_records": {
            "kind": "stream_stream",
            "request": pb2.TopicProducerAck,
            "response": pb2.TopicProducerRecord,
        },
    }
