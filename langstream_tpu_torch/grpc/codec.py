"""Record ↔ wire-message conversion for the external-agent protocol (the
port's copy of ``langstream_tpu/grpc/codec.py``)."""

from __future__ import annotations

import json
from typing import Any

from langstream_tpu_torch.api.record import Record, make_record
from langstream_tpu_torch.api.topics import OFFSET_HEADER


def datum_to_proto(pb2, value: Any):
    d = pb2.Datum()
    if value is None:
        d.null_value = True
    elif isinstance(value, bytes):
        d.bytes_value = value
    elif isinstance(value, str):
        d.string_value = value
    else:
        d.json_value = json.dumps(value)
    return d


def datum_from_proto(d) -> Any:
    kind = d.WhichOneof("kind")
    if kind is None or kind == "null_value":
        return None
    if kind == "bytes_value":
        return d.bytes_value
    if kind == "string_value":
        return d.string_value
    return json.loads(d.json_value)


def record_to_proto(pb2, record: Record, record_id: int):
    msg = pb2.WireRecord(
        record_id=record_id,
        origin=record.origin or "",
        timestamp=record.timestamp or 0,
    )
    msg.key.CopyFrom(datum_to_proto(pb2, record.key))
    msg.value.CopyFrom(datum_to_proto(pb2, record.value))
    for name, value in record.headers:
        if name == OFFSET_HEADER:
            continue  # transport-local, never crosses the process boundary
        header = msg.headers.add()
        header.name = name
        header.value.CopyFrom(datum_to_proto(pb2, value))
    return msg


def record_from_proto(msg) -> Record:
    return make_record(
        value=datum_from_proto(msg.value),
        key=datum_from_proto(msg.key),
        headers=[(h.name, datum_from_proto(h.value)) for h in msg.headers],
        origin=msg.origin or None,
        timestamp=msg.timestamp or None,
    )
