"""Structured-record transform steps.

Parity: the GenAI-toolkit transform steps
(``langstream-ai-agents/.../com/datastax/oss/streaming/ai/*.java``): ``cast``,
``compute``, ``drop``, ``drop-fields``, ``flatten``, ``merge-key-value``,
``unwrap-key-value``, plus the shared ``when:`` guard every step honors. All
operate on the :class:`~langstream_tpu_torch.api.record.MutableRecord` view with the
expression language from ``langstream_tpu_torch.core.expressions``.

The port's copy of ``langstream_tpu/agents/transform.py``; it imports only the port.
"""

from __future__ import annotations

from typing import Any

from langstream_tpu_torch.api.agent import SingleRecordProcessor
from langstream_tpu_torch.api.record import MutableRecord, Record
from langstream_tpu_torch.core.expressions import evaluate, evaluate_accessor


class TransformStep(SingleRecordProcessor):
    """Base: when-guard + mutable-record plumbing."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.when = configuration.get("when")

    async def process_record(self, record: Record) -> list[Record]:
        mutable = MutableRecord.from_record(record)
        if self.when and not evaluate(self.when, mutable):
            return [record]
        result = await self.apply(mutable)
        if isinstance(result, list):
            return [m.to_record() for m in result if not m.dropped]
        return [] if mutable.dropped else [mutable.to_record()]

    async def apply(self, record: MutableRecord) -> Any:
        raise NotImplementedError


class CastStep(TransformStep):
    """``cast``: coerce value (or key) to a target schema type."""

    _CASTS = {
        "string": lambda v: v if isinstance(v, str) else ("" if v is None else str(v)),
        "int8": int, "int16": int, "int32": int, "int64": int,
        "float": float, "double": float,
        "boolean": lambda v: bool(v) if not isinstance(v, str) else v.lower() == "true",
        "bytes": lambda v: v if isinstance(v, bytes) else str(v).encode(),
    }

    async def apply(self, record: MutableRecord) -> None:
        schema_type = self.configuration.get("schema-type", "string")
        part = self.configuration.get("part", "value")
        caster = self._CASTS.get(schema_type)
        if caster is None:
            raise ValueError(f"cast: unknown schema-type {schema_type!r}")
        if part == "key":
            record.key = caster(record.key)
        else:
            import json

            v = record.value
            if schema_type == "string" and isinstance(v, (dict, list)):
                record.value = json.dumps(v)
            else:
                record.value = caster(v)


class ComputeStep(TransformStep):
    """``compute``: assign expression results to fields."""

    async def apply(self, record: MutableRecord) -> None:
        for f in self.configuration.get("fields", []):
            name = f["name"]
            value = evaluate(str(f["expression"]), record)
            ftype = f.get("type")
            if ftype and value is not None:
                value = CastStep._CASTS.get(ftype, lambda v: v)(value)
            record.set_field(name, value)


class DropStep(TransformStep):
    """``drop``: drop the record (its ``when:`` decides which)."""

    async def apply(self, record: MutableRecord) -> None:
        record.dropped = True


class DropFieldsStep(TransformStep):
    """``drop-fields``: remove fields from value (or key)."""

    async def apply(self, record: MutableRecord) -> None:
        part = self.configuration.get("part")
        for name in self.configuration.get("fields", []):
            if "." in name or part is None:
                record.remove_field(name)
            else:
                record.remove_field(f"{part}.{name}")


def _flatten(obj: Any, prefix: str, delimiter: str, out: dict[str, Any]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = f"{prefix}{delimiter}{k}" if prefix else str(k)
            if isinstance(v, dict):
                _flatten(v, key, delimiter, out)
            else:
                out[key] = v
    else:
        out[prefix] = obj


class FlattenStep(TransformStep):
    """``flatten``: flatten nested structures with a delimiter."""

    async def apply(self, record: MutableRecord) -> None:
        delimiter = self.configuration.get("delimiter", "_")
        part = self.configuration.get("part", "value")
        target = record.value if part == "value" else record.key
        if isinstance(target, dict):
            out: dict[str, Any] = {}
            _flatten(target, "", delimiter, out)
            if part == "value":
                record.value = out
            else:
                record.key = out


class MergeKeyValueStep(TransformStep):
    """``merge-key-value``: merge the key's fields into the value."""

    async def apply(self, record: MutableRecord) -> None:
        if isinstance(record.key, dict) and isinstance(record.value, dict):
            record.value = {**record.key, **record.value}


class UnwrapKeyValueStep(TransformStep):
    """``unwrap-key-value``: replace the record with its value (or key)."""

    async def apply(self, record: MutableRecord) -> None:
        if self.configuration.get("unwrapKey", False):
            record.value = record.key
        record.key = None
