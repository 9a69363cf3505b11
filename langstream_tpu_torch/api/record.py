"""The record model: what flows on topics.

Parity: the reference's ``Record`` interface (key, value, headers, origin,
timestamp; ``langstream-api/.../runner/code/Record.java``) and the mutable
transform-context used by the GenAI transform steps
(``langstream-agents-commons/.../MutableRecord.java``).

Values are plain Python objects (str, bytes, dict/list for structured data).
Structured access uses dotted *accessors* — ``value.question``,
``key.id``, ``properties.session`` — matching the reference's field-addressing
convention used throughout agent configs (``completion-field: value.answer``).

The port's copy of ``langstream_tpu/api/record.py``; it imports only the port.
"""

from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping


def now_millis() -> int:
    return int(time.time() * 1000)


@dataclass(frozen=True)
class SimpleRecord:
    """An immutable record.

    ``headers`` is a tuple of (key, value) pairs — duplicate keys allowed,
    order preserved, hashable (so records can key dicts/sets in trackers).
    """

    value: Any = None
    key: Any = None
    headers: tuple[tuple[str, Any], ...] = ()
    origin: str | None = None
    timestamp: int | None = None

    def header(self, name: str, default: Any = None) -> Any:
        for k, v in self.headers:
            if k == name:
                return v
        return default

    def header_map(self) -> dict[str, Any]:
        return dict(self.headers)

    def with_headers(self, extra: Mapping[str, Any]) -> "SimpleRecord":
        merged = tuple((k, v) for k, v in self.headers if k not in extra) + tuple(
            extra.items()
        )
        return SimpleRecord(
            value=self.value,
            key=self.key,
            headers=merged,
            origin=self.origin,
            timestamp=self.timestamp,
        )

    def with_value(self, value: Any) -> "SimpleRecord":
        return SimpleRecord(
            value=value,
            key=self.key,
            headers=self.headers,
            origin=self.origin,
            timestamp=self.timestamp,
        )


# The canonical record type alias used across the framework.
Record = SimpleRecord


def make_record(
    value: Any = None,
    key: Any = None,
    headers: Iterable[tuple[str, Any]] | Mapping[str, Any] | None = None,
    origin: str | None = None,
    timestamp: int | None = None,
) -> Record:
    if headers is None:
        hdrs: tuple[tuple[str, Any], ...] = ()
    elif isinstance(headers, Mapping):
        hdrs = tuple(headers.items())
    else:
        hdrs = tuple(headers)
    return SimpleRecord(
        value=value,
        key=key,
        headers=hdrs,
        origin=origin,
        timestamp=timestamp if timestamp is not None else now_millis(),
    )


def _parse_structured(obj: Any) -> Any:
    """Best-effort view of a value as structured data (dict/list)."""
    if isinstance(obj, (dict, list)):
        return obj
    if isinstance(obj, (bytes, bytearray)):
        try:
            obj = obj.decode("utf-8")
        except UnicodeDecodeError:
            return obj
    if isinstance(obj, str):
        s = obj.strip()
        if s.startswith("{") or s.startswith("["):
            try:
                return json.loads(s)
            except json.JSONDecodeError:
                return obj
    return obj


@dataclass
class MutableRecord:
    """Mutable view of a record used by transform steps.

    Transform agents address fields with dotted accessors rooted at
    ``value``, ``key``, or ``properties`` (headers). The terminal
    ``to_record()`` re-freezes into a :class:`SimpleRecord`.

    Parity: ``MutableRecord`` transform context in the reference's
    agents-commons (``ai/agents/commons/MutableRecord.java``).
    """

    value: Any = None
    key: Any = None
    properties: dict[str, Any] = field(default_factory=dict)
    origin: str | None = None
    timestamp: int | None = None
    # When True the record is dropped from the pipeline (drop step).
    dropped: bool = False

    @classmethod
    def from_record(cls, record: Record) -> "MutableRecord":
        return cls(
            value=copy.deepcopy(_parse_structured(record.value)),
            key=copy.deepcopy(_parse_structured(record.key)),
            properties=record.header_map(),
            origin=record.origin,
            timestamp=record.timestamp,
        )

    def to_record(self) -> Record:
        return SimpleRecord(
            value=self.value,
            key=self.key,
            headers=tuple(self.properties.items()),
            origin=self.origin,
            timestamp=self.timestamp,
        )

    # ---- dotted-accessor field access ------------------------------------

    def _root(self, name: str) -> Any:
        if name == "value":
            return self.value
        if name == "key":
            return self.key
        if name == "properties":
            return self.properties
        if name == "origin":
            return self.origin
        if name == "timestamp":
            return self.timestamp
        raise KeyError(f"unknown accessor root: {name!r}")

    def get_field(self, accessor: str, default: Any = None) -> Any:
        """Resolve ``value.a.b`` / ``key.x`` / ``properties.h`` paths."""
        parts = accessor.split(".")
        try:
            cur = self._root(parts[0])
        except KeyError:
            return default
        for p in parts[1:]:
            if isinstance(cur, Mapping):
                if p not in cur:
                    return default
                cur = cur[p]
            elif isinstance(cur, list):
                try:
                    cur = cur[int(p)]
                except (ValueError, IndexError):
                    return default
            else:
                return default
        return cur

    def set_field(self, accessor: str, new_value: Any) -> None:
        """Set ``value`` / ``value.a.b`` / ``key.x`` / ``properties.h``.

        Setting a nested path under a scalar value promotes the value to a
        dict (matching the reference's behavior of writing, e.g.,
        ``completion-field: value.answer`` onto a JSON value).
        """
        parts = accessor.split(".")
        root = parts[0]
        if len(parts) == 1:
            if root == "value":
                self.value = new_value
            elif root == "key":
                self.key = new_value
            elif root == "destinationTopic":
                self.properties["langstream-destination-topic"] = new_value
            else:
                raise KeyError(f"cannot assign accessor root: {accessor!r}")
            return

        if root == "value":
            if not isinstance(self.value, dict):
                self.value = {}
            container: Any = self.value
        elif root == "key":
            if not isinstance(self.key, dict):
                self.key = {}
            container = self.key
        elif root == "properties":
            container = self.properties
        else:
            raise KeyError(f"cannot assign under root: {root!r}")

        for p in parts[1:-1]:
            nxt = container.get(p) if isinstance(container, Mapping) else None
            if not isinstance(nxt, dict):
                nxt = {}
                container[p] = nxt
            container = nxt
        container[parts[-1]] = new_value

    def remove_field(self, accessor: str) -> None:
        parts = accessor.split(".")
        if len(parts) == 1:
            # bare name means a top-level field of the value
            parts = ["value", parts[0]]
        try:
            cur = self._root(parts[0])
        except KeyError:
            return
        for p in parts[1:-1]:
            if isinstance(cur, Mapping) and p in cur:
                cur = cur[p]
            else:
                return
        if isinstance(cur, dict):
            cur.pop(parts[-1], None)
