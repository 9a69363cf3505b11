"""Custom Python agents: user code in the application package.

Parity: the reference's ``python-source`` / ``python-processor`` /
``python-sink`` / ``python-service`` run user classes over a localhost gRPC
hop into a sidecar interpreter (``langstream-agent-grpc`` +
``langstream_grpc/grpc_service.py``). This framework *is* Python, so user
code loads **in-process** — same contract (``className`` config, class with
``read``/``process``/``write``), zero serialization overhead. The user class
is looked up on the application's ``python/`` directory (same layout the
reference mandates).

Both styles of user class are accepted:
- subclasses of our :class:`AgentSource`/:class:`AgentProcessor`/:class:`AgentSink`;
- reference-SDK-style duck-typed classes: ``process(record) -> list`` where
  returned items are ``(value, key, headers)`` tuples, dicts, or records.

The port's copy of ``langstream_tpu/agents/python_custom.py``; it imports only the port.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path
from typing import Any

from langstream_tpu_torch.api.agent import (
    AgentProcessor,
    AgentSink,
    AgentSource,
    RecordSink,
    SingleRecordProcessor,
)
from langstream_tpu_torch.api.record import Record, SimpleRecord, make_record


def _load_user_class(configuration: dict[str, Any]):
    class_name = configuration.get("className", "")
    if not class_name:
        raise ValueError("python agent requires 'className'")
    module_name, _, cls_name = class_name.rpartition(".")
    app_dir = configuration.get("__application_directory__")
    search_paths = []
    if app_dir:
        search_paths = [str(Path(app_dir) / "python"), str(Path(app_dir) / "python" / "lib")]
        for p in search_paths:
            if p not in sys.path and Path(p).is_dir():
                sys.path.insert(0, p)
    if not module_name:
        raise ValueError(f"className {class_name!r} must be 'module.Class'")
    module = importlib.import_module(module_name)
    importlib.reload(module)
    return getattr(module, cls_name)


def _coerce_result(item: Any, source: Record) -> Record:
    if isinstance(item, SimpleRecord):
        return item
    if isinstance(item, tuple):
        value = item[0] if len(item) > 0 else None
        key = item[1] if len(item) > 1 else None
        headers = item[2] if len(item) > 2 else None
        return make_record(value=value, key=key, headers=headers)
    if isinstance(item, dict) and ("value" in item or "key" in item or "headers" in item):
        return make_record(
            value=item.get("value"),
            key=item.get("key"),
            headers=item.get("headers"),
        )
    return source.with_value(item)


class PythonProcessorAgent(SingleRecordProcessor):
    """``python-processor`` (and legacy ``python-function``)."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        cls = _load_user_class(configuration)
        self.delegate = cls()
        if hasattr(self.delegate, "init"):
            result = self.delegate.init(configuration)
            if hasattr(result, "__await__"):
                await result

    async def setup(self, context) -> None:
        await super().setup(context)
        if isinstance(self.delegate, (AgentProcessor,)):
            await self.delegate.setup(context)

    async def process_record(self, record: Record) -> list[Record]:
        result = self.delegate.process(record)
        if hasattr(result, "__await__"):
            result = await result
        if result is None:
            return []
        if not isinstance(result, list):
            result = [result]
        return [_coerce_result(r, record) for r in result]

    def process(self, records: list[Record], sink: RecordSink) -> None:
        if isinstance(self.delegate, AgentProcessor):
            self.delegate.process(records, sink)
        else:
            super().process(records, sink)


class PythonSourceAgent(AgentSource):
    """``python-source``."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        cls = _load_user_class(configuration)
        self.delegate = cls()
        if hasattr(self.delegate, "init"):
            result = self.delegate.init(configuration)
            if hasattr(result, "__await__"):
                await result

    async def read(self) -> list[Record]:
        result = self.delegate.read()
        if hasattr(result, "__await__"):
            result = await result
        return [_coerce_result(r, make_record()) for r in (result or [])]

    async def commit(self, records: list[Record]) -> None:
        if hasattr(self.delegate, "commit"):
            result = self.delegate.commit(records)
            if hasattr(result, "__await__"):
                await result


class PythonServiceAgent:
    """``python-service``: long-running user service (parity:
    ``Service.main`` in the reference's Python SDK, ``api.py``)."""

    def __new__(cls):
        from langstream_tpu_torch.api.agent import AgentService

        class _Service(AgentService):
            async def init(self, configuration: dict[str, Any]) -> None:
                await super().init(configuration)
                user_cls = _load_user_class(configuration)
                self.delegate = user_cls()
                if hasattr(self.delegate, "init"):
                    result = self.delegate.init(configuration)
                    if hasattr(result, "__await__"):
                        await result

            async def run(self) -> None:
                entry = getattr(self.delegate, "main", None) or getattr(
                    self.delegate, "run"
                )
                result = entry()
                if hasattr(result, "__await__"):
                    await result

        return _Service()


class PythonSinkAgent(AgentSink):
    """``python-sink``."""

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        cls = _load_user_class(configuration)
        self.delegate = cls()
        if hasattr(self.delegate, "init"):
            result = self.delegate.init(configuration)
            if hasattr(result, "__await__"):
                await result

    async def write(self, record: Record) -> None:
        result = self.delegate.write(record)
        if hasattr(result, "__await__"):
            await result
