"""Object-storage sources + the local-directory source.

Parity: ``langstream-agent-s3`` (``agents/s3/S3Source.java`` — list/read,
delete-on-commit, idle polling) and
``langstream-agent-azure-blob-storage-source``. Both are first-party here:
:mod:`langstream_tpu_torch.agents.s3_impl` speaks SigV4-signed S3 REST and
:mod:`langstream_tpu_torch.agents.azure_impl` speaks SharedKey/SAS Blob REST, so
neither needs an SDK. ``local-storage-source`` (same list/read/
delete-on-commit contract against a directory) remains the dev-mode
equivalent, used the way the reference's tests use MinIO testcontainers.

The port's copy of ``langstream_tpu/agents/storage.py``.
"""

from __future__ import annotations

import asyncio
from pathlib import Path
from typing import Any

from langstream_tpu_torch.api.agent import AgentSource
from langstream_tpu_torch.api.record import Record, make_record


class LocalStorageSource(AgentSource):
    """``local-storage-source``: emits one record per file in a directory.

    Config: ``path``, ``extensions`` (filter), ``delete-on-commit`` (default
    true), ``idle-time`` (seconds between polls).
    """

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.path = Path(configuration["path"])
        self.extensions = set(configuration.get("extensions", []))
        self.delete_on_commit = bool(configuration.get("delete-on-commit", True))
        self.idle_time = float(configuration.get("idle-time", 1.0))
        self._emitted: set[str] = set()

    async def read(self) -> list[Record]:
        if not self.path.is_dir():
            await asyncio.sleep(self.idle_time)
            return []
        out: list[Record] = []
        for file in sorted(self.path.iterdir()):
            if not file.is_file():
                continue
            if self.extensions and file.suffix.lstrip(".") not in self.extensions:
                continue
            if str(file) in self._emitted:
                continue
            data = file.read_bytes()
            try:
                value: Any = data.decode("utf-8")
            except UnicodeDecodeError:
                value = data
            out.append(
                make_record(
                    value=value,
                    key=file.name,
                    headers={"name": file.name, "path": str(file)},
                )
            )
            self._emitted.add(str(file))
        if not out:
            await asyncio.sleep(self.idle_time)
        return out

    async def commit(self, records: list[Record]) -> None:
        if not self.delete_on_commit:
            return
        for record in records:
            path = record.header("path")
            if path:
                Path(path).unlink(missing_ok=True)
                self._emitted.discard(path)


def make_s3_source() -> AgentSource:
    from langstream_tpu_torch.agents.s3_impl import S3Source

    return S3Source()


def make_azure_source() -> AgentSource:
    from langstream_tpu_torch.agents.azure_impl import AzureBlobSource

    return AzureBlobSource()
