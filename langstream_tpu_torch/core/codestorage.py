"""Code storage: where application code archives live (the port's copy of
``langstream_tpu/core/codestorage.py``).

Parity: ``CodeStorage`` SPI (``langstream-api/.../codestorage/``) with
``LocalDiskCodeStorage`` (``langstream-core/.../impl/codestorage/``) and the
provider module (``langstream-codestorage-providers``: S3 via MinIO client,
Azure blobs). The control plane uploads the zipped app directory on deploy;
agent pods' init container downloads it before the runtime starts.

First-party stores: the local filesystem (shared volume / PV in-cluster),
S3-compatible object storage (SigV4 REST via the port's
:class:`langstream_tpu_torch.serving.s3.SyncS3Client` — no SDK needed), and
Azure Blob (SharedKey REST via :mod:`langstream_tpu_torch.agents.azure_impl`).
"""

from __future__ import annotations

import abc
import hashlib
import io
import shutil
import zipfile
from pathlib import Path
from typing import Any


class CodeStorage(abc.ABC):
    @abc.abstractmethod
    def store(self, tenant: str, application_id: str, archive: bytes) -> str:
        """Store a zip archive; returns the code-archive id."""

    @abc.abstractmethod
    def download(self, tenant: str, code_archive_id: str) -> bytes: ...

    @abc.abstractmethod
    def delete(self, tenant: str, code_archive_id: str) -> None: ...

    def close(self) -> None: ...


class LocalDiskCodeStorage(CodeStorage):
    def __init__(self, root: Path | str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, tenant: str, code_archive_id: str) -> Path:
        for part in (tenant, code_archive_id):
            if "/" in part or "\\" in part or ".." in part or not part:
                raise ValueError(f"illegal path component {part!r}")
        return self.root / tenant / f"{code_archive_id}.zip"

    def store(self, tenant: str, application_id: str, archive: bytes) -> str:
        digest = hashlib.sha256(archive).hexdigest()[:24]
        code_archive_id = f"{application_id}-{digest}"
        path = self._path(tenant, code_archive_id)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(archive)
        return code_archive_id

    def download(self, tenant: str, code_archive_id: str) -> bytes:
        return self._path(tenant, code_archive_id).read_bytes()

    def delete(self, tenant: str, code_archive_id: str) -> None:
        self._path(tenant, code_archive_id).unlink(missing_ok=True)


class S3CodeStorage(CodeStorage):
    """S3/MinIO-backed archives (parity: ``S3CodeStorage.java:51,84``) over
    the in-tree SigV4 REST client — works against AWS S3 and MinIO alike.

    No network I/O at construction: read-only consumers (the code-download
    init container) may hold credentials that can't HEAD/create the bucket;
    the bucket is ensured lazily on the first ``store``.
    """

    def __init__(self, configuration: dict[str, Any]):
        from langstream_tpu_torch.serving.s3 import SyncS3Client

        self.bucket = configuration.get("bucket-name", "langstream-code-storage")
        region = configuration.get("region", "") or "us-east-1"
        # no endpoint configured = real AWS S3 for that region (the behavior
        # the boto3-based predecessor had); MinIO et al. set it explicitly
        endpoint = (
            configuration.get("endpoint")
            or f"https://s3.{region}.amazonaws.com"
        )
        self.client = SyncS3Client(
            endpoint=endpoint,
            access_key=configuration.get("access-key", ""),
            secret_key=configuration.get("secret-key", ""),
            region=region,
        )
        self._bucket_ready = False

    def _key(self, tenant: str, code_archive_id: str) -> str:
        return f"{tenant}/{code_archive_id}.zip"

    def store(self, tenant: str, application_id: str, archive: bytes) -> str:
        if not self._bucket_ready:
            if not self.client.bucket_exists(self.bucket):
                self.client.create_bucket(self.bucket)
            self._bucket_ready = True
        digest = hashlib.sha256(archive).hexdigest()[:24]
        code_archive_id = f"{application_id}-{digest}"
        self.client.put_object(
            self.bucket, self._key(tenant, code_archive_id), archive
        )
        return code_archive_id

    def download(self, tenant: str, code_archive_id: str) -> bytes:
        return self.client.get_object(
            self.bucket, self._key(tenant, code_archive_id)
        )

    def delete(self, tenant: str, code_archive_id: str) -> None:
        self.client.delete_object(
            self.bucket, self._key(tenant, code_archive_id)
        )


class AzureBlobCodeStorage(CodeStorage):
    """Azure-Blob-backed archives (parity:
    ``AzureBlobCodeStorage.java`` in ``langstream-codestorage-providers``)
    over the in-tree SharedKey REST client. Same lazy-container policy as
    :class:`S3CodeStorage`."""

    def __init__(self, configuration: dict[str, Any]):
        from langstream_tpu_torch.agents.azure_impl import (
            SyncAzureBlobClient,
            parse_connection_string,
        )

        endpoint = configuration.get("endpoint")
        if not endpoint:
            raise ValueError("azure code storage requires 'endpoint'")
        container = configuration.get("container", "langstream-code-storage")
        conn = configuration.get("storage-account-connection-string")
        account = configuration.get("storage-account-name")
        key = configuration.get("storage-account-key")
        sas = configuration.get("sas-token")
        if conn and not (account and key):
            parts = parse_connection_string(str(conn))
            account = parts.get("AccountName")
            key = parts.get("AccountKey")
        if not sas and not (account and key):
            # fail at config time, not at the first 401 in a deployer Job
            raise ValueError(
                "azure code storage needs sas-token, storage-account-name/"
                "storage-account-key, or a connection string carrying "
                "AccountName+AccountKey"
            )
        self.client = SyncAzureBlobClient(
            endpoint, container,
            account=account, account_key=key,
            sas_token=sas,
        )
        self._container_ready = False

    def _name(self, tenant: str, code_archive_id: str) -> str:
        return f"{tenant}/{code_archive_id}.zip"

    def store(self, tenant: str, application_id: str, archive: bytes) -> str:
        if not self._container_ready:
            if not self.client.container_exists():
                self.client.create_container()
            self._container_ready = True
        digest = hashlib.sha256(archive).hexdigest()[:24]
        code_archive_id = f"{application_id}-{digest}"
        self.client.put_blob(self._name(tenant, code_archive_id), archive)
        return code_archive_id

    def download(self, tenant: str, code_archive_id: str) -> bytes:
        return self.client.get_blob(self._name(tenant, code_archive_id))

    def delete(self, tenant: str, code_archive_id: str) -> None:
        self.client.delete_blob(self._name(tenant, code_archive_id))


def make_code_storage(configuration: dict[str, Any] | None) -> CodeStorage:
    """Factory keyed by ``type`` (parity: CodeStorageRegistry)."""
    configuration = configuration or {}
    storage_type = configuration.get("type", "local")
    if storage_type in ("local", "none"):
        return LocalDiskCodeStorage(
            configuration.get("path", "/tmp/langstream-code-storage")
        )
    if storage_type == "s3":
        return S3CodeStorage(configuration.get("configuration", configuration))
    if storage_type in ("azure", "azure-blob-storage"):
        return AzureBlobCodeStorage(
            configuration.get("configuration", configuration)
        )
    raise ValueError(f"unknown code storage type {storage_type!r}")


# ---- archive helpers ------------------------------------------------------


def zip_directory(directory: Path | str) -> bytes:
    """Zip an application directory (what the CLI/control plane upload)."""
    directory = Path(directory)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for path in sorted(directory.rglob("*")):
            if path.is_file():
                zf.write(path, path.relative_to(directory).as_posix())
    return buf.getvalue()


def unzip_to(archive: bytes, destination: Path | str) -> None:
    destination = Path(destination)
    destination.mkdir(parents=True, exist_ok=True)
    root = destination.resolve()
    with zipfile.ZipFile(io.BytesIO(archive)) as zf:
        for member in zf.namelist():
            # zip-slip guard: the resolved target must live under root
            # (Path.is_relative_to, not a string prefix — '/work/app2' must
            # not pass for root '/work/app')
            target = (destination / member).resolve()
            if not target.is_relative_to(root):
                raise ValueError(f"illegal archive member path {member!r}")
        zf.extractall(destination)


def clear_directory(directory: Path | str) -> None:
    directory = Path(directory)
    if directory.is_dir():
        for child in directory.iterdir():
            if child.is_dir():
                shutil.rmtree(child)
            else:
                child.unlink()
