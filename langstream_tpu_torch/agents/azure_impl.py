"""Azure Blob Storage source over the Blob REST API (no SDK).

Parity: ``langstream-agent-azure-blob-storage-source/.../AzureBlobStorageSource.java``
(config keys ``endpoint``, ``container``, ``sas-token``,
``storage-account-name``, ``storage-account-key``,
``storage-account-connection-string``, ``idle-time``, ``file-extensions``;
list/read blobs, delete on commit, auto-create the container). The reference
builds an SDK ``BlobContainerClient``; here the two Azure auth schemes are
implemented directly: SharedKey request signing (HMAC-SHA256 over the
canonicalized request) and SAS token pass-through.

The port's copy of ``langstream_tpu/agents/azure_impl.py``: the async client
runs on the port's own client (:func:`langstream_tpu_torch.gateway.wire.open_response`)
instead of aiohttp. SharedKey signs the ``Content-Type`` exactly as that
client sends it: the one set here, or none on a request without one.
"""

from __future__ import annotations

import asyncio
import base64
import datetime
import hashlib
import hmac
import logging
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Any

from langstream_tpu_torch.api.agent import AgentSource
from langstream_tpu_torch.api.record import Record, make_record
from langstream_tpu_torch.agents.s3_impl import DEFAULT_EXTENSIONS
from langstream_tpu_torch.gateway import wire

log = logging.getLogger(__name__)

API_VERSION = "2021-08-06"


class AzureRequestError(RuntimeError):
    """Non-OK Blob-service response; carries the HTTP status so callers can
    treat 404s (blob raced away between list and get) as skippable."""

    def __init__(self, message: str, status: int):
        super().__init__(message)
        self.status = status


def parse_connection_string(conn: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in conn.split(";"):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def shared_key_headers(
    method: str,
    url: str,
    *,
    account: str,
    key_b64: str,
    payload: bytes = b"",
    content_type: str = "",
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """SharedKey authorization headers for one Blob-service request
    (`Authorization: SharedKey {account}:{sig}` over the canonicalized
    string-to-sign). Deterministic given ``now``."""
    parsed = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    ms_date = now.strftime("%a, %d %b %Y %H:%M:%S GMT")
    headers = {
        "x-ms-date": ms_date,
        "x-ms-version": API_VERSION,
    }
    if payload:
        headers["x-ms-blob-type"] = "BlockBlob"
    canonical_headers = "".join(
        f"{k}:{headers[k]}\n" for k in sorted(headers) if k.startswith("x-ms-")
    )
    # canonicalized resource: /{account}{path} + sorted query "k:v" lines
    resource = f"/{account}{parsed.path or '/'}"
    query = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    for name, value in sorted((k.lower(), v) for k, v in query):
        resource += f"\n{name}:{value}"
    content_length = str(len(payload)) if payload else ""
    string_to_sign = "\n".join(
        [method.upper(),
         "",               # Content-Encoding
         "",               # Content-Language
         content_length,   # Content-Length ("" when 0)
         "",               # Content-MD5
         content_type,     # Content-Type
         "",               # Date (x-ms-date is signed instead)
         "",               # If-Modified-Since
         "",               # If-Match
         "",               # If-None-Match
         "",               # If-Unmodified-Since
         "",               # Range
         canonical_headers + resource]
    )
    signature = base64.b64encode(
        hmac.new(
            base64.b64decode(key_b64), string_to_sign.encode(), hashlib.sha256
        ).digest()
    ).decode()
    headers["Authorization"] = f"SharedKey {account}:{signature}"
    return headers


def _parse_blob_list(body: bytes) -> tuple[list[str], str]:
    """List-blobs XML → (names, next-marker; '' = last page)."""
    root = ET.fromstring(body)
    names = [
        name.text or ""
        for blobs in root.iter("Blobs")
        for name in blobs.iter("Name")
        if name.text
    ]
    return names, (root.findtext("NextMarker") or "")


class AsyncAzureBlobClient:
    """The Blob-service slice the source needs: container create/head, list
    blobs, get/put/delete blob."""

    def __init__(
        self,
        endpoint: str,
        container: str,
        *,
        account: str | None = None,
        account_key: str | None = None,
        sas_token: str | None = None,
    ):
        self.endpoint = endpoint.rstrip("/")
        self.container = container
        self.sas = (sas_token or "").lstrip("?")
        self.account_key = account_key
        parsed = urllib.parse.urlsplit(self.endpoint)
        if account:
            self.account = account
        elif parsed.path.strip("/"):
            # Azurite-style http://host:port/{account}
            self.account = parsed.path.strip("/").split("/")[0]
        else:
            # {account}.blob.core.windows.net
            self.account = parsed.netloc.split(".")[0].split(":")[0]

    def _url(self, path: str, query: str = "") -> str:
        qs = [q for q in (query, self.sas) if q]
        return f"{self.endpoint}{path}" + ("?" + "&".join(qs) if qs else "")

    def _headers(self, method: str, url: str, payload: bytes) -> dict[str, str]:
        """Auth + content headers for one request — the single place the
        signing decisions live (the sync client reuses it verbatim).

        The Content-Type that goes on the wire must be the one that gets
        signed: the client adds 'application/octet-stream' on its own to a
        bytes body, as aiohttp does, so it is set explicitly (body-less PUTs
        and POSTs too) and signed exactly as sent."""
        content_type = (
            "application/octet-stream"
            if payload or method in ("PUT", "POST")
            else ""
        )
        if self.account_key:
            headers = shared_key_headers(
                method, url, account=self.account, key_b64=self.account_key,
                payload=payload, content_type=content_type,
            )
        else:
            headers = {"x-ms-version": API_VERSION}
            if payload:
                headers["x-ms-blob-type"] = "BlockBlob"
        if content_type:
            headers["Content-Type"] = content_type
        return headers

    async def _request(
        self, method: str, path: str, query: str = "", *, payload: bytes = b"",
        ok: tuple[int, ...] = (200, 201, 202),
    ) -> tuple[int, bytes]:
        url = self._url(path, query)
        headers = self._headers(method, url, payload)
        async with await wire.open_response(
            method, url, data=payload or None, headers=headers
        ) as resp:
            body = await resp.read()
            if resp.status not in ok:
                raise AzureRequestError(
                    f"azure-blob {method} {path}: {resp.status} {body[:300]!r}",
                    resp.status,
                )
            return resp.status, body

    async def container_exists(self) -> bool:
        status, _ = await self._request(
            "HEAD", f"/{self.container}", "restype=container", ok=(200, 404)
        )
        return status == 200

    async def create_container(self) -> None:
        await self._request(
            "PUT", f"/{self.container}", "restype=container", ok=(200, 201)
        )

    async def list_blobs(self) -> list[str]:
        out: list[str] = []
        marker = ""
        while True:
            query = "restype=container&comp=list"
            if marker:
                query += "&marker=" + urllib.parse.quote(marker, safe="")
            _, body = await self._request(
                "GET", f"/{self.container}", query, ok=(200,)
            )
            names, marker = _parse_blob_list(body)
            out.extend(names)
            if not marker:
                return out

    async def get_blob(self, name: str) -> bytes:
        _, body = await self._request(
            "GET", f"/{self.container}/{urllib.parse.quote(name)}", ok=(200,)
        )
        return body

    async def put_blob(self, name: str, data: bytes) -> None:
        await self._request(
            "PUT", f"/{self.container}/{urllib.parse.quote(name)}",
            payload=data, ok=(200, 201),
        )

    async def delete_blob(self, name: str) -> None:
        await self._request(
            "DELETE", f"/{self.container}/{urllib.parse.quote(name)}",
            ok=(200, 202, 204),
        )


class SyncAzureBlobClient:
    """Blocking twin of :class:`AsyncAzureBlobClient` (urllib) for code
    storage — deployer Jobs and init containers are synchronous."""

    def __init__(self, endpoint: str, container: str, *,
                 account: str | None = None, account_key: str | None = None,
                 sas_token: str | None = None):
        self._impl = AsyncAzureBlobClient(
            endpoint, container, account=account, account_key=account_key,
            sas_token=sas_token,
        )

    @property
    def container(self) -> str:
        return self._impl.container

    def _request(self, method: str, path: str, query: str = "", *,
                 payload: bytes = b"",
                 ok: tuple[int, ...] = (200, 201, 202)) -> tuple[int, bytes]:
        import urllib.error
        import urllib.request

        impl = self._impl
        url = impl._url(path, query)
        headers = impl._headers(method, url, payload)
        req = urllib.request.Request(
            url, data=payload or None, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(req) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        if status not in ok:
            raise AzureRequestError(
                f"azure-blob {method} {path}: {status} {body[:300]!r}", status
            )
        return status, body

    def container_exists(self) -> bool:
        status, _ = self._request(
            "HEAD", f"/{self.container}", "restype=container", ok=(200, 404)
        )
        return status == 200

    def create_container(self) -> None:
        self._request(
            "PUT", f"/{self.container}", "restype=container", ok=(200, 201)
        )

    def get_blob(self, name: str) -> bytes:
        return self._request(
            "GET", f"/{self.container}/{urllib.parse.quote(name)}", ok=(200,)
        )[1]

    def put_blob(self, name: str, data: bytes) -> None:
        self._request(
            "PUT", f"/{self.container}/{urllib.parse.quote(name)}",
            payload=data, ok=(200, 201),
        )

    def delete_blob(self, name: str) -> None:
        self._request(
            "DELETE", f"/{self.container}/{urllib.parse.quote(name)}",
            ok=(200, 202, 204),
        )


class AzureBlobSource(AgentSource):
    """``azure-blob-storage-source``: one record per blob; delete on commit.

    Auth resolution mirrors the reference (``AzureBlobStorageSource.java:69-85``):
    ``sas-token`` first, then ``storage-account-name``/``storage-account-key``,
    then ``storage-account-connection-string``; anything else is an error.
    """

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        endpoint = configuration.get("endpoint")
        if not endpoint:
            raise ValueError("azure-blob-storage-source requires 'endpoint'")
        container = str(configuration.get("container", "langstream-azure-source"))
        sas = configuration.get("sas-token")
        name = configuration.get("storage-account-name")
        key = configuration.get("storage-account-key")
        conn = configuration.get("storage-account-connection-string")
        if sas:
            self.client = AsyncAzureBlobClient(endpoint, container, sas_token=sas)
        elif name and key:
            self.client = AsyncAzureBlobClient(
                endpoint, container, account=name, account_key=key
            )
        elif conn:
            parts = parse_connection_string(str(conn))
            self.client = AsyncAzureBlobClient(
                endpoint, container,
                account=parts.get("AccountName"),
                account_key=parts.get("AccountKey"),
            )
        else:
            raise ValueError(
                "either sas-token, storage-account-name/storage-account-key or "
                "storage-account-connection-string must be provided"
            )
        self.idle_time = float(configuration.get("idle-time", 5))
        raw = str(configuration.get("file-extensions", DEFAULT_EXTENSIONS))
        self.extensions = {e.strip() for e in raw.split(",") if e.strip()}
        self._pending: set[str] = set()
        self._listing: list[str] = []

    async def start(self) -> None:
        if not await self.client.container_exists():
            log.info("creating missing container %s", self.client.container)
            await self.client.create_container()

    def _matches(self, name: str) -> bool:
        if "*" in self.extensions:
            return True
        ext = name.rsplit(".", 1)[-1].lower() if "." in name else ""
        return ext in self.extensions

    async def read(self) -> list[Record]:
        """One blob per read (memory bounded by the largest blob); the
        listing is cached between reads and refreshed when drained."""
        if not self._listing:
            self._listing = [
                n
                for n in await self.client.list_blobs()
                if n not in self._pending and self._matches(n)
            ]
        while self._listing:
            name = self._listing.pop(0)
            if name in self._pending:
                continue
            try:
                data = await self.client.get_blob(name)
            except AzureRequestError as e:
                if e.status == 404:
                    log.info("blob %s vanished before read; skipping", name)
                    continue
                raise
            self._pending.add(name)
            return [
                make_record(
                    value=data,
                    key=name,
                    headers={"name": name, "container": self.client.container},
                )
            ]
        await asyncio.sleep(self.idle_time)
        return []

    async def commit(self, records: list[Record]) -> None:
        for record in records:
            name = record.header("name")
            if name:
                await self.client.delete_blob(name)
                self._pending.discard(name)
