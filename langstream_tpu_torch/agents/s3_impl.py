"""S3 object-storage source + dependency-free S3 REST client.

Parity: ``langstream-agent-s3/src/main/java/ai/langstream/agents/s3/S3Source.java``
(config keys ``bucketName``, ``endpoint``, ``access-key``, ``secret-key``,
``region``, ``idle-time``, ``file-extensions``; list/read objects, delete on
commit, auto-create the bucket). The reference uses the MinIO SDK; no S3 SDK
is baked into this image, so this module implements the small slice of the
S3 REST surface the source needs (list-objects-v2, get/put/delete object,
bucket create/head) directly over HTTP.

The port's copy of ``langstream_tpu/agents/s3_impl.py``: the async client
runs on the port's own client (:func:`langstream_tpu_torch.gateway.wire.open_response`)
instead of aiohttp, and AWS Signature V4, ``S3RequestError`` and the
blocking client that code storage uses are the port's
:mod:`langstream_tpu_torch.serving.s3`. The ``host`` that SigV4 signs is
sent as the request's ``Host`` header, so what is signed is what is sent.
"""

from __future__ import annotations

import asyncio
import logging
import urllib.parse
from typing import Any

from langstream_tpu_torch.api.agent import AgentSource
from langstream_tpu_torch.api.record import Record, make_record
from langstream_tpu_torch.gateway import wire
from langstream_tpu_torch.serving.s3 import S3RequestError, _parse_list_objects, sigv4_headers

log = logging.getLogger(__name__)


class AsyncS3Client:
    """The async S3 surface the source agent needs, over the port's client."""

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1"):
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region or "us-east-1"

    async def _request(
        self, method: str, path: str, *, payload: bytes = b"",
        ok: tuple[int, ...] = (200, 204),
    ):
        url = f"{self.endpoint}{path}"
        headers = sigv4_headers(
            method, url, access_key=self.access_key, secret_key=self.secret_key,
            region=self.region, payload=payload,
        )
        async with await wire.open_response(
            method, url, data=payload or None, headers=headers
        ) as resp:
            body = await resp.read()
            if resp.status not in ok:
                raise S3RequestError(
                    f"s3 {method} {path}: {resp.status} {body[:300]!r}",
                    resp.status,
                )
            return resp.status, body

    async def bucket_exists(self, bucket: str) -> bool:
        status, _ = await self._request("HEAD", f"/{bucket}", ok=(200, 404))
        return status == 200

    async def create_bucket(self, bucket: str) -> None:
        await self._request("PUT", f"/{bucket}", ok=(200,))

    async def list_objects(self, bucket: str) -> list[dict[str, Any]]:
        out: list[dict[str, Any]] = []
        token: str | None = None
        while True:
            qs = "?list-type=2"
            if token:
                qs += "&continuation-token=" + urllib.parse.quote(token, safe="")
            _, body = await self._request("GET", f"/{bucket}{qs}", ok=(200,))
            objects, token = _parse_list_objects(body)
            out.extend(objects)
            if not token:
                return out

    async def get_object(self, bucket: str, key: str) -> bytes:
        _, body = await self._request(
            "GET", f"/{bucket}/{urllib.parse.quote(key)}", ok=(200,)
        )
        return body

    async def put_object(self, bucket: str, key: str, data: bytes) -> None:
        await self._request(
            "PUT", f"/{bucket}/{urllib.parse.quote(key)}", payload=data,
            ok=(200, 201),
        )

    async def delete_object(self, bucket: str, key: str) -> None:
        await self._request(
            "DELETE", f"/{bucket}/{urllib.parse.quote(key)}", ok=(200, 204)
        )


DEFAULT_EXTENSIONS = "pdf,docx,html,htm,md,txt"


class S3Source(AgentSource):
    """``s3-source``: emit one record per object in a bucket; delete on
    commit (at-least-once: an object re-emits after a crash until committed).

    Reference config keys (``S3Source.java:64-80``): ``bucketName``,
    ``endpoint``, ``access-key``, ``secret-key``, ``region``, ``idle-time``,
    ``file-extensions`` (comma list, ``*`` = everything).
    """

    async def init(self, configuration: dict[str, Any]) -> None:
        await super().init(configuration)
        self.bucket = str(configuration.get("bucketName", "langstream-source"))
        self.client = AsyncS3Client(
            endpoint=str(configuration.get("endpoint", "http://localhost:9000")),
            access_key=str(configuration.get("access-key", "minioadmin")),
            secret_key=str(configuration.get("secret-key", "minioadmin")),
            region=str(configuration.get("region", "") or "us-east-1"),
        )
        self.idle_time = float(configuration.get("idle-time", 5))
        raw = str(configuration.get("file-extensions", DEFAULT_EXTENSIONS))
        self.extensions = {e.strip() for e in raw.split(",") if e.strip()}
        self._pending: set[str] = set()
        self._listing: list[str] = []  # keys discovered but not yet fetched

    async def start(self) -> None:
        if not await self.client.bucket_exists(self.bucket):
            log.info("creating missing s3 bucket %s", self.bucket)
            await self.client.create_bucket(self.bucket)

    def _matches(self, key: str) -> bool:
        if "*" in self.extensions:
            return True
        ext = key.rsplit(".", 1)[-1].lower() if "." in key else ""
        return ext in self.extensions

    async def read(self) -> list[Record]:
        """One object per read (the reference's cadence,
        ``S3Source.java:read``): memory stays bounded by the largest object,
        not the bucket. The listing is cached between reads and refreshed
        only when drained."""
        if not self._listing:
            self._listing = [
                o["key"]
                for o in await self.client.list_objects(self.bucket)
                if o["key"] not in self._pending and self._matches(o["key"])
            ]
        while self._listing:
            key = self._listing.pop(0)
            if key in self._pending:
                continue
            try:
                data = await self.client.get_object(self.bucket, key)
            except S3RequestError as e:
                if e.status == 404:
                    # deleted between list and get (another replica committed
                    # it, or an external actor) — stale listing entry, skip
                    log.info("object %s vanished before read; skipping", key)
                    continue
                raise
            self._pending.add(key)
            return [
                make_record(
                    value=data,
                    key=key,
                    headers={"name": key, "bucket": self.bucket},
                )
            ]
        await asyncio.sleep(self.idle_time)
        return []

    async def commit(self, records: list[Record]) -> None:
        for record in records:
            key = record.header("name")
            if key:
                await self.client.delete_object(self.bucket, key)
                self._pending.discard(key)
