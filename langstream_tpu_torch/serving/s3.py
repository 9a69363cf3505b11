"""A dependency-free S3 REST client for the prefix store's T2 tier (the
port's copy of what ``langstream_tpu/agents/s3_impl.py`` gives the JAX
package's ``S3PrefixStorage``: ``S3RequestError``, AWS Signature V4,
ListObjectsV2 parsing and the blocking ``SyncS3Client``). The port imports
nothing of the JAX package, so it carries its own copy."""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Any

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class S3RequestError(RuntimeError):
    """Non-OK S3 response; carries the HTTP status so callers can treat
    404s (object raced away between list and get) as skippable."""

    def __init__(self, message: str, status: int):
        super().__init__(message)
        self.status = status


def _uri_encode(value: str, *, encode_slash: bool = True) -> str:
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(value, safe=safe)


def sigv4_headers(
    method: str,
    url: str,
    *,
    access_key: str,
    secret_key: str,
    region: str = "us-east-1",
    service: str = "s3",
    payload: bytes = b"",
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """AWS Signature Version 4 headers for one request (the whole algorithm,
    no SDK): returns ``host``, ``x-amz-date``, ``x-amz-content-sha256`` and
    ``Authorization``. Deterministic given ``now`` (tests pin it)."""
    parsed = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest() if payload else _EMPTY_SHA256

    # the callers build request paths with urllib.parse.quote, so parsed.path
    # is already the percent-encoded form that goes on the wire — the
    # canonical URI must be exactly that (re-encoding here would sign
    # '/my%2520file' for a request that sends '/my%20file')
    canonical_uri = parsed.path or "/"
    query_pairs = urllib.parse.parse_qsl(
        parsed.query, keep_blank_values=True, strict_parsing=False
    )
    canonical_query = "&".join(
        f"{_uri_encode(k, encode_slash=True)}={_uri_encode(v, encode_slash=True)}"
        for k, v in sorted(query_pairs)
    )
    host = parsed.netloc
    headers = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    signed_names = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join(
        [method.upper(), canonical_uri, canonical_query, canonical_headers,
         signed_names, payload_hash]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        ["AWS4-HMAC-SHA256", amz_date, scope,
         hashlib.sha256(canonical_request.encode()).hexdigest()]
    )

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k_date = _hmac(b"AWS4" + secret_key.encode(), datestamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(
        k_signing, string_to_sign.encode(), hashlib.sha256
    ).hexdigest()
    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}"
    )
    return headers


def _parse_list_objects(body: bytes) -> tuple[list[dict[str, Any]], str | None]:
    """ListObjectsV2 XML → ([{key, size}], continuation-token | None)."""
    root = ET.fromstring(body)
    ns = ""
    if root.tag.startswith("{"):
        ns = root.tag[: root.tag.index("}") + 1]
    objects = [
        {
            "key": c.findtext(f"{ns}Key"),
            "size": int(c.findtext(f"{ns}Size") or 0),
        }
        for c in root.findall(f"{ns}Contents")
    ]
    token = root.findtext(f"{ns}NextContinuationToken")
    return objects, token or None


class SyncS3Client:
    """Blocking S3 client over urllib: the prefix store's T2 backend calls
    it from the hydrator thread only."""

    #: explicit socket bound on every blocking request: the prefix-store
    #: hydrator blocks on this client, and a dead endpoint must become a
    #: loud error inside a bounded window, never a thread parked in recv
    DEFAULT_TIMEOUT_S = 30.0

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1",
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region or "us-east-1"
        self.timeout_s = float(timeout_s)

    def _request(self, method: str, path: str, *, payload: bytes = b"",
                 ok: tuple[int, ...] = (200, 204)) -> tuple[int, bytes]:
        url = f"{self.endpoint}{path}"
        headers = sigv4_headers(
            method, url, access_key=self.access_key, secret_key=self.secret_key,
            region=self.region, payload=payload,
        )
        req = urllib.request.Request(
            url, data=payload or None, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                status, body = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, body = e.code, e.read()
        if status not in ok:
            raise S3RequestError(
                f"s3 {method} {path}: {status} {body[:300]!r}", status
            )
        return status, body

    def bucket_exists(self, bucket: str) -> bool:
        status, _ = self._request("HEAD", f"/{bucket}", ok=(200, 404))
        return status == 200

    def create_bucket(self, bucket: str) -> None:
        self._request("PUT", f"/{bucket}", ok=(200,))

    def get_object(self, bucket: str, key: str) -> bytes:
        return self._request(
            "GET", f"/{bucket}/{urllib.parse.quote(key)}", ok=(200,)
        )[1]

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        self._request(
            "PUT", f"/{bucket}/{urllib.parse.quote(key)}", payload=data,
            ok=(200, 201),
        )

    def delete_object(self, bucket: str, key: str) -> None:
        self._request(
            "DELETE", f"/{bucket}/{urllib.parse.quote(key)}", ok=(200, 204)
        )
