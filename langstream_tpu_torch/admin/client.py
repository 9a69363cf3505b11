"""Admin client: a reusable facade over the control-plane REST API (the
port's copy of ``langstream_tpu/admin/client.py``, on the port's stdlib
client, :func:`langstream_tpu_torch.gateway.wire.http_request`).

Parity: ``langstream-admin-client`` (``AdminClient.java`` + per-resource
``...Cmd`` classes) — the reference ships a standalone library with retry
policies that both its CLI and tests drive. Retries: idempotent requests
(GET/PUT/DELETE and explicitly-marked others) back off exponentially on
connection errors and 5xx; non-idempotent POSTs retry only when the
connection could not be opened (:class:`~langstream_tpu_torch.gateway.wire.
ConnectError`: nothing was sent), never after the request went out.

Imports neither ``torch`` nor the serving stack: the CLI's admin commands
run on it alone.
"""

from __future__ import annotations

import asyncio
import json as _json
import logging
import uuid
from typing import Any

from langstream_tpu_torch.gateway import wire

log = logging.getLogger(__name__)

_IDEMPOTENT = {"GET", "PUT", "DELETE", "HEAD"}


class AdminApiError(RuntimeError):
    def __init__(self, status: int, body: str):
        super().__init__(f"{status}: {body}")
        self.status = status
        self.body = body


def multipart_body(
    fields: list[tuple[str, str | None, bytes, str | None]],
) -> tuple[bytes, str]:
    """``multipart/form-data`` of ``(name, filename, payload, content type)``
    fields: ``(body, Content-Type header)``, as the control plane's deploy
    reads it (an ``app`` zip, ``instance`` and ``secrets`` texts)."""
    boundary = uuid.uuid4().hex
    out = bytearray()
    for name, filename, payload, content_type in fields:
        disposition = f'form-data; name="{name}"'
        if filename is not None:
            disposition += f'; filename="{filename}"'
        out += f"--{boundary}\r\nContent-Disposition: {disposition}\r\n".encode()
        if content_type:
            out += f"Content-Type: {content_type}\r\n".encode()
        out += b"\r\n" + payload + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return bytes(out), f"multipart/form-data; boundary={boundary}"


class AdminClient:
    """One instance per control plane; safe to share across tasks."""

    def __init__(
        self,
        base_url: str,
        token: str | None = None,
        *,
        retries: int = 3,
        backoff_s: float = 0.5,
        timeout_s: float = 60.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.retries = retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s

    async def close(self) -> None:
        """Nothing to close: every request has its own connection (kept
        for the JAX client's shape)."""

    async def request(
        self, method: str, path: str, *, retry_safe: bool | None = None,
        binary: bool = False, json: Any = None, data: bytes | None = None,
        headers: dict[str, str] | None = None,
    ) -> Any:
        """``json`` is sent as a JSON body, ``data`` as raw bytes (with the
        caller's ``Content-Type`` in ``headers``); neither sends no body."""
        method = method.upper()
        idempotent = retry_safe if retry_safe is not None else method in _IDEMPOTENT
        url = f"{self.base_url}{path}"
        hdrs = dict(headers or {})
        if self.token:
            hdrs["Authorization"] = f"Bearer {self.token}"
        body = data
        if json is not None:
            body = _json.dumps(json).encode()
            hdrs["Content-Type"] = "application/json"
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                status, _, _, raw = await wire.http_request(
                    method, url, body=body, headers=hdrs, timeout=self.timeout_s,
                )
                text = (
                    ""
                    if binary and status < 300
                    else raw.decode("utf-8", errors="replace")
                )
                if status >= 500 and idempotent and attempt < self.retries:
                    last = AdminApiError(status, text[:500])
                    raise last
                if status >= 300:
                    raise AdminApiError(status, text)
                if binary:
                    return raw
                try:
                    return _json.loads(text)
                except _json.JSONDecodeError:
                    return text
            except (OSError, asyncio.IncompleteReadError) as e:
                # connection-level failures are safe to retry for any verb
                # only when nothing was sent (the connection never opened);
                # an idempotent request may be re-issued after any of them
                # (TimeoutError is an OSError)
                if not idempotent and not isinstance(e, wire.ConnectError):
                    raise
                last = e
            except AdminApiError as e:
                if not (e.status >= 500 and idempotent):
                    raise
                last = e
            if attempt < self.retries:
                delay = self.backoff_s * (2**attempt)
                log.debug("retrying %s %s in %.1fs (%s)", method, path, delay, last)
                await asyncio.sleep(delay)
        raise last  # retries exhausted

    # ---- tenants ----------------------------------------------------------

    async def list_tenants(self) -> list[str]:
        return await self.request("GET", "/api/tenants")

    async def put_tenant(self, tenant: str, config: dict | None = None) -> Any:
        return await self.request("PUT", f"/api/tenants/{tenant}", json=config)

    async def delete_tenant(self, tenant: str) -> Any:
        return await self.request("DELETE", f"/api/tenants/{tenant}")

    # ---- applications ------------------------------------------------------

    async def list_applications(self, tenant: str) -> list[str]:
        return await self.request("GET", f"/api/applications/{tenant}")

    async def get_application(
        self, tenant: str, name: str, *, files: bool = False
    ) -> dict:
        suffix = "?files=true" if files else ""
        return await self.request(
            "GET", f"/api/applications/{tenant}/{name}{suffix}"
        )

    async def deploy_application(
        self, tenant: str, name: str, payload: dict
    ) -> dict:
        return await self.request(
            "POST", f"/api/applications/{tenant}/{name}", json=payload
        )

    async def update_application(
        self, tenant: str, name: str, payload: dict
    ) -> dict:
        return await self.request(
            "PATCH", f"/api/applications/{tenant}/{name}", json=payload,
            retry_safe=True,  # update re-validates against the stored app
        )

    async def delete_application(self, tenant: str, name: str) -> Any:
        return await self.request("DELETE", f"/api/applications/{tenant}/{name}")

    async def application_logs(self, tenant: str, name: str) -> Any:
        return await self.request(
            "GET", f"/api/applications/{tenant}/{name}/logs"
        )

    async def application_agents(self, tenant: str, name: str) -> Any:
        return await self.request(
            "GET", f"/api/applications/{tenant}/{name}/agents"
        )
