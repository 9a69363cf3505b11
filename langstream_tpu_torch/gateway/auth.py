"""Gateway authentication providers: the port's copy of
``langstream_tpu/gateway/auth.py`` (the ``http`` provider on the port's
stdlib client, :func:`langstream_tpu_torch.gateway.wire.http_request`).

Parity: ``langstream-api-gateway-auth`` (google/github/jwt/http providers).
First-party: ``http`` (POST credentials to a verification endpoint) and
``test`` (accept-all, principal echoes the credentials — the fixture role
the reference's tests play). ``google``/``github``/``jwt`` gate on network
or optional libraries.
"""

from __future__ import annotations

import abc
import re
from collections import OrderedDict
from typing import Any

#: the media types aiohttp reads as JSON
_JSON_TYPE = re.compile(r"^application/(?:[\w.+-]+?\+)?json")


class AuthenticationException(Exception):
    pass


class GatewayAuthenticationProvider(abc.ABC):
    """authenticate(credentials) → principal claims dict (raises on deny)."""

    def __init__(self, configuration: dict[str, Any]):
        self.configuration = configuration

    @abc.abstractmethod
    async def authenticate(self, credentials: str | None) -> dict[str, Any]: ...


class TestAuthenticationProvider(GatewayAuthenticationProvider):
    """Accept-all provider for tests/dev: principal.subject = credentials."""

    async def authenticate(self, credentials: str | None) -> dict[str, Any]:
        if self.configuration.get("require-credentials") and not credentials:
            raise AuthenticationException("credentials required")
        return {"subject": credentials or "anonymous"}


class HttpAuthenticationProvider(GatewayAuthenticationProvider):
    """POSTs the credentials to an external endpoint; 2xx → principal from
    the JSON response (parity: the reference's http auth provider)."""

    async def authenticate(self, credentials: str | None) -> dict[str, Any]:
        import json

        from langstream_tpu_torch.gateway.wire import http_request

        url = self.configuration.get("base-url", "") + self.configuration.get(
            "path-template", "/check"
        )
        status, _, headers, body = await http_request(
            "POST", url, json_body={"token": credentials}
        )
        if status >= 300:
            raise AuthenticationException(f"auth endpoint: {status}")
        # aiohttp's ``json()`` in the JAX provider: a body that is not
        # declared JSON reads as {}, an empty one as None
        ctype = headers.get("content-type", "").lower()
        try:
            if not _JSON_TYPE.match(ctype):
                raise ValueError(f"not a JSON response: {ctype!r}")
            data = json.loads(body.strip()) if body.strip() else None
        except Exception:
            data = {}
        return data if isinstance(data, dict) else {"subject": str(data)}


_PROVIDERS: dict[str, type[GatewayAuthenticationProvider]] = {
    "test": TestAuthenticationProvider,
    "http": HttpAuthenticationProvider,
}


def register_auth_provider(name: str, cls: type[GatewayAuthenticationProvider]) -> None:
    _PROVIDERS[name] = cls


def _ensure_providers() -> None:
    if "jwt" not in _PROVIDERS:
        from langstream_tpu_torch.auth.providers import (
            GithubAuthenticationProvider,
            GoogleAuthenticationProvider,
            JwtAuthenticationProvider,
        )

        _PROVIDERS["jwt"] = JwtAuthenticationProvider
        _PROVIDERS["google"] = GoogleAuthenticationProvider
        _PROVIDERS["github"] = GithubAuthenticationProvider


# Constructed providers are memoized by (name, config): gateways resolve
# their provider on every request, and per-request construction would both
# rebuild validator state (defeating e.g. the google JWKS cache) and defer
# construction-time config validation to the first login. LRU-bounded so
# rotated secrets/configs don't pin provider objects for process lifetime.
_INSTANCES: OrderedDict[tuple[str, str], GatewayAuthenticationProvider] = (
    OrderedDict()
)
_INSTANCES_MAX = 64


def get_auth_provider(
    name: str, configuration: dict[str, Any]
) -> GatewayAuthenticationProvider:
    import json

    _ensure_providers()
    if name not in _PROVIDERS:
        raise AuthenticationException(
            f"unknown auth provider {name!r}; available: {sorted(_PROVIDERS)} "
            f"(google/github need outbound network)"
        )
    key = (name, json.dumps(configuration, sort_keys=True, default=str))
    provider = _INSTANCES.get(key)
    if provider is None:
        provider = _INSTANCES[key] = _PROVIDERS[name](configuration)
    _INSTANCES.move_to_end(key)
    while len(_INSTANCES) > _INSTANCES_MAX:
        _INSTANCES.popitem(last=False)
    return provider


def validate_gateway_authentication(gateways) -> None:
    """Construct every gateway's auth provider once at deploy/update
    validation time so misconfiguration (e.g. google without clientId)
    fails the deploy instead of surfacing as per-login 401s."""
    for gw in gateways or []:
        auth = getattr(gw, "authentication", None)
        if not auth:
            continue
        name = auth.get("provider", "test")
        try:
            get_auth_provider(name, auth.get("configuration", {}))
        except AuthenticationException as e:
            gw_id = getattr(gw, "id", None) or "?"
            raise ValueError(
                f"gateway {gw_id!r}: invalid authentication ({name}): {e}"
            ) from e
