"""Gateway auth providers: jwt, google, github (the port's copy of
``langstream_tpu/auth/providers.py``).

Parity: ``langstream-api-gateway-auth``
(``ai/langstream/apigateway/auth/impl/{google,github,jwt}``). The google and
github providers need outbound network (Google JWKS / GitHub API) and fail
with a clear AuthenticationException when offline — gated, not stubbed.
Registered into the gateway's provider registry on import of
:mod:`langstream_tpu_torch.gateway.auth`.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any

from langstream_tpu_torch.auth.jwt import JwtError, JwtValidator, decode_unverified
from langstream_tpu_torch.gateway.auth import (
    AuthenticationException,
    GatewayAuthenticationProvider,
)

GOOGLE_JWKS = "https://www.googleapis.com/oauth2/v3/certs"
GOOGLE_ISSUERS = ("https://accounts.google.com", "accounts.google.com")


class JwtAuthenticationProvider(GatewayAuthenticationProvider):
    """Validate a caller-supplied JWT; the claims become the principal
    (``value-from-authentication`` reads them, e.g. ``sub``)."""

    def __init__(self, configuration: dict[str, Any]):
        super().__init__(configuration)
        try:
            self.validator = JwtValidator.from_config(configuration)
        except JwtError as e:
            raise AuthenticationException(str(e)) from e

    async def authenticate(self, credentials: str | None) -> dict[str, Any]:
        if not credentials:
            raise AuthenticationException("missing bearer token")
        try:
            claims = self.validator.validate(credentials)
        except JwtError as e:
            raise AuthenticationException(str(e)) from e
        claims.setdefault("subject", claims.get("sub"))
        return claims


class GoogleAuthenticationProvider(GatewayAuthenticationProvider):
    """Verify a Google ID token against Google's JWKS; requires outbound
    network. Config: ``clientId`` (audience)."""

    def __init__(self, configuration: dict[str, Any]):
        super().__init__(configuration)
        self.client_id = configuration.get("clientId")
        if not self.client_id:
            # without an audience check any valid Google ID token (minted
            # for any OAuth client) would authenticate — refuse to
            # construct (this fails deploy-time gateway validation)
            raise AuthenticationException(
                "google auth provider requires 'clientId' (token audience)"
            )
        # one validator per provider: JwksCache amortizes the JWKS fetch
        # across requests (per-call construction would re-fetch every login)
        self.validator = JwtValidator(
            jwks_uri=GOOGLE_JWKS,
            jwks_hosts_allowlist=["www.googleapis.com"],
            audience=self.client_id,
        )

    async def authenticate(self, credentials: str | None) -> dict[str, Any]:
        if not credentials:
            raise AuthenticationException("missing google id token")
        try:
            claims = self.validator.validate(credentials)
        except JwtError as e:
            raise AuthenticationException(f"google token rejected: {e}") from e
        if claims.get("iss") not in GOOGLE_ISSUERS:
            raise AuthenticationException(
                f"unexpected issuer {claims.get('iss')!r}"
            )
        claims.setdefault("subject", claims.get("email") or claims.get("sub"))
        return claims


class GithubAuthenticationProvider(GatewayAuthenticationProvider):
    """Resolve a GitHub OAuth token to its user via the GitHub API; requires
    outbound network. Config: ``allowed-organizations`` (optional)."""

    API_USER = "https://api.github.com/user"

    async def authenticate(self, credentials: str | None) -> dict[str, Any]:
        if not credentials:
            raise AuthenticationException("missing github token")
        import asyncio

        def _fetch() -> dict[str, Any]:
            req = urllib.request.Request(
                self.API_USER,
                headers={
                    "Authorization": f"Bearer {credentials}",
                    "Accept": "application/vnd.github+json",
                    "User-Agent": "langstream-tpu-gateway",
                },
            )
            with urllib.request.urlopen(req, timeout=10) as resp:
                return json.loads(resp.read())

        try:
            user = await asyncio.get_running_loop().run_in_executor(None, _fetch)
        except Exception as e:  # noqa: BLE001 — offline/401 both land here
            raise AuthenticationException(f"github auth failed: {e}") from e
        return {
            "subject": user.get("login"),
            "login": user.get("login"),
            "name": user.get("name"),
            "email": user.get("email"),
        }


def peek_subject(token: str) -> str | None:
    """Best-effort unverified subject (diagnostics only)."""
    try:
        _, claims = decode_unverified(token)
        return claims.get("sub")
    except JwtError:
        return None
