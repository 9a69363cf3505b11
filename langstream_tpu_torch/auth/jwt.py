"""JWT validation (HS256/RS256) + JWKS resolution, no third-party JWT lib:
the port's copy of ``langstream_tpu/auth/jwt.py``.

Parity: ``langstream-auth-jwt`` — ``AuthenticationProviderToken`` (configured
secret/public key, audience/issuer checks) and ``JwksUriSigningKeyResolver``
(fetch the signer's JWKS by ``kid``, restricted to an allowlist of hosts).
HS256 and RS256 are both stdlib here: RS256 verification is RSASSA-PKCS1-v1_5
(RFC 8017 §8.2.2) written out — ``pow(s, e, n)`` against the EMSA-PKCS1-v1_5
encoding of the SHA-256 digest — where the JAX package calls
``cryptography``, which the port does not need. JWKS fetches are the only
network touchpoint and gate cleanly when offline.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import math
import time
import urllib.request
from typing import Any


class JwtError(Exception):
    pass


def _b64url_decode(data: str) -> bytes:
    padding = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + padding)


def _b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def encode_hs256(claims: dict[str, Any], secret: str) -> str:
    """Mint an HS256 token (tests, CLI, dev gateways)."""
    header = _b64url_encode(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url_encode(json.dumps(claims).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url_encode(sig)}"


def decode_unverified(token: str) -> tuple[dict[str, Any], dict[str, Any]]:
    """(header, claims) without signature verification — for kid routing and
    error messages only; never trust these claims."""
    try:
        header_b64, payload_b64, _ = token.split(".")
        return (
            json.loads(_b64url_decode(header_b64)),
            json.loads(_b64url_decode(payload_b64)),
        )
    except Exception as e:  # noqa: BLE001
        raise JwtError(f"malformed token: {e}") from e


#: the DER DigestInfo prefix of a SHA-256 digest (RFC 8017 §9.2, note 1)
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def _verify_rs256(signing_input: bytes, signature: bytes, jwk: dict[str, Any]) -> bool:
    """RSASSA-PKCS1-v1_5 verification with SHA-256 (RFC 8017 §8.2.2): the
    signature must be exactly the modulus' length and below it; ``s^e mod
    n`` must equal ``00 01 FF..FF 00 || DigestInfo || SHA-256(input)``
    byte for byte, compared in constant time. A key that is not an RSA
    public key raises ValueError, as the JAX package's key construction
    does."""
    n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
    e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
    if n < 3 or n % 2 == 0 or e < 3 or e >= n or e % 2 == 0:
        raise ValueError("invalid RSA public key numbers")
    k = (n.bit_length() + 7) // 8
    if len(signature) != k:
        return False
    s = int.from_bytes(signature, "big")
    if s >= n:
        return False
    t = _SHA256_DIGEST_INFO + hashlib.sha256(signing_input).digest()
    if k < len(t) + 11:
        return False
    expected = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return hmac.compare_digest(pow(s, e, n).to_bytes(k, "big"), expected)


class JwksCache:
    """Fetch-and-cache JWKS documents, restricted to allowed hosts (parity:
    the reference's resolver refuses arbitrary ``jwks_uri`` hosts)."""

    def __init__(self, allowed_hosts: list[str] | None = None, ttl: float = 3600.0):
        self.allowed_hosts = allowed_hosts or []
        self.ttl = ttl
        self._cache: dict[str, tuple[float, dict]] = {}

    def get(self, uri: str) -> dict[str, Any]:
        from urllib.parse import urlparse

        host = urlparse(uri).hostname or ""
        if self.allowed_hosts and host not in self.allowed_hosts:
            raise JwtError(f"jwks host {host!r} not in allowlist")
        now = time.time()
        cached = self._cache.get(uri)
        if cached and now - cached[0] < self.ttl:
            return cached[1]
        try:
            with urllib.request.urlopen(uri, timeout=10) as resp:
                doc = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 — offline/unreachable gates here
            raise JwtError(f"jwks fetch failed for {uri}: {e}") from e
        self._cache[uri] = (now, doc)
        return doc

    def key_for(self, uri: str, kid: str | None) -> dict[str, Any]:
        keys = self.get(uri).get("keys", [])
        for key in keys:
            if kid is None or key.get("kid") == kid:
                return key
        raise JwtError(f"no jwks key with kid {kid!r}")


class JwtValidator:
    """Validate a token against a configured secret (HS256), public JWK
    (RS256), or a JWKS endpoint; then check exp/nbf/aud/iss."""

    def __init__(
        self,
        secret: str | None = None,
        public_jwk: dict[str, Any] | None = None,
        jwks_uri: str | None = None,
        jwks_hosts_allowlist: list[str] | None = None,
        audience: str | None = None,
        issuer: str | None = None,
        leeway: float = 30.0,
    ):
        self.secret = secret
        self.public_jwk = public_jwk
        self.jwks_uri = jwks_uri
        self.jwks = JwksCache(jwks_hosts_allowlist)
        self.audience = audience
        self.issuer = issuer
        self.leeway = leeway
        if not (secret or public_jwk or jwks_uri):
            raise JwtError(
                "JwtValidator needs one of: secret, public-jwk, jwks-uri"
            )

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "JwtValidator":
        return cls(
            secret=config.get("secret"),
            public_jwk=config.get("public-jwk"),
            jwks_uri=config.get("jwks-uri"),
            jwks_hosts_allowlist=config.get("jwks-hosts-allowlist"),
            audience=config.get("audience"),
            issuer=config.get("issuer"),
            leeway=float(config.get("leeway-seconds", 30)),
        )

    def validate(self, token: str) -> dict[str, Any]:
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url_decode(header_b64))
            signature = _b64url_decode(sig_b64)
        except (ValueError, TypeError) as e:
            # covers bad segment count, binascii.Error (a ValueError
            # subclass) and JSONDecodeError — malformed input must surface
            # as JwtError so callers can map it to 401, never 500
            raise JwtError(f"malformed token: {e}") from e
        signing_input = f"{header_b64}.{payload_b64}".encode()
        alg = header.get("alg") if isinstance(header, dict) else None

        if alg == "HS256":
            if not self.secret:
                raise JwtError("HS256 token but no secret configured")
            expected = hmac.new(
                self.secret.encode(), signing_input, hashlib.sha256
            ).digest()
            if not hmac.compare_digest(expected, signature):
                raise JwtError("signature verification failed")
        elif alg == "RS256":
            jwk = self.public_jwk
            if jwk is None:
                if not self.jwks_uri:
                    raise JwtError("RS256 token but no public key / jwks-uri")
                jwk = self.jwks.key_for(self.jwks_uri, header.get("kid"))
            if not _verify_rs256(signing_input, signature, jwk):
                raise JwtError("signature verification failed")
        else:
            raise JwtError(f"unsupported alg {alg!r}")

        try:
            claims = json.loads(_b64url_decode(payload_b64))
        except (ValueError, TypeError) as e:
            raise JwtError(f"malformed claims: {e}") from e
        if not isinstance(claims, dict):
            raise JwtError("claims payload is not an object")
        now = time.time()
        try:
            exp = float(claims["exp"]) if "exp" in claims else None
            nbf = float(claims["nbf"]) if "nbf" in claims else None
        except (TypeError, ValueError) as e:
            raise JwtError(f"non-numeric exp/nbf claim: {e}") from e
        # float() also accepts "NaN"/"Infinity", which would make every
        # time comparison below vacuously pass (never expires)
        if (exp is not None and not math.isfinite(exp)) or (
            nbf is not None and not math.isfinite(nbf)
        ):
            raise JwtError("non-finite exp/nbf claim")
        if exp is not None and now > exp + self.leeway:
            raise JwtError("token expired")
        if nbf is not None and now < nbf - self.leeway:
            raise JwtError("token not yet valid")
        if self.audience is not None:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise JwtError(f"audience mismatch: {aud!r}")
        if self.issuer is not None and claims.get("iss") != self.issuer:
            raise JwtError(f"issuer mismatch: {claims.get('iss')!r}")
        return claims
