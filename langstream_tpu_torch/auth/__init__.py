"""Authentication: JWT validation + gateway user-auth providers (the port's
copy of ``langstream_tpu/auth``).

Parity: ``langstream-auth-jwt`` (token validation incl. JWKS fetch,
``AuthenticationProviderToken.java`` / ``JwksUriSigningKeyResolver.java``)
and ``langstream-api-gateway-auth`` (google/github/jwt/http providers).
"""

from langstream_tpu_torch.auth.jwt import (
    JwtError,
    JwtValidator,
    decode_unverified,
    encode_hs256,
)

__all__ = ["JwtError", "JwtValidator", "decode_unverified", "encode_hs256"]
