"""The port's authentication (``langstream_tpu_torch/auth``,
``gateway/auth.py``) against the JAX package's: HS256 tokens byte for
byte, the exp/nbf/aud/iss verdicts with their leeway, the port's stdlib
RS256 verification against the JAX package's ``cryptography`` one on keys
``cryptography`` makes here (valid, tampered, wrong key, wrong length), the
JWKS host allowlist and cache against a local JWKS server, the ``http``
provider against a local verification endpoint, ``google`` and ``github``
against local stand-ins (nothing leaves the machine), the providers'
memoization, and ``validate_gateway_authentication``'s messages, the
``gateway-authentication`` example's deploy refusals included."""

import asyncio
import base64
import contextlib
import http.server
import json
import threading
import time
from pathlib import Path

import pytest

from langstream_tpu.auth import jwt as jax_jwt
from langstream_tpu.auth import providers as jax_providers
from langstream_tpu.gateway import auth as jax_auth
from langstream_tpu_torch.auth import jwt as port_jwt
from langstream_tpu_torch.auth import providers as port_providers
from langstream_tpu_torch.gateway import auth as port_auth

REPO = Path(__file__).resolve().parents[1]
SIDES = {"jax": (jax_jwt, jax_auth, jax_providers), "port": (port_jwt, port_auth, port_providers)}


def verdict(fn, *args):
    """``("ok", result)`` or ``(exception class name, message)``."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — the verdict is the comparison
        return type(e).__name__, str(e)


def averdict(coro_fn, *args):
    async def run():
        try:
            return "ok", await coro_fn(*args)
        except Exception as e:  # noqa: BLE001
            return type(e).__name__, str(e)

    return asyncio.run(run())


# ---------------------------------------------------------------------------
# HS256 and the claim checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("claims", [{}, {"sub": "alice", "role": "admin"},
                                    {"sub": "ü", "n": [1, 2.5, None], "nested": {"a": True}}])
def test_hs256_tokens_are_byte_equal(claims):
    token = port_jwt.encode_hs256(claims, "s3cret")
    assert token == jax_jwt.encode_hs256(claims, "s3cret")
    assert port_jwt.decode_unverified(token) == jax_jwt.decode_unverified(token)


NOW = time.time()
CLAIM_CASES = [
    ({"secret": "s"}, {"sub": "x"}, "s"),
    ({"secret": "s"}, {"sub": "x"}, "wrong"),
    ({"secret": "s"}, {"exp": NOW - 3600}, "s"),
    ({"secret": "s"}, {"exp": NOW - 10}, "s"),  # inside the 30 s leeway
    ({"secret": "s", "leeway-seconds": 0}, {"exp": NOW - 10}, "s"),
    ({"secret": "s"}, {"nbf": NOW + 3600}, "s"),
    ({"secret": "s"}, {"nbf": NOW + 10}, "s"),
    ({"secret": "s"}, {"exp": "soon"}, "s"),
    ({"secret": "s"}, {"nbf": None}, "s"),
    ({"secret": "s"}, {"exp": "NaN"}, "s"),
    ({"secret": "s", "audience": "api"}, {"aud": ["other", "api"]}, "s"),
    ({"secret": "s", "audience": "api"}, {"aud": "other"}, "s"),
    ({"secret": "s", "issuer": "me"}, {"iss": "them"}, "s"),
    ({"secret": "s", "issuer": "me"}, {"iss": "me"}, "s"),
    ({"public-jwk": {"kty": "RSA"}}, {"sub": "x"}, "s"),  # HS256 with no secret
    ({}, {}, "s"),
]


@pytest.mark.parametrize("case", range(len(CLAIM_CASES)))
def test_the_claim_verdicts_are_equal(case):
    config, claims, key = CLAIM_CASES[case]
    token = jax_jwt.encode_hs256(claims, key)
    verdicts = {}
    for name, (jwt, _, _) in SIDES.items():
        made = verdict(jwt.JwtValidator.from_config, config)
        verdicts[name] = made if made[0] != "ok" else verdict(made[1].validate, token)
    assert verdicts["port"] == verdicts["jax"]


@pytest.mark.parametrize("token", ["", "a.b", "a.b.c.d", "!!!.???.***",
                                   "eyJhbGciOiJub25lIn0.e30.", "bnVsbA.e30.AA"])
def test_malformed_tokens_get_the_same_verdict(token):
    out = {name: verdict(jwt.JwtValidator(secret="s").validate, token)
           for name, (jwt, _, _) in SIDES.items()}
    assert out["port"] == out["jax"] and out["port"][0] == "JwtError"


# ---------------------------------------------------------------------------
# RS256: the stdlib verification against cryptography's
# ---------------------------------------------------------------------------


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _int_b64(i: int) -> str:
    return _b64url(i.to_bytes((i.bit_length() + 7) // 8, "big"))


def rsa_key(bits: int = 2048, e: int = 65537):
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives.asymmetric import rsa

    key = rsa.generate_private_key(public_exponent=e, key_size=bits)
    numbers = key.public_key().public_numbers()
    return key, {"kty": "RSA", "kid": f"k{bits}-{e}", "n": _int_b64(numbers.n),
                 "e": _int_b64(numbers.e)}


def rs256_token(key, claims: dict, kid: str | None = None) -> str:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    header = {"alg": "RS256", **({"kid": kid} if kid else {})}
    signing_input = f"{_b64url(json.dumps(header).encode())}.{_b64url(json.dumps(claims).encode())}"
    sig = key.sign(signing_input.encode(), padding.PKCS1v15(), hashes.SHA256())
    return f"{signing_input}.{_b64url(sig)}"


@pytest.mark.parametrize("bits,e", [(1024, 65537), (2048, 65537), (2048, 3), (3072, 65537)])
def test_rs256_verification_accepts_exactly_what_cryptography_accepts(bits, e):
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    key, jwk = rsa_key(bits, e)
    _, other_jwk = rsa_key(bits, e)
    message = b"header.payload"
    sig = key.sign(message, padding.PKCS1v15(), hashes.SHA256())
    n = int.from_bytes(base64.urlsafe_b64decode(jwk["n"] + "=="), "big")
    k = len(sig)
    flipped = bytearray(sig)
    flipped[k // 2] ^= 0x01
    # the same signature under SHA-1's DigestInfo: a valid PKCS#1 v1.5
    # block, but not SHA-256's
    sha1_sig = key.sign(message, padding.PKCS1v15(), hashes.SHA1())
    cases = [
        (message, sig, jwk, True),
        (b"header.payloaD", sig, jwk, False),  # tampered input
        (message, bytes(flipped), jwk, False),  # tampered signature
        (message, sig, other_jwk, False),  # wrong key
        (message, sig[:-1], jwk, False),  # short
        (message, b"\0" + sig, jwk, False),  # long, same value
        (message, (n + 1).to_bytes(k, "big") if n + 1 < 256 ** k else sig[::-1], jwk, False),
        (message, bytes(k), jwk, False),
        (message, b"", jwk, False),
        (message, sha1_sig, jwk, False),
    ]
    for i, (msg, signature, key_jwk, want) in enumerate(cases):
        port = port_jwt._verify_rs256(msg, signature, key_jwk)
        jax = jax_jwt._verify_rs256(msg, signature, key_jwk)
        assert port is jax is want, (i, port, jax)


def test_rs256_tokens_through_the_validators():
    key, jwk = rsa_key()
    token = rs256_token(key, {"sub": "svc", "aud": "api"})
    head, payload, sig = token.split(".")
    cases = [token, f"{head}.{payload[:-2]}AA.{sig}", f"{head}.{payload}.{sig[:-4]}"]
    for t in cases:
        out = {name: verdict(jwt.JwtValidator(public_jwk=jwk, audience="api").validate, t)
               for name, (jwt, _, _) in SIDES.items()}
        assert out["port"] == out["jax"], t
    assert port_jwt.JwtValidator(public_jwk=jwk).validate(token)["sub"] == "svc"


# ---------------------------------------------------------------------------
# local stand-ins: a JWKS document, GitHub's user API, an http auth endpoint
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def local_server(routes: dict):
    """A stdlib HTTP server on 127.0.0.1 in a thread: ``routes`` maps a path
    to ``(status, content type, body)`` or a callable of the handler
    returning that; yields (base URL, the list of requests seen)."""
    seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def _answer(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            seen.append((self.command, self.path, dict(self.headers), body))
            route = routes.get(self.path.split("?")[0])
            if route is None:
                status, ctype, payload = 404, "text/plain", b"no"
            else:
                status, ctype, payload = route(self, body) if callable(route) else route
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = _answer

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", seen
    finally:
        server.shutdown()
        server.server_close()


def test_the_jwks_allowlist_cache_and_kid_lookup_agree():
    key, jwk = rsa_key()
    doc = json.dumps({"keys": [{"kid": "other", "n": "AQAB", "e": "AQAB"}, jwk]}).encode()
    with local_server({"/jwks.json": (200, "application/json", doc)}) as (base, seen):
        uri = f"{base}/jwks.json"
        for name, (jwt, _, _) in SIDES.items():
            refused = verdict(jwt.JwksCache(allowed_hosts=["trusted.example.com"]).get, uri)
            assert refused == ("JwtError", "jwks host '127.0.0.1' not in allowlist"), name
            cache = jwt.JwksCache(allowed_hosts=["127.0.0.1"])
            assert cache.key_for(uri, jwk["kid"]) == jwk
            assert cache.key_for(uri, None)["kid"] == "other"
            assert verdict(cache.key_for, uri, "nope") == ("JwtError", "no jwks key with kid 'nope'")
            validator = jwt.JwtValidator(jwks_uri=uri, jwks_hosts_allowlist=["127.0.0.1"])
            assert validator.validate(rs256_token(key, {"sub": name}, jwk["kid"]))["sub"] == name
        fetches = [s for s in seen if s[1] == "/jwks.json"]
        assert len(fetches) == 4  # one per cache: the TTL holds the document
        missing = {name: verdict(jwt.JwksCache(allowed_hosts=["127.0.0.1"]).get,
                                 f"{base}/missing.json")
                   for name, (jwt, _, _) in SIDES.items()}
    assert missing["port"] == missing["jax"] and missing["port"][0] == "JwtError"


def test_the_http_provider_against_a_local_endpoint():
    def check(handler, body):
        token = json.loads(body)["token"]
        if token == "good":
            return 200, "application/json", json.dumps({"subject": "u1", "role": "r"}).encode()
        if token == "text":
            return 200, "text/plain", b'{"subject": "u2"}'
        if token == "list":
            return 200, "application/json", b"[1, 2]"
        if token == "empty":
            return 200, "application/json", b"  "
        return 401, "text/plain", b"denied"

    with local_server({"/check": check, "/auth/verify": check}) as (base, seen):
        for config in ({"base-url": base}, {"base-url": base, "path-template": "/auth/verify"}):
            for credentials in ("good", "text", "list", "empty", "bad", None):
                out = {name: averdict(auth.get_auth_provider("http", config).authenticate,
                                      credentials)
                       for name, (_, auth, _) in SIDES.items()}
                assert out["port"] == out["jax"], (config, credentials)
        assert averdict(port_auth.get_auth_provider("http", {"base-url": base}).authenticate,
                        "good") == ("ok", {"subject": "u1", "role": "r"})


def test_google_and_github_gate_and_answer_against_local_stand_ins(monkeypatch):
    """Offline the providers refuse cleanly (no hang, the same message); a
    local JWKS and a local user API show the accepting paths. Nothing
    leaves the machine: Google's JWKS host stays outside the allowlist
    until the test points the validator at the local document, and
    GitHub's user URL is the local server's."""
    key, jwk = rsa_key()
    doc = json.dumps({"keys": [jwk]}).encode()

    def user(handler, body):
        if handler.headers.get("Authorization") == "Bearer gho_good":
            return 200, "application/json", json.dumps(
                {"login": "octo", "name": "Octo Cat", "email": None}).encode()
        return 401, "application/json", b'{"message": "Bad credentials"}'

    with local_server({"/certs": (200, "application/json", doc), "/user": user}) as (base, _):
        for name, (_, auth, providers) in SIDES.items():
            monkeypatch.setattr(providers.GithubAuthenticationProvider, "API_USER", f"{base}/user")
        out = {}
        for name, (_, auth, providers) in SIDES.items():
            v = {}
            v["no-client-id"] = verdict(auth.get_auth_provider, "google", {})
            google = auth.get_auth_provider("google", {"clientId": "cid"})
            v["google-none"] = averdict(google.authenticate, None)
            v["google-malformed"] = averdict(google.authenticate, "fake-id-token")
            token = rs256_token(key, {"iss": "accounts.google.com", "aud": "cid",
                                      "sub": "g1", "email": "g@example.com"}, jwk["kid"])
            # the JWKS host allowlist refuses anything but Google's host
            google.validator.jwks_uri = f"{base}/certs"
            v["google-not-allowed"] = averdict(google.authenticate, token)
            google.validator.jwks.allowed_hosts = ["127.0.0.1"]
            v["google-ok"] = averdict(google.authenticate, token)
            v["google-issuer"] = averdict(google.authenticate, rs256_token(
                key, {"iss": "evil", "aud": "cid"}, jwk["kid"]))
            v["google-audience"] = averdict(google.authenticate, rs256_token(
                key, {"iss": "accounts.google.com", "aud": "x"}, jwk["kid"]))
            github = auth.get_auth_provider("github", {})
            v["github-none"] = averdict(github.authenticate, None)
            v["github-ok"] = averdict(github.authenticate, "gho_good")
            v["github-bad"] = averdict(github.authenticate, "gho_fake")
            out[name] = v
    assert out["port"] == out["jax"]
    assert out["port"]["google-ok"][1]["subject"] == "g@example.com"
    assert out["port"]["github-ok"] == ("ok", {"subject": "octo", "login": "octo",
                                               "name": "Octo Cat", "email": None})
    assert out["port"]["github-bad"][0] == "AuthenticationException"
    assert "not in allowlist" in out["port"]["google-not-allowed"][1]


def test_providers_are_memoized_by_name_and_configuration():
    for name, (_, auth, _) in SIDES.items():
        a = auth.get_auth_provider("jwt", {"secret": "m1"})
        assert auth.get_auth_provider("jwt", {"secret": "m1"}) is a
        assert auth.get_auth_provider("jwt", {"secret": "m2"}) is not a
        first = auth.get_auth_provider("test", {"i": -1})
        for i in range(auth._INSTANCES_MAX + 1):
            auth.get_auth_provider("test", {"i": i})
        assert len(auth._INSTANCES) == auth._INSTANCES_MAX
        assert auth.get_auth_provider("test", {"i": -1}) is not first  # evicted
    out = {name: verdict(auth.get_auth_provider, "nope", {}) for name, (_, auth, _) in SIDES.items()}
    assert out["port"] == out["jax"] and out["port"][0] == "AuthenticationException"


def test_the_test_and_jwt_providers_answer_equal():
    token = jax_jwt.encode_hs256({"sub": "user-1"}, "gw")
    for provider, config, credentials in [
            ("test", {}, None), ("test", {}, "alice"), ("test", {"require-credentials": True}, None),
            ("jwt", {"secret": "gw"}, token), ("jwt", {"secret": "gw"}, "not-a-token"),
            ("jwt", {"secret": "gw"}, None), ("jwt", {"secret": "other"}, token)]:
        out = {name: averdict(auth.get_auth_provider(provider, config).authenticate, credentials)
               for name, (_, auth, _) in SIDES.items()}
        assert out["port"] == out["jax"], (provider, config, credentials)


def _gateways(package: str, directory: str, secrets: str | None):
    if package == "jax":
        from langstream_tpu.core.parser import build_application_from_directory
        from langstream_tpu.core.placeholders import resolve_placeholders
    else:
        from langstream_tpu_torch.core.parser import build_application_from_directory
        from langstream_tpu_torch.core.placeholders import resolve_placeholders
    app = build_application_from_directory(
        directory, str(REPO / "examples" / "instances" / "memory.yaml"), secrets)
    resolve_placeholders(app)
    return app.gateways


@pytest.mark.parametrize("gateway", [
    {"id": "g", "type": "produce", "topic": "t", "authentication": {"provider": "google"}},
    {"id": "g", "type": "produce", "topic": "t", "authentication": {
        "provider": "jwt", "configuration": {"secret-key": "x"}}},
    {"id": "g", "type": "produce", "topic": "t", "authentication": {"provider": "ldap"}},
    {"id": "g", "type": "produce", "topic": "t", "authentication": {
        "provider": "jwt", "configuration": {"secret": "x"}}},
    {"id": "", "type": "produce", "topic": "t", "authentication": {
        "provider": "google", "configuration": {}}},
])
def test_validate_gateway_authentication_gives_equal_messages(gateway):
    from langstream_tpu.api.application import Gateway as JaxGateway
    from langstream_tpu_torch.api.application import Gateway as PortGateway

    out = {}
    for name, cls in (("jax", JaxGateway), ("port", PortGateway)):
        gw = cls.from_dict(dict(gateway))
        out[name] = verdict(SIDES[name][1].validate_gateway_authentication, [gw])
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("secrets", [None, "examples/secrets/secrets.yaml"])
def test_the_gateway_authentication_example_is_refused_alike(secrets):
    """The example cannot deploy in either package: without secrets its
    ``google.client-id`` placeholder does not resolve; with the repository's
    secrets its ``produce-jwt`` gateway names ``secret-key`` where the jwt
    provider reads ``secret`` (a kept reference trait)."""
    directory = str(REPO / "examples" / "applications" / "gateway-authentication")
    secrets = str(REPO / secrets) if secrets else None
    out = {}
    for name in ("jax", "port"):
        try:
            gateways = _gateways(name, directory, secrets)
            out[name] = verdict(SIDES[name][1].validate_gateway_authentication, gateways)
        except Exception as e:  # noqa: BLE001 — placeholder resolution
            out[name] = (type(e).__name__, str(e))
    assert out["port"] == out["jax"]
    assert out["port"][0] != "ok"
    if secrets:
        assert out["port"][1] == ("gateway 'produce-jwt': invalid authentication (jwt): "
                                  "JwtValidator needs one of: secret, public-jwk, jwks-uri")
    else:
        assert "google.client-id" in out["port"][1]


def test_the_gateway_authentication_example_is_refused_at_deploy_by_both_control_planes():
    """The example's gateways over an app the port carries (its ``compute``
    agent is not ported): both control planes answer 400 with one reason."""
    from langstream_tpu.controlplane.server import ControlPlaneServer as JaxControlPlane
    from langstream_tpu_torch.controlplane.server import ControlPlaneServer
    from langstream_tpu_torch.gateway import wire

    example = REPO / "examples" / "applications" / "gateway-authentication"
    payload = {"files": {
        "gateways.yaml": (example / "gateways.yaml").read_text(),
        "pipeline.yaml": "topics:\n  - name: messages\n    creation-mode: create-if-not-exists\n"
                         "pipeline:\n  - name: echo\n    type: document-to-json\n"
                         "    input: messages\n"},
        "instance": (REPO / "examples" / "instances" / "memory.yaml").read_text(),
        "secrets": (REPO / "examples" / "secrets" / "secrets.yaml").read_text()}

    async def main():
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            jax_port = s.getsockname()[1]
        servers = [JaxControlPlane(port=jax_port), ControlPlaneServer(port=0)]
        answers = []
        for server in servers:
            await server.start()
            try:
                base = f"http://127.0.0.1:{server.port}"
                await wire.http_request("PUT", f"{base}/api/tenants/t", body=None)
                status, _, _, body = await wire.http_request(
                    "POST", f"{base}/api/applications/t/auth", json_body=payload)
                answers.append((status, body.decode()))
            finally:
                await server.stop()
        return answers

    jax, port = asyncio.run(main())
    assert port == jax
    assert port[0] == 400 and "produce-jwt" in port[1] and "secret, public-jwk" in port[1]
