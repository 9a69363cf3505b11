"""The port's Kafka wire lane security, every case of
``tests/test_kafka_security.py``: SASL (PLAIN + SCRAM), TLS, and compressed
fetches (the reference reaches SASL_SSL brokers out of the box, e.g. its
Astra instance ``examples/instances/astra.yaml:27-29``). Each case with a
broker runs against both fakes (``tests/torch_fake_kafka.py`` and
``tests/fake_kafka.py``); the JAX client's SCRAM runs against the port's
fake.

Independence: the SCRAM client is pinned to the OFFICIAL RFC 7677 test
vector (not our own server); the fake broker's SCRAM server side derives
and verifies proofs with its own implementation; the gzip fixture below is
hand-built with its own varint/struct writer, not encode_record_batch.
"""

from __future__ import annotations

import asyncio
import gzip
import ssl
import struct
import subprocess
import zlib

import pytest

import fake_kafka as jax_fake
import torch_fake_kafka
from langstream_tpu_torch.runtime.kafka_wire import (
    KafkaProtocolError,
    KafkaSecurity,
    KafkaWireClient,
    ScramClient,
    crc32c,
    decode_record_batches,
    encode_record_batch,
)


#: the two fake brokers a case with a broker runs against
FAKES = {"torch-fake": torch_fake_kafka.FakeKafkaBroker, "jax-fake": jax_fake.FakeKafkaBroker}


def _run(coro):
    return asyncio.run(coro)


# ---------------------------------------------------------------------------
# SCRAM client against the OFFICIAL RFC 7677 SCRAM-SHA-256 test vector
# ---------------------------------------------------------------------------


def test_scram_sha256_rfc7677_vector():
    """user=user password=pencil, fixed nonces: every message byte-exact
    per RFC 7677 §3, and the server signature verifies."""
    c = ScramClient(
        "SCRAM-SHA-256", "user", "pencil", nonce="rOprNGfwEbeRWgbNEkqO"
    )
    assert c.client_first() == b"n,,n=user,r=rOprNGfwEbeRWgbNEkqO"
    server_first = (
        b"r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
        b"s=W22ZaJ0SNY7soEsUEjb6gQ==,i=4096"
    )
    assert c.client_final(server_first) == (
        b"c=biws,r=rOprNGfwEbeRWgbNEkqO%hvYDpWUa2RaTCAfuxFIlj)hNlF$k0,"
        b"p=dHzbZapWIk4jUhN+Ute9ytag9zjfMHgsqmmiz7AndVQ="
    )
    # correct server signature passes, a tampered one fails
    c.verify_server_final(
        b"v=6rriTRBi23WpRR/wtup+mMhUZUn/dB5nLTJRsjl95G4="
    )
    with pytest.raises(KafkaProtocolError, match="server signature"):
        c.verify_server_final(
            b"v=7rriTRBi23WpRR/wtup+mMhUZUn/dB5nLTJRsjl95G4="
        )


def test_scram_rejects_server_nonce_not_extending_client_nonce():
    c = ScramClient("SCRAM-SHA-256", "user", "pencil", nonce="abc")
    with pytest.raises(KafkaProtocolError, match="nonce"):
        c.client_final(b"r=XYZdifferent,s=c2FsdA==,i=4096")


def test_scram_username_escaping():
    c = ScramClient("SCRAM-SHA-256", "a=b,c", "pw", nonce="n1")
    assert c.client_first() == b"n,,n=a=3Db=2Cc,r=n1"


# ---------------------------------------------------------------------------
# property parsing (the reference's instance style)
# ---------------------------------------------------------------------------


def test_security_from_astra_style_properties():
    sec = KafkaSecurity.from_client_properties({
        "security.protocol": "SASL_SSL",
        "sasl.mechanism": "PLAIN",
        "sasl.jaas.config": (
            'org.apache.kafka.common.security.plain.PlainLoginModule '
            'required username="token" password="AstraCS:fake:secret";'
        ),
    })
    assert sec.protocol == "SASL_SSL"
    assert sec.mechanism == "PLAIN"
    assert sec.username == "token"
    assert sec.password == "AstraCS:fake:secret"
    assert sec.use_tls and sec.use_sasl


def test_empty_endpoint_identification_keeps_chain_verification():
    """The Java-client semantics: an empty algorithm disables only the
    hostname check; the certificate chain is still verified."""
    sec = KafkaSecurity.from_client_properties({
        "security.protocol": "SSL",
        "ssl.endpoint.identification.algorithm": "",
    })
    assert sec.ssl_verify is True
    assert sec.ssl_check_hostname is False
    ctx = sec.build_ssl_context()
    assert ctx.check_hostname is False
    assert ctx.verify_mode == ssl.CERT_REQUIRED


def test_security_plaintext_is_none_and_bad_protocol_raises():
    assert KafkaSecurity.from_client_properties({}) is None
    with pytest.raises(ValueError, match="not supported"):
        KafkaSecurity.from_client_properties(
            {"security.protocol": "KERBEROS"}
        )
    with pytest.raises(ValueError, match="credentials"):
        KafkaSecurity.from_client_properties(
            {"security.protocol": "SASL_PLAINTEXT"}
        )


# ---------------------------------------------------------------------------
# SASL against the fake broker (its SCRAM server side is independent)
# ---------------------------------------------------------------------------


def _client(broker, **sec) -> KafkaWireClient:
    return KafkaWireClient(
        f"127.0.0.1:{broker.port}",
        security=KafkaSecurity(**sec) if sec else None,
    )


async def _roundtrip(client: KafkaWireClient) -> list:
    try:
        await client.create_topic("t", partitions=1)
        await client.produce(
            "t", 0, [(b"k", b"v", [])], timestamp_ms=1
        )
        records, _ = await client.fetch("t", 0, 0)
        return [(r.key, r.value) for r in records]
    finally:
        await client.close()


@pytest.mark.parametrize("mechanism", ["PLAIN", "SCRAM-SHA-256",
                                       "SCRAM-SHA-512"])
@pytest.mark.parametrize("fake", sorted(FAKES))
def test_sasl_roundtrip(fake, mechanism):
    with FAKES[fake](sasl={mechanism: ("alice", "s3cret")}) as broker:
        out = _run(_roundtrip(_client(
            broker, protocol="SASL_PLAINTEXT", mechanism=mechanism,
            username="alice", password="s3cret",
        )))
        assert out == [(b"k", b"v")]


@pytest.mark.parametrize("mechanism", ["PLAIN", "SCRAM-SHA-256"])
@pytest.mark.parametrize("fake", sorted(FAKES))
def test_sasl_wrong_password_rejected(fake, mechanism):
    with FAKES[fake](sasl={mechanism: ("alice", "s3cret")}) as broker:
        client = _client(
            broker, protocol="SASL_PLAINTEXT", mechanism=mechanism,
            username="alice", password="wrong",
        )
        with pytest.raises(KafkaProtocolError,
                           match="SASL|SCRAM|denied|invalid"):
            _run(_roundtrip(client))
        assert broker.auth_failures >= 1


@pytest.mark.parametrize("fake", sorted(FAKES))
def test_unauthenticated_client_is_dropped(fake):
    """A plaintext client against a SASL-required broker: the broker kills
    the connection on the first normal API, like real brokers do."""
    with FAKES[fake](sasl={"PLAIN": ("alice", "s3cret")}) as broker:
        client = _client(broker)  # no security config
        with pytest.raises((ConnectionError, asyncio.IncompleteReadError,
                            OSError)):
            _run(_roundtrip(client))
        assert broker.auth_failures >= 1


@pytest.mark.parametrize("fake", sorted(FAKES))
def test_unsupported_mechanism_lists_supported(fake):
    with FAKES[fake](sasl={"SCRAM-SHA-256": ("a", "b")}) as broker:
        client = _client(
            broker, protocol="SASL_PLAINTEXT", mechanism="PLAIN",
            username="a", password="b",
        )
        with pytest.raises(KafkaProtocolError, match="SCRAM-SHA-256"):
            _run(_roundtrip(client))


# ---------------------------------------------------------------------------
# TLS (self-signed cert via the openssl CLI) + SASL_SSL
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tls_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("kafka_tls")
    cert, key = d / "cert.pem", d / "key.pem"
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", str(key), "-out", str(cert), "-days", "2",
            "-subj", "/CN=127.0.0.1",
            "-addext", "subjectAltName=IP:127.0.0.1",
        ],
        check=True, capture_output=True,
    )
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(str(cert), str(key))
    return server_ctx, str(cert)


@pytest.mark.parametrize("fake", sorted(FAKES))
def test_sasl_ssl_roundtrip(fake, tls_pair):
    server_ctx, cafile = tls_pair
    with FAKES[fake](
        sasl={"PLAIN": ("alice", "s3cret")}, ssl_context=server_ctx
    ) as broker:
        # FULL verification: chain against the generated CA, hostname
        # against the cert's IP SAN — no verification shortcuts
        out = _run(_roundtrip(_client(
            broker, protocol="SASL_SSL", mechanism="PLAIN",
            username="alice", password="s3cret", ssl_cafile=cafile,
        )))
        assert out == [(b"k", b"v")]


@pytest.mark.parametrize("fake", sorted(FAKES))
def test_ssl_only_roundtrip(fake, tls_pair):
    server_ctx, cafile = tls_pair
    with FAKES[fake](ssl_context=server_ctx) as broker:
        out = _run(_roundtrip(_client(
            broker, protocol="SSL", ssl_cafile=cafile,
        )))
        assert out == [(b"k", b"v")]


@pytest.mark.parametrize("fake", sorted(FAKES))
def test_tls_client_rejects_untrusted_cert(fake, tls_pair):
    server_ctx, _ = tls_pair
    with FAKES[fake](ssl_context=server_ctx) as broker:
        client = _client(broker, protocol="SSL")  # system CAs only
        with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
            _run(_roundtrip(client))


# ---------------------------------------------------------------------------
# compressed fetch decode (fixtures hand-built, not via encode_record_batch)
# ---------------------------------------------------------------------------


def _uvarint(v: int) -> bytes:
    """Unsigned LEB128 of the zigzag encoding — written independently of
    Writer.varint."""
    z = (v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1
    out = b""
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _hand_built_batch(codec: int, compress) -> bytes:
    """One-record batch (key=b'K', value=b'hello') with the records section
    run through ``compress``; header laid out field by field with struct."""
    rec = (
        b"\x00"              # attributes
        + _uvarint(0)        # ts delta
        + _uvarint(0)        # offset delta
        + _uvarint(1) + b"K"
        + _uvarint(5) + b"hello"
        + _uvarint(0)        # headers
    )
    records = _uvarint(len(rec)) + rec
    payload = compress(records)
    crc_part = (
        struct.pack(">hiqq", codec, 0, 77, 77)   # attrs, lastOffsetDelta, ts
        + struct.pack(">qhi", -1, -1, -1)        # producer id/epoch/seq
        + struct.pack(">i", 1)                   # count
        + payload
    )
    return (
        struct.pack(">qi", 0, 4 + 1 + 4 + len(crc_part))
        + struct.pack(">i", -1)
        + b"\x02"
        + struct.pack(">I", crc32c(crc_part))
        + crc_part
    )


def test_fetch_decode_gzip_batch():
    batch = _hand_built_batch(1, gzip.compress)
    recs = decode_record_batches(batch)
    assert [(r.key, r.value, r.timestamp) for r in recs] == [
        (b"K", b"hello", 77)
    ]


def test_fetch_decode_zstd_batch():
    zstandard = pytest.importorskip("zstandard")
    batch = _hand_built_batch(
        4, lambda b: zstandard.ZstdCompressor().compress(b)
    )
    recs = decode_record_batches(batch)
    assert [(r.key, r.value) for r in recs] == [(b"K", b"hello")]


def test_fetch_decode_zstd_streaming_frame_without_content_size():
    """zstd-jni (the Java producer) streams frames WITHOUT the content-size
    header field; the decoder must not rely on it."""
    import io

    zstandard = pytest.importorskip("zstandard")

    def stream_compress(b: bytes) -> bytes:
        buf = io.BytesIO()
        with zstandard.ZstdCompressor().stream_writer(
            buf, closefd=False
        ) as w:
            w.write(b)
        data = buf.getvalue()
        # sanity: the one-shot API indeed refuses this frame
        with pytest.raises(zstandard.ZstdError):
            zstandard.ZstdDecompressor().decompress(data)
        return data

    recs = decode_record_batches(_hand_built_batch(4, stream_compress))
    assert [(r.key, r.value) for r in recs] == [(b"K", b"hello")]


def test_jaas_escaped_credentials_are_unescaped():
    sec = KafkaSecurity.from_client_properties({
        "security.protocol": "SASL_PLAINTEXT",
        "sasl.mechanism": "PLAIN",
        "sasl.jaas.config": (
            'PlainLoginModule required username="al\\"ice" '
            'password="p\\\\w\\"d";'
        ),
    })
    assert sec.username == 'al"ice'
    assert sec.password == 'p\\w"d'



def test_fetch_decode_snappy_batch_pure_python():
    """Snappy batches decode without python-snappy: the pure-Python
    raw-block decoder in kafka_wire handles them (no more error path
    naming a missing library)."""
    from test_kafka_wire import _raw_literal

    batch = _hand_built_batch(2, _raw_literal)
    recs = decode_record_batches(batch)
    assert [(r.key, r.value) for r in recs] == [(b"K", b"hello")]


@pytest.mark.parametrize("fake", sorted(FAKES))
def test_gzip_produce_roundtrip_through_independent_server_parse(fake):
    """Produce with gzip: the fake broker's own parser (stdlib gzip, own
    field walk) must recover the records, and a fetch returns them."""
    records = [(b"k1", b"v1" * 100, [("h", b"x")]), (None, b"v2", [])]
    batch = encode_record_batch(records, base_timestamp=5, compression="gzip")
    # sanity: the batch really is compressed (bit 0 of attributes)
    parsed = FAKES[fake]._parse_batches(batch)
    assert parsed == [
        (5, b"k1", b"v1" * 100, [("h", b"x")]), (5, None, b"v2", []),
    ]

    with FAKES[fake]() as broker:
        async def main():
            client = KafkaWireClient(f"127.0.0.1:{broker.port}")
            try:
                await client.create_topic("t", partitions=1)
                await client.produce(
                    "t", 0, records, timestamp_ms=5, compression="gzip"
                )
                out, _ = await client.fetch("t", 0, 0)
                return [(r.key, r.value) for r in out]
            finally:
                await client.close()

        assert _run(main()) == [(b"k1", b"v1" * 100), (None, b"v2")]


def test_gzip_compress_helper_is_real_gzip():
    from langstream_tpu_torch.runtime.kafka_wire import _gzip_compress

    data = b"payload " * 64
    assert gzip.decompress(_gzip_compress(data)) == data
    assert zlib.decompress(_gzip_compress(data), 16 + zlib.MAX_WBITS) == data


@pytest.mark.parametrize("fake", sorted(FAKES))
def test_sasl_reconnect_reauthenticates(fake):
    """After the broker drops an idle connection the redial must re-run
    SASL, not resume unauthenticated (call() drops the conn on EOF)."""
    with FAKES[fake](sasl={"PLAIN": ("alice", "s3cret")}) as broker:
        async def main():
            client = _client(
                broker, protocol="SASL_PLAINTEXT", mechanism="PLAIN",
                username="alice", password="s3cret",
            )
            try:
                await client.create_topic("t", partitions=1)
                # sever every connection server-side
                conn = client._bootstrap_conn
                conn._writer.close()
                conn._writer = conn._reader = None
                for c in client._conns.values():
                    c._writer.close()
                    c._writer = c._reader = None
                # next call redials + re-authenticates transparently
                await client.produce("t", 0, [(None, b"x", [])],
                                     timestamp_ms=1)
                out, _ = await client.fetch("t", 0, 0)
                return [r.value for r in out]
            finally:
                await client.close()

        assert _run(main()) == [b"x"]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mechanism", ["SCRAM-SHA-256", "SCRAM-SHA-512", "PLAIN"])
def test_the_jax_client_authenticates_on_the_port_fake(mechanism):
    """The JAX package's SASL client against the port's fake broker, whose
    SCRAM server side derives and checks the proof on its own; SaslHandshake
    and SaslAuthenticate come first on every connection."""
    from langstream_tpu.runtime import kafka_wire as jax_wire

    with torch_fake_kafka.FakeKafkaBroker(sasl={mechanism: ("alice", "s3cret")}) as broker:
        client = jax_wire.KafkaWireClient(
            f"127.0.0.1:{broker.port}", security=jax_wire.KafkaSecurity(
                protocol="SASL_PLAINTEXT", mechanism=mechanism, username="alice",
                password="s3cret"))
        assert _run(_roundtrip(client)) == [(b"k", b"v")]
        assert broker.auth_failures == 0
        sasl = {torch_fake_kafka.API_SASL_HANDSHAKE, torch_fake_kafka.API_SASL_AUTHENTICATE}
        for seen in broker.connections:
            keys = [k for k, _ in seen]
            n_sasl = next((i for i, k in enumerate(keys) if k not in sasl), len(keys))
            assert n_sasl >= 2 and not sasl & set(keys[n_sasl:]), keys

