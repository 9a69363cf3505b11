"""The tiered prefix store of the port (``langstream_tpu_torch/serving/
prefixstore.py`` and the engine's demote, promote and hydrate) against the
JAX package.

- The spec, its validation, the storage backends and the store's tier
  mechanics (T1 LRU, the cascade to T2 and hydration, a foreign
  fingerprint refused and deleted, a corrupt blob refused, the T2 budget,
  the pin against shrink, ledger conservation): the cases of
  ``tests/test_prefixstore.py`` run on the port's module. The S3 backend
  runs against an S3-shaped server on localhost; its request signing
  equals the JAX package's.
- Engines on the tiny model with the JAX engine's parameters, f32 and int8
  paged pools: T1-promoted and T2-hydrated greedy tokens equal the port's
  cold run and the JAX engine's; a T2 directory written by a JAX engine
  hydrates in a port engine with identical tokens, and the reverse (two
  replicas sharing one bucket); a hydration timeout is a counted cold
  compute; the pipelined loop under a load that demotes gives the
  sequential loop's tokens.
"""

import asyncio
import datetime
import http.server
import random
import threading
import urllib.parse

import numpy as np
import pytest
import torch

from langstream_tpu.agents import s3_impl as jax_s3
from langstream_tpu.serving import prefixstore as jax_ps
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving import s3
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from langstream_tpu_torch.serving.prefixstore import (
    LocalDiskPrefixStorage,
    PrefixStore,
    PrefixStoreSpec,
    S3PrefixStorage,
    make_prefix_storage,
    prefix_digest_for_text,
    validate_application_prefix_store,
)
from test_torch_engine import flatten_jax_params

FINGERPRINT = {
    "model": "tiny", "dtype": "float32", "kv-quantize": None, "kv-block-size": 16,
    "layers": 2, "kv-heads": 2, "head-dim": 8, "max-seq-len": 256,
}


def _spec_dict(tmp_path=None, **overrides) -> dict:
    d = {"t0-bytes": 0, "t1-bytes": 1 << 20, "t2-rescan-s": 0.1, "hydrate-timeout-s": 5.0}
    if tmp_path is not None:
        d["t2"] = {"type": "local", "path": str(tmp_path)}
    d.update(overrides)
    return d


def _spec(tmp_path=None, **overrides) -> PrefixStoreSpec:
    return PrefixStoreSpec.from_dict(_spec_dict(tmp_path, **overrides))


def _store(tmp_path=None, **overrides) -> PrefixStore:
    return PrefixStore(_spec(tmp_path, **overrides), fingerprint=dict(FINGERPRINT),
                       block_bytes=2048, rows_per_block=16)


def _arrays(seed: int, nbytes: int = 2048) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    half = nbytes // 8
    return {name: torch.from_numpy(rng.standard_normal(half).astype(np.float32))
            for name in ("k", "v")}


# --------------------------------------------------------------------------
# spec and validation
# --------------------------------------------------------------------------

SPECS = [
    None,
    {"t1-bytes": 4096},
    {"enabled": True, "t0-bytes": 1024, "t1-bytes": 4096, "t2-bytes": 1 << 30,
     "t2": {"type": "local", "path": "/tmp/x"}, "hydrate-timeout-s": 2.5,
     "t2-rescan-s": 1.0},
    {"enabled": "false", "t0_bytes": 0, "t2": {"type": "s3", "bucket-name": "b"}},
]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_spec_parses_and_round_trips_as_jax(i):
    d = SPECS[i]
    spec, jax_spec = PrefixStoreSpec.from_dict(d), jax_ps.PrefixStoreSpec.from_dict(d)
    if d is None:
        assert spec is None and jax_spec is None
        return
    assert spec.to_dict() == jax_spec.to_dict()
    assert PrefixStoreSpec.from_dict(spec.to_dict()) == spec
    assert spec.t2_config() == jax_spec.t2_config()


@pytest.mark.parametrize("bad", [
    {"t1-bytes": 0}, {"t0-bytes": -1}, {"t2-bytes": -5}, {"hydrate-timeout-s": 0},
    {"t2-rescan-s": -1}, {"t2": {"type": "ftp"}}, {"t2": "not-a-mapping"},
    {"unknown-key": 1}, "not-a-mapping",
])
def test_spec_validation_rejects_as_jax(bad):
    with pytest.raises(ValueError) as jax_err:
        jax_ps.PrefixStoreSpec.from_dict(bad)
    with pytest.raises(ValueError) as err:
        PrefixStoreSpec.from_dict(bad)
    assert str(err.value) == str(jax_err.value)


def test_validate_application_prefix_store():
    class Res:
        type = "tpu-serving-configuration"

        def __init__(self, conf):
            self.configuration = conf

    class App:
        def __init__(self, conf):
            self.resources = {"tpu": Res(conf)}

    validate_application_prefix_store(App({"prefix-store": None}))
    validate_application_prefix_store(App({"prefix-store": {"t1-bytes": 4096}}))
    with pytest.raises(ValueError, match="prefix-store"):
        validate_application_prefix_store(App({"prefix-store": {"t1-bytes": -1}}))


def test_serving_config_parses_prefix_store_and_validates_as_jax(tmp_path):
    d = {"model": "tiny", "slots": 1, "max-seq-len": 64, "kv-layout": "paged",
         "kv-block-size": 16, "prefix-store": _spec_dict(tmp_path)}
    cfg = ServingConfig.from_dict(d)
    assert isinstance(cfg.prefix_store, PrefixStoreSpec)
    assert cfg.prefix_store.to_dict() == JaxServingConfig.from_dict(d).prefix_store.to_dict()
    hash(cfg)  # the config stays hashable (get_or_create keys on it)
    with pytest.raises(ValueError, match="kv-layout=paged"):
        TorchServingEngine(ServingConfig(model="tiny", slots=1, max_seq_len=64,
                                         prefix_store=_spec()), device="cpu")
    with pytest.raises(ValueError, match="prefix-cache"):
        TorchServingEngine(ServingConfig(model="tiny", slots=1, max_seq_len=64,
                                         kv_layout="paged", kv_block_size=16,
                                         prefix_cache=False, prefix_store=_spec()),
                           device="cpu")
    # a disabled store is accepted anywhere and builds no store
    off = TorchServingEngine(ServingConfig(model="tiny", slots=1, max_seq_len=64,
                                           prefix_store=_spec(enabled=False)), device="cpu")
    assert off.prefix_store is None and "prefixstore" not in off.stats()


# --------------------------------------------------------------------------
# storage backends
# --------------------------------------------------------------------------


def test_local_disk_storage_roundtrip(tmp_path):
    storage = LocalDiskPrefixStorage(tmp_path)
    assert storage.get("aa11") is None
    storage.put("aa11", b"payload-1")
    storage.put("bb22", b"payload-2")
    assert storage.get("aa11") == b"payload-1"
    assert storage.list_keys() == ["aa11", "bb22"]
    storage.delete("aa11")
    assert storage.get("aa11") is None
    assert storage.list_keys() == ["bb22"]
    for bad in ("", "a/b", "..", "a.b"):
        with pytest.raises(ValueError):
            storage.put(bad, b"x")
    # the JAX package's backend reads the same files
    assert jax_ps.LocalDiskPrefixStorage(tmp_path).list_keys() == ["bb22"]


def test_make_prefix_storage_factory(tmp_path):
    assert make_prefix_storage(None) is None
    assert make_prefix_storage({}) is None
    assert isinstance(make_prefix_storage({"type": "local", "path": str(tmp_path)}),
                      LocalDiskPrefixStorage)
    with pytest.raises(ValueError):
        make_prefix_storage({"type": "local"})  # no path
    with pytest.raises(ValueError):
        make_prefix_storage({"type": "gcs"})


def test_sigv4_and_list_parsing_equal_jax():
    now = datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=datetime.timezone.utc)
    for method, url, payload in [
        ("GET", "http://127.0.0.1:9000/bucket?list-type=2&prefix=prefix-kv%2F", b""),
        ("PUT", "http://127.0.0.1:9000/bucket/prefix-kv/ab12.kvp", b"blob"),
        ("DELETE", "https://s3.us-east-1.amazonaws.com/b/k%20x", b""),
    ]:
        kw = dict(access_key="AK", secret_key="SK", region="eu-west-1", payload=payload, now=now)
        assert s3.sigv4_headers(method, url, **kw) == jax_s3.sigv4_headers(method, url, **kw)
    body = (b'<?xml version="1.0"?><ListBucketResult xmlns="http://s3.amazonaws.com/doc/'
            b'2006-03-01/"><Contents><Key>prefix-kv/aa.kvp</Key><Size>12</Size></Contents>'
            b'<NextContinuationToken>tok</NextContinuationToken></ListBucketResult>')
    assert s3._parse_list_objects(body) == jax_s3._parse_list_objects(body)


class _FakeS3(http.server.BaseHTTPRequestHandler):
    """The slice of the S3 REST surface the backend speaks: bucket HEAD/PUT,
    object PUT/GET/DELETE and ListObjectsV2 (one page), kept in memory."""

    objects: dict = {}
    buckets: set = set()

    def log_message(self, *args):
        pass

    def _reply(self, status: int, body: bytes = b"") -> None:
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body and self.command != "HEAD":
            self.wfile.write(body)

    def _split(self):
        url = urllib.parse.urlsplit(self.path)
        bucket, _, key = url.path.lstrip("/").partition("/")
        return bucket, urllib.parse.unquote(key), urllib.parse.parse_qs(url.query)

    def do_HEAD(self):
        bucket, _, _ = self._split()
        self._reply(200 if bucket in self.buckets else 404)

    def do_PUT(self):
        bucket, key, _ = self._split()
        data = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        if key:
            self.objects[(bucket, key)] = data
        else:
            self.buckets.add(bucket)
        self._reply(200)

    def do_GET(self):
        bucket, key, query = self._split()
        if key:
            data = self.objects.get((bucket, key))
            self._reply(200, data) if data is not None else self._reply(404, b"NoSuchKey")
            return
        prefix = query.get("prefix", [""])[0]
        items = "".join(
            f"<Contents><Key>{k}</Key><Size>{len(v)}</Size></Contents>"
            for (b, k), v in sorted(self.objects.items()) if b == bucket and k.startswith(prefix))
        self._reply(200, f"<ListBucketResult>{items}</ListBucketResult>".encode())

    def do_DELETE(self):
        bucket, key, _ = self._split()
        self.objects.pop((bucket, key), None)
        self._reply(204)


def test_s3_backend_against_a_local_s3_server(tmp_path):
    """The S3 backend puts, lists, gets and deletes blobs, and a store over
    it cascades and hydrates as over local disk."""
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _FakeS3)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    t2 = {"type": "s3", "endpoint": f"http://127.0.0.1:{server.server_address[1]}",
          "bucket-name": "prefix-bucket", "access-key": "AK", "secret-key": "SK"}
    try:
        storage = make_prefix_storage(t2)
        assert isinstance(storage, S3PrefixStorage)
        storage.put("aa11", b"payload")
        assert "prefix-bucket" in _FakeS3.buckets
        assert storage.list_keys() == ["aa11"] and storage.get("aa11") == b"payload"
        storage.delete("aa11")
        assert storage.get("aa11") is None and storage.list_keys() == []
        store = PrefixStore(_spec(None, **{"t1-bytes": 1, "t2": t2}),
                            fingerprint=dict(FINGERPRINT), block_bytes=2048, rows_per_block=16)
        other = None
        try:
            store.insert_t1("d1", "", _arrays(1))
            assert store.flush(10)
            store.apply_results()
            assert store.t2_has("d1") and store.t2_bytes == 2048
            # a second replica's first scan finds the blob
            other = PrefixStore(_spec(None, **{"t2": t2}), fingerprint=dict(FINGERPRINT),
                                block_bytes=2048, rows_per_block=16)
            assert other.flush(10)
            other.apply_results()
            assert other.request_hydration(["d1"]) == 1
            assert other.flush(10)
            other.apply_results()
            got = other.take_t1("d1")
            torch.testing.assert_close(got["arrays"]["k"], _arrays(1)["k"], rtol=0, atol=0)
        finally:
            store.close()
            if other is not None:
                other.close()
    finally:
        server.shutdown()
        server.server_close()


# --------------------------------------------------------------------------
# the store's tier mechanics
# --------------------------------------------------------------------------


def test_t1_insert_take_and_lru_eviction_without_t2():
    store = _store(None, **{"t1-bytes": 5000})  # room for two 2 KB entries
    store.insert_t1("d1", "", _arrays(1))
    store.insert_t1("d2", "d1", _arrays(2))
    assert store.t1_has("d1") and store.t1_has("d2")
    store.insert_t1("d3", "d2", _arrays(3))  # d1 (LRU) evicts, counted
    assert not store.t1_has("d1")
    assert store.evictions == 1 and store.evicted_bytes == 2048
    events = dict(store.drain_events())
    assert events.get("prefix-evict", {}).get("reason") == "t1-budget"
    entry = store.take_t1("d2")
    assert entry is not None and entry["parent"] == "d1"
    assert store.take_t1("d2") is None
    assert store.t1_hits == 1 and store.t1_misses == 1
    assert store.t1_bytes == 2048
    store.close()


def test_demotion_cascade_to_t2_and_hydration(tmp_path):
    store = _store(tmp_path, **{"t1-bytes": 1})
    store.insert_t1("d1", "", _arrays(1))
    store.insert_t1("d2", "d1", _arrays(2))
    assert store.flush(10)
    store.apply_results()
    assert store.t2_has("d1") and store.t2_has("d2")
    assert store.t1_bytes == 0 and store.in_transit_bytes == 0
    assert store.t2_bytes == 4096 and store.demotions_t1_t2 == 2
    other = _store(tmp_path, **{"t1-bytes": 1 << 20})  # discovers them by scan
    assert other.flush(10)
    other.apply_results()
    assert other.t2_has("d1") and other.t2_has("d2")
    assert other.request_hydration(["d1", "d2"]) == 2
    assert other.flush(10)
    other.apply_results()
    assert other.t1_has("d1") and other.t1_has("d2")
    assert other.hydrations == 2 and other.hydrate_failures == 0
    got = other.take_t1("d1")
    assert got["parent"] == ""
    torch.testing.assert_close(got["arrays"]["k"], _arrays(1)["k"], rtol=0, atol=0)
    # the JAX package's store reads the port's blobs as one of its replicas
    jax_store = jax_ps.PrefixStore(jax_ps.PrefixStoreSpec.from_dict(_spec_dict(tmp_path)),
                                   fingerprint=dict(FINGERPRINT), block_bytes=2048,
                                   rows_per_block=16)
    assert jax_store.flush(10)
    jax_store.apply_results()
    assert jax_store.request_hydration(["d2"]) == 1
    assert jax_store.flush(10)
    jax_store.apply_results()
    np.testing.assert_array_equal(jax_store.take_t1("d2")["arrays"]["v"], _arrays(2)["v"].numpy())
    for s in (store, other, jax_store):
        s.close()


def test_fingerprint_mismatch_refused_and_deleted(tmp_path):
    store = _store(tmp_path, **{"t1-bytes": 1})
    store.insert_t1("d1", "", _arrays(1))
    assert store.flush(10)
    store.apply_results()
    other = PrefixStore(_spec(tmp_path, **{"t1-bytes": 1 << 20}),
                        fingerprint=dict(FINGERPRINT, **{"kv-block-size": 64}),
                        block_bytes=2048, rows_per_block=64)
    assert other.flush(10)
    other.apply_results()
    assert other.request_hydration(["d1"]) == 1
    assert other.flush(10)
    other.apply_results()
    assert other.fingerprint_refusals == 1
    assert not other.t1_has("d1") and not other.t2_has("d1")
    assert LocalDiskPrefixStorage(tmp_path).get("d1") is None  # gone, not skipped
    store.close()
    other.close()


def test_corrupt_blob_refused(tmp_path):
    storage = LocalDiskPrefixStorage(tmp_path)
    storage.put("feed", b"not a kv payload at all")
    store = _store(tmp_path)
    assert store.flush(10)
    store.apply_results()
    assert store.t2_has("feed")
    store.request_hydration(["feed"])
    assert store.flush(10)
    store.apply_results()
    assert store.hydrate_failures == 1 and not store.t1_has("feed")
    assert storage.get("feed") is None  # deleted, never retried forever
    store.close()


def test_t2_byte_budget_trims_oldest(tmp_path):
    store = _store(tmp_path, **{"t1-bytes": 1, "t2-bytes": 5000})
    for i in range(4):
        store.insert_t1(f"d{i}", "", _arrays(i))
        assert store.flush(10)
        store.apply_results()
    assert store.t2_bytes <= 5000
    assert not store.t2_has("d0") and not store.t2_has("d1")
    assert store.t2_has("d2") and store.t2_has("d3")
    assert store.flush(10)
    assert LocalDiskPrefixStorage(tmp_path).get("d0") is None
    store.close()


def test_hydrated_entries_pinned_against_shrink(tmp_path):
    clock = [0.0]
    store = PrefixStore(_spec(tmp_path, **{"t1-bytes": 1, "hydrate-timeout-s": 5.0}),
                        fingerprint=dict(FINGERPRINT), block_bytes=2048, rows_per_block=16,
                        clock=lambda: clock[0])
    store.insert_t1("d1", "", _arrays(1))
    assert store.flush(10)
    store.apply_results()
    store.request_hydration(["d1"])
    assert store.flush(10)
    store.apply_results()
    assert store.t1_has("d1")  # over the 1-byte budget, but pinned
    clock[0] = 6.0
    store.insert_t1("dx", "", _arrays(9))
    assert not store.t1_has("d1")  # past the pin window it shrinks
    store.close()


def _ledger_balances(ledger: dict) -> bool:
    resident = ledger["t1_bytes"] + ledger["in_transit_bytes"] + ledger["t2_bytes"]
    flows = (ledger["inserted_bytes"] + ledger["discovered_bytes"]
             - ledger["taken_bytes"] - ledger["evicted_bytes"])
    return resident == flows


def test_ledger_conservation_property(tmp_path):
    """T1 + in-transit + T2 bytes sum exactly across a random sequence of
    inserts, takes, hydrations and applied results."""
    rng = random.Random(11)
    store = _store(tmp_path, **{"t1-bytes": 6000, "t2-bytes": 9000})
    digests = [f"p{i:02d}" for i in range(24)]
    for step in range(300):
        op = rng.random()
        d = rng.choice(digests)
        if op < 0.45:
            store.insert_t1(d, "", _arrays(rng.randrange(1000)))
        elif op < 0.65:
            store.take_t1(d)
        elif op < 0.85:
            store.request_hydration([d])
        else:
            store.apply_results()
        if step % 40 == 0:
            store.flush(10)
            store.apply_results()
        ledger = store.ledger()
        assert _ledger_balances(ledger), (step, ledger)
        assert ledger["t1_bytes"] == sum(e["nbytes"] for e in store._t1.values())
        assert ledger["in_transit_bytes"] == sum(e["nbytes"] for e in store._t2_inflight.values())
        assert ledger["t2_bytes"] == sum(store._t2_index.values())
    store.flush(10)
    store.apply_results()
    store.close()


def test_prefix_digest_for_text_equals_jax():
    shared = "s" * 600
    for value in (None, "short", shared + " tail one", shared + " another tail",
                  "x" + shared, 12345, "é" * 700):
        assert prefix_digest_for_text(value) == jax_ps.prefix_digest_for_text(value)
    assert prefix_digest_for_text(shared + " a") == prefix_digest_for_text(shared + " b")


# --------------------------------------------------------------------------
# engines: demote, promote, hydrate
# --------------------------------------------------------------------------

PROMPT = list(range(1, 100))
OPTS = {"max-tokens": 8, "temperature": 0}
ENGINE = {"model": "tiny", "slots": 2, "max-seq-len": 256, "decode-chunk": 4,
          "model-dtype": "float32", "kv-layout": "paged", "kv-block-size": 16,
          "kv-pool-blocks": 48, "prefix-cache": True}


def _cfg(kv, store: dict | None = None, **extra) -> dict:
    cfg = {**ENGINE, "kv-quantize": kv, **extra}
    if store is not None:
        cfg["prefix-store"] = store
    return cfg


async def _drain_tiers(engine, timeout_s: float = 15.0) -> dict:
    """Wait until the demotion cascade has reached T2 (leaf first; the
    chain's head lands last)."""
    for _ in range(int(timeout_s / 0.02)):
        st = engine.stats()["prefixstore"]
        if (st["t0"]["blocks"] == 0 and st["t1"]["entries"] == 0
                and not st["t2"]["in_transit_bytes"] and not st["t2"]["pending_jobs"]):
            return st
        await asyncio.sleep(0.02)
    return engine.stats()["prefixstore"]


def _jax_run(cfg: dict, scenario):
    """``scenario(engine)`` on a JAX engine; (flat params, its result)."""
    async def main():
        engine = TpuServingEngine(JaxServingConfig.from_dict(cfg))
        try:
            return flatten_jax_params(engine.params), await scenario(engine)
        finally:
            await engine.close()
            TpuServingEngine.reset_instances()

    return asyncio.run(main())


def _port_run(cfg: dict, params, scenario):
    async def main():
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu", params=params)
        try:
            result = await scenario(engine)
        finally:
            await engine.close()
        assert engine.block_mgr.stats()["reserved_blocks"] == 0
        return result

    return asyncio.run(main())


def _params(flat):
    return params_from_numpy(flat, device="cpu", dtype=torch.float32)


async def _generate(engine):
    return await engine.generate(PROMPT, dict(OPTS))


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_tier_round_trip_equals_cold_and_jax(tmp_path, kv):
    """Replica A serves once and demotes the prompt's blocks to T2 through
    T1; its second request promotes them back; replica B, a fresh engine on
    the same T2 directory, hydrates them. Greedy tokens and text equal the
    port's cold run (no store) and the JAX engine's."""
    flat, want = _jax_run(_cfg(kv), _generate)
    params = _params(flat)
    cold = _port_run(_cfg(kv), params, _generate)
    assert cold["tokens"] == want["tokens"] and cold["text"] == want["text"]
    store = _spec_dict(tmp_path, **{"t1-bytes": 1})

    async def replica_a(engine):
        first = await _generate(engine)
        await _drain_tiers(engine)
        warm = await _generate(engine)
        st = engine.stats()["prefixstore"]
        assert st["promotions"] >= 1 and st["demotions_t0_t1"] >= 1
        assert st["demotions_t1_t2"] >= 1 and _ledger_balances(st["ledger"])
        kinds = {e["kind"] for e in engine.flight.recent_events(0)}
        assert {"prefix-demote", "prefix-promote"} <= kinds
        return first, warm

    first, warm = _port_run(_cfg(kv, store), params, replica_a)

    async def replica_b(engine):
        assert engine.prefix_store.flush(10)
        out = await _generate(engine)
        st = engine.stats()["prefixstore"]
        assert st["hydrations"] > 0 and st["t1"]["hits"] > 0
        assert engine.prefix_hits >= 1 and engine.prefix_tokens > 0
        return out

    hydrated = _port_run(_cfg(kv, store), params, replica_b)
    for got in (first, warm, hydrated):
        assert got["tokens"] == want["tokens"] and got["text"] == want["text"]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_t2_directory_crosses_packages(tmp_path, kv):
    """One T2 directory shared by a JAX replica and a port replica: blobs
    the JAX engine demoted hydrate in a port engine, and the reverse, with
    the tokens of a cold run."""
    jax_dir, port_dir = tmp_path / "from-jax", tmp_path / "from-port"

    async def writer(engine):
        out = await _generate(engine)
        await _drain_tiers(engine)
        assert engine.stats()["prefixstore"]["t2"]["entries"] > 0
        return out

    async def reader(engine):
        assert engine.prefix_store.flush(10)
        out = await _generate(engine)
        st = engine.stats()["prefixstore"]
        assert st["hydrations"] > 0 and st["fingerprint_refusals"] == 0
        return out

    flat, want = _jax_run(_cfg(kv, _spec_dict(jax_dir, **{"t1-bytes": 1})), writer)
    params = _params(flat)
    port_read = _port_run(_cfg(kv, _spec_dict(jax_dir, **{"t1-bytes": 1})), params, reader)
    port_wrote = _port_run(_cfg(kv, _spec_dict(port_dir, **{"t1-bytes": 1})), params, writer)
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in jax_dir.iterdir())

    # the JAX reader's random init is the writer's (the same seed)
    _, jax_read = _jax_run(_cfg(kv, _spec_dict(port_dir, **{"t1-bytes": 1})), reader)
    for got in (port_read, port_wrote, jax_read):
        assert got["tokens"] == want["tokens"] and got["text"] == want["text"]


def test_hydrate_timeout_falls_back_to_counted_cold_compute(tmp_path):
    """A hydration whose blobs never arrive does not strand the request:
    the stash times out (a counted failure and a ``timeout`` event) and
    the request computes cold, with the cold tokens."""
    store = _spec_dict(tmp_path, **{"t1-bytes": 1})

    async def writer(engine):
        out = await _generate(engine)
        await _drain_tiers(engine)
        return out

    cold = _port_run(_cfg(None, store), None, writer)

    async def starved(engine):
        assert engine.prefix_store.flush(10)
        engine.prefix_store.apply_results()
        # the hydrator stops: no fetch will ever deliver
        engine.prefix_store._jobs.append(("stop",))
        engine.prefix_store._kick.set()
        out = await asyncio.wait_for(_generate(engine), 30)
        events = [e for e in engine.flight.recent_events(0) if e["kind"] == "prefix-hydrate"]
        assert [e["stage"] for e in events] == ["begin", "timeout"]
        st = engine.stats()["prefixstore"]
        assert st["hydrate_failures"] >= 1 and st["hydrations"] == 0
        assert st["t0"]["hits"] == 0  # computed cold
        return out

    got = _port_run(_cfg(None, {**store, "hydrate-timeout-s": 0.3}), None, starved)
    assert got["tokens"] == cold["tokens"]


MIXED = [(list(range(1 + i % 3, 70 + i % 3)) + [200 + i] * (5 + i), 4 + 3 * (i % 4))
         for i in range(10)]


def test_pipelined_loop_with_demotion_equals_sequential(tmp_path, monkeypatch):
    """A mixed load over shared preambles with a small T0 budget (blocks
    demote between bursts and promote at admission): the pipelined loop's
    greedy tokens equal the sequential loop's (``LS_TPU_PIPELINE=0``), one
    fetch per chunk, and the tier ledger balances."""
    cfg = _cfg(None, {"t0-bytes": 6 * 2 * 2 * 16 * 16 * 4, "t1-bytes": 1 << 20},
               **{"slots": 3, "decode-chunk": 8, "decode-chunk-light": 2})

    async def load(engine):
        # every demotion pass must find nothing in flight: no pending chunk,
        # no burst deferring its releases
        real, seen = engine._demote_prefix_blocks, []

        async def demote(loop):
            seen.append((engine._pending_chunk is None, engine._defer_release,
                         list(engine._deferred_releases)))
            return await real(loop)

        engine._demote_prefix_blocks = demote
        results = []
        for wave in (MIXED[:5], MIXED[5:]):
            results += await asyncio.gather(*(
                engine.generate(p, {"max-tokens": n, "temperature": 0}) for p, n in wave))
        await engine.settled()
        assert seen and all(state == (True, False, []) for state in seen), seen
        return [r["tokens"] for r in results], engine.stats()

    pipelined, stats = _port_run(cfg, None, load)
    assert stats["pipeline"] and stats["decode-chunks"]["heavy"] > 0
    assert stats["decode-chunks"]["host_fetches_per_chunk"] == 1.0
    st = stats["prefixstore"]
    assert st["demotions_t0_t1"] > 0 and st["promotions"] > 0
    assert st["t0"]["demote_fetches"] > 0 and _ledger_balances(st["ledger"])
    monkeypatch.setenv("LS_TPU_PIPELINE", "0")
    sequential, seq_stats = _port_run(cfg, None, load)
    assert not seq_stats["pipeline"]
    assert pipelined == sequential


def test_eviction_storm_keeps_the_ledgers_exact(tmp_path):
    """Distinct prompts against tiny budgets under pool pressure: T0 -> T1
    -> T2 with budget trims and organic pool evictions, every byte resident,
    taken or evicted with a counted reason; the memory ledger's prefix
    sub-owner agrees with the block manager."""
    rng = random.Random(3)

    async def storm(engine):
        for _ in range(8):
            base = rng.randrange(1, 200)
            prompt = [((base + j) % 250) + 1 for j in range(90)]
            await engine.generate(prompt, {"max-tokens": 4, "temperature": 0})
        st = await _drain_tiers(engine)
        assert _ledger_balances(st["ledger"]), st["ledger"]
        assert st["demotions_t0_t1"] > 0 and st["demotions_t1_t2"] > 0
        assert st["evictions"] > 0
        memory = engine.stats()["attribution"]["memory"]
        assert memory["kv_pool_prefix_bytes"] == (
            engine.block_mgr.prefix_block_count() * engine._kv_block_bytes)
        return st

    _port_run(_cfg(None, _spec_dict(tmp_path, **{"t1-bytes": 1, "t2-bytes": 24 * 1024})),
              None, storm)
