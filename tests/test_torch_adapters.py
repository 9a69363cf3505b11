"""The multi-LoRA adapter store of the port (``langstream_tpu_torch/serving/
adapters.py``) and ``lora_delta`` (``langstream_tpu_torch/models/llama.py``)
against the JAX package.

- ``lora_delta``: the same seeded inputs through the JAX function and the
  port's, with 2-D and 3-D ``h``, mixed row ids and row 0 giving exactly
  zero; within 1e-5 in f32 and 2e-2 in bf16.
- The store: the cases of ``tests/test_adapters.py`` run on the port's
  module (spec round trip and rejections, application validation, names,
  the wire and its checks, the T0 LRU with pins and refusal, the T1 budget
  evicting without T2 and demoting with it, T2 scan, discovery and
  hydration, the hydrate pin against shrink, a foreign fingerprint refused
  and deleted, the T2 budget trim, ledger conservation), with the JAX
  module beside it where both can run the same case.
- Across packages: the port's ``serialize_adapter`` bytes equal the JAX
  package's for the same factors and fingerprint, and each package's blob
  deserializes in the other.
"""

import random

import numpy as np
import pytest
import torch

from langstream_tpu.models.llama import lora_delta as jax_lora_delta
from langstream_tpu.serving import adapters as jax_ad
from langstream_tpu_torch.models.llama import lora_delta
from langstream_tpu_torch.serving import adapters as ad
from langstream_tpu_torch.serving.adapters import (
    ADAPTER_HEADER,
    BLOB_KIND,
    FACTOR_KEYS,
    AdapterStore,
    AdapterStoreSpec,
    check_adapter_name,
    deserialize_adapter,
    make_lora_arrays,
    publish_adapter,
    serialize_adapter,
    validate_application_adapter_store,
)
from langstream_tpu_torch.serving.kvtransfer import LayoutMismatch

FINGERPRINT = {
    "model": "tiny", "dtype": "float32", "rank": 2, "layers": 1, "hidden": 8,
    "heads": 2, "kv-heads": 1, "head-dim": 4,
}


def _spec_dict(tmp_path=None, **overrides) -> dict:
    d = {"rank": 2, "t0-entries": 2, "t1-bytes": 1 << 20, "hydrate-timeout-s": 5.0,
         "t2-rescan-s": 0.1}
    if tmp_path is not None:
        d["t2"] = {"type": "local", "path": str(tmp_path)}
    d.update(overrides)
    return d


def _store(tmp_path=None, clock=None, module=ad, **overrides):
    kwargs = {} if clock is None else {"clock": clock}
    return module.AdapterStore(module.AdapterStoreSpec.from_dict(_spec_dict(tmp_path, **overrides)),
                               fingerprint=dict(FINGERPRINT), entry_bytes=4096, **kwargs)


def _arrays(seed: int) -> dict[str, np.ndarray]:
    """A tiny factor set matching FINGERPRINT (one layer, rank 2)."""
    return make_lora_arrays(layers=1, hidden=8, heads=2, kv_heads=1, head_dim=4, rank=2,
                            seed=seed)


def _nbytes(arrays) -> int:
    return int(sum(a.nbytes for a in arrays.values()))


def _conserved(store) -> bool:
    ledger = store.ledger()
    resident = ledger["t1_bytes"] + ledger["in_transit_bytes"] + ledger["t2_bytes"]
    return resident == (ledger["inserted_bytes"] + ledger["discovered_bytes"]
                        - ledger["evicted_bytes"])


def _settle(store, timeout_s: float = 10.0) -> None:
    assert store.flush(timeout_s)
    store.apply_results()


# --------------------------------------------------------------------------
# lora_delta
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), ("bfloat16", 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_lora_delta_equals_jax(ndim, dtype, tol):
    import jax.numpy as jnp

    rng = np.random.default_rng(5 + ndim)
    n_rows, d_in, rank, d_out, B, P = 4, 24, 3, 20, 6, 5
    a = rng.standard_normal((n_rows, d_in, rank)).astype(np.float32)
    b = rng.standard_normal((n_rows, rank, d_out)).astype(np.float32) * 0.5
    a[0] = 0.0
    b[0] = 0.0
    h = rng.standard_normal((B, d_in) if ndim == 2 else (B, P, d_in)).astype(np.float32)
    ids = np.array([0, 2, 1, 0, 3, 2], dtype=np.int32)
    if dtype == "bfloat16":
        tdt, jdt = torch.bfloat16, jnp.bfloat16
    else:
        tdt, jdt = torch.float32, jnp.float32
    want = np.asarray(jax_lora_delta(jnp.asarray(h, jdt), jnp.asarray(ids), jnp.asarray(a, jdt),
                                     jnp.asarray(b, jdt)).astype(jnp.float32))
    got = lora_delta(torch.from_numpy(h).to(tdt), torch.from_numpy(ids),
                     torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got = got.to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    # row 0 is the base model: an exact zero, not a small number
    assert not got[ids == 0].any()
    assert got[ids != 0].any()


def test_lora_delta_int64_ids_and_single_adapter_is_the_dense_product():
    """The engine uploads int64 ids; one adapter for every row is the plain
    ``h @ A @ B``."""
    g = torch.Generator().manual_seed(2)
    a = torch.randn(3, 16, 4, generator=g)
    b = torch.randn(3, 4, 12, generator=g)
    h = torch.randn(5, 7, 16, generator=g)
    ids = torch.full((5,), 2, dtype=torch.int64)
    torch.testing.assert_close(lora_delta(h, ids, a, b), h @ a[2] @ b[2], atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# spec, validation, names
# --------------------------------------------------------------------------

SPECS = [
    None,
    {},
    {"enabled": True, "rank": 16, "t0-entries": 8, "t1-bytes": 4096, "t2-bytes": 1 << 30,
     "t2": {"type": "local", "path": "/tmp/x"}, "hydrate-timeout-s": 2.5, "t2-rescan-s": 1.0},
    {"enabled": "false", "rank": 4, "t0_entries": 2, "t2": {"type": "s3", "bucket-name": "b"}},
]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_spec_parses_and_round_trips_as_jax(i):
    d = SPECS[i]
    spec, jax_spec = AdapterStoreSpec.from_dict(d), jax_ad.AdapterStoreSpec.from_dict(d)
    if d is None:
        assert spec is None and jax_spec is None
        return
    assert spec.to_dict() == jax_spec.to_dict()
    assert AdapterStoreSpec.from_dict(spec.to_dict()) == spec
    assert spec.t2_config() == jax_spec.t2_config()
    if not d:  # the defaults
        assert spec.rank == 8 and spec.t0_entries == 4
        assert spec.hydrate_timeout_s == 5.0 and spec.t2_config() is None


@pytest.mark.parametrize("bad", [
    {"rank": 0}, {"t0-entries": 0}, {"t1-bytes": 0}, {"t2-bytes": -5},
    {"hydrate-timeout-s": 0}, {"t2-rescan-s": -1}, {"t2": {"type": "ftp"}},
    {"t2": "not-a-mapping"}, {"unknown-key": 1}, "not-a-mapping",
])
def test_spec_validation_rejects_as_jax(bad):
    with pytest.raises(ValueError) as jax_err:
        jax_ad.AdapterStoreSpec.from_dict(bad)
    with pytest.raises(ValueError) as err:
        AdapterStoreSpec.from_dict(bad)
    assert str(err.value) == str(jax_err.value)


def test_validate_application_adapter_store():
    class Res:
        type = "tpu-serving-configuration"

        def __init__(self, conf):
            self.configuration = conf

    class App:
        def __init__(self, conf):
            self.resources = {"tpu": Res(conf)}

    validate_application_adapter_store(App({"adapter-store": None}))
    validate_application_adapter_store(App({"adapter-store": {"rank": 4, "t0-entries": 2}}))
    with pytest.raises(ValueError, match="adapter-store"):
        validate_application_adapter_store(App({"adapter-store": {"rank": -1}}))


@pytest.mark.parametrize("name", ["", "a/b", "a b", "a\nb", "x" * 121, None])
def test_check_adapter_name_rejects_as_jax(name):
    with pytest.raises(ValueError) as jax_err:
        jax_ad.check_adapter_name(name)
    with pytest.raises(ValueError) as err:
        check_adapter_name(name)
    assert str(err.value) == str(jax_err.value)


def test_constants_and_good_names_equal_jax():
    assert check_adapter_name("tenant-a-v3") == "tenant-a-v3"
    assert (BLOB_KIND, ADAPTER_HEADER, FACTOR_KEYS) == (
        jax_ad.BLOB_KIND, jax_ad.ADAPTER_HEADER, jax_ad.FACTOR_KEYS)
    for seed in (0, 3):
        kw = dict(layers=2, hidden=8, heads=2, kv_heads=1, head_dim=4, rank=2, seed=seed,
                  scale=0.5)
        mine, theirs = make_lora_arrays(**kw), jax_ad.make_lora_arrays(**kw)
        assert list(mine) == list(theirs)
        for k in FACTOR_KEYS:
            np.testing.assert_array_equal(mine[k], theirs[k])


# --------------------------------------------------------------------------
# the wire
# --------------------------------------------------------------------------


def test_wire_roundtrip_and_checks():
    arrays = _arrays(1)
    blob = serialize_adapter("a1", arrays, FINGERPRINT)
    back = deserialize_adapter(blob, "a1", FINGERPRINT)
    assert set(back) == set(FACTOR_KEYS)
    for k in FACTOR_KEYS:
        assert isinstance(back[k], np.ndarray) and back[k].flags.writeable
        np.testing.assert_array_equal(back[k], arrays[k])
    with pytest.raises(LayoutMismatch, match="does not match"):
        deserialize_adapter(blob, "a2", FINGERPRINT)
    with pytest.raises(LayoutMismatch, match="rank"):
        deserialize_adapter(blob, "a1", {**FINGERPRINT, "rank": 4})
    partial = {k: v for k, v in arrays.items() if k != "wo_b"}
    with pytest.raises(LayoutMismatch, match="missing factors"):
        deserialize_adapter(serialize_adapter("a1", partial, FINGERPRINT), "a1", FINGERPRINT)
    # a prefix-block blob (another kind on the same wire) is refused
    from langstream_tpu_torch.serving.kvtransfer import serialize_handoff

    other = serialize_handoff({"kind": "prefix-block", "name": "a1"}, dict(arrays))
    with pytest.raises(LayoutMismatch, match="not a lora-adapter blob"):
        deserialize_adapter(other, "a1", FINGERPRINT)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_blob_bytes_equal_jax_and_cross(writer):
    """The port's blob is byte for byte the JAX package's for the same
    factors and fingerprint, and each side reads the other's."""
    arrays = make_lora_arrays(layers=2, hidden=8, heads=2, kv_heads=1, head_dim=4, rank=2,
                              seed=9, scale=0.5)
    fp = {**FINGERPRINT, "layers": 2}
    mine = serialize_adapter("shared-v1", arrays, fp)
    theirs = jax_ad.serialize_adapter("shared-v1", arrays, fp)
    assert mine == theirs
    blob = theirs if writer == "jax" else mine
    reader = ad if writer == "jax" else jax_ad
    back = reader.deserialize_adapter(blob, "shared-v1", fp)
    for k in FACTOR_KEYS:
        np.testing.assert_array_equal(np.asarray(back[k]), arrays[k])


def test_bf16_factors_cross_the_wire_as_raw_words():
    """A blob of bf16 factors (numpy has no bf16: the JAX package writes
    ml_dtypes arrays) reads back as CPU bf16 tensors with the JAX bytes."""
    import ml_dtypes

    arrays = _arrays(4)
    fp = {**FINGERPRINT, "dtype": "bfloat16"}
    jax_blob = jax_ad.serialize_adapter(
        "bf", {k: v.astype(ml_dtypes.bfloat16) for k, v in arrays.items()}, fp)
    back = deserialize_adapter(jax_blob, "bf", fp)
    for k in FACTOR_KEYS:
        assert back[k].dtype == torch.bfloat16
        want = torch.from_numpy(arrays[k]).to(torch.bfloat16)
        assert torch.equal(back[k], want)
    assert serialize_adapter("bf", back, fp) == jax_blob


# --------------------------------------------------------------------------
# tier mechanics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("module", [ad, jax_ad], ids=["port", "jax"])
def test_t0_row_lru_pin_and_refusal(module):
    store = _store(module=module)  # 2 device rows, no T2
    for name, seed in (("a", 1), ("b", 2), ("c", 3)):
        store.install(name, _arrays(seed))
    ra, rb = store.t0_assign("a"), store.t0_assign("b")
    assert {ra, rb} == {1, 2}  # row 0 is the zeros row
    assert store.t0_row("a") == ra  # LRU bump: "b" is the victim
    rc = store.t0_assign("c")
    assert rc == rb and store.t0_evictions == 1
    assert sorted(store.t0_resident()) == ["a", "c"]
    store.pin("a")
    store.pin("c")
    assert store.t0_assign("b") is None and store.eviction_refusals == 1
    store.unpin("c")
    assert store.t0_assign("b") == rc
    assert store.pinned("a") == 1 and store.pinned("c") == 0
    assert [k for k, _ in store.drain_events()].count("adapter-evict") == 2
    assert _conserved(store)


def test_t1_budget_evicts_without_t2_demotes_with(tmp_path):
    per = _nbytes(_arrays(1))
    store = _store(**{"t1-bytes": per + per // 2})
    store.install("a", _arrays(1))
    store.install("b", _arrays(2))
    assert store.t1_has("b") and not store.t1_has("a")
    assert store.evictions == 1 and store.evicted_bytes == per
    assert ("adapter-evict", {"tier": "t1", "adapter": "a", "bytes": per,
                              "reason": "t1-budget"}) in store.drain_events()
    assert _conserved(store)

    store2 = _store(tmp_path, **{"t1-bytes": per + per // 2})
    store2.install("a", _arrays(1))
    store2.install("b", _arrays(2))
    _settle(store2)
    assert store2.demotions_t1_t2 == 1
    assert store2.t2_has("a") and store2.t2_bytes == per
    assert store2.in_transit_bytes == 0 and store2.evictions == 0
    assert _conserved(store2)
    # the demoted blob is the JAX package's byte for byte
    assert (tmp_path / "a.kvp").read_bytes() == jax_ad.serialize_adapter(
        "a", _arrays(1), FINGERPRINT)
    store2.close()


def test_t2_scan_discovery_and_hydration(tmp_path):
    jax_ad.publish_adapter({"type": "local", "path": str(tmp_path)}, "pub", _arrays(9),
                           FINGERPRINT)  # another replica (the JAX package) publishes
    store = _store(tmp_path)
    _settle(store)  # the initial scan
    assert store.known("pub") and store.t2_has("pub")
    ledger = store.ledger()
    assert ledger["t2_bytes"] == 0 and ledger["discovered_bytes"] == 0
    assert store.request_hydration(["pub"]) == 1
    _settle(store)
    assert store.t1_has("pub")
    per = _nbytes(_arrays(9))
    ledger = store.ledger()
    assert ledger["discovered_bytes"] == per and ledger["t2_bytes"] == per
    assert store.hydrations == 1 and store.t2_hits == 1
    for k in FACTOR_KEYS:
        np.testing.assert_array_equal(store.t1_peek("pub")["arrays"][k], _arrays(9)[k])
    assert "adapter-hydrate" in [k for k, _ in store.drain_events()]
    assert _conserved(store)
    assert store.request_hydration(["nope"]) == 0
    store.close()


def test_hydrated_entries_pinned_against_shrink(tmp_path):
    now = [1000.0]
    per = _nbytes(_arrays(1))
    store = _store(tmp_path, clock=lambda: now[0],
                   **{"t1-bytes": per + per // 2, "hydrate-timeout-s": 5.0})
    publish_adapter({"type": "local", "path": str(tmp_path)}, "hyd", _arrays(3), FINGERPRINT)
    store._jobs.append(("scan",))
    store._kick.set()
    _settle(store)
    store.request_hydration(["hyd"])
    _settle(store)
    assert store.t1_has("hyd")
    store.install("loc", _arrays(4))  # over budget: the install is the victim
    assert store.t1_has("hyd")
    now[0] += 6.0  # past the window the hydrated entry shrinks away
    store.install("loc2", _arrays(5))
    store._shrink_t1()
    assert not store.t1_has("hyd")
    _settle(store)
    assert _conserved(store)
    store.close()


def test_fingerprint_mismatch_refused_and_deleted(tmp_path):
    publish_adapter({"type": "local", "path": str(tmp_path)}, "bad", _arrays(2),
                    {**FINGERPRINT, "rank": 64})
    store = _store(tmp_path)
    _settle(store)
    assert store.t2_has("bad")
    store.request_hydration(["bad"])
    _settle(store)
    assert not store.t1_has("bad")
    assert store.fingerprint_refusals == 1 and store.hydrate_failures == 1
    assert not store.t2_has("bad")
    refusal = [d for k, d in store.drain_events()
               if k == "adapter-evict" and "fingerprint" in d.get("reason", "")]
    assert refusal and refusal[0]["adapter"] == "bad"
    assert not (tmp_path / "bad.kvp").exists()  # deleted from the origin
    store._jobs.append(("scan",))
    store._kick.set()
    _settle(store)
    assert not store.known("bad")
    assert _conserved(store)
    store.close()


def test_t2_byte_budget_trims_oldest(tmp_path):
    per = _nbytes(_arrays(1))
    store = _store(tmp_path, **{"t1-bytes": per + per // 2, "t2-bytes": per + per // 2})
    for name, seed in (("a", 1), ("b", 2), ("c", 3)):
        store.install(name, _arrays(seed))
        _settle(store)
    assert store.demotions_t1_t2 == 2
    assert store.t2_bytes <= per + per // 2 and store.evictions >= 1
    assert [d for k, d in store.drain_events()
            if k == "adapter-evict" and d.get("reason") == "t2-budget"]
    assert _conserved(store)
    store.close()


@pytest.mark.parametrize("seed", [7, 8])
def test_ledger_conservation_property(tmp_path, seed):
    """Random install/assign/hydrate/pin sequences keep ``t1 + in_transit
    + t2 == inserted + discovered - evicted`` exact at every settle."""
    rng = random.Random(seed)
    per = _nbytes(_arrays(0))
    store = _store(tmp_path, **{"t1-bytes": int(per * 2.5), "t2-bytes": per * 3})
    names = [f"ad-{i}" for i in range(8)]
    for i in (6, 7):
        publish_adapter({"type": "local", "path": str(tmp_path)}, names[i], _arrays(100 + i),
                        FINGERPRINT)
    store._jobs.append(("scan",))
    store._kick.set()
    for _ in range(60):
        op = rng.randrange(5)
        name = rng.choice(names)
        if op == 0:
            store.install(name, _arrays(sum(map(ord, name)) % 997))
        elif op == 1:
            store.t0_assign(name)
        elif op == 2:
            store.request_hydration([name])
        elif op == 3:
            store.pin(name) if rng.random() < 0.5 else store.unpin(name)
        else:
            _settle(store)
            assert _conserved(store)
    _settle(store)
    assert _conserved(store)
    assert store.ledger()["t0_bytes"] == len(store.t0_resident()) * 4096
    store.drain_events()
    store.close()


def test_stats_keys_equal_jax(tmp_path):
    mine, theirs = _store(tmp_path), _store(tmp_path, module=jax_ad)
    try:
        for store in (mine, theirs):
            store.install("a", _arrays(1))
            store.t0_assign("a")
            _settle(store)
        a, b = mine.stats(), theirs.stats()
        assert a.keys() == b.keys()
        for k in ("t0", "t1", "t2", "ledger"):
            assert a[k].keys() == b[k].keys()
        assert a["ledger"] == b["ledger"] and a["t0"] == b["t0"]
    finally:
        mine.close()
        theirs.close()
