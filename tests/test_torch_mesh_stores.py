"""The tiered stores and the pool roles under a mesh: the port's gloo ranks
on the CPU against the JAX engine under the same mesh on the 8 virtual
devices.

The port runs one process per rank, so every tier move is replayed on
every rank (``serving/lockstep.py``'s ``kv_gather``, ``kv_scatter`` and
``adapter_row`` frames) and the rows go through the mesh's collectives,
each rank holding its KV heads and its share of every adapter factor.
The engines start their other ranks themselves (``LOCAL_WORLD_SIZE``, as
in ``tests/test_torch_launch.py``) and are built through
``TorchServiceProvider``; the model is ``tiny`` f32 on the HF fixture,
whose 2 KV heads split over ``tp: 2``. Greedy tokens and text are
compared exactly, rows within 1e-5.

- Prefix tiers at ``{tp: 2}`` and ``{dp: 2, tp: 2}``: the first,
  T1-promoted and T2-hydrated streams equal the JAX engine's, the tier
  moves are counted on every rank, and each rank's pool rows after the
  promotion equal its rows at the demotion (``LS_TORCH_TIER_DIGESTS``);
  at ``{tp: 2}`` a T2 directory written by either package is read by the
  other.
- Adapters at ``{tp: 2}`` and ``{dp: 2, tp: 2}``: a wave mixed across
  base and three adapters on two T0 rows gives the JAX engine's tokens,
  evicting and loading rows on every rank.
- Pool roles at ``{tp: 2}``, one engine at a time: port prefill to JAX
  decode, JAX prefill to port decode, port prefill at tp=2 to port decode
  at tp=1 through the pod's two functions; the tokens equal a combined
  engine's, the exported rows the JAX export's with an equal fingerprint.
- The rows by heads: each rank's share of a pool, assembled, is the whole
  pool's rows, and a scatter keeps each rank's heads.
- The new frames round-trip; a follower killed during a demotion breaks
  the group and ``close()`` names its exit code; ``adapter-store`` on a
  slice of several hosts is still refused in the JAX engine's words.
"""

import asyncio
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig, TpuServingEngine
from langstream_tpu_torch.agents.provider import TorchServiceProvider
from langstream_tpu_torch.parallel import launch
from langstream_tpu_torch.serving import engine as port_engine, kvtransfer
from langstream_tpu_torch.serving.adapters import make_lora_arrays
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine, _check_supported
from langstream_tpu_torch.serving.lockstep import decode_descriptor, encode_descriptor

FIXTURES = Path(__file__).parent / "fixtures"
PAGED = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 128,
         "decode-chunk": 4, "checkpoint": str(FIXTURES / "llama_tiny_golden"),
         "kv-layout": "paged", "kv-block-size": 16, "kv-pool-blocks": 48}
MESHES = {"tp2": {"tp": 2}, "dp2tp2": {"dp": 2, "tp": 2}}
PROMPT = list(range(1, 100))
PROMPTS = ["hello tpu world", "a slice of two pods", "abcdefgh, ijklmnop", "q"]
OPTS = {"max-tokens": 8, "temperature": 0}


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    """Every wait of a world within 30 s; every test ends with no world
    and no shared engine left."""
    monkeypatch.setenv("LS_TORCH_COLLECTIVE_TIMEOUT_S", "30")
    monkeypatch.delenv("LS_SLICE_HOSTS", raising=False)
    yield
    TorchServingEngine.reset_instances()
    TpuServingEngine.reset_instances()
    assert launch._WORLD is None, "a test left its world up"


def _ranks(monkeypatch, mesh: dict) -> None:
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(int(np.prod(list(mesh.values())))))


def _port(cfg: dict, scenario):
    """``scenario(engine)`` on the provider's engine for ``cfg``, closed in
    its loop; returns the result and the engine (its mesh section then
    holds every started rank's report)."""
    async def main():
        engine = TorchServiceProvider(cfg, device="cpu").get_completions_service({}).engine
        try:
            return await scenario(engine), engine
        finally:
            await engine.close()

    result, engine = asyncio.run(main())
    if engine.mesh_section() is not None:
        for child in engine.mesh_section()["launched"]["children"]:
            assert child["exit-code"] == 0 and not child["killed"], child
    return result, engine


def _jax(cfg: dict, scenario):
    async def main():
        engine = TpuServingEngine(JaxServingConfig.from_dict(cfg))
        try:
            return await scenario(engine)
        finally:
            await engine.close()

    return asyncio.run(main())


def _children(engine) -> list[dict]:
    return engine.mesh_section()["launched"]["children"]


# --------------------------------------------------------------------------
# prefix tiers
# --------------------------------------------------------------------------


def _store(path, **overrides) -> dict:
    return {"t0-bytes": 0, "t1-bytes": 1, "t2": {"type": "local", "path": str(path)},
            "t2-rescan-s": 0.1, "hydrate-timeout-s": 10.0, **overrides}


async def _drain_tiers(engine, timeout_s: float = 20.0) -> dict:
    """Wait until the demotion cascade has reached T2."""
    for _ in range(int(timeout_s / 0.02)):
        st = engine.stats()["prefixstore"]
        if (st["t0"]["blocks"] == 0 and st["t1"]["entries"] == 0
                and not st["t2"]["in_transit_bytes"] and not st["t2"]["pending_jobs"]):
            return st
        await asyncio.sleep(0.02)
    raise AssertionError(f"the tiers did not drain: {engine.stats()['prefixstore']}")


async def _generate(engine):
    result = await engine.generate(PROMPT, dict(OPTS))
    return result["tokens"], result["text"]


async def _first_and_warm(engine):
    """A cold request, its blocks demoted to T2 through T1, then the same
    request promoted back (from T1: the cascade keeps the chain there for
    as long as a T2 write is in transit, so the drain reads both tiers)."""
    first = await _generate(engine)
    await _drain_tiers(engine)
    warm = await _generate(engine)
    return first, warm, engine.stats()["prefixstore"]


async def _hydrated(engine):
    assert engine.prefix_store.flush(10)
    out = await _generate(engine)
    st = engine.stats()["prefixstore"]
    assert st["hydrations"] > 0 and st["fingerprint_refusals"] == 0
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefix_tiers_under_a_mesh_give_the_jax_engines_tokens(mesh, tmp_path, monkeypatch):
    """The JAX engine and the port's, each demoting a prompt's blocks to
    T2 and promoting them back, then a fresh engine hydrating them; at
    ``{tp: 2}`` each package's fresh engine reads the other's directory.
    Every stream equals the JAX engine's first; the port counts the moves
    on every rank, and each rank's promoted rows equal its demoted ones."""
    _ranks(monkeypatch, MESHES[mesh])
    monkeypatch.setenv("LS_TORCH_TIER_DIGESTS", "1")
    jax_dir, port_dir = tmp_path / "from-jax", tmp_path / "from-port"
    cfg = {**PAGED, "prefix-cache": True, "mesh": MESHES[mesh]}
    jax_first, jax_warm, jax_st = _jax({**cfg, "prefix-store": _store(jax_dir)},
                                       _first_and_warm)
    (first, warm, st), engine = _port({**cfg, "prefix-store": _store(port_dir)},
                                      _first_and_warm)
    assert first == warm == jax_first == jax_warm
    for key in ("demotions_t0_t1", "demotions_t1_t2", "promotions"):
        assert st[key] == jax_st[key] >= 1, key
    assert engine.kv_fingerprint()["kv-heads"] == 2  # the whole model's
    leader = engine.mesh_section()
    moves = leader["tier-moves"]
    assert moves["kv_gather"] >= st["demotions_t0_t1"] // 4 and moves["kv_scatter"] >= 1
    assert leader["collectives"]["kv-tier"]["bytes"] > 0
    for rank in [leader] + [c["mesh"][0] for c in _children(engine)]:
        assert rank["tier-moves"] == moves
        digests = rank["tier-digests"]
        demoted = [d for op, ds in digests if op == "kv_gather" for d in ds]
        promoted = [d for op, ds in digests if op == "kv_scatter" for d in ds]
        # every demoted block came back, byte for byte on this rank
        assert len(demoted) == st["demotions_t0_t1"] and sorted(promoted) == sorted(demoted)
    hydrated, _ = _port({**cfg, "prefix-store": _store(
        jax_dir if mesh == "tp2" else port_dir)}, _hydrated)
    assert hydrated == jax_first
    if mesh == "tp2":
        assert sorted(p.name for p in port_dir.iterdir()) == sorted(
            p.name for p in jax_dir.iterdir())
        assert _jax({**cfg, "prefix-store": _store(port_dir)}, _hydrated) == jax_first


# --------------------------------------------------------------------------
# adapters
# --------------------------------------------------------------------------

ADAPTERS = {name: make_lora_arrays(layers=2, hidden=64, heads=4, kv_heads=2, head_dim=16,
                                   rank=4, seed=seed, scale=0.5)
            for name, seed in (("tenant-a", 11), ("tenant-b", 12), ("tenant-c", 13))}
WAVES = [[None, "tenant-a", "tenant-b", None], ["tenant-c", "tenant-a", None, "tenant-b"]]


async def _adapter_waves(engine):
    for name, arrays in ADAPTERS.items():
        engine.install_adapter(name, arrays)
    out = []
    for names in WAVES:
        results = await asyncio.gather(*(
            engine.generate(p, {**OPTS, **({"adapter": n} if n else {})})
            for p, n in zip(PROMPTS, names)))
        out.append([(r["tokens"], r["text"]) for r in results])
    return out, engine.stats()["adapters"]["t0"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_adapters_under_a_mesh_give_the_jax_engines_tokens(mesh, monkeypatch):
    """Two waves mixed across base, ``tenant-a``, ``tenant-b`` and
    ``tenant-c`` on two T0 rows: the JAX engine's tokens under the same
    mesh, adapter streams that differ from the base streams, and rows
    evicted and loaded again on every rank (each rank holds the row map
    the leader holds and ran the adapter deltas)."""
    _ranks(monkeypatch, MESHES[mesh])
    cfg = {**PAGED, "mesh": MESHES[mesh],
           "adapter-store": {"rank": 4, "t0-entries": 2, "t1-bytes": 8 << 20,
                             "hydrate-timeout-s": 10.0, "t2-rescan-s": 0.1}}
    want, jax_t0 = _jax(cfg, _adapter_waves)
    (got, t0), engine = _port(cfg, _adapter_waves)
    assert got == want
    assert got[0][1] != got[0][0] and got[0][2] != got[0][3]  # the adapters steer
    assert t0["evictions"] == jax_t0["evictions"] >= 1
    leader = engine.mesh_section()
    assert leader["tier-moves"]["adapter_row"] == t0["loads"] >= 3
    assert engine.adapter_fingerprint()["heads"] == 4
    for child in _children(engine):
        assert child["mesh"][0]["tier-moves"] == leader["tier-moves"]
        assert child["mesh"][0]["adapter-rows"] == leader["adapter-rows"]
        assert child["lora_delta"] > 0


# --------------------------------------------------------------------------
# pool roles
# --------------------------------------------------------------------------

TP2 = {**PAGED, "mesh": {"tp": 2}}


async def _combined(engine):
    return [r["tokens"] for r in await asyncio.gather(*(
        engine.generate(p, dict(OPTS)) for p in PROMPTS))]


async def _prefill(engine):
    results = await asyncio.gather(*(engine.generate(p, dict(OPTS)) for p in PROMPTS))
    return [engine.take_export(r["handoff"]) for r in results]


async def _decode(engine, payloads):
    return [r["tokens"] for r in await asyncio.gather(*(
        engine.import_handoff(p) for p in payloads))]


@pytest.fixture(scope="module")
def jax_handoff():
    """The JAX engine's combined tokens and its prefill pool's payloads at
    ``{tp: 2}``."""
    combined = _jax(TP2, _combined)
    payloads = _jax({**TP2, "pool-role": "prefill"}, _prefill)
    TpuServingEngine.reset_instances()
    return combined, payloads


def _same_payloads(ours: list[bytes], theirs: list[bytes]) -> None:
    for a, b in zip(ours, theirs, strict=True):
        (ha, aa), (hb, ab) = kvtransfer.deserialize_handoff(a), kvtransfer.deserialize_handoff(b)
        assert ha["fingerprint"] == hb["fingerprint"]
        assert ha["kv-rows"] == hb["kv-rows"] and aa.keys() == ab.keys()
        for name in aa:
            torch.testing.assert_close(aa[name], ab[name], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("route", ["port-prefill-jax-decode", "jax-prefill-port-decode",
                                   "port-tp2-prefill-port-tp1-decode"])
def test_pool_roles_under_a_mesh_hand_off_across_packages(route, monkeypatch, jax_handoff):
    """One engine at a time: the decode side's tokens equal the combined
    JAX engine's; a port export at tp=2 holds the JAX export's rows (whole
    heads) under an equal fingerprint. The tp=1 decode pool takes the
    payloads through the pod's functions (``take_kv_export`` picks them up
    from the mesh engine's leader, ``import_kv_handoff`` routes them)."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    combined, jax_payloads = jax_handoff
    prefill, decode = {**TP2, "pool-role": "prefill"}, {**TP2, "pool-role": "decode"}
    if route == "jax-prefill-port-decode":
        tokens, engine = _port(decode, lambda e: _decode(e, jax_payloads))
        assert engine.mesh_section()["tier-moves"]["kv_scatter"] == len(PROMPTS)
        assert tokens == combined
        return
    if route == "port-prefill-jax-decode":
        payloads, engine = _port(prefill, _prefill)
        assert _jax(decode, lambda e: _decode(e, payloads)) == combined
    else:
        async def picked_up(engine):
            results = await asyncio.gather(*(engine.generate(p, dict(OPTS)) for p in PROMPTS))
            return [port_engine.take_kv_export(r["handoff"])["payload"] for r in results]

        payloads, engine = _port(prefill, picked_up)

        async def routed(engine):
            return [r["tokens"] for r in await asyncio.gather(*(
                port_engine.import_kv_handoff(p) for p in payloads))]

        tokens, _ = _port({**PAGED, "pool-role": "decode"}, routed)
        assert tokens == combined
    assert engine.mesh_section()["tier-moves"]["kv_gather"] == len(PROMPTS)
    for child in _children(engine):
        assert child["mesh"][0]["tier-moves"]["kv_gather"] == len(PROMPTS)
    _same_payloads(payloads, jax_payloads)


# --------------------------------------------------------------------------
# the rows by heads, the frames, failure and refusal
# --------------------------------------------------------------------------


class _Queue:
    """A stand-in mesh inside one process: each collective returns the
    next of ``results``, in call order (what the group would give this
    rank)."""

    def __init__(self, results: list):
        self.results = list(results)

    def all_gather(self, x, axis, dim, tag=None):
        return torch.cat(self.results.pop(0), dim=dim)

    def broadcast(self, x, axis=None, src=0, tag=None):
        got = self.results.pop(0)
        assert got.shape == x.shape and got.dtype == x.dtype
        return got


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else [tree]


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_rows_by_heads_assemble_the_whole_pools_rows(kv):
    """Each rank's pool holds its heads' share of the fused head axis (the
    int8 scales' too): its gathered rows, all-gathered in ``tp`` order,
    are the whole pool's rows; a scatter of the whole rows broadcast to a
    rank writes into its pool exactly its heads' share of the whole
    pool's scatter."""
    torch.manual_seed(0)
    L, nb, bs, heads, D = 2, 6, 4, 4, 8

    def pool():
        if kv == "f32":
            return torch.randn(L, nb, bs, heads * D)
        return {"q": torch.randint(-127, 128, (L, nb, bs, heads * D), dtype=torch.int8),
                "s": torch.rand(L, nb, bs, heads)}

    def share(whole, i):
        def cut(x):
            w = x.shape[-1] // 2
            return x[..., i * w:(i + 1) * w].contiguous()
        return {k: cut(v) for k, v in whole.items()} if isinstance(whole, dict) else cut(whole)

    def same(a, b):
        for x, y in zip(_leaves(a), _leaves(b), strict=True):
            torch.testing.assert_close(x, y, rtol=0, atol=0)

    whole = (pool(), pool())
    ranks = [tuple(share(c, i) for c in whole) for i in range(2)]
    table = np.array([3, 1, 4], dtype=np.int32)
    want = kvtransfer.gather_slot(*whole, table, 3)
    local = [kvtransfer.gather_slot(*r, table, 3) for r in ranks]
    for i in range(2):
        results = [[_leaves(local[0][c])[j], _leaves(local[1][c])[j]]
                   for c in range(2) for j in range(len(_leaves(want[c])))]
        got = kvtransfer.gather_slot(*ranks[i], table, 3, mesh=_Queue(results), split=True)
        same(got[0], want[0])
        same(got[1], want[1])
    rows = kvtransfer.fetch_rows(*want, 10)[0]
    target = np.array([5, 2, 3, 1], dtype=np.int32)
    fresh = (pool(), pool())
    fresh_ranks = [tuple(share(c, i) for c in fresh) for i in range(2)]
    kvtransfer.scatter_slot(*fresh, rows, target, 10, 16)
    uploaded = [leaf for name in ("k", "v") for leaf in _leaves(
        kvtransfer._rows_tree(rows, name, 10, 16, torch.device("cpu")))]
    for i, (k, v) in enumerate(fresh_ranks):
        kvtransfer.scatter_slot(k, v, None, target, 10, 16, mesh=_Queue(uploaded),
                                heads=(i, 2))
        same(k, share(fresh[0], i))
        same(v, share(fresh[1], i))


def test_the_new_frame_kinds_round_trip():
    """The tier moves and a prefill frame carrying its rows' adapter rows
    decode to what was encoded."""
    frames = [
        {"op": "kv_gather", "table": np.array([4, 9, 2], dtype=np.int32)},
        {"op": "kv_gather", "table": np.array([7, 8], dtype=np.int32), "rows": 20,
         "replica": 1},
        {"op": "kv_scatter", "table": np.arange(8, dtype=np.int32), "rows": 48,
         "padded": 64},
        {"op": "adapter_row", "row": 2, "name": "tenant-a"},
        {"op": "prefill", "tokens": np.ones((2, 32), dtype=np.int64),
         "ad_rows": np.array([0, 2], dtype=np.int32), "sampler_mode": [False, False, True]},
    ]
    for desc in frames:
        back = decode_descriptor(encode_descriptor(desc)[4:])
        assert back.keys() == desc.keys()
        for key, value in desc.items():
            if isinstance(value, np.ndarray):
                assert back[key].dtype == value.dtype
                np.testing.assert_array_equal(back[key], value)
            else:
                assert back[key] == value


def test_a_follower_killed_during_a_demotion_breaks_the_group(tmp_path, monkeypatch):
    """Rank 1 is killed as the leader starts its first demotion: the move
    is not made on the leader alone; the group breaks (a
    ``lockstep-divergence`` event: the engine stops and refuses the next
    request) and ``close()`` raises
    naming the rank and its exit code."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    cfg = {**PAGED, "prefix-cache": True, "mesh": {"tp": 2},
           "prefix-store": _store(tmp_path)}
    engine = TorchServiceProvider(cfg, device="cpu").get_completions_service({}).engine
    child = engine._launched.children[0]
    real = engine._run_gather

    def killing(table_row, rows, replica=0):
        if child.proc.poll() is None:
            os.kill(child.proc.pid, 9)
            child.proc.wait()
        return real(table_row, rows, replica)

    engine._run_gather = killing

    async def main():
        await _generate(engine)
        for _ in range(1500):  # the demotion runs at the loop's next pass
            if engine._stop:
                break
            await asyncio.sleep(0.02)
        assert engine._stop
        kinds = [e["kind"] for e in engine.flight.recent_events(0)]
        assert "lockstep-divergence" in kinds
        with pytest.raises(RuntimeError, match="stopped"):
            await _generate(engine)
        with pytest.raises(RuntimeError, match=rf"local rank 1 \(pid {child.proc.pid}\) "
                                               rf"exited -9"):
            await engine.close()

    asyncio.run(main())
    assert engine.stats()["prefixstore"]["demotions_t0_t1"] == 0


def test_adapter_store_on_a_slice_is_refused_and_the_other_stores_are_not(monkeypatch):
    """On a slice of several hosts (``LS_SLICE_HOSTS=2``) ``adapter-store``
    under a mesh is refused with the JAX engine's message; ``prefix-store``
    and ``pool-role`` pass the same check (they take the same frames)."""
    monkeypatch.setenv("LS_SLICE_HOSTS", "2")
    base = {**PAGED, "mesh": {"tp": 2}}
    with pytest.raises(ValueError) as err:
        _check_supported(ServingConfig.from_dict({**base, "adapter-store": {"rank": 4}}))
    assert str(err.value) == ("adapter-store is incompatible with multi-host lockstep "
                              "(followers replay positional dispatch descriptors that "
                              "carry no adapter rows)")
    for extra in ({"prefix-store": {"t1-bytes": 1 << 20}}, {"pool-role": "prefill"},
                  {"pool-role": "decode"}):
        _check_supported(ServingConfig.from_dict({**base, **extra}))
    monkeypatch.delenv("LS_SLICE_HOSTS")
    _check_supported(ServingConfig.from_dict({**base, "adapter-store": {"rank": 4}}))
    assert launch._WORLD is None
