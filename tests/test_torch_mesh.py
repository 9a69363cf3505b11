"""The port's meshes and shards (``langstream_tpu_torch/parallel/mesh.py``,
the specs of ``models/llama.py``, ``models/moe.py``, ``models/quant.py``
and ``models/paged.py``) against the JAX package's.

- ``make_mesh``: the same axis sizes (the ``-1`` wildcard included) and the
  same errors as ``langstream_tpu.parallel.mesh.make_mesh`` on the 8
  virtual CPU devices of ``tests/conftest.py``, rank ``r`` at the
  coordinates of device ``r``; a mesh whose product is not the world size
  is refused naming both numbers.
- The specs are the JAX package's, entry for entry, and for every rank
  ``shard_for_rank`` gives the index slices that
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives that
  rank's device: Llama, MoE and int8 trees, and both cache layouts.
- The backend rule, and the local config a rank serves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from langstream_tpu.models import llama as jl
from langstream_tpu.models import moe as jm
from langstream_tpu.models import paged as jp
from langstream_tpu.models.quant import (
    QTensor as JaxQTensor,
    quantize_llama_params as jax_quantize_llama,
    quantize_moe_params as jax_quantize_moe,
    quantize_specs as jax_quantize_specs,
)
from langstream_tpu.parallel.mesh import make_mesh as jax_make_mesh
from langstream_tpu_torch.models import llama as tl
from langstream_tpu_torch.models import moe as tm
from langstream_tpu_torch.models import paged as tp_
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.models.quant import QTensor, quantize_specs
from langstream_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    backend_rule,
    local_shape,
    make_mesh,
    shard_for_rank,
    shard_tree,
)
from test_torch_engine import flatten_jax_params

MESHES = [{"tp": 2}, {"dp": 2, "tp": 2}, {"ep": 2, "tp": 2}, {"dp": 2, "ep": 2, "tp": 2},
          {"tp": 8}, {"dp": -1, "tp": 2}, {"ep": 4, "tp": -1}]


def _ranks(axis_sizes: dict, world: int) -> list[Mesh]:
    return [make_mesh(axis_sizes, world_size=world, rank=r, groups=False)
            for r in range(world)]


def _world(axis_sizes: dict) -> int:
    known = int(np.prod([v for v in axis_sizes.values() if v != -1]))
    return 8 if -1 in axis_sizes.values() else known


# ---------------------------------------------------------------------------
# (a) make_mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_make_mesh_matches_jax(axes):
    world = _world(axes)
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:world])
    ranks = _ranks(dict(axes), world)
    assert ranks[0].axis_names == tuple(jmesh.axis_names)
    assert ranks[0].shape == dict(jmesh.shape)
    # rank r sits where device r sits in the JAX device grid
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)
    for mesh in ranks:
        where = tuple(int(i[0]) for i in np.nonzero(grid == jax.devices()[mesh.rank].id))
        assert tuple(mesh.coords[a] for a in mesh.axis_names) == where


@pytest.mark.parametrize("axes,match", [
    ({"dp": -1, "tp": -1}, "only one axis may be -1"),
    ({"dp": 4, "tp": 4}, "needs 16 devices, have 8"),
])
def test_make_mesh_errors_are_the_jax_ones(axes, match):
    with pytest.raises(ValueError, match=match):
        jax_make_mesh(dict(axes), devices=jax.devices()[:8])
    with pytest.raises(ValueError, match=match):
        make_mesh(dict(axes), world_size=8, rank=0, groups=False)


def test_a_mesh_smaller_than_the_world_is_refused_naming_both_numbers():
    # the JAX package takes the first devices; one process per rank cannot
    # leave a rank out of the group
    assert dict(jax_make_mesh({"tp": 2}, devices=jax.devices()[:8]).shape) == {"tp": 2}
    with pytest.raises(ValueError, match=r"spans 2 ranks but the world has 8"):
        make_mesh({"tp": 2}, world_size=8, rank=0, groups=False)
    # no group joined: the world is this process
    assert make_mesh({"tp": 1}).world_size == 1
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh({"tp": 2})


def test_backend_rule_reads_the_devices():
    assert backend_rule("cpu", 4)[0] == "gloo"
    backend, reason = backend_rule("cuda", 2, cards=1)
    assert backend == "gloo" and "share 1 card" in reason
    assert backend_rule("cuda", 4, cards=4) == ("nccl", "4 rank(s) on 4 card(s): one card each")
    # a multi-host slice: one rank per host, each with its card
    assert backend_rule("cuda", 16, local_world_size=1, cards=1)[0] == "nccl"


# ---------------------------------------------------------------------------
# (b) specs and shards
# ---------------------------------------------------------------------------


def _spec_tuple(spec):
    return tuple(spec)


def _walk_specs(port, jax_specs):
    if isinstance(port, dict):
        assert port.keys() == jax_specs.keys()
        for k in port:
            _walk_specs(port[k], jax_specs[k])
    elif isinstance(port, QTensor):
        assert isinstance(jax_specs, JaxQTensor)
        assert _spec_tuple(port.q) == _spec_tuple(jax_specs.q)
        assert _spec_tuple(port.s) == _spec_tuple(jax_specs.s)
    else:
        assert _spec_tuple(port) == _spec_tuple(jax_specs)


def test_param_and_cache_specs_are_the_jax_ones():
    c = jl.LlamaConfig.tiny()
    _walk_specs(tl.llama_param_specs(tl.LlamaConfig.tiny()), jl.llama_param_specs(c))
    _walk_specs(tm.moe_param_specs(tm.MoEConfig.tiny()), jm.moe_param_specs(jm.MoEConfig.tiny()))
    for axes in [(), ("tp",), ("dp", "tp"), ("dp", "ep", "tp")]:
        assert tuple(tl.kv_cache_spec(axes)) == tuple(jl.kv_cache_spec(axes))
        assert tuple(tp_.paged_cache_spec(axes)) == tuple(jp.paged_cache_spec(axes))


def _check_leaf(full: np.ndarray, spec, jmesh, axes: dict, world: int):
    """Every rank's shard_for_rank slice of ``full`` equals its device's
    slice in the JAX sharding."""
    indices = NamedSharding(jmesh, jax.sharding.PartitionSpec(*spec)).devices_indices_map(
        full.shape)
    t = torch.from_numpy(full.copy())
    for mesh in _ranks(axes, world):
        want = full[indices[jax.devices()[mesh.rank]]]
        got = shard_for_rank(t, P(*spec), mesh).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.shape == local_shape(full.shape, P(*spec), mesh)


def _check_tree(tree, specs, jmesh, axes, world):
    if isinstance(tree, dict):
        for k in tree:
            _check_tree(tree[k], specs[k], jmesh, axes, world)
    elif isinstance(tree, JaxQTensor):
        _check_leaf(np.asarray(tree.q), specs.q, jmesh, axes, world)
        _check_leaf(np.asarray(tree.s), specs.s, jmesh, axes, world)
    else:
        _check_leaf(np.asarray(tree), specs, jmesh, axes, world)


@pytest.mark.parametrize("model,axes", [
    ("llama", {"tp": 2}), ("llama", {"dp": 2, "tp": 2}), ("llama-int8", {"tp": 2}),
    ("llama-int8", {"dp": 2, "tp": 2}), ("moe", {"ep": 2, "tp": 2}),
    ("moe-int8", {"ep": 2, "tp": 2}), ("moe-int8", {"dp": 2, "ep": 2, "tp": 2}),
], ids=lambda v: v if isinstance(v, str) else "x".join(f"{k}{n}" for k, n in v.items()))
def test_shard_for_rank_matches_devices_indices_map(model, axes):
    world = int(np.prod(list(axes.values())))
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:world])
    if model.startswith("llama"):
        c = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
        params = jl.init_llama_params(c, jax.random.PRNGKey(0))
        specs = jl.llama_param_specs(c)
        if model.endswith("int8"):
            params = jax_quantize_llama(params)
    else:
        c = dataclasses.replace(jm.MoEConfig.tiny(), dtype=jnp.float32)
        params = jm.init_moe_params(c, jax.random.PRNGKey(0))
        specs = jm.moe_param_specs(c)
        if model.endswith("int8"):
            params = jax_quantize_moe(params)
    specs = jax_quantize_specs(specs, params)
    _check_tree(params, specs, jmesh, axes, world)
    # the port's own tree and specs give the same shards
    port_params = params_from_numpy(flatten_jax_params(params), device="cpu")
    port_specs = (tl.llama_param_specs if model.startswith("llama")
                  else tm.moe_param_specs)(None)
    port_specs = quantize_specs(port_specs, port_params)
    _walk_specs(port_specs, specs)
    for mesh in _ranks(axes, world):
        local = shard_tree(port_params, port_specs, mesh)
        wq = local["layers"]["wq"]
        wq = wq.q if isinstance(wq, QTensor) else wq
        assert wq.shape[-1] == c.heads * c.head_dim // mesh.size("tp")


@pytest.mark.parametrize("axes", [{"tp": 2}, {"dp": 2, "tp": 2}], ids=str)
def test_cache_shards_match_devices_indices_map(axes):
    world = int(np.prod(list(axes.values())))
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:world])
    rng = np.random.RandomState(0)
    L, nb, bs, Kh, D, slots, S = 2, 6, 4, 2, 8, 4, 16
    paged = rng.randn(L, nb, bs, Kh * D).astype(np.float32)
    paged_scales = rng.rand(L, nb, bs, Kh).astype(np.float32)
    spec = jp.paged_cache_spec(tuple(axes))
    _check_leaf(paged, spec, jmesh, axes, world)
    _check_leaf(paged_scales, spec, jmesh, axes, world)
    dense = rng.randn(L, slots, S, Kh, D).astype(np.float32)
    dspec = jl.kv_cache_spec(tuple(axes))
    _check_leaf(dense, dspec, jmesh, axes, world)
    # the dense int8 cache's scales take the spec minus head_dim
    _check_leaf(rng.rand(L, slots, S, Kh).astype(np.float32), tuple(dspec)[:4], jmesh,
                axes, world)


def test_local_config_splits_heads_and_ffn_and_degrades_attention():
    mesh = make_mesh({"dp": 2, "tp": 2}, world_size=4, rank=3, groups=False)
    local = tl.local_config(tl.LlamaConfig.tiny(), mesh)
    assert (local.heads, local.kv_heads, local.intermediate) == (2, 1, 64)
    assert local.shard.attention and local.shard.tp and local.vocab_size == 384
    # tiny's 2 KV heads do not split over 4: the attention block stays whole
    mesh4 = make_mesh({"tp": 4}, world_size=4, rank=1, groups=False)
    local4 = tl.local_config(tl.LlamaConfig.tiny(), mesh4)
    assert (local4.heads, local4.kv_heads, local4.intermediate) == (4, 2, 32)
    assert not local4.shard.attention
    specs = tl.rank_specs(tl.llama_param_specs(None), tl.LlamaConfig.tiny(), mesh4)
    assert tuple(specs["layers"]["wq"]) == (None, None, None)
    assert tuple(specs["layers"]["w_up"]) == (None, None, "tp")
    moe = tl.local_config(tm.MoEConfig.tiny(), make_mesh(
        {"ep": 2, "tp": 2}, world_size=4, rank=0, groups=False))
    assert (moe.moe_intermediate, moe.experts) == (64, 4)


# ---------------------------------------------------------------------------
# a rank places its shards, never the whole tree
# ---------------------------------------------------------------------------


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, QTensor):
        return _tree_bytes(tree.q) + _tree_bytes(tree.s)
    return tree.numel() * tree.element_size()


def _assert_trees_equal(got, want) -> None:
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, QTensor):
        _assert_trees_equal(got.q, want.q)
        _assert_trees_equal(got.s, want.s)
    else:
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("family,int8", [("llama", False), ("llama", True),
                                         ("moe", False), ("moe", True)],
                         ids=["llama", "llama-int8", "moe", "moe-int8"])
def test_random_init_places_each_leaf_as_it_is_drawn(family, int8):
    """The init functions' ``place`` hook (what an engine under a mesh runs):
    each rank keeps the slices of the very weights a one-rank engine draws
    from the same seed, leaf by leaf, and a tp=2 rank keeps about half the
    bytes (the norms and, for MoE at tp=1, the attention stay whole)."""
    from langstream_tpu_torch.models import quant as tq

    if family == "llama":
        c = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
        init = tq.init_llama_params_q8 if int8 else tl.init_llama_params
        axes, base = {"tp": 2}, tl.llama_param_specs(c)
    else:
        c = dataclasses.replace(tm.MoEConfig.tiny(), dtype=torch.float32)
        init = tq.init_moe_params_q8 if int8 else tm.init_moe_params
        axes, base = {"ep": 2, "tp": 1}, tm.moe_param_specs(c)
    full = init(c, torch.Generator().manual_seed(0), device="cpu")
    for mesh in _ranks(axes, 2):
        specs = tl.rank_specs(base, c, mesh)
        paths = []

        def place(path, leaf):
            spec = specs
            for key in path.split("."):
                spec = spec[key]
            paths.append(path)
            return shard_tree(leaf, quantize_specs(spec, leaf), mesh)

        got = init(c, torch.Generator().manual_seed(0), device="cpu", place=place)
        _assert_trees_equal(got, shard_tree(full, quantize_specs(specs, full), mesh))
        assert len(paths) == len(set(paths)) == 3 + len(full["layers"])
        share = _tree_bytes(got) / _tree_bytes(full)
        assert (0.45 < share < 0.6) if family == "llama" else share < 0.8, share


def test_stacked_quantization_is_the_whole_tensors():
    """Quantizing a stacked weight one layer at a time (the host's f32
    transient stays one layer's) gives the whole tensor's numbers."""
    from langstream_tpu_torch.models.quant import quantize_stacked, quantize_tensor

    g = torch.Generator().manual_seed(3)
    for shape, axis in (((3, 16, 24), 1), ((2, 3, 16, 8), 2)):
        w = torch.randn(shape, generator=g).to(torch.bfloat16)
        got, want = quantize_stacked(w, axis), quantize_tensor(w, axis)
        assert torch.equal(got.q, want.q) and torch.equal(got.s, want.s)
        assert got.dtype == want.dtype


def test_a_replica_samples_its_rows_as_the_whole_batch_would():
    """Under a dp split a replica samples only its rows, drawing for the
    whole batch: its tokens are the whole batch's at those rows, for a
    contiguous span (decode, verify) and an index (prefill) alike."""
    from langstream_tpu_torch.serving.sampler import sample_tokens, speculative_accept

    rng = np.random.RandomState(0)
    B, V, D1 = 6, 40, 3
    logits = torch.from_numpy(rng.randn(B, V).astype(np.float32))
    temps = torch.tensor([0.7, 1.0, 0.0, 1.3, 0.9, 1.0])
    topks = torch.tensor([0, 5, 0, 10, 0, 3])
    topps = torch.tensor([0.9, 1.0, 1.0, 0.8, 1.0, 0.95])
    kw = dict(use_top_p=True, use_top_k=True)
    whole = sample_tokens(logits, torch.Generator().manual_seed(1), temps, topks,
                          top_ps=topps, **kw)
    for rows in (slice(2, 4), torch.tensor([0, 5])):
        part = sample_tokens(logits[rows], torch.Generator().manual_seed(1), temps[rows],
                             topks[rows], top_ps=topps[rows], rows=(B, rows), **kw)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[rows])
    vlogits = torch.from_numpy(rng.randn(B, D1, V).astype(np.float32))
    drafts = torch.from_numpy(rng.randint(0, V, (B, D1 - 1)))
    whole = speculative_accept(vlogits, drafts, torch.Generator().manual_seed(2), temps,
                               topks, topps, **kw)
    rows = slice(3, 6)
    part = speculative_accept(vlogits[rows], drafts[rows], torch.Generator().manual_seed(2),
                              temps[rows], topks[rows], topps[rows], rows=(B, rows), **kw)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[rows])
