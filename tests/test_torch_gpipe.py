"""Pipeline parallelism and training through it in the port
(``langstream_tpu_torch/parallel/pipeline.py``) against the JAX package's
``langstream_tpu/parallel/pipeline.py``.

The JAX side runs as ``tests/test_moe_pipeline.py`` runs it, on the 8
virtual CPU devices. The port side runs one gloo process per rank (no JAX
there): each rank holds its shards under ``pp_param_specs`` (its ``L/pp``
layers, its experts on ``ep``, its ``tp`` columns and rows), computes, and
writes what it holds; the test holds every rank's output against the JAX
output, a shard against the JAX block at the rank's coordinates. f32
throughout.

- ``llama_forward_pp`` at ``{pp: 2, dp: 2, tp: 2}`` and ``{pp: 4, tp: 2}``
  (4 layers): logits within 1e-4.
- ``moe_forward_pp`` at ``{pp: 2, ep: 2, tp: 2}`` with M = 1, 2 and 4:
  logits within 1e-4, aux within 1e-5 relative; ``B % M`` raises the JAX
  package's message.
- The training step of ``tests/test_moe_pipeline.py`` (NLL + 0.01 aux,
  ``sgd(1e-3)``) at ``{pp: 2, ep: 2, tp: 2}`` and ``{dp: 2, pp: 2}`` (with
  ``sync_grads``), each also with a capacity that drops tokens: the loss
  within 1e-5, each rank's gradient of every leaf within 1e-4 of the leaf's
  largest JAX gradient, the updated parameters within 1e-6 of the JAX
  package's ``optax`` update.

One world of 8 ranks and one of 4, each with all its cases; every world
ends through ``parallel.mesh.shutdown()`` and every rank must exit 0.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from langstream_tpu.models import llama as jllama
from langstream_tpu.models import moe as jmoe
from langstream_tpu.parallel import pipeline as jpipe
from langstream_tpu.parallel.mesh import make_mesh as jax_make_mesh
from test_torch_ring import _block, _flat, run_world

LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4      # of the leaf's largest JAX gradient
UPDATE_TOL = 1e-6
LR = 1e-3

_RANK = r'''
import dataclasses, json, sys
import numpy as np, torch
from langstream_tpu_torch.models import llama as tl, moe as tm
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.parallel import pipeline as pl
from langstream_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown, sync_grads

rank, coordinator, path, world = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
cases = json.loads(open(path + "/cases.json").read())
init_distributed(coordinator, world, rank, "cpu", timeout_s=60)
data = np.load(path + "/inputs.npz")


def tree(prefix):
    out = {"layers": {}}
    for k in data.files:
        if k.startswith(prefix + ".layers."):
            out["layers"][k[len(prefix) + 8:]] = data[k]
        elif k.startswith(prefix + "."):
            out[k[len(prefix) + 1:]] = data[k]
    return params_from_numpy(out, device="cpu", dtype=torch.float32)


def leaves(t, prefix=""):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


results = {}
for name, case in cases.items():
    mesh = make_mesh(case["axes"])
    if case["model"] == "llama":
        config = dataclasses.replace(tl.LlamaConfig.tiny(max_seq_len=64), dtype=torch.float32,
                                     layers=case["layers"])
    else:
        config = dataclasses.replace(tm.MoEConfig.tiny(max_seq_len=64), dtype=torch.float32,
                                     capacity_factor=case["capacity_factor"])
    params = pl.shard_pp_params(tree(case["params"]), config, mesh)
    tokens = torch.from_numpy(data[case["tokens"]])
    M = case["M"]
    if case["kind"] == "forward":
        if case["model"] == "llama":
            results[name + ".logits"] = pl.llama_forward_pp(config, params, tokens, mesh, M).numpy()
        else:
            logits, aux = pl.moe_forward_pp(config, params, tokens, mesh, M)
            results[name + ".logits"], results[name + ".aux"] = logits.numpy(), aux.numpy()
        continue
    for _, leaf in leaves(params):
        leaf.requires_grad_(True)
    logits, aux = pl.moe_forward_pp(config, params, tokens, mesh, M)
    loss = tl.next_token_nll(logits, tokens) + 0.01 * aux
    loss.backward()
    sync_grads(params, pl.pp_param_specs(config, mesh), mesh)
    results[name + ".loss"] = loss.detach().numpy()
    with torch.no_grad():
        for path_, leaf in leaves(params):
            results[f"{name}.grad.{path_}"] = leaf.grad.numpy()
            results[f"{name}.new.{path_}"] = (leaf - 1e-3 * leaf.grad).numpy()
    results[name + ".collectives"] = np.array(json.dumps(mesh.describe()["collectives"]))
np.savez(f"{path}/out{rank}.npz", **results)
shutdown()
'''


def _tokens(B: int, S: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 300, size=(B, S)).astype(np.int32)


def _jax_llama(layers: int):
    config = dataclasses.replace(jllama.LlamaConfig.tiny(max_seq_len=64), dtype=jnp.float32,
                                 layers=layers)
    return config, jllama.init_llama_params(config, jax.random.PRNGKey(10 + layers))


def _jax_moe(capacity_factor: float):
    config = dataclasses.replace(jmoe.MoEConfig.tiny(max_seq_len=64), dtype=jnp.float32,
                                 capacity_factor=capacity_factor)
    return config, jmoe.init_moe_params(config, jax.random.PRNGKey(20))


MOE_DEFAULT = 1.25  # MoEConfig's own factor
# capacity ceil(2 * 16 * 0.25 / 4) = 2 per expert for a microbatch of 2 x 8
# tokens: 4 experts keep at most 8 of its 32 choices, so tokens drop
MOE_DROP = 0.25
PP_EP_TP = {"pp": 2, "ep": 2, "tp": 2}
DP_PP = {"dp": 2, "pp": 2}
TOKENS = {"t416": _tokens(4, 16, 3), "t48": _tokens(4, 8, 5), "t68": _tokens(6, 8, 6)}
WORLD8 = {
    "llama-pp2dp2tp2": {"kind": "forward", "model": "llama", "layers": 2, "params": "llama2",
                        "axes": {"pp": 2, "dp": 2, "tp": 2}, "tokens": "t416", "M": 2},
    "llama-pp4tp2": {"kind": "forward", "model": "llama", "layers": 4, "params": "llama4",
                     "axes": {"pp": 4, "tp": 2}, "tokens": "t416", "M": 2},
    **{f"moe-m{M}": {"kind": "forward", "model": "moe", "capacity_factor": MOE_DEFAULT,
                     "params": "moe", "axes": PP_EP_TP, "tokens": "t416", "M": M}
       for M in (1, 2, 4)},
    "train": {"kind": "train", "model": "moe", "capacity_factor": MOE_DEFAULT,
              "params": "moe", "axes": PP_EP_TP, "tokens": "t48", "M": 2},
    "train-drop": {"kind": "train", "model": "moe", "capacity_factor": MOE_DROP,
                   "params": "moe", "axes": PP_EP_TP, "tokens": "t48", "M": 2},
}
WORLD4 = {
    "train-dp": {"kind": "train", "model": "moe", "capacity_factor": MOE_DEFAULT,
                 "params": "moe", "axes": DP_PP, "tokens": "t48", "M": 2},
    "train-dp-drop": {"kind": "train", "model": "moe", "capacity_factor": MOE_DROP,
                      "params": "moe", "axes": DP_PP, "tokens": "t48", "M": 2},
}
CASES = {**WORLD8, **WORLD4}


def _inputs() -> dict:
    inputs = dict(TOKENS)
    inputs.update(_flat("llama2", _jax_llama(2)[1]))
    inputs.update(_flat("llama4", _jax_llama(4)[1]))
    inputs.update(_flat("moe", _jax_moe(MOE_DEFAULT)[1]))
    return inputs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' outputs by rank, each world started once for the module."""
    inputs = _inputs()
    root = tmp_path_factory.mktemp("gpipe")
    outs = {}
    for world, cases in ((8, WORLD8), (4, WORLD4)):
        ranks = run_world(root / f"w{world}", world, cases, inputs, script=_RANK)
        for name in cases:
            outs[name] = [{k[len(name) + 1:]: v for k, v in rank.items()
                           if k.startswith(name + ".")} for rank in ranks]
    return outs


def _jax_mesh(axes: dict):
    n = math.prod(axes.values())
    return jax_make_mesh(dict(axes), devices=jax.devices()[:n])


def _port_specs(case: dict) -> dict:
    """The spec tree each port rank holds its shards under, flattened."""
    from langstream_tpu_torch.models import llama as tl
    from langstream_tpu_torch.models import moe as tm
    from langstream_tpu_torch.parallel.mesh import make_mesh
    from langstream_tpu_torch.parallel.pipeline import pp_param_specs

    axes = case["axes"]
    config = tl.LlamaConfig.tiny() if case["model"] == "llama" else tm.MoEConfig.tiny()
    mesh = make_mesh(axes, world_size=math.prod(axes.values()), rank=0, groups=False)
    specs = pp_param_specs(config, mesh)
    flat = {k: v for k, v in specs.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in specs["layers"].items()})
    return flat


def _spec_block(a: np.ndarray, spec, axes: dict, rank: int) -> np.ndarray:
    dims = {}
    for dim, entry in enumerate(spec):
        if entry is not None:
            dims[dim] = entry if isinstance(entry, tuple) else (entry,)
    return _block(a, axes, rank, dims)


def _jax_train(case: dict):
    """The JAX package's training step (``tests/test_moe_pipeline.py``) on
    the case's mesh: loss, gradients and updated parameters, flattened."""
    config, params = _jax_moe(case["capacity_factor"])
    axes = dict(case["axes"])
    jaxes = {**axes, "ep": axes.get("ep", 1), "tp": axes.get("tp", 1)}  # the specs name both
    jmesh = _jax_mesh(jaxes)
    sharded = jmoe.shard_moe_params(params, config, jmesh)
    tokens = jnp.asarray(TOKENS[case["tokens"]])
    optimizer = optax.sgd(LR)
    opt_state = optimizer.init(sharded)

    def loss_fn(p, t):
        logits, aux = jpipe.moe_forward_pp(config, p, t, jmesh, num_microbatches=case["M"])
        targets = t[:, 1:]
        logprobs = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logprobs, targets[..., None], axis=-1)
        return nll.mean() + 0.01 * aux

    @jax.jit
    def train_step(p, opt_state, t):
        loss, grads = jax.value_and_grad(loss_fn)(p, t)
        updates, opt_state = optimizer.update(grads, opt_state)
        return loss, grads, optax.apply_updates(p, updates)

    loss, grads, new = train_step(sharded, opt_state, tokens)
    return float(loss), _flat("g", grads), _flat("n", new)


def test_pp_layer_specs_match_jax():
    """``pp_layer_specs`` puts ``pp`` where the JAX package's does, on the
    Llama and the MoE layer specs (and on whole spec trees)."""
    from langstream_tpu_torch.models import llama as tl
    from langstream_tpu_torch.models import moe as tm
    from langstream_tpu_torch.parallel.pipeline import pp_layer_specs

    for port_specs, jax_specs in (
            (tl.llama_param_specs(tl.LlamaConfig.tiny()),
             jllama.llama_param_specs(jllama.LlamaConfig.tiny())),
            (tm.moe_param_specs(tm.MoEConfig.tiny()),
             jmoe.moe_param_specs(jmoe.MoEConfig.tiny()))):
        for tree_p, tree_j in ((port_specs["layers"], jax_specs["layers"]),
                               (port_specs, jax_specs)):
            got, want = pp_layer_specs(tree_p), jpipe.pp_layer_specs(tree_j)
            flat_j = dict(jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
            flat_p = {}

            def walk(t, prefix=()):
                for k, v in t.items():
                    if isinstance(v, dict):
                        walk(v, prefix + (k,))
                    else:
                        flat_p[prefix + (k,)] = v

            walk(got)
            assert {tuple(p.key for p in k): tuple(v) for k, v in flat_j.items()} == \
                {k: tuple(v) for k, v in flat_p.items()}


@pytest.mark.parametrize("name", ["llama-pp2dp2tp2", "llama-pp4tp2"])
def test_llama_forward_pp_matches_jax(name, worlds):
    """Every rank returns the whole batch's logits, equal to the JAX
    package's ``llama_forward_pp`` on the same mesh within 1e-4."""
    case = CASES[name]
    config, params = _jax_llama(case["layers"])
    want = np.asarray(jax.jit(lambda p, t: jpipe.llama_forward_pp(
        config, p, t, _jax_mesh(case["axes"]), num_microbatches=case["M"]))(
            params, jnp.asarray(TOKENS[case["tokens"]])))
    for rank, out in enumerate(worlds[name]):
        np.testing.assert_allclose(out["logits"], want, **LOGITS_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("M", [1, 2, 4])
def test_moe_forward_pp_matches_jax(M, worlds):
    """``moe_forward_pp`` at ``{pp: 2, ep: 2, tp: 2}``: each microbatch
    routes with its own capacity and the aux is the total over ``M``; the
    logits within 1e-4 and the aux within 1e-5 relative on every rank."""
    name = f"moe-m{M}"
    case = CASES[name]
    config, params = _jax_moe(case["capacity_factor"])
    jmesh = _jax_mesh(case["axes"])
    logits, aux = jax.jit(lambda p, t: jpipe.moe_forward_pp(config, p, t, jmesh,
                                                            num_microbatches=M))(
        jmoe.shard_moe_params(params, config, jmesh), jnp.asarray(TOKENS[case["tokens"]]))
    for rank, out in enumerate(worlds[name]):
        np.testing.assert_allclose(out["logits"], np.asarray(logits), **LOGITS_TOL,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(out["aux"], float(aux), rtol=1e-5, err_msg=f"rank {rank}")


def test_microbatches_must_divide_the_batch():
    """``B % M`` raises the JAX package's ``ValueError`` in both forwards
    (before any transfer, so a one-process mesh view shows it)."""
    from langstream_tpu_torch.models import llama as tl
    from langstream_tpu_torch.models import moe as tm
    from langstream_tpu_torch.parallel.mesh import make_mesh
    from langstream_tpu_torch.parallel.pipeline import llama_forward_pp, moe_forward_pp

    msg = "batch 6 not divisible by microbatches 4"
    tokens = TOKENS["t68"]
    mesh = make_mesh({"pp": 2}, world_size=2, rank=0, groups=False)
    jmesh = _jax_mesh({"pp": 2, "ep": 1, "tp": 1})
    for port_fn, port_cfg, jax_fn, jax_cfg in (
            (llama_forward_pp, tl.LlamaConfig.tiny(), jpipe.llama_forward_pp,
             jllama.LlamaConfig.tiny()),
            (moe_forward_pp, tm.MoEConfig.tiny(), jpipe.moe_forward_pp,
             jmoe.MoEConfig.tiny())):
        with pytest.raises(ValueError, match=msg):
            port_fn(port_cfg, {}, torch.from_numpy(tokens), mesh, num_microbatches=4)
        with pytest.raises(ValueError, match=msg):
            jax_fn(jax_cfg, {}, jnp.asarray(tokens), jmesh, num_microbatches=4)


@pytest.mark.parametrize("name", list(k for k in CASES if k.startswith("train")))
def test_training_step_matches_jax(name, worlds):
    """The JAX package's MoE pipeline training step, NLL + 0.01 aux, one
    ``sgd(1e-3)`` update: the loss within 1e-5 on every rank; every rank's
    gradient of every leaf it holds within 1e-4 of the leaf's largest JAX
    gradient (the gradients summed over ``dp`` by ``sync_grads`` where the
    mesh has it); the updated leaves within 1e-6 of the ``optax`` update.
    The backward moved the hand-offs back (``pp-handoff-bwd``) and, where
    the mesh has them, summed the experts' inputs over ``ep`` and ``tp``."""
    case = CASES[name]
    loss, grads, new = _jax_train(case)
    specs = _port_specs(case)
    axes = case["axes"]
    for rank, out in enumerate(worlds[name]):
        msg = f"rank {rank}"
        assert abs(float(out["loss"]) - loss) <= LOSS_TOL, (msg, float(out["loss"]), loss)
        for leaf, spec in specs.items():
            want_g = _spec_block(grads[f"g.{leaf}"], spec, axes, rank)
            scale = float(np.abs(grads[f"g.{leaf}"]).max())
            np.testing.assert_allclose(out[f"grad.{leaf}"], want_g, rtol=0,
                                       atol=GRAD_TOL * scale, err_msg=f"{msg} {leaf}")
            np.testing.assert_allclose(out[f"new.{leaf}"],
                                       _spec_block(new[f"n.{leaf}"], spec, axes, rank),
                                       rtol=0, atol=UPDATE_TOL, err_msg=f"{msg} {leaf}")
        coll = json.loads(str(out["collectives"]))
        assert coll["pp-handoff-bwd"]["calls"] == coll["pp-handoff"]["calls"] > 0, coll
        if axes.get("ep", 1) * axes.get("tp", 1) > 1:
            assert "ep+tp-bwd" in coll, coll
        if axes.get("dp", 1) > 1:
            assert {"grads", "dp-route", "dp-logits"} <= set(coll), coll


def test_the_drop_cases_drop_tokens():
    """The drop cases' capacity keeps at most ``E * capacity`` of a
    microbatch's ``2 * tokens`` routed choices, fewer than it has."""
    config = jmoe.MoEConfig.tiny()
    for name in ("train-drop", "train-dp-drop"):
        case = CASES[name]
        B, S = TOKENS[case["tokens"]].shape
        tokens = (B // case["M"]) * S
        cap = dataclasses.replace(config, capacity_factor=case["capacity_factor"]).capacity(
            tokens)
        assert config.experts * cap < 2 * tokens, (name, cap, tokens)
