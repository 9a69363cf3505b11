"""Gradients through the port's collectives, the ring and Ulysses, and the
dense sequence-parallel training step, against the JAX package.

- Each differentiable collective of ``parallel/mesh.py`` (``sum``,
  ``enter``, ``permute``, ``all_gather``, ``all_to_all``) in a gloo world
  at ``{dp: 2, sp: 2, tp: 2}``: every rank's input gradient equals the
  gradient of the one-process function (the collective written over the
  whole arrays in numpy), exactly up to f32 rounding (1e-6).
- The ring and Ulysses backward against ``jax.grad`` of the JAX package's
  ``ring_attention``/``ulysses_attention`` on ``tests/test_ring.py``'s
  meshes (causal and not, heads on ``tp``, the GQA expansion): every
  rank's q/k/v gradient within 1e-5 of the JAX gradient's block.
- ``__graft_entry__.py``'s dense step (``llama_forward_sp``, NLL) at
  ``{dp: 2, sp: 2, tp: 2}``, ring and Ulysses: each rank's loss and its
  gradient of every leaf (after ``sync_grads``) within 1e-4 of JAX's
  ``value_and_grad`` (the gradient's tolerance relative to the leaf's
  largest).
- A ``{tp: 2}`` engine wave's collectives move what they moved before the
  collectives carried gradients: the same tags, calls and bytes.
- The flash wrapper's plain route still differentiates (its gradient is
  ``jax.grad`` of the JAX ``dense_attention`` within 1e-5), and the guard
  that keeps a kernel out of a graph raises only under grad mode.

Every world ends through ``parallel.mesh.shutdown()`` and every rank must
exit 0.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import llama as jllama
from langstream_tpu.parallel import ring as jring
from langstream_tpu.parallel.mesh import make_mesh as jax_make_mesh
from test_torch_lockstep import spawn_world, world_outputs
from test_torch_ring import _block, _coords, _flat, _qkv, run_world

EXACT = dict(atol=1e-6, rtol=1e-6)
ATTN_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = 1e-4

_RANK = r'''
import dataclasses, json, sys
import numpy as np, torch
from langstream_tpu_torch.models import llama as tl
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.parallel import ring
from langstream_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown, sync_grads

rank, coordinator, path, world = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
cases = json.loads(open(path + "/cases.json").read())
init_distributed(coordinator, world, rank, "cpu", timeout_s=60)
data = np.load(path + "/inputs.npz")
COTANGENT = {"sum": "cs", "all_gather": "cg", "all_to_all": "ca"}


def block(a, mesh, dims):
    for dim, axes in dims.items():
        n = mesh.size(*axes)
        step = a.shape[dim] // n
        a = a.narrow(dim, mesh.index(*axes) * step, step)
    return a


def leaves(t, prefix=""):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


results = {}
for name, case in cases.items():
    mesh = make_mesh(case["axes"])
    kind = case["kind"]
    if kind == "collective":
        op = case["op"]
        x = torch.from_numpy(data[f"x{rank}"]).requires_grad_(True)
        c = torch.from_numpy(data[f"{COTANGENT.get(op, 'c')}{rank}"])
        if op == "sum":
            y = mesh.sum(x, "sp")
        elif op == "enter":
            y = mesh.enter(x, "tp")
        elif op == "permute":
            y = mesh.permute(x, "sp", case["shift"])
        elif op == "all_gather":
            y = mesh.all_gather(x, "sp", dim=1)
        else:
            y = mesh.all_to_all(x, "sp", split_dim=2, concat_dim=1)
        (y * c).sum().backward()
        results[name + ".y"] = y.detach().numpy()
        results[name + ".grad"] = x.grad.numpy()
        results[name + ".collectives"] = np.array(json.dumps(mesh.describe()["collectives"]))
    elif kind in ("ring", "ulysses"):
        dims = {0: ("dp",), 1: ("sp",)}
        if case.get("tp"):
            dims[2] = ("tp",)
        q, k, v = (block(torch.from_numpy(data[f"{case['qkv']}.{x}"]), mesh, dims)
                   .clone().requires_grad_(True) for x in "qkv")
        cot = block(torch.from_numpy(data[f"{case['qkv']}.cot"]), mesh, dims)
        fn = ring.ring_attention if kind == "ring" else ring.ulysses_attention
        (fn(q, k, v, mesh, causal=case["causal"]) * cot).sum().backward()
        for x, t in zip("qkv", (q, k, v)):
            results[f"{name}.d{x}"] = t.grad.numpy()
    else:  # the dense sequence-parallel training step
        config = dataclasses.replace(tl.LlamaConfig.tiny(max_seq_len=64), dtype=torch.float32)
        tree = {"layers": {}}
        for key in data.files:
            if key.startswith("llama.layers."):
                tree["layers"][key[len("llama.layers."):]] = data[key]
            elif key.startswith("llama."):
                tree[key[len("llama."):]] = data[key]
        params = tl.shard_llama_params(
            params_from_numpy(tree, device="cpu", dtype=torch.float32), config, mesh)
        for _, leaf in leaves(params):
            leaf.requires_grad_(True)
        tokens = torch.from_numpy(data["step_tokens"])
        logits = tl.llama_forward_sp(tl.local_config(config, mesh), params, tokens, mesh,
                                     attn=case["attn"])
        loss = tl.next_token_nll(logits, tokens, mesh)
        loss.backward()
        sync_grads(params, tl.rank_specs(tl.llama_param_specs(config), config, mesh), mesh)
        results[name + ".loss"] = loss.detach().numpy()
        for path_, leaf in leaves(params):
            results[f"{name}.grad.{path_}"] = leaf.grad.numpy()
        results[name + ".collectives"] = np.array(json.dumps(mesh.describe()["collectives"]))
np.savez(f"{path}/out{rank}.npz", **results)
shutdown()
'''

AXES = {"dp": 2, "sp": 2, "tp": 2}
WORLD = 8
X_SHAPE = (2, 4, 4, 3)  # (B, S-shard, H, D) per rank
COLLECTIVES = {
    "sum": {"kind": "collective", "axes": AXES, "op": "sum"},
    "enter": {"kind": "collective", "axes": AXES, "op": "enter"},
    "permute": {"kind": "collective", "axes": AXES, "op": "permute", "shift": 1},
    "permute-back": {"kind": "collective", "axes": AXES, "op": "permute", "shift": -1},
    "all_gather": {"kind": "collective", "axes": AXES, "op": "all_gather"},
    "all_to_all": {"kind": "collective", "axes": AXES, "op": "all_to_all"},
}
QKV = {"a": _qkv(seed=11), "b": _qkv(H=8, Kh=2, seed=12), "c": _qkv(H=8, Kh=8, seed=13)}
DP_SP = {"dp": 2, "sp": 4}
SP_TP = {"sp": 4, "tp": 2}
ATTENTION = {
    "ring-causal": {"kind": "ring", "axes": DP_SP, "qkv": "a", "causal": True},
    "ring-noncausal": {"kind": "ring", "axes": DP_SP, "qkv": "a", "causal": False},
    "ring-tp": {"kind": "ring", "axes": SP_TP, "qkv": "b", "causal": True, "tp": True},
    "ulysses-kh2": {"kind": "ulysses", "axes": DP_SP, "qkv": "b", "causal": True},
    "ulysses-kh8": {"kind": "ulysses", "axes": DP_SP, "qkv": "c", "causal": True},
}
STEPS = {f"step-{attn}": {"kind": "step", "axes": AXES, "attn": attn}
         for attn in ("ring", "ulysses")}
CASES = {**COLLECTIVES, **ATTENTION, **STEPS}


def _jax_llama():
    config = dataclasses.replace(jllama.LlamaConfig.tiny(max_seq_len=64), dtype=jnp.float32)
    return config, jllama.init_llama_params(config, jax.random.PRNGKey(7))


def _inputs() -> dict:
    """Each rank's ``x{r}`` (replicated over tp, as ``enter``'s input is)
    and its cotangents: ``c{r}`` of ``enter``'s and the permutes' outputs,
    ``cs{r}`` and ``cg{r}`` of the sum's and the all-gather's (replicated
    over sp, as the loss downstream of them is), ``ca{r}`` of the
    all-to-all's; the attention inputs and the step's tokens and params."""
    rng = np.random.RandomState(0)
    B, S, H, D = X_SHAPE
    n = AXES["sp"]
    draws = {key: {r: rng.randn(*shape).astype(np.float32) for r in range(WORLD)}
             for key, shape in (("x", X_SHAPE), ("c", X_SHAPE), ("cs", X_SHAPE),
                                ("cg", (B, n * S, H, D)), ("ca", (B, n * S, H // n, D)))}
    inputs = {}
    for r in range(WORLD):
        c = _coords(AXES, r)
        tp0 = r - int(c["tp"])          # this rank's peer at tp index 0
        sp0 = r - int(c["sp"]) * AXES["tp"]  # its peer at sp index 0
        inputs[f"x{r}"] = draws["x"][tp0]
        inputs[f"c{r}"], inputs[f"ca{r}"] = draws["c"][r], draws["ca"][r]
        inputs[f"cs{r}"], inputs[f"cg{r}"] = draws["cs"][sp0], draws["cg"][sp0]
    for name, qkv in QKV.items():
        for x, arr in qkv.items():
            inputs[f"{name}.{x}"] = arr
        inputs[f"{name}.cot"] = rng.randn(*qkv["q"].shape).astype(np.float32)
    inputs["step_tokens"] = rng.randint(0, 384, size=(4, 32)).astype(np.int32)
    inputs.update(_flat("llama", _jax_llama()[1]))
    return inputs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's outputs by rank, from one world of 8 started once."""
    inputs = _inputs()
    ranks = run_world(tmp_path_factory.mktemp("train_sp"), WORLD, CASES, inputs,
                      script=_RANK)
    return inputs, {name: [{k[len(name) + 1:]: v for k, v in rank.items()
                            if k.startswith(name + ".")} for rank in ranks]
                    for name in CASES}


def _peers(rank: int, axis: str) -> list[int]:
    """The ranks of ``rank``'s group along ``axis``, in axis order."""
    c = _coords(AXES, rank)
    return [r for r in range(WORLD)
            if all(_coords(AXES, r)[a] == c[a] for a in AXES if a != axis)]


def _expected(op: str, inputs: dict, rank: int, shift: int = 1):
    """``(y, dx)`` of the one-process function at ``rank``: the collective
    over its group's whole arrays, and the gradient of the whole objective
    (each rank's ``sum(y * c)`` added up, a replicated loss counted once)."""
    x = {r: inputs[f"x{r}"] for r in range(WORLD)}
    c = {r: inputs[f"{dict(sum='cs', all_gather='cg', all_to_all='ca').get(op, 'c')}{r}"]
         for r in range(WORLD)}
    axis = "tp" if op == "enter" else "sp"
    group = _peers(rank, axis)
    i = group.index(rank)
    n = len(group)
    if op == "sum":  # replicated output, one loss: dx is its cotangent
        return sum(x[r] for r in group), c[rank]
    if op == "enter":  # each rank's own work on the replicated x
        return x[rank], sum(c[r] for r in group)
    if op == "permute":  # rank i's x lands on rank i + shift
        return x[group[(i - shift) % n]], c[group[(i + shift) % n]]
    if op == "all_gather":
        return np.concatenate([x[r] for r in group], axis=1), np.split(c[rank], n, axis=1)[i]
    # all_to_all: sequence-sharded in, head-sharded out, over the whole array
    whole_x = np.concatenate([x[r] for r in group], axis=1)  # (B, S, H, D)
    whole_c = np.concatenate([c[r] for r in group], axis=2)  # cotangent by heads
    heads = whole_x.shape[2] // n
    return whole_x[:, :, i * heads:(i + 1) * heads], np.split(whole_c, n, axis=1)[i]


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_gradients_match_the_one_process_function(name, world):
    """Every rank's output and input gradient equal the one-process
    function's; the backward's traffic is counted under ``<tag>-bwd``
    (none for the all-gather, whose backward takes a slice, nor for the
    sum, whose backward is the identity)."""
    inputs, outs = world
    case = COLLECTIVES[name]
    for rank, out in enumerate(outs[name]):
        y, dx = _expected(case["op"], inputs, rank, case.get("shift", 1))
        np.testing.assert_allclose(out["y"], y, **EXACT, err_msg=f"rank {rank}")
        np.testing.assert_allclose(out["grad"], dx, **EXACT, err_msg=f"rank {rank}")
        tags = set(json.loads(str(out["collectives"])))
        back = {t for t in tags if t.endswith("-bwd")}
        assert bool(back) == (case["op"] in ("enter", "permute", "all_to_all")), tags


def _jax_attention_grads(case: dict):
    qkv = QKV[case["qkv"]]
    q, k, v = (jnp.asarray(qkv[x]) for x in "qkv")
    cot = jnp.asarray(_inputs()[f"{case['qkv']}.cot"])
    axes = case["axes"]
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:math.prod(axes.values())])
    fn = jring.ring_attention if case["kind"] == "ring" else jring.ulysses_attention

    def objective(q, k, v):
        return jnp.sum(fn(q, k, v, jmesh, causal=case["causal"]) * cot)

    return [np.asarray(g) for g in jax.jit(jax.grad(objective, argnums=(0, 1, 2)))(q, k, v)]


@pytest.mark.parametrize("name", list(ATTENTION))
def test_attention_backward_matches_jax(name, world):
    """The q, k and v gradients of ``sum(attention(q, k, v) * cot)`` on
    every rank equal the blocks of the JAX package's ``jax.grad`` at the
    rank's coordinates (rows on dp, positions on sp, heads on tp), within
    1e-5. Causal ring ranks skip blocks, and still run every rotation's
    backward with their peers."""
    case = ATTENTION[name]
    grads = _jax_attention_grads(case)
    dims = {0: ("dp",), 1: ("sp",)}
    if case.get("tp"):
        dims[2] = ("tp",)
    for rank, out in enumerate(world[1][name]):
        for x, want in zip("qkv", grads):
            np.testing.assert_allclose(out[f"d{x}"], _block(want, case["axes"], rank, dims),
                                       **ATTN_TOL, err_msg=f"rank {rank} d{x}")


def _jax_step(attn: str):
    """``__graft_entry__.py``'s dense step on the JAX side: the loss and the
    gradients of ``llama_forward_sp``'s next-token NLL, flattened."""
    config, params = _jax_llama()
    jmesh = jax_make_mesh(dict(AXES), devices=jax.devices()[:WORLD])
    sharded = jllama.shard_llama_params(params, config, jmesh)
    tokens = jnp.asarray(_inputs()["step_tokens"])

    def loss_fn(p, t):
        logits = jllama.llama_forward_sp(config, p, t, jmesh, attn=attn)
        targets = t[:, 1:]
        logprobs = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logprobs, targets[..., None], axis=-1)
        return nll.mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(sharded, tokens)
    return float(loss), _flat("g", grads)


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_dense_sp_step_matches_jax(attn, world):
    """The dense step at ``{dp: 2, sp: 2, tp: 2}``: each rank takes its
    positions' targets from the whole tokens (the last position drops
    out), the NLL is summed over ``sp`` and ``dp`` over the global count,
    and ``sync_grads`` sums the gradients over ``dp`` and ``sp``. Every
    rank's loss and its gradient of every leaf it holds equal JAX's within
    1e-4 (the gradient's of the leaf's largest)."""
    from langstream_tpu_torch.models import llama as tl
    from langstream_tpu_torch.parallel.mesh import make_mesh

    loss, grads = _jax_step(attn)
    config = tl.LlamaConfig.tiny()
    for rank, out in enumerate(world[1][f"step-{attn}"]):
        mesh = make_mesh(AXES, world_size=WORLD, rank=rank, groups=False)
        specs = tl.rank_specs(tl.llama_param_specs(config), config, mesh)
        flat = {k: v for k, v in specs.items() if k != "layers"}
        flat.update({f"layers.{k}": v for k, v in specs["layers"].items()})
        assert abs(float(out["loss"]) - loss) <= STEP_TOL, (rank, float(out["loss"]), loss)
        for leaf, spec in flat.items():
            dims = {d: (e if isinstance(e, tuple) else (e,)) for d, e in enumerate(spec)
                    if e is not None}
            want = grads[f"g.{leaf}"]
            np.testing.assert_allclose(
                out[f"grad.{leaf}"], _block(want, AXES, rank, dims), rtol=0,
                atol=STEP_TOL * float(np.abs(want).max()), err_msg=f"rank {rank} {leaf}")
        coll = json.loads(str(out["collectives"]))
        assert {"tp-bwd", "logits-bwd", "grads", "loss"} <= set(coll), coll
        assert f"sp-{'ring' if attn == 'ring' else 'a2a'}-bwd" in coll, coll


# the collectives of a {tp: 2} wave of two single-prompt waves (pipeline
# off, so each dispatch is a fixed function of the prompt): the tags,
# calls and bytes the engine's forward moved before the collectives
# carried gradients
TP2_RESOURCE = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 128,
                "decode-chunk": 4, "pipeline": False, "mesh": {"tp": 2}}
TP2_PROMPTS = [["hello tpu world"], ["abcdefgh, ijklmnop"]]
TP2_COLLECTIVES = {
    "embed": [18, 32768], "tp": [72, 131072], "logits": [2, 3072], "logits-decode": [16, 98304],
}


def test_serving_collectives_are_unchanged(tmp_path):
    """A ``{tp: 2}`` engine serving two one-prompt waves, greedy: the
    leader's collectives by call site are the serving forward's own (no
    ``-bwd`` traffic under ``no_grad``), with the calls and bytes above."""
    procs, outs = spawn_world(tmp_path, 2, [TP2_RESOURCE], prompts=TP2_PROMPTS, max_tokens=8)
    lead = world_outputs(procs, outs)[0][0]
    got = {tag: [c["calls"], c["bytes"]] for tag, c in lead["mesh"]["collectives"].items()}
    assert got == TP2_COLLECTIVES


def test_flash_plain_route_differentiates_like_jax():
    """On the CPU the flash wrapper takes its plain version, whose gradient
    of ``sum(out * cot)`` is ``jax.grad`` of the JAX ``dense_attention``
    within 1e-5."""
    from langstream_tpu_torch.ops.flash_attention import flash_attention

    qkv = _qkv(B=2, S=24, H=4, Kh=2, D=16, seed=21)
    cot = np.random.RandomState(22).randn(*qkv["q"].shape).astype(np.float32)
    q, k, v = (torch.from_numpy(qkv[x]).requires_grad_(True) for x in "qkv")
    (flash_attention(q, k, v, causal=True) * torch.from_numpy(cot)).sum().backward()

    def objective(q, k, v):
        out = jring.dense_attention(q, k, v, causal=True, scale=1.0 / math.sqrt(16))
        return jnp.sum(out * cot)

    want = jax.grad(objective, argnums=(0, 1, 2))(*(jnp.asarray(qkv[x]) for x in "qkv"))
    for t, w in zip((q, k, v), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **ATTN_TOL)


def test_the_kernel_guard_refuses_only_a_recorded_call():
    """``refuse_grad`` (called by every kernel wrapper before a launch)
    raises, naming the kernel and its missing backward, when grad mode is
    on and an input (an int8 pool's tensors too) requires grad; it passes
    under ``no_grad`` and for inputs without a gradient."""
    from langstream_tpu_torch.ops import refuse_grad

    leaf = torch.ones(2, requires_grad=True)
    plain = torch.ones(2)
    with pytest.raises(RuntimeError, match="flash_attention: the CUDA kernel has no backward"):
        refuse_grad("flash_attention", plain, leaf)
    with pytest.raises(RuntimeError, match="paged_attention_q8"):
        refuse_grad("paged_attention_q8", plain, {"q": plain, "s": leaf})
    refuse_grad("flash_attention", plain, {"q": plain, "s": plain})
    with torch.no_grad():
        refuse_grad("flash_attention", leaf)
