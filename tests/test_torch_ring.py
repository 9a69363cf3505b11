"""Sequence parallelism in the port (``langstream_tpu_torch/parallel/ring.py``,
the sp prefill of ``models/llama.py`` and ``models/moe.py``) against the JAX
package's.

The JAX side runs as ``tests/test_ring.py`` runs it: global arrays under
``shard_map`` on the 8 virtual CPU devices. The port side runs one gloo
process per rank (no JAX there); each rank computes its shard and writes
it, and the test holds every rank's shard against the JAX output's block
at that rank's coordinates.

- Ring attention (causal and not, and with ``tp`` heads) and Ulysses
  (``Kh`` 2 and 8, the GQA expansion) on ``tests/test_ring.py``'s meshes,
  within 1e-5.
- ``llama_forward_sp`` (ring and Ulysses) on ``{dp: 2, sp: 2, tp: 2}``,
  within 1e-4 (f32 through two layers and the LM head).
- The sp prefill (``prefill_forward``): last-token logits and the K/V of
  every layer, whole on every ``sp`` rank, within 1e-5, at ``{sp: 2}`` and
  ``{sp: 4, tp: 2}``; a prompt whose padded length does not divide ``sp``
  takes the non-ring path in both packages; MoE-tiny at ``{sp: 2}`` with a
  capacity that drops tokens.

Every world ends through ``parallel.mesh.shutdown()`` and every rank must
exit 0.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import llama as jllama
from langstream_tpu.models import moe as jmoe
from langstream_tpu.parallel import ring as jring
from langstream_tpu.parallel.mesh import make_mesh as jax_make_mesh
from test_torch_lockstep import REPO, free_port

RING_TOL = dict(atol=1e-5, rtol=1e-5)

# a rank of a port world: runs every case of cases.json on its shard
_RANK = r'''
import dataclasses, json, sys
import numpy as np, torch
from langstream_tpu_torch.models import llama as tl, moe as tm
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.parallel import ring
from langstream_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown

rank, coordinator, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
cases = json.loads(open(path + "/cases.json").read())
world = int(sys.argv[4])
init_distributed(coordinator, world, rank, "cpu", timeout_s=60)
data = np.load(path + "/inputs.npz")


def tree(prefix):
    out = {"layers": {}}
    for k in data.files:
        if not k.startswith(prefix + "."):
            continue
        name = k[len(prefix) + 1:]
        if name.startswith("layers."):
            out["layers"][name[len("layers."):]] = data[k]
        else:
            out[name] = data[k]
    return params_from_numpy(out, device="cpu", dtype=torch.float32)


def block(a, mesh, dims):
    # this rank's block of a global array: dims maps a dimension to its axes
    for dim, axes in dims.items():
        n = mesh.size(*axes)
        step = a.shape[dim] // n
        a = a.narrow(dim, mesh.index(*axes) * step, step)
    return a


results = {}
for name, case in cases.items():
    mesh = make_mesh(case["axes"])
    kind = case["kind"]
    if kind in ("ring", "ulysses"):
        q, k, v = (torch.from_numpy(data[f"{case['qkv']}.{x}"]) for x in "qkv")
        dims = {0: ("dp",), 1: ("sp",)}
        if case.get("tp"):
            dims[2] = ("tp",)
        q, k, v = (block(x, mesh, dims) for x in (q, k, v))
        fn = ring.ring_attention if kind == "ring" else ring.ulysses_attention
        results[name] = fn(q, k, v, mesh, causal=case["causal"]).numpy()
    elif kind == "forward_sp":
        config = dataclasses.replace(tl.LlamaConfig.tiny(max_seq_len=64), dtype=torch.float32)
        params = tl.shard_llama_params(tree("llama"), config, mesh)
        results[name] = tl.llama_forward_sp(
            tl.local_config(config, mesh), params, torch.from_numpy(data["fwd_tokens"]),
            mesh, attn=case["attn"]).numpy()
    elif kind == "prefill":
        tokens = torch.from_numpy(data[case["tokens"]])
        lengths = torch.from_numpy(data[case["tokens"] + "_lengths"])
        if case.get("moe"):
            config = dataclasses.replace(tm.MoEConfig.tiny(), dtype=torch.float32,
                                         capacity_factor=case["moe"])
            params = tm.shard_moe_params(tree("moe"), config, mesh)
            local = tl.local_config(config, mesh)
            ffn = tm.moe_serving_ffn(local, mesh=mesh)
        else:
            config = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
            params = tl.shard_llama_params(tree("llama"), config, mesh)
            local, ffn = tl.local_config(config, mesh), None
        logits, ks, vs = tl.prefill_forward(local, params, tokens, lengths, ffn=ffn)
        results[name + ".logits"] = logits.numpy()
        results[name + ".ks"] = ks.numpy()
        results[name + ".vs"] = vs.numpy()
        results[name + ".collectives"] = np.array(sorted(mesh.collectives))
np.savez(f"{path}/out{rank}.npz", **results)
shutdown()
'''


def run_world(tmp_path: Path, world: int, cases: dict, inputs: dict,
              timeout: float = 240.0, script: str = _RANK) -> list[dict]:
    """Run ``cases`` on every rank of a gloo world of ``world`` processes
    (``script`` is a rank's program: argv rank, coordinator, directory,
    world size; it writes ``out<rank>.npz``); each rank's outputs by name.
    Every rank must exit 0."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    np.savez(tmp_path / "inputs.npz", **inputs)
    (tmp_path / "cases.json").write_text(json.dumps(cases))
    coordinator = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(r), coordinator, str(tmp_path),
                 str(world)], cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=log))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        log = (tmp_path / f"rank{r}.log").read_text(errors="replace")[-3000:]
        assert p.returncode == 0, f"rank {r} exited {p.returncode}: {log}"
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


def _coords(axes: dict, rank: int) -> dict:
    return dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))


def _block(a: np.ndarray, axes: dict, rank: int, dims: dict) -> np.ndarray:
    """The JAX output's block at ``rank``'s coordinates: ``dims`` maps a
    dimension to the axes it splits over (first axis major)."""
    c = _coords(axes, rank)
    for dim, names in dims.items():
        n = int(np.prod([axes.get(x, 1) for x in names]))
        idx = 0
        for x in names:
            idx = idx * axes.get(x, 1) + int(c.get(x, 0))
        step = a.shape[dim] // n
        a = np.take(a, np.arange(idx * step, (idx + 1) * step), axis=dim)
    return a


def _qkv(B=2, S=32, H=8, Kh=4, D=16, seed=0) -> dict:
    rng = np.random.RandomState(seed)
    return {x: rng.randn(B, S, n, D).astype(np.float32)
            for x, n in (("q", H), ("k", Kh), ("v", Kh))}


def _flat(prefix: str, params: dict) -> dict:
    out = {f"{prefix}.{k}": np.asarray(v) for k, v in params.items() if k != "layers"}
    out.update({f"{prefix}.layers.{k}": np.asarray(v) for k, v in params["layers"].items()})
    return out


def _jax_llama():
    config = dataclasses.replace(jllama.LlamaConfig.tiny(max_seq_len=64), dtype=jnp.float32)
    return config, jllama.init_llama_params(config, jax.random.PRNGKey(3))


def _jax_moe(capacity_factor: float):
    config = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=jnp.float32,
                                 capacity_factor=capacity_factor)
    return config, jmoe.init_moe_params(config, jax.random.PRNGKey(4))


def _prompts(B: int, P: int, lengths, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 384, size=(B, P)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    for b, n in enumerate(lengths):
        tokens[b, n:] = 0  # right padding
    return tokens, lengths


QKV = {"a": _qkv(), "b": _qkv(H=8, Kh=2), "c": _qkv(H=8, Kh=8)}
DP_SP = {"dp": 2, "sp": 4}
SP_TP = {"sp": 4, "tp": 2}
WORLD8 = {
    "ring-causal": {"kind": "ring", "axes": DP_SP, "qkv": "a", "causal": True},
    "ring-noncausal": {"kind": "ring", "axes": DP_SP, "qkv": "a", "causal": False},
    "ring-tp": {"kind": "ring", "axes": SP_TP, "qkv": "b", "causal": True, "tp": True},
    "ulysses-kh2": {"kind": "ulysses", "axes": DP_SP, "qkv": "b", "causal": True},
    "ulysses-kh8": {"kind": "ulysses", "axes": DP_SP, "qkv": "c", "causal": True},
    "forward-ring": {"kind": "forward_sp", "axes": {"dp": 2, "sp": 2, "tp": 2},
                     "attn": "ring"},
    "forward-ulysses": {"kind": "forward_sp", "axes": {"dp": 2, "sp": 2, "tp": 2},
                        "attn": "ulysses"},
    # P = 32 divides sp = 4: the ring; P = 30 does not: every rank prefills whole
    "prefill-sp4tp2": {"kind": "prefill", "axes": SP_TP, "tokens": "p32"},
    "prefill-sp4tp2-nodiv": {"kind": "prefill", "axes": SP_TP, "tokens": "p30"},
}
MOE_CAPACITY = 0.5  # capacity = ceil(B*P / 4): every expert overflows
WORLD2 = {
    "prefill-sp2": {"kind": "prefill", "axes": {"sp": 2}, "tokens": "p32"},
    "moe-prefill-sp2": {"kind": "prefill", "axes": {"sp": 2}, "tokens": "p32",
                        "moe": MOE_CAPACITY},
}
PROMPTS = {"p32": _prompts(3, 32, [32, 19, 1], 5), "p30": _prompts(3, 30, [30, 17, 9], 6)}


def _inputs() -> dict:
    inputs = {f"{name}.{x}": arr for name, qkv in QKV.items() for x, arr in qkv.items()}
    inputs["fwd_tokens"] = np.random.RandomState(1).randint(
        0, 384, size=(2, 32)).astype(np.int32)
    inputs.update(_flat("llama", _jax_llama()[1]))
    inputs.update(_flat("moe", _jax_moe(MOE_CAPACITY)[1]))
    for name, (tokens, lengths) in PROMPTS.items():
        inputs[name], inputs[name + "_lengths"] = tokens, lengths
    return inputs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' outputs, each world started once for the module."""
    inputs = _inputs()
    root = tmp_path_factory.mktemp("ring")
    return {8: run_world(root / "w8", 8, WORLD8, inputs),
            2: run_world(root / "w2", 2, WORLD2, inputs)}


def _jax_attention(case: dict) -> np.ndarray:
    qkv = QKV[case["qkv"]]
    q, k, v = (jnp.asarray(qkv[x]) for x in "qkv")
    axes = case["axes"]
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:int(np.prod(list(axes.values())))])
    fn = jring.ring_attention if case["kind"] == "ring" else jring.ulysses_attention
    return np.asarray(fn(q, k, v, jmesh, causal=case["causal"]))


@pytest.mark.parametrize("name", ["ring-causal", "ring-noncausal", "ring-tp",
                                  "ulysses-kh2", "ulysses-kh8"])
def test_attention_shards_match_jax(name, worlds):
    """Every rank's output shard equals the JAX output's block at its
    coordinates (rows on dp, positions on sp, heads on tp), within 1e-5."""
    case = WORLD8[name]
    want = _jax_attention(case)
    dims = {0: ("dp",), 1: ("sp",)}
    if case.get("tp"):
        dims[2] = ("tp",)
    for rank, out in enumerate(worlds[8]):
        np.testing.assert_allclose(out[name], _block(want, case["axes"], rank, dims),
                                   **RING_TOL, err_msg=f"rank {rank}")


def test_ulysses_refuses_heads_that_do_not_divide_sp():
    """The JAX package's error, from the port's all-to-all (checked before
    any transfer, so a one-process mesh view shows it)."""
    from langstream_tpu_torch.parallel.mesh import make_mesh
    from langstream_tpu_torch.parallel.ring import ulysses_attention

    mesh = make_mesh({"sp": 4}, world_size=4, rank=0, groups=False)
    mesh._groups = {("sp",): object()}  # a group, so the check is reached
    q = torch.ones(1, 2, 6, 4)
    with pytest.raises(ValueError, match=r"split_axis \(6\) has to be divisible by "
                                         r"the size of the named axis sp \(4\)"):
        ulysses_attention(q, torch.ones(1, 2, 4, 4), torch.ones(1, 2, 4, 4), mesh)
    q = jnp.ones((1, 8, 6, 4))
    jmesh = jax_make_mesh({"sp": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match=r"split_axis \(6\) has to be divisible by "
                                         r"the size of the named axis sp \(4\)"):
        jring.ulysses_attention(q, jnp.ones((1, 8, 4, 4)), jnp.ones((1, 8, 4, 4)), jmesh)


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_llama_forward_sp_matches_jax(attn, worlds):
    """``llama_forward_sp`` at ``{dp: 2, sp: 2, tp: 2}``: each rank's
    ``(B/dp, S/sp, V)`` logits equal the block of the JAX package's
    ``llama_forward_sp`` on the same params (within 1e-4)."""
    config, params = _jax_llama()
    axes = WORLD8[f"forward-{attn}"]["axes"]
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:8])
    sharded = jllama.shard_llama_params(params, config, jmesh)
    tokens = jnp.asarray(_inputs()["fwd_tokens"])
    want = np.asarray(jax.jit(
        lambda p, t: jllama.llama_forward_sp(config, p, t, jmesh, attn=attn))(sharded, tokens))
    for rank, out in enumerate(worlds[8]):
        np.testing.assert_allclose(out[f"forward-{attn}"],
                                   _block(want, axes, rank, {0: ("dp",), 1: ("sp",)}),
                                   atol=1e-4, rtol=1e-4, err_msg=f"rank {rank}")


def _jax_prefill(case: dict, monkeypatch) -> tuple:
    """The JAX prefill under the case's mesh, and how often it reached
    ``ring_attention`` (traced once per layer scan)."""
    axes = case["axes"]
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:int(np.prod(list(axes.values())))])
    tokens, lengths = PROMPTS[case["tokens"]]
    calls = []
    real = jring.ring_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jring, "ring_attention", counted)
    if case.get("moe"):
        config, params = _jax_moe(case["moe"])
        ffn = jmoe.moe_serving_ffn(config)
    else:
        config, params = dataclasses.replace(
            jllama.LlamaConfig.tiny(), dtype=jnp.float32), _jax_llama()[1]
        ffn = None
    logits, ks, vs = jllama.prefill_forward(config, params, jnp.asarray(tokens),
                                            jnp.asarray(lengths), mesh=jmesh, ffn=ffn)
    return (np.asarray(logits), np.asarray(ks), np.asarray(vs)), len(calls)


@pytest.mark.parametrize("name,world", [("prefill-sp2", 2), ("prefill-sp4tp2", 8),
                                        ("prefill-sp4tp2-nodiv", 8),
                                        ("moe-prefill-sp2", 2)])
def test_sp_prefill_matches_jax(name, world, worlds, monkeypatch):
    """The sp prefill's last-token logits and every layer's K/V at the
    real positions (this rank's KV heads on tp, whole along the sequence on
    every sp rank) equal the JAX package's ``prefill_forward`` under the same mesh within
    1e-5. The ring runs exactly when the padded length divides sp, in both
    packages: a ring prefill counts the ``sp-ring``, ``sp-kv`` and
    ``sp-last`` collectives, the other path none of them."""
    case = {**WORLD8, **WORLD2}[name]
    (logits, ks, vs), jax_ring_calls = _jax_prefill(case, monkeypatch)
    ring_path = PROMPTS[case["tokens"]][0].shape[1] % case["axes"]["sp"] == 0
    assert (jax_ring_calls > 0) == ring_path
    tp = case["axes"].get("tp", 1)
    for rank, out in enumerate(worlds[world]):
        msg = f"rank {rank}"
        np.testing.assert_allclose(out[name + ".logits"], logits, **RING_TOL, err_msg=msg)
        for got, want in ((out[name + ".ks"], ks), (out[name + ".vs"], vs)):
            want = _block(want, case["axes"], rank, {3: ("tp",)}) if tp > 1 else want
            # the rows a cache keeps: a padded position's K/V is garbage the
            # cache overwrites before reading (the JAX dense path masks
            # padded keys, the port's causal attention does not)
            for b, n in enumerate(PROMPTS[case["tokens"]][1]):
                np.testing.assert_allclose(got[:, b, :n], want[:, b, :n], **RING_TOL,
                                           err_msg=f"{msg} row {b}")
        coll = set(out[name + ".collectives"].tolist())
        assert ({"sp-ring", "sp-kv", "sp-last"} <= coll) == ring_path, coll
        assert not ring_path or "sp-ring" in coll
        if not ring_path:
            assert not coll & {"sp-ring", "sp-kv", "sp-last"}, coll
        if case.get("moe"):
            assert "sp-moe" in coll, coll


def test_the_moe_case_drops_tokens():
    """The MoE case's capacity drops routed choices at the first layer (so
    the sp prefill is held to the whole batch's drops, not a shard's)."""
    from langstream_tpu_torch.models import llama as tl
    from langstream_tpu_torch.models import moe as tm
    from langstream_tpu_torch.models.convert import params_from_numpy

    jconfig, jparams = _jax_moe(MOE_CAPACITY)
    flat = {k: np.asarray(v) for k, v in jparams.items() if k != "layers"}
    flat["layers"] = {k: np.asarray(v) for k, v in jparams["layers"].items()}
    params = params_from_numpy(flat, device="cpu", dtype=torch.float32)
    config = dataclasses.replace(tm.MoEConfig.tiny(), dtype=torch.float32,
                                 capacity_factor=MOE_CAPACITY)
    tokens, lengths = (torch.from_numpy(a) for a in PROMPTS["p32"])
    ffn = tm.moe_serving_ffn(config)
    dropped = []

    def spy(h, lp, valid=None):
        B, S, H = h.shape
        cap = config.capacity(B * S)
        _, slots, _, _ = tm.top2_routing(h.reshape(-1, H).float() @ lp["router"], cap,
                                         valid.reshape(-1))
        dropped.append(int(((slots == cap) & valid.reshape(-1, 1)).sum()))
        return ffn(h, lp, valid)

    tl.prefill_forward(config, params, tokens, lengths, ffn=spy)
    assert dropped[0] > 0, dropped
