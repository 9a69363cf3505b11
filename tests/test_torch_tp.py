"""Serving under a mesh: the port's per-rank reads and its TP/DP/EP engines
against the JAX package's.

- (c) The per-rank paged read (``ops/paged_attention.py``
  ``shard_mapped_paged_read``): for every rank of the mesh, the single-query
  read over f32 and int8 pools and the multi-query history read give that
  rank's block (its rows on ``dp``, its heads on ``tp``) of what the JAX
  package's ``shard_mapped_paged_read`` returns, run as the JAX tests run
  it (the Pallas kernels in interpret mode on the 8 virtual CPU devices),
  including both degradations: a batch that does not divide ``dp`` and KV
  heads that do not divide ``tp``.
- (d) Engines: ``tiny`` in f32 under ``{tp: 2}`` and ``{dp: 2, tp: 2}``,
  dense and paged, paged with the prefix cache, chunked prefill and
  speculation, and ``moe-tiny`` under ``{ep: 2}`` and ``{ep: 2, tp: 2}``
  (the MoE specs name ``tp``, so the ep-only mesh carries ``tp: 1``, as the
  JAX engine needs), on the in-repo HF fixtures. The port runs as gloo
  processes of ``python -m langstream_tpu_torch.serving.lockstep_demo``
  (no JAX there), one world of 2 ranks and one of 4, started before the
  JAX engines run so both proceed at once; the leader's greedy tokens equal
  the JAX engine's under the same mesh, the logprobs agree within 1e-4,
  and every follower ends each dispatch with the leader's tokens.
"""

import os
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.ops import paged_attention as jops
from langstream_tpu.parallel.mesh import make_mesh as jax_make_mesh
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig, TpuServingEngine
from langstream_tpu_torch.ops import paged_attention as tops
from langstream_tpu_torch.parallel.mesh import make_mesh
from test_torch_lockstep import spawn_world, world_outputs

FIXTURES = Path(__file__).parent / "fixtures"
LLAMA = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 128,
         "decode-chunk": 4, "checkpoint": str(FIXTURES / "llama_tiny_golden")}
MOE = {**LLAMA, "model": "moe-tiny", "checkpoint": str(FIXTURES / "moe_tiny_golden")}
PAGED = {"kv-layout": "paged", "kv-block-size": 16}
PREAMBLE = "System: answer briefly and well. "  # two waves share it
WAVES = [["hello tpu world", PREAMBLE + "the quick brown fox", "abcdefgh, ijklmnop"],
         [PREAMBLE + "judge my vow", "a"]]
MAX_TOKENS = 8

# case -> (world size, resource configuration)
CASES = {
    "tp2-dense": (2, {**LLAMA, "mesh": {"tp": 2}}),
    "tp2-paged": (2, {**LLAMA, **PAGED, "prefix-cache": False, "mesh": {"tp": 2}}),
    "tp2-paged-prefix-chunked-speculative": (2, {
        **LLAMA, **PAGED, "prefix-cache": True, "prefill-chunk": 16,
        "speculative-drafts": 4, "mesh": {"tp": 2}}),
    "moe-ep2": (2, {**MOE, "mesh": {"ep": 2, "tp": 1}}),
    "dp2tp2-dense": (4, {**LLAMA, "mesh": {"dp": 2, "tp": 2}}),
    "dp2tp2-paged-prefix": (4, {**LLAMA, **PAGED, "mesh": {"dp": 2, "tp": 2}}),
    "moe-ep2tp2": (4, {**MOE, "mesh": {"ep": 2, "tp": 2}}),
    "moe-ep2tp2-paged": (4, {**MOE, **PAGED, "prefix-cache": False,
                             "mesh": {"ep": 2, "tp": 2}}),
}
# cases held against the port's own one-rank engine only
PORT_CASES = {
    "tp2-int8": (2, {**LLAMA, "quantize": "int8", "mesh": {"tp": 2}}),
}
WORLDS = {**CASES, **PORT_CASES}


# ---------------------------------------------------------------------------
# (c) the per-rank paged reads
# ---------------------------------------------------------------------------


def _read_case(B: int, Kh: int, G: int, D: int, *, int8: bool, T: int | None):
    rng = np.random.RandomState(7)
    bs, nb, nrb = 8, 14, 3
    H = Kh * G
    dtype = np.float32
    q_shape = (B, H, D) if T is None else (B, T, H, D)
    q = rng.randn(*q_shape).astype(dtype)
    if int8:
        def pool():
            return {"q": rng.randint(-127, 128, (nb, bs, Kh * D)).astype(np.int8),
                    "s": rng.uniform(0.01, 0.1, (nb, bs, Kh)).astype(np.float32)}
    else:
        def pool():
            return rng.randn(nb, bs, Kh * D).astype(dtype)
    pk, pv = pool(), pool()
    tables = np.stack([rng.permutation(np.arange(1, nb))[:nrb] for _ in range(B)]).astype(
        np.int32)
    lengths = rng.randint(1, nrb * bs + 1, size=B).astype(np.int32)
    return q, pk, pv, tables, lengths, nrb


def _heads(a: np.ndarray, axis: int, part: int, parts: int) -> np.ndarray:
    step = a.shape[axis] // parts
    return np.take(a, np.arange(part * step, (part + 1) * step), axis=axis)


@pytest.mark.parametrize("axes,B,Kh,int8,T", [
    ({"dp": 2, "tp": 2}, 4, 2, False, None),      # both axes split
    ({"dp": 2, "tp": 2}, 3, 2, False, None),      # batch does not divide dp
    ({"dp": 2, "tp": 4}, 4, 2, False, None),      # KV heads do not divide tp
    ({"dp": 2, "tp": 2}, 4, 2, True, None),       # int8 pool (kernel #3)
    ({"dp": 2, "tp": 2}, 4, 2, False, 16),        # multi-query history read
    ({"dp": 2, "tp": 4}, 3, 2, False, 16),        # ... with both degradations
], ids=["decode", "batch-not-dp", "kv-not-tp", "decode-int8", "multiquery",
        "multiquery-degraded"])
def test_per_rank_paged_read_matches_jax_shard_mapped_read(axes, B, Kh, int8, T):
    G, D = 2, 16
    q, pk, pv, tables, lengths, nrb = _read_case(B, Kh, G, D, int8=int8, T=T)
    world = int(np.prod(list(axes.values())))
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:world])
    jq = jnp.asarray(q, jnp.bfloat16) if int8 else jnp.asarray(q)
    if T is None:
        jfn = partial(jops.paged_attention_partial, num_read_blocks=nrb, head_dim=D,
                      interpret=True)
        tails = dict(q_spec_tail=("tp", None),
                     out_spec_tails=(("tp", None), ("tp",), ("tp",)))
        tfn = partial(tops.paged_attention_partial, num_read_blocks=nrb, head_dim=D)
        head_axis = 1
    else:
        jfn = partial(jops.paged_attention_multiquery_partial, num_read_blocks=nrb,
                      head_dim=D, interpret=True)
        tails = dict(q_spec_tail=(None, "tp", None),
                     out_spec_tails=((None, "tp", None), (None, "tp"), (None, "tp")))
        tfn = partial(tops.paged_attention_multiquery_partial, num_read_blocks=nrb,
                      head_dim=D)
        head_axis = 2
    tree = (lambda p: {k: jnp.asarray(v) for k, v in p.items()}) if int8 else jnp.asarray
    want = [np.asarray(o, np.float32) for o in jops.shard_mapped_paged_read(
        jfn, jmesh, kv_heads=Kh, batch=B, **tails)(
        jq, tree(pk), tree(pv), jnp.asarray(tables), jnp.asarray(lengths))]
    tp = axes["tp"]
    split_tp = Kh % tp == 0
    split_dp = B % axes["dp"] == 0
    torch_pool = ((lambda p: {k: torch.from_numpy(v) for k, v in p.items()}) if int8
                  else torch.from_numpy)
    for rank in range(world):
        mesh = make_mesh(dict(axes), world_size=world, rank=rank, groups=False)
        t_idx, d_idx = mesh.index("tp"), mesh.index("dp")
        q_r, pk_r, pv_r = q, pk, pv
        if split_tp:
            q_r = _heads(q, head_axis, t_idx, tp)
            cut = lambda a: _heads(a, a.ndim - 1, t_idx, tp)  # noqa: E731
            pk_r, pv_r = ((({k: cut(v) for k, v in p.items()}) if int8 else cut(p))
                          for p in (pk, pv))
        tq = torch.from_numpy(np.ascontiguousarray(q_r))
        if int8:
            tq = tq.to(torch.bfloat16)
        read = tops.shard_mapped_paged_read(tfn, mesh, kv_heads=Kh, batch=B)
        got = read(tq, torch_pool(pk_r), torch_pool(pv_r), torch.from_numpy(tables),
                   torch.from_numpy(lengths))
        assert read.split == ("dp" if split_dp else None, "tp" if split_tp else None)
        rows = slice(None) if not split_dp else slice(d_idx * B // axes["dp"],
                                                      (d_idx + 1) * B // axes["dp"])
        blocks = []
        for w in want:
            w = w[rows]
            if split_tp:
                w = _heads(w, head_axis, t_idx, tp)
            blocks.append(w)
        if int8:
            # bf16 queries: compare the normalised outputs, the JAX test's rule
            out_w = blocks[0] / np.maximum(blocks[2], 1e-30)[..., None]
            out_g = (got[0] / got[2].clamp(min=1e-30)[..., None]).float().numpy()
            np.testing.assert_allclose(out_g, out_w, rtol=5e-2, atol=5e-2)
        else:
            for g, w in zip(got, blocks):
                np.testing.assert_allclose(g.float().numpy(), w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (d) engines under a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_worlds(tmp_path_factory):
    """The two worlds, started at once; joined on first use."""
    started = {}
    for n in (2, 4):
        names = [name for name, (size, _) in WORLDS.items() if size == n]
        tmp = tmp_path_factory.mktemp(f"world{n}")
        procs, outs = spawn_world(tmp, n, [WORLDS[name][1] for name in names],
                                  prompts=WAVES, max_tokens=MAX_TOKENS)
        started[n] = (names, procs, outs)
    results: dict[str, dict] = {}

    def get(name: str) -> dict:
        n = WORLDS[name][0]
        if name not in results:
            names, procs, outs = started[n]
            ranks = world_outputs(procs, outs, timeout=300)
            for i, case in enumerate(names):
                results[case] = ranks[0][i]
        return results[name]

    yield get
    for _, procs, _ in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


async def _serve(engine):
    out = []
    try:
        for wave in WAVES:
            import asyncio

            out += await asyncio.gather(*(
                engine.generate(p, {"max-tokens": MAX_TOKENS, "temperature": 0.0})
                for p in wave))
    finally:
        await engine.close()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_tokens_equal_the_jax_engine(case, port_worlds, run_async):
    _, cfg = CASES[case]
    jax_engine = TpuServingEngine(JaxServingConfig.from_dict(cfg))
    want = run_async(_serve(jax_engine))
    TpuServingEngine.reset_instances()
    got = port_worlds(case)
    assert got["mesh"]["axes"] == cfg["mesh"]
    assert got["mesh"]["world-size"] == CASES[case][0]
    assert got["mesh"]["lockstep-role"] == "leader"
    assert got["tokens"] == [list(r["tokens"]) for r in want]
    for g, w in zip(got["logprobs"], want):
        np.testing.assert_allclose(g, w["logprobs"], atol=1e-4)
    if "speculative-drafts" in cfg:
        # every lockstep op ran: chunked prefill continues, a prefix hit,
        # verify steps
        assert got["continue-calls"] > 0 and got["speculative-steps"] > 0
        assert got["prefix"]["hits"] > 0


def test_a_tp_rank_holds_half_the_weights(port_worlds, run_async):
    """A rank under ``{tp: 2}`` keeps only its shards (the checkpoint's tree
    is sharded on the host and only the shards move): about half the
    weight bytes of a one-rank engine on the same checkpoint."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    cfg = {k: v for k, v in CASES["tp2-dense"][1].items() if k != "mesh"}
    one = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")
    run_async(one.close())
    share = port_worlds("tp2-dense")["mesh"]["weights-bytes"] / one._weights_bytes
    assert 0.45 < share < 0.6, share


def test_an_int8_checkpoint_serves_as_the_one_rank_engine(port_worlds, run_async):
    """``{tp: 2}`` with ``quantize: int8`` from a checkpoint: each rank
    quantizes every stacked weight one layer at a time over the whole
    contraction axis before it keeps its shard (a row-parallel weight's
    scales are the whole tree's), so its streams are the one-rank engine's
    and it holds half its bytes."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    cfg = {k: v for k, v in PORT_CASES["tp2-int8"][1].items() if k != "mesh"}
    one = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")
    want = run_async(_serve(one))
    got = port_worlds("tp2-int8")
    assert got["tokens"] == [list(r["tokens"]) for r in want]
    for g, w in zip(got["logprobs"], want):
        np.testing.assert_allclose(g, w["logprobs"], atol=1e-4)
    share = got["mesh"]["weights-bytes"] / one._weights_bytes
    assert 0.45 < share < 0.6, share


def test_dp_replicas_run_their_own_slots_rows(port_worlds):
    """Under ``{dp: 2, tp: 2}`` each dp replica runs the rows of its own
    slots: the model issues no dp collective of its own, the
    engine sums each dispatch's outputs over ``dp`` once, and the leader's
    replica embeds (and so computes) well under the rows the tp-only
    engine does on the same workload."""
    dp, tp_only = port_worlds("dp2tp2-dense")["mesh"], port_worlds("tp2-dense")["mesh"]
    assert dp["dp-slots"] == [0, 2] and tp_only["dp-slots"] is None
    assert dp["dp-prefill-split"]
    # the prefix cache hands prompt blocks across slots: every replica
    # prefills every row, and splits the decode and verify rows only
    assert not port_worlds("dp2tp2-paged-prefix")["mesh"]["dp-prefill-split"]
    coll = dp["collectives"]
    assert set(coll) <= {"embed", "tp", "logits", "logits-decode", "dp-rows"}, coll
    assert coll["dp-rows"]["calls"] == dp["lockstep-dispatches"]
    assert "dp-rows" not in tp_only["collectives"]
    share = coll["embed"]["bytes"] / tp_only["collectives"]["embed"]["bytes"]
    assert share < 0.75, share


_MOE_RANK = """
import dataclasses, sys, numpy as np, torch
from langstream_tpu_torch.models import moe as tm
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.parallel.mesh import init_distributed, make_mesh
rank, coordinator, path, axes = int(sys.argv[1]), sys.argv[2], sys.argv[3], eval(sys.argv[4])
world = int(np.prod(list(axes.values())))
init_distributed(coordinator, world, rank, "cpu", timeout_s=60)
data = np.load(path + "/inputs.npz")
flat = {k: data[k] for k in data.files}
tree = {"layers": {}}
for k, v in flat.items():
    if k.startswith("layers."):
        tree["layers"][k[len("layers."):]] = v
    elif k != "tokens":
        tree[k] = v
params = params_from_numpy(tree, device="cpu", dtype=torch.float32)
config = dataclasses.replace(tm.MoEConfig.tiny(), dtype=torch.float32)
logits, aux = tm.moe_forward_sharded(config, params, torch.from_numpy(data["tokens"]),
                                     make_mesh(axes))
np.save(f"{path}/logits{rank}.npy", logits.numpy())
"""


@pytest.mark.parametrize("axes", [{"ep": 2, "tp": 1}, {"ep": 2, "tp": 2}], ids=str)
def test_moe_forward_sharded_matches_jax(axes, tmp_path):
    """``moe_forward_sharded`` on every rank of a gloo world gives the whole
    batch's logits of the JAX package's ``moe_forward_sharded`` under the
    same mesh (f32, within 1e-4)."""
    import dataclasses
    import subprocess
    import sys

    from langstream_tpu.models import moe as jm
    from test_torch_lockstep import REPO, free_port

    c = dataclasses.replace(jm.MoEConfig.tiny(), dtype=jnp.float32)
    params = jm.init_moe_params(c, jax.random.PRNGKey(2))
    tokens = np.random.RandomState(0).randint(1, c.vocab_size, size=(2, 12)).astype(np.int32)
    world = int(np.prod(list(axes.values())))
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:world])
    want = np.asarray(jm.moe_forward_sharded(c, params, jnp.asarray(tokens), jmesh)[0])
    flat = {"tokens": tokens, "embed": np.asarray(params["embed"]),
            "final_norm": np.asarray(params["final_norm"]),
            "lm_head": np.asarray(params["lm_head"])}
    flat.update({f"layers.{k}": np.asarray(v) for k, v in params["layers"].items()})
    np.savez(tmp_path / "inputs.npz", **flat)
    coordinator = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _MOE_RANK, str(r), coordinator,
                               str(tmp_path), repr(axes)], cwd=REPO, env=env,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for r in range(world)]
    try:
        errs = [p.communicate(timeout=120)[1].decode(errors="replace")[-2000:] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {rank}: {err}"
        np.testing.assert_allclose(np.load(tmp_path / f"logits{rank}.npy"), want,
                                   atol=1e-4, rtol=1e-4)
