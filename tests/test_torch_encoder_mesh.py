"""The embeddings engine under a mesh: the port's encoder
(``langstream_tpu_torch/models/encoder.py``: ``encoder_param_specs``,
``shard_encoder_params``, ``encode(mesh=)``) against the JAX package's
``encode`` with ``encoder_param_specs`` placement, and the port's
``EmbeddingEngine`` under ``mesh`` (its calls replayed on every rank through
the lockstep ``embed`` frame) against the one-rank engine.

The port side runs one gloo process per rank (no JAX there). Every world
ends through ``parallel.mesh.shutdown()`` and every rank must exit 0.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from langstream_tpu.models import encoder as jenc
from langstream_tpu.parallel.mesh import make_mesh as jax_make_mesh
from langstream_tpu_torch.models import encoder as tenc
from langstream_tpu_torch.parallel.mesh import P
from test_torch_lockstep import spawn_world, world_outputs
from test_torch_ring import _flat, run_world

TOL = dict(atol=1e-5, rtol=1e-5)

_RANK = r'''
import json, sys
import numpy as np, torch
from langstream_tpu_torch.models import encoder as te
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown

rank, coordinator, path, world = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
cases = json.loads(open(path + "/cases.json").read())
init_distributed(coordinator, world, rank, "cpu", timeout_s=60)
data = np.load(path + "/inputs.npz")
tree = {"layers": {}}
for k in data.files:
    if k.startswith("enc.layers."):
        tree["layers"][k[len("enc.layers."):]] = data[k]
    elif k.startswith("enc."):
        tree[k[len("enc."):]] = data[k]
params = params_from_numpy(tree, device="cpu", dtype=torch.float32)
config = te.EncoderConfig.tiny()
results = {}
for name, case in cases.items():
    mesh = make_mesh(case["axes"])
    local = te.shard_encoder_params(params, config, mesh)
    results[name] = te.encode(config, local, torch.from_numpy(data["tokens"]),
                              torch.from_numpy(data["mask"]), mesh=mesh).numpy()
    results[name + ".wq"] = np.array(local["layers"]["wq"].shape)
    results[name + ".collectives"] = np.array(sorted(mesh.collectives))
np.savez(f"{path}/out{rank}.npz", **results)
shutdown()
'''

CASES = {2: {"enc-tp2": {"axes": {"tp": 2}}},
         4: {"enc-dp2tp2": {"axes": {"dp": 2, "tp": 2}}}}


def _inputs():
    config = jenc.EncoderConfig.tiny()
    params = jenc.init_encoder_params(config, jax.random.PRNGKey(5))
    rng = np.random.RandomState(3)
    tokens = rng.randint(1, config.vocab_size, size=(4, 16)).astype(np.int32)
    mask = np.zeros((4, 16), np.int32)
    for b, n in enumerate((16, 9, 3, 0)):  # the last row is padding only
        mask[b, :n] = 1
    tokens = tokens * mask
    return config, params, tokens, mask


def test_encoder_param_specs_are_the_jax_packages():
    config = tenc.EncoderConfig.tiny()
    port, jax_specs = tenc.encoder_param_specs(config), jenc.encoder_param_specs(
        jenc.EncoderConfig.tiny())

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            assert isinstance(a, P) and tuple(a) == tuple(b)

    same(port, jax_specs)


@pytest.mark.parametrize("world,name", [(2, "enc-tp2"), (4, "enc-dp2tp2")])
def test_encoder_under_a_mesh_matches_jax(world, name, tmp_path):
    """Every rank's ``encode`` on its shards (heads and FFN width on tp,
    rows on dp) returns the whole batch's vectors of the JAX package's
    ``encode`` with ``encoder_param_specs`` placement, within 1e-5."""
    config, params, tokens, mask = _inputs()
    axes = CASES[world][name]["axes"]
    jmesh = jax_make_mesh(dict(axes), devices=jax.devices()[:world])
    placed = jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(jmesh, s)), params,
                          jenc.encoder_param_specs(config),
                          is_leaf=lambda x: isinstance(x, JP))
    want = np.asarray(jax.jit(lambda p, t, m: jenc.encode(config, p, t, m))(
        placed, jnp.asarray(tokens), jnp.asarray(mask)))
    inputs = {**_flat("enc", params), "tokens": tokens.astype(np.int64),
              "mask": mask.astype(np.int64)}
    outs = run_world(tmp_path, world, CASES[world], inputs, script=_RANK)
    hidden = config.hidden
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out[name], want, **TOL, err_msg=f"rank {rank}")
        assert out[name + ".wq"].tolist() == [config.layers, hidden, hidden // axes["tp"]]
        coll = set(out[name + ".collectives"].tolist())
        assert "enc-tp" in coll and ("enc-dp" in coll) == ("dp" in axes), coll


EMBED = {"embeddings-model": "tiny", "mesh": {"dp": 2}}
SERVE = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 64,
         "decode-chunk": 4}
BOTH = {**SERVE, "embeddings-model": "tiny", "mesh": {"tp": 2}}
TEXTS = ["hello tpu world", "the quick brown fox jumps", "a", "embeddings under a mesh",
         "one more text"]


@pytest.fixture(scope="module")
def embed_world(tmp_path_factory):
    """One 2-rank world per configuration in turn: the embeddings engine
    alone at ``{dp: 2}``, then a resource with both a serving engine and
    an embeddings engine at ``{tp: 2}`` sharing one lockstep channel."""
    tmp = tmp_path_factory.mktemp("embed")
    procs, outs = spawn_world(tmp, 2, [EMBED, BOTH], prompts=TEXTS, max_tokens=4)
    return world_outputs(procs, outs, timeout=240)


def _one_rank_vectors() -> list[list[float]]:
    from langstream_tpu_torch.serving.embeddings import EmbeddingEngine

    engine = EmbeddingEngine("tiny", device="cpu")
    try:
        return asyncio.run(engine.embed(TEXTS))
    finally:
        engine.close()


def test_the_embeddings_engine_at_dp2_equals_the_one_rank_engine(embed_world):
    """``EmbeddingEngine(mesh={dp: 2})``: each replica encodes its rows of
    the padded batch, summed over dp; the leader's vectors equal the
    one-rank engine's within 1e-5, and the follower replayed the call."""
    leader, follower = embed_world[0][0], embed_world[1][0]
    np.testing.assert_allclose(np.asarray(leader["vectors"]),
                               np.asarray(_one_rank_vectors()), **TOL)
    mesh = leader["embed-mesh"]
    assert mesh["axes"] == {"dp": 2} and mesh["lockstep-role"] == "leader"
    assert mesh["collectives"]["enc-dp"]["calls"] == 1
    assert follower["replayed"] == 1 and follower["mesh"] is None
    assert follower["embed-mesh"][0]["collectives"]["enc-dp"]["calls"] == 1


def test_a_serving_and_an_embeddings_engine_share_one_channel(embed_world, run_async):
    """A resource served by both agents under ``{tp: 2}``: the embeddings
    engine joins the serving engine's lockstep channel (one channel per
    rank, not two leaders on one port); the tokens equal the one-rank
    serving engine's and the vectors the one-rank embeddings engine's, and
    the world ends when the last engine closes."""
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    leader, follower = embed_world[0][1], embed_world[1][1]
    one = TorchServingEngine(ServingConfig.from_dict(SERVE), device="cpu")

    async def serve():
        try:
            return await asyncio.gather(*(
                one.generate(t, {"max-tokens": 4, "temperature": 0.0}) for t in TEXTS))
        finally:
            await one.close()

    want = run_async(serve())
    assert leader["tokens"] == [list(r["tokens"]) for r in want]
    np.testing.assert_allclose(np.asarray(leader["vectors"]),
                               np.asarray(_one_rank_vectors()), **TOL)
    assert leader["embed-mesh"]["axes"] == {"tp": 2}
    assert "enc-tp" in follower["embed-mesh"][0]["collectives"]
    # the follower replayed the serving dispatches and the embed call
    assert follower["replayed"] == len(follower["dispatches"]) + 1
