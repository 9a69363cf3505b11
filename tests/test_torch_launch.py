"""Meshes from the normal entry points: the port's launcher
(``langstream_tpu_torch/parallel/launch.py``) starts the local ranks an
engine's mesh needs, as a JAX process takes its host's devices.

No test here starts a rank. ``LOCAL_WORLD_SIZE`` (set with ``monkeypatch``)
is the ranks this host may run: the counterpart of the 8 virtual CPU
devices the JAX engines run on. The port's ranks are gloo processes on the
CPU, this process rank 0.

- Through ``TorchServiceProvider``: ``tiny`` f32 on the HF fixture at
  ``{tp: 2}`` and ``{dp: 2, tp: 2}``, and ``moe-tiny`` at ``{ep: 2, tp: 1}``,
  give exactly the JAX engine's greedy tokens under the same mesh; the
  tiny encoder at ``{dp: 2}`` gives the JAX ``EmbeddingEngine``'s vectors
  (the same weights) within 1e-5.
- The refusals name their numbers: a mesh over the capacity, a slice's
  mesh that is not ``hosts x local`` ranks, a second world of another size
  while one is up (and one of the same size shares the world), a second
  serving engine on the world (its ranks replay one), which leaves the
  first's world up.
- Lifecycle: every world ends with its ranks exited 0 and gone
  (``os.kill(pid, 0)`` raises ``ProcessLookupError``), three worlds in a
  row, one of them ended by ``get_or_create``'s replacement of a stale
  engine; a rank killed mid-wave breaks the leader's group within a
  bounded time and ``close()`` raises with its exit code; an engine that
  fails once its world is up raises with its rank's output and leaves no
  rank.
- A 2 x 2 slice through the port's pod seam, in two pod processes
  (``chip_smoke.py --q2-pod``, the smoke's path Q2), gives the JAX
  engine's tokens.
"""

import asyncio
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from langstream_tpu.models import encoder as jenc
from langstream_tpu.serving.engine import EmbeddingEngine as JaxEmbeddingEngine
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig, TpuServingEngine
from langstream_tpu_torch.agents.provider import TorchServiceProvider
from langstream_tpu_torch.models import encoder as tenc
from langstream_tpu_torch.parallel import launch
from langstream_tpu_torch.serving.embeddings import EmbeddingEngine
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from langstream_tpu_torch.serving.lockstep import LockstepBroken
from test_torch_lockstep import REPO, free_port

FIXTURES = Path(__file__).parent / "fixtures"
LLAMA = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 128,
         "decode-chunk": 4, "checkpoint": str(FIXTURES / "llama_tiny_golden")}
MOE = {**LLAMA, "model": "moe-tiny", "checkpoint": str(FIXTURES / "moe_tiny_golden")}
CASES = {
    "tp2": {**LLAMA, "mesh": {"tp": 2}},
    "dp2tp2": {**LLAMA, "kv-layout": "paged", "kv-block-size": 16, "seed": 0,
               "mesh": {"dp": 2, "tp": 2}},
    "moe-ep2": {**MOE, "mesh": {"ep": 2, "tp": 1}},
}
PROMPTS = ["hello tpu world", "a slice of two pods", "abcdefgh, ijklmnop", "q"]
MAX_TOKENS = 8
TINY = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 128,
        "decode-chunk": 4}
TEXTS = ["hello tpu world", "the quick brown fox jumps", "a", "embeddings under a mesh",
         "one more text"]


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    """Every wait of a world within 30 s; every test ends with no world
    and no shared engine left."""
    monkeypatch.setenv("LS_TORCH_COLLECTIVE_TIMEOUT_S", "30")
    monkeypatch.delenv("LS_SLICE_HOSTS", raising=False)
    yield
    TorchServingEngine.reset_instances()
    EmbeddingEngine.reset_instances()
    assert launch._WORLD is None, "a test left its world up"


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX engine's greedy tokens per case, under the case's mesh on
    the 8 virtual CPU devices (each case served once)."""
    done: dict[str, list] = {}

    def get(case: str) -> list:
        if case not in done:
            engine = TpuServingEngine(JaxServingConfig.from_dict(CASES[case]))

            async def serve():
                try:
                    return await asyncio.gather(*(
                        engine.generate(p, {"max-tokens": MAX_TOKENS, "temperature": 0.0})
                        for p in PROMPTS))
                finally:
                    await engine.close()

            done[case] = [list(r["tokens"]) for r in asyncio.run(serve())]
            TpuServingEngine.reset_instances()
        return done[case]

    return get


def _gone(children: list[dict]) -> None:
    """No process of a world's started ranks is left."""
    for child in children:
        with pytest.raises(ProcessLookupError):
            os.kill(child["pid"], 0)


async def _serve(engine, prompts=PROMPTS, max_tokens=MAX_TOKENS) -> list:
    try:
        results = await asyncio.gather(*(
            engine.generate(p, {"max-tokens": max_tokens, "temperature": 0.0})
            for p in prompts))
        return [list(r["tokens"]) for r in results]
    finally:
        await engine.close()


@pytest.mark.parametrize("case", list(CASES))
def test_the_provider_serves_a_mesh_with_the_jax_engines_tokens(case, monkeypatch, jax_tokens):
    """``LOCAL_WORLD_SIZE`` ranks may run here; the provider's engine
    starts the mesh's other ranks itself, leads them, and its greedy tokens
    equal the JAX engine's under the same mesh; ``close()`` ends the world,
    every started rank replayed every dispatch, exited 0 and is gone."""
    cfg = CASES[case]
    n = math.prod(cfg["mesh"].values())
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(n))
    engine = TorchServiceProvider(cfg, device="cpu").get_completions_service({}).engine
    tokens = asyncio.run(_serve(engine))
    mesh = engine.mesh_section()
    assert tokens == jax_tokens(case)
    assert mesh["axes"] == cfg["mesh"] and mesh["world-size"] == n
    assert mesh["lockstep-role"] == "leader" and mesh["backend"] == "gloo"
    children = mesh["launched"]["children"]
    assert [c["rank"] for c in children] == list(range(1, n))
    for child in children:
        assert child["exit-code"] == 0 and not child["killed"]
        assert child["replayed"] == mesh["lockstep-dispatches"] > 0
        assert child["mesh"][0]["rank"] == child["rank"]
    _gone(children)


def test_the_embeddings_service_at_dp2_gives_the_jax_engines_vectors(monkeypatch):
    """The tiny encoder at ``{dp: 2}`` through the provider's embeddings
    service, its second rank started by the engine: the JAX
    ``EmbeddingEngine``'s vectors under the same mesh, on the same weights
    (the port's seed-0 init placed on the JAX mesh), within 1e-5."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    resource = {"embeddings-model": "tiny", "mesh": {"dp": 2}}
    service = TorchServiceProvider(resource, device="cpu").get_embeddings_service({})
    try:
        got = asyncio.run(service.compute_embeddings(TEXTS))
    finally:
        service.engine.close()
    mesh = service.engine.mesh_section()
    assert mesh["collectives"]["enc-dp"]["calls"] == 1
    children = mesh["launched"]["children"]
    assert [(c["rank"], c["exit-code"], c["replayed"]) for c in children] == [(1, 0, 1)]
    _gone(children)

    # the JAX encoder's specs name tp, so its mesh carries a tp of 1
    jax_engine = JaxEmbeddingEngine("tiny", None, None, {"dp": 2, "tp": 1})
    weights = tenc.init_encoder_params(tenc.EncoderConfig.tiny(),
                                       torch.Generator().manual_seed(0), device="cpu")
    tree = {k: ({n: t.numpy() for n, t in v.items()} if isinstance(v, dict) else v.numpy())
            for k, v in weights.items()}
    jax_engine.params = jax.tree.map(
        lambda p, s: jax.device_put(jnp.asarray(p), NamedSharding(jax_engine.mesh, s)),
        tree, jenc.encoder_param_specs(jax_engine.config),
        is_leaf=lambda x: isinstance(x, JP))
    want = asyncio.run(jax_engine.embed(TEXTS))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_refusals_name_their_numbers_and_one_world_per_process(monkeypatch, run_async):
    """A mesh over the capacity; a slice's mesh that is not every rank of
    it; while a world is up, a mesh of another size (naming both meshes).
    A serving and an embeddings engine of the same size share the world
    and its lockstep channel; the world ends with the last of them."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
        TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"dp": 2, "tp": 2}}),
                           device="cpu")
    monkeypatch.setenv("LS_SLICE_HOSTS", "2")
    with pytest.raises(ValueError, match=r"spans 2 ranks, but a slice of 2 hosts x 2 "
                                         r"local ranks has 4"):
        TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"tp": 2}}),
                           device="cpu")
    monkeypatch.delenv("LS_SLICE_HOSTS")
    assert launch._WORLD is None  # the refusals started nothing
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    first = TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"tp": 2}}),
                               device="cpu")
    embedder = None
    try:
        with pytest.raises(ValueError, match=r"mesh \{'dp': 2, 'tp': 2\} needs 4 ranks, "
                                             r"but this process leads the world of mesh "
                                             r"\{'tp': 2\} \(2 ranks\)"):
            TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"dp": 2, "tp": 2}}),
                               device="cpu")
        embedder = EmbeddingEngine("tiny", mesh={"tp": 2}, device="cpu")
        assert embedder._launched is first._launched
        assert embedder._lockstep is first._lockstep
        vectors = asyncio.run(embedder.embed(TEXTS))
        tokens = run_async(_serve(first, PROMPTS[:2], 4))
    finally:
        if embedder is not None:
            embedder.close()  # the last user of the channel: "stop"
    one = EmbeddingEngine("tiny", device="cpu")
    np.testing.assert_allclose(vectors, asyncio.run(one.embed(TEXTS)), atol=1e-5, rtol=1e-5)
    one.close()
    plain = TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu")
    assert tokens == run_async(_serve(plain, PROMPTS[:2], 4))
    children = first.mesh_section()["launched"]["children"]
    assert [(c["rank"], c["exit-code"]) for c in children] == [(1, 0)]
    assert children[0]["replayed"] == first.mesh_section()["lockstep-dispatches"] + 1
    _gone(children)


def test_a_second_serving_engine_is_refused_and_the_first_keeps_its_world(monkeypatch,
                                                                          run_async):
    """Two serving engines of one mesh size: the started ranks replay one
    serving engine, so the second is refused naming both configs; having
    only joined the world, it leaves it up, and the first serves on with
    the tokens of an engine without a mesh. A serving engine may lead the
    world again once the first has released it (an embeddings engine
    keeping the world up); the world ends with its last engine, its rank
    exited 0 and gone."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    first = TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"tp": 2}}),
                               device="cpu")
    world = first._launched
    embedder = None
    try:
        with pytest.raises(ValueError, match=r"cannot join the lockstep channel on :\d+, "
                                             r"which the serving engine of .* leads") as info:
            TorchServingEngine(ServingConfig.from_dict({**TINY, "seed": 7, "mesh": {"tp": 2}}),
                               device="cpu")
        assert '"seed": 7' in str(info.value) and '"seed": 0' in str(info.value)
        assert launch._WORLD is world and world.children[0].proc.poll() is None
        # an embeddings engine shares the world; once the first serving
        # engine has closed, it holds the world up, and a serving engine of
        # another config leads it in turn
        embedder = EmbeddingEngine("tiny", mesh={"tp": 2}, device="cpu")
        tokens = run_async(_serve(first, PROMPTS[:2], 4))
        assert launch._WORLD is world and world.children[0].proc.poll() is None
        second = TorchServingEngine(ServingConfig.from_dict({**TINY, "seed": 7,
                                                             "mesh": {"tp": 2}}),
                                    device="cpu")
        assert second._launched is world and second._lockstep is embedder._lockstep
        seconds = run_async(_serve(second, PROMPTS[:2], 4))
    finally:
        if embedder is not None:
            embedder.close()  # the last user of the channel: "stop"
    plain = TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu")
    assert tokens == run_async(_serve(plain, PROMPTS[:2], 4))
    other = TorchServingEngine(ServingConfig.from_dict({**TINY, "seed": 7}), device="cpu")
    assert seconds == run_async(_serve(other, PROMPTS[:2], 4))
    children = world.describe()["children"]
    assert [(c["rank"], c["exit-code"]) for c in children] == [(1, 0)]
    _gone(children)


def test_an_engine_that_fails_after_its_world_started_leaves_no_rank(monkeypatch):
    """The model's specs refuse the mesh only once the world is up (the
    JAX engine's ``_present`` rule, in the weights' placement): the
    engine's error is raised with what its started rank said, and the
    world is ended with no rank left."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=r"add 'tp' to the mesh") as info:
        TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"sp": 2}}), device="cpu")
    assert launch._WORLD is None
    notes = "\n".join(getattr(info.value, "__notes__", []))
    assert "local rank 1 (pid" in notes
    pid = int(notes.split("local rank 1 (pid ", 1)[1].split(")", 1)[0])
    _gone([{"pid": pid}])


def test_three_worlds_in_a_row_start_and_end_with_no_rank_left(monkeypatch):
    """Three engines of one resource in a row, each starting its world:
    the first and third ended by ``close()``, the second by
    ``get_or_create``'s replacement of an engine whose event loop closed
    (it ends the old world and reaps its rank before starting the next).
    The same tokens each time; every rank exits 0 and is gone."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    config = ServingConfig.from_dict({**TINY, "mesh": {"tp": 2}})
    runs = []
    for i in range(3):
        engine = TorchServingEngine.get_or_create(config, device="cpu")
        assert all(engine is not old for old, _ in runs)
        if i == 1:
            async def serve_only():  # the loop closes; the engine is not closed
                return [list((await engine.generate(
                    p, {"max-tokens": 4, "temperature": 0.0}))["tokens"])
                        for p in PROMPTS[:2]]

            tokens = asyncio.run(serve_only())
            assert launch._WORLD is engine._launched  # still up
        else:
            tokens = asyncio.run(_serve(engine, PROMPTS[:2], 4))
        runs.append((engine, tokens))
    for engine, tokens in runs:
        assert tokens == runs[0][1]
        children = engine.mesh_section()["launched"]["children"]
        assert [(c["rank"], c["exit-code"]) for c in children] == [(1, 0)]
        _gone(children)
    assert len({c["pid"] for e, _ in runs
                for c in e.mesh_section()["launched"]["children"]}) == 3


def test_a_rank_killed_mid_wave_breaks_the_group_and_close_reports_it(monkeypatch):
    """The started rank is killed while a request decodes: the leader's
    next collective or broadcast fails, the request fails with
    ``LockstepBroken`` and the engine stops, within a bounded time;
    ``close()`` ends the world without the barrier and raises naming the
    rank and its exit code, which ``stats()["mesh"]`` keeps."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    engine = TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"tp": 2}}),
                                device="cpu")
    pid = engine.mesh_section()["launched"]["children"][0]["pid"]

    async def main():
        async def kill_after_a_chunk():
            while engine._ls_seq < 3:  # the prefill and two decode chunks
                await asyncio.sleep(0.001)
            os.kill(pid, 9)

        killer = asyncio.ensure_future(kill_after_a_chunk())
        start = time.monotonic()
        with pytest.raises(LockstepBroken):
            await engine.generate("hello tpu world", {"max-tokens": 100, "temperature": 0})
        broke_s = time.monotonic() - start
        await killer
        assert engine._stop
        with pytest.raises(RuntimeError, match=rf"local rank 1 \(pid {pid}\) exited -9"):
            await engine.close()
        return broke_s

    assert asyncio.run(main()) < 25  # within the 30 s collective timeout
    children = engine.mesh_section()["launched"]["children"]
    assert [(c["rank"], c["exit-code"]) for c in children] == [(1, -9)]
    _gone(children)


def test_a_2x2_slice_through_the_pod_seam_gives_the_jax_engines_tokens(tmp_path, jax_tokens):
    """Two pod processes of a slice (``LS_SLICE_HOSTS=2``, ``LS_POD_NAME``
    q-0 and q-1, ``LOCAL_WORLD_SIZE=2``) through the port's
    ``maybe_join_slice`` and ``run_slice_follower``: each pod joins as rank
    ``ordinal x 2`` and starts its second rank itself; the ordinal-0 pod's
    engine leads all three others, its tokens are the JAX engine's at
    ``{dp: 2, tp: 2}``, and every pod and started rank exits 0."""
    coordinator, lockstep = f"127.0.0.1:{free_port()}", free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "LS_SLICE_HOSTS": "2",
           "LOCAL_WORLD_SIZE": "2", "LS_COORDINATOR_ADDRESS": coordinator,
           "LS_LOCKSTEP_PORT": str(lockstep), "LS_LOCKSTEP_TOKEN": "slice-token"}
    env.pop("JAX_PLATFORMS", None)
    pods = []
    for name in ("q-0", "q-1"):
        out = tmp_path / f"{name}.json"
        with open(tmp_path / f"{name}.log", "wb") as log:  # a file, not a pipe
            pods.append((subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--q2-pod",
                 json.dumps(CASES["dp2tp2"]), json.dumps(PROMPTS), str(MAX_TOKENS), "cpu",
                 str(out)], cwd=REPO, env={**env, "LS_POD_NAME": name},
                stdout=subprocess.DEVNULL, stderr=log), out, tmp_path / f"{name}.log"))
    try:
        for proc, _, log in pods:
            proc.wait(timeout=120)
            assert proc.returncode == 0, log.read_text(errors="replace")[-3000:]
    finally:
        for proc, _, _ in pods:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    leader, follower = (json.loads(out.read_text()) for _, out, _ in pods)
    assert leader["tokens"] == jax_tokens("dp2tp2")
    assert leader["mesh"]["world-size"] == 4 and leader["mesh"]["rank"] == 0
    assert follower["replayed"] == leader["mesh"]["lockstep-dispatches"]
    started = [(c["rank"], c["exit-code"], c["replayed"])
               for pod in (leader, follower) for c in pod["launched"]["children"]]
    dispatches = leader["mesh"]["lockstep-dispatches"]
    assert started == [(1, 0, dispatches), (3, 0, dispatches)]
    _gone(leader["launched"]["children"] + follower["launched"]["children"])
