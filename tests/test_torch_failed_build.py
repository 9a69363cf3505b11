"""A serving engine whose build fails never takes down the world an
embeddings engine leads (``serving/lockstep.py``: each follower answers an
``engine`` frame with a ``built`` frame, drops a build that failed and
keeps replaying; the leader reads every answer and raises).

An embeddings engine at ``{dp: 2}`` starts the world (its second rank a
gloo process on the CPU, ``LOCAL_WORLD_SIZE=2``) and embeds. A serving
engine then joins it and fails to build:

- on every rank: its ``checkpoint`` directory does not exist, so each rank
  raises ``FileNotFoundError`` and the leader's constructor raises its own;
- on the follower only: the ``checkpoint`` is a relative path that the
  leader's working directory holds and the started rank's does not (as on
  two hosts that do not share a volume); the constructor raises naming the
  rank and its ``FileNotFoundError``.

Either way the started rank stays alive, the embeddings engine returns the
same vectors, a serving engine of a good config then leads the world with
an unmeshed engine's tokens, and ``close()`` ends the world with its rank
exited 0 and gone.
"""

import asyncio
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from langstream_tpu_torch.parallel import launch
from langstream_tpu_torch.serving.embeddings import EmbeddingEngine
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from test_torch_launch import PROMPTS, TEXTS, TINY, _gone, _serve

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    """Every wait of a world within 30 s; every test ends with no world
    and no shared engine left."""
    monkeypatch.setenv("LS_TORCH_COLLECTIVE_TIMEOUT_S", "30")
    monkeypatch.delenv("LS_SLICE_HOSTS", raising=False)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    yield
    TorchServingEngine.reset_instances()
    EmbeddingEngine.reset_instances()
    assert launch._WORLD is None, "a test left its world up"


@pytest.mark.parametrize("where", ["every-rank", "follower-only"])
def test_a_failed_serving_build_leaves_the_embeddings_world_serving(where, tmp_path,
                                                                   monkeypatch, run_async):
    """The serving engine's constructor raises (naming the follower's
    error when only the follower failed); the started rank is alive, the
    vectors are the same, and the world serves a good serving engine
    afterwards with an unmeshed engine's tokens."""
    failing = {"model": "tiny", "model-dtype": "float32", "slots": 4, "max-seq-len": 128,
               "decode-chunk": 4, "mesh": {"tp": 2}}
    embedder = EmbeddingEngine("tiny", mesh={"dp": 2}, device="cpu")
    try:
        before = asyncio.run(embedder.embed(TEXTS))
        world = embedder._launched
        if where == "every-rank":
            failing["checkpoint"] = str(tmp_path / "no-such-checkpoint")
            with pytest.raises(FileNotFoundError):
                TorchServingEngine(ServingConfig.from_dict(failing), device="cpu")
        else:
            name = f"ls-follower-only-{os.getpid()}"
            assert not Path(name).exists()  # the started rank's working directory
            shutil.copytree(FIXTURES / "llama_tiny_golden", tmp_path / name)
            failing["checkpoint"] = name
            with monkeypatch.context() as m:
                m.chdir(tmp_path)
                with pytest.raises(RuntimeError, match=r"failed to build on 1 follower rank\(s\)"
                                                       r" of its world \(rank 1: "
                                                       r"FileNotFoundError"):
                    TorchServingEngine(ServingConfig.from_dict(failing), device="cpu")
        assert launch._WORLD is world and world.children[0].proc.poll() is None
        np.testing.assert_array_equal(asyncio.run(embedder.embed(TEXTS)), before)
        serving = TorchServingEngine(ServingConfig.from_dict({**TINY, "mesh": {"tp": 2}}),
                                     device="cpu")
        assert serving._lockstep is embedder._lockstep
        tokens = run_async(_serve(serving, PROMPTS[:2], 4))
        np.testing.assert_array_equal(asyncio.run(embedder.embed(TEXTS)), before)
    finally:
        embedder.close()  # the last user of the channel: "stop"
    plain = TorchServingEngine(ServingConfig.from_dict(TINY), device="cpu")
    assert tokens == run_async(_serve(plain, PROMPTS[:2], 4))
    children = world.describe()["children"]
    assert [(c["rank"], c["exit-code"]) for c in children] == [(1, 0)]
    # the rank's report: the dropped engine is gone, the good one replayed
    assert [m["axes"] for m in children[0]["mesh"]] == [{"tp": 2}, {"dp": 2}]
    _gone(children)
