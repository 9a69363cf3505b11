"""The port's encoder and ``EmbeddingEngine`` against the JAX package's.

Parameters come from the JAX package's own init, carried across with
``params_from_numpy`` (the encoder's tree is a plain nested dict); token
ids come from numpy with a fixed seed. f32 throughout, tolerance 1e-5.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import encoder as je
from langstream_tpu.serving.engine import EmbeddingEngine as JaxEmbeddingEngine
from langstream_tpu_torch.agents.provider import TorchServiceProvider
from langstream_tpu_torch.models import encoder as te
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving.embeddings import EmbeddingEngine

WIDTHS = {"tiny": (je.EncoderConfig.tiny, te.EncoderConfig.tiny),
          "minilm-l6": (je.EncoderConfig.minilm_l6, te.EncoderConfig.minilm_l6)}
TEXTS = ["", "a", "embeddings for retrieval", "héllo wörld, ünïcode",
         "a longer passage " * 5, "x" * 40, "the quick brown fox"]


@pytest.fixture(scope="module")
def encoders():
    """Per width: the JAX config and params, the port's config and params
    (the same numbers)."""
    out = {}
    for name, (jcfg, tcfg) in WIDTHS.items():
        jc = jcfg()
        jparams = je.init_encoder_params(jc, jax.random.PRNGKey(3))
        flat = jax.tree.map(np.asarray, jparams)
        out[name] = (jc, jparams, tcfg(), params_from_numpy(flat, device="cpu"))
    return out


def _batch(rng, B, S, vocab):
    """Ragged right-padded rows; the last row of a batch of 5 is all
    padding (its vector must stay finite)."""
    tokens = np.zeros((B, S), np.int32)
    mask = np.zeros((B, S), np.int32)
    for b in range(B):
        n = 0 if (B == 5 and b == B - 1) else int(rng.integers(1, S + 1))
        tokens[b, :n] = rng.integers(0, vocab, n)
        mask[b, :n] = 1
    return tokens, mask


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B", [1, 3, 5])
def test_encode_matches_jax(encoders, width, B):
    jc, jparams, tc, tparams = encoders[width]
    tokens, mask = _batch(np.random.default_rng(B), B, 24, jc.vocab_size)
    want = np.asarray(je.encode(jc, jparams, jnp.asarray(tokens), jnp.asarray(mask)))
    got = te.encode(tc, tparams, torch.from_numpy(tokens).long(),
                    torch.from_numpy(mask).long()).numpy()
    assert got.shape == (B, tc.hidden) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("B", [1, 3, 5])
def test_embedding_engine_matches_jax(encoders, width, B):
    """Bucketing, power-of-two row padding and slicing as the JAX engine:
    the same vectors for the same texts."""
    _, jparams, _, tparams = encoders[width]
    jax_engine = JaxEmbeddingEngine(width, None, None, None)
    jax_engine.params = jparams
    engine = EmbeddingEngine(width, device="cpu")
    engine.params = tparams
    texts = TEXTS[:B] if B < 5 else TEXTS[2:2 + B]

    async def both():
        return await jax_engine.embed(texts), await engine.embed(texts)

    try:
        want, got = asyncio.run(both())
    finally:
        engine.close()
    assert len(got) == B and all(len(v) == len(want[0]) for v in got)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_random_init_layout_and_device_rule(encoders):
    """The port's init has the JAX init's tree, shapes and scales; the
    engine's weights come from a CPU generator seeded 0 on every device."""
    jc, jparams, tc, _ = encoders["tiny"]
    got = te.init_encoder_params(tc, torch.Generator().manual_seed(0), device="cpu")
    want_shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    got_shapes = {k: ({n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict)
                      else tuple(v.shape)) for k, v in got.items()}
    assert got_shapes == want_shapes
    engine = EmbeddingEngine("tiny", device="cpu")
    engine.close()
    torch.testing.assert_close(engine.params["layers"]["wq"], got["layers"]["wq"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            EmbeddingEngine("tiny")


def test_load_from_sentence_transformers_matches_jax(tmp_path):
    """Both loaders read one ``pytorch_model.bin`` of random tensors under
    the BERT names (a short word-embedding table keeps the file small)."""
    rng = np.random.default_rng(0)
    c = te.EncoderConfig.minilm_l6()
    H, I = c.hidden, c.intermediate
    shapes = {"embeddings.word_embeddings.weight": (512, H),
              "embeddings.position_embeddings.weight": (c.max_position, H),
              "embeddings.LayerNorm.weight": (H,), "embeddings.LayerNorm.bias": (H,)}
    for i in range(c.layers):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            shapes[f"{p}attention.self.{name}.weight"] = (H, H)
            shapes[f"{p}attention.self.{name}.bias"] = (H,)
        shapes.update({
            f"{p}attention.output.dense.weight": (H, H),
            f"{p}attention.output.dense.bias": (H,),
            f"{p}attention.output.LayerNorm.weight": (H,),
            f"{p}attention.output.LayerNorm.bias": (H,),
            f"{p}intermediate.dense.weight": (I, H), f"{p}intermediate.dense.bias": (I,),
            f"{p}output.dense.weight": (H, I), f"{p}output.dense.bias": (H,),
            f"{p}output.LayerNorm.weight": (H,), f"{p}output.LayerNorm.bias": (H,),
        })
    torch.save({k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for k, s in shapes.items()}, tmp_path / "pytorch_model.bin")
    jc, jparams = je.load_from_sentence_transformers(str(tmp_path))
    tc, tparams = te.load_from_sentence_transformers(str(tmp_path))
    assert tc == te.EncoderConfig.minilm_l6() and jc == je.EncoderConfig.minilm_l6()
    want = jax.tree.map(np.asarray, jparams)
    for k, v in want.items():
        if isinstance(v, dict):
            for n, a in v.items():
                np.testing.assert_array_equal(tparams[k][n].numpy(), a, err_msg=n)
        else:
            np.testing.assert_array_equal(tparams[k].numpy(), v, err_msg=k)
    with pytest.raises(FileNotFoundError):
        te.load_from_sentence_transformers(str(tmp_path / "absent"))


def test_provider_embeddings_service_and_engine_sharing():
    """The provider's embeddings service goes through ``get_or_create``
    (one engine per model, tokenizer, checkpoint and device); a mesh
    raises naming the ROADMAP item."""
    EmbeddingEngine.reset_instances()
    try:
        resource = {"type": "tpu-serving-configuration", "name": "tpu",
                    "model": "tiny", "embeddings-model": "tiny"}
        provider = TorchServiceProvider(resource, device="cpu")
        service = provider.get_embeddings_service({})
        assert provider.get_embeddings_service({}).engine is service.engine
        assert EmbeddingEngine.get_or_create("tiny", device="cpu") is service.engine
        vectors = asyncio.run(service.compute_embeddings(["one", "two words"]))
        direct = asyncio.run(service.engine.embed(["one", "two words"]))
        assert vectors == direct and len(vectors[0]) == te.EncoderConfig.tiny().hidden
        with pytest.raises(NotImplementedError, match="item 13"):
            TorchServiceProvider({**resource, "mesh": {"tp": 2}},
                                 device="cpu").get_embeddings_service({})
    finally:
        for engine in EmbeddingEngine._instances.values():
            engine.close()
        EmbeddingEngine.reset_instances()
