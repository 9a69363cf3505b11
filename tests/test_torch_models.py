"""The port's model layer against the JAX package, module by module.

Inputs come from numpy with a fixed seed (or from the JAX package's own
init, carried across with ``params_from_numpy``) and go through the JAX
function and its port. f32 throughout unless a test says otherwise.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import kvquant as jkv
from langstream_tpu.models import llama as jl
from langstream_tpu.models import llama_paged as jlp
from langstream_tpu.models import paged as jp
from langstream_tpu.models import quant as jq
from langstream_tpu.serving.sampler import sample_tokens as jax_sample
from langstream_tpu_torch.models import kvquant as tkv
from langstream_tpu_torch.models import llama as tl
from langstream_tpu_torch.models import llama_paged as tlp
from langstream_tpu_torch.models import paged as tp
from langstream_tpu_torch.models import quant as tq
from langstream_tpu_torch.models.convert import params_from_numpy, tensor_from_numpy
from langstream_tpu_torch.models.tokenizer import ByteTokenizer, load_tokenizer
from langstream_tpu_torch.serving.sampler import sample_tokens

FIXTURES = Path(__file__).parent / "fixtures" / "llama_tiny_golden"


def flatten_jax_params(tree):
    """JAX parameter tree → numpy leaves; ``QTensor`` → ``{"q", "s"}``."""
    if isinstance(tree, jq.QTensor):
        return {"q": np.asarray(tree.q), "s": np.asarray(tree.s)}
    if isinstance(tree, dict):
        return {k: flatten_jax_params(v) for k, v in tree.items()}
    return np.asarray(tree)


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x)


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return tensor_from_numpy(np.asarray(x), device="cpu")


def _configs(max_seq_len=128):
    jc = dataclasses.replace(jl.LlamaConfig.tiny(max_seq_len), dtype=jnp.float32)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(max_seq_len), dtype=torch.float32)
    return jc, tc


@pytest.fixture(scope="module")
def tiny():
    jc, tc = _configs()
    jparams = jl.init_llama_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jparams


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_exact(dtype):
    x = np.random.default_rng(0).standard_normal((3, 5, 2, 16), dtype=np.float32) * 4
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    xj = jnp.asarray(x).astype(dtype)
    want = jkv.quantize_rows(xj)
    got = tkv.quantize_rows(tensor_from_numpy(np.asarray(xj), device="cpu"))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_tensor_bit_exact(axis):
    w = np.random.default_rng(1).standard_normal((3, 32, 48), dtype=np.float32)
    w[:, :, 0] = 0.0  # a zero channel keeps scale 1
    want = jq.quantize_tensor(jnp.asarray(w), axis=axis)
    got = tq.quantize_tensor(torch.from_numpy(w), axis=axis)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    # dequant + embedding gather are the same arithmetic
    np.testing.assert_array_equal(
        tq.as_weight(got).numpy(), np.asarray(jq.as_weight(want))
    )


def test_quantize_llama_params_matches_jax(tiny):
    jc, tc, jparams = tiny
    want = flatten_jax_params(jq.quantize_llama_params(jparams))
    got = tq.quantize_llama_params(
        params_from_numpy(flatten_jax_params(jparams), device="cpu")
    )
    for name in ("embed", "lm_head"):
        np.testing.assert_array_equal(got[name].q.numpy(), want[name]["q"])
        np.testing.assert_array_equal(got[name].s.numpy(), want[name]["s"])
    for name, leaf in want["layers"].items():
        g = got["layers"][name]
        if isinstance(leaf, dict):
            np.testing.assert_array_equal(g.q.numpy(), leaf["q"])
        else:
            np.testing.assert_array_equal(g.numpy(), leaf)


def test_embedding_take_quantized():
    embed = np.random.default_rng(2).standard_normal((20, 8), dtype=np.float32)
    tokens = np.array([[1, 5, 19], [0, 0, 7]])
    jqt = jq.quantize_tensor(jnp.asarray(embed), axis=1)
    tqt = tq.quantize_tensor(torch.from_numpy(embed), axis=1)
    np.testing.assert_array_equal(
        tq.embedding_take(tqt, torch.from_numpy(tokens)).numpy(),
        np.asarray(jq.embedding_take(jqt, jnp.asarray(tokens))),
    )


def test_init_llama_params_q8_layout_matches_jax():
    """Same tree, shapes and dtypes as the JAX package's direct int8 init
    (the values differ: the two RNGs differ)."""
    jc, tc = _configs()
    want = jax.tree.map(
        lambda a: (a.shape, str(a.dtype)),
        flatten_jax_params(jq.init_llama_params_q8(jc, jax.random.PRNGKey(0))),
    )
    got_tree = tq.init_llama_params_q8(tc, torch.Generator().manual_seed(0), device="cpu")

    def desc(t):
        if isinstance(t, tq.QTensor):
            return {"q": desc(t.q), "s": desc(t.s)}
        if isinstance(t, dict):
            return {k: desc(v) for k, v in t.items()}
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))

    assert desc(got_tree) == want
    assert got_tree["lm_head"].q.abs().max() == 127  # per-column absmax hits 127


def test_params_from_numpy_bf16_bits_pass_through():
    x = jnp.asarray(np.random.default_rng(3).standard_normal((4, 5)), jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(), np.asarray(x).view(np.int16)
    )


# ---------------------------------------------------------------------------
# paged pool
# ---------------------------------------------------------------------------


def _pool_case(int8: bool, bf16: bool = False, seed=4):
    rng = np.random.default_rng(seed)
    L, nb, bs, Kh, D, B, T = 2, 9, 4, 2, 8, 3, 6
    rows = rng.standard_normal((L, B, T, Kh * D), dtype=np.float32)
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [6, 7, 8, 0]], np.int32)
    starts = np.array([0, 3, 5], np.int32)
    valid = np.ones((B, T), bool)
    valid[0, 4:] = False  # rows past a slot's count go to scratch block 0
    if int8:
        base = (L, nb, bs)
        pool = {
            "q": rng.integers(-127, 128, base + (Kh * D,), dtype=np.int8),
            "s": rng.uniform(0.01, 0.1, base + (Kh,)).astype(np.float32),
        }
    else:
        pool = rng.standard_normal((L, nb, bs, Kh * D), dtype=np.float32)
        if bf16:
            pool = np.asarray(jnp.asarray(pool, jnp.bfloat16))
    return pool, rows, tables, starts, valid


@pytest.mark.parametrize(
    "int8,prequantized,bf16",
    [(False, False, False), (False, False, True), (True, False, False),
     (True, True, False)],
)
def test_write_rows_and_gather_kv_exact(int8, prequantized, bf16):
    pool, rows, tables, starts, valid = _pool_case(int8, bf16)
    if prequantized:
        q = jkv.quantize_rows(jnp.asarray(rows).reshape(2, 3, 6, 2, 8))
        rows_j = {"q": q["q"].reshape(2, 3, 6, 16), "s": q["s"]}
    else:
        rows_j = jnp.asarray(rows).astype(jnp.bfloat16 if bf16 else jnp.float32)
    want = jp.write_rows(
        jax.tree.map(jnp.asarray, pool), rows_j, jnp.asarray(tables),
        jnp.asarray(starts), jnp.asarray(valid),
    )
    got = tp.write_rows(
        _t(pool), _t(_np(rows_j)), torch.from_numpy(tables),
        torch.from_numpy(starts), torch.from_numpy(valid),
    )

    def leaves(tree):  # numpy, with bf16 widened exactly to f32
        if isinstance(tree, dict):
            return [leaves(tree["q"])[0], leaves(tree["s"])[0]]
        if isinstance(tree, torch.Tensor):
            return [tree.float().numpy() if tree.dtype == torch.bfloat16 else tree.numpy()]
        a = np.asarray(tree)
        return [a.astype(np.float32) if a.dtype.name == "bfloat16" else a]

    # block 0 is scratch: which garbage row lands there last is unordered
    for w, g in zip(leaves(want), leaves(got)):
        np.testing.assert_array_equal(g[:, 1:], w[:, 1:])
    gw = jp.gather_kv(want, jnp.asarray(tables), 3)
    gg = tp.gather_kv(got, torch.from_numpy(tables), 3)
    rows_ok = np.asarray(tables[:, :3] != 0)  # scratch columns hold garbage
    for w, g in zip(leaves(gw), leaves(gg)):
        np.testing.assert_array_equal(
            g.reshape(g.shape[0], 3, 3, 4, -1)[:, rows_ok],
            w.reshape(w.shape[0], 3, 3, 4, -1)[:, rows_ok],
        )


def test_block_manager_matches_jax():
    """Admission, reservation, growth and release give the same tables and
    counts as the JAX package's BlockManager (prefix cache unused)."""
    layout_j = jp.PagedLayout.for_model(64, 3, block_size=8, num_blocks=12)
    layout_t = tp.PagedLayout.for_model(64, 3, block_size=8, num_blocks=12)
    assert dataclasses.asdict(layout_j) == dataclasses.asdict(layout_t)
    mj, mt = jp.BlockManager(layout_j, 3), tp.BlockManager(layout_t, 3)
    script = [("admit", 0, 30), ("grow", 0, 10), ("admit", 1, 20), ("grow", 1, 20),
              ("grow", 0, 30), ("release", 0), ("admit", 2, 40), ("grow", 2, 33),
              ("release", 1), ("admit", 0, 17), ("grow", 0, 17)]
    for op, slot, *n in script:
        for m in (mj, mt):
            if op == "admit":
                assert m.can_admit(n[0])
                m.admit(slot, n[0])
            elif op == "grow":
                m.ensure_capacity(slot, n[0])
            else:
                m.release(slot)
        np.testing.assert_array_equal(mt.tables, mj.tables)
        assert mt.reserved_blocks == mj.reserved_blocks
        assert mt.stats()["free_blocks"] == mj.stats()["free_blocks"]
    for n in (1, 40, 64, 65, 200):
        assert mt.fits_ever(n) == mj.fits_ever(n)
        assert mt.can_admit(n) == mj.can_admit(n)


# ---------------------------------------------------------------------------
# llama layers
# ---------------------------------------------------------------------------


def test_rms_norm_rope_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 4, 16), dtype=np.float32)
    w = rng.standard_normal((16,), dtype=np.float32)
    np.testing.assert_allclose(
        tl._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6,
    )
    pos = np.arange(14).reshape(2, 7)
    cj, sj = jl._rope(jnp.asarray(pos), 16, 500000.0)
    ct, st = tl._rope(torch.from_numpy(pos), 16, 500000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tl._apply_rope(torch.from_numpy(x), ct, st).numpy(),
        np.asarray(jl._apply_rope(jnp.asarray(x), cj, sj)),
        rtol=1e-5, atol=1e-5,
    )


def _prompts():
    tokens = np.zeros((3, 16), np.int32)
    lengths = np.array([16, 9, 3], np.int32)
    rng = np.random.default_rng(6)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(0, 384, n)
    return tokens, lengths


def test_prefill_forward_matches_jax(tiny):
    jc, tc, jparams = tiny
    params = params_from_numpy(flatten_jax_params(jparams), device="cpu")
    tokens, lengths = _prompts()
    lj, kj, vj = jl.prefill_forward(jc, jparams, jnp.asarray(tokens),
                                    jnp.asarray(lengths), use_flash=False)
    lt, kt, vt = tl.prefill_forward(tc, params, torch.from_numpy(tokens).long(),
                                    torch.from_numpy(lengths))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5)
    for b, n in enumerate(lengths):  # real rows; padded rows are garbage
        np.testing.assert_allclose(kt[:, b, :n].numpy(), np.asarray(kj)[:, b, :n],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(vt[:, b, :n].numpy(), np.asarray(vj)[:, b, :n],
                                   rtol=1e-5, atol=1e-5)


def test_llama_forward_matches_hf_golden():
    """The port against the independent HF reference fixture, params loaded
    by the port's own loader: forward logits within 2e-3, and the engine
    (``checkpoint:`` the fixture) decodes HF's greedy continuation."""
    import asyncio

    from langstream_tpu_torch.models.checkpoints import load_llama_checkpoint
    from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

    golden = np.load(FIXTURES / "golden.npz")
    _, tc = _configs()
    params = load_llama_checkpoint(str(FIXTURES), tc)
    for p in (0, 1):
        tokens = torch.from_numpy(golden[f"prompt_{p}"][None, :]).long()
        logits = tl.llama_forward(tc, params, tokens)[0].numpy()
        np.testing.assert_allclose(logits, golden[f"logits_{p}"], rtol=2e-3, atol=2e-3)

    engine = TorchServingEngine(ServingConfig.from_dict({
        "model": "tiny", "model-dtype": "float32", "max-seq-len": 128,
        "checkpoint": str(FIXTURES)}), device="cpu")

    async def greedy():
        try:
            return await asyncio.gather(*(
                engine.generate(golden[f"prompt_{p}"].tolist(),
                                {"max-tokens": len(golden[f"greedy_{p}"]), "temperature": 0})
                for p in (0, 1)))
        finally:
            await engine.close()

    for p, result in enumerate(asyncio.run(greedy())):
        assert result["tokens"] == golden[f"greedy_{p}"].tolist()


def _greedy_jax(logits, key, counts=None):
    B = logits.shape[0]
    return jax_sample(logits, key, jnp.zeros((B,)), jnp.zeros((B,), jnp.int32),
                      all_greedy=True)


def _greedy_torch(logits):
    B = logits.shape[0]
    return sample_tokens(logits, None, torch.zeros(B), torch.zeros(B, dtype=torch.int32),
                         all_greedy=True)


@pytest.mark.parametrize(
    "weights_int8,kv_int8", [(False, False), (True, False), (False, True)]
)
def test_paged_prefill_and_two_decode_chunks_match_jax(tiny, weights_int8, kv_int8):
    """llama_prefill_paged then two llama_decode_chunk_paged chunks, both
    packages on the same params and the same pool geometry: logits 1e-5,
    identical greedy tokens, pools that agree."""
    jc, tc, jparams = tiny
    if weights_int8:
        jparams = jq.quantize_llama_params(jparams)
    params = params_from_numpy(flatten_jax_params(jparams), device="cpu",
                               dtype=torch.float32)
    tokens, lengths = _prompts()
    layout = jp.PagedLayout.for_model(128, 3, block_size=8, num_blocks=40)
    mgr = jp.BlockManager(layout, 3)
    K, steps = 4, 2
    for b, n in enumerate(lengths):
        mgr.admit(b, int(n) + K * steps + 1)
        mgr.ensure_capacity(b, int(n) + K * steps)
    tables = mgr.tables.copy()
    if kv_int8:
        pk_j, pv_j = jp.init_paged_kv_cache_int8(jc, layout)
        pk_t, pv_t = tp.init_paged_kv_cache_int8(tc, layout, device="cpu")
    else:
        pk_j, pv_j = jp.init_paged_kv_cache(jc, layout)
        pk_t, pv_t = tp.init_paged_kv_cache(tc, layout, device="cpu")

    lj, pk_j, pv_j = jlp.llama_prefill_paged(
        jc, jparams, jnp.asarray(tokens), jnp.asarray(lengths), pk_j, pv_j,
        jnp.asarray(tables), use_flash=False,
    )
    lt, pk_t, pv_t = tlp.llama_prefill_paged(
        tc, params, torch.from_numpy(tokens).long(), torch.from_numpy(lengths),
        pk_t, pv_t, torch.from_numpy(tables),
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-5)

    first = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    assert (lt.argmax(-1).numpy() == first).all()
    active = np.array([True, True, False])  # an inactive slot never commits
    tok_j, len_j = jnp.asarray(first), jnp.asarray(lengths)
    tok_t, len_t = torch.from_numpy(first).long(), torch.from_numpy(lengths)
    for _ in range(steps):
        ct_j, cl_j, tok_j, len_j, pk_j, pv_j = jlp.llama_decode_chunk_paged(
            jc, jparams, tok_j, len_j, jnp.asarray(active), pk_j, pv_j,
            jnp.asarray(tables), _greedy_jax, jax.random.PRNGKey(0), K,
            num_read_blocks=4, kernel="xla",
        )
        ct_t, cl_t, tok_t, len_t, pk_t, pv_t = tlp.llama_decode_chunk_paged(
            tc, params, tok_t, len_t, torch.from_numpy(active), pk_t, pv_t,
            torch.from_numpy(tables), _greedy_torch, K, num_read_blocks=4,
        )
        np.testing.assert_array_equal(ct_t.numpy(), np.asarray(ct_j))
        np.testing.assert_allclose(cl_t.numpy(), np.asarray(cl_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    live = np.unique(tables[tables > 0])
    if kv_int8:
        # identical int8 codes except where a 1e-7 input difference crosses a
        # rounding edge (one code step)
        dq = pk_t["q"].numpy()[:, live].astype(int) - np.asarray(pk_j["q"])[:, live]
        assert np.abs(dq).max() <= 1
        np.testing.assert_allclose(pv_t["s"].numpy()[:, live],
                                   np.asarray(pv_j["s"])[:, live], rtol=1e-5)
    else:
        np.testing.assert_allclose(pk_t.numpy()[:, live], np.asarray(pk_j)[:, live],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pv_t.numpy()[:, live], np.asarray(pv_j)[:, live],
                                   rtol=1e-5, atol=1e-5)


def test_dense_decode_chunk_matches_jax_dense_chunk(tiny):
    """The dense layout through identity-table blocks against the JAX
    package's dense ``llama_decode_chunk`` (its CPU decode path)."""
    jc, tc, jparams = tiny
    params = params_from_numpy(flatten_jax_params(jparams), device="cpu")
    tokens, lengths = _prompts()
    ck_j, cv_j = jl.init_kv_cache(jc, 3)
    logits, ck_j, cv_j = jl.llama_prefill(
        jc, jparams, jnp.asarray(tokens), jnp.asarray(lengths), ck_j, cv_j,
        jnp.arange(3), use_flash=False,
    )
    ck_t = tensor_from_numpy(np.asarray(ck_j), device="cpu")
    cv_t = tensor_from_numpy(np.asarray(cv_j), device="cpu")
    first = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    active = np.array([True, False, True])
    out_j = jl.llama_decode_chunk(
        jc, jparams, jnp.asarray(first), jnp.asarray(lengths),
        jnp.asarray(active), ck_j, cv_j, _greedy_jax, jax.random.PRNGKey(0), 4,
    )
    out_t = tlp.llama_decode_chunk_dense_pallas(
        tc, params, torch.from_numpy(first).long(), torch.from_numpy(lengths),
        torch.from_numpy(active), ck_t, cv_t, _greedy_torch, 4, window=None,
    )
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), rtol=1e-5, atol=1e-5)
    # the commit wrote the active slots' new rows through the view and left
    # their earlier rows alone (the inactive slot has no scratch block to
    # commit into: it must not land on slot 0's first rows)
    for b in np.nonzero(active)[0]:
        n = lengths[b]
        for cache_t, cache_j in ((out_t[4], out_j[4]), (out_t[5], out_j[5])):
            np.testing.assert_allclose(cache_t[:, b, :n + 4].numpy(),
                                       np.asarray(cache_j)[:, b, :n + 4],
                                       rtol=1e-5, atol=1e-5)


def test_pack_tokens_logprobs_matches_jax():
    tokens = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    lps = np.array([[-0.5, -1.25, -3.0], [-0.0, -7.5, -1e-9]], np.float32)
    want = np.asarray(jlp.pack_tokens_logprobs(jnp.asarray(tokens), jnp.asarray(lps)))
    got = tlp.pack_tokens_logprobs(torch.from_numpy(tokens), torch.from_numpy(lps))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[6:].numpy().view(np.float32), lps.reshape(-1))


def test_byte_tokenizer_roundtrip():
    from langstream_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer

    tok, jtok = load_tokenizer(None), JaxByteTokenizer()
    assert isinstance(tok, ByteTokenizer)
    text = "héllo, wörld ✓"
    assert tok.encode(text) == jtok.encode(text)
    assert tok.decode(tok.encode(text)) == jtok.decode(jtok.encode(text)) == text
    assert (tok.bos_id, tok.eos_id, tok.pad_id, tok.vocab_size) == (257, 258, 256, 259)
