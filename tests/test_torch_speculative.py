"""Speculation of the port against the JAX package, module by module: the
prompt-lookup drafter, the verify step, the fused draft+verify step and the
rejection sampler.

Inputs come from numpy with a fixed seed; the model is the tiny f32 Llama of
the JAX package (its own init, carried across with ``params_from_numpy``),
over a bf16/f32 (here f32) or an int8 paged pool. Tokens, advance counts,
next tokens and lengths must match exactly, logprobs within 1e-4 and the
committed pool rows within 1e-5 (int8: equal codes, scales within 1e-6).
The sampler's draws come from another RNG than ``jax.random``, so sampled
acceptance is held to the target distribution by frequency.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import llama as jl
from langstream_tpu.models import llama_paged as jlp
from langstream_tpu.models import paged as jp
from langstream_tpu.models import quant as jq
from langstream_tpu.serving import sampler as jsamp
from langstream_tpu_torch.models import convert as tconv
from langstream_tpu_torch.models import llama as tl
from langstream_tpu_torch.models import llama_paged as tlp
from langstream_tpu_torch.ops import paged_attention as tpa
from langstream_tpu_torch.serving import sampler as tsamp

LOGPROB_TOL = 1e-4
POOL_TOL = 1e-5


def _t(x):
    """numpy (or a JAX array, or an int8 {"q","s"} pool) → CPU tensors."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return tconv.tensor_from_numpy(np.asarray(x), device="cpu")


def _flatten(tree):
    if isinstance(tree, jq.QTensor):
        return {"q": np.asarray(tree.q), "s": np.asarray(tree.s)}
    if isinstance(tree, dict):
        return {k: _flatten(v) for k, v in tree.items()}
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# prompt_lookup_draft
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alphabet,seed", [(3, 0), (6, 1), (40, 2)])
def test_prompt_lookup_draft_matches_jax(alphabet, seed):
    """256 rows per case: the degenerate lengths 0-3, a match whose draft is
    clipped at ``n``, rows with no match (a large alphabet), and random
    lengths up to the row width."""
    B, S, D = 256, 64, 4
    rng = np.random.default_rng(seed)
    ctx = rng.integers(1, alphabet + 1, size=(B, S)).astype(np.int32)
    lengths = rng.integers(4, S + 1, size=B).astype(np.int32)
    lengths[:4] = [0, 1, 2, 3]
    # a match right before the end: (a, b, c, a, b) drafts [c, a, b], clipped
    ctx[4, :5] = [7, 8, 9, 7, 8]
    lengths[4] = 5
    ctx[5, :4] = [1, 2, 3, 4]  # all distinct bigrams: no match
    lengths[5] = 4
    for b in range(B):
        ctx[b, lengths[b]:] = 0  # zero-padded like the engine's rows
    want_d, want_n = jax.jit(jax.vmap(lambda row, n: jlp.prompt_lookup_draft(row, n, D)))(
        jnp.asarray(ctx), jnp.asarray(lengths))
    got_d, got_n = tlp.prompt_lookup_draft(torch.from_numpy(ctx), torch.from_numpy(lengths), D)
    assert got_d.dtype == torch.int32 and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    n_real = got_n.numpy()
    assert (n_real[:3] == 0).all() and n_real[5] == 0
    assert n_real[4] == 3 and got_d[4].tolist() == [9, 7, 8, 0]
    hits = (n_real > 0).sum()
    assert (hits > 100) if alphabet <= 6 else (hits < B - 10)
    assert ((n_real > 0) & (n_real < D)).any()  # some drafts clipped at n


# ---------------------------------------------------------------------------
# llama_verify_chunk_paged
# ---------------------------------------------------------------------------

MAX_SEQ, BS, D1 = 64, 16, 5
# rows: correct drafts, wrong drafts, inactive, at the context cap (room 2)
PROMPT_LENS = [8, 11, 5, MAX_SEQ - 2]
ACTIVE = [True, True, False, True]


def _verify_case(kv_int8: bool):
    """A pool holding each row's prompt (the JAX package's prefill), each
    row's first token, and the model's own greedy continuation from there
    (a JAX decode chunk), from which correct drafts are taken."""
    jc = dataclasses.replace(jl.LlamaConfig.tiny(max_seq_len=MAX_SEQ), dtype=jnp.float32)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(max_seq_len=MAX_SEQ), dtype=torch.float32)
    jparams = jl.init_llama_params(jc, jax.random.PRNGKey(5))
    B = len(PROMPT_LENS)
    layout = jp.PagedLayout.for_model(MAX_SEQ, B, block_size=BS, num_blocks=24)
    mgr = jp.BlockManager(layout, B)
    for b in range(B):
        mgr.admit(b, MAX_SEQ)
        mgr.ensure_capacity(b, MAX_SEQ)
    tables = mgr.tables.copy()
    rng = np.random.default_rng(11)
    prompts = np.zeros((B, max(PROMPT_LENS)), np.int32)
    for b, n in enumerate(PROMPT_LENS):
        prompts[b, :n] = rng.integers(1, 300, n)
    init = jp.init_paged_kv_cache_int8 if kv_int8 else jp.init_paged_kv_cache
    pk, pv = init(jc, layout)
    lengths = jnp.asarray(PROMPT_LENS, jnp.int32)
    logits, pk, pv = jlp.llama_prefill_paged(
        jc, jparams, jnp.asarray(prompts), lengths, pk, pv, jnp.asarray(tables),
        use_flash=False)
    tok0 = jnp.argmax(logits, axis=-1).astype(jnp.int32)

    def greedy(lg, key):
        t = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        return t, jnp.zeros_like(t, dtype=jnp.float32)

    ref, _, _, _, _, _ = jlp.llama_decode_chunk_paged(
        jc, jparams, tok0, lengths, jnp.ones(B, bool), pk, pv, jnp.asarray(tables),
        greedy, jax.random.PRNGKey(0), D1 - 1, num_read_blocks=MAX_SEQ // BS)
    ref = np.asarray(ref).T                                       # (B, D1-1)
    tokens = np.concatenate([np.asarray(tok0)[:, None], ref], axis=1).astype(np.int32)
    tokens[1, 1:] = [333, 334, 335, 336]                          # wrong drafts
    return jc, tc, jparams, tables, pk, pv, tokens


def _slot_rows(pool, tables, b, n):
    """Rows ``[0, n)`` of slot ``b`` through its table (either pool layout)."""
    pos = np.arange(n)
    idx = tables[b, pos // BS] * BS + pos % BS
    if isinstance(pool, dict):
        return {k: np.asarray(v).reshape((v.shape[0], -1) + v.shape[3:])[:, idx]
                for k, v in pool.items()}
    p = np.asarray(pool)
    return p.reshape((p.shape[0], -1) + p.shape[3:])[:, idx]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32-pool", "int8-pool"])
def test_verify_chunk_matches_jax(kv_int8):
    jc, tc, jparams, tables, pk, pv, tokens = _verify_case(kv_int8)
    nrb = MAX_SEQ // BS
    em_j, adv_j, nxt_j, nl_j, pk_j, pv_j, lp_j = jlp.llama_verify_chunk_paged(
        jc, jparams, jnp.asarray(tokens), jnp.asarray(PROMPT_LENS, jnp.int32),
        jnp.asarray(ACTIVE), pk, pv, jnp.asarray(tables), nrb)
    params = tconv.params_from_numpy(_flatten(jparams), device="cpu")
    pk_t, pv_t = _t(_flatten(pk)), _t(_flatten(pv))
    before = tpa.paged_attention_multiquery_partial.launches
    em, adv, nxt, nl, pk_t, pv_t, lp = tlp.llama_verify_chunk_paged(
        tc, params, torch.from_numpy(tokens).long(),
        torch.tensor(PROMPT_LENS, dtype=torch.int32), torch.tensor(ACTIVE),
        pk_t, pv_t, torch.from_numpy(tables), nrb)
    assert tpa.paged_attention_multiquery_partial.launches == before  # plain on CPU
    adv_np = adv.numpy()
    np.testing.assert_array_equal(adv_np, np.asarray(adv_j))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_j))
    np.testing.assert_array_equal(nl.numpy(), np.asarray(nl_j))
    # the cases the batch must exercise
    assert adv_np.tolist()[:3] == [D1, 1, 0] and 1 <= adv_np[3]
    for b in range(len(PROMPT_LENS)):
        a = adv_np[b]
        np.testing.assert_array_equal(em.numpy()[b, :a], np.asarray(em_j)[b, :a])
        np.testing.assert_allclose(lp.numpy()[b, :a], np.asarray(lp_j)[b, :a],
                                   rtol=LOGPROB_TOL, atol=LOGPROB_TOL)
        n = min(int(nl[b]), MAX_SEQ)  # the committed rows, history included
        for got_pool, want_pool in ((pk_t, pk_j), (pv_t, pv_j)):
            got = _slot_rows(_flatten(got_pool), tables, b, n)
            want = _slot_rows(want_pool, tables, b, n)
            if kv_int8:
                np.testing.assert_array_equal(got["q"], want["q"])
                np.testing.assert_allclose(got["s"], want["s"], rtol=0, atol=1e-6)
            else:
                np.testing.assert_allclose(got, want, rtol=POOL_TOL, atol=POOL_TOL)


def test_verify_chunk_inactive_row_writes_nothing():
    """The inactive row's table blocks keep their contents: its suffix goes
    to the scratch block, not through its real table."""
    _, tc, jparams, tables, pk, pv, tokens = _verify_case(False)
    params = tconv.params_from_numpy(_flatten(jparams), device="cpu")
    pk_t, pv_t = _t(_flatten(pk)), _t(_flatten(pv))
    blocks = tables[2][tables[2] > 0]
    k_before = pk_t[:, blocks].clone()
    tlp.llama_verify_chunk_paged(
        tc, params, torch.from_numpy(tokens).long(),
        torch.tensor(PROMPT_LENS, dtype=torch.int32), torch.tensor(ACTIVE),
        pk_t, pv_t, torch.from_numpy(tables), MAX_SEQ // BS)
    assert torch.equal(pk_t[:, blocks], k_before)


# ---------------------------------------------------------------------------
# llama_spec_step_paged
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32-pool", "int8-pool"])
def test_spec_step_matches_jax(kv_int8):
    """Greedy: the packed array (tokens, counts and lengths exact, logprobs
    within 1e-4) and the updated context rows equal the JAX package's; the
    port's extra sentinel column aside, the rows are the same."""
    jc, tc, jparams, tables, pk, pv, tokens = _verify_case(kv_int8)
    B = len(PROMPT_LENS)
    rng = np.random.default_rng(3)
    # context rows [prompt | current], repetitive so that drafts land (the
    # pools hold other prompts: both packages verify against that history)
    ctx = np.zeros((B, MAX_SEQ), np.int32)
    for b, n in enumerate(PROMPT_LENS):
        ctx[b, :n + 1] = np.tile(rng.integers(1, 300, 4), MAX_SEQ // 4)[:n + 1]
    current = ctx[np.arange(B), PROMPT_LENS].copy()
    nrb = MAX_SEQ // BS
    packed_j, ctx_j, _, _ = jlp.llama_spec_step_paged(
        jc, jparams, jnp.asarray(ctx), jnp.asarray(current),
        jnp.asarray(PROMPT_LENS, jnp.int32), jnp.asarray(ACTIVE), pk, pv,
        jnp.asarray(tables), num_drafts=D1 - 1, num_read_blocks=nrb)
    params = tconv.params_from_numpy(_flatten(jparams), device="cpu")
    ctx_t = torch.zeros((B, MAX_SEQ + 1), dtype=torch.int32)
    ctx_t[:, :MAX_SEQ] = torch.from_numpy(ctx)
    packed, ctx_t, _, _ = tlp.llama_spec_step_paged(
        tc, params, ctx_t, torch.from_numpy(current).long(),
        torch.tensor(PROMPT_LENS, dtype=torch.int32), torch.tensor(ACTIVE),
        _t(_flatten(pk)), _t(_flatten(pv)), torch.from_numpy(tables),
        num_drafts=D1 - 1, num_read_blocks=nrb)
    got, want = packed.numpy(), np.asarray(packed_j)
    assert got.dtype == np.int32 and got.shape == want.shape
    nE = B * D1
    adv = got[nE:nE + B]
    n_real = got[nE + 3 * B:nE + 4 * B]
    np.testing.assert_array_equal(got[nE:nE + 4 * B], want[nE:nE + 4 * B])
    emitted, lps = got[:nE].reshape(B, D1), got[nE + 4 * B:].view(np.float32).reshape(B, D1)
    em_j, lp_j = want[:nE].reshape(B, D1), want[nE + 4 * B:].view(np.float32).reshape(B, D1)
    for b in range(B):
        np.testing.assert_array_equal(emitted[b, :adv[b]], em_j[b, :adv[b]])
        np.testing.assert_allclose(lps[b, :adv[b]], lp_j[b, :adv[b]],
                                   rtol=LOGPROB_TOL, atol=LOGPROB_TOL)
    np.testing.assert_array_equal(ctx_t[:, :MAX_SEQ].numpy(), np.asarray(ctx_j))
    assert n_real[2] == 0 and adv[2] == 0 and (n_real[[0, 1]] > 0).all()


# ---------------------------------------------------------------------------
# speculative_accept
# ---------------------------------------------------------------------------


def test_speculative_accept_greedy_rows_match_jax():
    """Greedy rows: the accepted count equals JAX's and the token at the
    stop position is the argmax there, in both packages."""
    rng = np.random.default_rng(0)
    B, V = 64, 50
    logits = (rng.standard_normal((B, D1, V)) * 2).astype(np.float32)
    argmax = logits.argmax(-1)
    drafts = argmax[:, :-1].copy()
    for b in range(B):  # break the run at a row-dependent position
        j = b % D1
        if j < D1 - 1:
            drafts[b, j] = (drafts[b, j] + 1 + b) % V
    drafts = drafts.astype(np.int32)
    temps = np.zeros(B, np.float32)
    topks = np.zeros(B, np.int32)
    topps = np.ones(B, np.float32)
    acc_j, fb_j = jsamp.speculative_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jax.random.PRNGKey(3),
        jnp.asarray(temps), jnp.asarray(topks), jnp.asarray(topps),
        use_top_p=False, use_top_k=False)
    acc, fb = tsamp.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts), torch.Generator().manual_seed(3),
        torch.from_numpy(temps), torch.from_numpy(topks), torch.from_numpy(topps),
        use_top_p=False, use_top_k=False)
    assert acc.dtype == torch.int32 and fb.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(acc.numpy(), [b % D1 for b in range(B)])
    rows = np.arange(B)
    stop = acc.numpy()
    np.testing.assert_array_equal(fb.numpy()[rows, stop], argmax[rows, stop])
    np.testing.assert_array_equal(np.asarray(fb_j)[rows, stop], argmax[rows, stop])


def test_speculative_accept_first_token_distribution_exact():
    """Port of ``tests/test_speculative.py::
    test_speculative_accept_first_token_distribution_exact``: over 8,000
    draws the first emitted token follows the filtered target, and so does
    the second, given that the first draft survived."""
    V, N = 8, 8000
    rng = np.random.RandomState(0)
    logits_np = (rng.randn(1, 3, V) * 2.0).astype(np.float32)
    drafts = np.array([[int(logits_np[0, 0].argmax()), 5]], np.int32)
    logits = torch.from_numpy(np.repeat(logits_np, N, axis=0))
    temps = torch.full((N,), 0.9)
    topks = torch.zeros(N, dtype=torch.int32)
    topps = torch.ones(N)
    d = torch.from_numpy(np.repeat(drafts, N, axis=0))
    acc, fb = tsamp.speculative_accept(logits, d, torch.Generator().manual_seed(1), temps,
                                       topks, topps, use_top_p=False, use_top_k=False)
    acc, fb = acc.numpy(), fb.numpy()
    first = np.where(acc >= 1, drafts[0, 0], fb[:, 0])
    second = np.where(acc >= 2, drafts[0, 1], fb[:, 1])

    def target(pos):  # the JAX package's filtered target
        return np.asarray(jax.nn.softmax(jsamp.filtered_logits(
            jnp.asarray(logits_np[:, pos]), jnp.asarray([0.9]), jnp.asarray([0]),
            use_top_k=False)))[0]

    np.testing.assert_allclose(np.bincount(first, minlength=V) / N, target(0), atol=0.03)
    sel = acc >= 1
    assert sel.sum() > 500
    np.testing.assert_allclose(np.bincount(second[sel], minlength=V) / sel.sum(),
                               target(1), atol=0.05)


def test_speculative_accept_top_k_never_leaves_the_filter():
    """Sampled rows with top-k: every emitted token (accepted draft or
    fallback at the stop) lies inside the top-k set of its position."""
    N, V, k = 4000, 80, 5
    rng = np.random.default_rng(2)
    row = rng.standard_normal((D1, V)).astype(np.float32) * 2
    logits = torch.from_numpy(np.tile(row, (N, 1, 1)))
    drafts = torch.from_numpy(np.tile(row[:-1].argsort(-1)[:, -2], (N, 1)).astype(np.int32))
    acc, fb = tsamp.speculative_accept(
        logits, drafts, torch.Generator().manual_seed(0), torch.full((N,), 0.8),
        torch.full((N,), k, dtype=torch.int32), torch.ones(N), use_top_k=True)
    topk = np.argsort(-row, axis=-1)[:, :k]
    stop = acc.numpy()
    emitted = fb.numpy()[np.arange(N), stop]
    assert all(emitted[i] in topk[stop[i]] for i in range(N))
    assert (stop > 0).mean() > 0.05  # the second-best draft is accepted sometimes


def test_sampled_verify_greedy_rows_degenerate_to_argmax():
    """Port of ``tests/test_speculative.py::
    test_sampled_verify_greedy_rows_degenerate_to_argmax``: a greedy row in
    the SAMPLED verify variant gives the greedy variant's advance, next
    token, lengths and emitted run, which equal the JAX package's."""
    jc, tc, jparams, tables, pk, pv, tokens = _verify_case(False)
    params = tconv.params_from_numpy(_flatten(jparams), device="cpu")
    B = len(PROMPT_LENS)
    out = {}
    for mode in ((False, False, True), (False, False, False)):
        out[mode] = tlp.llama_verify_chunk_paged(
            tc, params, torch.from_numpy(tokens).long(),
            torch.tensor(PROMPT_LENS, dtype=torch.int32), torch.tensor(ACTIVE),
            _t(_flatten(pk)), _t(_flatten(pv)), torch.from_numpy(tables), MAX_SEQ // BS,
            generator=torch.Generator().manual_seed(7), temps=torch.zeros(B),
            topks=torch.zeros(B, dtype=torch.int32), topps=torch.ones(B),
            sampler_mode=mode)
    em_g, adv_g, nxt_g, nl_g = out[(False, False, True)][:4]
    em_s, adv_s, nxt_s, nl_s = out[(False, False, False)][:4]
    assert torch.equal(adv_s, adv_g) and torch.equal(nxt_s, nxt_g) and torch.equal(nl_s, nl_g)
    for b in range(B):
        a = int(adv_g[b])
        assert em_s[b, :a].tolist() == em_g[b, :a].tolist()
    _, adv_j, nxt_j, _, _, _, _ = jlp.llama_verify_chunk_paged(
        jc, jparams, jnp.asarray(tokens), jnp.asarray(PROMPT_LENS, jnp.int32),
        jnp.asarray(ACTIVE), pk, pv, jnp.asarray(tables), MAX_SEQ // BS,
        key=jax.random.PRNGKey(7), temps=jnp.zeros(B), topks=jnp.zeros(B, jnp.int32),
        topps=jnp.ones(B), sampler_mode=(False, False, False))
    np.testing.assert_array_equal(adv_s.numpy(), np.asarray(adv_j))
    np.testing.assert_array_equal(nxt_s.numpy(), np.asarray(nxt_j))
