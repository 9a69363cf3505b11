"""The continuation slice against the JAX package, module by module: the
multi-query history read, the prefix cache of ``BlockManager`` and
``llama_prefill_continue_paged``; plus the rule that the port's
constructors run on the card unless asked for the CPU.

Inputs come from numpy with a fixed seed (parameters from the JAX package's
own init, carried across with ``params_from_numpy``); f32 throughout, with
a tolerance of 1e-4 unless a test says otherwise.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import llama as jl
from langstream_tpu.models import llama_paged as jlp
from langstream_tpu.models import paged as jp
from langstream_tpu.models import quant as jq
from langstream_tpu.ops import paged_attention as jpa
from langstream_tpu_torch.models import convert as tconv
from langstream_tpu_torch.models import llama as tl
from langstream_tpu_torch.models import llama_paged as tlp
from langstream_tpu_torch.models import paged as tp
from langstream_tpu_torch.models import quant as tq
from langstream_tpu_torch.ops import paged_attention as tpa

TOL = 1e-4


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
# step 0: constructors run on the card unless asked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "init_llama_params", "init_llama_params_q8", "init_paged_kv_cache",
    "init_paged_kv_cache_int8", "tensor_from_numpy", "params_from_numpy",
])
def test_constructors_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    c = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    layout = tp.PagedLayout.for_model(128, 2, block_size=16)
    calls = {
        "init_llama_params": lambda: tl.init_llama_params(c, None),
        "init_llama_params_q8": lambda: tq.init_llama_params_q8(c, None),
        "init_paged_kv_cache": lambda: tp.init_paged_kv_cache(c, layout),
        "init_paged_kv_cache_int8": lambda: tp.init_paged_kv_cache_int8(c, layout),
        "tensor_from_numpy": lambda: tconv.tensor_from_numpy(np.zeros(3)),
        "params_from_numpy": lambda: tconv.params_from_numpy({"w": np.zeros(3)}),
    }
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        calls[name]()
    # and the same call on the CPU, asked for, works
    if name == "tensor_from_numpy":
        assert tconv.tensor_from_numpy(np.zeros(3), device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# the multi-query history read
# ---------------------------------------------------------------------------


def _mq_case(starts, T, Kh, seed=0):
    rng = np.random.RandomState(seed)
    B, H, D, bs, nb = 3, 8, 16, 8, 20
    q = rng.randn(B, T, H, D).astype(np.float32)
    kp = rng.randn(nb, bs, Kh * D).astype(np.float32)
    vp = rng.randn(nb, bs, Kh * D).astype(np.float32)
    tables = rng.randint(1, nb, size=(B, 6)).astype(np.int32)
    return q, kp, vp, tables, np.asarray(starts, np.int32)


def _dense_reference(q, kp, vp, tables, starts, nrb, Kh):
    """Softmax over the gathered history window, in numpy (the reference
    of ``tests/test_paged.py::test_multiquery_kernel_matches_xla_reference``);
    a slot with no history attends nothing and gives 0."""
    B, T, H, D = q.shape
    bs = kp.shape[1]
    W = nrb * bs
    kw = kp[tables[:, :nrb]].reshape(B, W, Kh, D)
    vw = vp[tables[:, :nrb]].reshape(B, W, Kh, D)
    G = H // Kh
    s = np.einsum("btkgd,bwkd->bkgtw", q.reshape(B, T, Kh, G, D), kw) / math.sqrt(D)
    mask = (np.arange(W)[None, :] < starts[:, None])[:, None, None, None, :]
    s = np.where(mask, s, -np.inf)
    out = np.zeros((B, Kh, G, T, D), np.float32)
    for b in range(B):
        if starts[b]:
            p = np.exp(s[b] - s[b].max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            out[b] = np.einsum("kgtw,wkd->kgtd", p, vw[b])
    return out.transpose(0, 3, 1, 2, 4).reshape(B, T, H, D)


@pytest.mark.parametrize("Kh", [4, 2], ids=["gqa8to4", "gqa8to2"])
@pytest.mark.parametrize("T", [16, 32])
@pytest.mark.parametrize("starts", [[5, 17, 24], [0, 9, 24]], ids=["ragged", "with0"])
def test_multiquery_plain_matches_jax_and_dense_reference(starts, T, Kh):
    q, kp, vp, tables, st = _mq_case(starts, T, Kh)
    nrb = 3
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=16)
    want = jpa.paged_attention_multiquery_partial(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(st), t_block=8, interpret=True, **kw,
    )
    before = tpa.paged_attention_multiquery_partial.launches
    got = tpa.paged_attention_multiquery_partial(
        _t(q), _t(kp), _t(vp), _t(tables), _t(st), t_block=8, **kw,
    )
    assert tpa.paged_attention_multiquery_partial.launches == before  # plain on CPU
    assert [tuple(g.shape) for g in got] == [(3, T, 8, 16), (3, T, 8), (3, T, 8)]
    assert all(g.dtype == torch.float32 for g in got)
    live = st > 0
    for g, w in zip(got, want):  # partials of slots with history
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live],
                                   rtol=TOL, atol=TOL)
    acc, m, l = got
    for b in np.nonzero(~live)[0]:  # no history: m = NEG_INF, l = 0, acc = 0
        assert (m[b] == tpa.NEG_INF).all() and (l[b] == 0).all() and (acc[b] == 0).all()
    merged = tpa.merge_partial_attention([got]).numpy()
    np.testing.assert_allclose(merged, _dense_reference(q, kp, vp, tables, st, nrb, Kh),
                               rtol=TOL, atol=TOL)


def test_multiquery_rejects_int8_pools():
    q, kp, vp, tables, st = _mq_case([4, 4, 4], 16, 4)
    pool = {"q": torch.zeros((20, 8, 64), dtype=torch.int8),
            "s": torch.ones((20, 8, 4))}
    with pytest.raises(ValueError, match="int8"):
        tpa.paged_attention_multiquery_partial(
            _t(q), pool, pool, _t(tables), _t(st),
            num_read_blocks=3, kv_heads=4, head_dim=16,
        )


# ---------------------------------------------------------------------------
# the prefix cache of BlockManager
# ---------------------------------------------------------------------------


def _same_state(mj, mt):
    np.testing.assert_array_equal(mt.tables, mj.tables)
    assert mt._refs == mj._refs
    assert list(mt._prefix.items()) == list(mj._prefix.items())  # LRU order too
    assert mt._parent == mj._parent and mt._nchildren == mj._nchildren
    sj, st = mj.stats(), mt.stats()
    assert st == {k: sj[k] for k in st}, (st, sj)
    assert mt.prefix_block_count() == mj.prefix_block_count()


def test_block_manager_prefix_cache_matches_jax():
    """One scripted sequence — admit, register, match, adopt, release,
    evict (leaf first), and allocation under pressure that evicts — through
    both managers: digests, tables, refcounts, LRU order and stats agree
    after every step."""
    lay_j = jp.PagedLayout(block_size=4, num_blocks=12, max_blocks_per_slot=8)
    lay_t = tp.PagedLayout(block_size=4, num_blocks=12, max_blocks_per_slot=8)
    mj, mt = jp.BlockManager(lay_j, 4), tp.BlockManager(lay_t, 4)
    p1 = list(range(1, 13))                      # 3 full blocks
    p2 = p1[:8] + [50, 51, 52, 53, 54]           # shares 2, then its own
    p3 = [7] * 30                                # unrelated, 7 full blocks
    assert mt.chain_digests(p1) == mj.chain_digests(p1)
    assert list(mt._digests(p3)) == list(mj._digests(p3))  # byte-identical
    matches = []

    def step(op, *args):
        for m in (mj, mt):
            if op == "admit":
                m.admit(args[0], args[1])
            elif op == "grow":
                m.ensure_capacity(args[0], args[1])
            elif op == "register":
                m.register_prefix(args[0], args[1])
            elif op == "adopt":
                blocks, reuse = m.match_prefix(args[1])
                matches.append((blocks, reuse))
                m.adopt_prefix(args[0], blocks)
            elif op == "release":
                m.release(args[0])
            elif op == "evict":
                matches.append(m._evict_one())
        if op in ("adopt", "evict"):
            assert matches[-1] == matches[-2]
        _same_state(mj, mt)

    step("admit", 0, 16)
    step("grow", 0, 12)
    step("register", 0, p1)
    step("admit", 1, 20)
    step("adopt", 1, p2)                         # hits p1's first 2 blocks
    assert matches[-1][1] == 8
    step("grow", 1, 13)
    step("register", 1, p2)                      # p2's tail extends the chain
    step("release", 0)                           # shared blocks stay cached
    step("admit", 0, 16)
    step("adopt", 0, p1)                         # p1 again: 2 blocks (limit)
    step("release", 0)
    step("release", 1)
    assert mt.stats()["cached_prefix_blocks"] == 4
    step("evict")                                # LRU leaf first
    step("admit", 2, 30)
    step("grow", 2, 30)                          # free list runs dry: evicts
    step("register", 2, p3)
    step("release", 2)
    for _ in range(8):
        step("evict")
    for prompt in (p1, p2, p3):
        assert mt.match_prefix(prompt) == mj.match_prefix(prompt)


def test_prefix_cache_leaf_first_eviction():
    """Port of ``tests/test_paged.py::test_prefix_cache_leaf_first_eviction``:
    eviction drains a chain tail first, so its head stays matchable."""
    bm = tp.BlockManager(tp.PagedLayout(block_size=4, num_blocks=10,
                                        max_blocks_per_slot=8), 4)
    p = list(range(1, 13))
    bm.admit(0, 12)
    bm.ensure_capacity(0, 12)
    bm.register_prefix(0, p)
    bm.release(0)
    assert bm.stats()["cached_prefix_blocks"] == 3
    assert bm._evict_one()
    assert bm.match_prefix(p)[1] == 8
    assert bm._evict_one()
    assert bm.match_prefix(p)[1] == 4


# ---------------------------------------------------------------------------
# llama_prefill_continue_paged
# ---------------------------------------------------------------------------


def _continue_case(starts, suffix_lens, P2, bs, max_seq, kv_int8, seed=7):
    """A pool holding each row's history (the JAX package's monolithic
    prefill of the first ``start`` tokens), the rows' suffixes, and both
    packages' copies of params and pools."""
    B = len(starts)
    jc = dataclasses.replace(jl.LlamaConfig.tiny(max_seq_len=max_seq), dtype=jnp.float32)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(max_seq_len=max_seq), dtype=torch.float32)
    jparams = jl.init_llama_params(jc, jax.random.PRNGKey(2))
    layout = jp.PagedLayout.for_model(max_seq, B, block_size=bs, num_blocks=40)
    mgr = jp.BlockManager(layout, B)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 300, s + n) for s, n in zip(starts, suffix_lens)]
    for b, prompt in enumerate(prompts):
        mgr.admit(b, len(prompt) + 8)
        mgr.ensure_capacity(b, len(prompt))
    tables = mgr.tables.copy()
    init = jp.init_paged_kv_cache_int8 if kv_int8 else jp.init_paged_kv_cache
    pk, pv = init(jc, layout)
    hist = np.zeros((B, max(max(starts), 1)), np.int32)
    for b, s in enumerate(starts):
        hist[b, :s] = prompts[b][:s]
    _, pk, pv = jlp.llama_prefill_paged(
        jc, jparams, jnp.asarray(hist), jnp.asarray(starts, jnp.int32), pk, pv,
        jnp.asarray(tables), use_flash=False,
    )
    suffix = np.zeros((B, P2), np.int32)
    for b, (s, n) in enumerate(zip(starts, suffix_lens)):
        suffix[b, :n] = prompts[b][s:]
    return jc, tc, jparams, tables, pk, pv, suffix, prompts


def _live_rows(pool, tables):
    live = np.unique(tables[tables > 0])
    if isinstance(pool, dict):
        return {k: np.asarray(v)[:, live] for k, v in pool.items()}
    return np.asarray(pool)[:, live]


@pytest.mark.parametrize(
    "case",
    [
        # (starts, suffix lengths, P2, block size, max_seq, int8 KV, all logits)
        ([48, 0, 16], [30, 20, 32], 32, 16, 128, False, False),
        ([48, 0, 16], [30, 20, 32], 32, 16, 128, False, True),
        ([64], [250], 256, 64, 512, False, False),
        ([48, 0, 16], [30, 20, 32], 32, 16, 128, True, False),
    ],
    ids=["mixed-starts", "all-logits", "multi-block-suffix", "int8-pool"],
)
def test_prefill_continue_matches_jax(case):
    starts, suffix_lens, P2, bs, max_seq, kv_int8, all_logits = case
    jc, tc, jparams, tables, pk, pv, suffix, prompts = _continue_case(
        starts, suffix_lens, P2, bs, max_seq, kv_int8
    )
    nrb = max(1, -(-max(starts) // bs))
    pk_t, pv_t = _t(_flatten(pk)), _t(_flatten(pv))  # the history prefill's pools
    lj, pk_j, pv_j = jlp.llama_prefill_continue_paged(
        jc, jparams, jnp.asarray(suffix), jnp.asarray(starts, jnp.int32),
        jnp.asarray(suffix_lens, jnp.int32), pk, pv, jnp.asarray(tables),
        num_read_blocks=nrb, return_all_logits=all_logits,
    )
    params = tconv.params_from_numpy(_flatten(jparams), device="cpu")
    before = tpa.paged_attention_multiquery_partial.launches
    lt, pk_t, pv_t = tlp.llama_prefill_continue_paged(
        tc, params, torch.from_numpy(suffix).long(),
        torch.tensor(starts, dtype=torch.int32),
        torch.tensor(suffix_lens, dtype=torch.int32), pk_t, pv_t,
        torch.from_numpy(tables), num_read_blocks=nrb,
        return_all_logits=all_logits,
    )
    assert tpa.paged_attention_multiquery_partial.launches == before
    assert tuple(lt.shape) == tuple(lj.shape)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    got_k, want_k = _live_rows(_flatten(pk_t), tables), _live_rows(pk_j, tables)
    got_v, want_v = _live_rows(_flatten(pv_t), tables), _live_rows(pv_j, tables)
    if kv_int8:
        # identical int8 codes except where a 1e-7 input difference crosses
        # a rounding edge (one code step)
        for g, w in ((got_k, want_k), (got_v, want_v)):
            assert np.abs(g["q"].astype(int) - w["q"]).max() <= 1
            np.testing.assert_allclose(g["s"], w["s"], rtol=1e-5)
    else:
        np.testing.assert_allclose(got_k, want_k, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_v, want_v, rtol=TOL, atol=TOL)
    if case[0] == [64]:
        # the multi-block suffix also equals the port's one-shot prefill
        # (the tolerance of tests/test_paged.py::test_prefill_continue_long_suffix_blocked)
        layout = tp.PagedLayout.for_model(max_seq, 1, block_size=bs, num_blocks=40)
        fk, fv = tp.init_paged_kv_cache(tc, layout, device="cpu")
        full = torch.from_numpy(np.asarray(prompts[0])[None]).long()
        ref, _, _ = tlp.llama_prefill_paged(
            tc, params, full, torch.tensor([full.shape[1]]), fk, fv,
            torch.from_numpy(tables),
        )
        np.testing.assert_allclose(lt.numpy(), ref.numpy(), rtol=5e-4, atol=5e-4)
