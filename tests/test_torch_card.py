"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU or interpret mode, so every test here skips on a
machine without an NVIDIA GPU. This file imports nothing of JAX, so it runs
on the card's machine, where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_card.py -q

(``--noconftest``: the suite's conftest.py imports JAX.)
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from langstream_tpu_torch.models.kvquant import quantize_rows
from langstream_tpu_torch.models.llama import LlamaConfig, init_llama_params
from langstream_tpu_torch.models.moe import MoEConfig, init_moe_params
from langstream_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_kernel_route,
)
from langstream_tpu_torch.ops.paged_attention import (
    NEG_INF,
    SPLIT_ROWS,
    _paged_attention_partial_q8,
    merge_partial_attention,
    multiquery_kernel_route,
    multiquery_read_splits,
    paged_attention_multiquery_partial,
    paged_attention_multiquery_reference,
    paged_attention_multiquery_split_reference,
    paged_attention_partial,
    paged_attention_reference,
    paged_attention_split_reference,
    paged_read_splits,
)
from langstream_tpu_torch.serving import kvtransfer
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="CUDA kernels run only on an NVIDIA GPU (no CPU/interpret mode)",
)

TABLES = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)


@pytest.fixture(autouse=True)
def _exact_f32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,S", [(True, 200), (False, 77)])
def test_flash_kernel_matches_plain(D, dtype, tol, causal, S):
    rng = np.random.default_rng(0)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((2, S, h, D), dtype=np.float32))
        .to(dtype).cuda()
        for h in (8, 2, 2)
    )
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, causal=causal)
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tensor_core_kernel_matches_plain(D, S, causal):
    """bf16 at the served widths goes through the wgmma kernel: ragged
    query and key edges around its 64-row warpgroup and 128-key tiles,
    and Sq != Sk without causality."""
    assert flash_kernel_route(torch.bfloat16, D) == "wgmma"
    rng = np.random.default_rng(S)
    Sk = S if causal else S + 37
    q = torch.from_numpy(rng.standard_normal((2, S, 8, D), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, Sk, 2, D), dtype=np.float32))
            for _ in range(2))
    q, k, v = (x.to(torch.bfloat16).cuda() for x in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention_reference(q, k, v, causal=causal)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", [16, 128])
def test_split_read_matches_plain(dtype, bs):
    """The split read at Llama-3-8B width over 64 slots: one slot at the
    whole window (every span live), lengths 0, SPLIT_ROWS and
    SPLIT_ROWS +- 1, the rest random, over shuffled block tables."""
    rng = np.random.default_rng(bs)
    B, H, Kh, D, nrb = 64, 32, 8, 128, 1024 // bs
    window = nrb * bs
    assert paged_read_splits(nrb, bs) == window // SPLIT_ROWS > 1
    lengths = rng.integers(1, window + 1, B)
    lengths[:5] = [window, 0, SPLIT_ROWS, SPLIT_ROWS - 1, SPLIT_ROWS + 1]
    nb = B * nrb + 1
    tables = torch.from_numpy(
        (rng.permutation(nb - 1) + 1)[: B * nrb].reshape(B, nrb).astype(np.int32)).cuda()
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32)).to(dtype).cuda()
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, bs, Kh * D), dtype=np.float32))
              .to(dtype).cuda() for _ in range(2))
    lengths = torch.from_numpy(lengths.astype(np.int32)).cuda()
    args = (q, kp, vp, tables, lengths)
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    before = paged_attention_partial.launches
    got = paged_attention_partial(*args, **kw)
    assert paged_attention_partial.launches == before + 1
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for want in (paged_attention_reference(*args, **kw),
                 paged_attention_split_reference(*args, **kw)):
        err = (merge_partial_attention([got]) - merge_partial_attention([want])).abs().max()
        assert err.item() <= tol
    acc, m, l = got
    assert (m[1] == NEG_INF).all() and (l[1] == 0).all() and (acc[1] == 0).all()
    live = lengths > 0
    assert torch.isfinite(acc[live]).all() and (l[live] > 0).all()


def test_int8_pool_launches_the_q8_kernel():
    rng = np.random.default_rng(3)
    nb, bs, Kh, D = 10, 8, 2, 128
    pools = []
    for _ in range(2):
        r = quantize_rows(torch.from_numpy(
            rng.standard_normal((nb, bs, Kh, D), dtype=np.float32)))
        pools.append({"q": r["q"].reshape(nb, bs, Kh * D).cuda(), "s": r["s"].cuda()})
    q = torch.from_numpy(rng.standard_normal((3, 8, D), dtype=np.float32)).to(
        torch.bfloat16).cuda()
    args = (q, pools[0], pools[1], torch.from_numpy(TABLES).cuda(),
            torch.tensor([20, 0, 24], dtype=torch.int32).cuda())
    kw = dict(num_read_blocks=3, kv_heads=Kh, head_dim=D)
    plain, q8 = paged_attention_partial.launches, _paged_attention_partial_q8.launches
    got = paged_attention_partial(*args, **kw)
    assert _paged_attention_partial_q8.launches == q8 + 1
    assert paged_attention_partial.launches == plain
    want = paged_attention_reference(*args, **kw)
    err = (merge_partial_attention([got]) - merge_partial_attention([want])).abs().max()
    assert err.item() <= 2e-2


def _int8_pools(rng, nb, bs, Kh, D):
    pools = []
    for _ in range(2):
        r = quantize_rows(torch.from_numpy(
            rng.standard_normal((nb, bs, Kh, D), dtype=np.float32)))
        pools.append({"q": r["q"].reshape(nb, bs, Kh * D).cuda(), "s": r["s"].cuda()})
    return pools


@pytest.mark.parametrize("q_dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("bs", [16, 64, 128])
def test_int8_split_read_matches_plain(bs, D, q_dtype, tol):
    """The int8 split read against both plain versions over 8 slots with
    lengths 0, 255, 256, 257 and the whole 1,024-row window (4 spans)."""
    rng = np.random.default_rng(bs + D)
    B, H, Kh, nrb = 8, 8, 2, 1024 // bs
    window = nrb * bs
    lengths = rng.integers(1, window + 1, B)
    lengths[:5] = [0, SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1, window]
    nb = B * nrb + 1
    tables = torch.from_numpy(
        (rng.permutation(nb - 1) + 1)[: B * nrb].reshape(B, nrb).astype(np.int32)).cuda()
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32)).to(q_dtype).cuda()
    kp, vp = _int8_pools(rng, nb, bs, Kh, D)
    lengths = torch.from_numpy(lengths.astype(np.int32)).cuda()
    args = (q, kp, vp, tables, lengths)
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    before = _paged_attention_partial_q8.launches
    got = paged_attention_partial(*args, **kw)
    assert _paged_attention_partial_q8.launches == before + 1
    torch.cuda.synchronize()
    for want in (paged_attention_reference(*args, **kw),
                 paged_attention_split_reference(*args, **kw)):
        err = (merge_partial_attention([got]) - merge_partial_attention([want])).abs().max()
        assert err.item() <= tol
    acc, m, l = got
    assert (m[0] == NEG_INF).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    assert torch.isfinite(acc[1:]).all() and (l[1:] > 0).all()


@pytest.mark.parametrize("q_dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("H,Kh", [(4, 2), (16, 2), (6, 2)])
def test_int8_split_read_group_sizes(H, Kh, q_dtype, tol):
    """G = 2 (the tiny model), 8 and 3 query heads per KV head, through
    both product routes (mma.sync for bf16 q, FMAs for f32 q)."""
    rng = np.random.default_rng(H)
    B, D, bs, nrb = 4, 128, 64, 8
    nb = B * nrb + 1
    tables = torch.from_numpy(
        (rng.permutation(nb - 1) + 1)[: B * nrb].reshape(B, nrb).astype(np.int32)).cuda()
    q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32)).to(
        q_dtype).cuda()
    kp, vp = _int8_pools(rng, nb, bs, Kh, D)
    lengths = torch.tensor([0, 70, 300, 512], dtype=torch.int32).cuda()
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    got = paged_attention_partial(q, kp, vp, tables, lengths, **kw)
    want = paged_attention_reference(q, kp, vp, tables, lengths, **kw)
    err = (merge_partial_attention([got]) - merge_partial_attention([want])).abs().max()
    assert err.item() <= tol
    assert (got[1][0] == NEG_INF).all() and (got[2][0] == 0).all()


MQ_STARTS = [0, 1, 63, 64, 65, 1536]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("T", [1, 16, 17, 64, 512])
def test_multiquery_kernel_routes_match_plain(T, bs, D, dtype, tol):
    """Both routes of the multi-query read (wgmma for bf16, FMA for f32),
    starts on and off the 64-row tile, split (T <= 64) and unsplit
    (T = 512), against the plain version and its split twin."""
    rng = np.random.default_rng(T * bs + D)
    B, H, Kh = len(MQ_STARTS), 8, 2
    nrb = max(MQ_STARTS) // bs
    nb = 1 + B * nrb
    tables = torch.from_numpy(
        (rng.permutation(nb - 1) + 1).reshape(B, nrb).astype(np.int32)).cuda()
    starts = torch.tensor(MQ_STARTS, dtype=torch.int32).cuda()
    q = torch.from_numpy(rng.standard_normal((B, T, H, D), dtype=np.float32)).to(dtype).cuda()
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, bs, Kh * D), dtype=np.float32))
              .to(dtype).cuda() for _ in range(2))
    args = (q, kp, vp, tables, starts)
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    n_split = multiquery_read_splits(B, T, H // Kh, Kh, nrb, bs)
    assert (n_split > 1) == (T <= 64)
    before = paged_attention_multiquery_partial.launches
    got = paged_attention_multiquery_partial(*args, **kw)
    assert paged_attention_multiquery_partial.launches == before + 1
    torch.cuda.synchronize()
    acc, m, l = got
    assert acc.shape == (B, T, H, D) and m.shape == l.shape == (B, T, H)
    assert (m[0] == NEG_INF).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    assert torch.isfinite(acc[1:]).all() and (l[1:] > 0).all()
    for want in (paged_attention_multiquery_reference(*args, **kw),
                 paged_attention_multiquery_split_reference(*args, **kw)):
        err = (merge_partial_attention([got]) - merge_partial_attention([want])).abs().max()
        assert err.item() <= tol


def test_new_reads_launch_their_kernels():
    """The int8 pool and the bf16 multi-query call go through the kernels
    of this design (by name, in a profile); f32 keeps the FMA kernel."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(9)
    B, H, Kh, D, bs, nrb = 4, 8, 2, 128, 64, 8
    nb = 1 + B * nrb
    tables = torch.from_numpy(
        (rng.permutation(nb - 1) + 1).reshape(B, nrb).astype(np.int32)).cuda()
    lengths = torch.tensor([0, 100, 300, 512], dtype=torch.int32).cuda()
    kq, vq = _int8_pools(rng, nb, bs, Kh, D)
    kb, vb = (torch.from_numpy(rng.standard_normal((nb, bs, Kh * D), dtype=np.float32))
              .to(torch.bfloat16).cuda() for _ in range(2))
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    q1 = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32)).to(
        torch.bfloat16).cuda()
    q16 = torch.from_numpy(rng.standard_normal((B, 16, H, D), dtype=np.float32)).cuda()
    assert multiquery_kernel_route(torch.bfloat16, D) == "wgmma"
    assert multiquery_kernel_route(torch.float32, D) == "fma"
    counts = (_paged_attention_partial_q8.launches,
              paged_attention_multiquery_partial.launches)
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        paged_attention_partial(q1, kq, vq, tables, lengths, **kw)
        paged_attention_partial(q1.float(), kq, vq, tables, lengths, **kw)
        paged_attention_multiquery_partial(q16.to(torch.bfloat16), kb, vb, tables,
                                           lengths, **kw)
        paged_attention_multiquery_partial(q16, kb.float(), vb.float(), tables,
                                           lengths, **kw)
        torch.cuda.synchronize()
    assert _paged_attention_partial_q8.launches == counts[0] + 2
    assert paged_attention_multiquery_partial.launches == counts[1] + 2
    names = {e.name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
             .split("::")[-1].split()[-1] for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    for kernel in ("paged_decode_split_q8_mma_kernel", "paged_decode_split_q8_kernel",
                   "paged_decode_combine_kernel", "paged_mq_wgmma_kernel",
                   "paged_mq_combine_kernel", "paged_mq_kernel"):
        assert kernel in names, (kernel, names)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("lengths", [[20, 9, 24], [0, 5, 16]])
def test_paged_kernels_match_plain(int8, D, lengths):
    rng = np.random.default_rng(1)
    nb, bs, Kh = 10, 8, 2
    q = torch.from_numpy(rng.standard_normal((3, 4, D), dtype=np.float32)).cuda()
    pools = [torch.from_numpy(rng.standard_normal((nb, bs, Kh * D), dtype=np.float32))
             for _ in range(2)]
    fn = paged_attention_partial
    if int8:
        pools = [
            {"q": r["q"].reshape(nb, bs, Kh * D), "s": r["s"]}
            for r in (quantize_rows(p.reshape(nb, bs, Kh, D)) for p in pools)
        ]
        pools = [{k: v.cuda() for k, v in p.items()} for p in pools]
        fn = _paged_attention_partial_q8
    else:
        pools = [p.cuda() for p in pools]
    lengths = torch.tensor(lengths, dtype=torch.int32).cuda()
    args = (q, pools[0], pools[1], torch.from_numpy(TABLES).cuda(), lengths)
    kw = dict(num_read_blocks=3, kv_heads=Kh, head_dim=D)
    before = fn.launches
    got = paged_attention_partial(*args, **kw)
    assert fn.launches == before + 1
    want = paged_attention_reference(*args, **kw)
    err = (merge_partial_attention([got]) - merge_partial_attention([want])).abs().max()
    assert err.item() <= 1e-4
    acc, m, l = got
    empty = lengths == 0
    assert (m[empty] == NEG_INF).all() and (l[empty] == 0).all() and (acc[empty] == 0).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize(
    "H,Kh,D,bs,T",
    [(4, 2, 16, 16, 16), (4, 2, 16, 16, 37), (32, 8, 128, 64, 16),
     (32, 8, 128, 64, 100), (8, 8, 64, 32, 9)],
)
def test_multiquery_kernel_matches_plain(dtype, tol, H, Kh, D, bs, T):
    """The multi-query history read at tiny and Llama-3-8B widths, slots
    with no history among them, T on and off the kernel's query tile."""
    rng = np.random.default_rng(2)
    B, max_blocks = 4, 6
    starts = torch.tensor([0, bs // 2 + 3, 2 * bs, max_blocks * bs - 5], dtype=torch.int32)
    nb = 1 + B * max_blocks
    perm = rng.permutation(np.arange(1, nb))
    tables = torch.from_numpy(perm.reshape(B, max_blocks).astype(np.int32)).cuda()
    q = torch.from_numpy(rng.standard_normal((B, T, H, D), dtype=np.float32)).to(dtype).cuda()
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, bs, Kh * D), dtype=np.float32))
              .to(dtype).cuda() for _ in range(2))
    args = (q, kp, vp, tables, starts.cuda())
    kw = dict(num_read_blocks=max_blocks, kv_heads=Kh, head_dim=D)
    before = paged_attention_multiquery_partial.launches
    got = paged_attention_multiquery_partial(*args, **kw)
    assert paged_attention_multiquery_partial.launches == before + 1
    want = paged_attention_multiquery_reference(*args, **kw)
    torch.cuda.synchronize()
    acc, m, l = got
    assert acc.shape == (B, T, H, D) and m.shape == l.shape == (B, T, H)
    assert (m[0] == NEG_INF).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    assert torch.isfinite(acc[1:]).all() and torch.isfinite(l[1:]).all()
    err = (merge_partial_attention([got]) - merge_partial_attention([want])).abs().max()
    assert err.item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("B", [8, 64])
def test_multiquery_kernel_at_the_verify_width(B, dtype, tol):
    """The speculative verify's history read at Llama-3-8B width: T = 5
    (four drafts + 1), 20 query rows of a 64-row tile; B = 8 splits the
    history (64 CTAs), B = 64 runs 512 CTAs unsplit."""
    rng = np.random.default_rng(B)
    H, Kh, D, bs, max_len, T = 32, 8, 128, 64, 2048, 5
    starts = rng.integers(1, 1537, B)
    starts[:4] = [0, bs // 2 + 5, 2 * bs, 1536]
    nrb = -(-int(starts.max()) // bs)
    nb = 1 + B * nrb
    tables = torch.from_numpy(
        (rng.permutation(nb - 1) + 1).reshape(B, nrb).astype(np.int32)).cuda()
    q = torch.from_numpy(rng.standard_normal((B, T, H, D), dtype=np.float32)).to(dtype).cuda()
    kp, vp = (torch.from_numpy(rng.standard_normal((nb, bs, Kh * D), dtype=np.float32))
              .to(dtype).cuda() for _ in range(2))
    args = (q, kp, vp, tables, torch.from_numpy(starts.astype(np.int32)).cuda())
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    if dtype == torch.bfloat16:
        assert (multiquery_read_splits(B, T, H // Kh, Kh, nrb, bs) > 1) == (B == 8)
    before = paged_attention_multiquery_partial.launches
    got = paged_attention_multiquery_partial(*args, **kw)
    assert paged_attention_multiquery_partial.launches == before + 1
    torch.cuda.synchronize()
    acc, m, l = got
    assert (m[0] == NEG_INF).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    assert torch.isfinite(acc[1:]).all() and (l[1:] > 0).all()
    want = paged_attention_multiquery_reference(*args, **kw)
    err = (merge_partial_attention([got]) - merge_partial_attention([want])).abs().max()
    assert err.item() <= tol


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32-pool", "int8-pool"])
def test_verify_chunk_card_matches_cpu(kv_int8):
    """``llama_verify_chunk_paged`` on the tiny f32 model: the card (the
    multi-query kernel on the f32 pool, the blocked gather on the int8 one)
    against the CPU's plain versions on the same pool: random drafts, an
    inactive row and a row at the context cap."""
    from langstream_tpu_torch.models.llama_paged import (
        llama_prefill_paged,
        llama_verify_chunk_paged,
    )
    from langstream_tpu_torch.models.paged import (
        BlockManager,
        PagedLayout,
        init_paged_kv_cache,
        init_paged_kv_cache_int8,
    )

    S, bs = 64, 16
    c = dataclasses.replace(LlamaConfig.tiny(max_seq_len=S), dtype=torch.float32)
    params = init_llama_params(c, torch.Generator().manual_seed(5), device="cpu")
    lens = [8, 11, 5, S - 2]
    B = len(lens)
    layout = PagedLayout.for_model(S, B, block_size=bs, num_blocks=24)
    mgr = BlockManager(layout, B)
    for b in range(B):
        mgr.admit(b, S)
        mgr.ensure_capacity(b, S)
    tables = torch.from_numpy(mgr.tables.copy())
    rng = np.random.default_rng(11)
    prompts = torch.zeros((B, max(lens)), dtype=torch.long)
    for b, n in enumerate(lens):
        prompts[b, :n] = torch.from_numpy(rng.integers(1, 300, n))
    init = init_paged_kv_cache_int8 if kv_int8 else init_paged_kv_cache
    pk, pv = init(c, layout, device="cpu")
    logits, pk, pv = llama_prefill_paged(c, params, prompts, torch.tensor(lens), pk, pv,
                                         tables)
    tokens = torch.from_numpy(rng.integers(1, 300, (B, 5)))
    tokens[:, 0] = logits.argmax(-1)
    active = torch.tensor([True, True, False, True])
    out = {}
    for device in ("cpu", "cuda"):
        before = paged_attention_multiquery_partial.launches
        em, adv, nxt, nl, _, _, lp = llama_verify_chunk_paged(
            c, _to(params, device), tokens.to(device),
            torch.tensor(lens, dtype=torch.int32, device=device), active.to(device),
            _to(pk, device), _to(pv, device), tables.to(device), S // bs)
        launched = paged_attention_multiquery_partial.launches - before
        out[device] = (em.cpu(), adv.cpu(), nxt.cpu(), nl.cpu(), lp.cpu(), launched)
    em_c, adv_c, nxt_c, nl_c, lp_c, launched_c = out["cpu"]
    em_g, adv_g, nxt_g, nl_g, lp_g, launched_g = out["cuda"]
    assert launched_c == 0 and launched_g == (0 if kv_int8 else c.layers)
    assert torch.equal(adv_g, adv_c) and torch.equal(nxt_g, nxt_c) and torch.equal(nl_g, nl_c)
    for b in range(B):
        a = int(adv_c[b])
        assert em_g[b, :a].tolist() == em_c[b, :a].tolist()
        if a:  # the inactive row emits nothing
            assert (lp_g[b, :a] - lp_c[b, :a]).abs().max().item() <= 1e-4


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros((1, 16, 4, 32), device="cuda")  # head_dim 32
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    q = torch.zeros((1, 4, 64), device="cuda")
    pool = torch.zeros((4, 8, 128), device="cuda", dtype=torch.bfloat16)
    tables = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    lengths = torch.zeros((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        paged_attention_partial(q, pool, pool, tables, lengths,
                                num_read_blocks=2, kv_heads=2, head_dim=64)
    with pytest.raises(ValueError, match="dtype"):
        paged_attention_multiquery_partial(q[:, None].contiguous(), pool, pool, tables,
                                           lengths, num_read_blocks=2, kv_heads=2,
                                           head_dim=64)


@pytest.mark.parametrize(
    "layout",
    [
        {"kv-layout": "dense"},
        {"kv-layout": "paged", "prefix-cache": False, "kv-block-size": 16},
        {"kv-layout": "paged", "prefix-cache": False, "kv-block-size": 16,
         "kv-quantize": "int8"},
        {"kv-layout": "paged", "prefix-cache": True, "kv-block-size": 16},
        {"kv-layout": "paged", "prefix-cache": True, "kv-block-size": 16,
         "prefill-chunk": 32},
        {"kv-layout": "paged", "speculative-drafts": 4},
        {"kv-layout": "paged", "speculative-drafts": 4, "kv-quantize": "int8"},
    ],
)
def test_tiny_engine_card_matches_cpu(layout, monkeypatch):
    # no uplift calibration: its wall-clock verdict would switch the two
    # devices to plain decode at other steps
    monkeypatch.setenv("LS_TPU_SPEC_CALIBRATE_EVERY", str(10**9))
    preamble = "A shared preamble of more than three blocks of sixteen tokens. "
    prompts = ["paged cache equivalence", "second prompt!", "a",
               preamble + "and a longer fourth prompt here", preamble + "fifth"]
    if layout.get("speculative-drafts"):
        prompts.append("the cat sat on the mat. " * 6)  # drafts land here
    c = dataclasses.replace(LlamaConfig.tiny(max_seq_len=256), dtype=torch.float32)
    params = init_llama_params(c, torch.Generator().manual_seed(3), device="cpu")
    cfg = ServingConfig.from_dict({"model": "tiny", "model-dtype": "float32",
                                   "slots": 3, "max-seq-len": 256,
                                   "decode-chunk": 4, **layout})
    out = {}
    for device in ("cuda", "cpu"):
        async def run(engine=TorchServingEngine(cfg, device=device, params=params)):
            try:  # two waves in turn: with the prefix cache the second hits
                results = []
                for _ in range(2):
                    results += await asyncio.gather(
                        *(engine.generate(p, {"max-tokens": 12}) for p in prompts)
                    )
                stats = engine.stats()
                return results, stats["prefix"]["hits"], stats.get("speculative")
            finally:
                await engine.close()

        results, hits, spec = asyncio.run(run())
        out[device] = ([r["tokens"] for r in results], hits)
        if spec is not None:
            assert spec["drafts_accepted"] > 0
    assert out["cuda"] == out["cpu"]
    if layout.get("prefix-cache"):
        assert out["cuda"][1] >= 2


@pytest.mark.parametrize(
    "layout",
    [
        {"kv-layout": "dense"},
        {"kv-layout": "paged", "prefix-cache": False, "kv-block-size": 16,
         "kv-quantize": "int8"},
        {"kv-layout": "paged", "prefix-cache": True, "kv-block-size": 16,
         "prefill-chunk": 32},
    ],
)
def test_moe_tiny_engine_card_matches_cpu(layout):
    """moe-tiny in f32 on the card and on the CPU with the same params: two
    waves of more requests than slots (capacity drops at 3 slots), greedy
    tokens identical."""
    preamble = "A shared preamble of more than three blocks of sixteen tokens. "
    prompts = ["paged cache equivalence", "second prompt!", "a", "judge my vow",
               preamble + "and a longer fourth prompt here", preamble + "fifth"]
    c = dataclasses.replace(MoEConfig.tiny(max_seq_len=256), dtype=torch.float32)
    params = init_moe_params(c, torch.Generator().manual_seed(3), device="cpu")
    cfg = ServingConfig.from_dict({"model": "moe-tiny", "model-dtype": "float32",
                                   "slots": 3, "max-seq-len": 256,
                                   "decode-chunk": 4, **layout})
    out = {}
    for device in ("cuda", "cpu"):
        async def run(engine=TorchServingEngine(cfg, device=device, params=params)):
            try:
                results = []
                for _ in range(2):
                    results += await asyncio.gather(
                        *(engine.generate(p, {"max-tokens": 12}) for p in prompts)
                    )
                return results
            finally:
                await engine.close()

        out[device] = [r["tokens"] for r in asyncio.run(run())]
    assert out["cuda"] == out["cpu"]



def test_qos_preemption_card_matches_cpu():
    """tests/test_qos.py's preemption shape (8 blocks of 16, 2 slots) in
    f32 (``chip_smoke.py`` phase 5's QoS layout): a batch request preempted
    by an interactive arrival at its third token resumes to its unpreempted
    tokens, and the card's streams equal the CPU's."""
    import chip_smoke

    c = dataclasses.replace(LlamaConfig.tiny(max_seq_len=256), dtype=torch.float32)
    params = init_llama_params(c, torch.Generator().manual_seed(3), device="cpu")
    cfg = {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 256,
           "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16,
           "kv-pool-blocks": 8, "prefix-cache": False, "qos": {}}
    out = {device: chip_smoke.qos_preemption_round_trip(torch, cfg, device, params)
           for device in ("cuda", "cpu")}
    assert out["cuda"] == out["cpu"]
    alone, resumed, _, counts = out["cuda"]
    assert resumed == alone and counts == (1, 1)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_kv_transfer_pinned_paths_equal_the_cpu(int8):
    """The card's gather, fetch (pinned buffers, one event) and scatter
    (pinned pieces, asynchronous uploads) move the same bytes as the CPU's
    plain path: an export's rows, a demotion's blocks and a scatter of
    block lists and of whole arrays."""
    gen = torch.Generator().manual_seed(4)
    L, nb, bs, khd, kh = 4, 12, 64, 256, 2

    def pool():
        if int8:
            return {"q": torch.randint(-127, 127, (L, nb, bs, khd), dtype=torch.int8,
                                       generator=gen),
                    "s": torch.rand((L, nb, bs, kh), generator=gen)}
        return torch.randn((L, nb, bs, khd), generator=gen).to(torch.bfloat16)

    def to(p, device):  # always a copy: the scatter writes in place
        if int8:
            return {k: v.to(device, copy=True) for k, v in p.items()}
        return p.to(device, copy=True)

    pk, pv, dk, dv = pool(), pool(), pool(), pool()
    table = np.array([5, 2, 9], dtype=np.int32)
    out = {}
    for device in ("cuda", "cpu"):
        k, v = to(pk, device), to(pv, device)
        rows, _ = kvtransfer.fetch_rows(*kvtransfer.gather_slot(k, v, table, 3), 150)
        blocks, _ = kvtransfer.fetch_blocks(*kvtransfer.gather_slot(k, v, table, 3), 3)
        dst = (to(dk, device), to(dv, device))
        lists = {name: [b[name] for b in blocks] for name in blocks[0]}
        dst = kvtransfer.scatter_slot(*dst, lists, np.array([1, 3, 4, 0], np.int32), 170, 256)
        dst = kvtransfer.scatter_slot(*dst, rows, np.array([6, 7, 8, 0], np.int32), 150, 256)
        torch.cuda.synchronize()
        out[device] = (rows, blocks, to(dst[0], "cpu"), to(dst[1], "cpu"))
    assert kvtransfer.serialize_handoff({}, out["cuda"][0]) == kvtransfer.serialize_handoff(
        {}, out["cpu"][0])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert kvtransfer.serialize_handoff({}, a) == kvtransfer.serialize_handoff({}, b)
    for x, y in zip(out["cuda"][2:], out["cpu"][2:]):
        for a, b in (zip(x.values(), y.values()) if int8 else [(x, y)]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_adapter_card_matches_cpu_and_offline_merge(kv):
    """``chip_smoke.py`` phase 5's adapter case: greedy f32 tokens under one
    adapter (rank 4, ``scale=0.5``) are the same on the card and the CPU and
    equal a store-less engine whose weights carry the adapter merged
    offline; the base model's differ."""
    import chip_smoke

    c = dataclasses.replace(LlamaConfig.tiny(max_seq_len=256), dtype=torch.float32)
    params = init_llama_params(c, torch.Generator().manual_seed(3), device="cpu")
    cfg = {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 256,
           "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16,
           "prefix-cache": False, "kv-quantize": kv}
    out = {device: chip_smoke.adapter_round_trip(torch, cfg, device, params)
           for device in ("cuda", "cpu")}
    adapted, merged, base = out["cuda"]
    assert out["cuda"][:2] == out["cpu"][:2]
    assert adapted == merged and adapted != base


def test_adapter_row_load_in_place_and_lora_delta_on_the_card():
    """A row written in place on the dispatch thread (pinned uploads, the
    f32 factors converted on the card) holds the bf16 factors, row 0 stays
    zero, and ``lora_delta`` on the card equals the CPU within 2e-2."""
    from langstream_tpu_torch.models.llama import lora_delta
    from langstream_tpu_torch.serving.adapters import make_lora_arrays

    cfg = ServingConfig.from_dict({"model": "tiny", "slots": 4, "max-seq-len": 256,
                                   "kv-layout": "paged", "kv-block-size": 16,
                                   "adapter-store": {"rank": 4, "t0-entries": 2}})
    engine = TorchServingEngine(cfg, device="cuda")
    arrays = make_lora_arrays(layers=2, hidden=64, heads=4, kv_heads=2, head_dim=16, rank=4,
                              seed=5, scale=0.5)
    engine._run_adapter_load(arrays, 2)
    torch.cuda.synchronize()
    for k, buf in engine._ad_layers.items():
        assert buf.dtype == torch.bfloat16
        assert torch.equal(buf[:, 2].cpu(), torch.from_numpy(arrays[k]).to(torch.bfloat16))
        assert not buf[:, 0].any() and not buf[:, 1].any()
    h = torch.randn(4, 7, 64, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    ids = torch.tensor([0, 2, 2, 0])
    a, b = engine._ad_layers["wq_a"][0], engine._ad_layers["wq_b"][0]
    got = lora_delta(h.cuda(), ids.cuda(), a, b).float().cpu()
    want = lora_delta(h, ids, a.cpu(), b.cpu()).float()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert not got[0].any() and not got[3].any()
    asyncio.run(engine.close())


def test_a_genuine_cuda_oom_is_classified_as_an_allocator_failure():
    with pytest.raises(RuntimeError) as err:
        torch.empty(torch.cuda.get_device_properties(0).total_memory * 2,
                    dtype=torch.uint8, device="cuda")
    assert TorchServingEngine._resource_exhausted(err.value)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_pool_shrink_chaos_card_matches_cpu(kv):
    """Allocator failures injected at pool-grow and prefill on the card: the
    shrink requeues and every request completes with the CPU's tokens."""
    cfg = {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 256,
           "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16, "kv-quantize": kv,
           "shrink-recovery-s": 0.3,
           "faults": [{"site": "pool-grow", "after": 4, "count": 2},
                      {"site": "prefill", "after": 1, "count": 1}]}
    params = init_llama_params(dataclasses.replace(LlamaConfig.tiny(max_seq_len=256),
                                                   dtype=torch.float32),
                               torch.Generator().manual_seed(3), device="cpu")
    prompts = ["paged cache equivalence", "second prompt!", "a", "judge my vow", "fox"]

    def run(device):
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device=device, params=params)

        async def main():
            try:
                outs = await asyncio.gather(*(engine.generate(p, {"max-tokens": 12,
                                                                  "temperature": 0})
                                              for p in prompts))
                return [o["tokens"] for o in outs], engine.stats()["survival"]["shrinks"]
            finally:
                await engine.close()

        return asyncio.run(main())

    card, cpu = run("cuda"), run("cpu")
    assert card == cpu and card[1] >= 1


def test_journey_kinds_card_match_cpu():
    """A mixed wave and a chained handoff whose decode replica is dead (the
    local fallback): the journey kinds of every request and the tokens are
    the same on the card as on the CPU."""
    from langstream_tpu_torch.serving.handoff import HandoffChainer, RetryPolicy
    from langstream_tpu_torch.serving.journey import JOURNEYS

    base = {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 192,
            "decode-chunk": 4, "kv-layout": "paged", "kv-block-size": 16}
    params = init_llama_params(dataclasses.replace(LlamaConfig.tiny(max_seq_len=192),
                                                   dtype=torch.float32),
                               torch.Generator().manual_seed(5), device="cpu")

    class _DeadRouter:
        on_breaker_event = None

        def pick(self, phase=None, exclude=None):
            return "dead-0"

        def report_failure(self, replica, kind="error"):
            pass

    async def dead(replica, payload, headers, timeout_s):
        raise ConnectionError("refused")

    def run(device):
        wave = TorchServingEngine(ServingConfig.from_dict(base), device=device, params=params)
        pre = TorchServingEngine(ServingConfig.from_dict({**base, "pool-role": "prefill"}),
                                 device=device, params=params)

        async def main():
            before = set(JOURNEYS.ids())
            try:
                outs = await asyncio.gather(*(wave.generate(p, {"max-tokens": 9})
                                              for p in ("mixed wave", "of three", "prompts")))
                chainer = HandoffChainer(pre, router=_DeadRouter(), transport=dead,
                                         policy=RetryPolicy(attempts=2, backoff_s=0.001))
                fallback = await chainer.chain(await pre.generate("fall back", {"max-tokens": 7}))
            finally:
                await wave.close()
                await pre.close()
            journeys = [[e["kind"] for e in JOURNEYS.events(j)] for j in JOURNEYS.ids()
                        if j not in before]
            return [o["tokens"] for o in outs] + [fallback["tokens"]], journeys

        return asyncio.run(main())

    card, cpu = run("cuda"), run("cpu")
    assert card == cpu
    assert card[1][-1] == ["submit", "admit", "first-token", "export", "export-taken",
                           "import-received", "import", "first-step", "finish"]
