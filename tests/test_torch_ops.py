"""Port kernels' plain versions against the JAX package's Pallas kernels.

The same inputs, made with numpy from a seed, go through the JAX function
(Pallas kernels in interpret mode, as tests/test_ops.py and
tests/test_paged.py run them) and through the port's wrapper, which takes
its plain PyTorch version for CPU tensors. The CUDA kernels themselves run
only on the card: tests/test_torch_card.py holds them to the plain versions
there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models.kvquant import quantize_rows as jax_quantize_rows
from langstream_tpu.models.llama import LlamaConfig as JaxConfig
from langstream_tpu.models.llama_paged import _cache_partial_xla as jax_cache_partial
from langstream_tpu.ops.flash_attention import flash_attention as jax_flash
from langstream_tpu.ops.paged_attention import (
    merge_partial_attention as jax_merge,
    paged_attention_multiquery_partial as jax_paged_mq,
    paged_attention_partial as jax_paged,
)
from langstream_tpu_torch.models.llama import LlamaConfig as TorchConfig
from langstream_tpu_torch.models.llama_paged import _cache_partial_xla
from langstream_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_kernel_route,
)
from langstream_tpu_torch.models.kvquant import quantize_rows
from langstream_tpu_torch.ops.paged_attention import (
    NEG_INF,
    SPLIT_ROWS,
    combine_split_partials,
    _multiquery_plan,
    merge_partial_attention,
    multiquery_kernel_route,
    multiquery_read_splits,
    paged_attention_multiquery_reference,
    paged_attention_multiquery_split_reference,
    paged_attention_partial,
    paged_attention_reference,
    paged_attention_split_reference,
    paged_read_splits,
)

def _qkv(B=2, S=64, H=8, Kh=4, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, S, H, D), dtype=np.float32),
        rng.standard_normal((B, S, Kh, D), dtype=np.float32),
        rng.standard_normal((B, S, Kh, D), dtype=np.float32),
    )


# ---------------------------------------------------------------------------
# flash attention (kernel 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "causal,shape",
    [
        (True, {}),                       # aligned
        (False, {}),                      # non-causal
        (True, {"S": 48}),                # unaligned S: padding hidden by causality
        (False, {"S": 40, "H": 4, "Kh": 4}),  # non-causal + padded keys masked
        (True, {"H": 8, "Kh": 2}),        # GQA 8 -> 2 group mapping
    ],
)
def test_flash_plain_matches_jax_kernel(causal, shape):
    q, k, v = _qkv(**shape)
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=32, block_k=32, interpret=True,
    )
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_cpu_takes_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=16))
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before  # no kernel on the CPU
    torch.testing.assert_close(out, flash_attention_reference(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize(
    "dtype,head_dim,route",
    [
        (torch.bfloat16, 128, "wgmma"),  # Llama-3-8B prefill
        (torch.bfloat16, 64, "wgmma"),
        (torch.bfloat16, 16, "fma"),     # the tiny test model
        (torch.float32, 128, "fma"),     # TF32 would miss the f32 tolerance
        (torch.float32, 16, "fma"),
    ],
)
def test_flash_kernel_route(dtype, head_dim, route):
    assert flash_kernel_route(dtype, head_dim) == route


def test_flash_rejects_cross_attention_causal():
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=16))
    with pytest.raises(ValueError, match="self-attention"):
        flash_attention(q, k[:, :8], v[:, :8], causal=True)


# ---------------------------------------------------------------------------
# paged decode read (kernels 2 and 3)
# ---------------------------------------------------------------------------


def _paged_inputs(seed, *, B=3, H=4, Kh=2, D=16, bs=8, nb=10, q_dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), dtype=np.float32).astype(q_dtype)
    pools = [rng.standard_normal((nb, bs, Kh * D), dtype=np.float32) for _ in range(2)]
    return q, pools


TABLES = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)


@pytest.mark.parametrize(
    "lengths",
    [
        [20, 9, 24],     # the JAX package's own case
        [0, 5, 16],      # an inactive slot, a sub-block length, a block-exact length
        [0, 0, 0],       # nothing to read anywhere
    ],
)
def test_paged_plain_matches_jax_kernel_and_xla(lengths):
    q, (pk, pv) = _paged_inputs(0)
    lengths = np.array(lengths, np.int32)
    Kh, D, nrb = 2, 16, 3
    c = JaxConfig.tiny()
    j_args = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
              jnp.asarray(TABLES), jnp.asarray(lengths))
    want_kernel = jax_paged(*j_args, num_read_blocks=nrb, kv_heads=Kh,
                            head_dim=D, interpret=True)
    want_xla = jax_cache_partial(c, *j_args, nrb)
    got = paged_attention_partial(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(TABLES), torch.from_numpy(lengths),
        num_read_blocks=nrb, kv_heads=Kh, head_dim=D,
    )
    out = merge_partial_attention([got]).numpy()
    for want in (want_kernel, want_xla):
        np.testing.assert_allclose(
            out, np.asarray(jax_merge([want])), rtol=1e-5, atol=1e-5
        )
    # the model layer's named twin is the same plain version
    twin = _cache_partial_xla(
        TorchConfig.tiny(), torch.from_numpy(q), torch.from_numpy(pk),
        torch.from_numpy(pv), torch.from_numpy(TABLES), torch.from_numpy(lengths), nrb,
    )
    for g, t in zip(got, twin):
        torch.testing.assert_close(g, t, rtol=0, atol=0)
    # the inactive-slot contract the merge's guards rely on
    acc, m, l = (t.numpy() for t in got)
    for b in np.nonzero(lengths == 0)[0]:
        assert (m[b] == NEG_INF).all() and (l[b] == 0).all() and (acc[b] == 0).all()
    assert np.isfinite(out).all()


@pytest.mark.parametrize("lengths", [[20, 9, 24], [0, 5, 16]])
def test_paged_q8_plain_matches_jax_kernel_and_xla(lengths):
    """int8 pools with bf16 queries: the port's plain version against the
    JAX int8 kernel twin (interpret) and the XLA gather path."""
    rng = np.random.default_rng(1)
    Kh, D, bs, nb, nrb = 2, 16, 8, 10, 3
    q32 = rng.standard_normal((3, 4, D), dtype=np.float32)
    q_j = jnp.asarray(q32).astype(jnp.bfloat16)
    pools_j = []
    for _ in range(2):
        rows = rng.standard_normal((nb, bs, Kh, D), dtype=np.float32)
        qr = jax_quantize_rows(jnp.asarray(rows))
        pools_j.append({"q": qr["q"].reshape(nb, bs, Kh * D), "s": qr["s"]})
    lengths = np.array(lengths, np.int32)
    c = JaxConfig.tiny()
    j_args = (q_j, pools_j[0], pools_j[1], jnp.asarray(TABLES), jnp.asarray(lengths))
    want_kernel = jax_paged(*j_args, num_read_blocks=nrb, kv_heads=Kh,
                            head_dim=D, interpret=True)
    want_xla = jax_cache_partial(c, *j_args, nrb)

    def port_pool(p):
        return {"q": torch.from_numpy(np.array(p["q"])),
                "s": torch.from_numpy(np.array(p["s"]))}

    q_t = torch.from_numpy(q32).to(torch.bfloat16)
    got = paged_attention_partial(
        q_t, port_pool(pools_j[0]), port_pool(pools_j[1]),
        torch.from_numpy(TABLES), torch.from_numpy(lengths),
        num_read_blocks=nrb, kv_heads=Kh, head_dim=D,
    )
    out = merge_partial_attention([got]).to(torch.float32).numpy()
    for want in (want_kernel, want_xla):
        np.testing.assert_allclose(
            out, np.asarray(jax_merge([want]), dtype=np.float32),
            rtol=5e-2, atol=5e-2,  # bf16 math, blocked vs full softmax orders
        )


@pytest.mark.parametrize("split_rows", [8, 16])
@pytest.mark.parametrize(
    "lengths",
    [
        [16, 17, 0],     # on a span boundary, one row past it, an inactive slot
        [8, 9, 24],      # the first boundary, one past it, the whole window
        [0, 0, 0],       # every slot empty
        [20, 9, 24],     # the JAX package's own case
    ],
)
def test_paged_split_plain_matches_unsplit_and_jax_kernel(lengths, split_rows):
    """The split read's plain version (span partials merged by the combine
    kernel's algebra) against the unsplit plain version and the JAX kernel
    in interpret mode, with spans small enough that the tiny window holds
    several."""
    q, (pk, pv) = _paged_inputs(4)
    lengths = np.array(lengths, np.int32)
    Kh, D, nrb = 2, 16, 3
    args = (torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(TABLES), torch.from_numpy(lengths))
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    got = paged_attention_split_reference(*args, split_rows=split_rows, **kw)
    unsplit = paged_attention_reference(*args, **kw)
    for g, u in zip(got, unsplit):
        torch.testing.assert_close(g, u, rtol=1e-5, atol=1e-5)
    want = jax_paged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                     jnp.asarray(TABLES), jnp.asarray(lengths), num_read_blocks=nrb,
                     kv_heads=Kh, head_dim=D, interpret=True)
    np.testing.assert_allclose(merge_partial_attention([got]).numpy(),
                               np.asarray(jax_merge([want])), rtol=1e-5, atol=1e-5)
    acc, m, l = (t.numpy() for t in got)
    for b in np.nonzero(lengths == 0)[0]:
        assert (m[b] == NEG_INF).all() and (l[b] == 0).all() and (acc[b] == 0).all()


def test_paged_split_plain_reads_int8_pools():
    rng = np.random.default_rng(5)
    Kh, D, bs, nb, nrb = 2, 16, 8, 10, 3
    pools = []
    for _ in range(2):
        r = quantize_rows(torch.from_numpy(
            rng.standard_normal((nb, bs, Kh, D), dtype=np.float32)))
        pools.append({"q": r["q"].reshape(nb, bs, Kh * D), "s": r["s"]})
    q = torch.from_numpy(rng.standard_normal((3, 4, D), dtype=np.float32))
    args = (q, pools[0], pools[1], torch.from_numpy(TABLES),
            torch.tensor([17, 0, 24], dtype=torch.int32))
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    got = paged_attention_split_reference(*args, split_rows=8, **kw)
    for g, u in zip(got, paged_attention_reference(*args, **kw)):
        torch.testing.assert_close(g, u, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "num_read_blocks,block_size,split_rows,want",
    [
        (32, 64, 256, 8),    # 2,048 rows of the paged pool: 8 spans
        (16, 128, 256, 8),   # the dense layout's identity tables
        (4, 64, 256, 1),     # exactly one span: no combine launch
        (5, 64, 256, 2),     # one block past a span
        (1, 16, 256, 1),
        (3, 8, 8, 3),        # the CPU tests' small spans
        (3, 8, 16, 2),
    ],
)
def test_paged_read_splits(num_read_blocks, block_size, split_rows, want):
    assert paged_read_splits(num_read_blocks, block_size, split_rows) == want
    assert paged_read_splits(num_read_blocks, block_size) == max(
        1, -(-num_read_blocks * block_size // SPLIT_ROWS))


def test_combine_split_partials_reads_live_spans_only():
    """Spans past a slot's length are never written by the kernel: the
    combine must not read them (NaN there stays out), and a slot with no
    live span gives m = NEG_INF, l = 0, acc = 0; live spans merge as
    merge_partial_attention does, NEG_INF spans included."""
    rng = np.random.default_rng(6)
    B, n, H, D, R = 4, 3, 2, 5, 8
    acc = torch.from_numpy(rng.standard_normal((B, n, H, D), dtype=np.float32))
    m = torch.from_numpy(rng.standard_normal((B, n, H), dtype=np.float32))
    l = torch.from_numpy(rng.uniform(0.5, 2.0, (B, n, H)).astype(np.float32))
    lengths = torch.tensor([0, 8, 9, 30], dtype=torch.int32)  # 0, 1, 2 and 3 live spans
    m[3, 1] = NEG_INF  # a live span whose rows all scored NEG_INF
    l[3, 1] = 0.0
    acc[3, 1] = 0.0
    for b, live in enumerate((0, 1, 2, 3)):
        acc[b, live:] = float("nan")
        m[b, live:] = float("nan")
        l[b, live:] = float("nan")
    A, M, L = combine_split_partials(acc, m, l, lengths, window=n * R, split_rows=R)
    assert torch.isfinite(A).all() and torch.isfinite(L).all()
    assert (M[0] == NEG_INF).all() and (L[0] == 0).all() and (A[0] == 0).all()
    for b, live in enumerate((1, 2, 3), start=1):
        parts = [(acc[b, s], m[b, s], l[b, s]) for s in range(live)]
        torch.testing.assert_close(
            merge_partial_attention([(A[b], M[b], L[b])]),
            merge_partial_attention(parts), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(M[b], m[b, :live].amax(dim=0), rtol=0, atol=0)


@pytest.mark.parametrize("q_dtype,tol", [("bfloat16", 5e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("split_rows", [8, 16])
@pytest.mark.parametrize("lengths", [[16, 17, 0], [8, 9, 24], [20, 9, 24]])
def test_paged_q8_split_plain_matches_jax_kernel(lengths, split_rows, q_dtype, tol):
    """The int8 split read's plain version (span partials of the int8 pool
    merged by the combine's algebra) against the JAX int8 kernel
    ``_paged_kernel_q8`` in interpret mode, with spans small enough that
    the tiny window holds several: span boundaries, one row past them, an
    empty slot and the whole window."""
    rng = np.random.default_rng(7)
    Kh, D, bs, nb, nrb = 2, 16, 8, 10, 3
    q32 = rng.standard_normal((3, 4, D), dtype=np.float32)
    q_j = jnp.asarray(q32).astype(q_dtype)
    pools_j = []
    for _ in range(2):
        rows = rng.standard_normal((nb, bs, Kh, D), dtype=np.float32)
        qr = jax_quantize_rows(jnp.asarray(rows))
        pools_j.append({"q": qr["q"].reshape(nb, bs, Kh * D), "s": qr["s"]})
    lengths = np.array(lengths, np.int32)
    want = jax_paged(q_j, pools_j[0], pools_j[1], jnp.asarray(TABLES), jnp.asarray(lengths),
                     num_read_blocks=nrb, kv_heads=Kh, head_dim=D, interpret=True)
    pools = [{"q": torch.from_numpy(np.array(p["q"])), "s": torch.from_numpy(np.array(p["s"]))}
             for p in pools_j]
    q_t = torch.from_numpy(q32).to(getattr(torch, q_dtype))
    args = (q_t, pools[0], pools[1], torch.from_numpy(TABLES), torch.from_numpy(lengths))
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    got = paged_attention_split_reference(*args, split_rows=split_rows, **kw)
    np.testing.assert_allclose(
        merge_partial_attention([got]).to(torch.float32).numpy(),
        np.asarray(jax_merge([want]), dtype=np.float32), rtol=tol, atol=tol)
    acc, m, l = got
    for b in np.nonzero(lengths == 0)[0]:
        assert (m[b] == NEG_INF).all() and (l[b] == 0).all() and (acc[b] == 0).all()


MQ_TABLES = np.array([[3, 1, 4, 0, 0, 0], [5, 9, 2, 0, 0, 0], [6, 8, 7, 0, 0, 0]], np.int32)


@pytest.mark.parametrize("span_rows", [8, 16])
@pytest.mark.parametrize(
    "starts",
    [
        [0, 8, 9],      # no history, on the first 8-row boundary, one past it
        [16, 17, 24],   # on the 16-row boundary, one past it, the whole window
        [0, 0, 0],      # no history anywhere
    ],
)
def test_multiquery_split_plain_matches_unsplit_and_jax_kernel(starts, span_rows):
    """The split multi-query read's plain version (span partials merged by
    the combine's algebra, T axis included) against the unsplit plain
    version and the JAX kernel in interpret mode, with spans small enough
    that the tiny 24-row window holds several."""
    rng = np.random.default_rng(11)
    B, T, H, Kh, D, bs, nb, nrb = 3, 16, 8, 2, 16, 8, 10, 3
    q = rng.standard_normal((B, T, H, D), dtype=np.float32)
    kp, vp = (rng.standard_normal((nb, bs, Kh * D), dtype=np.float32) for _ in range(2))
    st = np.array(starts, np.int32)
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(MQ_TABLES), torch.from_numpy(st))
    kw = dict(num_read_blocks=nrb, kv_heads=Kh, head_dim=D)
    got = paged_attention_multiquery_split_reference(*args, span_rows=span_rows, **kw)
    for g, u in zip(got, paged_attention_multiquery_reference(*args, **kw)):
        torch.testing.assert_close(g, u, rtol=1e-5, atol=1e-5)
    want = jax_paged_mq(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                        jnp.asarray(MQ_TABLES), jnp.asarray(st), t_block=8,
                        interpret=True, **kw)
    np.testing.assert_allclose(merge_partial_attention([got]).numpy(),
                               np.asarray(jax_merge([want])), rtol=1e-5, atol=1e-5)
    acc, m, l = got
    for b in np.nonzero(st == 0)[0]:
        assert (m[b] == NEG_INF).all() and (l[b] == 0).all() and (acc[b] == 0).all()


@pytest.mark.parametrize(
    "batch,t,num_read_blocks,want",
    [
        (8, 512, 24, 1),   # a 512-token chunk (path C's passes): never split
        (1, 512, 32, 1),   # ... not even alone
        (8, 16, 24, 5),    # B=8, T=16: 64 CTAs, 5 spans of 320 rows
        (8, 64, 32, 1),    # the hits' bucket at B=8: 256 one-warpgroup CTAs fill the card
        (6, 64, 32, 1),    # path C's wave 2: 192 CTAs
        (1, 64, 32, 8),    # path C's wave 3: 32 CTAs, 8 spans of 256 rows
        (8, 16, 1, 1),     # the window is one 64-row tile
    ],
)
def test_multiquery_read_splits(batch, t, num_read_blocks, want):
    """Pinned at Llama-3-8B's G = 4, Kh = 8 and bs 64: the spans cover the
    window exactly, in whole 64-row tiles, with no empty trailing span."""
    n = multiquery_read_splits(batch, t, 4, 8, num_read_blocks, 64)
    assert n == want
    wg, n2, span = _multiquery_plan(batch, t, 4, 8, num_read_blocks, 64)
    window = num_read_blocks * 64
    assert n2 == n and span % 64 == 0 and (n - 1) * span < window <= n * span
    assert wg == (1 if t * 4 <= 256 else 3)


def test_combine_split_partials_reads_live_spans_only_with_a_t_axis():
    """The multi-query combine's algebra: partials (B, n, T, H[, D]); spans
    past a slot's history are never written (NaN there stays out), a slot
    with no live span gives m = NEG_INF, l = 0, acc = 0."""
    rng = np.random.default_rng(8)
    B, n, T, H, D, R = 4, 3, 5, 2, 6, 8
    acc = torch.from_numpy(rng.standard_normal((B, n, T, H, D), dtype=np.float32))
    m = torch.from_numpy(rng.standard_normal((B, n, T, H), dtype=np.float32))
    l = torch.from_numpy(rng.uniform(0.5, 2.0, (B, n, T, H)).astype(np.float32))
    starts = torch.tensor([0, 8, 9, 30], dtype=torch.int32)  # 0, 1, 2 and 3 live spans
    for b, live in enumerate((0, 1, 2, 3)):
        acc[b, live:] = float("nan")
        m[b, live:] = float("nan")
        l[b, live:] = float("nan")
    A, M, L = combine_split_partials(acc, m, l, starts, window=n * R, split_rows=R)
    assert A.shape == (B, T, H, D) and M.shape == L.shape == (B, T, H)
    assert torch.isfinite(A).all() and torch.isfinite(L).all()
    assert (M[0] == NEG_INF).all() and (L[0] == 0).all() and (A[0] == 0).all()
    for b, live in enumerate((1, 2, 3), start=1):
        parts = [(acc[b, s], m[b, s], l[b, s]) for s in range(live)]
        torch.testing.assert_close(
            merge_partial_attention([(A[b], M[b], L[b])]),
            merge_partial_attention(parts), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(M[b], m[b, :live].amax(dim=0), rtol=0, atol=0)


@pytest.mark.parametrize(
    "dtype,head_dim,route",
    [
        (torch.bfloat16, 128, "wgmma"),  # Llama-3-8B's continuation prefill
        (torch.bfloat16, 64, "wgmma"),
        (torch.bfloat16, 16, "fma"),     # the tiny test model
        (torch.float32, 128, "fma"),     # TF32 would miss the f32 tolerance
        (torch.float32, 64, "fma"),
        (torch.float32, 16, "fma"),
    ],
)
def test_multiquery_kernel_route(dtype, head_dim, route):
    assert multiquery_kernel_route(dtype, head_dim) == route


def test_merge_partial_attention_matches_jax():
    rng = np.random.default_rng(2)
    parts = []
    for _ in range(3):
        acc = rng.standard_normal((4, 6, 8), dtype=np.float32)
        m = rng.standard_normal((4, 6), dtype=np.float32)
        l = rng.uniform(0.5, 2.0, (4, 6)).astype(np.float32)
        parts.append([acc, m, l])
    # an empty segment and an all-empty row exercise the NEG_INF guards
    parts[1][1][0] = NEG_INF
    parts[1][2][0] = 0.0
    parts[1][0][0] = 0.0
    for p in parts:
        p[1][1] = NEG_INF
        p[2][1] = 0.0
        p[0][1] = 0.0
    want = np.asarray(jax_merge([tuple(jnp.asarray(a) for a in p) for p in parts]))
    got = merge_partial_attention(
        [tuple(torch.from_numpy(a) for a in p) for p in parts]
    ).numpy()
    # exp is the only transcendental: XLA's and PyTorch's CPU exp may round
    # the last bit differently, so equality is held to 2 ulp of f32
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
    assert (got[1] == 0).all()


def test_paged_cpu_takes_plain_version():
    q, (pk, pv) = _paged_inputs(3)
    args = (torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
            torch.from_numpy(TABLES), torch.tensor([3, 8, 20], dtype=torch.int32))
    kw = dict(num_read_blocks=3, kv_heads=2, head_dim=16)
    before = paged_attention_partial.launches
    got = paged_attention_partial(*args, **kw)
    want = paged_attention_reference(*args, **kw)
    assert paged_attention_partial.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A build that cannot run raises; there is no fallback."""
    from langstream_tpu_torch.ops import _build

    monkeypatch.setenv("LS_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    assert _build.library_path("flash_attention").parent == tmp_path / "build"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.build_all(names=()) == {}


def test_kernel_build_key_covers_shared_headers(tmp_path, monkeypatch):
    """An edited shared header, like an edited source or flag, gives a new
    library path, so a stale build is never reused."""
    from langstream_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (csrc / "common.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("k") not in (first, second)
