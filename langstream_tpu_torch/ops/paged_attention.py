"""Paged-attention reads (port of ``langstream_tpu/ops/paged_attention.py``).

A read goes straight through each slot's block table into the shared pool
and returns *partial* results ``(acc, m, l)`` — unnormalised accumulator,
running max, running sum-exp — because its caller attends over more than
one segment; the caller merges them with :func:`merge_partial_attention`.

- :func:`paged_attention_partial`: one decode query per slot over its
  cache rows (the other segment is the in-chunk buffer). For tensors on
  the card it launches the kernels of ``csrc/paged_attention.cu``: the
  split read (each CTA one span of :data:`SPLIT_ROWS` rows, then a combine
  of the spans; see :func:`paged_attention_split_reference`), in the
  pool's own type for a bf16/f32 pool and widening each int8 element once
  for an ``{"q","s"}`` int8 pool (``mma.sync`` products for bf16 queries,
  f32 FMAs for f32 ones); for tensors on the CPU it takes
  :func:`paged_attention_reference` (the JAX package's
  ``_cache_partial_xla``).
- :func:`paged_attention_multiquery_partial`: T suffix queries per slot
  over the slot's history rows (the continuation prefill; the other
  segment is the suffix itself). The kernels of
  ``csrc/paged_attention_mq.cu`` on the card (:func:`multiquery_kernel_route`:
  the tensor cores for bf16 at head_dim 64/128, the history split across
  CTAs when the grid is small, :func:`multiquery_read_splits`; f32 FMA tiles
  otherwise), :func:`paged_attention_multiquery_reference` on the CPU;
  bf16/f32 pools only, as in the JAX package.

Shapes (one layer):
  q             (B, H, D), or (B, T, H, D) for the multi-query read
  k_pool/v_pool (nb, bs, Kh*D), or {"q": int8 (nb, bs, Kh*D), "s": f32 (nb, bs, Kh)}
  block_tables  (B, max_blocks) int32
  lengths       (B,) int32 — cache rows to attend per slot (``starts`` for
                the multi-query read)
  → acc (B, [T,] H, D) f32, m (B, [T,] H) f32, l (B, [T,] H) f32
"""

from __future__ import annotations

import ctypes
import math

import torch

from langstream_tpu_torch.models.kvquant import cache_scores, cache_values
from langstream_tpu_torch.models.paged import gather_kv
from langstream_tpu_torch.ops import refuse_grad
from langstream_tpu_torch.ops._build import load_library

NEG_INF = float(torch.finfo(torch.float32).min)
#: 128 and 64 are the served models' widths; 16 is the tiny test model's
HEAD_DIMS = (16, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: query heads per KV head the decode reads take (the bf16/f32 read gives
#: each of its 4 warps at most 2 heads, the int8 read keeps at most 8)
_MAX_GROUP = 8
#: cache rows one CTA of the decode reads walks (SPLIT_ROWS of the CUDA
#: source; the entry points refuse any other value)
SPLIT_ROWS = 256
#: query rows per warpgroup (wgmma kernel) or CTA (FMA kernel) of the
#: multi-query read: (64 / G) positions x G heads
_MQ_ROWS = 64
#: warpgroups per CTA of the multi-query wgmma kernel (1 or 3): one for a
#: suffix of at most _MQ_SMALL_ROWS query rows (decode- and hit-sized: more,
#: smaller CTAs), else _MQ_WARPGROUPS (a chunk: each K/V tile serves 192 rows)
_MQ_WARPGROUPS = 3
_MQ_SMALL_ROWS = 4 * _MQ_ROWS
#: history rows per K/V tile of the multi-query wgmma kernel (BN of the source)
_MQ_TILE = 64
#: streaming multiprocessors of the H100 SXM the split rule fills
_SMS = 132


def _lib_mq() -> ctypes.CDLL:
    lib = load_library("paged_attention_mq")
    fn = lib.paged_attention_mq_partial_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 13
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    lib = load_library("paged_attention")
    fn, fn8 = lib.paged_attention_partial_fwd, lib.paged_attention_partial_q8_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        fn8.argtypes = (
            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn8.restype = ctypes.c_int
    return lib


def merge_partial_attention(parts):
    """Combine per-segment ``(acc, m, l)`` partials into normalised attention
    output: the associative online-softmax merge."""
    acc, m, l = parts[0]
    for acc2, m2, l2 in parts[1:]:
        m_new = torch.maximum(m, m2)
        shift = torch.where(m_new <= NEG_INF, torch.zeros_like(m_new), m_new)
        a1 = torch.exp(torch.where(m <= NEG_INF, torch.full_like(m, NEG_INF), m - shift))
        a2 = torch.exp(torch.where(m2 <= NEG_INF, torch.full_like(m2, NEG_INF), m2 - shift))
        acc = acc * a1[..., None] + acc2 * a2[..., None]
        l = l * a1 + l2 * a2
        m = m_new
    inv = torch.where(
        l > 0.0, 1.0 / torch.clamp(l, min=1e-30), torch.zeros_like(l)
    )
    return acc * inv[..., None]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _gather_layer_window(pool_l, block_tables, num_read_blocks, kv_heads, head_dim):
    """Densify one layer's window: (B, W, Kh, D), or the int8
    {"q": (B,W,Kh,D), "s": (B,W,Kh)} pair ready for the kvquant helpers."""
    if isinstance(pool_l, dict):
        w = gather_kv({n: a[None] for n, a in pool_l.items()}, block_tables,
                      num_read_blocks)
        B, W = w["s"].shape[1:3]
        return {
            "q": w["q"][0].reshape(B, W, kv_heads, head_dim),
            "s": w["s"][0],
        }
    w = gather_kv(pool_l[None], block_tables, num_read_blocks)[0]
    B, W = w.shape[:2]
    return w.reshape(B, W, kv_heads, head_dim)


def _window_partials(q, kw, vw, lengths, *, kv_heads, head_dim, scale):
    """Partial softmax stats of one query per slot over a dense window
    ``kw``/``vw`` (B, W, Kh, D) (or int8 ``{"q","s"}``), rows ``< lengths``."""
    B, H, D = q.shape
    W = (kw["s"] if isinstance(kw, dict) else kw).shape[1]
    G = H // kv_heads
    qg = q.reshape(B, kv_heads, G, head_dim)
    s = cache_scores(qg, kw)
    s = s / math.sqrt(head_dim) if scale is None else s * scale
    mask = (
        torch.arange(W, device=q.device)[None, :] < lengths.to(torch.long)[:, None]
    )[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                        # (B, Kh, G)
    shift = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - shift[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = cache_values(p.to(q.dtype), vw).to(torch.float32)
    return acc.reshape(B, H, D), m.reshape(B, H), l.reshape(B, H)


def paged_attention_reference(
    q, k_pool, v_pool, block_tables, lengths, *,
    num_read_blocks: int, kv_heads: int, head_dim: int,
    scale: float | None = None,
):
    """Plain version of both kernels: gather the window densely, compute
    partial softmax stats (``_cache_partial_xla`` of the JAX package). int8
    pools read through the fused kvquant helpers (scales onto scores and
    probabilities)."""
    kw = _gather_layer_window(k_pool, block_tables, num_read_blocks, kv_heads, head_dim)
    vw = _gather_layer_window(v_pool, block_tables, num_read_blocks, kv_heads, head_dim)
    return _window_partials(q, kw, vw, lengths, kv_heads=kv_heads,
                            head_dim=head_dim, scale=scale)


def paged_read_splits(num_read_blocks: int, block_size: int,
                      split_rows: int = SPLIT_ROWS) -> int:
    """Spans of ``split_rows`` cache rows the split read launches per slot
    and KV head: from the host's ints, so no device value is read."""
    return max(1, -(-num_read_blocks * block_size // split_rows))


def combine_split_partials(acc, m, l, lengths, *, window: int,
                           split_rows: int = SPLIT_ROWS):
    """The combine kernels' algebra: merge the span partials
    ``acc (B,n,...,H,D), m (B,n,...,H), l (B,n,...,H)`` of each slot over
    its ``ceil(min(length, window) / split_rows)`` live spans only (the
    kernel never writes the others), with the NEG_INF guards of
    :func:`merge_partial_attention`; no live span gives m = NEG_INF, l = 0,
    acc = 0. The trailing axes are the decode read's ``H`` or the
    multi-query read's ``T, H``."""
    n = m.shape[1]
    rows = lengths.to(torch.long).clamp(0, window)
    live = (torch.arange(n, device=m.device)[None, :]
            < (-(-rows // split_rows))[:, None])                       # (B, n)
    live = live.reshape(live.shape + (1,) * (m.dim() - 2))            # (B, n, 1, ...)
    m_live = torch.where(live, m, torch.full_like(m, NEG_INF))
    M = m_live.amax(dim=1)                                            # (B, ..., H)
    shift = torch.where(M <= NEG_INF, torch.zeros_like(M), M)
    w = torch.where(live & (m > NEG_INF), torch.exp(m_live - shift[:, None]),
                    torch.zeros_like(m))
    L = (torch.where(live, l, torch.zeros_like(l)) * w).sum(dim=1)
    A = (torch.where(live[..., None], acc, torch.zeros_like(acc)) * w[..., None]).sum(dim=1)
    return A, M, L


def paged_attention_split_reference(
    q, k_pool, v_pool, block_tables, lengths, *,
    num_read_blocks: int, kv_heads: int, head_dim: int,
    scale: float | None = None, split_rows: int = SPLIT_ROWS,
):
    """Plain version of the split read, span by span: the partials of each
    ``split_rows`` rows of the window as :func:`paged_attention_reference`
    computes them, merged by :func:`combine_split_partials`. Equal to the
    unsplit read up to rounding."""
    kw = _gather_layer_window(k_pool, block_tables, num_read_blocks, kv_heads, head_dim)
    vw = _gather_layer_window(v_pool, block_tables, num_read_blocks, kv_heads, head_dim)
    window = (kw["s"] if isinstance(kw, dict) else kw).shape[1]

    def rows(w, lo):
        if isinstance(w, dict):
            return {n: a[:, lo:lo + split_rows] for n, a in w.items()}
        return w[:, lo:lo + split_rows]

    parts = []
    for i in range(paged_read_splits(num_read_blocks, window // num_read_blocks,
                                     split_rows)):
        lo = i * split_rows
        span_len = (lengths.to(torch.long) - lo).clamp(0, split_rows)
        parts.append(_window_partials(q, rows(kw, lo), rows(vw, lo), span_len,
                                      kv_heads=kv_heads, head_dim=head_dim,
                                      scale=scale))
    acc, m, l = (torch.stack(t, dim=1) for t in zip(*parts))
    return combine_split_partials(acc, m, l, lengths, window=window,
                                  split_rows=split_rows)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _partial_outputs(B, H, D, dev, lead=()):
    """Empty f32 ``acc (B, *lead, H, D), m, l (B, *lead, H)``."""
    return (torch.empty((B, *lead, H, D), dtype=torch.float32, device=dev),
            torch.empty((B, *lead, H), dtype=torch.float32, device=dev),
            torch.empty((B, *lead, H), dtype=torch.float32, device=dev))


def _split_scratch(n_split, shape, dev, outputs):
    """Span partials ``(B, n_split, ..., H[, D])`` the combine launch merges;
    with one span the kernel writes ``outputs`` itself."""
    if n_split == 1:
        return outputs
    B, *rest = shape
    return _partial_outputs(B, rest[-2], rest[-1], dev, (n_split, *rest[:-2]))


def _check_common(q, tables, lengths, pool, kv_heads, head_dim, num_read_blocks):
    dev = q.device
    if q.dim() != 3 or not q.is_contiguous() or q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"paged_attention: q must be a contiguous (B,H,D) float32/bfloat16 "
            f"tensor, got {tuple(q.shape)} {q.dtype}"
        )
    B, H, D = q.shape
    if D != head_dim or D not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {D} (want one of {HEAD_DIMS})")
    if H % kv_heads or H // kv_heads > _MAX_GROUP:
        raise ValueError(
            f"paged_attention: {H} heads on {kv_heads} kv heads (the reads take "
            f"at most {_MAX_GROUP} query heads per kv head)"
        )
    for name, t in (("block_tables", tables), ("lengths", lengths)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous int32 on {dev}")
    if tables.dim() != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(
            f"paged_attention: tables {tuple(tables.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match batch {B}"
        )
    if not 0 < num_read_blocks <= tables.shape[1]:
        raise ValueError(
            f"paged_attention: num_read_blocks {num_read_blocks} outside "
            f"(0, {tables.shape[1]}]"
        )
    _check_pool(pool, dev, kv_heads, head_dim)


def _check_pool(pool, dev, kv_heads, head_dim):
    if (pool.device != dev or pool.dim() != 3 or not pool.is_contiguous()
            or pool.shape[2] != kv_heads * head_dim or pool.data_ptr() % 16):
        raise ValueError(
            f"paged_attention: pool must be a contiguous, 16-byte aligned "
            f"(nb, bs, {kv_heads * head_dim}) tensor on {dev}, got "
            f"{tuple(pool.shape)}"
        )


def paged_attention_partial(
    q: torch.Tensor,             # (B, H, D)
    k_pool,                      # (nb, bs, Kh*D), or int8 {"q","s"} pool
    v_pool,
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    lengths: torch.Tensor,       # (B,) int32
    *,
    num_read_blocks: int,        # table columns the read may cover
    kv_heads: int,
    head_dim: int,
    scale: float | None = None,
):
    """Partial (unnormalised) paged attention over the cache segment:
    ``(acc (B,H,D) f32, m (B,H) f32, l (B,H) f32)``. The kernels read only
    the rows each slot holds, never more than ``num_read_blocks`` blocks.
    For a bf16/f32 pool one call is two launches (the spans, then their
    combine; one launch when the window is one span)."""
    if isinstance(k_pool, dict):
        return _paged_attention_partial_q8(
            q, k_pool, v_pool, block_tables, lengths,
            num_read_blocks=num_read_blocks, kv_heads=kv_heads,
            head_dim=head_dim, scale=scale,
        )
    if not q.is_cuda:
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, lengths,
            num_read_blocks=num_read_blocks, kv_heads=kv_heads,
            head_dim=head_dim, scale=scale,
        )
    refuse_grad("paged_attention", q, k_pool, v_pool)
    for pool in (k_pool, v_pool):
        _check_common(q, block_tables, lengths, pool, kv_heads, head_dim,
                      num_read_blocks)
        if pool.dtype != q.dtype:
            raise ValueError(
                f"paged_attention: pool dtype {pool.dtype} != q dtype {q.dtype}"
            )
    if k_pool.shape != v_pool.shape:
        raise ValueError("paged_attention: k and v pools differ in shape")
    B, H, D = q.shape
    acc, m, l = _partial_outputs(B, H, D, q.device)
    if B == 0:
        return acc, m, l
    bs = k_pool.shape[1]
    n_split = paged_read_splits(num_read_blocks, bs)
    parts = _split_scratch(n_split, (B, H, D), q.device, (acc, m, l))
    rc = _lib().paged_attention_partial_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        *(t.data_ptr() for t in parts),
        B, H, kv_heads, D, bs, block_tables.shape[1],
        num_read_blocks, n_split, SPLIT_ROWS, _DTYPE_CODES[q.dtype],
        1.0 / math.sqrt(D) if scale is None else scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (CUDA error {rc})")
    paged_attention_partial.launches += 1
    return acc, m, l


def _paged_attention_partial_q8(
    q, k_pool: dict, v_pool: dict, block_tables, lengths, *,
    num_read_blocks: int, kv_heads: int, head_dim: int,
    scale: float | None = None,
):
    """int8-pool twin of :func:`paged_attention_partial`: the int8 split
    read (fused dequant: k scale on the score, v scale folded into p; bf16
    queries through ``mma.sync``, f32 ones through FMAs), then the same
    combine launch when the window holds more than one span."""
    if not q.is_cuda:
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, lengths,
            num_read_blocks=num_read_blocks, kv_heads=kv_heads,
            head_dim=head_dim, scale=scale,
        )
    refuse_grad("paged_attention_q8", q, k_pool, v_pool)
    for pool in (k_pool, v_pool):
        _check_common(q, block_tables, lengths, pool["q"], kv_heads, head_dim,
                      num_read_blocks)
        s = pool["s"]
        if (pool["q"].dtype != torch.int8 or s.dtype != torch.float32
                or s.device != q.device or not s.is_contiguous()
                or s.shape != pool["q"].shape[:2] + (kv_heads,)):
            raise ValueError(
                "paged_attention_q8: pool must be {'q': int8 (nb,bs,Kh*D), "
                "'s': contiguous float32 (nb,bs,Kh)} on q's device"
            )
    if k_pool["q"].shape != v_pool["q"].shape:
        raise ValueError("paged_attention_q8: k and v pools differ in shape")
    B, H, D = q.shape
    acc, m, l = _partial_outputs(B, H, D, q.device)
    if B == 0:
        return acc, m, l
    bs = k_pool["q"].shape[1]
    n_split = paged_read_splits(num_read_blocks, bs)
    parts = _split_scratch(n_split, (B, H, D), q.device, (acc, m, l))
    rc = _lib().paged_attention_partial_q8_fwd(
        q.data_ptr(), k_pool["q"].data_ptr(), k_pool["s"].data_ptr(),
        v_pool["q"].data_ptr(), v_pool["s"].data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        *(t.data_ptr() for t in parts),
        B, H, kv_heads, D, bs, block_tables.shape[1],
        num_read_blocks, n_split, SPLIT_ROWS, _DTYPE_CODES[q.dtype],
        1.0 / math.sqrt(D) if scale is None else scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention_q8 kernel launch failed (CUDA error {rc})")
    _paged_attention_partial_q8.launches += 1
    return acc, m, l


# ---------------------------------------------------------------------------
# multi-query history read (continuation prefill)
# ---------------------------------------------------------------------------


def multiquery_kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel the multi-query read launches on the card: ``"wgmma"``
    (tensor cores) for bf16 at head_dim 64/128, ``"fma"`` (f32 FMA tiles)
    for float32, where TF32 would miss the 1e-4 tolerance, and for the tiny
    head_dim 16."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in (64, 128) else "fma"


def _multiquery_plan(batch: int, t: int, group: int, kv_heads: int,
                     num_read_blocks: int, block_size: int) -> tuple[int, int, int]:
    """``(warpgroups, n_split, span_rows)`` of the wgmma multi-query read:
    one span of the whole window unless the grid is under one CTA per SM
    and each (slot, KV head) has at most four query tiles (decode- and
    hit-sized suffixes), then enough spans of whole 64-row tiles for about
    two CTAs per SM."""
    rows = t * group
    wg = 1 if rows <= _MQ_SMALL_ROWS else _MQ_WARPGROUPS
    window = num_read_blocks * block_size
    tiles = max(1, -(-window // _MQ_TILE))
    q_tiles = -(-rows // (_MQ_ROWS * wg))
    ctas = batch * kv_heads * q_tiles
    n = 1
    if ctas < _SMS and q_tiles <= 4:
        n = min(-(-2 * _SMS // max(ctas, 1)), tiles)
    span = -(-tiles // n) * _MQ_TILE
    return wg, max(1, -(-window // span)), span


def multiquery_read_splits(batch: int, t: int, group: int, kv_heads: int,
                           num_read_blocks: int, block_size: int) -> int:
    """Spans the wgmma multi-query read splits each slot's history into:
    from the host's ints, so no device value is read. 1 whenever the
    unsplit grid fills the card's 132 SMs, for a suffix of more than four
    query tiles (a 512-token chunk) and when the window is one 64-row
    tile."""
    return _multiquery_plan(batch, t, group, kv_heads, num_read_blocks, block_size)[1]


def _multiquery_window_partials(q, kw, vw, starts, *, kv_heads, head_dim, scale):
    """Partials of T queries per slot over a dense window ``kw``/``vw``
    (B, W, Kh, D), rows ``< starts`` for every query, in f32."""
    B, T, H, D = q.shape
    W = kw.shape[1]
    G = H // kv_heads
    qg = q.reshape(B, T, kv_heads, G, head_dim).to(torch.float32)
    s = torch.einsum("btkgd,bwkd->bkgtw", qg, kw.to(torch.float32)) * scale
    mask = (
        torch.arange(W, device=q.device)[None, :] < starts.to(torch.long)[:, None]
    )[:, None, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                        # (B, Kh, G, T)
    shift = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    p = torch.exp(s - shift[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgtw,bwkd->bkgtd", p, vw.to(torch.float32))
    return (
        acc.permute(0, 3, 1, 2, 4).reshape(B, T, H, D),
        m.permute(0, 3, 1, 2).reshape(B, T, H),
        l.permute(0, 3, 1, 2).reshape(B, T, H),
    )


def paged_attention_multiquery_reference(
    q, k_pool, v_pool, block_tables, starts, *,
    num_read_blocks: int, kv_heads: int, head_dim: int,
    scale: float | None = None,
):
    """Plain version of the multi-query kernels: gather the window densely
    and compute the partials in f32 (scores scaled by ``scale``, masked at
    ``col >= starts[b]`` for every query row, the NEG_INF guards of the
    decode read)."""
    kw = _gather_layer_window(k_pool, block_tables, num_read_blocks, kv_heads, head_dim)
    vw = _gather_layer_window(v_pool, block_tables, num_read_blocks, kv_heads, head_dim)
    return _multiquery_window_partials(
        q, kw, vw, starts, kv_heads=kv_heads, head_dim=head_dim,
        scale=1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)


def paged_attention_multiquery_split_reference(
    q, k_pool, v_pool, block_tables, starts, *,
    num_read_blocks: int, kv_heads: int, head_dim: int,
    scale: float | None = None, span_rows: int | None = None,
):
    """Plain version of the split multi-query read, span by span: the
    partials of each ``span_rows`` rows of the window as
    :func:`paged_attention_multiquery_reference` computes them, merged by
    :func:`combine_split_partials`. ``span_rows=None`` takes the wgmma
    kernel's own spans for these shapes. Equal to the unsplit read up to
    rounding."""
    B, T, H, D = q.shape
    if span_rows is None:
        _, _, span_rows = _multiquery_plan(B, T, H // kv_heads, kv_heads,
                                           num_read_blocks, k_pool.shape[1])
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kw = _gather_layer_window(k_pool, block_tables, num_read_blocks, kv_heads, head_dim)
    vw = _gather_layer_window(v_pool, block_tables, num_read_blocks, kv_heads, head_dim)
    window = kw.shape[1]
    parts = []
    for lo in range(0, window, span_rows):
        span_len = (starts.to(torch.long) - lo).clamp(0, span_rows)
        parts.append(_multiquery_window_partials(
            q, kw[:, lo:lo + span_rows], vw[:, lo:lo + span_rows], span_len,
            kv_heads=kv_heads, head_dim=head_dim, scale=scale))
    acc, m, l = (torch.stack(t, dim=1) for t in zip(*parts))
    return combine_split_partials(acc, m, l, starts, window=window,
                                  split_rows=span_rows)


def paged_attention_multiquery_partial(
    q: torch.Tensor,             # (B, T, H, D) — T suffix queries per slot
    k_pool,                      # (nb, bs, Kh*D) bf16/f32
    v_pool,
    block_tables: torch.Tensor,  # (B, max_blocks) int32
    starts: torch.Tensor,        # (B,) int32 — history rows per slot
    *,
    num_read_blocks: int,        # table columns covering max(starts)
    kv_heads: int,
    head_dim: int,
    t_block: int = 16,
    scale: float | None = None,
):
    """Multi-query twin of :func:`paged_attention_partial`: the T suffix
    queries of each slot attend the slot's paged HISTORY (rows
    ``< starts[b]``), a mask that is the same for all T queries.

    Returns ``(acc (B,T,H,D) f32, m (B,T,H) f32, l (B,T,H) f32)``; a slot
    with ``starts == 0`` gives ``m = NEG_INF, l = 0, acc = 0``. ``t_block``
    keeps the JAX signature; in the JAX package it is the query tile and T
    must be a multiple of it. Here T may be anything: the kernels' own
    query tile is ``64 / G`` positions (16 at Llama-3-8B) per warpgroup or
    CTA and they mask the ragged edge themselves, so ``t_block`` is only
    checked to be positive. On the card one call is one launch, or two
    when the wgmma read splits the history (the spans, then their combine).
    bf16/f32 pools only: an int8 pool raises ``ValueError`` (its history
    read is the model function's blocked gather, as in the JAX package)."""
    if isinstance(k_pool, dict) or isinstance(v_pool, dict):
        raise ValueError(
            "paged_attention_multiquery_partial reads bf16/float32 pools only; "
            "an int8 pool's history goes through the blocked gather of "
            "llama_prefill_continue_paged"
        )
    if t_block <= 0:
        raise ValueError(f"paged_attention_multiquery: t_block {t_block} must be > 0")
    if not q.is_cuda:
        return paged_attention_multiquery_reference(
            q, k_pool, v_pool, block_tables, starts,
            num_read_blocks=num_read_blocks, kv_heads=kv_heads,
            head_dim=head_dim, scale=scale,
        )
    refuse_grad("paged_attention_multiquery", q, k_pool, v_pool)
    dev = q.device
    if q.dim() != 4 or not q.is_contiguous() or q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"paged_attention_multiquery: q must be a contiguous (B,T,H,D) "
            f"float32/bfloat16 tensor, got {tuple(q.shape)} {q.dtype}"
        )
    B, T, H, D = q.shape
    if D != head_dim or D not in HEAD_DIMS:
        raise ValueError(
            f"paged_attention_multiquery: head_dim {D} (want one of {HEAD_DIMS})"
        )
    if H % kv_heads or _MQ_ROWS % (H // kv_heads):
        raise ValueError(
            f"paged_attention_multiquery: {H} heads on {kv_heads} kv heads "
            f"(the group size must divide {_MQ_ROWS})"
        )
    for name, t in (("block_tables", block_tables), ("starts", starts)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"paged_attention_multiquery: {name} must be contiguous int32 on {dev}"
            )
    if block_tables.dim() != 2 or block_tables.shape[0] != B or starts.shape != (B,):
        raise ValueError(
            f"paged_attention_multiquery: tables {tuple(block_tables.shape)} / "
            f"starts {tuple(starts.shape)} do not match batch {B}"
        )
    if not 0 < num_read_blocks <= block_tables.shape[1]:
        raise ValueError(
            f"paged_attention_multiquery: num_read_blocks {num_read_blocks} "
            f"outside (0, {block_tables.shape[1]}]"
        )
    for pool in (k_pool, v_pool):
        _check_pool(pool, dev, kv_heads, head_dim)
        if pool.dtype != q.dtype:
            raise ValueError(
                f"paged_attention_multiquery: pool dtype {pool.dtype} != q dtype {q.dtype}"
            )
    if k_pool.shape != v_pool.shape:
        raise ValueError("paged_attention_multiquery: k and v pools differ in shape")
    bs = k_pool.shape[1]
    wgmma = multiquery_kernel_route(q.dtype, D) == "wgmma"
    if wgmma and max(q.numel(), k_pool.numel()) >= 2**31:
        raise ValueError(
            "paged_attention_multiquery: the tensor-core read takes q and pools "
            "under 2^31 elements (32-bit offsets)"
        )
    acc, m, l = _partial_outputs(B, H, D, dev, (T,))
    if B == 0 or T == 0:
        return acc, m, l
    warpgroups, n_split, span_rows = (
        _multiquery_plan(B, T, H // kv_heads, kv_heads, num_read_blocks, bs)
        if wgmma else (1, 1, num_read_blocks * bs)
    )
    parts = _split_scratch(n_split, (B, T, H, D), dev, (acc, m, l))
    rc = _lib_mq().paged_attention_mq_partial_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        *(t.data_ptr() for t in parts),
        B, T, H, kv_heads, D, bs, block_tables.shape[1],
        num_read_blocks, n_split, span_rows, _DTYPE_CODES[q.dtype],
        1 if wgmma else 0, warpgroups,
        1.0 / math.sqrt(D) if scale is None else scale,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"paged_attention_multiquery kernel launch failed (CUDA error {rc})"
        )
    paged_attention_multiquery_partial.launches += 1
    return acc, m, l


#: kernel launches since the count was last set to 0
paged_attention_partial.launches = 0
_paged_attention_partial_q8.launches = 0
paged_attention_multiquery_partial.launches = 0


def shard_mapped_paged_read(fn, mesh, *, kv_heads: int, batch: int):
    """The paged read kernels per rank (port of the JAX package's
    ``shard_mapped_paged_read``, shared by the decode and the continuation
    call sites): slots on ``dp``, heads on ``tp`` (the pool's fused Kh*D
    axis splits on head boundaries), an axis degrading to replicated when
    the batch does not divide ``dp`` or the KV heads ``kv_heads`` (global)
    do not divide ``tp``.

    Returns ``read(q, k_pool, v_pool, tables, lengths, **kw)``: ``q`` and the
    pools hold this rank's heads when they split (all heads otherwise),
    ``tables`` and ``lengths`` the whole batch's. It runs ``fn`` on this
    rank's rows and heads (``kv_heads`` passed as the local count) and
    returns this rank's block of each output; ``read.rows`` is the rows'
    ``(lo, hi)``, None when dp degrades (every row)."""
    dp = mesh.size("dp")
    tp = mesh.size("tp")
    split_tp = tp > 1 and kv_heads % tp == 0
    rows = mesh.dp_rows(batch)
    local_kh = kv_heads // tp if split_tp else kv_heads

    def read(q, k_pool, v_pool, tables, lengths, **kw):
        if rows is not None:
            lo, hi = rows
            q, tables, lengths = q[lo:hi], tables[lo:hi], lengths[lo:hi]
        return fn(q, k_pool, v_pool, tables, lengths, kv_heads=local_kh, **kw)

    read.rows = rows
    read.split = ("dp" if rows is not None and dp > 1 else None,
                  "tp" if split_tp else None)
    return read
