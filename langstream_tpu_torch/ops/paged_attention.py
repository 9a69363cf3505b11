"""Paged-attention reads (port of ``langstream_tpu/ops/paged_attention.py``).

A read goes straight through each slot's block table into the shared pool
and returns *partial* results ``(acc, m, l)`` — unnormalised accumulator,
running max, running sum-exp — because its caller attends over more than
one segment; the caller merges them with :func:`merge_partial_attention`.

- :func:`paged_attention_partial`: one decode query per slot over its
  cache rows (the other segment is the in-chunk buffer). For tensors on
  the card it launches the kernels of ``csrc/paged_attention.cu`` — for a
  plain bf16/f32 pool the split read (each CTA one span of
  :data:`SPLIT_ROWS` rows, then a combine of the spans; see
  :func:`paged_attention_split_reference`), for an ``{"q","s"}`` int8 pool
  the int8 kernel; for tensors on the CPU it takes
  :func:`paged_attention_reference` (the JAX package's
  ``_cache_partial_xla``).
- :func:`paged_attention_multiquery_partial`: T suffix queries per slot
  over the slot's history rows (the continuation prefill; the other
  segment is the suffix itself). The kernel of
  ``csrc/paged_attention_mq.cu`` on the card,
  :func:`paged_attention_multiquery_reference` on the CPU; bf16/f32 pools
  only, as in the JAX package.

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
from langstream_tpu_torch.ops._build import load_library

NEG_INF = float(torch.finfo(torch.float32).min)
#: 128 and 64 are the served models' widths; 16 is the tiny test model's
HEAD_DIMS = (16, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the int8 kernel keeps G*D accumulators over 128 threads, at most 8 each
_MAX_GROUP_WIDTH = 1024
#: the split read gives each of its 4 warps at most 2 query heads
_MAX_GROUP = 8
#: cache rows one CTA of the bf16/f32 decode read walks (SPLIT_ROWS of the
#: CUDA source; the entry point refuses any other value)
SPLIT_ROWS = 256
#: query rows per CTA of the multi-query kernel: (64 / G) positions x G heads
_MQ_ROWS = 64


def _lib_mq() -> ctypes.CDLL:
    lib = load_library("paged_attention_mq")
    fn = lib.paged_attention_mq_partial_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
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
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
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
    """The combine kernel's algebra: merge the span partials
    ``acc (B,n,H,D), m (B,n,H), l (B,n,H)`` of each slot over its
    ``ceil(min(length, window) / split_rows)`` live spans only (the kernel
    never writes the others), with the NEG_INF guards of
    :func:`merge_partial_attention`; no live span gives m = NEG_INF, l = 0,
    acc = 0."""
    n = m.shape[1]
    rows = lengths.to(torch.long).clamp(0, window)
    live = (torch.arange(n, device=m.device)[None, :]
            < (-(-rows // split_rows))[:, None])[..., None]           # (B, n, 1)
    m_live = torch.where(live, m, torch.full_like(m, NEG_INF))
    M = m_live.amax(dim=1)                                            # (B, H)
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
    if H % kv_heads or (H // kv_heads) * D > _MAX_GROUP_WIDTH:
        raise ValueError(
            f"paged_attention: {H} heads on {kv_heads} kv heads with head_dim "
            f"{D} (group width G*D must be <= {_MAX_GROUP_WIDTH})"
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
    if H // kv_heads > _MAX_GROUP:
        raise ValueError(
            f"paged_attention: {H // kv_heads} query heads per kv head; the "
            f"split read takes at most {_MAX_GROUP}"
        )
    dev = q.device
    acc = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    if B == 0:
        return acc, m, l
    bs = k_pool.shape[1]
    n_split = paged_read_splits(num_read_blocks, bs)
    if n_split > 1:  # span partials, merged by the combine launch
        parts = (torch.empty((B, n_split, H, D), dtype=torch.float32, device=dev),
                 torch.empty((B, n_split, H), dtype=torch.float32, device=dev),
                 torch.empty((B, n_split, H), dtype=torch.float32, device=dev))
    else:  # one span writes the outputs itself
        parts = (acc, m, l)
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
    """int8-pool twin of :func:`paged_attention_partial` (fused dequant in
    the kernel: k scale on the score, v scale folded into p)."""
    if not q.is_cuda:
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, lengths,
            num_read_blocks=num_read_blocks, kv_heads=kv_heads,
            head_dim=head_dim, scale=scale,
        )
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
    B, H, D = q.shape
    acc = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B == 0:
        return acc, m, l
    rc = _lib().paged_attention_partial_q8_fwd(
        q.data_ptr(), k_pool["q"].data_ptr(), k_pool["s"].data_ptr(),
        v_pool["q"].data_ptr(), v_pool["s"].data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, H, kv_heads, D, k_pool["q"].shape[1], block_tables.shape[1],
        num_read_blocks, _DTYPE_CODES[q.dtype],
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


def paged_attention_multiquery_reference(
    q, k_pool, v_pool, block_tables, starts, *,
    num_read_blocks: int, kv_heads: int, head_dim: int,
    scale: float | None = None,
):
    """Plain version of the multi-query kernel: gather the window densely
    and compute the partials in f32, as the kernel does (scores scaled by
    ``scale``, masked at ``col >= starts[b]`` for every query row, the
    NEG_INF guards of the decode read)."""
    B, T, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kw = _gather_layer_window(k_pool, block_tables, num_read_blocks, kv_heads, head_dim)
    vw = _gather_layer_window(v_pool, block_tables, num_read_blocks, kv_heads, head_dim)
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
    must be a multiple of it. Here T may be anything: the kernel's own
    query tile is ``64 / G`` positions (16 at Llama-3-8B) and it masks the
    ragged edge itself, so ``t_block`` is only checked to be positive.
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
    acc = torch.empty((B, T, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return acc, m, l
    rc = _lib_mq().paged_attention_mq_partial_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), starts.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, T, H, kv_heads, D, k_pool.shape[1], block_tables.shape[1],
        num_read_blocks, _DTYPE_CODES[q.dtype],
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
