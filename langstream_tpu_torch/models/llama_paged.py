"""Llama prefill/decode over the paged KV pool (port of
``langstream_tpu/models/llama_paged.py``).

Same math as :mod:`langstream_tpu_torch.models.llama`; only the cache
geometry changes. Decode attention runs in two segments — the paged pool
(the CUDA read kernels, or their plain version on the CPU) and the in-chunk
KV buffer — merged with the online-softmax combine. The pool is read-only
during a chunk; one :func:`write_rows` commits the chunk buffer at its end.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from langstream_tpu_torch.models.llama import (
    LlamaConfig,
    _apply_rope,
    _default_ffn,
    _qkv,
    _rms_norm,
    _rope,
    layer_params,
    prefill_forward,
)
from langstream_tpu_torch.models.paged import pool_layer, write_rows
from langstream_tpu_torch.models.quant import as_weight as _w, embedding_take
from langstream_tpu_torch.ops.paged_attention import (
    NEG_INF,
    merge_partial_attention,
    paged_attention_partial,
    paged_attention_reference,
)


def llama_prefill_paged(
    config: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,        # (B, P) int, right-padded
    lengths: torch.Tensor,       # (B,) true lengths
    pool_k,                      # (L, nb, bs, Kh*D) or int8 {"q","s"}
    pool_v,
    block_tables: torch.Tensor,  # (B, max_blocks) — rows for THIS batch
):
    """Prompt forward + paged cache fill (one scatter per K and V, in place).
    Returns ``(logits (B, V) f32, pool_k, pool_v)``."""
    c = config
    B, Pn = tokens.shape
    logits, ks, vs = prefill_forward(c, params, tokens, lengths)
    KhD = c.kv_heads * c.head_dim
    L = ks.shape[0]
    valid = (
        torch.arange(Pn, device=tokens.device)[None, :]
        < lengths.to(torch.long)[:, None]
    )
    starts = torch.zeros((B,), dtype=torch.long, device=tokens.device)
    pool_k = write_rows(pool_k, ks.reshape(L, B, Pn, KhD), block_tables, starts, valid)
    pool_v = write_rows(pool_v, vs.reshape(L, B, Pn, KhD), block_tables, starts, valid)
    return logits, pool_k, pool_v


def pack_tokens_logprobs(tokens: torch.Tensor, logprobs: torch.Tensor) -> torch.Tensor:
    """Fold a chunk's host-bound outputs into ONE int32 tensor on the
    device: tokens first, then the f32 logprobs reinterpreted as int32
    (lossless — the host views the tail back as float32). The engine's
    per-chunk device-to-host traffic is exactly this tensor's copy."""
    return torch.cat([
        tokens.to(torch.int32).reshape(-1),
        logprobs.to(torch.float32).contiguous().view(torch.int32).reshape(-1),
    ])


def _cache_partial_xla(c: LlamaConfig, q, ck_l, cv_l, block_tables, lengths,
                       num_read_blocks: int):
    """Reference paged read (the plain twin of the decode-read kernels):
    gather the window densely (``_gather_layer_window``, kept beside the
    kernels in :mod:`langstream_tpu_torch.ops.paged_attention`), compute
    partial softmax stats."""
    return paged_attention_reference(
        q, ck_l, cv_l, block_tables, lengths,
        num_read_blocks=num_read_blocks, kv_heads=c.kv_heads,
        head_dim=c.head_dim,
    )


def llama_decode_chunk_paged(
    config: LlamaConfig,
    params: dict,
    tokens0: torch.Tensor,        # (B,)
    base_lengths: torch.Tensor,   # (B,) int32 — rows in the pool per slot
    active: torch.Tensor,         # (B,) bool
    pool_k,                       # (L, nb, bs, KhD) — read-only in the chunk
    pool_v,
    block_tables: torch.Tensor,   # (B, max_blocks) int32
    sample_fn: Callable,          # (logits) or (logits, counts) -> (tokens, logprobs)
    num_steps: int,
    num_read_blocks: int,         # block columns covering the longest slot
    sample_extras=None,           # (presences, frequencies, counts0 (B, V))
    return_packed: bool = False,
):
    """K fused decode steps against the paged pool: the pool is read-only,
    each step's new K/V lands in a chunk buffer ``(L, B, K, Kh, D)``, and
    one scatter commits the buffer at the end.

    Returns ``(chunk_tokens (K,B), chunk_logprobs (K,B), final_tokens,
    final_lengths, pool_k, pool_v)``, or with ``return_packed``
    ``(packed, final_tokens, final_lengths, pool_k, pool_v)``."""
    c = config
    B = tokens0.shape[0]
    device = tokens0.device
    KhD = c.kv_heads * c.head_dim
    G = c.heads // c.kv_heads
    adv = active.to(torch.int32)
    kbuf = torch.zeros((c.layers, B, num_steps, c.kv_heads, c.head_dim),
                       dtype=c.dtype, device=device)
    vbuf = torch.zeros_like(kbuf)
    pen = sample_extras is not None
    counts = sample_extras[2].clone() if pen else None
    rows = torch.arange(B, device=device)
    tokens = tokens0
    out_tokens, out_lps = [], []
    for step in range(num_steps):
        x = embedding_take(params["embed"], tokens)
        positions = base_lengths + step * adv
        cos, sin = _rope(positions, c.head_dim, c.rope_theta)
        for layer in range(c.layers):
            lp = layer_params(params, layer)
            h = _rms_norm(x, lp["attn_norm"], c.norm_eps)
            q, k, v = _qkv(c, h, lp)
            q = _apply_rope(q, cos, sin)
            k = _apply_rope(k, cos, sin)
            kbuf[layer, :, step] = k
            vbuf[layer, :, step] = v
            # segment 1: paged pool (partial stats)
            acc_c, m_c, l_c = paged_attention_partial(
                q, pool_layer(pool_k, layer), pool_layer(pool_v, layer),
                block_tables, base_lengths,
                num_read_blocks=num_read_blocks, kv_heads=c.kv_heads,
                head_dim=c.head_dim,
            )
            # segment 2: in-chunk buffer rows 0..step (partial stats, tiny)
            qg = q.reshape(B, c.kv_heads, G, c.head_dim)
            kb = kbuf[layer, :, : step + 1]
            vb = vbuf[layer, :, : step + 1]
            s_buf = torch.einsum("bkgd,btkd->bkgt", qg, kb).to(torch.float32)
            s_buf = s_buf / math.sqrt(c.head_dim)
            m_b = s_buf.amax(dim=-1)
            shift = torch.where(m_b <= NEG_INF, torch.zeros_like(m_b), m_b)
            p_b = torch.exp(s_buf - shift[..., None])
            l_b = p_b.sum(dim=-1)
            acc_b = torch.einsum(
                "bkgt,btkd->bkgd", p_b.to(vb.dtype), vb
            ).to(torch.float32)
            out = merge_partial_attention([
                (acc_c, m_c, l_c),
                (
                    acc_b.reshape(B, c.heads, c.head_dim),
                    m_b.reshape(B, c.heads),
                    l_b.reshape(B, c.heads),
                ),
            ]).to(x.dtype)
            x = x + out.reshape(B, c.heads * c.head_dim) @ _w(lp["wo"])
            h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
            x = x + _default_ffn(h2, lp)
        x = _rms_norm(x, params["final_norm"], c.norm_eps)
        logits = (x @ _w(params["lm_head"])).to(torch.float32)
        nxt, lp_ = sample_fn(logits, counts) if pen else sample_fn(logits)
        nxt = torch.where(active, nxt.to(tokens.dtype), tokens)
        if pen:
            counts.index_put_((rows, nxt.to(torch.long)), adv.to(counts.dtype),
                              accumulate=True)
        tokens = nxt
        out_tokens.append(nxt)
        out_lps.append(lp_)

    L = c.layers
    valid = active[:, None].expand(B, num_steps)
    pool_k = write_rows(pool_k, kbuf.reshape(L, B, num_steps, KhD),
                        block_tables, base_lengths, valid)
    pool_v = write_rows(pool_v, vbuf.reshape(L, B, num_steps, KhD),
                        block_tables, base_lengths, valid)
    final_lengths = base_lengths + num_steps * adv
    chunk_tokens = torch.stack(out_tokens)
    chunk_lps = torch.stack(out_lps)
    if return_packed:
        packed = pack_tokens_logprobs(chunk_tokens, chunk_lps)
        return packed, tokens, final_lengths, pool_k, pool_v
    return chunk_tokens, chunk_lps, tokens, final_lengths, pool_k, pool_v


def dense_block_size(max_seq_len: int, block_size: int = 128) -> int:
    """Identity-table block size for a dense cache: 128 rows where the
    sequence axis divides into them, else the largest divisor of it in
    ``gcd(max_seq_len, 128)``."""
    return block_size if max_seq_len % block_size == 0 else math.gcd(
        max_seq_len, block_size
    )


def llama_decode_chunk_dense_pallas(
    config: LlamaConfig,
    params: dict,
    tokens0: torch.Tensor,
    base_lengths: torch.Tensor,
    active: torch.Tensor,
    cache_k: torch.Tensor,        # (L, B, S, Kh, D) — the DENSE layout
    cache_v: torch.Tensor,
    sample_fn: Callable,
    num_steps: int,
    window: int | None,           # cache rows the read may cover (None = S)
    block_size: int = 128,
    sample_extras=None,
    return_packed: bool = False,
):
    """Dense-cache decode through the paged read kernels: a dense cache is a
    degenerate block pool — slot ``b``'s rows are the contiguous blocks
    ``[b*S/bs, (b+1)*S/bs)`` — so the cache viewed as
    ``(L, B*S/bs, bs, Kh*D)`` with identity block tables goes through the
    same kernel (and the commit writes through the view, in place)."""
    c = config
    L, B, S, Kh, D = cache_k.shape
    bs = dense_block_size(S, block_size)
    nb = S // bs
    pool_k = cache_k.view(L, B * nb, bs, Kh * D)
    pool_v = cache_v.view(L, B * nb, bs, Kh * D)
    device = cache_k.device
    tables = (
        torch.arange(B, dtype=torch.int32, device=device)[:, None] * nb
        + torch.arange(nb, dtype=torch.int32, device=device)[None, :]
    )
    rows = window if window is not None else S
    num_read_blocks = max(1, min(-(-rows // bs), nb))
    out = llama_decode_chunk_paged(
        c, params, tokens0, base_lengths, active, pool_k, pool_v, tables,
        sample_fn, num_steps, num_read_blocks=num_read_blocks,
        sample_extras=sample_extras, return_packed=return_packed,
    )
    return out[:-2] + (cache_k, cache_v)
