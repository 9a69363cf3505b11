"""Llama prefill/decode over the paged KV pool (port of
``langstream_tpu/models/llama_paged.py``).

Same math as :mod:`langstream_tpu_torch.models.llama`; only the cache
geometry changes. Decode attention runs in two segments — the paged pool
(the CUDA read kernels, or their plain version on the CPU) and the in-chunk
KV buffer — merged with the online-softmax combine. The pool is read-only
during a chunk; one :func:`write_rows` commits the chunk buffer at its end.
The continuation prefill (:func:`llama_prefill_continue_paged`, behind the
prefix cache and chunked prefill) attends a suffix to its paged history
and to itself, the same two-segment merge. The speculative verify step
(:func:`llama_verify_chunk_paged`, driven by :func:`llama_spec_step_paged`
with the :func:`prompt_lookup_draft` drafter) is a continuation of
``1 + drafts`` positions that returns every position's logits.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from langstream_tpu_torch.models.llama import (
    LlamaConfig,
    _apply_rope,
    _default_ffn,
    _out_proj,
    _qkv,
    _rms_norm,
    _rope,
    adapter_layer,
    layer_params,
    prefill_forward,
)
from langstream_tpu_torch.models.kvquant import cache_scores, cache_values
from langstream_tpu_torch.models.paged import pool_layer, write_rows
from langstream_tpu_torch.models.quant import as_weight as _w, embedding_take
from langstream_tpu_torch.ops.paged_attention import (
    NEG_INF,
    merge_partial_attention,
    paged_attention_multiquery_partial,
    paged_attention_partial,
    paged_attention_reference,
)
from langstream_tpu_torch.serving.sampler import speculative_accept


def llama_prefill_paged(
    config: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,        # (B, P) int, right-padded
    lengths: torch.Tensor,       # (B,) true lengths
    pool_k,                      # (L, nb, bs, Kh*D) or int8 {"q","s"}
    pool_v,
    block_tables: torch.Tensor,  # (B, max_blocks) — rows for THIS batch
    ffn=None,                    # FFN hook (MoE family), see prefill_forward
    commit_rows: torch.Tensor | None = None,  # (B,) bool — rows that commit
    adapters: dict | None = None,  # batched ragged LoRA, see adapter_layer
):
    """Prompt forward + paged cache fill (one scatter per K and V, in place).
    ``commit_rows`` leaves out rows whose K/V must not land (a padded
    batch's duplicate rows commit once). Returns ``(logits (B, V) f32,
    pool_k, pool_v)``."""
    c = config
    B, Pn = tokens.shape
    logits, ks, vs = prefill_forward(c, params, tokens, lengths, ffn=ffn,
                                     adapters=adapters)
    KhD = c.kv_heads * c.head_dim
    L = ks.shape[0]
    valid = (
        torch.arange(Pn, device=tokens.device)[None, :]
        < lengths.to(torch.long)[:, None]
    )
    if commit_rows is not None:
        valid = valid & commit_rows[:, None]
    starts = torch.zeros((B,), dtype=torch.long, device=tokens.device)
    pool_k = write_rows(pool_k, ks.reshape(L, B, Pn, KhD), block_tables, starts, valid)
    pool_v = write_rows(pool_v, vs.reshape(L, B, Pn, KhD), block_tables, starts, valid)
    return logits, pool_k, pool_v


def llama_prefill_continue_paged(
    config: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,          # (B, P2) SUFFIX tokens, right-padded
    start_lengths: torch.Tensor,   # (B,) int32 — tokens already in the pool
    suffix_lengths: torch.Tensor,  # (B,) int32 — true suffix lengths
    pool_k,                        # (L, nb, bs, Kh*D) or int8 {"q","s"}
    pool_v,
    block_tables: torch.Tensor,    # (B, max_blocks) int32
    num_read_blocks: int,          # block columns covering max(start)
    return_all_logits: bool = False,
    ffn=None,                      # FFN hook (MoE family), gets pos_valid
    commit_rows: torch.Tensor | None = None,  # (B,) bool — rows that commit
    adapters: dict | None = None,  # batched ragged LoRA, see adapter_layer
):
    """Prefill CONTINUATION: process a prompt suffix whose prefix K/V is
    already in the paged pool (positions ``[0, start)`` per slot) — the
    prefix cache's suffix prefill and every chunk of a chunked prefill.

    Attention per suffix query merges two segments with the online-softmax
    combine:

    - **history**, the pool rows ``< start``. A bf16/f32 pool goes through
      :func:`paged_attention_multiquery_partial` (its CUDA kernel on the
      card). An int8 pool goes through a blocked gather of about 128 rows
      of table columns per step with the kvquant helpers: the JAX package
      has no int8 twin of the multi-query kernel and takes this route for
      int8 pools itself, so the branch follows the pool's type.
    - **suffix**, causal among the suffix, online over key blocks of
      ``gcd(P2, 128)`` rows and masked at ``k_pos < suffix_len``.

    A row with ``start == 0`` (the first chunk of a chunked prefill) gets
    m = NEG_INF, l = 0 from the history and merges to suffix-only
    attention. Each layer's suffix K/V is committed at ``start`` (rows
    past ``suffix_len`` go to scratch) right after that layer's attention,
    in place: the layer's history read only sees rows ``< start``, so the
    result equals the JAX package's one commit after the last layer,
    without holding every layer's K/V; ``commit_rows`` leaves rows out of
    the commit (a padded batch's duplicate rows commit once). The FFN hook
    gets the (B, P2) real-suffix mask. Returns ``(logits, pool_k,
    pool_v)``: the last real suffix token's logits ``(B, V)`` f32, or with
    ``return_all_logits`` every position's ``(B, P2, V)``."""
    c = config
    if ffn is None:
        ffn = _default_ffn
    B, P2 = tokens.shape
    device = tokens.device
    quant = isinstance(pool_k, dict)
    bs = (pool_k["q"] if quant else pool_k).shape[2]
    KhD = c.kv_heads * c.head_dim
    Kh, G, D = c.kv_heads, c.heads // c.kv_heads, c.head_dim
    starts = start_lengths.to(torch.long)
    suffix_lengths = suffix_lengths.to(torch.long)
    x = embedding_take(params["embed"], tokens)
    ar = torch.arange(P2, device=device)
    cos, sin = _rope(starts[:, None] + ar[None, :], D, c.rope_theta)
    pos_valid = ar[None, :] < suffix_lengths[:, None]                 # (B, P2)
    commit = pos_valid if commit_rows is None else pos_valid & commit_rows[:, None]
    scale = 1.0 / math.sqrt(D)
    # suffix key block: bounds score memory at O(P2 * sbs) per step
    sbs = math.gcd(P2, 128)
    # int8 history: ~128 rows of table columns per gather step
    cps = max(1, 128 // bs)

    def online_update(carry, qg_flat, k_blk, v_blk, mask):
        """One flash-style block update; carry (o (B,Kh,G,P2,D) f32, l, m),
        k/v (B, T, Kh, D) or int8 {"q","s"}, mask broadcastable over
        (B, Kh, G, P2, T)."""
        o, l, m = carry
        T = (k_blk["s"] if isinstance(k_blk, dict) else k_blk).shape[1]
        s = cache_scores(qg_flat, k_blk).reshape(B, Kh, G, P2, T) * scale
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        shift = torch.where(m_new <= NEG_INF, torch.zeros_like(m_new), m_new)
        p = torch.where(mask, torch.exp(s - shift[..., None]), torch.zeros_like(s))
        alpha = torch.exp(
            torch.where(m <= NEG_INF, torch.full_like(m, NEG_INF), m - shift)
        )
        l = l * alpha + p.sum(dim=-1)
        update = cache_values(
            p.to(qg_flat.dtype).reshape(B, Kh, G * P2, T), v_blk
        ).reshape(B, Kh, G, P2, D)
        o = o * alpha[..., None] + update.to(torch.float32)
        return o, l, m_new

    def history_gather(ck_l, cv_l, qg_flat):
        """int8 pools: the blocked gather over the history."""
        carry = (
            torch.zeros((B, Kh, G, P2, D), dtype=torch.float32, device=device),
            torch.zeros((B, Kh, G, P2), dtype=torch.float32, device=device),
            torch.full((B, Kh, G, P2), NEG_INF, dtype=torch.float32, device=device),
        )
        tables = block_tables.to(torch.long)
        for step in range(-(-num_read_blocks // cps)):
            col_idx = step * cps + torch.arange(cps, device=device)
            cols = tables[:, torch.clamp(col_idx, max=num_read_blocks - 1)]

            def take(pool_l):
                if isinstance(pool_l, dict):
                    return {
                        "q": pool_l["q"][cols].reshape(B, cps * bs, Kh, D),
                        "s": pool_l["s"][cols].reshape(B, cps * bs, Kh),
                    }
                return pool_l[cols].reshape(B, cps * bs, Kh, D)

            # positions from the UNclamped columns: a clamped duplicate tail
            # column lies at or past num_read_blocks * bs, never < start
            w_pos = (col_idx[:, None] * bs + torch.arange(bs, device=device)).reshape(-1)
            mask = (w_pos[None, :] < starts[:, None])[:, None, None, None, :]
            carry = online_update(carry, qg_flat, take(ck_l), take(cv_l), mask)
        return carry

    for layer in range(c.layers):
        lp = layer_params(params, layer)
        ck_l, cv_l = pool_layer(pool_k, layer), pool_layer(pool_v, layer)
        ad = adapter_layer(adapters, layer)
        h = _rms_norm(x, lp["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, h, lp, ad)                 # (B, P2, heads|Kh, D)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        # the kvquant helpers work on (B, Kh, G', T/D): fold P2 into G
        qg_flat = (
            q.reshape(B, P2, Kh, G, D).permute(0, 2, 3, 1, 4).reshape(B, Kh, G * P2, D)
        )
        if quant:
            carry = history_gather(ck_l, cv_l, qg_flat)
        else:
            acc_h, m_h, l_h = paged_attention_multiquery_partial(
                q.contiguous(), ck_l, cv_l, block_tables, start_lengths,
                num_read_blocks=num_read_blocks, kv_heads=Kh, head_dim=D,
                scale=scale,
            )
            # (B, P2, H[, D]) -> the (B, Kh, G, P2[, D]) carry layout
            carry = (
                acc_h.reshape(B, P2, Kh, G, D).permute(0, 2, 3, 1, 4),
                l_h.reshape(B, P2, Kh, G).permute(0, 2, 3, 1),
                m_h.reshape(B, P2, Kh, G).permute(0, 2, 3, 1),
            )
            del acc_h, m_h, l_h
        for t in range(P2 // sbs):
            k_pos = t * sbs + torch.arange(sbs, device=device)
            mask = (
                (ar[:, None] >= k_pos[None, :])[None]
                & (k_pos[None, None, :] < suffix_lengths[:, None, None])
            )[:, None, None, :, :]
            carry = online_update(
                carry, qg_flat, k[:, t * sbs:(t + 1) * sbs],
                v[:, t * sbs:(t + 1) * sbs], mask,
            )
        o, l, _ = carry
        del carry
        inv = torch.where(l > 0.0, 1.0 / torch.clamp(l, min=1e-30), torch.zeros_like(l))
        out = (o * inv[..., None]).to(x.dtype)       # (B, Kh, G, P2, D)
        del o
        out = out.permute(0, 3, 1, 2, 4).reshape(B, P2, c.heads * D)
        x = x + _out_proj(out, lp, ad)
        h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
        x = x + ffn(h2, lp, pos_valid)
        # commit this layer's suffix rows (in place, through layer views)
        write_rows(_layer_slice(pool_k, layer), k.reshape(1, B, P2, KhD),
                   block_tables, start_lengths, commit)
        write_rows(_layer_slice(pool_v, layer), v.reshape(1, B, P2, KhD),
                   block_tables, start_lengths, commit)
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    if return_all_logits:
        logits = (x @ _w(params["lm_head"])).to(torch.float32)
    else:
        last = x[torch.arange(B, device=device), (suffix_lengths - 1).clamp(min=0)]
        logits = (last @ _w(params["lm_head"])).to(torch.float32)
    return logits, pool_k, pool_v


def _layer_slice(pool, layer: int):
    """A one-layer ``(1, nb, bs, ...)`` view of a pool (either layout), so
    :func:`write_rows` scatters into that layer in place."""
    if isinstance(pool, dict):
        return {name: a[layer:layer + 1] for name, a in pool.items()}
    return pool[layer:layer + 1]


def pack_tokens_logprobs(tokens: torch.Tensor, logprobs: torch.Tensor) -> torch.Tensor:
    """Fold a chunk's host-bound outputs into ONE int32 tensor on the
    device: tokens first, then the f32 logprobs reinterpreted as int32
    (lossless — the host views the tail back as float32). The engine's
    per-chunk device-to-host traffic is exactly this tensor's copy."""
    return torch.cat([
        tokens.to(torch.int32).reshape(-1),
        logprobs.to(torch.float32).contiguous().view(torch.int32).reshape(-1),
    ])


def prompt_lookup_draft(
    ctx: torch.Tensor,   # (B, S) int — [prompt | generated] per row, zero-padded
    n: torch.Tensor,     # (B,) int — valid tokens per row
    num_drafts: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prompt-lookup drafter, row by row over a batch: continue each row's
    LAST occurrence of its final bigram. Candidates are ``i in [1, n-2]``
    with ``(ctx[i-1], ctx[i]) == (ctx[n-2], ctx[n-1])``; the draft is
    ``ctx[i+1 : i+1+num_drafts]``, clipped to ``n`` and zero-padded. No
    match (or ``n < 3``) drafts zeros with ``n_real = 0``. Returns
    ``(drafts (B, num_drafts) int32, n_real (B,) int32)``."""
    B, S = ctx.shape
    device = ctx.device
    pos = torch.arange(S, device=device)[None, :]
    n = n.to(torch.long)[:, None]                                      # (B, 1)
    last0 = torch.gather(ctx, 1, (n - 2).clamp(min=0))
    last1 = torch.gather(ctx, 1, (n - 1).clamp(min=0))
    prev = torch.roll(ctx, 1, dims=1)  # prev[:, i] = ctx[:, i-1]; i = 0 masked
    match = (prev == last0) & (ctx == last1) & (pos >= 1) & (pos <= n - 2)
    i = torch.where(match, pos, torch.full_like(pos, -1)).amax(dim=1, keepdim=True)
    found = (i >= 0) & (n >= 3)
    start = i + 1
    offs = start + torch.arange(num_drafts, device=device)[None, :]
    drafts = torch.where(
        (offs < n) & found, torch.gather(ctx, 1, offs.clamp(0, S - 1)),
        torch.zeros_like(offs, dtype=ctx.dtype),
    )
    n_real = torch.where(found, (n - start).clamp(0, num_drafts), torch.zeros_like(n))
    return drafts.to(torch.int32), n_real[:, 0].to(torch.int32)


def llama_spec_step_paged(
    config: LlamaConfig,
    params: dict,
    ctx: torch.Tensor,            # (B, S+1) int32 context rows; column S is a sentinel
    current: torch.Tensor,        # (B,) last emitted token per slot
    base_lengths: torch.Tensor,   # (B,) int32 — tokens committed in the pool
    active: torch.Tensor,         # (B,) bool
    pool_k,
    pool_v,
    block_tables: torch.Tensor,
    num_drafts: int,
    num_read_blocks: int,
    generator: torch.Generator | None = None,
    temps: torch.Tensor | None = None,
    topks: torch.Tensor | None = None,
    topps: torch.Tensor | None = None,
    sampler_mode: tuple | None = None,
    ffn=None,
    adapters: dict | None = None,  # batched ragged LoRA, see adapter_layer
):
    """One speculative step on the device: prompt-lookup drafts from the
    context rows, the verify forward, and the context update, with no host
    sync. The rows hold ``[prompt | generated]``, so ``n = lengths + 1``
    (``current`` is ``ctx[n-1]``, not yet in the pool). The emitted run is
    written back at ``n .. n+adv-1`` so the next step drafts from a current
    context; unemitted columns and positions past the context go to the
    sentinel column ``S`` (the counterpart of the JAX package's
    out-of-bounds drop, without a boolean select).

    Returns ``(packed, ctx, pool_k, pool_v)``, ``packed`` the int32 layout
    ``[emitted (B*D1) | adv (B) | next (B) | new_lengths (B) | n_real (B) |
    bitcast logprobs (B*D1)]`` that the engine copies to the host once."""
    B, S1 = ctx.shape
    S = S1 - 1
    n = base_lengths.to(torch.long) + 1
    drafts, n_real = prompt_lookup_draft(ctx[:, :S], n, num_drafts)
    drafts = torch.where(active[:, None], drafts, torch.zeros_like(drafts))
    n_real = torch.where(active, n_real, torch.zeros_like(n_real))
    tokens = torch.cat([current.to(torch.long)[:, None], drafts.to(torch.long)], dim=1)
    emitted, adv, next_tokens, new_lengths, pool_k, pool_v, logprobs = (
        llama_verify_chunk_paged(
            config, params, tokens, base_lengths, active, pool_k, pool_v,
            block_tables, num_read_blocks, generator=generator, temps=temps,
            topks=topks, topps=topps, sampler_mode=sampler_mode, ffn=ffn,
            adapters=adapters,
        )
    )
    D1 = num_drafts + 1
    js = torch.arange(D1, device=ctx.device)[None, :]
    write_pos = n[:, None] + js                    # emitted[:, j] → ctx[n+j]
    cols = torch.where((js < adv[:, None]) & (write_pos < S), write_pos,
                       torch.full_like(write_pos, S))
    ctx.scatter_(1, cols, emitted.to(ctx.dtype))
    packed = torch.cat([
        emitted.to(torch.int32).reshape(-1),
        adv.to(torch.int32),
        next_tokens.to(torch.int32),
        new_lengths.to(torch.int32),
        n_real.to(torch.int32),
        logprobs.to(torch.float32).contiguous().view(torch.int32).reshape(-1),
    ])
    return packed, ctx, pool_k, pool_v


def llama_verify_chunk_paged(
    config: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,         # (B, D1): [current, draft_0 .. draft_{D1-2}]
    base_lengths: torch.Tensor,   # (B,) int32 — tokens in the pool per slot
    active: torch.Tensor,         # (B,) bool
    pool_k,
    pool_v,
    block_tables: torch.Tensor,
    num_read_blocks: int,
    generator: torch.Generator | None = None,
    temps: torch.Tensor | None = None,
    topks: torch.Tensor | None = None,
    topps: torch.Tensor | None = None,
    sampler_mode: tuple | None = None,   # (use_top_p, use_top_k, all_greedy)
    ffn=None,                            # FFN hook (MoE family)
    adapters: dict | None = None,        # batched ragged LoRA, see adapter_layer
):
    """Speculative VERIFY step: one continuation forward over ``D1 = 1 +
    drafts`` positions per slot scores every draft at once (its history
    read is the multi-query kernel on bf16/f32 pools).

    - **Greedy** (``sampler_mode`` None or all-greedy): keep the longest
      prefix of drafts equal to the model's own argmax, plus the model's
      token after it, so greedy streams equal plain decode on a bf16/f32
      pool. On an int8 pool a position reads as fresh K/V before its
      commit and as int8 after, at other boundaries than the decode chunk,
      so near-tie argmaxes may differ from a non-speculative stream.
    - **Sampled**: :func:`~langstream_tpu_torch.serving.sampler.speculative_accept`
      against the filtered target; greedy rows in the batch take the
      greedy rule.

    Inactive rows get suffix length 0 (their writes go to scratch, not
    through their real tables), and rows are capped at the context limit:
    a position >= ``max_seq_len`` would clamp to the slot's last table
    column in :func:`write_rows` and overwrite committed K/V. K/V of all
    verified positions is committed; rows past ``new_lengths`` hold
    rejected drafts, which no read sees and the next step overwrites.

    Returns ``(emitted (B, D1), adv (B,), next_tokens (B,), new_lengths
    (B,), pool_k, pool_v, logprobs (B, D1))``: the token to emit at each
    position, how many leading ones are real (1..D1, 0 when inactive), the
    next step's current token, and the lengths after the step."""
    c = config
    B, D1 = tokens.shape
    room = (c.max_seq_len - base_lengths.to(torch.long)).clamp(min=0)
    suffix_lengths = torch.where(
        active, room.clamp(max=D1), torch.zeros_like(room)
    ).to(torch.int32)
    logits, pool_k, pool_v = llama_prefill_continue_paged(
        c, params, tokens, base_lengths, suffix_lengths, pool_k, pool_v,
        block_tables, num_read_blocks, return_all_logits=True, ffn=ffn,
        adapters=adapters,
    )  # (B, D1, V) f32
    drafts = tokens[:, 1:]
    if sampler_mode is None or sampler_mode[2]:  # all greedy
        model_next = torch.argmax(logits, dim=-1)                  # (B, D1)
        # draft j (input position j+1) is accepted iff every earlier draft
        # was and the model's token at position j equals it
        match = (model_next[:, :-1] == drafts).to(torch.int32)
        accepted = torch.cumprod(match, dim=1).sum(dim=1)
        emitted = model_next
    else:
        use_top_p, use_top_k, _ = sampler_mode
        accepted, fallback = speculative_accept(
            logits, drafts, generator, temps, topks, topps,
            use_top_p=use_top_p, use_top_k=use_top_k,
        )
        # accepted drafts verbatim, then the residual/bonus sample at the
        # stop position (the only fallback column the engine reads)
        pos = torch.arange(D1, device=tokens.device)[None, :]
        drafts_pad = torch.nn.functional.pad(drafts, (0, 1))
        emitted = torch.where(pos < accepted[:, None], drafts_pad.to(torch.long),
                              fallback.to(torch.long))
    emitted = emitted.to(torch.int32)
    logprobs = torch.gather(
        torch.log_softmax(logits, dim=-1), 2, emitted.to(torch.long)[..., None]
    ).squeeze(-1)
    adv = torch.where(active, accepted.to(torch.int32) + 1,
                      torch.zeros_like(accepted, dtype=torch.int32))
    new_lengths = base_lengths.to(torch.int32) + adv
    next_tokens = torch.where(
        active,
        torch.gather(emitted, 1, (adv.to(torch.long) - 1).clamp(min=0)[:, None]).squeeze(1),
        tokens[:, 0].to(torch.int32),
    )
    return emitted, adv, next_tokens, new_lengths, pool_k, pool_v, logprobs


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
    commit_inactive: bool = False,
    ffn=None,                     # (h (B,H), lp, active (B,)) -> (B,H); default SwiGLU
    adapters: dict | None = None,  # batched ragged LoRA, see adapter_layer
):
    """K fused decode steps against the paged pool: the pool is read-only,
    each step's new K/V lands in a chunk buffer ``(L, B, K, Kh, D)``, and
    one scatter commits the buffer at the end. Inactive slots' rows go to
    scratch block 0, unless ``commit_inactive`` (a pool without a scratch
    block): then they land past the slot's own length, where no read
    looks.

    Returns ``(chunk_tokens (K,B), chunk_logprobs (K,B), final_tokens,
    final_lengths, pool_k, pool_v)``, or with ``return_packed``
    ``(packed, final_tokens, final_lengths, pool_k, pool_v)``."""
    c = config
    if ffn is None:
        ffn = _default_ffn
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
            ad = adapter_layer(adapters, layer)
            h = _rms_norm(x, lp["attn_norm"], c.norm_eps)
            q, k, v = _qkv(c, h, lp, ad)
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
            x = x + _out_proj(out.reshape(B, c.heads * c.head_dim), lp, ad)
            h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
            x = x + ffn(h2, lp, active)
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
    valid = (torch.ones_like(active) if commit_inactive else active)[:, None].expand(
        B, num_steps)
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
    cache_k,                      # (L, B, S, Kh, D) — the DENSE layout, or int8
    cache_v,                      # {"q": (L, B, S, Kh, D), "s": (L, B, S, Kh)}
    sample_fn: Callable,
    num_steps: int,
    window: int | None,           # cache rows the read may cover (None = S)
    block_size: int = 128,
    sample_extras=None,
    return_packed: bool = False,
    ffn=None,
):
    """Dense-cache decode through the paged read kernels: a dense cache is a
    degenerate block pool — slot ``b``'s rows are the contiguous blocks
    ``[b*S/bs, (b+1)*S/bs)`` — so the cache viewed as
    ``(L, B*S/bs, bs, Kh*D)`` with identity block tables goes through the
    same kernel (and the commit writes through the view, in place). An int8
    cache views as the int8 pool the same way (rows ``(L, B*S/bs, bs,
    Kh*D)``, scales ``(L, B*S/bs, bs, Kh)``) and reads through the int8
    kernel. Block 0 is slot 0's first rows here, not scratch, so inactive
    slots commit into their own rows past their length instead."""
    c = config
    quant = isinstance(cache_k, dict)
    L, B, S, Kh, D = (cache_k["q"] if quant else cache_k).shape
    bs = dense_block_size(S, block_size)
    nb = S // bs

    def view(cache):
        if quant:
            return {"q": cache["q"].view(L, B * nb, bs, Kh * D),
                    "s": cache["s"].view(L, B * nb, bs, Kh)}
        return cache.view(L, B * nb, bs, Kh * D)

    pool_k, pool_v = view(cache_k), view(cache_v)
    device = (cache_k["q"] if quant else cache_k).device
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
        commit_inactive=True, ffn=ffn,
    )
    return out[:-2] + (cache_k, cache_v)
