"""Token sampling on the device (port of ``langstream_tpu/serving/sampler.py``).

Sampling runs inside the decode chunk, so only the sampled token ids and
their logprobs ever cross to the host. Greedy (temperature 0), temperature,
top-k (a fixed ``K_MAX = 64`` window) and top-p, plus OpenAI-style
presence/frequency penalties. The expensive passes run only when a request
in the batch asks for them (the engine derives the flags per burst).
:func:`speculative_accept` is the rejection sampler of the speculative
verify step.

Random draws use a ``torch.Generator`` and the Gumbel-max trick, which
samples exactly the categorical distribution of the filtered logits without
a device-to-host sync. The numbers differ from ``jax.random``'s for the same
seed, so the two packages agree in distribution, not draw for draw.
"""

from __future__ import annotations

import torch

K_MAX = 64


def sample_tokens(
    logits: torch.Tensor,         # (B, V) float32
    generator: torch.Generator | None,
    temperatures: torch.Tensor,   # (B,) 0 = greedy
    top_ks: torch.Tensor,         # (B,) 0 = off
    use_top_p: bool = False,
    top_ps: torch.Tensor | None = None,  # (B,) 1.0 = off
    use_top_k: bool = True,
    all_greedy: bool = False,
    use_penalties: bool = False,
    presences: torch.Tensor | None = None,    # (B,)
    frequencies: torch.Tensor | None = None,  # (B,)
    counts: torch.Tensor | None = None,       # (B, V) output-token counts
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (tokens (B,) int32, logprobs (B,) float32 of the sampled token)."""
    if use_penalties:
        # applied before everything: greedy argmax and logprobs see the
        # penalised distribution
        cf = counts.to(logits.dtype)
        logits = logits - (
            presences[:, None] * (cf > 0).to(logits.dtype)
            + frequencies[:, None] * cf
        )
    greedy_tokens = torch.argmax(logits, dim=-1)

    def token_logprob(tokens: torch.Tensor) -> torch.Tensor:
        logprobs = torch.log_softmax(logits, dim=-1)
        return torch.gather(logprobs, 1, tokens[:, None].to(torch.long)).squeeze(1)

    if all_greedy:
        return greedy_tokens.to(torch.int32), token_logprob(greedy_tokens)

    scaled = filtered_logits(
        logits, temperatures, top_ks,
        use_top_p=use_top_p, top_ps=top_ps, use_top_k=use_top_k,
    )
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    tokens = torch.where(temperatures <= 0, greedy_tokens, sampled)
    return tokens.to(torch.int32), token_logprob(tokens)


def filtered_logits(
    logits: torch.Tensor,         # (B, V) float32
    temperatures: torch.Tensor,   # (B,)
    top_ks: torch.Tensor,         # (B,) 0 = off
    use_top_p: bool = False,
    top_ps: torch.Tensor | None = None,
    use_top_k: bool = True,
) -> torch.Tensor:
    """Temperature-scaled, top-k/top-p-masked logits: the exact categorical
    distribution :func:`sample_tokens` draws from."""
    B, V = logits.shape
    temps = torch.clamp(temperatures, min=1e-6)[:, None]
    scaled = logits / temps
    neg = torch.finfo(scaled.dtype).min
    if use_top_k:
        # mask everything below the k-th largest (k per row through a fixed
        # K_MAX window — no vocab-sized sort)
        top_vals = torch.topk(scaled, min(K_MAX, V), dim=-1).values
        k_idx = torch.clamp(top_ks.to(torch.long) - 1, 0, top_vals.shape[1] - 1)
        kth_val = torch.gather(top_vals, 1, k_idx[:, None])
        apply_topk = (top_ks > 0)[:, None]
        scaled = torch.where(apply_topk & (scaled < kth_val),
                             torch.full_like(scaled, neg), scaled)
    if use_top_p:
        if top_ps is None:
            raise ValueError("use_top_p needs top_ps")
        sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
        sorted_logits = torch.gather(scaled, 1, sort_idx)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_ps[:, None]  # always keeps the top one
        keep = torch.zeros_like(keep_sorted).scatter(1, sort_idx, keep_sorted)
        scaled = torch.where(keep, scaled, torch.full_like(scaled, neg))
    return scaled


def speculative_accept(
    logits: torch.Tensor,         # (B, D1, V) float32 — verify forward outputs
    drafts: torch.Tensor,         # (B, D1-1) int — deterministic draft tokens
    generator: torch.Generator | None,
    temperatures: torch.Tensor,   # (B,)
    top_ks: torch.Tensor,         # (B,)
    top_ps: torch.Tensor | None,  # (B,)
    use_top_p: bool = False,
    use_top_k: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rejection sampling for a DETERMINISTIC drafter (prompt lookup).

    The draft distribution is a point mass at the drafted token, so the
    speculative-sampling rule reduces to: accept draft ``d_j`` while
    ``u < p_j(d_j)`` (the target's filtered probability); at the first
    rejection emit a sample from ``p_j`` with ``d_j`` masked out (the
    residual); after full acceptance emit a bonus sample from the last
    position. The emitted stream is distributed exactly as plain sampling
    from :func:`filtered_logits`. Greedy rows (temperature <= 0) use a
    point mass at the unfiltered argmax: acceptance is ``draft ==
    argmax`` and every fallback is the argmax.

    Draws come from ``generator``: ``torch.rand`` for ``u`` and Gumbel-max
    for the categorical, with no host sync. Returns ``(accepted (B,)
    int32, fallback (B, D1) int32)``: the count of accepted drafts, and
    the token to emit at each position if the run stops there."""
    B, D1, V = logits.shape
    flat = logits.reshape(B * D1, V)

    def rep(a):
        return a.repeat_interleave(D1, dim=0)

    scaled = filtered_logits(
        flat, rep(temperatures), rep(top_ks), use_top_p=use_top_p,
        top_ps=rep(top_ps) if top_ps is not None else None, use_top_k=use_top_k,
    )
    p = torch.softmax(scaled, dim=-1)
    greedy = (rep(temperatures) <= 0)[:, None]
    onehot = torch.nn.functional.one_hot(torch.argmax(flat, dim=-1), V).to(p.dtype)
    p = torch.where(greedy, onehot, p).reshape(B, D1, V)

    drafts = drafts.to(torch.long)
    p_draft = torch.gather(p[:, :-1], 2, drafts[..., None]).squeeze(-1)  # (B, D1-1)
    u = torch.rand((B, D1 - 1), generator=generator, device=logits.device,
                   dtype=torch.float32)
    accepted = torch.cumprod((u < p_draft).to(torch.int32), dim=1).sum(dim=1)

    # fallback per position: a categorical over log p with the draft masked
    # out (the residual); the last position keeps the full p (the bonus). A
    # masked position is used only at the first rejection, where p(draft) < 1
    # leaves the residual some mass.
    fb_logits = torch.log(p + 1e-30)
    neg = torch.finfo(fb_logits.dtype).min
    draft_hot = torch.zeros((B, D1, V), dtype=torch.bool, device=logits.device)
    draft_hot[:, :-1].scatter_(2, drafts[..., None], True)
    fb_logits = fb_logits.masked_fill(draft_hot, neg)
    g = torch.rand(fb_logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    g = g.clamp_(min=torch.finfo(torch.float32).tiny)
    fallback = torch.argmax(fb_logits - torch.log(-torch.log(g)), dim=-1)
    return accepted.to(torch.int32), fallback.to(torch.int32)
