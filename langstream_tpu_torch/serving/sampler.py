"""Token sampling on the device (port of ``langstream_tpu/serving/sampler.py``).

Sampling runs inside the decode chunk, so only the sampled token ids and
their logprobs ever cross to the host. Greedy (temperature 0), temperature,
top-k (a fixed ``K_MAX = 64`` window) and top-p, plus OpenAI-style
presence/frequency penalties. The expensive passes run only when a request
in the batch asks for them (the engine derives the flags per burst).

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
