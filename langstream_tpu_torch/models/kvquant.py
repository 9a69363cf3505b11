"""int8 KV rows (port of ``langstream_tpu/models/kvquant.py``).

Per-row absmax int8, one f32 scale per (position, kv-head) row. The read
path never materialises a dequantized cache:

- scores: the scale is constant along the contracted ``head_dim``, so
  ``q . dequant(k) == (q . k_int8) * scale``;
- values: the scale varies along the contracted ``seq`` axis, so it folds
  into the probabilities: ``probs . dequant(v) == (probs * scale) . v_int8``.

An int8 cache is a ``{"q": int8, "s": f32}`` dict, the JAX package's layout.
"""

from __future__ import annotations

from typing import Any

import torch


def is_quant_cache(cache: Any) -> bool:
    return isinstance(cache, dict) and "q" in cache and "s" in cache


def quantize_rows(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-row absmax int8 over the trailing ``head_dim`` axis.

    ``x``: (..., D) → {"q": int8 (..., D), "s": f32 (...,)}. ``torch.round``
    rounds half to even, as ``jnp.round`` does.
    """
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0).to(
        torch.int8
    )
    return {"q": q, "s": scale}


def cache_scores(qg: torch.Tensor, ck_l: Any) -> torch.Tensor:
    """Scores of grouped queries against a cache window.

    ``qg``: (B, K, G, D); ``ck_l``: (B, S, K, D) or the int8 dict.
    Returns f32 (B, K, G, S), unscaled by 1/sqrt(D)."""
    if not is_quant_cache(ck_l):
        return torch.einsum("bkgd,bskd->bkgs", qg, ck_l).to(torch.float32)
    s = torch.einsum(
        "bkgd,bskd->bkgs", qg, ck_l["q"].to(qg.dtype)
    ).to(torch.float32)
    return s * ck_l["s"].permute(0, 2, 1)[:, :, None, :]


def cache_values(probs: torch.Tensor, cv_l: Any) -> torch.Tensor:
    """Value mix for a cache window.

    ``probs``: (B, K, G, S) in the model dtype; ``cv_l``: (B, S, K, D) or
    the int8 dict. Returns (B, K, G, D) in the probs dtype."""
    if not is_quant_cache(cv_l):
        return torch.einsum("bkgs,bskd->bkgd", probs, cv_l)
    scaled = (
        probs.to(torch.float32) * cv_l["s"].permute(0, 2, 1)[:, :, None, :]
    ).to(probs.dtype)
    return torch.einsum("bkgs,bskd->bkgd", scaled, cv_l["q"].to(probs.dtype))
