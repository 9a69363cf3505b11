"""Weight-only int8 quantization (port of ``langstream_tpu/models/quant.py``).

Per-output-channel symmetric int8 with f32 scales. :func:`as_weight`
dequantizes at the matmul site exactly as the JAX package writes it
(``q.astype(dtype) * s.astype(dtype)``); the JAX package leaves that
product to XLA outside any Pallas kernel, so here it is plain PyTorch and
the product goes to ``torch.matmul``. A fused int8 GEMV is later work.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from langstream_tpu_torch._device import require_device


@dataclasses.dataclass
class QTensor:
    """int8 weight + f32 scale, shaped to broadcast on dequant.

    ``dtype`` is the pre-quantization dtype the weight dequantizes back to,
    so quantized and plain params are interchangeable in the model code.
    """

    q: torch.Tensor  # int8, original shape
    s: torch.Tensor  # f32, reduced to 1 along the contraction axis
    dtype: torch.dtype = torch.bfloat16

    def __getitem__(self, idx) -> "QTensor":
        """Index the leading (layer) axis of a stacked weight."""
        return QTensor(self.q[idx], self.s[idx], self.dtype)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.s.to(device), self.dtype)


def as_weight(t):
    """Dequantize a QTensor (or pass a plain tensor through)."""
    if isinstance(t, QTensor):
        return t.q.to(t.dtype) * t.s.to(t.dtype)
    return t


def embedding_take(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Row gather that understands quantized embeddings (gathers int8 rows
    and their per-row scales, dequantizes only the gathered rows)."""
    if isinstance(embed, QTensor):
        rows = embed.q[tokens].to(embed.dtype)
        scales = embed.s[tokens].to(embed.dtype)
        return rows * scales
    return embed[tokens]


def quantize_tensor(w: torch.Tensor, axis: int) -> QTensor:
    """Symmetric per-channel int8: scale reduces over ``axis`` (the
    contraction dimension of the matmul that consumes ``w``)."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, s=scale, dtype=w.dtype)


def quantize_llama_params(params: dict) -> dict:
    """Quantize every matmul weight of a Llama param tree; norms stay as
    they are. Projections contract the middle axis of their stacked
    ``(L, in, out)`` layout; embed is gathered per row; lm_head contracts
    hidden."""
    layers = params["layers"]
    out_layers = {
        "attn_norm": layers["attn_norm"],
        "mlp_norm": layers["mlp_norm"],
    }
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        out_layers[name] = quantize_tensor(layers[name], axis=1)
    return {
        "embed": quantize_tensor(params["embed"], axis=1),
        "layers": out_layers,
        "final_norm": params["final_norm"],
        "lm_head": quantize_tensor(params["lm_head"], axis=0),
    }


def quantize_moe_params(params: dict) -> dict:
    """MoE twin of :func:`quantize_llama_params`: attention, embed and LM
    head as there; experts per (layer, expert, output column), contracting
    axis 2 of ``(L, E, in, out)``, one layer at a time so the f32
    transient is one layer's experts; the router stays float32."""
    layers = params["layers"]

    def experts(w: torch.Tensor) -> QTensor:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty(w.shape[:2] + (1, w.shape[3]), dtype=torch.float32,
                        device=w.device)
        for i in range(w.shape[0]):
            t = quantize_tensor(w[i], axis=1)
            q[i], s[i] = t.q, t.s
        return QTensor(q=q, s=s, dtype=w.dtype)

    return {
        "embed": quantize_tensor(params["embed"], axis=1),
        "layers": {
            "attn_norm": layers["attn_norm"],
            "wq": quantize_tensor(layers["wq"], axis=1),
            "wk": quantize_tensor(layers["wk"], axis=1),
            "wv": quantize_tensor(layers["wv"], axis=1),
            "wo": quantize_tensor(layers["wo"], axis=1),
            "mlp_norm": layers["mlp_norm"],
            "router": layers["router"],
            # (L, E, H, I) contract H; (L, E, I, H) contract I
            "w_gate": experts(layers["w_gate"]),
            "w_up": experts(layers["w_up"]),
            "w_down": experts(layers["w_down"]),
        },
        "final_norm": params["final_norm"],
        "lm_head": quantize_tensor(params["lm_head"], axis=0),
    }


# ---------------------------------------------------------------------------
# direct quantized random-init (never materializes the full-precision tree)
# ---------------------------------------------------------------------------


def _q8_chunk(shape, fan_in, axis, generator, device):
    """One f32 random-normal chunk quantized per channel along ``axis``."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * (1.0 / math.sqrt(fan_in))
    amax = w.abs().amax(dim=axis, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s


def _chunks(n: int, target: int = 32) -> int:
    """Largest chunk count <= target that divides n (vocab chunking)."""
    for d in range(min(target, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _q8_stacked(n, rows, cols, fan_in, dtype, generator, device) -> QTensor:
    """``n`` random ``(rows, cols)`` matrices quantized per output column,
    one f32 chunk at a time: ``(n, rows, cols)`` int8, ``(n, 1, cols)``
    scales."""
    q = torch.empty((n, rows, cols), dtype=torch.int8, device=device)
    s = torch.empty((n, 1, cols), dtype=torch.float32, device=device)
    for i in range(n):
        q[i], s[i] = _q8_chunk((rows, cols), fan_in, 0, generator, device)
    return QTensor(q=q, s=s, dtype=dtype)


def _q8_embed(c, generator, device) -> QTensor:
    """The embedding quantized per row, 1/32 of the vocab at a time."""
    V, Hd = c.vocab_size, c.hidden
    nb = _chunks(V)
    rows = V // nb
    eq = torch.empty((V, Hd), dtype=torch.int8, device=device)
    es = torch.empty((V, 1), dtype=torch.float32, device=device)
    for i in range(nb):
        sl = slice(i * rows, (i + 1) * rows)
        eq[sl], es[sl] = _q8_chunk((rows, Hd), Hd, 1, generator, device)
    return QTensor(q=eq, s=es, dtype=c.dtype)


def _q8_lm_head(c, generator, device) -> QTensor:
    """The LM head quantized per vocab column, 1/32 of the vocab at a time."""
    V, Hd = c.vocab_size, c.hidden
    nb = _chunks(V)
    rows = V // nb
    hq = torch.empty((Hd, V), dtype=torch.int8, device=device)
    hs = torch.empty((1, V), dtype=torch.float32, device=device)
    for i in range(nb):
        sl = slice(i * rows, (i + 1) * rows)
        hq[:, sl], hs[:, sl] = _q8_chunk((Hd, rows), Hd, 0, generator, device)
    return QTensor(q=hq, s=hs, dtype=c.dtype)


def _q8_attention(c, generator, device) -> dict:
    """A layer stack's attention projections, quantized per output column."""
    L, Hd = c.layers, c.hidden
    qkv_dim = c.heads * c.head_dim
    kv_dim = c.kv_heads * c.head_dim
    return {
        "wq": _q8_stacked(L, Hd, qkv_dim, Hd, c.dtype, generator, device),
        "wk": _q8_stacked(L, Hd, kv_dim, Hd, c.dtype, generator, device),
        "wv": _q8_stacked(L, Hd, kv_dim, Hd, c.dtype, generator, device),
        "wo": _q8_stacked(L, qkv_dim, Hd, qkv_dim, c.dtype, generator, device),
    }


def init_llama_params_q8(config, generator: torch.Generator | None = None,
                         device="cuda") -> dict:
    """Random-init Llama params already weight-quantized: the same tree,
    shapes and scale layout as ``quantize_llama_params(init_llama_params(c))``,
    but the peak during init is the int8 tree plus ONE chunk's f32
    transient (one layer's ``(in, out)`` matrix, or 1/32 of the vocab),
    never the full-precision tree. Runs on ``device``: the card unless the
    caller asks for the CPU."""
    device = require_device(device, "init_llama_params_q8")
    c = config
    L, Hd, I = c.layers, c.hidden, c.intermediate
    embed = _q8_embed(c, generator, device)
    layers = {
        "attn_norm": torch.ones((L, Hd), dtype=c.dtype, device=device),
        **_q8_attention(c, generator, device),
        "mlp_norm": torch.ones((L, Hd), dtype=c.dtype, device=device),
        "w_gate": _q8_stacked(L, Hd, I, Hd, c.dtype, generator, device),
        "w_up": _q8_stacked(L, Hd, I, Hd, c.dtype, generator, device),
        "w_down": _q8_stacked(L, I, Hd, I, c.dtype, generator, device),
    }
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones((Hd,), dtype=c.dtype, device=device),
        "lm_head": _q8_lm_head(c, generator, device),
    }


def init_moe_params_q8(config, generator: torch.Generator | None = None,
                       device="cuda") -> dict:
    """MoE twin of :func:`init_llama_params_q8`: the tree of
    ``quantize_moe_params(init_moe_params(c))``, experts made one ``(in,
    out)`` f32 chunk per (layer, expert) on ``device`` (a Mixtral-8x7B
    expert chunk is 235 MB; the stacked f32 tensor would be 60 GB). The
    router stays float32, unquantized."""
    device = require_device(device, "init_moe_params_q8")
    c = config
    L, E, Hd, I = c.layers, c.experts, c.hidden, c.moe_intermediate

    def experts(rows, cols, fan_in) -> QTensor:
        # (L*E) chunks -> (L, E, rows, cols), scales (L, E, 1, cols): the
        # layout of quantize_tensor(axis=2)
        w = _q8_stacked(L * E, rows, cols, fan_in, c.dtype, generator, device)
        return QTensor(q=w.q.view(L, E, rows, cols), s=w.s.view(L, E, 1, cols),
                       dtype=c.dtype)

    embed = _q8_embed(c, generator, device)
    layers = {
        "attn_norm": torch.ones((L, Hd), dtype=c.dtype, device=device),
        **_q8_attention(c, generator, device),
        "mlp_norm": torch.ones((L, Hd), dtype=c.dtype, device=device),
        "router": torch.randn((L, Hd, E), generator=generator, device=device,
                              dtype=torch.float32) * (1.0 / math.sqrt(Hd)),
        "w_gate": experts(Hd, I, Hd),
        "w_up": experts(Hd, I, Hd),
        "w_down": experts(I, Hd, I),
    }
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": torch.ones((Hd,), dtype=c.dtype, device=device),
        "lm_head": _q8_lm_head(c, generator, device),
    }
