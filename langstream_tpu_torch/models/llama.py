"""Llama-family decoder in PyTorch (port of ``langstream_tpu/models/llama.py``).

Layouts follow the JAX package at every public function so the two can be
compared like with like: stacked per-layer weights ``(L, in, out)``,
activations ``(B, S, hidden)``, q/k/v ``(B, S, heads, head_dim)``. The
layer ``lax.scan`` of the JAX package is a Python loop here.

Prefill attention always goes through
:func:`langstream_tpu_torch.ops.flash_attention.flash_attention`: its CUDA
kernel for tensors on the card, its plain version for tensors on the CPU.
The JAX package's ``seq_len >= 512`` gate was a TPU measurement and does not
carry over.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from langstream_tpu_torch._device import require_device
from langstream_tpu_torch.models.quant import as_weight as _w, embedding_take
from langstream_tpu_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden: int = 2048
    layers: int = 16
    heads: int = 16
    kv_heads: int = 8
    head_dim: int = 128
    intermediate: int = 5632
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def llama3_8b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return cls(
            vocab_size=128256, hidden=4096, layers=32, heads=32, kv_heads=8,
            head_dim=128, intermediate=14336, rope_theta=500000.0,
            max_seq_len=max_seq_len,
        )

    @classmethod
    def llama3_70b(cls, max_seq_len: int = 8192) -> "LlamaConfig":
        return cls(
            vocab_size=128256, hidden=8192, layers=80, heads=64, kv_heads=8,
            head_dim=128, intermediate=28672, rope_theta=500000.0,
            max_seq_len=max_seq_len,
        )

    @classmethod
    def llama_1b(cls, max_seq_len: int = 2048) -> "LlamaConfig":
        """~1.2B params: the per-device share of Llama-3-8B under TP8."""
        return cls(
            vocab_size=32000, hidden=2048, layers=16, heads=16, kv_heads=8,
            head_dim=128, intermediate=5632, max_seq_len=max_seq_len,
        )

    @classmethod
    def tiny(cls, max_seq_len: int = 128) -> "LlamaConfig":
        """Test-size config. Vocab covers the byte-level tokenizer."""
        return cls(
            vocab_size=384, hidden=64, layers=2, heads=4, kv_heads=2,
            head_dim=16, intermediate=128, max_seq_len=max_seq_len,
        )


def param_count(config: LlamaConfig) -> int:
    """Parameters of the model: attention, SwiGLU FFN and the two norms per
    layer, embedding and LM head, the final norm."""
    c = config
    per_layer = (
        c.hidden * c.heads * c.head_dim
        + 2 * c.hidden * c.kv_heads * c.head_dim
        + c.heads * c.head_dim * c.hidden
        + 3 * c.hidden * c.intermediate
        + 2 * c.hidden
    )
    return c.layers * per_layer + 2 * c.vocab_size * c.hidden + c.hidden


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_llama_params(config: LlamaConfig,
                      generator: torch.Generator | None = None,
                      device="cuda") -> dict:
    """Random-init params (stacked per-layer leading dim L) on ``device``
    (the card unless the caller asks for the CPU; the generator must live
    on the same device). The numbers differ from the JAX package's init
    for the same seed: the two RNGs differ, so tests carry parameters
    across with ``params_from_numpy``."""
    device = require_device(device, "init_llama_params")
    c = config
    qkv_dim = c.heads * c.head_dim
    kv_dim = c.kv_heads * c.head_dim
    L = c.layers

    def norm_init(*shape):
        return torch.ones(shape, dtype=c.dtype, device=device)

    def w_init(*shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * (1.0 / math.sqrt(fan_in))).to(c.dtype)

    return {
        "embed": w_init(c.vocab_size, c.hidden, fan_in=c.hidden),
        "layers": {
            "attn_norm": norm_init(L, c.hidden),
            "wq": w_init(L, c.hidden, qkv_dim, fan_in=c.hidden),
            "wk": w_init(L, c.hidden, kv_dim, fan_in=c.hidden),
            "wv": w_init(L, c.hidden, kv_dim, fan_in=c.hidden),
            "wo": w_init(L, qkv_dim, c.hidden, fan_in=qkv_dim),
            "mlp_norm": norm_init(L, c.hidden),
            "w_gate": w_init(L, c.hidden, c.intermediate, fan_in=c.hidden),
            "w_up": w_init(L, c.hidden, c.intermediate, fan_in=c.hidden),
            "w_down": w_init(L, c.intermediate, c.hidden, fan_in=c.intermediate),
        },
        "final_norm": norm_init(c.hidden),
        "lm_head": w_init(c.hidden, c.vocab_size, fan_in=c.hidden),
    }


def layer_params(params: dict, layer: int) -> dict:
    """One layer's slice of the stacked weights (views, no copies)."""
    return {name: w[layer] for name, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize in f32, cast back to the input dtype, then scale by ``w``
    (the JAX package's cast order)."""
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def _rope(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for the given positions: (..., head_dim//2), f32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """x: (..., heads, head_dim), split halves (not interleaved pairs);
    cos/sin broadcast over the heads axis."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(
        x.dtype
    )


def _swiglu(x, w_gate, w_up, w_down):
    gate = F.silu(x @ _w(w_gate))
    up = x @ _w(w_up)
    return (gate * up) @ _w(w_down)


def _default_ffn(h, lp, valid=None):
    """The dense SwiGLU FFN sub-block. The ``ffn=`` hook of every model
    entry point defaults to it; the MoE family plugs in its routed FFN
    (``models/moe.py``) and reuses the attention and cache paths.
    ``valid`` marks real positions: a pointwise FFN ignores it, a routed
    one must not let padded or inactive positions take expert capacity."""
    return _swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _qkv(c: LlamaConfig, h: torch.Tensor, lp: dict):
    """Projections reshaped to (..., heads|kv_heads, head_dim)."""
    lead = h.shape[:-1]
    q = (h @ _w(lp["wq"])).reshape(*lead, c.heads, c.head_dim)
    k = (h @ _w(lp["wk"])).reshape(*lead, c.kv_heads, c.head_dim)
    v = (h @ _w(lp["wv"])).reshape(*lead, c.kv_heads, c.head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# prefill / forward
# ---------------------------------------------------------------------------


def prefill_forward(
    config: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,   # (B, P) int, right-padded
    lengths: torch.Tensor,  # (B,) true lengths
    ffn=None,               # (h (B,P,H), lp, valid (B,P)) -> (B,P,H); default SwiGLU
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared prompt forward: returns (last-token logits (B, V) f32, ks, vs)
    where ks/vs are the roped per-layer K/V ``(L, B, P, Kh, D)``.

    Causality alone hides right-padded keys from every real query row, so
    the attention needs no per-row length; padded rows' outputs are
    garbage the caller discards. The FFN hook gets the (B, P) real-token
    mask."""
    c = config
    if ffn is None:
        ffn = _default_ffn
    B, Pn = tokens.shape
    x = embedding_take(params["embed"], tokens)  # (B, P, H)
    positions = torch.arange(Pn, device=tokens.device)[None, :].expand(B, Pn)
    cos, sin = _rope(positions, c.head_dim, c.rope_theta)
    pos_valid = positions < lengths.to(torch.long)[:, None]
    ks, vs = [], []
    for layer in range(c.layers):
        lp = layer_params(params, layer)
        h = _rms_norm(x, lp["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, h, lp)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        out = flash_attention(q, k, v, causal=True)
        x = x + out.reshape(B, Pn, c.heads * c.head_dim) @ _w(lp["wo"])
        h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
        x = x + ffn(h2, lp, pos_valid)
        ks.append(k)
        vs.append(v)
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    rows = torch.arange(B, device=tokens.device)
    last = x[rows, (lengths.to(torch.long) - 1).clamp(min=0)]
    logits = (last @ _w(params["lm_head"])).to(torch.float32)
    return logits, torch.stack(ks), torch.stack(vs)


def llama_forward(
    config: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,  # (B, S) int
    ffn=None,              # (h (B,S,H), lp, valid=None) -> (B,S,H); default SwiGLU
) -> torch.Tensor:
    """All-position logits (B, S, V) f32, no KV cache (causal attention);
    every position is a real token."""
    c = config
    if ffn is None:
        ffn = _default_ffn
    B, S = tokens.shape
    x = embedding_take(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = _rope(positions, c.head_dim, c.rope_theta)
    for layer in range(c.layers):
        lp = layer_params(params, layer)
        h = _rms_norm(x, lp["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, h, lp)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        out = flash_attention(q, k, v, causal=True)
        x = x + out.reshape(B, S, c.heads * c.head_dim) @ _w(lp["wo"])
        h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
        x = x + ffn(h2, lp)
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    return (x @ _w(params["lm_head"])).to(torch.float32)
