"""BERT/MiniLM-class text encoder for embeddings (port of
``langstream_tpu/models/encoder.py``).

The architecture of sentence-transformers all-MiniLM-L6-v2 (6 layers, 384
hidden, 12 heads, tanh-approximated GELU, post-LN) with mean pooling and
an L2 norm. The JAX package computes it outside any Pallas kernel, so the
products here are plain ``torch.matmul``. Real weights load from a local
sentence-transformers directory (:func:`load_from_sentence_transformers`);
otherwise :func:`init_encoder_params` makes random ones from a generator.
The JAX package's tensor-parallel specs come with multi-GPU serving
(ROADMAP.md Queue 1 item 13b).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from langstream_tpu_torch._device import require_device


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_position: int = 512
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @classmethod
    def minilm_l6(cls) -> "EncoderConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        # vocab covers the byte tokenizer (256 bytes + specials)
        return cls(vocab_size=384, hidden=32, layers=2, heads=4,
                   intermediate=64, max_position=64)


def init_encoder_params(config: EncoderConfig,
                        generator: torch.Generator | None = None,
                        device="cuda") -> dict:
    """Random-init params (stacked per-layer leading dim L) on ``device``
    (the card unless the caller asks for the CPU; the generator must live
    on the same device). Same layout and scales as the JAX package's
    init; the numbers differ, since the two RNGs differ."""
    device = require_device(device, "init_encoder_params")
    c = config
    L = c.layers

    def w(*shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x / math.sqrt(fan_in)).to(c.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=c.dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=c.dtype, device=device)

    return {
        "tok_embed": w(c.vocab_size, c.hidden, fan_in=c.hidden),
        "pos_embed": w(c.max_position, c.hidden, fan_in=c.hidden),
        "embed_norm_w": ones(c.hidden),
        "embed_norm_b": zeros(c.hidden),
        "layers": {
            "wq": w(L, c.hidden, c.hidden, fan_in=c.hidden), "bq": zeros(L, c.hidden),
            "wk": w(L, c.hidden, c.hidden, fan_in=c.hidden), "bk": zeros(L, c.hidden),
            "wv": w(L, c.hidden, c.hidden, fan_in=c.hidden), "bv": zeros(L, c.hidden),
            "wo": w(L, c.hidden, c.hidden, fan_in=c.hidden), "bo": zeros(L, c.hidden),
            "attn_norm_w": ones(L, c.hidden), "attn_norm_b": zeros(L, c.hidden),
            "w1": w(L, c.hidden, c.intermediate, fan_in=c.hidden),
            "b1": zeros(L, c.intermediate),
            "w2": w(L, c.intermediate, c.hidden, fan_in=c.intermediate),
            "b2": zeros(L, c.hidden),
            "mlp_norm_w": ones(L, c.hidden), "mlp_norm_b": zeros(L, c.hidden),
        },
    }


def _layer_norm(x, w, b, eps):
    """Normalize in f32, cast back to the input dtype, then scale and shift
    (the JAX package's cast order)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


@torch.no_grad()
def encode(config: EncoderConfig, params: dict, tokens: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """(B, S) right-padded ids and their (B, S) 1/0 mask → (B, hidden) f32
    sentence embeddings: mean pooling over real tokens, L2-normalised. Keys
    are masked with the f32 minimum, not -inf, so an all-padding row stays
    finite (uniform attention, a zero pooled vector, a guarded norm)."""
    c = config
    B, S = tokens.shape
    head_dim = c.hidden // c.heads
    x = params["tok_embed"][tokens] + params["pos_embed"][None, :S]
    x = _layer_norm(x, params["embed_norm_w"], params["embed_norm_b"], c.norm_eps)
    keep = (mask == 1)[:, None, None, :]
    neg = torch.finfo(torch.float32).min
    lp_all = params["layers"]
    for i in range(c.layers):
        lp = {name: t[i] for name, t in lp_all.items()}

        def heads(w, b):
            return (torch.matmul(x, w) + b).reshape(B, S, c.heads, head_dim)

        q, k, v = heads(lp["wq"], lp["bq"]), heads(lp["wk"], lp["bk"]), heads(lp["wv"], lp["bv"])
        scores = torch.einsum("bqnd,bknd->bnqk", q, k).to(torch.float32)
        scores = torch.where(keep, scores / math.sqrt(head_dim), neg)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(B, S, c.hidden)
        out = torch.matmul(out, lp["wo"]) + lp["bo"]
        x = _layer_norm(x + out, lp["attn_norm_w"], lp["attn_norm_b"], c.norm_eps)
        h = F.gelu(torch.matmul(x, lp["w1"]) + lp["b1"], approximate="tanh")
        h = torch.matmul(h, lp["w2"]) + lp["b2"]
        x = _layer_norm(x + h, lp["mlp_norm_w"], lp["mlp_norm_b"], c.norm_eps)
    m = mask[..., None].to(x.dtype)
    pooled = ((x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)).to(torch.float32)
    return pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-9)


def load_from_sentence_transformers(model_name_or_path: str) -> tuple[EncoderConfig, dict]:
    """MiniLM-L6 weights from a local sentence-transformers directory's
    ``pytorch_model.bin`` (BERT tensor names), as an f32 tree on the CPU;
    nothing is downloaded."""
    path = Path(model_name_or_path)
    if not path.exists():
        raise FileNotFoundError(
            f"no local checkpoint at {model_name_or_path}; download is not "
            f"possible offline"
        )
    state = torch.load(path / "pytorch_model.bin", map_location="cpu", weights_only=True)
    c = EncoderConfig.minilm_l6()

    def get(name):
        return state[name].to(torch.float32)

    names = {  # ours: (BERT name under encoder.layer.{i}., transpose)
        "wq": ("attention.self.query.weight", True),
        "bq": ("attention.self.query.bias", False),
        "wk": ("attention.self.key.weight", True),
        "bk": ("attention.self.key.bias", False),
        "wv": ("attention.self.value.weight", True),
        "bv": ("attention.self.value.bias", False),
        "wo": ("attention.output.dense.weight", True),
        "bo": ("attention.output.dense.bias", False),
        "attn_norm_w": ("attention.output.LayerNorm.weight", False),
        "attn_norm_b": ("attention.output.LayerNorm.bias", False),
        "w1": ("intermediate.dense.weight", True),
        "b1": ("intermediate.dense.bias", False),
        "w2": ("output.dense.weight", True),
        "b2": ("output.dense.bias", False),
        "mlp_norm_w": ("output.LayerNorm.weight", False),
        "mlp_norm_b": ("output.LayerNorm.bias", False),
    }
    layers = {
        ours: torch.stack([
            get(f"encoder.layer.{i}.{bert}").T if t else get(f"encoder.layer.{i}.{bert}")
            for i in range(c.layers)
        ]).contiguous()
        for ours, (bert, t) in names.items()
    }
    params = {
        "tok_embed": get("embeddings.word_embeddings.weight"),
        "pos_embed": get("embeddings.position_embeddings.weight"),
        "embed_norm_w": get("embeddings.LayerNorm.weight"),
        "embed_norm_b": get("embeddings.LayerNorm.bias"),
        "layers": layers,
    }
    return c, params
