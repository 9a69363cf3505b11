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
from typing import Any

import torch
import torch.nn.functional as F

from langstream_tpu_torch._device import require_device
from langstream_tpu_torch.models.quant import as_weight as _w, embedding_take
from langstream_tpu_torch.ops.flash_attention import flash_attention
from langstream_tpu_torch.parallel.mesh import P, shard_tree


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
    #: this rank's :class:`RankShard` under a mesh (see :func:`local_config`)
    shard: Any = dataclasses.field(default=None, compare=False, repr=False)

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
                      device="cuda", place=None) -> dict:
    """Random-init params (stacked per-layer leading dim L) on ``device``
    (the card unless the caller asks for the CPU; the generator must live
    on the same device). The numbers differ from the JAX package's init
    for the same seed: the two RNGs differ, so tests carry parameters
    across with ``params_from_numpy``. ``place(path, leaf)`` takes each
    leaf as it is made (``path`` dotted, e.g. ``layers.wq``) and returns
    what the tree keeps (a rank's shard: the full leaf is freed before the
    next is drawn; the draws are the same)."""
    device = require_device(device, "init_llama_params")
    c = config
    qkv_dim = c.heads * c.head_dim
    kv_dim = c.kv_heads * c.head_dim
    L = c.layers
    put = place or (lambda path, leaf: leaf)

    def norm_init(path, *shape):
        return put(path, torch.ones(shape, dtype=c.dtype, device=device))

    def w_init(path, *shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return put(path, (w * (1.0 / math.sqrt(fan_in))).to(c.dtype))

    return {
        "embed": w_init("embed", c.vocab_size, c.hidden, fan_in=c.hidden),
        "layers": {
            "attn_norm": norm_init("layers.attn_norm", L, c.hidden),
            "wq": w_init("layers.wq", L, c.hidden, qkv_dim, fan_in=c.hidden),
            "wk": w_init("layers.wk", L, c.hidden, kv_dim, fan_in=c.hidden),
            "wv": w_init("layers.wv", L, c.hidden, kv_dim, fan_in=c.hidden),
            "wo": w_init("layers.wo", L, qkv_dim, c.hidden, fan_in=qkv_dim),
            "mlp_norm": norm_init("layers.mlp_norm", L, c.hidden),
            "w_gate": w_init("layers.w_gate", L, c.hidden, c.intermediate,
                             fan_in=c.hidden),
            "w_up": w_init("layers.w_up", L, c.hidden, c.intermediate, fan_in=c.hidden),
            "w_down": w_init("layers.w_down", L, c.intermediate, c.hidden,
                             fan_in=c.intermediate),
        },
        "final_norm": norm_init("final_norm", c.hidden),
        "lm_head": w_init("lm_head", c.hidden, c.vocab_size, fan_in=c.hidden),
    }


def layer_params(params: dict, layer: int) -> dict:
    """One layer's slice of the stacked weights (views, no copies)."""
    return {name: w[layer] for name, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# tensor parallelism: specs, a rank's config and its collectives
# ---------------------------------------------------------------------------


def llama_param_specs(config: LlamaConfig) -> dict:
    """PartitionSpecs per param (Megatron TP over axis ``tp``)."""
    return {
        "embed": P("tp", None),          # vocab-sharded
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, "tp"),   # column (heads)
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),   # row
            "mlp_norm": P(None, None),
            "w_gate": P(None, None, "tp"),
            "w_up": P(None, None, "tp"),
            "w_down": P(None, "tp", None),
        },
        "final_norm": P(None),
        "lm_head": P(None, "tp"),        # vocab-sharded logits
    }


#: the attention block's weights, replicated over tp where the KV heads
#: do not split
ATTENTION_WEIGHTS = ("wq", "wk", "wv", "wo")


def attention_splits(config, tp: int) -> bool:
    """Whether the attention heads split over ``tp`` ranks: both the query
    and the KV heads must divide (the JAX read wrappers' rule)."""
    return tp > 1 and config.heads % tp == 0 and config.kv_heads % tp == 0


def rank_specs(specs: dict, config, mesh) -> dict:
    """``specs`` as this mesh serves them: the attention weights replicated
    over ``tp`` when :func:`attention_splits` says no."""
    if attention_splits(config, mesh.size("tp")) or "tp" not in mesh.axis_names:
        return specs
    layers = dict(specs["layers"])
    for name in ATTENTION_WEIGHTS:
        layers[name] = P(*(None if e == "tp" else e for e in layers[name]))
    return {**specs, "layers": layers}


def shard_llama_params(params: dict, config: LlamaConfig, mesh) -> dict:
    """This rank's shards of the full ``params`` (int8 trees too)."""
    from langstream_tpu_torch.models.quant import quantize_specs

    specs = rank_specs(llama_param_specs(config), config, mesh)
    return shard_tree(params, quantize_specs(specs, params), mesh)


def kv_cache_spec(mesh_axes: tuple[str, ...]):
    """Cache (L, slots, S, kv_heads, head_dim): slots on dp, kv heads on tp."""
    dp = "dp" if "dp" in mesh_axes else None
    tp = "tp" if "tp" in mesh_axes else None
    return P(None, dp, None, tp, None)


@dataclasses.dataclass(frozen=True, eq=False)
class RankShard:
    """What a rank's local config needs of the mesh: the mesh itself, and
    whether the attention heads and the rest (FFN intermediate, vocab)
    split over ``tp``."""

    mesh: Any
    attention: bool
    tp: bool


def local_config(config, mesh):
    """This rank's config under ``mesh``: ``heads``/``kv_heads`` divided by
    ``tp`` where :func:`attention_splits`, the FFN intermediate divided by
    ``tp``, and ``shard`` set. The vocab and the experts keep their global
    counts (the embedding, the LM head and the expert FFN read their
    shards' offsets from the mesh)."""
    tp = mesh.size("tp")
    inter = "moe_intermediate" if hasattr(config, "moe_intermediate") else "intermediate"
    for name, value in (("vocab_size", config.vocab_size), (inter, getattr(config, inter))):
        if value % tp:
            raise ValueError(f"{name} {value} does not split over tp={tp}")
    attention = attention_splits(config, tp)
    changes = {inter: getattr(config, inter) // tp,
               "shard": RankShard(mesh, attention, tp > 1)}
    if attention:
        changes.update(heads=config.heads // tp, kv_heads=config.kv_heads // tp)
    return dataclasses.replace(config, **changes)


def embed_tokens(c, embed, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings; vocab-parallel under tp (this rank's rows of
    the table, a masked lookup, then a sum over ``tp``)."""
    if c.shard is None or not c.shard.tp:
        return embedding_take(embed, tokens)
    rows = (embed.q if hasattr(embed, "q") else embed).shape[0]
    lo = c.shard.mesh.index("tp") * rows
    local = tokens.to(torch.long) - lo
    mine = (local >= 0) & (local < rows)
    x = embedding_take(embed, local.clamp(0, rows - 1))
    x = x * mine[..., None].to(x.dtype)
    return c.shard.mesh.sum(x, "tp", tag="embed")


def lm_logits(c, x: torch.Tensor, lm_head, tag: str = "logits") -> torch.Tensor:
    """f32 logits over the whole vocab; under tp each rank's vocab columns
    are gathered into every rank (a sum of zero-padded shards; ``tag``
    names the call site in the mesh's collective counters)."""
    logits = (x @ _w(lm_head)).to(torch.float32)
    if c.shard is None or not c.shard.tp:
        return logits
    V = logits.shape[-1]
    full = logits.new_zeros(logits.shape[:-1] + (c.vocab_size,))
    lo = c.shard.mesh.index("tp") * V
    full[..., lo:lo + V] = logits
    return c.shard.mesh.sum(full, "tp", tag=tag)


def tp_sum(c, y: torch.Tensor, attention: bool = False) -> torch.Tensor:
    """A row-parallel product's partial sums added over ``tp`` (the
    attention block's only when its heads split)."""
    shard = c.shard
    if shard is None or not (shard.attention if attention else shard.tp):
        return y
    return shard.mesh.sum(y, "tp")


def attention_prefill(c, q, k, v) -> torch.Tensor:
    """Causal prefill attention: the flash kernel on this rank's heads."""
    return flash_attention(q, k, v, causal=True)


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


def ffn_for(c, ffn):
    """The FFN a model entry point runs: ``ffn`` when given (the MoE FFN
    sums its own shards), else the dense SwiGLU, its row-parallel
    ``w_down`` summed over ``tp`` under a mesh."""
    if ffn is not None:
        return ffn
    if c.shard is None or not c.shard.tp:
        return _default_ffn
    return lambda h, lp, valid=None: tp_sum(c, _default_ffn(h, lp, valid))


def _qkv(c: LlamaConfig, h: torch.Tensor, lp: dict, ad=None):
    """Projections reshaped to (..., heads|kv_heads, head_dim). ``ad`` is
    one layer's ``(ids, factors)`` from :func:`adapter_layer`: each
    projection then gains its per-slot :func:`lora_delta` before the
    reshape, as in the JAX package."""
    lead = h.shape[:-1]
    q = h @ _w(lp["wq"])
    k = h @ _w(lp["wk"])
    v = h @ _w(lp["wv"])
    if ad is not None:
        ids, al = ad
        q = q + lora_delta(h, ids, al["wq_a"], al["wq_b"])
        k = k + lora_delta(h, ids, al["wk_a"], al["wk_b"])
        v = v + lora_delta(h, ids, al["wv_a"], al["wv_b"])
    return (q.reshape(*lead, c.heads, c.head_dim),
            k.reshape(*lead, c.kv_heads, c.head_dim),
            v.reshape(*lead, c.kv_heads, c.head_dim))


def _out_proj(out: torch.Tensor, lp: dict, ad=None, c=None) -> torch.Tensor:
    """The attention output projection ``out @ wo``, plus the per-slot
    ``wo`` delta when ``ad`` is given (added before the residual, as in the
    JAX package); under a mesh (``c.shard``) the row-parallel partial sums
    are added over ``tp``."""
    attn = out @ _w(lp["wo"])
    if ad is not None:
        ids, al = ad
        attn = attn + lora_delta(out, ids, al["wo_a"], al["wo_b"])
    return attn if c is None else tp_sum(c, attn, attention=True)


# ---------------------------------------------------------------------------
# batched ragged LoRA (Punica/S-LoRA-style adapter gather)
# ---------------------------------------------------------------------------


def lora_delta(h: torch.Tensor, ids: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Per-slot low-rank delta ``h @ A[id] @ B[id]`` for one projection.

    ``a``/``b`` are one layer's slices of the stacked adapter buffers,
    ``(n_rows, d_in, rank)`` / ``(n_rows, rank, d_out)``, and ``ids`` is
    the per-row ``(B,)`` row index; ``h`` is ``(B, d_in)`` or ``(B, P,
    d_in)``. Row 0 is all zeros, so adapter-less rows get an exact zero
    and a batch of mixed adapters is one gather and two batched products
    (the rows are data, not structure). The LoRA alpha/rank scale is
    folded into B at publish time (``serving/adapters.py``)."""
    a_sel = a.index_select(0, ids)  # (B, d_in, rank)
    b_sel = b.index_select(0, ids)  # (B, rank, d_out)
    if h.dim() == 2:
        return torch.bmm(torch.bmm(h[:, None, :], a_sel), b_sel)[:, 0]
    return torch.bmm(torch.bmm(h, a_sel), b_sel)


def adapter_layer(adapters: dict | None, layer: int):
    """One layer's ``(ids, factors)`` of an ``adapters`` argument
    (``{"ids": (B,) int64, "layers": {wq_a: (L, N, d_in, r), ...}}``), as
    :func:`_qkv` and :func:`_out_proj` take it; None without adapters."""
    if adapters is None:
        return None
    return adapters["ids"], {k: v[layer] for k, v in adapters["layers"].items()}


# ---------------------------------------------------------------------------
# prefill / forward
# ---------------------------------------------------------------------------


def prefill_forward(
    config: LlamaConfig,
    params: dict,
    tokens: torch.Tensor,   # (B, P) int, right-padded
    lengths: torch.Tensor,  # (B,) true lengths
    ffn=None,               # (h (B,P,H), lp, valid (B,P)) -> (B,P,H); default SwiGLU
    adapters: dict | None = None,  # batched ragged LoRA, see adapter_layer
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared prompt forward: returns (last-token logits (B, V) f32, ks, vs)
    where ks/vs are the roped per-layer K/V ``(L, B, P, Kh, D)``.

    Causality alone hides right-padded keys from every real query row, so
    the attention needs no per-row length; padded rows' outputs are
    garbage the caller discards. The FFN hook gets the (B, P) real-token
    mask. ``adapters`` adds each row's LoRA deltas to the q/k/v/o
    projections (None: no delta is computed)."""
    c = config
    ffn = ffn_for(c, ffn)
    B, Pn = tokens.shape
    x = embed_tokens(c, params["embed"], tokens)  # (B, P, H)
    positions = torch.arange(Pn, device=tokens.device)[None, :].expand(B, Pn)
    cos, sin = _rope(positions, c.head_dim, c.rope_theta)
    pos_valid = positions < lengths.to(torch.long)[:, None]
    ks, vs = [], []
    for layer in range(c.layers):
        lp = layer_params(params, layer)
        ad = adapter_layer(adapters, layer)
        h = _rms_norm(x, lp["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, h, lp, ad)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        out = attention_prefill(c, q, k, v)
        x = x + _out_proj(out.reshape(B, Pn, c.heads * c.head_dim), lp, ad, c)
        h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
        x = x + ffn(h2, lp, pos_valid)
        ks.append(k)
        vs.append(v)
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    rows = torch.arange(B, device=tokens.device)
    last = x[rows, (lengths.to(torch.long) - 1).clamp(min=0)]
    logits = lm_logits(c, last, params["lm_head"])
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
    ffn = ffn_for(c, ffn)
    B, S = tokens.shape
    x = embed_tokens(c, params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = _rope(positions, c.head_dim, c.rope_theta)
    for layer in range(c.layers):
        lp = layer_params(params, layer)
        h = _rms_norm(x, lp["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, h, lp)
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        out = attention_prefill(c, q, k, v)
        x = x + _out_proj(out.reshape(B, S, c.heads * c.head_dim), lp, None, c)
        h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
        x = x + ffn(h2, lp)
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    return lm_logits(c, x, params["lm_head"])
