"""Mixture-of-Experts decoder, Mixtral family (port of
``langstream_tpu/models/moe.py``).

The attention blocks, caches and serving paths are the Llama ones: the MoE
family plugs its routed FFN into them through the ``ffn=`` hook of every
model entry point (:func:`moe_serving_ffn`). Routing is GShard top-2 with a
static per-expert capacity: each token's two winners are renormalised,
tokens rank within an expert by their flattened ``(B*S)`` order with every
first choice ahead of every second choice, and tokens past the capacity
fall through the residual.

The JAX package dispatches with one-hot ``(B*S, E, C)`` einsums and lets
XLA fuse them. Eager PyTorch would materialise them (10.7 GB per f32
tensor at 8 prompts of 4,096 tokens on Mixtral-8x7B), so :func:`moe_ffn`
computes the same routing in index form (:func:`top2_routing`): each
choice's slot in its expert's queue from a cumsum, a scatter into an
``(E, C, H)`` buffer with dropped tokens sent to a row that is thrown away,
one ``bmm`` per projection over the experts, and a gather weighted back.
:func:`top2_gating` keeps the one-hot form as the plain version the tests
hold the index form to. No routing step reads a device value on the host
or takes a shape from the data.

Not here: ``moe_param_specs``, ``shard_moe_params`` and
``moe_forward_sharded`` (multi-GPU, ROADMAP.md Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch
import torch.nn.functional as F

from langstream_tpu_torch._device import require_device
from langstream_tpu_torch.models.llama import (
    _apply_rope,
    _qkv,
    _rms_norm,
    _rope,
    layer_params,
)
from langstream_tpu_torch.models.quant import as_weight, embedding_take
from langstream_tpu_torch.ops.flash_attention import flash_attention_reference


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    head_dim: int = 128
    moe_intermediate: int = 14336
    experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    rope_theta: float = 1000000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def mixtral_8x7b(cls, max_seq_len: int = 4096) -> "MoEConfig":
        return cls(max_seq_len=max_seq_len)

    @classmethod
    def tiny(cls, max_seq_len: int = 128) -> "MoEConfig":
        return cls(
            vocab_size=384, hidden=64, layers=2, heads=4, kv_heads=2,
            head_dim=16, moe_intermediate=128, experts=4,
            experts_per_token=2, max_seq_len=max_seq_len,
        )

    def capacity(self, tokens: int) -> int:
        """Static per-expert capacity for a batch of ``tokens`` (padding
        included: the caller passes the padded batch's ``B*S``)."""
        return max(
            1,
            int(math.ceil(
                self.experts_per_token * tokens * self.capacity_factor / self.experts
            )),
        )


def init_moe_params(config: MoEConfig, generator: torch.Generator | None = None,
                    device="cuda") -> dict:
    """Random-init params on ``device`` (the card unless the caller asks for
    the CPU; the generator must live there): the Llama layout plus a
    float32 ``router`` ``(L, hidden, E)`` and stacked experts ``w_gate``/
    ``w_up`` ``(L, E, hidden, I)`` and ``w_down`` ``(L, E, I, hidden)``.
    The numbers differ from the JAX package's for the same seed; tests
    carry parameters across with ``params_from_numpy``."""
    device = require_device(device, "init_moe_params")
    c = config
    qkv_dim = c.heads * c.head_dim
    kv_dim = c.kv_heads * c.head_dim
    L, E, I = c.layers, c.experts, c.moe_intermediate

    def norm_init(*shape):
        return torch.ones(shape, dtype=c.dtype, device=device)

    def normal(*shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w * (1.0 / math.sqrt(fan_in))

    def w_init(*shape, fan_in):
        return normal(*shape, fan_in=fan_in).to(c.dtype)

    return {
        "embed": w_init(c.vocab_size, c.hidden, fan_in=c.hidden),
        "layers": {
            "attn_norm": norm_init(L, c.hidden),
            "wq": w_init(L, c.hidden, qkv_dim, fan_in=c.hidden),
            "wk": w_init(L, c.hidden, kv_dim, fan_in=c.hidden),
            "wv": w_init(L, c.hidden, kv_dim, fan_in=c.hidden),
            "wo": w_init(L, qkv_dim, c.hidden, fan_in=qkv_dim),
            "mlp_norm": norm_init(L, c.hidden),
            # float32: routing decisions are numerically delicate
            "router": normal(L, c.hidden, E, fan_in=c.hidden),
            "w_gate": w_init(L, E, c.hidden, I, fan_in=c.hidden),
            "w_up": w_init(L, E, c.hidden, I, fan_in=c.hidden),
            "w_down": w_init(L, E, I, c.hidden, fan_in=I),
        },
        "final_norm": norm_init(c.hidden),
        "lm_head": w_init(c.hidden, c.vocab_size, fan_in=c.hidden),
    }


# ---------------------------------------------------------------------------
# top-2 gating
# ---------------------------------------------------------------------------


def _top2_choices(probs: torch.Tensor, valid: torch.Tensor | None):
    """The two winners of each row of ``probs`` (N, E) and their
    renormalised weights, as the JAX package computes them: the first
    index on ties (``argmax``, never ``topk``), an invalid row's
    probabilities 0. Returns (idx1, idx2, w1, w2)."""
    idx1 = torch.argmax(probs, dim=-1)
    idx2 = torch.argmax(probs.scatter(-1, idx1[:, None], 0.0), dim=-1)
    p1 = torch.gather(probs, -1, idx1[:, None])[:, 0]
    p2 = torch.gather(probs, -1, idx2[:, None])[:, 0]
    if valid is not None:
        p1 = torch.where(valid, p1, torch.zeros_like(p1))
        p2 = torch.where(valid, p2, torch.zeros_like(p2))
    denom = p1 + p2 + 1e-9
    return idx1, idx2, p1 / denom, p2 / denom


def _aux_loss(first_mask: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """GShard/Switch load-balancing loss: E * sum_e fraction_e * mean_prob_e,
    halved over the two choices (first choices only in the fraction)."""
    E = probs.shape[-1]
    density = first_mask.to(probs.dtype).mean(dim=0)
    return torch.sum(density * probs.mean(dim=0)) * (E * E) / 2.0


def top2_routing(
    router_logits: torch.Tensor,       # (N, E) float32, N = B*S flattened
    capacity: int,
    valid: torch.Tensor | None = None,  # (N,) bool
):
    """Top-2 gating in index form (the main path). Returns ``(experts (N, 2)
    long, slots (N, 2) long, weights (N, 2) f32, aux_loss)``: each token's
    two experts, its place in each one's queue (``capacity`` when dropped,
    or when the token is invalid) and its combine weight (0 when dropped).
    Places come from a cumsum over the flattened order, second choices
    after all of an expert's first choices; invalid tokens take no place."""
    N, E = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    idx1, idx2, w1, w2 = _top2_choices(probs, valid)
    experts_ar = torch.arange(E, device=probs.device)
    m1 = (idx1[:, None] == experts_ar).to(torch.int64)
    m2 = (idx2[:, None] == experts_ar).to(torch.int64)
    if valid is not None:
        m1 = m1 * valid[:, None]
        m2 = m2 * valid[:, None]
    rank1 = torch.gather(torch.cumsum(m1, dim=0), 1, idx1[:, None])[:, 0] - 1
    rank2 = (torch.gather(torch.cumsum(m2, dim=0), 1, idx2[:, None])[:, 0] - 1
             + m1.sum(dim=0)[idx2])
    keep1 = (rank1 < capacity) & (m1.sum(dim=1) > 0)
    keep2 = (rank2 < capacity) & (m2.sum(dim=1) > 0)
    dropped = torch.full_like(rank1, capacity)
    experts = torch.stack([idx1, idx2], dim=1)
    slots = torch.stack([torch.where(keep1, rank1, dropped),
                         torch.where(keep2, rank2, dropped)], dim=1)
    weights = torch.stack([torch.where(keep1, w1, torch.zeros_like(w1)),
                           torch.where(keep2, w2, torch.zeros_like(w2))], dim=1)
    return experts, slots, weights, _aux_loss(m1, probs)


def top2_gating(
    router_logits: torch.Tensor,       # (B, S, E) float32
    capacity: int,
    valid: torch.Tensor | None = None,  # (B, S) bool
):
    """GShard top-2 gating in the JAX package's one-hot form (the plain
    version of :func:`top2_routing`; only the tests call it). Returns
    ``(dispatch (B, S, E, C) bool, combine (B, S, E, C) f32, aux_loss)``.
    ``valid`` keeps right-padded prefill positions and inactive decode
    slots out of expert capacity."""
    B, S, E = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1).reshape(B * S, E)
    flat_valid = None if valid is None else valid.reshape(B * S)
    idx1, idx2, w1, w2 = _top2_choices(probs, flat_valid)
    flat1 = F.one_hot(idx1, E).to(probs.dtype)
    flat2 = F.one_hot(idx2, E).to(probs.dtype)
    if flat_valid is not None:
        flat1 = flat1 * flat_valid[:, None].to(probs.dtype)
        flat2 = flat2 * flat_valid[:, None].to(probs.dtype)
    pos1 = torch.cumsum(flat1, dim=0) * flat1 - flat1
    pos2 = (torch.cumsum(flat2, dim=0) + flat1.sum(dim=0, keepdim=True)) * flat2 - flat2
    keep1 = (pos1 < capacity) & (flat1 > 0)
    keep2 = (pos2 < capacity) & (flat2 > 0)
    # a place past the capacity one-hots to zeros, as in jax.nn.one_hot
    oh1 = F.one_hot(pos1.long().clamp(max=capacity), capacity + 1)[..., :capacity]
    oh2 = F.one_hot(pos2.long().clamp(max=capacity), capacity + 1)[..., :capacity]
    combine = (
        w1[:, None, None] * keep1[..., None] * oh1.to(probs.dtype)
        + w2[:, None, None] * keep2[..., None] * oh2.to(probs.dtype)
    ).reshape(B, S, E, capacity)
    return combine > 0.0, combine, _aux_loss(flat1, probs)


# ---------------------------------------------------------------------------
# the routed FFN
# ---------------------------------------------------------------------------


def moe_ffn(
    x: torch.Tensor,          # (B, S, H)
    router_w: torch.Tensor,   # (H, E) float32
    w_gate: torch.Tensor,     # (E, H, I)
    w_up: torch.Tensor,       # (E, H, I)
    w_down: torch.Tensor,     # (E, I, H)
    capacity: int,
    valid: torch.Tensor | None = None,  # (B, S) bool — see top2_gating
):
    """Top-2 MoE feed-forward in index form; returns ``(output (B, S, H),
    aux_loss)``. The combine weights are cast to ``x``'s dtype, as the JAX
    package casts its combine tensor, and the two weighted expert outputs
    sum in f32."""
    B, S, H = x.shape
    N = B * S
    E = router_w.shape[1]
    xf = x.reshape(N, H)
    logits = xf.to(torch.float32) @ router_w
    experts, slots, weights, aux = top2_routing(
        logits, capacity, None if valid is None else valid.reshape(N))
    # row e*C + slot of the expert-major buffer; E*C is the thrown-away row
    rows = torch.where(slots < capacity, experts * capacity + slots,
                       torch.full_like(slots, E * capacity))
    xe = x.new_zeros((E * capacity + 1, H))
    xe.index_copy_(0, rows[:, 0], xf)
    xe.index_copy_(0, rows[:, 1], xf)
    xe = xe[:-1].view(E, capacity, H)
    gate = F.silu(torch.bmm(xe, w_gate))
    up = torch.bmm(xe, w_up)
    ye = torch.bmm(gate * up, w_down).view(E * capacity, H)
    # a dropped choice gathers some row with weight 0
    y = ye[rows.clamp(max=E * capacity - 1)]
    w = weights.to(x.dtype).to(torch.float32)
    out = (w[..., None] * y.to(torch.float32)).sum(dim=1).to(x.dtype)
    return out.view(B, S, H), aux


def moe_ffn_reference(x, router_w, w_gate, w_up, w_down, capacity, valid=None):
    """:func:`moe_ffn` through the one-hot dispatch and combine of
    :func:`top2_gating`, the JAX package's einsums (the plain version the
    tests hold :func:`moe_ffn` to)."""
    logits = torch.einsum("bsh,he->bse", x.to(torch.float32), router_w)
    dispatch, combine, aux = top2_gating(logits, capacity, valid=valid)
    xe = torch.einsum("bsec,bsh->ech", dispatch.to(x.dtype), x)
    gate = F.silu(torch.einsum("ech,ehi->eci", xe, w_gate))
    up = torch.einsum("ech,ehi->eci", xe, w_up)
    ye = torch.einsum("eci,eih->ech", gate * up, w_down)
    return torch.einsum("bsec,ech->bsh", combine.to(x.dtype), ye), aux


def moe_serving_ffn(config: MoEConfig):
    """The FFN hook of the Llama serving paths (``ffn=`` on the prefill,
    continuation, decode and verify entry points): routes each position
    through the top-2 expert mix. Takes ``(B, H)`` decode activations with
    a ``(B,)`` active mask or ``(B, S, H)`` prefill activations with a
    ``(B, S)`` real-token mask, and int8 expert weights (dequantized per
    layer by ``as_weight``, as the JAX package does). Capacity follows the
    batch's padded shape: ``B`` is the slot count in decode."""

    def ffn(h: torch.Tensor, lp: dict, valid: torch.Tensor | None = None) -> torch.Tensor:
        squeeze = h.dim() == 2
        x = h[:, None, :] if squeeze else h
        if valid is not None and valid.dim() == 1:
            valid = valid[:, None]  # decode: (B,) active -> (B, 1)
        B, S, _ = x.shape
        out, _aux = moe_ffn(
            x, lp["router"], as_weight(lp["w_gate"]), as_weight(lp["w_up"]),
            as_weight(lp["w_down"]), config.capacity(B * S), valid=valid,
        )
        return out[:, 0, :] if squeeze else out

    return ffn


def moe_forward(config: MoEConfig, params: dict, tokens: torch.Tensor,
                *, attention=None):
    """All-position logits ``(B, S, V)`` f32 and the summed aux loss, no KV
    cache. ``attention(q, k, v)`` defaults to dense causal attention
    (:func:`~langstream_tpu_torch.ops.flash_attention.flash_attention_reference`,
    the JAX package's default ``dense_attention``); every position is a
    real token."""
    c = config
    B, S = tokens.shape
    if attention is None:
        attention = partial(flash_attention_reference, causal=True)
    capacity = c.capacity(B * S)
    x = embedding_take(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = _rope(positions, c.head_dim, c.rope_theta)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in range(c.layers):
        lp = layer_params(params, layer)
        h = _rms_norm(x, lp["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, h, lp)
        out = attention(_apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v)
        x = x + out.reshape(B, S, c.heads * c.head_dim) @ as_weight(lp["wo"])
        h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
        ffn, aux = moe_ffn(
            h2, lp["router"], as_weight(lp["w_gate"]), as_weight(lp["w_up"]),
            as_weight(lp["w_down"]), capacity,
        )
        x = x + ffn
        aux_total = aux_total + aux
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    logits = (x @ as_weight(params["lm_head"])).to(torch.float32)
    return logits, aux_total


def moe_param_count(config: MoEConfig) -> int:
    """Parameters of the model: attention, router, every expert and the two
    norms per layer, embedding and LM head, the final norm."""
    c = config
    attn = (
        c.hidden * c.heads * c.head_dim
        + 2 * c.hidden * c.kv_heads * c.head_dim
        + c.heads * c.head_dim * c.hidden
    )
    experts = c.experts * 3 * c.hidden * c.moe_intermediate
    per_layer = attn + experts + c.hidden * c.experts + 2 * c.hidden
    return c.layers * per_layer + 2 * c.vocab_size * c.hidden + c.hidden
