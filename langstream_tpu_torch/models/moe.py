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

**Expert parallelism** (:func:`moe_param_specs`, :func:`shard_moe_params`,
``moe_serving_ffn(mesh=)``): each rank holds ``E/ep`` experts with their
intermediate split on ``tp``. Routing and capacity are computed the same
on every rank (the activations are replicated over ``ep``), each rank
computes only its own experts' combine terms, and one sum over the ``ep``
and ``tp`` groups adds them, which keeps the global-capacity semantics of
:func:`top2_routing` exactly. The JAX package's all-to-alls become that
one sum.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch
import torch.nn.functional as F

from langstream_tpu_torch._device import require_device
from typing import Any

from langstream_tpu_torch.models.llama import (
    _apply_rope,
    _out_proj,
    _qkv,
    _rms_norm,
    _rope,
    embed_tokens,
    layer_params,
    lm_logits,
    local_config,
    rank_specs,
)
from langstream_tpu_torch.models.quant import as_weight, quantize_specs
from langstream_tpu_torch.ops.flash_attention import flash_attention_reference
from langstream_tpu_torch.parallel.mesh import P, shard_tree


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
    #: this rank's shard under a mesh (see ``models.llama.local_config``)
    shard: Any = dataclasses.field(default=None, compare=False, repr=False)

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
                    device="cuda", place=None) -> dict:
    """Random-init params on ``device`` (the card unless the caller asks for
    the CPU; the generator must live there): the Llama layout plus a
    float32 ``router`` ``(L, hidden, E)`` and stacked experts ``w_gate``/
    ``w_up`` ``(L, E, hidden, I)`` and ``w_down`` ``(L, E, I, hidden)``.
    The numbers differ from the JAX package's for the same seed; tests
    carry parameters across with ``params_from_numpy``. ``place`` as in
    ``init_llama_params``."""
    device = require_device(device, "init_moe_params")
    c = config
    qkv_dim = c.heads * c.head_dim
    kv_dim = c.kv_heads * c.head_dim
    L, E, I = c.layers, c.experts, c.moe_intermediate
    put = place or (lambda path, leaf: leaf)

    def norm_init(path, *shape):
        return put(path, torch.ones(shape, dtype=c.dtype, device=device))

    def normal(*shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return w * (1.0 / math.sqrt(fan_in))

    def w_init(path, *shape, fan_in):
        return put(path, normal(*shape, fan_in=fan_in).to(c.dtype))

    return {
        "embed": w_init("embed", c.vocab_size, c.hidden, fan_in=c.hidden),
        "layers": {
            "attn_norm": norm_init("layers.attn_norm", L, c.hidden),
            "wq": w_init("layers.wq", L, c.hidden, qkv_dim, fan_in=c.hidden),
            "wk": w_init("layers.wk", L, c.hidden, kv_dim, fan_in=c.hidden),
            "wv": w_init("layers.wv", L, c.hidden, kv_dim, fan_in=c.hidden),
            "wo": w_init("layers.wo", L, qkv_dim, c.hidden, fan_in=qkv_dim),
            "mlp_norm": norm_init("layers.mlp_norm", L, c.hidden),
            # float32: routing decisions are numerically delicate
            "router": put("layers.router", normal(L, c.hidden, E, fan_in=c.hidden)),
            "w_gate": w_init("layers.w_gate", L, E, c.hidden, I, fan_in=c.hidden),
            "w_up": w_init("layers.w_up", L, E, c.hidden, I, fan_in=c.hidden),
            "w_down": w_init("layers.w_down", L, E, I, c.hidden, fan_in=I),
        },
        "final_norm": norm_init("final_norm", c.hidden),
        "lm_head": w_init("lm_head", c.hidden, c.vocab_size, fan_in=c.hidden),
    }


def moe_param_specs(config: MoEConfig) -> dict:
    """Expert axis on ``ep``, Megatron TP inside each expert."""
    return {
        "embed": P(None, None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": P(None, None, "tp"),
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "mlp_norm": P(None, None),
            "router": P(None, None, None),
            "w_gate": P(None, "ep", None, "tp"),
            "w_up": P(None, "ep", None, "tp"),
            "w_down": P(None, "ep", "tp", None),
        },
        "final_norm": P(None),
        "lm_head": P(None, "tp"),
    }


def shard_moe_params(params: dict, config: MoEConfig, mesh) -> dict:
    """This rank's shards of the full ``params`` (int8 trees too)."""
    specs = rank_specs(moe_param_specs(config), config, mesh)
    return shard_tree(params, quantize_specs(specs, params), mesh)


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
    mesh=None,
):
    """Top-2 MoE feed-forward in index form; returns ``(output (B, S, H),
    aux_loss)``. The combine weights are cast to ``x``'s dtype, as the JAX
    package casts its combine tensor, and the two weighted expert outputs
    sum in f32.

    Under a ``mesh`` the expert weights are this rank's: ``E/ep`` experts
    from ``mesh.index("ep") * E/ep`` on, their intermediate split on
    ``tp``. The routing is the whole batch's, the same on every rank; the
    rank keeps only the choices that land on its experts and the f32 sum of
    every rank's terms over ``ep`` and ``tp`` is the output."""
    B, S, H = x.shape
    N = B * S
    E_local = w_gate.shape[0]
    lo = 0 if mesh is None else mesh.index("ep") * E_local
    xf = x.reshape(N, H)
    logits = xf.to(torch.float32) @ router_w
    experts, slots, weights, aux = top2_routing(
        logits, capacity, None if valid is None else valid.reshape(N))
    mine = slots < capacity
    if mesh is not None:
        mine = mine & (experts >= lo) & (experts < lo + E_local)
    # row e*C + slot of the expert-major buffer; E*C is the thrown-away row
    rows = torch.where(mine, (experts - lo) * capacity + slots,
                       torch.full_like(slots, E_local * capacity))
    xe = x.new_zeros((E_local * capacity + 1, H))
    xe.index_copy_(0, rows[:, 0], xf)
    xe.index_copy_(0, rows[:, 1], xf)
    xe = xe[:-1].view(E_local, capacity, H)
    gate = F.silu(torch.bmm(xe, w_gate))
    up = torch.bmm(xe, w_up)
    ye = torch.bmm(gate * up, w_down).view(E_local * capacity, H)
    # a dropped (or another rank's) choice gathers some row with weight 0
    y = ye[rows.clamp(max=E_local * capacity - 1)]
    if mesh is not None:
        weights = torch.where(mine, weights, torch.zeros_like(weights))
    w = weights.to(x.dtype).to(torch.float32)
    out = (w[..., None] * y.to(torch.float32)).sum(dim=1)
    if mesh is not None:
        out = mesh.sum(out, "ep", "tp")
    return out.to(x.dtype).view(B, S, H), aux


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


def moe_serving_ffn(config: MoEConfig, mesh=None):
    """The FFN hook of the Llama serving paths (``ffn=`` on the prefill,
    continuation, decode and verify entry points): routes each position
    through the top-2 expert mix. Takes ``(B, H)`` decode activations with
    a ``(B,)`` active mask or ``(B, S, H)`` prefill activations with a
    ``(B, S)`` real-token mask, and int8 expert weights (dequantized per
    layer by ``as_weight``, as the JAX package does). Capacity follows the
    batch's padded shape: ``B`` is the slot count in decode. Under a
    ``mesh`` the layer's experts are this rank's (see :func:`moe_ffn`)."""

    def ffn(h: torch.Tensor, lp: dict, valid: torch.Tensor | None = None) -> torch.Tensor:
        squeeze = h.dim() == 2
        x = h[:, None, :] if squeeze else h
        if valid is not None and valid.dim() == 1:
            valid = valid[:, None]  # decode: (B,) active -> (B, 1)
        B, S, _ = x.shape
        out, _aux = moe_ffn(
            x, lp["router"], as_weight(lp["w_gate"]), as_weight(lp["w_up"]),
            as_weight(lp["w_down"]), config.capacity(B * S), valid=valid, mesh=mesh,
        )
        return out[:, 0, :] if squeeze else out

    return ffn


def moe_forward(config: MoEConfig, params: dict, tokens: torch.Tensor,
                *, attention=None, mesh=None):
    """All-position logits ``(B, S, V)`` f32 and the summed aux loss, no KV
    cache. ``attention(q, k, v)`` defaults to dense causal attention
    (:func:`~langstream_tpu_torch.ops.flash_attention.flash_attention_reference`,
    the JAX package's default ``dense_attention``); every position is a
    real token. Under a ``mesh``, ``config`` is this rank's local config
    and ``params`` its shards (:func:`moe_forward_sharded`)."""
    c = config
    B, S = tokens.shape
    if attention is None:
        attention = partial(flash_attention_reference, causal=True)
    capacity = c.capacity(B * S)
    x = embed_tokens(c, params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = _rope(positions, c.head_dim, c.rope_theta)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in range(c.layers):
        lp = layer_params(params, layer)
        h = _rms_norm(x, lp["attn_norm"], c.norm_eps)
        q, k, v = _qkv(c, h, lp)
        out = attention(_apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v)
        x = x + _out_proj(out.reshape(B, S, c.heads * c.head_dim), lp, None, c)
        h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
        ffn, aux = moe_ffn(
            h2, lp["router"], as_weight(lp["w_gate"]), as_weight(lp["w_up"]),
            as_weight(lp["w_down"]), capacity, mesh=mesh,
        )
        x = x + ffn
        aux_total = aux_total + aux
    x = _rms_norm(x, params["final_norm"], c.norm_eps)
    return lm_logits(c, x, params["lm_head"]), aux_total


def moe_forward_sharded(config: MoEConfig, params: dict, tokens: torch.Tensor,
                        mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE forward on this rank: ``params`` the full tree (this rank
    keeps its shards, :func:`shard_moe_params`), attention per rank over
    its heads on ``tp``, the experts on ``ep``; every rank returns the
    whole batch's logits and the aux loss."""
    local = local_config(config, mesh)
    return moe_forward(local, shard_moe_params(params, config, mesh), tokens,
                       mesh=mesh)


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
