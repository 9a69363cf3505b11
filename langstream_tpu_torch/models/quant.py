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


def quantize_specs(specs, params):
    """Lift a PartitionSpec tree over a (partially) quantized param tree.

    Each QTensor leaf's spec ``P`` becomes ``QTensor(q=P, s=P')`` where
    ``P'`` drops the mesh axis on dimensions the scale reduces to size 1:
    the scale is replicated along the contraction axis, which is the axis
    TP row-sharding splits. Column-sharded weights keep the axis: their
    scales are per-output-channel and shard with the outputs."""
    from langstream_tpu_torch.parallel.mesh import P

    if isinstance(params, dict):
        return {k: quantize_specs(specs[k], v) for k, v in params.items()}
    if not isinstance(params, QTensor):
        return specs
    entries = list(specs) + [None] * (params.q.dim() - len(specs))
    s_entries = [None if params.s.shape[i] == 1 else entries[i]
                 for i in range(params.q.dim())]
    return QTensor(q=specs, s=P(*s_entries), dtype=params.dtype)


def quantize_tensor(w: torch.Tensor, axis: int) -> QTensor:
    """Symmetric per-channel int8: scale reduces over ``axis`` (the
    contraction dimension of the matmul that consumes ``w``)."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, s=scale, dtype=w.dtype)


def quantize_stacked(w: torch.Tensor, axis: int) -> QTensor:
    """:func:`quantize_tensor` of a stacked ``(L, ...)`` weight, one layer
    at a time (the same numbers; the f32 transient is one layer's)."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty(w.shape[:axis] + (1,) + w.shape[axis + 1:], dtype=torch.float32,
                    device=w.device)
    for i in range(w.shape[0]):
        t = quantize_tensor(w[i], axis=axis - 1)
        q[i], s[i] = t.q, t.s
    return QTensor(q=q, s=s, dtype=w.dtype)


#: the contraction axis each quantized leaf of a Llama tree reduces over
#: (by dotted path; the norms are absent: they stay as they are).
#: Projections contract the middle axis of their stacked ``(L, in, out)``
#: layout; embed is gathered per row; lm_head contracts hidden
LLAMA_QUANT_AXES = {"embed": 1, "lm_head": 0, **{
    f"layers.{name}": 1 for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}}
#: the MoE tree's: attention, embed and LM head as Llama's; experts per
#: (layer, expert, output column), contracting axis 2 of ``(L, E, in,
#: out)``; the router stays float32
MOE_QUANT_AXES = {**{k: v for k, v in LLAMA_QUANT_AXES.items()
                     if k not in ("layers.w_gate", "layers.w_up", "layers.w_down")},
                  "layers.w_gate": 2, "layers.w_up": 2, "layers.w_down": 2}


def quantize_leaf(path: str, w, axes: dict):
    """The leaf at ``path`` as its tree's quantizer leaves it: stacked
    layer weights one layer at a time (:func:`quantize_stacked`), the
    others whole, leaves absent from ``axes`` (and quantized ones) as
    they are."""
    axis = axes.get(path)
    if axis is None or isinstance(w, QTensor):
        return w
    return quantize_stacked(w, axis) if path.startswith("layers.") else quantize_tensor(w, axis)


def _quantize_tree(params: dict, axes: dict, prefix: str = "") -> dict:
    return {k: (_quantize_tree(v, axes, f"{prefix}{k}.") if isinstance(v, dict)
                else quantize_leaf(prefix + k, v, axes))
            for k, v in params.items()}


def quantize_llama_params(params: dict) -> dict:
    """Quantize every matmul weight of a Llama param tree
    (:data:`LLAMA_QUANT_AXES`); norms stay as they are."""
    return _quantize_tree(params, LLAMA_QUANT_AXES)


def quantize_moe_params(params: dict) -> dict:
    """MoE twin of :func:`quantize_llama_params` (:data:`MOE_QUANT_AXES`):
    one layer at a time, so the f32 transient is one layer's experts."""
    return _quantize_tree(params, MOE_QUANT_AXES)


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


def _q8_attention(c, generator, device, put) -> dict:
    """A layer stack's attention projections, quantized per output column."""
    L, Hd = c.layers, c.hidden
    qkv_dim = c.heads * c.head_dim
    kv_dim = c.kv_heads * c.head_dim
    return {
        "wq": put("layers.wq", _q8_stacked(L, Hd, qkv_dim, Hd, c.dtype, generator, device)),
        "wk": put("layers.wk", _q8_stacked(L, Hd, kv_dim, Hd, c.dtype, generator, device)),
        "wv": put("layers.wv", _q8_stacked(L, Hd, kv_dim, Hd, c.dtype, generator, device)),
        "wo": put("layers.wo", _q8_stacked(L, qkv_dim, Hd, qkv_dim, c.dtype, generator,
                                           device)),
    }


def init_llama_params_q8(config, generator: torch.Generator | None = None,
                         device="cuda", place=None) -> dict:
    """Random-init Llama params already weight-quantized: the same tree,
    shapes and scale layout as ``quantize_llama_params(init_llama_params(c))``,
    but the peak during init is the int8 tree plus ONE chunk's f32
    transient (one layer's ``(in, out)`` matrix, or 1/32 of the vocab),
    never the full-precision tree. Runs on ``device``: the card unless the
    caller asks for the CPU. ``place`` as in ``init_llama_params`` (with
    it the peak is the kept tree plus one full int8 leaf)."""
    device = require_device(device, "init_llama_params_q8")
    c = config
    L, Hd, I = c.layers, c.hidden, c.intermediate
    put = place or (lambda path, leaf: leaf)

    def ones(path, *shape):
        return put(path, torch.ones(shape, dtype=c.dtype, device=device))

    embed = put("embed", _q8_embed(c, generator, device))
    layers = {
        "attn_norm": ones("layers.attn_norm", L, Hd),
        **_q8_attention(c, generator, device, put),
        "mlp_norm": ones("layers.mlp_norm", L, Hd),
        "w_gate": put("layers.w_gate", _q8_stacked(L, Hd, I, Hd, c.dtype, generator, device)),
        "w_up": put("layers.w_up", _q8_stacked(L, Hd, I, Hd, c.dtype, generator, device)),
        "w_down": put("layers.w_down", _q8_stacked(L, I, Hd, I, c.dtype, generator, device)),
    }
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": ones("final_norm", Hd),
        "lm_head": put("lm_head", _q8_lm_head(c, generator, device)),
    }


def init_moe_params_q8(config, generator: torch.Generator | None = None,
                       device="cuda", place=None) -> dict:
    """MoE twin of :func:`init_llama_params_q8`: the tree of
    ``quantize_moe_params(init_moe_params(c))``, experts made one ``(in,
    out)`` f32 chunk per (layer, expert) on ``device`` (a Mixtral-8x7B
    expert chunk is 235 MB; the stacked f32 tensor would be 60 GB). The
    router stays float32, unquantized. ``place`` as in
    ``init_llama_params``."""
    device = require_device(device, "init_moe_params_q8")
    c = config
    L, E, Hd, I = c.layers, c.experts, c.hidden, c.moe_intermediate
    put = place or (lambda path, leaf: leaf)

    def ones(path, *shape):
        return put(path, torch.ones(shape, dtype=c.dtype, device=device))

    def experts(path, rows, cols, fan_in) -> QTensor:
        # (L*E) chunks -> (L, E, rows, cols), scales (L, E, 1, cols): the
        # layout of quantize_tensor(axis=2)
        w = _q8_stacked(L * E, rows, cols, fan_in, c.dtype, generator, device)
        return put(path, QTensor(q=w.q.view(L, E, rows, cols),
                                 s=w.s.view(L, E, 1, cols), dtype=c.dtype))

    embed = put("embed", _q8_embed(c, generator, device))
    layers = {
        "attn_norm": ones("layers.attn_norm", L, Hd),
        **_q8_attention(c, generator, device, put),
        "mlp_norm": ones("layers.mlp_norm", L, Hd),
        "router": put("layers.router", torch.randn(
            (L, Hd, E), generator=generator, device=device,
            dtype=torch.float32) * (1.0 / math.sqrt(Hd))),
        "w_gate": experts("layers.w_gate", Hd, I, Hd),
        "w_up": experts("layers.w_up", Hd, I, Hd),
        "w_down": experts("layers.w_down", I, Hd, I),
    }
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": ones("final_norm", Hd),
        "lm_head": put("lm_head", _q8_lm_head(c, generator, device)),
    }
