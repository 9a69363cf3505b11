"""Pipeline parallelism: the GPipe schedule over the ``pp`` mesh axis, with
its backward (port of ``langstream_tpu/parallel/pipeline.py``).

- The stacked layer tensors ``(L, ...)`` shard their layer axis over
  ``pp`` (:func:`pp_layer_specs`): each rank (stage) holds ``L/pp``
  contiguous layers. Weights never move, activations do.
- :func:`gpipe` runs the JAX package's schedule: at tick ``t`` stage ``s``
  runs microbatch ``t - s``, and one hand-off per tick sends each stage's
  output to stage ``(s + 1) % pp`` (:meth:`Mesh.permute`). The JAX package
  runs it under ``shard_map`` manual over ``pp``; here every rank runs its
  own stage, and ``tp``/``ep`` work inside a stage calls its collectives
  as the serving paths do.
- Training: every collective carries its gradient back (see
  :mod:`langstream_tpu_torch.parallel.mesh`). A backward collective pairs
  up only if every rank of its group runs it, in the same order, so no
  received tensor may drop out of a rank's graph: the schedule selects
  with ``torch.where`` on a tensor condition, as the JAX package computes
  and masks (stage 0's delivery, the bubble's ticks, the outputs only the
  last stage retires), and every rank's graph has the same shape. The
  last tick's hand-off would reach no one and is not made.
- The bubble is ``(pp - 1) / (M + pp - 1)`` of the ticks.

Under ``dp`` each replica runs its share of every microbatch's rows. A
JAX microbatch is ``B/M`` consecutive rows of the whole batch, and the
MoE routes, caps and balances per microbatch, so the replicas route
together (``moe_ffn``'s ``route_axis``); the logits are gathered over
``dp`` and every rank returns the whole batch's, as the JAX package's
``out_specs=P()`` does.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from langstream_tpu_torch.parallel.mesh import P, shard_tree
from langstream_tpu_torch.parallel.ring import dense_attention


def gpipe(stage_fn, x_microbatches: torch.Tensor, mesh, axis: str = "pp"):
    """Run the GPipe schedule on this rank's stage. ``x_microbatches``
    ``(M, mb, ...)`` is replicated over ``axis``; ``stage_fn(x)`` applies
    this stage's layers to one microbatch and returns ``(activations,
    aux)`` (aux a f32 scalar, e.g. the MoE load-balancing loss of the
    stage's layers). Returns the processed microbatches, on every stage
    (the last stage's, summed over ``axis`` in f32), and the aux summed
    over the valid ticks and the stages."""
    pp, s = mesh.size(axis), mesh.index(axis)
    M = x_microbatches.shape[0]
    T = M + pp - 1  # total ticks (the (pp-1)/(M+pp-1) bubble)
    dev = x_microbatches.device
    first = torch.tensor(s == 0, device=dev)
    last = torch.tensor(s == pp - 1, device=dev)
    # stage s holds a real microbatch only at ticks with 0 <= t - s < M
    valid = torch.tensor([0 <= t - s < M for t in range(T)], device=dev)
    buf = torch.zeros_like(x_microbatches[0])
    outs = [torch.zeros_like(x_microbatches[0])] * M
    aux_acc = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(T):
        # stage 0 feeds microbatch t; later stages consume the previous
        # tick's delivery (stage s sees microbatch t - s)
        inp = torch.where(first, x_microbatches[min(t, M - 1)], buf)
        y, aux = stage_fn(inp)
        aux_acc = aux_acc + torch.where(valid[t], aux, torch.zeros_like(aux))
        if t >= pp - 1:  # the last stage retires microbatch t - (pp - 1)
            outs[t - pp + 1] = torch.where(last, y, outs[t - pp + 1])
        if t < T - 1:
            buf = mesh.permute(y, axis, 1, tag=f"{axis}-handoff")
    # results live on the last stage (the others hold zeros): the sum
    # hands them to every stage, so the head and the loss run everywhere
    out = mesh.sum(torch.stack(outs).to(torch.float32), axis, tag=f"{axis}-out")
    aux_total = mesh.sum(aux_acc.reshape(1), axis, tag=f"{axis}-aux").reshape(())
    return out.to(x_microbatches.dtype), aux_total


def pp_layer_specs(layer_specs: dict) -> dict:
    """Put ``pp`` on the stacked layer axis of each per-layer spec (e.g.
    ``P(None, None, 'tp')`` -> ``P('pp', None, 'tp')``)."""
    return {name: pp_layer_specs(spec) if isinstance(spec, dict) else P("pp", *spec[1:])
            for name, spec in layer_specs.items()}


def pp_param_specs(config, mesh) -> dict:
    """The spec tree a rank of a pipeline holds its parameters under: the
    model's specs as ``mesh`` serves them (``rank_specs``), the layers' on
    ``pp`` too."""
    from langstream_tpu_torch.models.llama import llama_param_specs, rank_specs
    from langstream_tpu_torch.models.moe import moe_param_specs

    specs = moe_param_specs(config) if hasattr(config, "experts") else llama_param_specs(config)
    specs = rank_specs(specs, config, mesh)
    return {**specs, "layers": pp_layer_specs(specs["layers"])}


def shard_pp_params(params: dict, config, mesh) -> dict:
    """This rank's shards of the full ``params`` under
    :func:`pp_param_specs` (its ``L/pp`` layers)."""
    from langstream_tpu_torch.models.quant import quantize_specs

    return shard_tree(params, quantize_specs(pp_param_specs(config, mesh), params), mesh)


def _pipeline(config, params: dict, tokens: torch.Tensor, mesh, M: int, layer_fn):
    """Embed, :func:`gpipe` over the stage's layers, head: the whole batch's
    ``(B, S, V)`` f32 logits on every rank, and the aux total.
    ``layer_fn(c, x, lp, cos, sin, attention)`` runs one layer and returns
    ``(x, aux)``."""
    from langstream_tpu_torch.models.llama import (
        _rms_norm,
        _rope,
        embed_tokens,
        lm_logits,
        local_config,
    )
    from langstream_tpu_torch.models.quant import as_weight

    B, S = tokens.shape
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    mb, dp = B // M, mesh.size("dp")
    if mb % dp:
        raise ValueError(f"microbatch of {mb} rows does not split over dp={dp}")
    c = local_config(config, mesh)
    rows = mb // dp
    lo = mesh.index("dp") * rows
    x = embed_tokens(c, params["embed"], tokens.reshape(M, mb, S)[:, lo:lo + rows])
    # f32 across the stage boundary, as in the JAX package; the input is
    # replicated over pp, so its gradient is summed there
    x = mesh.enter(x.to(torch.float32), "pp", tag="pp-in")
    positions = torch.arange(S, device=tokens.device)[None, :].expand(rows, S)
    cos, sin = _rope(positions, c.head_dim, c.rope_theta)
    attention = partial(dense_attention, causal=True, scale=1.0 / math.sqrt(c.head_dim))
    layers = params["layers"]
    depth = next(iter(layers.values())).shape[0]

    def stage(xm: torch.Tensor):
        h = xm.to(c.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=xm.device)
        for i in range(depth):
            h, a = layer_fn(c, h, {k: w[i] for k, w in layers.items()}, cos, sin, attention)
            aux = aux + a
        return h.to(torch.float32), aux

    out, aux = gpipe(stage, x, mesh)
    out = _rms_norm(out, params["final_norm"], c.norm_eps)
    # the JAX package's head multiplies the f32 activations by the head
    # promoted to f32
    logits = lm_logits(c, out, as_weight(params["lm_head"]).to(out.dtype))
    logits = mesh.all_gather(logits, "dp", dim=1, tag="dp-logits")  # (M, mb, S, V)
    return logits.reshape(B, S, -1), aux


def llama_forward_pp(config, params: dict, tokens: torch.Tensor, mesh,
                     num_microbatches: int = 4) -> torch.Tensor:
    """Pipeline-parallel all-position logits ``(B, S, V)`` f32 on every
    rank. ``config`` is the model's, ``params`` this rank's shards
    (:func:`shard_pp_params`): its ``L/pp`` layers, ``tp`` shards inside
    them. The embed and head run outside the stages; the stages' attention
    is dense and causal (the JAX package's ``_causal_attention``)."""
    from langstream_tpu_torch.models.llama import _rms_norm, attention_block, ffn_for

    def layer(c, x, lp, cos, sin, attention):
        x = attention_block(c, x, lp, cos, sin, attention)
        h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
        return x + ffn_for(c, None)(h2, lp), torch.zeros((), device=x.device)

    return _pipeline(config, params, tokens, mesh, num_microbatches, layer)[0]


def moe_forward_pp(config, params: dict, tokens: torch.Tensor, mesh,
                   num_microbatches: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Pipeline-parallel MoE forward: ``pp`` stages over the layers, expert
    parallelism (``ep``) and ``tp`` inside each stage. Returns ``(logits
    (B, S, V) f32, aux)`` on every rank; as in the JAX package, each
    microbatch routes with its own capacity, ``capacity((B // M) * S)``,
    and the aux is the stages' and microbatches' total over ``M``."""
    from langstream_tpu_torch.models.llama import _rms_norm, attention_block
    from langstream_tpu_torch.models.moe import moe_ffn
    from langstream_tpu_torch.models.quant import as_weight

    B, S = tokens.shape
    M = num_microbatches

    def layer(c, x, lp, cos, sin, attention):
        x = attention_block(c, x, lp, cos, sin, attention)
        h2 = _rms_norm(x, lp["mlp_norm"], c.norm_eps)
        ffn, aux = moe_ffn(h2, lp["router"], as_weight(lp["w_gate"]), as_weight(lp["w_up"]),
                           as_weight(lp["w_down"]), config.capacity((B // M) * S), mesh=mesh,
                           route_axis="dp")
        return x + ffn, aux

    logits, aux = _pipeline(config, params, tokens, mesh, M, layer)
    return logits, aux / M
