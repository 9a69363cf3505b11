"""Ring attention and Ulysses sequence parallelism over ``torch.distributed``
(port of ``langstream_tpu/parallel/ring.py``).

The sequence axis is sharded over the mesh axis ``sp``: each rank holds
``S/n`` tokens, and attention runs as a collective over the ``sp`` group.

- **Ring attention** (:func:`ring_attention`): K/V shards rotate around the
  ring (:meth:`Mesh.permute`, the ``lax.ppermute`` of the JAX package)
  while each rank keeps its Q shard; the softmax is accumulated online
  (running max and running sum), so the ``S x S`` score matrix never
  exists. Step ``s`` accumulates global block ``(idx - s) % n``, then
  rotates; the last block is accumulated without a rotation.
- **Ulysses** (:func:`ulysses_attention`): two all-to-alls re-shard
  sequence to heads, dense attention runs on whole sequences of a share of
  the heads, and one all-to-all re-shards back.

The JAX functions take global tensors under ``shard_map``; these take this
rank's shard, ``(B, S/n, H, D)``, and return its shard of the output. Both
support GQA and causal masking at *global* positions (each rank's block
offset is its index along ``sp``). The JAX ring body is XLA einsums, not a
Pallas kernel, so the products here stay ``torch`` ops, in the JAX
package's f32 arithmetic. Both differentiate: the collectives carry the
gradients back (see :mod:`langstream_tpu_torch.parallel.mesh`), and every
rank runs every rotation's backward, a skipped block's too.
"""

from __future__ import annotations

import math

import torch

#: the score elements one accumulation step holds at once: the query rows
#: of a block are taken in chunks under this budget (each row's arithmetic
#: is the same whatever the chunk), so a long prompt's scores stay bounded
SCORE_BUDGET = 1 << 27


def _axis_or_none(mesh, name: str | None) -> str | None:
    if name is None or mesh is None:
        return None
    return name if name in mesh.axis_names else None


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def _ring_attention_local(
    q: torch.Tensor,  # (B, Sq, H, D) this rank's Q shard
    k: torch.Tensor,  # (B, Sk, Kh, D) this rank's K shard (rotates)
    v: torch.Tensor,  # (B, Sk, Kh, D)
    *,
    mesh,
    axis_name: str,
    causal: bool,
    scale: float,
) -> torch.Tensor:
    """One rank's online-softmax attention over every K/V block as the
    blocks rotate around the ``axis_name`` ring. Every rank makes the same
    transfers on every step; the causal skip skips a future block's
    compute only. The accumulators are made anew at each step (each row
    chunk's ``m``, ``l`` and ``o``, concatenated at the end), so the
    function differentiates; the running max is a stabiliser the output
    does not depend on, so no gradient goes through it."""
    n = mesh.size(axis_name)
    idx = mesh.index(axis_name)
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    dev = q.device
    qg = (q.to(torch.float32) * scale).reshape(B, Sq, Kh, G, D)
    q_pos = idx * Sq + torch.arange(Sq, device=dev)
    neg = torch.tensor(torch.finfo(torch.float32).min, device=dev)

    # per chunk of query rows, accumulators in (B, Kh, G, rows, ...) layout
    rows = max(1, SCORE_BUDGET // max(1, B * H * Sk))
    spans = [(a, min(Sq, a + rows)) for a in range(0, Sq, rows)]
    acc = [(torch.full((B, Kh, G, b - a), neg.item(), dtype=torch.float32, device=dev),
            torch.zeros((B, Kh, G, b - a), dtype=torch.float32, device=dev),
            torch.zeros((B, Kh, G, b - a, D), dtype=torch.float32, device=dev))
           for a, b in spans]

    def accumulate(k_blk, v_blk, s):
        j = (idx - s) % n  # global block index currently held
        kf, vf = k_blk.to(torch.float32), v_blk.to(torch.float32)
        k_pos = j * Sk + torch.arange(Sk, device=dev)
        for c, (a, b) in enumerate(spans):
            m_old, l_old, o_old = acc[c]
            scores = torch.einsum("bqkgd,bskd->bkgqs", qg[:, a:b], kf)
            if causal:
                mask = (q_pos[a:b, None] >= k_pos[None, :])[None, None, None]
                scores = torch.where(mask, scores, neg)
            m_new = torch.maximum(m_old, scores.detach().amax(dim=-1))
            # rows with no valid key yet keep m = neg; exp(neg - neg) would
            # not be 0, so the shift is guarded (the JAX package's order)
            shift = torch.where(m_new <= neg, torch.zeros_like(m_new), m_new)
            p = torch.exp(scores - shift[..., None])
            if causal:
                p = torch.where(mask, p, torch.zeros_like(p))
            alpha = torch.exp(torch.where(m_old <= neg, neg, m_old - shift))
            acc[c] = (m_new, l_old * alpha + p.sum(dim=-1),
                      o_old * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vf))

    def needed(s) -> bool:
        # a block entirely in the future is fully masked: skip its compute
        j = (idx - s) % n
        return not causal or j * Sk <= idx * Sq + Sq - 1

    kv = torch.stack([k, v])
    for s in range(n):
        if needed(s):
            accumulate(kv[0], kv[1], s)
        if s < n - 1:  # n - 1 rotations: the last block stays put
            kv = mesh.permute(kv, axis_name, 1, tag=f"{axis_name}-ring")
    o = torch.cat([o for _, _, o in acc], dim=3)
    l = torch.cat([l for _, l, _ in acc], dim=3)
    out = o / torch.clamp(l, min=1e-30)[..., None]  # (B, Kh, G, Sq, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)
    if n > 1 and not needed(n - 1) and torch.is_grad_enabled() and kv.requires_grad:
        # the last block arrived and was skipped: keep it in the graph at a
        # zero gradient, so this rank runs the rotations' backward with its
        # peers, whose last block was used
        out = _Keep.apply(out, kv)
    return out


class _Keep(torch.autograd.Function):
    """``y`` itself, with ``x`` in the graph at a zero gradient."""

    @staticmethod
    def forward(ctx, y, x):
        ctx.x_shape, ctx.x_dtype, ctx.x_device = x.shape, x.dtype, x.device
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros(ctx.x_shape, dtype=ctx.x_dtype, device=ctx.x_device)


def ring_attention(
    q: torch.Tensor,  # (B, S/n, H, D) this rank's shard
    k: torch.Tensor,  # (B, S/n, Kh, D)
    v: torch.Tensor,  # (B, S/n, Kh, D)
    mesh,
    *,
    causal: bool = True,
    seq_axis: str = "sp",
    head_axis: str | None = "tp",
    batch_axis: str | None = "dp",
    scale: float | None = None,
) -> torch.Tensor:
    """Sequence-parallel attention on this rank's shard: the sequence split
    over ``seq_axis``, the heads this rank holds (its share on
    ``head_axis`` when the caller split them), its rows on ``batch_axis``
    (the caller's split too: ``head_axis`` and ``batch_axis`` name the
    JAX package's layout and change nothing here). Returns this rank's
    ``(B, S/n, H, D)`` output."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sa = _axis_or_none(mesh, seq_axis)
    if sa is None:
        raise ValueError(
            f"mesh {getattr(mesh, 'axis_names', None)} has no sequence axis {seq_axis!r}")
    return _ring_attention_local(q, k, v, mesh=mesh, axis_name=sa, causal=causal,
                                 scale=scale)


# ---------------------------------------------------------------------------
# Ulysses (all-to-all head/sequence re-sharding)
# ---------------------------------------------------------------------------


def dense_attention(q, k, v, *, causal: bool, scale: float, q_offset=0):
    """Dense GQA attention. q: (B, Sq, H, D); k/v: (B, Sk, Kh, D).

    The products take the input dtype's values with f32 accumulation (the
    JAX package's ``preferred_element_type``: inputs widened to f32, whose
    products of bf16 values are exact); the softmax is f32 and its
    probabilities are rounded to the input dtype before the second
    product."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qg = q.reshape(B, Sq, Kh, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        rows = q_offset + torch.arange(Sq, device=q.device)
        mask = rows[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        scores = torch.where(mask[None, None, None], scores,
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", probs.to(q.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _ulysses_local(q, k, v, *, mesh, axis_name: str, causal: bool, scale: float):
    """Re-shard sequence to heads, dense-attend, re-shard back."""
    n = mesh.size(axis_name)
    Kh = k.shape[2]
    if Kh < n:
        # fewer KV heads than ranks: expand the GQA groups so the head
        # all-to-all divides (replicated K/V bandwidth, as in JAX)
        reps = n // Kh
        k = torch.repeat_interleave(k, reps, dim=2)
        v = torch.repeat_interleave(v, reps, dim=2)
    tag = f"{axis_name}-a2a"
    # (B, S/n, H, D) -> (B, S, H/n, D)
    q = mesh.all_to_all(q, axis_name, split_dim=2, concat_dim=1, tag=tag)
    k = mesh.all_to_all(k, axis_name, split_dim=2, concat_dim=1, tag=tag)
    v = mesh.all_to_all(v, axis_name, split_dim=2, concat_dim=1, tag=tag)
    out = dense_attention(q, k, v, causal=causal, scale=scale)
    return mesh.all_to_all(out, axis_name, split_dim=1, concat_dim=2, tag=tag)


def ulysses_attention(
    q: torch.Tensor,  # (B, S/n, H, D) this rank's shard
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    causal: bool = True,
    seq_axis: str = "sp",
    batch_axis: str | None = "dp",
    scale: float | None = None,
) -> torch.Tensor:
    """All-to-all sequence parallelism (Ulysses) on this rank's shard:
    sequence-sharded in and out, dense attention over head-sharded tensors
    in the middle. Requires ``H % sp == 0``; KV heads are group-expanded
    when ``Kh < sp``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sa = _axis_or_none(mesh, seq_axis)
    if sa is None:
        raise ValueError(
            f"mesh {getattr(mesh, 'axis_names', None)} has no sequence axis {seq_axis!r}")
    return _ulysses_local(q, k, v, mesh=mesh, axis_name=sa, causal=causal, scale=scale)
