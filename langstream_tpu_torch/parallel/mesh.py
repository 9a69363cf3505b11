"""Meshes over ``torch.distributed`` (port of ``langstream_tpu/parallel/mesh.py``).

The JAX package lays devices out in a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives. PyTorch runs one process per rank, so here a
:class:`Mesh` is this rank's view of the group: the axis sizes in dict
order, this rank's coordinates (rank ``r`` sits at
``np.unravel_index(r, sizes)``, the JAX layout of ``devices[:total]``) and
one process group per axis (and one over ``ep`` and ``tp`` together, for
the expert FFN's sum). The model code calls the collectives itself, on
the groups: :meth:`Mesh.sum` (an all-reduce), and for sequence parallelism
:meth:`Mesh.permute` (the ring's ``ppermute``), :meth:`Mesh.all_to_all`
(Ulysses) and :meth:`Mesh.all_gather`; the serving tiers move KV rows and
adapter factors with :meth:`Mesh.all_gather` and :meth:`Mesh.broadcast`.

**Gradients.** Every collective carries one back, as ``jax.grad``
transposes the JAX package's: the sum's backward is the identity (its
output is replicated and each rank's loss is the same), :meth:`Mesh.enter`
marks where a replicated tensor enters a rank's own share of the work
(identity forward, a sum backward), a permute's backward is the permute
the other way, an all-to-all's the same exchange, an all-gather's this
rank's slice. The backward's transfers are counted under ``<tag>-bwd``;
under ``no_grad`` nothing is recorded and the serving paths move what they
moved before. :func:`sync_grads` is data parallelism's sum of the
gradients over ``dp`` and ``sp``.

**The backend rule** (:func:`backend_rule`) is explicit, logged and
reported in :meth:`Mesh.describe`: NCCL when every rank of a host has its
own card, gloo when ranks share a card or run on the CPU. Ranks that share
a card are not a fallback: every kernel still runs on the card, and only
the collectives go through the host. The rule reads the devices, never an
exception. Each collective has one route per transport, chosen from the
backend and the tensor's device: NCCL's own op; gloo's CPU op on a CUDA
tensor staged through pinned host memory (gloo on CUDA tensors has only
``all_reduce`` and ``broadcast``); gloo's CPU op on a CPU tensor. Every
group gets a bounded timeout at init (``LS_TORCH_COLLECTIVE_TIMEOUT_S``,
default 120 s), so a dead peer raises inside a collective instead of
hanging it.

**Joining and leaving.** :func:`init_distributed` keeps the coordinator's
``TCPStore`` for the life of the process, so a world that
:func:`shutdown` ended (a barrier, then ``destroy_process_group``) can be
joined again at the same address: every world of a process is one
generation of keys in that store. The ranks need not be started by hand:
an engine whose mesh finds no world starts the missing local ranks itself
(:mod:`langstream_tpu_torch.parallel.launch`, what ``jax.devices()`` gives
a JAX process), and its ``end_world`` reaps them once :func:`shutdown`
has ended the world.

:func:`shard_for_rank` is the counterpart of ``put_global``: every process
holds the full value (the same seed or the same checkpoint on every rank)
and keeps its own slice, the index slices that JAX's
``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the device
at this rank's coordinates.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import logging
import math
import os
import time
import warnings
from typing import Any

import numpy as np
import torch

log = logging.getLogger(__name__)

class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), an axis name,
    or a tuple of axis names (the dimension split over their product, the
    first axis major), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def collective_timeout_s() -> float:
    return float(os.environ.get("LS_TORCH_COLLECTIVE_TIMEOUT_S", "120"))


def backend_rule(device, world_size: int, local_world_size: int | None = None,
                 cards: int | None = None) -> tuple[str, str]:
    """``(backend, reason)`` for ranks on ``device``: ``nccl`` when every rank
    of this host has its own card, ``gloo`` when ranks share a card or run on
    the CPU. ``local_world_size`` is the ranks on this host (default: all of
    them, one host); ``cards`` the cards it has (default: what torch sees)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", "ranks run on the CPU"
    cards = torch.cuda.device_count() if cards is None else cards
    local = local_world_size or world_size
    if cards >= local:
        return "nccl", f"{local} rank(s) on {cards} card(s): one card each"
    return "gloo", (
        f"{local} ranks share {cards} card(s): NCCL refuses two ranks on one "
        f"device, so the collectives go through the host; every kernel still "
        f"runs on the card"
    )


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:{rank % cards}`` for a bare ``cuda``,
    the CPU or an explicit index as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def open_store(host: str, world_size: int, timeout_s: float | None = None) -> str:
    """Host the coordinator's ``TCPStore`` on a port the kernel picks (no
    race between choosing a free port and binding it) and return its
    ``host:port``, which :func:`init_distributed` then joins as rank 0."""
    import torch.distributed as dist

    timeout = datetime.timedelta(
        seconds=timeout_s if timeout_s is not None else collective_timeout_s())
    store = dist.TCPStore(host, 0, world_size, True, timeout=timeout,
                          wait_for_workers=False)
    coordinator = f"{host}:{store.port}"
    _STORE.update(key=(coordinator, world_size, 0), generation=0, store=store)
    return coordinator


def init_distributed(coordinator: str, world_size: int, rank: int, device="cuda",
                     timeout_s: float | None = None,
                     local_world_size: int | None = None) -> str:
    """Join the group at ``coordinator`` (``host:port``) as ``rank`` of
    ``world_size``, with the backend of :func:`backend_rule` for
    ``local_world_size`` ranks on this host (default: ``LOCAL_WORLD_SIZE``,
    else every rank) and a bounded timeout. Returns the backend. A group
    already joined is kept; after :func:`shutdown` the same address is
    joined again (the next world)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    local = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE", "0")) or None
    backend, reason = backend_rule(device, world_size, local)
    log.info("torch.distributed: rank %d/%d joins %s with %s (%s)",
             rank, world_size, coordinator, backend, reason)
    _JOINED["reason"] = reason
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device, rank))
    timeout = datetime.timedelta(
        seconds=timeout_s if timeout_s is not None else collective_timeout_s())
    key = (coordinator, world_size, rank)
    if _STORE.get("key") != key:
        host, port = coordinator.rsplit(":", 1)
        _STORE.update(key=key, generation=0, store=dist.TCPStore(
            host, int(port), world_size, rank == 0, timeout=timeout))
    generation = _STORE["generation"]
    _STORE["generation"] += 1
    dist.init_process_group(
        backend, store=dist.PrefixStore(f"world{generation}/", _STORE["store"]),
        world_size=world_size, rank=rank, timeout=timeout,
    )
    return backend


def shutdown(barrier: bool = True) -> None:
    """End this process's world: a barrier over it (bounded by the
    timeout the world was joined with), then ``destroy_process_group``,
    which ends every group of every mesh made in it. Every rank calls it,
    so none leaves while a peer still talks to it. ``barrier=False`` when
    a peer is known dead (the barrier would only time out). Nothing when
    no group is initialized. A world whose ranks the launcher started ends
    through :func:`langstream_tpu_torch.parallel.launch.end_world`, which
    calls this and then reaps them."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    try:
        if barrier:
            dist.barrier()
    finally:
        dist.destroy_process_group()


#: why :func:`init_distributed` chose the backend of the group it joined
_JOINED: dict[str, str] = {}
#: the coordinator's store, kept across worlds: ``key`` (address, world
#: size, rank), ``store`` and the next world's ``generation``
_STORE: dict[str, Any] = {}


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _tracks(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x`` here."""
    return torch.is_grad_enabled() and x.requires_grad


class _Collective(torch.autograd.Function):
    """A collective with its backward: ``forward(x)`` and ``backward(g)``
    are the mesh's transfers (each one collective over the same group, so
    every rank of the group runs both, in the same order)."""

    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.inverse = backward
        return forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.inverse(g), None, None


def _collective(x: torch.Tensor, forward, backward) -> torch.Tensor:
    """``forward(x)``, recorded with ``backward`` when autograd tracks ``x``
    (a serving call under ``no_grad`` runs the transfer alone)."""
    if _tracks(x):
        return _Collective.apply(x, forward, backward)
    return forward(x)


class Mesh:
    """This rank's view of a device mesh: axis sizes in dict order, its
    coordinates, and its process group over each axis (None where the axis
    has size 1 or the mesh was made without groups, as the tests' meshes of
    a rank that is not running are)."""

    def __init__(self, axis_sizes: dict[str, int], rank: int, world_size: int,
                 backend: str | None = None, reason: str | None = None,
                 groups: dict | None = None):
        self.axis_sizes = dict(axis_sizes)
        self.rank = rank
        self.world_size = world_size
        self.backend = backend
        self.reason = reason
        self._groups = groups or {}
        #: per call site (``tag``): calls, host seconds, bytes summed. Over
        #: gloo on the card the seconds are the collective's alone (the
        #: stream is synchronized first); over NCCL they are the launch
        self.collectives: dict[str, list] = {}
        sizes = tuple(self.axis_sizes.values())
        index = np.unravel_index(rank, sizes) if sizes else ()
        self.coords = {a: int(i) for a, i in zip(self.axis_sizes, index)}

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.axis_sizes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axis_sizes)

    def size(self, *axes: str) -> int:
        """The product of the named axes' sizes (1 for an absent axis)."""
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's index along the named axes together, the first axis
        major (0 on an absent axis)."""
        idx = 0
        for a in axes:
            idx = idx * self.axis_sizes.get(a, 1) + self.coords.get(a, 0)
        return idx

    def group(self, *axes: str):
        """The process group of the ranks that share every coordinate but
        those of ``axes``; None when those axes hold one rank."""
        key = tuple(a for a in self.axis_names if a in axes and self.axis_sizes[a] > 1)
        return self._groups.get(key) if key else None

    def _count(self, tag: str, t0: float, nbytes: int) -> None:
        entry = self.collectives.setdefault(tag, [0, 0.0, 0])
        entry[0] += 1
        entry[1] += time.monotonic() - t0
        entry[2] += nbytes

    def sum(self, x: torch.Tensor, *axes: str, tag: str | None = None) -> torch.Tensor:
        """``x`` summed over ``axes`` (an all-reduce on their group; ``x``
        itself when they hold one rank). Half-precision tensors are summed
        in f32 and rounded once. ``tag`` names the call site in
        :attr:`collectives` (default: the axes). The backward is the
        identity: the output is replicated and every rank computes the same
        loss from it (Megatron's *g*)."""
        if self.group(*axes) is None:
            return x
        tag = tag or "+".join(axes)
        return _collective(x, lambda t: self._all_reduce(t, axes, tag), lambda g: g)

    def enter(self, x: torch.Tensor, *axes: str, tag: str | None = None) -> torch.Tensor:
        """``x`` itself, where a tensor replicated over ``axes`` enters work
        that each of their ranks does on its own share (Megatron's *f*):
        the backward sums the gradient over ``axes``, counted under
        ``<tag>-bwd``. No traffic forward, and none without a gradient."""
        if self.group(*axes) is None or not _tracks(x):
            return x
        tag = f"{tag or '+'.join(axes)}-bwd"
        return _collective(x, lambda t: t.view_as(t),
                           lambda g: self._all_reduce(g, axes, tag))

    def _all_reduce(self, x: torch.Tensor, axes, tag: str) -> torch.Tensor:
        import torch.distributed as dist

        buf = x.to(torch.float32) if x.dtype in (torch.bfloat16, torch.float16) \
            else x.contiguous().clone()
        if buf.is_cuda and self.backend == "gloo":
            # gloo stages a CUDA tensor through the host, which waits for
            # the work queued before it anyway: wait here, so the seconds
            # below are the collective's own and not that work's tail
            torch.cuda.current_stream(buf.device).synchronize()
        t0 = time.monotonic()
        dist.all_reduce(buf, group=self.group(*axes))
        self._count(tag, t0, buf.numel() * buf.element_size())
        return buf.to(x.dtype)

    # -- data movement: bytes only, so every dtype travels every route ----

    def _staged(self, x: torch.Tensor, op) -> torch.Tensor:
        """Run ``op(bytes) -> bytes`` on ``x``'s raw bytes (a flat uint8
        tensor) by its route, and view the result back in ``x``'s dtype
        on ``x``'s device: NCCL's op on the card, gloo's on the CPU, and
        for a CUDA tensor under gloo (which has only ``all_reduce`` and
        ``broadcast`` for them) gloo's CPU op on a pinned host copy."""
        flat = x.contiguous().view(-1).view(torch.uint8)
        if x.is_cuda and self.backend != "nccl":
            torch.cuda.current_stream(x.device).synchronize()
            host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(flat)
            out = op(host).to(x.device)
        else:
            out = op(flat)
        return out.view(x.dtype)

    def permute(self, x: torch.Tensor, axis: str, shift: int = 1,
                tag: str | None = None) -> torch.Tensor:
        """``x`` sent to the rank ``(i + shift) % n`` along ``axis`` and
        the tensor of rank ``(i - shift) % n`` received (``lax.ppermute``
        with the ring's ``perm``); ``x`` itself when the axis holds one
        rank. The backward is the permute by ``-shift``."""
        if self.group(axis) is None or shift % self.size(axis) == 0:
            return x
        tag = tag or f"{axis}-permute"
        return _collective(x, lambda t: self._permute(t, axis, shift, tag),
                           lambda g: self._permute(g, axis, -shift, f"{tag}-bwd"))

    def _permute(self, x: torch.Tensor, axis: str, shift: int, tag: str) -> torch.Tensor:
        import torch.distributed as dist

        group, n = self.group(axis), self.size(axis)
        ranks = dist.get_process_group_ranks(group)  # in axis order
        i = self.index(axis)
        dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
        t0 = time.monotonic()

        def op(flat):
            recv = torch.empty_like(flat)
            for work in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, flat, dst, group=group),
                    dist.P2POp(dist.irecv, recv, src, group=group)]):
                work.wait()
            return recv

        out = self._staged(x, op).view(x.shape)
        self._count(tag, t0, x.numel() * x.element_size())
        return out

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int, concat_dim: int,
                   tag: str | None = None) -> torch.Tensor:
        """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
        ``x`` cut into ``n`` equal parts along ``split_dim``, part ``j`` sent
        to rank ``j`` of ``axis``, the parts received concatenated along
        ``concat_dim`` in rank order. The exchange of the stacked parts is
        its own inverse, so the backward is the same exchange."""
        n = self.size(axis)
        if self.group(axis) is None:
            return x
        if x.shape[split_dim] % n:
            raise ValueError(  # the JAX package's message
                f"The size of all_to_all split_axis ({x.shape[split_dim]}) has to "
                f"be divisible by the size of the named axis {axis} ({n})")
        tag = tag or f"{axis}-a2a"
        parts = torch.stack(x.tensor_split(n, dim=split_dim))  # (n, *part)
        got = _collective(parts, lambda t: self._all_to_all(t, axis, tag),
                          lambda g: self._all_to_all(g, axis, f"{tag}-bwd"))
        return torch.cat(got.unbind(0), dim=concat_dim)

    def _all_to_all(self, parts: torch.Tensor, axis: str, tag: str) -> torch.Tensor:
        import torch.distributed as dist

        t0 = time.monotonic()

        def op(flat):
            recv = torch.empty_like(flat)
            dist.all_to_all_single(recv, flat, group=self.group(axis))
            return recv

        got = self._staged(parts, op).view(parts.shape)
        self._count(tag, t0, parts.numel() * parts.element_size())
        return got

    def all_gather(self, x: torch.Tensor, axis: str, dim: int,
                   tag: str | None = None) -> torch.Tensor:
        """Every rank's ``x`` along ``axis`` concatenated along ``dim`` in
        rank order; ``x`` itself when the axis holds one rank. The backward
        takes this rank's slice of the gradient (the loss downstream is
        replicated over ``axis``)."""
        if self.group(axis) is None:
            return x
        tag = tag or f"{axis}-gather"
        i = self.index(axis)
        got = _collective(x, lambda t: self._all_gather(t, axis, tag), lambda g: g[i])
        return torch.cat(got.unbind(0), dim=dim)

    def _all_gather(self, x: torch.Tensor, axis: str, tag: str) -> torch.Tensor:
        """``(n, *x.shape)``: every rank's ``x`` in rank order."""
        import torch.distributed as dist

        n = self.size(axis)
        t0 = time.monotonic()

        def op(flat):
            out = flat.new_empty((n * flat.numel(),))
            with warnings.catch_warnings():  # renamed in later torch releases
                warnings.simplefilter("ignore", FutureWarning)
                dist.all_gather_into_tensor(out, flat, group=self.group(axis))
            return out

        got = self._staged(x, op).view(n, *x.shape)
        self._count(tag, t0, x.numel() * x.element_size() * n)
        return got

    def broadcast(self, x: torch.Tensor, axis: str | None = None, src: int = 0,
                  tag: str | None = None) -> torch.Tensor:
        """The ``x`` of the rank at index ``src`` along ``axis`` on every
        rank of that axis (``axis`` None: rank ``src`` of the world, to
        every rank); elsewhere ``x`` is only the receive buffer, of the same
        shape and dtype. ``x`` itself when the axis holds one rank. Serving
        only: it records no backward."""
        import torch.distributed as dist

        if axis is None:
            if self.world_size <= 1 or not self._groups:
                return x
            group, root = None, src
        else:
            group = self.group(axis)
            if group is None:
                return x
            root = dist.get_process_group_ranks(group)[src]
        t0 = time.monotonic()

        def op(flat):
            dist.broadcast(flat, src=root, group=group)
            return flat

        out = self._staged(x, op).view(x.shape)
        self._count(tag or f"{axis or 'world'}-broadcast", t0, x.numel() * x.element_size())
        return out

    def dp_rows(self, batch: int) -> tuple[int, int] | None:
        """This rank's rows of a ``batch`` split over ``dp``; None when the
        mesh has no ``dp`` or the batch does not divide (replicated)."""
        n = self.size("dp")
        if n <= 1 or batch % n:
            return None
        step = batch // n
        lo = self.index("dp") * step
        return lo, lo + step

    def replica(self) -> "Mesh":
        """This rank's view without ``dp``: the mesh of one data-parallel
        replica, which the model code runs on (the engine hands each replica
        its own slots' rows and sums the outputs over ``dp``). Shares the
        groups and the collective counters."""
        view = copy.copy(self)
        view.axis_sizes = {a: n for a, n in self.axis_sizes.items() if a != "dp"}
        view.coords = {a: i for a, i in self.coords.items() if a != "dp"}
        return view

    def describe(self) -> dict[str, Any]:
        return {"axes": dict(self.axis_sizes), "rank": self.rank,
                "world-size": self.world_size, "coords": dict(self.coords),
                "backend": self.backend, "backend-reason": self.reason,
                "collectives": {tag: {"calls": n, "seconds": round(sec, 6), "bytes": b}
                                for tag, (n, sec, b) in self.collectives.items()}}

    def __repr__(self) -> str:
        return f"Mesh({self.axis_sizes}, rank={self.rank})"


def mesh_axes(mesh: Mesh | None) -> tuple[str, ...]:
    return tuple(mesh.axis_names) if mesh is not None else ()


def _group_keys(axis_sizes: dict[str, int]) -> list[tuple[str, ...]]:
    """The axis sets that get a process group: each axis of size > 1 (``sp``
    for the ring, Ulysses and the sequence gathers), ``ep`` with ``tp``
    for the expert FFN's sum, and ``dp`` with ``sp`` for the gradients'
    sum (:func:`sync_grads`) and a training loss's."""
    names = [a for a, n in axis_sizes.items() if n > 1]
    keys = [(a,) for a in names]
    for pair in (("ep", "tp"), ("dp", "sp")):
        if all(a in names for a in pair):
            keys.append(tuple(a for a in names if a in pair))
    return keys


def _make_groups(axis_sizes: dict[str, int], rank: int, timeout_s: float) -> dict:
    """Every rank creates every group in the same order (``new_group`` is
    collective over the world); each keeps the ones it belongs to."""
    import torch.distributed as dist

    sizes = tuple(axis_sizes.values())
    names = tuple(axis_sizes)
    coords = [np.unravel_index(r, sizes) for r in range(math.prod(sizes))]
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}
    for key in _group_keys(axis_sizes):
        others = [i for i, a in enumerate(names) if a not in key]
        members: dict[tuple, list[int]] = {}
        for r, c in enumerate(coords):
            members.setdefault(tuple(int(c[i]) for i in others), []).append(r)
        for ranks in members.values():
            group = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                groups[key] = group
    return groups


def resolve_axes(axis_sizes: dict[str, int], world: int) -> dict[str, int]:
    """``axis_sizes`` with its one ``-1`` axis (if any) given every rank of
    ``world`` the other axes leave."""
    axis_sizes = dict(axis_sizes)
    wildcard = [k for k, v in axis_sizes.items() if v == -1]
    if wildcard:
        if len(wildcard) > 1:
            raise ValueError("only one axis may be -1")
        known = math.prod(v for v in axis_sizes.values() if v != -1)
        axis_sizes[wildcard[0]] = world // known
    return axis_sizes


def make_mesh(axis_sizes: dict[str, int] | None = None, *,
              world_size: int | None = None, rank: int | None = None,
              groups: bool = True, timeout_s: float | None = None) -> Mesh:
    """Build this rank's mesh from axis sizes, e.g. ``{"dp": 2, "tp": 4}``.

    A size of ``-1`` on exactly one axis means "all remaining ranks". Axis
    order follows dict order; put ``tp`` last so its ranks are neighbours.
    The product of the sizes must equal the world size. ``world_size`` and
    ``rank`` default to the joined group's (1 and 0 without one);
    ``groups=False`` makes the coordinates only (a rank that is not
    running, in tests)."""
    joined_world, joined_rank = _world()
    world = joined_world if world_size is None else world_size
    me = joined_rank if rank is None else rank
    axis_sizes = resolve_axes(axis_sizes or {"tp": world}, world)
    total = math.prod(axis_sizes.values())
    if total > world:
        raise ValueError(
            f"mesh {axis_sizes} needs {total} devices, have {world}"
        )
    if total != world:
        raise ValueError(
            f"mesh {axis_sizes} spans {total} ranks but the world has {world}: "
            f"one process per rank, so the product of the axis sizes must equal "
            f"the world size"
        )
    backend = reason = None
    made: dict = {}
    if groups and world > 1:
        import torch.distributed as dist

        backend = dist.get_backend()
        reason = _JOINED.get("reason") or f"{backend}: a group joined by the caller"
        made = _make_groups(axis_sizes, me,
                            timeout_s if timeout_s is not None else collective_timeout_s())
        log.info("mesh %s: rank %d at %s over %s", axis_sizes, me,
                 dict(zip(axis_sizes, np.unravel_index(me, tuple(axis_sizes.values())))),
                 backend)
    return Mesh(axis_sizes, me, world, backend, reason, made)


def local_mesh(tp: int | None = None, dp: int = 1, sp: int = 1) -> Mesh:
    """Convenience mesh over the world: ``(dp, sp, tp)``."""
    n, _ = _world()
    if tp is None:
        tp = n // (dp * sp)
    return make_mesh({"dp": dp, "sp": sp, "tp": tp})


# ---------------------------------------------------------------------------
# a rank's slice of a full tensor
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_slices(shape, spec, mesh: Mesh) -> tuple[slice, ...]:
    """The index slices of this rank's shard of a ``shape`` tensor under
    ``spec``: dimension ``i`` splits into ``mesh.size(*axes)`` equal parts
    and the rank takes part ``mesh.index(*axes)``."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        axes = _entry_axes(entry)
        parts = mesh.size(*axes)
        if dim % parts:
            raise ValueError(
                f"dimension of size {dim} does not split over {axes} ({parts} ranks)"
            )
        step = dim // parts
        lo = mesh.index(*axes) * step
        out.append(slice(lo, lo + step))
    return tuple(out)


def local_shape(shape, spec, mesh: Mesh) -> tuple[int, ...]:
    return tuple(s.stop - s.start for s in shard_slices(shape, spec, mesh))


def shard_for_rank(tensor: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the full ``tensor`` under ``spec``, as a tensor
    of its own (the full one can be freed)."""
    view = tensor
    for dim, s in enumerate(shard_slices(tensor.shape, spec, mesh)):
        if s.stop - s.start != tensor.shape[dim]:
            view = view.narrow(dim, s.start, s.stop - s.start)
    return view.clone(memory_format=torch.contiguous_format) if view is not tensor else tensor


def shard_tree(tree, specs, mesh: Mesh):
    """:func:`shard_for_rank` over a parameter tree and its spec tree (a
    quantized leaf takes a ``QTensor`` of specs, see ``quantize_specs``)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, q=shard_for_rank(tree.q, specs.q, mesh),
                                   s=shard_for_rank(tree.s, specs.s, mesh))
    return shard_for_rank(tree, specs, mesh)


def sync_grads(params, specs, mesh: Mesh) -> None:
    """Data parallelism's all-reduce, once before the update: the gradient
    of every leaf of ``params`` that neither ``dp`` nor ``sp`` shards under
    its spec in ``specs`` is summed over those of the two the mesh has
    (each rank's gradient holds its own rows' and positions' share; GSPMD
    gives the JAX package the same sum), counted under ``grads``. Leaves
    without a gradient are left alone."""
    if isinstance(params, dict):
        for name, leaf in params.items():
            sync_grads(leaf, specs[name], mesh)
        return
    if not isinstance(params, torch.Tensor) or params.grad is None:
        return
    named = {a for entry in specs for a in _entry_axes(entry)}
    axes = tuple(a for a in ("dp", "sp") if a not in named)
    if mesh.group(*axes) is not None:
        with torch.no_grad():
            params.grad = mesh.sum(params.grad, *axes, tag="grads")
