"""Meshes over ``torch.distributed`` (port of ``langstream_tpu/parallel/mesh.py``).

The JAX package lays devices out in a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives. PyTorch runs one process per rank, so here a
:class:`Mesh` is this rank's view of the group: the axis sizes in dict
order, this rank's coordinates (rank ``r`` sits at
``np.unravel_index(r, sizes)``, the JAX layout of ``devices[:total]``) and
one process group per axis (and one over ``ep`` and ``tp`` together, for
the expert FFN's sum). The model code calls the collectives itself, on
the groups: :meth:`Mesh.sum` is the only one the port needs, and
``broadcast`` the only other one the lockstep plane could use, because the
backend table of ``torch.distributed`` lists only these two for gloo on
CUDA tensors.

**The backend rule** (:func:`backend_rule`) is explicit, logged and
reported in :meth:`Mesh.describe`: NCCL when every rank of a host has its
own card, gloo when ranks share a card or run on the CPU. Ranks that share
a card are not a fallback: every kernel still runs on the card, and only
the collectives go through the host. The rule reads the devices, never an
exception. Every group gets a bounded timeout at init
(``LS_TORCH_COLLECTIVE_TIMEOUT_S``, default 120 s), so a dead peer raises
inside a collective instead of hanging it.

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


def init_distributed(coordinator: str, world_size: int, rank: int, device="cuda",
                     timeout_s: float | None = None) -> str:
    """Join the group at ``tcp://coordinator`` (``host:port``) as ``rank`` of
    ``world_size``, with the backend of :func:`backend_rule` and a bounded
    timeout. Returns the backend. A group already joined is kept."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0")) or None
    backend, reason = backend_rule(device, world_size, local)
    log.info("torch.distributed: rank %d/%d joins %s with %s (%s)",
             rank, world_size, coordinator, backend, reason)
    _JOINED["reason"] = reason
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device, rank))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(
            seconds=timeout_s if timeout_s is not None else collective_timeout_s()),
    )
    return backend


#: why :func:`init_distributed` chose the backend of the group it joined
_JOINED: dict[str, str] = {}


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


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

    def sum(self, x: torch.Tensor, *axes: str, tag: str | None = None) -> torch.Tensor:
        """``x`` summed over ``axes`` (an all-reduce on their group; ``x``
        itself when they hold one rank). Half-precision tensors are summed
        in f32 and rounded once. ``tag`` names the call site in
        :attr:`collectives` (default: the axes)."""
        group = self.group(*axes)
        if group is None:
            return x
        import torch.distributed as dist

        buf = x.to(torch.float32) if x.dtype in (torch.bfloat16, torch.float16) \
            else x.contiguous().clone()
        if buf.is_cuda and self.backend == "gloo":
            # gloo stages a CUDA tensor through the host, which waits for
            # the work queued before it anyway: wait here, so the seconds
            # below are the collective's own and not that work's tail
            torch.cuda.current_stream(buf.device).synchronize()
        t0 = time.monotonic()
        dist.all_reduce(buf, group=group)
        entry = self.collectives.setdefault(tag or "+".join(axes), [0, 0.0, 0])
        entry[0] += 1
        entry[1] += time.monotonic() - t0
        entry[2] += buf.numel() * buf.element_size()
        return buf.to(x.dtype)

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
    """The axis sets that get a process group: each axis of size > 1, and
    ``ep`` with ``tp`` for the expert FFN's sum."""
    names = [a for a, n in axis_sizes.items() if n > 1]
    keys = [(a,) for a in names]
    if "ep" in names and "tp" in names:
        keys.append(tuple(a for a in names if a in ("ep", "tp")))
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
    axis_sizes = dict(axis_sizes or {"tp": world})
    wildcard = [k for k, v in axis_sizes.items() if v == -1]
    known = math.prod(v for v in axis_sizes.values() if v != -1)
    if wildcard:
        if len(wildcard) > 1:
            raise ValueError("only one axis may be -1")
        axis_sizes[wildcard[0]] = world // known
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
