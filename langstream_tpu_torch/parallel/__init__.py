"""Parallelism over ``torch.distributed``: meshes, specs and a rank's shards
(port of ``langstream_tpu/parallel``). Axes:

- ``dp``: data parallel, slots split over ranks in the cache and its read;
- ``tp``: tensor parallel, Megatron-style sharded matmuls;
- ``ep``: expert parallel, each rank holds a share of the experts;
- ``sp``: sequence parallel, a prompt's positions split over ranks, with
  ring attention or Ulysses (:mod:`langstream_tpu_torch.parallel.ring`).

One process per rank: the model code calls the collectives on the mesh's
groups (see :mod:`langstream_tpu_torch.parallel.mesh`), where GSPMD put
them in the JAX package; every world ends through :func:`shutdown`.
Pipeline parallelism (``pp``: ``gpipe``, ``llama_forward_pp``,
``moe_forward_pp``, with their backward) is ROADMAP.md Queue 1 item 13c.
"""

from langstream_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    PartitionSpec,
    local_mesh,
    make_mesh,
    mesh_axes,
    shard_for_rank,
    shutdown,
)
from langstream_tpu_torch.parallel.ring import (
    dense_attention,
    ring_attention,
    ulysses_attention,
)

__all__ = ["Mesh", "P", "PartitionSpec", "dense_attention", "local_mesh", "make_mesh",
           "mesh_axes", "ring_attention", "shard_for_rank", "shutdown",
           "ulysses_attention"]
