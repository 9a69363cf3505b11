"""Parallelism over ``torch.distributed``: meshes, specs and a rank's shards
(port of ``langstream_tpu/parallel``). Axes:

- ``dp``: data parallel, slots split over ranks in the cache and its read;
- ``tp``: tensor parallel, Megatron-style sharded matmuls;
- ``ep``: expert parallel, each rank holds a share of the experts.

One process per rank: the model code calls the collectives on the mesh's
groups (see :mod:`langstream_tpu_torch.parallel.mesh`), where GSPMD put
them in the JAX package. Sequence parallelism (``sp``) is ROADMAP.md
Queue 1 item 13b.
"""

from langstream_tpu_torch.parallel.mesh import (
    Mesh,
    P,
    PartitionSpec,
    local_mesh,
    make_mesh,
    mesh_axes,
    shard_for_rank,
)

__all__ = ["Mesh", "P", "PartitionSpec", "local_mesh", "make_mesh", "mesh_axes",
           "shard_for_rank"]
