"""Parallelism over ``torch.distributed``: meshes, specs and a rank's shards
(port of ``langstream_tpu/parallel``). Axes:

- ``dp``: data parallel, slots split over ranks in the cache and its read;
- ``tp``: tensor parallel, Megatron-style sharded matmuls;
- ``ep``: expert parallel, each rank holds a share of the experts;
- ``sp``: sequence parallel, a prompt's positions split over ranks, with
  ring attention or Ulysses (:mod:`langstream_tpu_torch.parallel.ring`);
- ``pp``: pipeline parallel, each rank a stage of contiguous layers under
  the GPipe schedule (:mod:`langstream_tpu_torch.parallel.pipeline`).

One process per rank: the model code calls the collectives on the mesh's
groups (see :mod:`langstream_tpu_torch.parallel.mesh`), where GSPMD put
them in the JAX package; an engine whose mesh finds no world starts its
host's other ranks itself (:mod:`langstream_tpu_torch.parallel.launch`);
every world ends through :func:`shutdown` (the launcher's ``end_world``
then reaps the ranks it started). Every
collective carries its gradient, so the forwards train: ``gpipe``,
``llama_forward_pp`` and ``moe_forward_pp`` at ``{dp, pp, ep, tp}``,
``llama_forward_sp`` at ``{dp, sp, tp}``, with :func:`sync_grads` summing
the gradients over ``dp`` and ``sp`` before the update.
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
    sync_grads,
)
from langstream_tpu_torch.parallel.pipeline import (
    gpipe,
    llama_forward_pp,
    moe_forward_pp,
    pp_layer_specs,
    pp_param_specs,
    shard_pp_params,
)
from langstream_tpu_torch.parallel.ring import (
    dense_attention,
    ring_attention,
    ulysses_attention,
)

__all__ = ["Mesh", "P", "PartitionSpec", "dense_attention", "gpipe", "llama_forward_pp",
           "local_mesh", "make_mesh", "mesh_axes", "moe_forward_pp", "pp_layer_specs",
           "pp_param_specs", "ring_attention", "shard_for_rank", "shard_pp_params",
           "shutdown", "sync_grads", "ulysses_attention"]
