"""The pod's slice seam for the port (port of ``maybe_join_slice`` and
``_run_slice_follower`` of ``langstream_tpu/runtime/pod.py``).

A multi-host slice is a StatefulSet of ``LS_SLICE_HOSTS`` pods, each with
``local`` ranks (``LOCAL_WORLD_SIZE``, else its card count; one JAX pod
drives every chip it holds the same way). Every pod joins one
``torch.distributed`` group at ``LS_COORDINATOR_ADDRESS`` (``host:port``)
as rank ``<pod ordinal> * local`` (``LS_POD_NAME``) of ``hosts * local``
and starts its other ranks ``<pod ordinal> * local + i`` itself
(:func:`langstream_tpu_torch.parallel.launch.join_slice`), with the
backend rule of :func:`langstream_tpu_torch.parallel.mesh.backend_rule`.
The ordinal-0 pod leads: its engine serves the records and broadcasts each
dispatch over the lockstep channel (``LS_LOCKSTEP_PORT``, joins
authenticated by ``LS_LOCKSTEP_TOKEN``), which every other rank of the
slice replays: the other pods open no consumer
(:func:`run_slice_follower`), and every pod's started ranks follow the same
leader. The platform's pod reaches these through ``serve_torch.register``,
which points its names at them; at the agent's end it closes the port's
engines (:func:`close_engines`), so a slice's world ends through its
leader's ``stop`` and every rank exits 0. A mesh engine's KV handoff routes
(``/kv/export`` pickups and ``/kv/import``) reach its leader, the one
engine in the pod's instance map: its ranks replay the gathers and
scatters, and a follower pod serves no handoff.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import threading
from typing import Any, Awaitable, Callable

log = logging.getLogger(__name__)


def pod_ordinal(pod_name: str | None) -> int:
    """StatefulSet pods are named ``<sts>-<ordinal>``."""
    if not pod_name or "-" not in pod_name:
        return 0
    tail = pod_name.rsplit("-", 1)[1]
    return int(tail) if tail.isdigit() else 0


def maybe_join_slice(device="cuda"):
    """Join the slice's ``torch.distributed`` group, this pod's other local
    ranks started, when this pod is one host of a multi-host slice
    (``LS_SLICE_HOSTS`` > 1): the :class:`~langstream_tpu_torch.parallel.launch.LocalWorld`;
    None otherwise."""
    from langstream_tpu_torch.parallel.launch import join_slice

    return join_slice(device)


async def run_slice_follower(hosts: int, ordinal: int,
                             serve_info: Callable[[Any], Awaitable[Any]] | None = None,
                             device="cuda") -> int:
    """A non-leader host of a slice: opens no broker consumer (the leader
    alone reads records, so the group sees one input stream) but replays
    every model call the leader dispatches, in lockstep
    (:class:`~langstream_tpu_torch.serving.lockstep.LockstepFollower`).

    ``serve_info(info)`` starts the pod's info server on an object whose
    ``info()`` describes this follower, so ``/ready`` answers on every pod
    of the StatefulSet (the platform's ``_serve_info``); it returns a
    server with ``close()``. Returns the descriptors replayed; SIGTERM or
    SIGINT stops the replay. The world ends with the replay
    (:func:`~langstream_tpu_torch.parallel.launch.end_world`, which reaps
    this pod's started ranks): after the leader's ``stop``, through the barrier
    every rank makes; after a signal or a broken channel, without it."""
    from langstream_tpu_torch.parallel.launch import end_world
    from langstream_tpu_torch.serving.lockstep import DEFAULT_PORT, LockstepFollower

    log.info("slice follower %d/%d: joining lockstep channel", ordinal, hosts)
    replayed = 0
    leader_host = os.environ["LS_COORDINATOR_ADDRESS"].rsplit(":", 1)[0]
    port = int(os.environ.get("LS_LOCKSTEP_PORT", str(DEFAULT_PORT)))
    follower = LockstepFollower(leader_host, port,
                                token=os.environ.get("LS_LOCKSTEP_TOKEN", ""),
                                device=device)

    class _FollowerInfo:
        def info(self) -> dict[str, Any]:
            engines = ([follower.engine] if follower.engine is not None else []) + list(
                follower.embedders.values())
            return {
                "role": "slice-follower",
                "ordinal": ordinal,
                "hosts": hosts,
                "replayed-steps": replayed,
                # the engines this pod replays: each one's mesh section
                # (its rank, dispatches, tier moves)
                "mesh": [e.mesh_section() for e in engines],
            }

    server = await serve_info(_FollowerInfo()) if serve_info is not None else None
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass  # not the main thread's loop: the caller stops the task
    # a daemon thread, not the default executor: asyncio.run joins executor
    # threads at shutdown, and the replay thread blocks in recv; on SIGTERM
    # follower.stop() closes the socket to unblock it
    replay_done = asyncio.Event()
    replay_result: list = []

    def _replay():
        try:
            replay_result.append(follower.run())
        except BaseException as e:  # surfaced below
            replay_result.append(e)
        finally:
            loop.call_soon_threadsafe(replay_done.set)

    threading.Thread(target=_replay, name="lockstep-replay", daemon=True).start()
    waits = {asyncio.ensure_future(replay_done.wait()), asyncio.ensure_future(stop.wait())}
    try:
        _, pending = await asyncio.wait(waits, return_when=asyncio.FIRST_COMPLETED)
        for task in pending:
            task.cancel()
        if not replay_done.is_set():
            follower.stop()  # unblock the recv; the thread exits on its own
            await asyncio.wait_for(replay_done.wait(), timeout=10)
    finally:
        if server is not None:
            server.close()
        # the leader's "stop" ended the replay: every rank meets at the
        # barrier; otherwise the leader is not coming, so no barrier
        led_out = (replay_done.is_set() and not stop.is_set() and bool(replay_result)
                   and not isinstance(replay_result[0], BaseException))
        end_world(barrier=led_out)
    if replay_result and isinstance(replay_result[0], BaseException):
        raise replay_result[0]
    replayed = replay_result[0] if replay_result else 0
    log.info("lockstep replay finished after %s steps; slice follower %d stopping",
             replayed, ordinal)
    return replayed


async def close_engines() -> None:
    """Close this process's shared engines, serving and embeddings, at the
    pod's end (after its agent drained and stopped): the last user of a
    world's lockstep channel sends ``stop``, so every rank of the mesh
    leaves its replay and meets the final barrier, and the ranks this pod
    started are reaped. Raises the first failure after closing them all (a
    rank that did not exit 0 among them)."""
    from langstream_tpu_torch.serving.embeddings import EmbeddingEngine
    from langstream_tpu_torch.serving.engine import TorchServingEngine

    with TorchServingEngine._instances_lock:
        engines = list(TorchServingEngine._instances.values())
    with EmbeddingEngine._instances_lock:
        embedders = list(EmbeddingEngine._instances.values())
    TorchServingEngine.reset_instances()
    EmbeddingEngine.reset_instances()
    errors = []
    for engine in engines:
        try:
            await engine.close()
        except RuntimeError as e:
            errors.append(e)
    for embedder in embedders:
        try:
            embedder.close()
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
