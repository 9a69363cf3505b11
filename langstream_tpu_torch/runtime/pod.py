"""The pod's slice seam for the port (port of ``maybe_join_slice`` and
``_run_slice_follower`` of ``langstream_tpu/runtime/pod.py``).

A multi-host slice is a StatefulSet of ``LS_SLICE_HOSTS`` pods. Every pod
joins one ``torch.distributed`` group at ``LS_COORDINATOR_ADDRESS``
(``host:port``) as rank ``<pod ordinal>`` (``LS_POD_NAME``), with the
backend rule of :func:`langstream_tpu_torch.parallel.mesh.backend_rule`.
The ordinal-0 pod leads: its engine serves the records and broadcasts each
dispatch over the lockstep channel (``LS_LOCKSTEP_PORT``, joins
authenticated by ``LS_LOCKSTEP_TOKEN``). The other pods open no consumer
and replay (:func:`run_slice_follower`). The platform's pod reaches these
through ``serve_torch.register``, which points its two names at them.
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


def maybe_join_slice(device="cuda") -> None:
    """Join the slice's ``torch.distributed`` group when this pod is one
    host of a multi-host slice (``LS_SLICE_HOSTS`` > 1); nothing otherwise."""
    from langstream_tpu_torch.parallel.mesh import init_distributed

    hosts = int(os.environ.get("LS_SLICE_HOSTS", "1"))
    if hosts <= 1:
        return
    coordinator = os.environ["LS_COORDINATOR_ADDRESS"]
    rank = pod_ordinal(os.environ.get("LS_POD_NAME"))
    log.info("joining %d-host slice as rank %d (coordinator %s)",
             hosts, rank, coordinator)
    init_distributed(coordinator, hosts, rank, device)


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
    SIGINT stops the replay."""
    from langstream_tpu_torch.serving.lockstep import DEFAULT_PORT, LockstepFollower

    log.info("slice follower %d/%d: joining lockstep channel", ordinal, hosts)
    replayed = 0

    class _FollowerInfo:
        def info(self) -> dict[str, Any]:
            return {
                "role": "slice-follower",
                "ordinal": ordinal,
                "hosts": hosts,
                "replayed-steps": replayed,
            }

    server = await serve_info(_FollowerInfo()) if serve_info is not None else None
    leader_host = os.environ["LS_COORDINATOR_ADDRESS"].rsplit(":", 1)[0]
    port = int(os.environ.get("LS_LOCKSTEP_PORT", str(DEFAULT_PORT)))
    follower = LockstepFollower(leader_host, port,
                                token=os.environ.get("LS_LOCKSTEP_TOKEN", ""),
                                device=device)
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
    if replay_result and isinstance(replay_result[0], BaseException):
        raise replay_result[0]
    replayed = replay_result[0] if replay_result else 0
    log.info("lockstep replay finished after %s steps; slice follower %d stopping",
             replayed, ordinal)
    return replayed
