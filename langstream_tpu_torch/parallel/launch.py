"""Local ranks: the port's counterpart of what ``jax.devices()`` gives a JAX
process.

One JAX process drives every chip of its host: ``make_mesh`` takes
``jax.devices()[:total]`` (``langstream_tpu/parallel/mesh.py``), so a mesh
serves from the normal entry points with nothing else started. PyTorch runs
one process per rank. So when an engine needs a mesh and no world is
joined, :func:`ensure_world` starts the missing local ranks itself, one
process per card, joins them as rank 0 and hands the engine the
:class:`LocalWorld` it leads.

- :func:`local_ranks` is the ranks this host may run: ``LOCAL_WORLD_SIZE``
  (torchrun's name) when set, else the card count (1 on the CPU). On the
  CPU it plays the part of ``--xla_force_host_platform_device_count``; on
  one card, ranks that share it run over gloo
  (:func:`~langstream_tpu_torch.parallel.mesh.backend_rule`).
- A child is a fresh interpreter running this module, never a ``fork``:
  the parent may hold a CUDA context and, under ``serve_torch.py``, JAX.
  Its environment carries its rank, the world, the coordinator, the
  lockstep port and token. It joins the world, replays the leader's
  lockstep channel
  (:class:`~langstream_tpu_torch.serving.lockstep.LockstepFollower`, which
  builds the engines from the leader's frames) until ``stop``, ends the
  world and exits 0. Its output goes to a file of its own (a full pipe
  would stall the rank), whose tail is raised with any failure.
- Ordering: the parent hosts the store and binds the lockstep socket
  first, both on ports the kernel picks, and hands the ports to the
  children; a child joins the store, then connects to the channel, where
  it waits in the socket's backlog until the engine leads it. Every wait
  is bounded by the world's timeout (``collective_timeout_s``), and the
  engine's wait for its followers checks the children, so one that exits
  early ends the wait with its rank, exit code and output.
- Reaping: :func:`end_world` (called by the last leading engine's
  ``close()``) ends the world where it always ended, in
  :func:`~langstream_tpu_torch.parallel.mesh.shutdown`, then calls
  :func:`reap`: every child is waited for within the world's timeout, one
  still alive is
  killed and named, each exit code is kept (:meth:`LocalWorld.describe`,
  in the engines' ``stats()["mesh"]``), and any that is not 0 raises. A
  child whose leader dies sees its channel break and exits on its own.
- One world per process (``torch.distributed`` has one default group): a
  second engine whose mesh has as many ranks shares the world and its
  channel; a mesh of another size is refused while the world is up. The
  ranks replay one serving engine, so a second serving engine is refused
  too (:func:`~langstream_tpu_torch.serving.lockstep.lead`); embeddings
  engines share it. An engine that only joined the world leaves it up
  when it fails; one that started it ends it (:func:`abandon`).

On a multi-host slice of ``LS_SLICE_HOSTS`` pods, :func:`join_slice` does
the same on each pod for its own cards: the pod joins as rank
``ordinal * local`` of ``hosts * local`` and starts ranks
``ordinal * local + 1 .. ordinal * local + local - 1``, and every child of
every pod follows the one leader, the ordinal-0 pod's engine, at the
coordinator's host (``LS_LOCKSTEP_PORT``, ``LS_LOCKSTEP_TOKEN``).

Run as a module, this file is a child rank (its environment set by
:meth:`LocalWorld.start`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import secrets
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

import torch

from langstream_tpu_torch.parallel.mesh import (
    collective_timeout_s,
    init_distributed,
    open_store,
    resolve_axes,
    shutdown,
)

log = logging.getLogger(__name__)

#: the directory that holds the package, put on a child's ``PYTHONPATH``
_ROOT = str(Path(__file__).resolve().parents[2])


def local_ranks(device) -> int:
    """The ranks this host may run: ``LOCAL_WORLD_SIZE`` when set, else the
    cards torch sees for CUDA and 1 for the CPU."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local:
        return int(local)
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def slice_hosts() -> int:
    return int(os.environ.get("LS_SLICE_HOSTS", "1"))


@dataclasses.dataclass
class _Child:
    rank: int
    proc: subprocess.Popen
    output: Path  # its stdout and stderr
    report: Path  # what it replayed and launched, written at its exit
    killed: bool = False
    result: dict | None = None

    def tail(self) -> str:
        try:
            return self.output.read_text(errors="replace")[-3000:]
        except OSError:
            return ""

    def describe(self) -> dict[str, Any]:
        return {"rank": self.rank, "pid": self.proc.pid, "exit-code": self.proc.returncode,
                "killed": self.killed, **(self.result or {})}


class LocalWorld:
    """A world this process joined as rank ``rank`` of ``size``, with the
    other ``local - 1`` ranks of its host started by it. ``axes`` is the
    mesh it serves (None until an engine names it, on a slice joined by
    the pod); ``lockstep_port`` and ``token`` are the channel its leader
    engine opens (on :meth:`take_server`'s socket, when this process bound
    it)."""

    def __init__(self, size: int, rank: int, local: int, device, coordinator: str,
                 lockstep_port: int, token: str, axes: dict | None = None,
                 server: socket.socket | None = None):
        self.size, self.rank, self.local = size, rank, local
        self.hosts = size // local
        self.device = str(device)
        self.coordinator = coordinator
        self.lockstep_port, self.token = lockstep_port, token
        self.axes = axes
        self._server = server
        self.children: list[_Child] = []
        self._dir: Path | None = None  # the children's output and reports

    def take_server(self) -> socket.socket | None:
        """The listening lockstep socket, once (the first engine to lead)."""
        server, self._server = self._server, None
        return server

    def start(self) -> None:
        """Start this host's other ranks: fresh interpreters running this
        module, each writing its output to a file of its own."""
        if self.local == 1:
            return
        self._dir = Path(tempfile.mkdtemp(prefix="ls-ranks-"))
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join(
                   p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p),
               "WORLD_SIZE": str(self.size), "LOCAL_WORLD_SIZE": str(self.local),
               "LS_COORDINATOR_ADDRESS": self.coordinator,
               "LS_LOCKSTEP_PORT": str(self.lockstep_port),
               "LS_LOCKSTEP_TOKEN": self.token, "LS_LAUNCH_DEVICE": self.device}
        env.setdefault("OMP_NUM_THREADS", "1")  # as torchrun: ranks share the cores
        for local_rank in range(1, self.local):
            rank = self.rank + local_rank
            output, report = self._dir / f"rank{rank}.log", self._dir / f"rank{rank}.json"
            with open(output, "wb") as out:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "langstream_tpu_torch.parallel.launch"],
                    env={**env, "RANK": str(rank), "LOCAL_RANK": str(local_rank),
                         "LS_LAUNCH_REPORT": str(report)},
                    stdin=subprocess.DEVNULL, stdout=out, stderr=subprocess.STDOUT)
            self.children.append(_Child(rank, proc, output, report))
        log.info("started local ranks %s of a world of %d (pids %s)",
                 [c.rank for c in self.children], self.size,
                 [c.proc.pid for c in self.children])

    def check(self) -> None:
        """Raise if a child has exited while its world is up."""
        for c in self.children:
            if c.proc.poll() is not None:
                raise RuntimeError(
                    f"local rank {c.rank} (pid {c.proc.pid}) exited {c.proc.returncode} "
                    f"while its world was up; its output ends:\n{c.tail()}")

    def lost_a_rank(self) -> bool:
        return any(c.proc.poll() is not None for c in self.children)

    def reap(self, kill: bool = False) -> None:
        """Wait for every child within the world's timeout (``kill``: kill
        them at once), killing and naming one still alive past it; keep
        each exit code and report; raise ``RuntimeError`` naming every
        child that was killed or did not exit 0."""
        timeout = collective_timeout_s()
        deadline = time.monotonic() + timeout
        for c in self.children:
            if not kill:
                try:
                    c.proc.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
            if c.proc.poll() is None:
                c.proc.kill()
                c.killed = True
                c.proc.wait()
            try:
                c.result = json.loads(c.report.read_text())
            except (OSError, ValueError):
                pass
        when = "when its world failed" if kill else f"{timeout:g} s after its world ended"
        failed = [f"local rank {c.rank} (pid {c.proc.pid}) "
                  + (f"was still running {when} and was killed" if c.killed
                     else f"exited {c.proc.returncode}")
                  + f"; its output ends:\n{c.tail()}"
                  for c in self.children if c.killed or c.proc.returncode != 0]
        server = self.take_server()
        if server is not None:
            server.close()
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
        if failed:
            raise RuntimeError(f"the world of mesh {self.axes} lost ranks: "
                               + "\n".join(failed))

    def describe(self) -> dict[str, Any]:
        """Each child's rank, pid, exit code (None while it runs), whether
        it was killed, and from its report the dispatches it replayed, its
        kernels' launches, its ``lora_delta`` calls and its engines' mesh
        sections."""
        return {"hosts": self.hosts, "local-ranks": self.local,
                "children": [c.describe() for c in self.children]}


#: the world this process started ranks for; None when it started none
#: (no world, or one its caller joined). One per process, as
#: ``torch.distributed``'s default group is.
_WORLD: LocalWorld | None = None


def _joined() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def ensure_world(axes: dict | None, device) -> tuple[LocalWorld | None, bool]:
    """Make sure a world of ``axes``' ranks is up, starting this host's
    missing ranks when none is. Returns the world this process leads
    (shared by every engine of a mesh of that size), or None where nothing
    was started (no mesh, one rank, or a world the caller joined, which
    ``make_mesh`` holds the mesh to), and whether this call started it
    (its caller then ends it if it fails). A mesh larger than the capacity
    (``LS_SLICE_HOSTS`` hosts of :func:`local_ranks` each) is refused with
    ``needs N devices, have M``; on a slice, one of another size than the
    capacity; while a world is up, one of another size than the world."""
    if not axes:
        return None, False
    if _joined():
        world = _WORLD
        if world is None:
            return None, False
        axes = resolve_axes(axes, world.size)
        n = math.prod(axes.values())
        if n != world.size:
            if world.axes is None:
                raise ValueError(
                    f"mesh {axes} spans {n} ranks, but this slice has {world.hosts} "
                    f"hosts x {world.local} local ranks = {world.size}: a slice's "
                    f"mesh spans every rank of it")
            raise ValueError(
                f"mesh {axes} needs {n} ranks, but this process leads the world of "
                f"mesh {world.axes} ({world.size} ranks) until its engines close: "
                f"one world per process")
        if world.axes is None:
            world.axes = axes
        return world, False
    hosts, local = slice_hosts(), local_ranks(device)
    capacity = hosts * local
    axes = resolve_axes(axes, capacity)
    n = math.prod(axes.values())
    if n <= 1:
        return None, False
    if n > capacity:
        raise ValueError(f"mesh {axes} needs {n} devices, have {capacity}")
    if hosts > 1:
        if n != capacity:
            raise ValueError(
                f"mesh {axes} spans {n} ranks, but a slice of {hosts} hosts x {local} "
                f"local ranks has {capacity}: a slice's mesh spans every rank of it")
        world = join_slice(device)
        world.axes = axes
        return world, True
    # one host: ranks 1..n-1 here, JAX's devices[:total]; the store and the
    # lockstep socket are bound before the children learn their ports
    coordinator = open_store("127.0.0.1", n)
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.bind(("127.0.0.1", 0))
    server.listen(n - 1)
    return _start(LocalWorld(n, 0, n, device, coordinator, server.getsockname()[1],
                             secrets.token_hex(16), axes=axes, server=server)), True


def join_slice(device="cuda") -> LocalWorld | None:
    """On a pod of a multi-host slice (``LS_SLICE_HOSTS`` > 1): join the
    slice's world at ``LS_COORDINATOR_ADDRESS`` as rank ``ordinal * local``
    of ``hosts * local`` (the ordinal from ``LS_POD_NAME``, ``local`` from
    :func:`local_ranks`), with this pod's other ``local - 1`` ranks started;
    the world already joined when there is one; None off a slice."""
    from langstream_tpu_torch.runtime.pod import pod_ordinal
    from langstream_tpu_torch.serving.lockstep import DEFAULT_PORT

    hosts = slice_hosts()
    if hosts <= 1:
        return None
    if _joined():
        return _WORLD
    local = local_ranks(device)
    ordinal = pod_ordinal(os.environ.get("LS_POD_NAME"))
    coordinator = os.environ["LS_COORDINATOR_ADDRESS"]
    log.info("joining a %d-host slice as rank %d of %d (coordinator %s)",
             hosts, ordinal * local, hosts * local, coordinator)
    return _start(LocalWorld(
        hosts * local, ordinal * local, local, device, coordinator,
        int(os.environ.get("LS_LOCKSTEP_PORT", str(DEFAULT_PORT))),
        os.environ.get("LS_LOCKSTEP_TOKEN", "")))


def _start(world: LocalWorld) -> LocalWorld:
    """Start ``world``'s children, then join it (the rendezvous waits for
    them, within the world's timeout); on failure, end it naming them."""
    global _WORLD
    _WORLD = world
    try:
        world.start()
        init_distributed(world.coordinator, world.size, world.rank, world.device,
                         local_world_size=world.local)
    except BaseException as e:
        abandon(e)
        raise
    return world


def lost_a_rank() -> bool:
    """Whether a rank this process started has exited (its world's
    barrier would only time out)."""
    return _WORLD is not None and _WORLD.lost_a_rank()


def reap(kill: bool = False) -> None:
    """Forget the world this process started ranks for and reap them
    (:meth:`LocalWorld.reap`); nothing when it started none."""
    global _WORLD
    world, _WORLD = _WORLD, None
    if world is not None:
        world.reap(kill)


def end_world(barrier: bool = True) -> None:
    """End this process's world (:func:`shutdown`; no barrier when a rank
    this process started has already exited, since it would only time
    out), then reap the ranks this process started (:func:`reap`, which
    raises on a rank that failed)."""
    try:
        shutdown(barrier=barrier and not lost_a_rank())
    finally:
        reap()


def abandon(error: BaseException) -> None:
    """End the world this process started after ``error`` (its start, or
    the engine that was to lead it, failed): its children killed at once
    and reaped, what each said added to ``error``'s notes, then the world
    ended without a barrier."""
    if _WORLD is None:
        return
    try:
        reap(kill=True)
    except RuntimeError as e:
        error.add_note(str(e))
    finally:
        shutdown(barrier=False)


def _child() -> int:
    """A started rank: join the world, replay the leader's channel until
    ``stop``, end the world, write the report, exit 0. Any failure raises
    (a traceback in its output and a non-zero exit code)."""
    from langstream_tpu_torch.models import llama
    from langstream_tpu_torch.ops import launch_counts
    from langstream_tpu_torch.serving.lockstep import LockstepFollower

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    coordinator, device = os.environ["LS_COORDINATOR_ADDRESS"], os.environ["LS_LAUNCH_DEVICE"]
    init_distributed(coordinator, size, rank, device)
    follower = LockstepFollower(
        coordinator.rsplit(":", 1)[0], int(os.environ["LS_LOCKSTEP_PORT"]),
        # a single host's channel is open before its ranks start; a slice's
        # opens when the ordinal-0 pod builds its engine
        connect_timeout=collective_timeout_s() if slice_hosts() <= 1 else 600.0,
        token=os.environ["LS_LOCKSTEP_TOKEN"], device=device)
    replayed = None
    try:
        replayed = follower.run()
    finally:
        # the leader's "stop" ended the replay: every rank meets at the
        # barrier; otherwise the leader is not coming
        shutdown(barrier=replayed is not None)
    engines = ([follower.engine] if follower.engine is not None else []) + list(
        follower.embedders.values())
    Path(os.environ["LS_LAUNCH_REPORT"]).write_text(json.dumps({
        "replayed": replayed, "kernels": launch_counts(), "lora_delta": llama.LORA_DELTA_CALLS,
        "mesh": [e.mesh_section() for e in engines]}))
    return 0


if __name__ == "__main__":
    sys.exit(_child())
