"""Pod entrypoint: the four in-cluster commands (the port's copy of
``langstream_tpu/runtime/pod.py``).

    python -m langstream_tpu_torch.runtime.pod [--device cuda|cpu] \
        {agent-runtime|application-setup|deployer-runtime|agent-code-download} ...
    python -m serve_torch [--device cuda|cpu] pod <the same command>

Parity: ``Main`` (``langstream-runtime-impl/.../runtime/Main.java:24``) with
subcommands ``agent-runtime``, ``agent-code-download``, ``deployer-runtime``,
``application-setup`` — the commands the k8s manifests generated by
:mod:`langstream_tpu_torch.k8s.resources` run in init containers, main
containers and Jobs (as ``python -m serve_torch --device <device> pod ...``).

The device is the leading ``--device`` (default ``cuda``): an agent pod
serves every ``tpu-serving-configuration`` resource on it, and an agent pod
started on ``cuda`` that finds no card fails (``require_device``), it never
serves on the CPU. The routes of the info server (:func:`_serve_info`) read
the port's engine functions (``langstream_tpu_torch.serving.engine``) when
they run, and ``/metrics`` the port's registry
(:func:`langstream_tpu_torch.core.metrics.render_metrics`). At its end an
agent pod closes the port's engines (:func:`close_engines`).

The pod's slice seam: a multi-host slice is a StatefulSet of
``LS_SLICE_HOSTS`` pods, each with ``local`` ranks (``LOCAL_WORLD_SIZE``,
else its card count; one JAX pod drives every chip it holds the same way).
Every pod joins one ``torch.distributed`` group at
``LS_COORDINATOR_ADDRESS`` (``host:port``) as rank ``<pod ordinal> *
local`` (``LS_POD_NAME``) of ``hosts * local`` and starts its other ranks
``<pod ordinal> * local + i`` itself
(:func:`langstream_tpu_torch.parallel.launch.join_slice`), with the backend
rule of :func:`langstream_tpu_torch.parallel.mesh.backend_rule`. The
ordinal-0 pod leads: its engine serves the records and broadcasts each
dispatch over the lockstep channel (``LS_LOCKSTEP_PORT``, joins
authenticated by ``LS_LOCKSTEP_TOKEN``), which every other rank of the
slice replays: the other pods open no consumer (:func:`run_slice_follower`),
and every pod's started ranks follow the same leader. A slice's world ends
through its leader's ``stop`` (:func:`close_engines` at the agent's end), and
every rank exits 0. A mesh engine's KV handoff routes (``/kv/export``
pickups and ``/kv/import``) reach its leader, the one engine in the pod's
instance map: its ranks replay the gathers and scatters, and a follower pod
serves no handoff.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Any, Awaitable, Callable

log = logging.getLogger("langstream_tpu_torch.pod")


class PodHealth:
    """Pod-level readiness state shared with the probe endpoints:
    ``agent_ready`` flips True once the AgentRunner has started (agents
    initialized, consumers attached) and back to False when draining —
    the gate ``/ready`` combines with the engines' warmup/wedge verdicts
    (serving/health.py). ``draining`` flips True when ``/drain`` is hit
    (autoscaler scale-down, the k8s preStop hook, or a voluntary
    eviction riding the PodDisruptionBudget): readiness drops
    immediately so the Service stops routing here while the engines
    requeue their in-flight work (docs/FLEET.md)."""

    def __init__(self) -> None:
        self.agent_ready = False
        self.draining = False
        # stamped when draining flips on (monotonic) plus the grace the
        # caller asked for: a drain is supposed to END in termination,
        # and a pod still alive long past its budget is an orphan (the
        # control plane died mid-scale-down, or someone curled /drain) —
        # liveness recycles it back into capacity
        self.draining_since: float | None = None
        self.drain_grace_s: float = 30.0

    def mark_draining(self, grace_s: float = 30.0) -> None:
        self.draining = True
        if self.draining_since is None:
            self.draining_since = time.monotonic()
            self.drain_grace_s = grace_s

    def drain_orphaned(self) -> bool:
        """True when the pod has been draining far beyond any budget that
        could still be waiting on it (3x grace, floored at 120 s — the
        preStop and autoscaler paths terminate within ONE grace)."""
        if not self.draining or self.draining_since is None:
            return False
        return (
            time.monotonic() - self.draining_since
            > max(120.0, 3.0 * self.drain_grace_s)
        )


def _probe_healthz(health: "PodHealth | None" = None) -> tuple[int, dict[str, Any]]:
    """Liveness: 503 only when an engine is WEDGED (no step progress
    while work is queued — the device is gone and only a reschedule
    brings it back), or when a drain was never followed by the
    termination it announces (the pod would otherwise be a permanent
    zero-capacity zombie: /ready 503 forever, /healthz 200 forever —
    nothing routes to it and nothing recycles it). DEGRADED stays 200:
    restarting a pod for a recompile storm or KV pressure would destroy
    work without fixing anything. Wait-free by contract (graftcheck
    OBS504): a probe that synced the device would hang exactly when the
    device does."""
    from langstream_tpu_torch.serving.health import worst_state
    from langstream_tpu_torch.serving.engine import health_report

    engines = health_report()
    status = worst_state(e.get("state", "wedged") for e in engines)
    wedged = [e.get("model") for e in engines if e.get("state") == "wedged"]
    orphaned = health is not None and health.drain_orphaned()
    if orphaned:
        # the drained engines already requeued/settled everything they
        # held — a restart loses nothing and restores capacity
        status = "drain-expired"
    return (503 if wedged or orphaned else 200), {
        "status": status,
        "wedged": wedged,
        "drain_expired": orphaned,
        # engines serving under a shrunken KV budget (adaptive
        # pool-shrink, docs/RESILIENCE.md): alive and answering — 200,
        # like DEGRADED — but an operator reading the probe body sees
        # the capacity loss without another round trip
        "budget_withheld": [
            e.get("model") for e in engines if e.get("budget_withheld")
        ],
        "engines": engines,
    }


def _probe_ready(health: PodHealth | None) -> tuple[int, dict[str, Any]]:
    """Readiness: 200 only once the agent runner has started AND every
    live engine is warmed and not wedged — a pod stops receiving traffic
    both before it can serve (init/warmup) and after it no longer can
    (wedge), and recovers when the condition clears. Also kicks warmup
    on warmup-on-start engines so the compile wave runs inside the
    not-ready window. Wait-free (OBS504): task creation + snapshot
    reads, nothing blocking."""
    from langstream_tpu_torch.serving.engine import health_report, kick_warmups

    kick_warmups()
    engines = health_report()
    agent_ok = health.agent_ready if health is not None else True
    blockers = []
    if not agent_ok:
        blockers.append("agent-init")
    if health is not None and health.draining:
        # the /drain handler flipped this: traffic off first, then the
        # engines requeue — readiness is the router's skip signal
        blockers.append("draining")
    for entry in engines:
        if not entry.get("ready", True):
            why = (
                "wedged"
                if entry.get("state") == "wedged"
                else "draining"
                if entry.get("draining")
                else f"warmup-{entry.get('warmup')}"
            )
            blockers.append(f"engine:{entry.get('model')}:{why}")
    return (200 if not blockers else 503), {
        "ready": not blockers,
        "blockers": blockers,
        "agent_ready": agent_ok,
        "engines": engines,
    }


def _attribution_payload() -> list[dict[str, Any]]:
    """The pod ``/attribution`` body: per-engine device-attribution
    payloads — program cost ledger (achieved-vs-expected per compiled
    variant) plus the HBM memory ledger. Wait-free by contract
    (graftcheck OBS505, same shape as the probe handlers): snapshot
    reads and arithmetic only, so the endpoint answers even while the
    engine is wedged mid-dispatch — exactly when an operator asks which
    program owns the stall."""
    from langstream_tpu_torch.serving.engine import attribution_report

    return attribution_report()


def _kv_export_payload(request_id: str) -> "dict[str, Any] | None":
    """The pod ``GET /kv/export/{request}`` body: one KV handoff export
    entry (payload bytes + the stashed ``langstream-trace`` value the
    response echoes, so the decode-side chainer keeps the trace),
    popped from whichever engine exported it. Wait-free by contract
    (graftcheck POOL701, the transfer plane's OBS504 twin): a prefill
    pod mid-incident must still answer the decode pool's pickup —
    snapshot reads and a dict pop, nothing that can wait."""
    from langstream_tpu_torch.serving.engine import take_kv_export

    return take_kv_export(request_id)


def _journey_payload(journey_id: str | None) -> Any:
    """The pod ``/journey`` bodies: this process's PARTIAL per-request
    event ledger (serving/journey.py) — ``/journey`` the index,
    ``/journey/{id}`` one journey's events, which the control plane
    stitches across pods. Wait-free by contract (graftcheck OBS506,
    the journey plane's OBS504 twin): ``list()`` snapshot copies only,
    so the ledger answers even while an engine is wedged mid-dispatch —
    exactly when an operator asks where a request's time went."""
    from langstream_tpu_torch.serving.journey import JOURNEYS

    if journey_id:
        return JOURNEYS.events(journey_id)
    return JOURNEYS.summaries()


def _incidents_payload(bundle_id: str | None) -> Any:
    """The pod ``/incidents`` bodies: the bounded incident-bundle index
    per engine (``/incidents``) or one full bundle
    (``/incidents/{id}``) — breach-triggered evidence snapshots the
    capture plane already put on disk (serving/incident.py). The report
    walk is lock-free (the :func:`health_report` snapshot rationale);
    the recorder's bundle-table lock is serving-thread-only, never the
    engine hot path's."""
    from langstream_tpu_torch.serving.engine import incident_report

    return incident_report(bundle_id)


def _memory_payload() -> list[dict[str, Any]]:
    """The pod ``/memory`` body: the HBM ledger alone
    (``hbm_bytes_by_owner`` + limit/slack per engine) — the view a
    capacity dashboard polls without pulling the per-program ledger.
    Wait-free (OBS505) like :func:`_attribution_payload`."""
    from langstream_tpu_torch.serving.engine import attribution_report

    return [
        {
            "model": entry.get("model"),
            "slots": entry.get("slots"),
            "memory": entry.get("memory"),
        }
        for entry in attribution_report()
    ]


def load_pod_config(path: str) -> dict[str, Any]:
    return json.loads(Path(path).read_text())


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
    of the StatefulSet (:func:`_serve_info`); it returns a
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


def build_agent_runner(
    config: dict[str, Any],
    code_dir: str | None = None,
    state_dir: Path | None = None,
):
    """Rebuild (plan, node) from the pod config, wire downloaded app code
    into the import path and the application directory, and construct the
    AgentRunner — the testable core of :func:`run_agent`."""
    from langstream_tpu_torch.k8s.podconfig import plan_and_node
    from langstream_tpu_torch.runtime.runner import AgentRunner

    if code_dir and Path(code_dir).is_dir():
        # app code (custom python agents) joins the import path, the role the
        # reference's NAR classloaders play for java agents
        for sub in ("python", "python/lib"):
            p = Path(code_dir) / "app" / sub
            if p.is_dir():
                sys.path.insert(0, str(p))

    plan, node = plan_and_node(config)
    app_root = Path(code_dir) / "app" if code_dir else None
    if app_root is not None and app_root.is_dir():
        # custom python/sidecar agents resolve their code relative to the
        # application package (grpc/client.py builds the sidecar PYTHONPATH
        # from it); in-cluster the downloaded archive is that package
        plan.application.directory = str(app_root)
    # replica identity = the *logical* replica (one per ICI slice, set by the
    # StatefulSet factory), falling back to the pod ordinal for single-host
    # agents where pod == logical replica.
    ordinal = pod_ordinal(os.environ.get("LS_POD_NAME"))
    logical = os.environ.get("LS_LOGICAL_REPLICA")
    replica = int(logical) if logical is not None else ordinal
    return AgentRunner(plan, node, replica=replica, state_dir=state_dir)


async def run_agent(config_path: str, code_dir: str | None = None,
                    device: str = "cuda") -> None:
    """Serve one agent replica until SIGTERM or SIGINT, then drain, stop and
    close the port's engines (:func:`close_engines`)."""
    try:
        await _run_agent(config_path, code_dir, device)
    finally:
        await close_engines()


async def _run_agent(config_path: str, code_dir: str | None, device: str) -> None:
    config = load_pod_config(config_path)
    maybe_join_slice(device)
    # Within a multi-host slice, only the ordinal-0 host (the slice leader)
    # consumes from the broker; the other hosts join the world and replay
    # every dispatch the leader's engine makes.
    hosts = int(os.environ.get("LS_SLICE_HOSTS", "1"))
    ordinal = pod_ordinal(os.environ.get("LS_POD_NAME"))
    if hosts > 1 and ordinal != 0:
        await run_slice_follower(hosts, ordinal, serve_info=_serve_info, device=device)
        return

    state_dir = Path("/agent-state") if Path("/agent-state").is_dir() else None
    runner = build_agent_runner(config, code_dir, state_dir=state_dir)
    replica = runner.replica

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)

    # probes come up BEFORE the runner starts: /ready answers 503 (agent
    # init pending) instead of connection-refused, so the kubelet sees a
    # live-but-not-ready pod rather than a probe error
    health = PodHealth()
    server = await _serve_info(runner, health=health)
    try:
        await runner.start()
        health.agent_ready = True
        log.info("agent %s replica %d running", runner.agent_id, replica)
        await stop.wait()
        log.info("draining agent %s", runner.agent_id)
        health.agent_ready = False  # readiness drops first: drain takes traffic off
        health.mark_draining(float(os.environ.get("LS_DRAIN_GRACE_S", "30")))
        # belt and braces under the preStop hook: a SIGTERM that arrived
        # without /drain (kubectl delete --grace-period, node pressure) still
        # requeues in-flight generations instead of dropping them; a second
        # drain after the hook already ran is an idempotent no-op
        from langstream_tpu_torch.serving.engine import drain_engines

        reports = await drain_engines(
            grace_s=float(os.environ.get("LS_DRAIN_GRACE_S", "30"))
        )
        if reports:
            log.info("engine drain reports: %s", reports)
        await runner.stop()
    finally:
        server.close()


async def _serve_info(runner, health: PodHealth | None = None) -> Any:
    """/metrics + /info + /traces + /flight + /attribution + /memory +
    /journey + /healthz + /ready on :8080
    (parity: AgentRunner.java:96-110; /traces serves this process's span
    ring buffer, core/tracing.py; /flight the engines' flight recorders,
    serving/flight.py; /healthz + /ready the probe endpoints the k8s
    StatefulSet's liveness/readiness probes hit, serving/health.py —
    /info stays the CLI's agent-status surface and answers 200 from the
    moment this server binds)."""
    from langstream_tpu_torch.core.metrics import render_metrics

    async def handle(reader, writer):
        try:
            request = await reader.readline()
            # parse headers (Content-Length gates the body read — the KV
            # import endpoint is the one POST this plane serves)
            req_headers: dict[str, str] = {}
            while True:
                line = await reader.readline()
                if not line.strip():
                    break
                key, _, value = line.decode("latin-1").partition(":")
                req_headers[key.strip().lower()] = value.strip()
            body = b""
            try:
                clen = int(req_headers.get("content-length", "0") or 0)
            except ValueError:
                clen = 0
            if clen > 0:
                body = await reader.readexactly(clen)
            path = request.split()[1].decode() if len(request.split()) > 1 else "/"
            status = 200
            extra_headers = b""
            # trace propagation on the pod handoff plane: the KV routes
            # honor and ECHO langstream-trace the way the gateway does,
            # so a handoff chainer never breaks the trace chain
            trace_hdr = req_headers.get("langstream-trace")
            if path.startswith("/metrics"):
                # always 200 + versioned text exposition, even when
                # prometheus_client is absent (render_metrics falls back to
                # the in-tree registry): scraper probes must not read an
                # empty body as a dead target
                payload = render_metrics()
                ctype = "text/plain; version=0.0.4"
            elif path.startswith("/traces"):
                from urllib.parse import urlparse

                from langstream_tpu_torch.core.tracing import SPANS

                tail = urlparse(path).path[len("/traces"):].strip("/")
                if tail:
                    payload = json.dumps(SPANS.spans(tail)).encode()
                else:
                    payload = json.dumps(SPANS.summaries()).encode()
                ctype = "application/json"
            elif path.startswith("/flight"):
                # engine flight recorder: /flight = recent samples + events
                # + rollup per live engine; /flight/summary = rollups only
                # (what the control plane fans in and dashboards poll)
                from urllib.parse import urlparse

                from langstream_tpu_torch.serving.engine import flight_report

                tail = urlparse(path).path[len("/flight"):].strip("/")
                payload = json.dumps(
                    flight_report(summary_only=(tail == "summary"))
                ).encode()
                ctype = "application/json"
            elif path.startswith("/attribution"):
                # device attribution plane (serving/attribution.py):
                # per-program achieved-vs-expected + the HBM memory
                # ledger; the control plane fans this in beside /flight
                payload = json.dumps(_attribution_payload()).encode()
                ctype = "application/json"
            elif path.startswith("/memory"):
                # HBM ledger alone: hbm_bytes_by_owner + limit/slack
                payload = json.dumps(_memory_payload()).encode()
                ctype = "application/json"
            elif path.startswith("/healthz"):
                # liveness: 503 only on a WEDGED engine (k8s restarts the
                # pod — the reschedule ROADMAP item 5 asks for)
                status, body = _probe_healthz(health)
                payload = json.dumps(body).encode()
                ctype = "application/json"
            elif path.startswith("/ready"):
                # readiness: agent init done + engines warmed + no wedge
                status, body = _probe_ready(health)
                payload = json.dumps(body).encode()
                ctype = "application/json"
            elif path.startswith("/drain"):
                # drain-before-terminate (docs/FLEET.md): flip readiness
                # off, then drain every serving engine — stop admission,
                # preempt-and-requeue in-flight generations, serve the
                # backlog inside the grace budget. Wired as the k8s
                # preStop hook and called by the autoscaler before a
                # scale-down decrements replicas; the response blocks
                # until the drain settles (k8s waits out preStop within
                # terminationGracePeriodSeconds, which the StatefulSet
                # factory sizes above the default grace here).
                from urllib.parse import parse_qs, urlparse

                from langstream_tpu_torch.serving.engine import drain_engines

                try:
                    grace = float(
                        (parse_qs(urlparse(path).query).get("grace-s")
                         or [30.0])[0]
                    )
                except ValueError:
                    grace = 30.0
                if health is not None:
                    health.mark_draining(grace)
                reports = await drain_engines(grace_s=grace)
                payload = json.dumps(
                    {"draining": True, "engines": reports}
                ).encode()
                ctype = "application/json"
            elif path.startswith("/kv/export/"):
                # KV handoff pickup (docs/DISAGG.md): the decode pool
                # fetches a prefill pod's serialized blocks here; the
                # payload is popped — a handoff is consumed exactly once
                from urllib.parse import urlparse

                rid = urlparse(path).path[len("/kv/export/"):].strip("/")
                entry = _kv_export_payload(rid)
                if entry is None:
                    status = 404
                    payload = json.dumps(
                        {"error": f"unknown or already-taken export {rid!r}"}
                    ).encode()
                    ctype = "application/json"
                else:
                    payload = entry["payload"]
                    ctype = "application/octet-stream"
                    # echo the prefill-side trace so the picker can
                    # forward it to the decode pool's /kv/import
                    if entry.get("trace"):
                        extra_headers += (
                            b"langstream-trace: "
                            + str(entry["trace"]).encode() + b"\r\n"
                        )
            elif path.startswith("/kv/import"):
                # KV handoff landing (docs/DISAGG.md): allocate blocks,
                # scatter the rows, admit straight into decode; answers
                # when the generation completes (the transfer + decode
                # run on the engine executor, never this event loop's
                # thread). Refusals are typed: layout mismatch → 409
                # (no sibling replica will take it either), capacity →
                # 503 + Retry-After (the router retries the next decode
                # replica — docs/DISAGG.md failure modes).
                from langstream_tpu_torch.serving.engine import import_kv_handoff
                from langstream_tpu_torch.serving.handoff import DeadlineExceeded
                from langstream_tpu_torch.serving.kvtransfer import LayoutMismatch
                from langstream_tpu_torch.serving.qos import RateLimited

                ctype = "application/json"
                try:
                    result = await import_kv_handoff(
                        body, trace_header=trace_hdr,
                        # end-to-end deadline (docs/RESILIENCE.md): the
                        # chainer forwards the gateway's stamp; the wire
                        # header's copy wins when both are present
                        deadline_header=req_headers.get(
                            "langstream-deadline"
                        ),
                    )
                    echo = result.get("trace") or trace_hdr
                    if echo:
                        extra_headers += (
                            b"langstream-trace: "
                            + str(echo).encode() + b"\r\n"
                        )
                    payload = json.dumps(result).encode()
                except LayoutMismatch as e:
                    status = 409
                    payload = json.dumps({"error": str(e)}).encode()
                except DeadlineExceeded as e:
                    # the request's end-to-end budget is spent: 504 —
                    # terminal by contract (no sibling decode replica
                    # has more time), never a retryable 503
                    status = 504
                    payload = json.dumps(
                        {"error": str(e),
                         "overrun_s": round(e.overrun_s, 6)}
                    ).encode()
                except RateLimited as e:
                    status = 503
                    retry = max(1, int(e.retry_after or 1))
                    extra_headers = (
                        b"Retry-After: " + str(retry).encode() + b"\r\n"
                    )
                    payload = json.dumps(
                        {"error": str(e), "reason": e.reason,
                         "retry_after_s": e.retry_after}
                    ).encode()
                except ValueError as e:
                    status = 400
                    payload = json.dumps({"error": str(e)}).encode()
            elif path.startswith("/journey"):
                # request journey plane (serving/journey.py): /journey =
                # index of this process's partial ledgers, /journey/{id}
                # = one journey's events — what the control plane's
                # cross-pod stitcher fans in (docs/OBSERVABILITY.md)
                from urllib.parse import urlparse

                tail = urlparse(path).path[len("/journey"):].strip("/")
                payload = json.dumps(_journey_payload(tail or None)).encode()
                ctype = "application/json"
            elif path.startswith("/incidents"):
                # incident capture plane (serving/incident.py):
                # /incidents = bounded bundle index per engine,
                # /incidents/{id} = one full evidence bundle — the
                # post-mortem starts from what the breach snapshotted,
                # not from whatever survived in the live rings
                from urllib.parse import urlparse

                tail = urlparse(path).path[len("/incidents"):].strip("/")
                report = _incidents_payload(tail or None)
                if tail and not report:
                    status = 404
                    payload = json.dumps(
                        {"error": f"unknown incident bundle {tail!r}"}
                    ).encode()
                else:
                    payload = json.dumps(report).encode()
                ctype = "application/json"
            elif path.startswith("/profile/"):
                # debug endpoint: /profile/start[?dir=/path] | /profile/stop
                # drives torch.profiler capture on every live serving engine
                from urllib.parse import parse_qs, urlparse

                from langstream_tpu_torch.serving.engine import profile_engines

                parsed = urlparse(path)
                action = parsed.path.rsplit("/", 1)[1]
                tdir = (parse_qs(parsed.query).get("dir") or [None])[0]
                try:
                    payload = json.dumps(profile_engines(action, tdir)).encode()
                except ValueError as e:
                    payload = json.dumps({"error": str(e)}).encode()
                    writer.write(
                        b"HTTP/1.1 400 Bad Request\r\nContent-Type: "
                        b"application/json\r\nContent-Length: "
                        + str(len(payload)).encode()
                        + b"\r\nConnection: close\r\n\r\n" + payload
                    )
                    await writer.drain()
                    return
                ctype = "application/json"
            else:
                payload = json.dumps(runner.info(), default=str).encode()
                ctype = "application/json"
            reason = {
                200: "OK",
                400: "Bad Request",
                404: "Not Found",
                409: "Conflict",
                503: "Service Unavailable",
                504: "Gateway Timeout",
            }.get(status, "OK")
            writer.write(
                f"HTTP/1.1 {status} {reason}\r\n".encode()
                + extra_headers
                + b"Content-Type: " + ctype.encode()
                + b"\r\nContent-Length: " + str(len(payload)).encode()
                + b"\r\nConnection: close\r\n\r\n" + payload
            )
            await writer.drain()
        except Exception as e:
            log.debug("info endpoint response aborted: %s", e)
        finally:
            writer.close()

    port = int(os.environ.get("LS_HTTP_PORT", "8080"))
    try:
        return await asyncio.start_server(handle, "0.0.0.0", port)
    except OSError as e:
        # in-cluster every pod owns :8080; outside (dev/verify) the port may
        # be taken — metrics are optional, the runner is not
        log.warning("cannot bind info server on :%d (%s); continuing", port, e)

        class _NullServer:
            def close(self) -> None: ...

        return _NullServer()


async def run_setup(config_path: str) -> None:
    """Create topics + provision assets (parity:
    ``ApplicationSetupRunner.runSetup``)."""
    from langstream_tpu_torch.core.deployer import ApplicationDeployer
    from langstream_tpu_torch.core.parser import build_application_from_files

    config = load_pod_config(config_path)
    app = build_application_from_files(
        config["files"], config.get("instance"), config.get("secrets")
    )
    deployer = ApplicationDeployer()
    plan = deployer.create_implementation(config["applicationId"], app)
    await deployer.setup(plan)
    log.info("setup complete: %d topics", len(plan.topics))


async def run_deployer(action: str, config_path: str) -> None:
    """Plan the app and write/delete Agent CRs (parity:
    ``RuntimeDeployer.deploy``)."""
    from langstream_tpu_torch.core.deployer import ApplicationDeployer
    from langstream_tpu_torch.core.parser import build_application_from_files
    from langstream_tpu_torch.k8s.client import HttpKubeApi
    from langstream_tpu_torch.k8s.cluster_runtime import (
        DEFAULT_IMAGE,
        KubernetesClusterRuntime,
    )

    config = load_pod_config(config_path)
    app = build_application_from_files(
        config["files"], config.get("instance"), config.get("secrets")
    )
    deployer = ApplicationDeployer()
    plan = deployer.create_implementation(config["applicationId"], app)
    api = HttpKubeApi.in_cluster()
    runtime = KubernetesClusterRuntime(
        api,
        image=config.get("image") or DEFAULT_IMAGE,
        code_storage=config.get("codeStorage"),
    )
    tenant = config["tenant"]
    if action == "deploy":
        crs = runtime.deploy(tenant, plan, config.get("codeArchiveId"))
        log.info("deployed %d agent CRs", len(crs))
    else:
        runtime.delete(tenant, plan)
        log.info("deleted agent CRs")


def run_code_download(config_path: str, destination: str) -> None:
    """Init container: pull the code archive (parity:
    ``AgentCodeDownloader``)."""
    from langstream_tpu_torch.core.codestorage import make_code_storage, unzip_to

    config = load_pod_config(config_path)
    archive_id = (config.get("codeStorage") or {}).get("codeArchiveId") or config.get(
        "codeArchiveId"
    )
    if not archive_id:
        log.info("no code archive configured; nothing to download")
        return
    storage = make_code_storage(config.get("codeStorage"))
    tenant = config.get("tenant", "default")
    unzip_to(storage.download(tenant, archive_id), Path(destination) / "app")
    log.info("code archive %s unpacked to %s", archive_id, destination)


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


COMMANDS = ("agent-runtime", "application-setup", "deployer-runtime", "agent-code-download")


def main(argv: list[str] | None = None) -> int:
    """Run one pod command: ``[--device cuda|cpu] <command> <args>``. An
    ``agent-runtime`` on ``cuda`` without a card fails before the agent
    starts."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if argv[:1] == ["--device"]:
        if len(argv) < 2 or argv[1] not in ("cuda", "cpu"):
            print("error: --device needs cuda or cpu", file=sys.stderr)
            return 2
        device, argv = argv[1], argv[2:]
    if not argv or argv[0] not in COMMANDS:
        if argv:
            print(f"unknown command {argv[0]!r}", file=sys.stderr)
        print(
            "usage: python -m langstream_tpu_torch.runtime.pod [--device cuda|cpu] "
            "{agent-runtime|application-setup|deployer-runtime|"
            "agent-code-download} ...",
            file=sys.stderr,
        )
        return 2
    command, *rest = argv
    if command == "agent-runtime":
        from langstream_tpu_torch._device import require_device
        from langstream_tpu_torch.agents import services

        require_device(device, "the agent pod (--device cuda)")
        services.set_serving_device(device)
        asyncio.run(run_agent(rest[0], rest[1] if len(rest) > 1 else None, device))
    elif command == "application-setup":
        # args: setup <config>  (subaction kept for reference-shape parity)
        asyncio.run(run_setup(rest[-1]))
    elif command == "deployer-runtime":
        asyncio.run(run_deployer(rest[0], rest[1]))
    else:
        run_code_download(rest[0], rest[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
