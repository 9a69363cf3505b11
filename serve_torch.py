#!/usr/bin/env python3
"""Serve LangStream applications through the PyTorch port.

    python serve_torch.py [--device cpu|cuda] <langstream-tpu CLI arguments>
    python -m serve_torch [--device cpu|cuda] pod <pod command ...>
    python -m serve_torch [--device cpu|cuda] operator
    python -m serve_torch [--device cpu|cuda] controlplane

for example, the single-process dev mode on the chat example, and the
one-command local cluster:

    python serve_torch.py run chat -app examples/applications/chat-completions
    python serve_torch.py --device cpu run chat -app <application directory>
    python -m serve_torch --device cpu mini up --once

The launcher registers the port's provider
(:class:`langstream_tpu_torch.agents.provider.TorchServiceProvider`) for
the ``tpu-serving-configuration`` resource type, then hands the rest of
the arguments to the platform's click CLI (``langstream_tpu.cli.main``).
Every ``ai-chat-completions``, ``ai-text-completions`` and
``compute-ai-embeddings`` agent that names such a resource is then served
by the port's engines on ``--device`` (default ``cuda``: the card). Which
package serves is the launcher's choice, not the application's: the
resource keeps the keys it has.

The port's engines register ``stream-key`` requests with the platform's
stream registry (``langstream_tpu.serving.streaming.STREAMS``), the one the
gateway cancels by on a client disconnect and the AI agents consult, so a
disconnect frees the port's decode slot as it frees the JAX engine's. The
pod's routes read their functions from ``langstream_tpu.serving.engine``
when they run (:data:`POD_SEAM`); :func:`register` points each at a
function over both packages' engines: a wedged port engine answers 503 on
``/healthz``, a ``warmup-on-start`` port engine warms inside the pod's
not-ready window, ``/drain`` (and the preStop hook) drains both packages'
engines under one grace, ``/kv/import`` lands a payload in a port engine
and answers 409, 503 and 504 for its refusals, and ``/flight``,
``/attribution``, ``/memory``, ``/profile`` and ``/incidents`` list both
packages' engines.

The request-evidence planes cross too. A request an agent sends to the
port runs under the platform's ambient trace, handed over as a header
value, so the port's spans and journey edges join the record's trace. The
port's journey ledger and span buffer mirror every edge and span into the
platform's (:data:`langstream_tpu.serving.journey.JOURNEYS`,
:data:`langstream_tpu.core.tracing.SPANS`), so ``/journey``,
``/journey/{id}`` and ``/traces`` list both packages, and a request whose
prefill ran in one package and decode in the other reads as one timeline.
The mirror is an append, as wait-free as the port's own.

A resource with a ``mesh`` serves from the same command on a host with
several cards: the engine starts the mesh's other ranks itself, one
process per card, and leads them
(:mod:`langstream_tpu_torch.parallel.launch`), as one JAX process drives
every chip of its host; ``LOCAL_WORLD_SIZE`` sets how many ranks the host
may run (on the CPU, or ranks sharing one card over gloo). A multi-host
slice of the port (a ``mesh`` over ``LS_SLICE_HOSTS`` pods) starts
through the pod's own slice seam: :func:`register` points
``langstream_tpu.runtime.pod.maybe_join_slice`` and
``_run_slice_follower`` at the port's (:data:`SLICE_SEAM`), so every pod
joins the ``torch.distributed`` group as rank ``ordinal * local``, starts
its other local ranks, and the followers replay the leader's dispatches
behind the pod's info server; ``run_agent`` is wrapped too, so at the
agent's end the pod closes the port's engines and a slice's world ends
through its leader's ``stop``, every rank reaped.

The Prometheus plane crosses the same way: the port's engines build their
reporters from ``langstream_tpu_torch.core.metrics.REPORTER``, which
:func:`register` points at the platform's reporter class, so the pod's one
``/metrics`` scrape (``langstream_tpu.api.metrics.render_metrics``) carries
the port's ``langstream_serving_*`` and ``langstream_stream_*`` series
under the JAX engine's names, TTFT exemplars included. An engine built
before :func:`register` keeps the port's own registry.

In the cluster the port's pods are the operator's. :func:`register` points
the platform operator's ``AgentResourcesFactory`` at the port's
(:mod:`langstream_tpu_torch.k8s.resources`, :data:`OPERATOR_SEAM`): an
agent with a device mesh asks for ``nvidia.com/gpu`` cards on an H100 node
pool, and every agent pod starts as ``python -m serve_torch --device
<device> pod agent-runtime ...``, which registers the port and runs the
platform's pod entrypoint (``langstream_tpu.runtime.pod.main``). The
placement name is ``LS_ACCELERATOR``, one of the port's entries (unset:
``h100``); any other name, a TPU's among them, is refused. ``python -m
serve_torch operator`` runs the platform's operator so; under ``mini up``
the operator and the process kubelet run in this process, so its agent
pods serve through the port too. ``python -m serve_torch controlplane``
runs the platform's control plane (``langstream_tpu.controlplane``) after
:func:`register`: in ``LS_MODE: local`` (the compose stack,
``deploy/torch/docker-compose.yaml``) its in-process agents serve through
the port; in ``LS_MODE: k8s`` it writes Agent CRs stamped with
``LS_RUNTIME_IMAGE``, which the port's operator places. The port's install
(``deploy/torch/``: manifests, a Helm chart and the compose file) is
rendered by ``tools/render_deploy_torch.py``.

This file is the seam between the two packages, the one that imports both,
and sits outside ``langstream_tpu_torch`` so that the port itself imports
nothing of JAX. The platform layers it starts (runner, gateway, control
plane) load JAX on import, so it runs only where JAX is installed;
``chip_smoke.py`` drives the port's provider on a card that has no JAX.
"""

from __future__ import annotations

import sys
import time


#: the pod functions (``langstream_tpu/runtime/pod.py`` reads them from
#: ``langstream_tpu.serving.engine`` at call time) that also answer for the
#: port's engines once :func:`register` ran
POD_SEAM = ("health_report", "kick_warmups", "take_kv_export", "flight_report",
            "attribution_report", "drain_engines", "import_kv_handoff",
            "profile_engines", "incident_report")


def _merge(jax_out: dict, port_out: dict) -> dict:
    """Two by-model dicts as one: a port engine whose model a JAX engine
    also serves is keyed ``"<model> (torch)"``."""
    out = dict(jax_out)
    for model, value in port_out.items():
        out[model if model not in out else f"{model} (torch)"] = value
    return out


def _translated(error: Exception) -> Exception:
    """A port refusal as the JAX package's class, the one the pod's
    ``/kv/import`` handler maps to its status (409, 503 + Retry-After, 504);
    any other error as it is."""
    from langstream_tpu.serving.handoff import DeadlineExceeded
    from langstream_tpu.serving.kvtransfer import LayoutMismatch
    from langstream_tpu.serving.qos import RateLimited
    from langstream_tpu_torch.serving import handoff, kvtransfer, qos

    if isinstance(error, kvtransfer.LayoutMismatch):
        return LayoutMismatch(str(error))
    if isinstance(error, qos.RateLimited):
        return RateLimited(error.reason, error.retry_after, str(error))
    if isinstance(error, handoff.DeadlineExceeded):
        return DeadlineExceeded(str(error), overrun_s=error.overrun_s)
    return error


def _port_takes_import(payload: bytes, port_engine) -> bool:
    """Whether the port lands this payload: it has an engine that can take
    the payload's model, and the JAX package has none or only combined ones
    while the port has a decode pool (decode pools first, as within one
    package; on a tie the JAX engine)."""
    from langstream_tpu.serving.engine import TpuServingEngine
    from langstream_tpu.serving.kvtransfer import peek_header

    model = (peek_header(payload).get("fingerprint") or {}).get("model")
    port = port_engine.import_candidates(model)
    if not port:
        return False
    jax = [e for e in list(TpuServingEngine._instances.values())
           if e.config.model == model and e.block_mgr is not None
           and e.config.pool_role != "prefill"]
    if not jax:
        return True
    return (port[0].config.pool_role == "decode"
            and all(e.config.pool_role != "decode" for e in jax))


def _with_port(name: str, jax_fn, port_engine):
    """``name`` over both packages' engines: the JAX list plus the port's
    (health, flight, attribution, incidents), both kicks (warmup), the
    first entry found (export), both packages' drains under one deadline,
    one engine of either package for an import, both packages' profiles."""
    port_fn = getattr(port_engine, name)
    if name == "take_kv_export":
        def seam(request_id):
            entry = jax_fn(request_id)
            return entry if entry is not None else port_fn(request_id)
    elif name == "kick_warmups":
        def seam():
            jax_fn()
            port_fn()
    elif name == "flight_report":
        def seam(summary_only=False, samples=240):
            return jax_fn(summary_only, samples) + port_fn(summary_only, samples)
    elif name == "drain_engines":
        async def seam(grace_s=30.0):
            # one deadline for the pod: the port drains in what is left
            deadline = time.monotonic() + grace_s
            reports = await jax_fn(grace_s)
            return _merge(reports, await port_fn(max(0.5, deadline - time.monotonic())))
    elif name == "import_kv_handoff":
        async def seam(payload, trace_header=None, deadline_header=None):
            if not _port_takes_import(payload, port_engine):
                # the JAX engine's, or its LayoutMismatch when no engine of
                # either package takes the model
                return await jax_fn(payload, trace_header, deadline_header)
            try:
                return await port_fn(payload, trace_header, deadline_header)
            except Exception as e:
                translated = _translated(e)
                if translated is e:
                    raise
                raise translated from e
    elif name == "profile_engines":
        def seam(action, trace_dir=None):
            return _merge(jax_fn(action, trace_dir), port_fn(action, trace_dir))
    elif name == "incident_report":
        def seam(bundle_id=None):
            return jax_fn(bundle_id) + port_fn(bundle_id)
    else:
        def seam():
            return jax_fn() + port_fn()
    seam.__name__ = name
    seam.__wrapped__ = jax_fn
    seam.with_port = True
    return seam


#: the pod's slice functions (``langstream_tpu/runtime/pod.py`` calls the
#: first two from ``run_agent``, and ``main`` calls ``run_agent``) that
#: :func:`register` points at the port's: joining, following, and the
#: agent's end, which closes the port's engines
SLICE_SEAM = ("maybe_join_slice", "_run_slice_follower", "run_agent")


def _slice_seam(name: str, jax_fn, device):
    """The port's ``name`` of the pod's slice seam, on ``device``: joining
    the ``torch.distributed`` group, replaying the leader's dispatches
    behind the pod's own info server, or running the agent and then closing
    the port's engines (a slice's world ends through its leader's
    ``stop``, every rank reaped)."""
    from langstream_tpu.runtime import pod
    from langstream_tpu_torch.runtime import pod as port_pod

    if name == "maybe_join_slice":
        def seam():
            port_pod.maybe_join_slice(device)
    elif name == "run_agent":
        async def seam(config_path, code_dir=None):
            try:
                await jax_fn(config_path, code_dir)
            finally:
                await port_pod.close_engines()
    else:
        async def seam(hosts, ordinal):
            await port_pod.run_slice_follower(hosts, ordinal, serve_info=pod._serve_info,
                                              device=device)
    seam.__name__ = name
    seam.__wrapped__ = jax_fn
    seam.with_port = True
    return seam


#: the platform operator's factory (``langstream_tpu/k8s/operator.py`` looks
#: it up at reconcile time) that :func:`register` points at the port's
OPERATOR_SEAM = ("AgentResourcesFactory",)


def _factory_seam(jax_factory, device):
    """The operator's ``AgentResourcesFactory`` over the port's: the calls
    ``AgentController`` makes, on its typed Agent CR, answered with the
    port's manifests at the placement ``LS_ACCELERATOR`` names
    (:func:`~langstream_tpu_torch.k8s.resources.accelerator_from_env`; the
    TPU name the operator passes is not used), the pods started on
    ``device``."""
    from langstream_tpu_torch.k8s.resources import AgentResourcesFactory as port
    from langstream_tpu_torch.k8s.resources import accelerator_from_env

    class PortAgentResourcesFactory:
        with_port = True
        __wrapped__ = jax_factory
        agent_resource_name = staticmethod(port.agent_resource_name)

        @staticmethod
        def generate_headless_service(cr):
            return port.generate_headless_service(cr.to_dict())

        @staticmethod
        def generate_statefulsets(cr, accelerator=None):
            return port.generate_statefulsets(cr.to_dict(), accelerator_from_env(),
                                              device=device)

        @staticmethod
        def generate_pod_disruption_budgets(cr, statefulsets):
            return port.generate_pod_disruption_budgets(cr.to_dict(), statefulsets)

    return PortAgentResourcesFactory


def _platform_trace() -> str | None:
    """The platform's ambient trace as a header value (None outside one)."""
    from langstream_tpu.core.tracing import current_context

    ctx = current_context()
    return ctx.to_header() if ctx is not None else None


def register(device="cuda") -> None:
    """Make the port serve every ``tpu-serving-configuration`` resource
    resolved from now on in this process, its stream keys registered with
    the platform's stream registry and its requests under the platform's
    ambient trace; mirror the port's journey edges and spans into the
    platform's ledger and span buffer; build the port's metric series in
    the platform's registry; point the pod's functions
    (:data:`POD_SEAM`) at the port's engines as well as the JAX package's,
    the pod's slice functions (:data:`SLICE_SEAM`) at the port's, and the
    operator's factory (:data:`OPERATOR_SEAM`) at the port's, its pods on
    ``device``. A second call changes nothing more: each seam is wrapped
    once."""
    import langstream_tpu.serving.engine as jax_engine
    from langstream_tpu.agents.services import register_provider
    from langstream_tpu.api.metrics import PrometheusMetricsReporter
    from langstream_tpu.core import tracing as jax_tracing
    from langstream_tpu.serving import journey as jax_journey
    from langstream_tpu.serving.streaming import STREAMS
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.core import metrics as port_metrics
    from langstream_tpu_torch.core import tracing as port_tracing
    from langstream_tpu_torch.serving import engine as port_engine
    from langstream_tpu_torch.serving import journey as port_journey

    register_provider(
        "tpu-serving-configuration",
        lambda resource: TorchServiceProvider(resource, device=device, streams=STREAMS,
                                              ambient_trace=_platform_trace),
    )
    port_journey.JOURNEYS.mirror = jax_journey.JOURNEYS
    port_tracing.SPANS.mirror = jax_tracing.SPANS
    port_metrics.REPORTER = PrometheusMetricsReporter
    for name in POD_SEAM:
        current = getattr(jax_engine, name)
        if not getattr(current, "with_port", False):
            setattr(jax_engine, name, _with_port(name, current, port_engine))
    from langstream_tpu.runtime import pod

    for name in SLICE_SEAM:
        current = getattr(pod, name)
        if not getattr(current, "with_port", False):
            setattr(pod, name, _slice_seam(name, current, device))
    from langstream_tpu.k8s import operator

    for name in OPERATOR_SEAM:
        current = getattr(operator, name)
        if not getattr(current, "with_port", False):
            setattr(operator, name, _factory_seam(current, device))


def main(argv: list[str] | None = None) -> None:
    """Register on ``--device`` (a leading option), then run what the
    remaining arguments name: ``pod <pod command ...>`` the platform's pod
    entrypoint, ``operator`` the platform's operator (after checking
    ``LS_ACCELERATOR``), ``controlplane`` the platform's control plane,
    anything else the CLI. It exits the process with the command's code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if argv[:1] == ["--device"]:
        if len(argv) < 2:
            raise SystemExit("serve_torch.py: --device needs a value (cpu or cuda)")
        device, argv = argv[1], argv[2:]
    register(device)
    if argv[:1] == ["pod"]:
        from langstream_tpu.runtime import pod

        raise SystemExit(pod.main(argv[1:]))
    if argv[:1] == ["operator"]:
        from langstream_tpu.k8s import operator
        from langstream_tpu_torch.k8s.resources import accelerator_from_env

        accelerator_from_env()  # a TPU name fails here, before the loop starts
        operator.main()
        return
    if argv[:1] == ["controlplane"]:
        import asyncio
        import logging

        from langstream_tpu.controlplane.__main__ import main as controlplane

        logging.basicConfig(level=logging.INFO)
        asyncio.run(controlplane())
        return
    from langstream_tpu.cli.main import cli

    cli.main(args=argv, prog_name="serve_torch.py")


if __name__ == "__main__":
    main()
