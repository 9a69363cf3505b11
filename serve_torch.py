#!/usr/bin/env python3
"""Serve LangStream applications through the PyTorch port.

    python serve_torch.py [--device cpu|cuda] <langstream-tpu CLI arguments>

for example, the single-process dev mode on the chat example:

    python serve_torch.py run chat -app examples/applications/chat-completions
    python serve_torch.py --device cpu run chat -app <application directory>

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
pod's ``/healthz`` and ``/ready`` probes and its ``/kv/export`` pickup read
``health_report``, ``kick_warmups`` and ``take_kv_export`` from
``langstream_tpu.serving.engine`` when they run; :func:`register` points
those three at functions over both packages' engines, so a wedged port
engine answers 503 and a ``warmup-on-start`` port engine warms inside the
pod's not-ready window.

This file is the seam between the two packages, the one that imports both,
and sits outside ``langstream_tpu_torch`` so that the port itself imports
nothing of JAX. The platform layers it starts (runner, gateway, control
plane) load JAX on import, so it runs only where JAX is installed;
``chip_smoke.py`` drives the port's provider on a card that has no JAX.
"""

from __future__ import annotations

import sys


#: the pod functions (``langstream_tpu/runtime/pod.py`` reads them from
#: ``langstream_tpu.serving.engine`` at call time) that also answer for the
#: port's engines once :func:`register` ran
POD_SEAM = ("health_report", "kick_warmups", "take_kv_export")


def _with_port(name: str, jax_fn, port_fn):
    """``name`` over both packages' engines: the JAX list plus the port's
    (health), both kicks (warmup), the first entry found (export)."""
    if name == "take_kv_export":
        def seam(request_id):
            entry = jax_fn(request_id)
            return entry if entry is not None else port_fn(request_id)
    elif name == "kick_warmups":
        def seam():
            jax_fn()
            port_fn()
    else:
        def seam():
            return jax_fn() + port_fn()
    seam.__name__ = name
    seam.__wrapped__ = jax_fn
    seam.with_port = True
    return seam


def register(device="cuda") -> None:
    """Make the port serve every ``tpu-serving-configuration`` resource
    resolved from now on in this process, its stream keys registered with
    the platform's stream registry, and point the pod's probes and
    ``/kv/export`` (:data:`POD_SEAM`) at the port's engines as well as the
    JAX package's. A second call changes nothing more: the pod functions are
    wrapped once."""
    import langstream_tpu.serving.engine as jax_engine
    from langstream_tpu.agents.services import register_provider
    from langstream_tpu.serving.streaming import STREAMS
    from langstream_tpu_torch.agents.provider import TorchServiceProvider
    from langstream_tpu_torch.serving import engine as port_engine

    register_provider(
        "tpu-serving-configuration",
        lambda resource: TorchServiceProvider(resource, device=device, streams=STREAMS),
    )
    for name in POD_SEAM:
        current = getattr(jax_engine, name)
        if not getattr(current, "with_port", False):
            setattr(jax_engine, name, _with_port(name, current, getattr(port_engine, name)))


def main(argv: list[str] | None = None) -> None:
    """Register on ``--device`` (a leading option), then run the CLI on the
    remaining arguments; like any click entry point it exits the process
    with the command's code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if argv[:1] == ["--device"]:
        if len(argv) < 2:
            raise SystemExit("serve_torch.py: --device needs a value (cpu or cuda)")
        device, argv = argv[1], argv[2:]
    register(device)
    from langstream_tpu.cli.main import cli

    cli.main(args=argv, prog_name="serve_torch.py")


if __name__ == "__main__":
    main()
