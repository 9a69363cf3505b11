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
disconnect frees the port's decode slot as it frees the JAX engine's.

This file is the seam between the two packages, the one that imports both,
and sits outside ``langstream_tpu_torch`` so that the port itself imports
nothing of JAX. The platform layers it starts (runner, gateway, control
plane) load JAX on import, so it runs only where JAX is installed;
``chip_smoke.py`` drives the port's provider on a card that has no JAX.
"""

from __future__ import annotations

import sys


def register(device="cuda") -> None:
    """Make the port serve every ``tpu-serving-configuration`` resource
    resolved from now on in this process, its stream keys registered with
    the platform's stream registry."""
    from langstream_tpu.agents.services import register_provider
    from langstream_tpu.serving.streaming import STREAMS
    from langstream_tpu_torch.agents.provider import TorchServiceProvider

    register_provider(
        "tpu-serving-configuration",
        lambda resource: TorchServiceProvider(resource, device=device, streams=STREAMS),
    )


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
