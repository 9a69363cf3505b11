"""Control-plane service entrypoint (the port's copy of
``langstream_tpu/controlplane/__main__.py``).

    python -m langstream_tpu_torch.controlplane [--device cuda|cpu]

Env:
- ``LS_MODE``: ``local`` (in-process agents — the dev/docker-compose mode;
  the default here). ``k8s`` (CRs + operator) is refused by name: the
  port's k8s compute runtime and stores are still to come, and this
  entrypoint never falls back to another mode.
- ``LS_PORT`` (default 8090), ``LS_BIND`` (default ``0.0.0.0``),
- ``LS_STORE_PATH``: filesystem store dir (the in-memory store without it),
- ``LS_ARCHETYPES``: archetype templates root for ``/api/archetypes``,
- ``LS_ADMIN_AUTH``: JSON admin-JWT validator config — enables bearer-token
  auth on every /api route (and thereby the full application view with
  secrets).

``tpu-serving-configuration`` resources serve on ``--device`` (the card
unless ``--device cpu`` is given; without a card the command fails, it
never falls back to the CPU). SIGINT or SIGTERM stops it: every
application is undeployed and the engines closed, exit 0.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys

#: why ``LS_MODE=k8s`` is refused
K8S_NOT_PORTED = (
    "LS_MODE=k8s: the control plane's k8s mode (KubernetesApplicationStore, "
    "KubernetesComputeRuntime) is not ported to langstream_tpu_torch yet; a later "
    "slice of the port brings it. Use LS_MODE=local."
)


async def main(device: str = "cuda") -> int:
    from langstream_tpu_torch._device import require_device
    from langstream_tpu_torch.agents import services
    from langstream_tpu_torch.cli.main import close_engines
    from langstream_tpu_torch.controlplane.server import (
        ControlPlaneServer,
        LocalComputeRuntime,
    )
    from langstream_tpu_torch.controlplane.stores import (
        FileSystemApplicationStore,
        InMemoryApplicationStore,
    )

    mode = os.environ.get("LS_MODE", "local")
    if mode != "local":
        print(f"error: {K8S_NOT_PORTED}" if mode == "k8s" else
              f"error: unknown LS_MODE {mode!r}", file=sys.stderr)
        return 2
    require_device(device, "python -m langstream_tpu_torch.controlplane")
    services.set_serving_device(device)
    port = int(os.environ.get("LS_PORT", "8090"))
    path = os.environ.get("LS_STORE_PATH")
    store = FileSystemApplicationStore(path) if path else InMemoryApplicationStore()
    admin_auth = (
        json.loads(os.environ["LS_ADMIN_AUTH"])
        if os.environ.get("LS_ADMIN_AUTH")
        else None
    )
    server = ControlPlaneServer(
        store=store, compute=LocalComputeRuntime(), port=port,
        host=os.environ.get("LS_BIND", "0.0.0.0"),
        archetypes_path=os.environ.get("LS_ARCHETYPES"),
        admin_auth=admin_auth,
    )
    await server.start()
    logging.getLogger(__name__).info(
        "control plane up on :%d (mode=%s)", server.port, mode
    )
    print(f"control plane: http://127.0.0.1:{server.port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        await server.stop()
        await close_engines()
    print("stopped", flush=True)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="python -m langstream_tpu_torch.controlplane")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    sys.exit(asyncio.run(main(parser.parse_args().device)))
