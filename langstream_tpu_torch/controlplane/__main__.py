"""Control-plane service entrypoint (the port's copy of
``langstream_tpu/controlplane/__main__.py``).

    python -m langstream_tpu_torch.controlplane [--device cuda|cpu]

Env:
- ``LS_MODE``: ``local`` (in-process agents — the dev/docker-compose mode;
  the default here) or ``k8s`` (Application CRs, Agent CRs and Secrets
  through the kube API, ``HttpKubeApi.in_cluster()``, which the operator
  reconciles into the port's pods: the port's
  :class:`~langstream_tpu_torch.k8s.stores.KubernetesApplicationStore` and
  :class:`~langstream_tpu_torch.k8s.compute.KubernetesComputeRuntime`).
  Any other mode is refused by name.
- ``LS_PORT`` (default 8090), ``LS_BIND`` (default ``0.0.0.0``),
- ``LS_RUNTIME_IMAGE`` (k8s: the agent pods' image, default the port's
  runtime image), ``LS_CODE_STORAGE`` (k8s: JSON code-storage config,
  ``type``/``configuration``),
- ``LS_STORE_PATH``: filesystem store dir for local mode (the in-memory
  store without it),
- ``LS_ARCHETYPES``: archetype templates root for ``/api/archetypes``,
- ``LS_ADMIN_AUTH``: JSON admin-JWT validator config — enables bearer-token
  auth on every /api route (and thereby the full application view with
  secrets).

In local mode ``tpu-serving-configuration`` resources serve on
``--device`` (the card unless ``--device cpu`` is given; without a card the
command fails, it never falls back to the CPU); in k8s mode the agents
serve in their pods, on the device the operator gives them, and this
process needs no card. SIGINT or SIGTERM stops it: in local mode every
application is undeployed and the engines closed; exit 0.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import signal
import sys

#: the modes this entrypoint serves
MODES = ("local", "k8s")


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
    if mode not in MODES:
        print(f"error: unknown LS_MODE {mode!r}; known: {', '.join(MODES)}",
              file=sys.stderr)
        return 2
    port = int(os.environ.get("LS_PORT", "8090"))
    if mode == "k8s":
        from langstream_tpu_torch.k8s.client import HttpKubeApi
        from langstream_tpu_torch.k8s.cluster_runtime import DEFAULT_IMAGE
        from langstream_tpu_torch.k8s.compute import KubernetesComputeRuntime
        from langstream_tpu_torch.k8s.stores import KubernetesApplicationStore

        code_storage = (json.loads(os.environ["LS_CODE_STORAGE"])
                        if os.environ.get("LS_CODE_STORAGE") else None)
        api = HttpKubeApi.in_cluster()
        image = os.environ.get("LS_RUNTIME_IMAGE", DEFAULT_IMAGE)
        store = KubernetesApplicationStore(api, runtime_image=image,
                                           code_storage_config=code_storage)
        compute = KubernetesComputeRuntime(api, image=image,
                                           code_storage_config=code_storage)
    else:
        require_device(device, "python -m langstream_tpu_torch.controlplane")
        services.set_serving_device(device)
        path = os.environ.get("LS_STORE_PATH")
        store = FileSystemApplicationStore(path) if path else InMemoryApplicationStore()
        compute = LocalComputeRuntime()
    admin_auth = (
        json.loads(os.environ["LS_ADMIN_AUTH"])
        if os.environ.get("LS_ADMIN_AUTH")
        else None
    )
    server = ControlPlaneServer(
        store=store, compute=compute, port=port,
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
