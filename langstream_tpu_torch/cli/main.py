"""The port's dev-mode ``run``: one process parses an application, plans
it, runs every agent under the port's runner on the in-memory broker, and
serves its gateways, until SIGINT or SIGTERM.

    python -m langstream_tpu_torch.cli run NAME -app DIR [-i INSTANCE]
        [-s SECRETS] [--gateway-port P] [--device cuda|cpu]

It follows the JAX package's ``run`` (``langstream_tpu/cli/main.py``)
without the control plane's REST port: the application is deployed
straight into the in-process compute runtime, and the gateway's routes are
the JAX gateway's (``ws://127.0.0.1:<P>/v1/{produce,consume,chat}/default/
<NAME>/<gateway>``). ``tpu-serving-configuration`` resources serve on
``--device``: the card unless ``--device cpu`` is given; with no card and
no ``--device cpu`` the command fails (``require_device``), it never falls
back to the CPU. A signal stops the gateway, undeploys the application,
closes the engines and exits 0.

:class:`LocalRun` is the same in-process, for callers that drive an
application themselves (the smoke, the tests).
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys
from pathlib import Path
from typing import Any

from langstream_tpu_torch.controlplane.server import LocalComputeRuntime
from langstream_tpu_torch.controlplane.stores import StoredApplication
from langstream_tpu_torch.gateway.server import GatewayRegistry, GatewayServer

TENANT = "default"


def collect_files(app_dir: Path) -> dict[str, str]:
    """An application directory's YAML files as the control plane stores
    them (custom Python agents, which ship their ``python/`` code, are not
    ported yet)."""
    files = {}
    for path in sorted(app_dir.glob("*.yaml")) + sorted(app_dir.glob("*.yml")):
        files[path.name] = path.read_text()
    if not files:
        raise ValueError(f"no YAML files in {app_dir}")
    return files


class LocalRun:
    """One application deployed in this process behind its gateway:
    ``await LocalRun(...).start()``, then :meth:`url` for a gateway's
    socket and :attr:`runner` for its topics; :meth:`stop` undeploys it and
    closes the port's engines.

    One run serves in a process at a time: the serving device and the
    engines are the process's, so :meth:`start` refuses a second run until
    the first has stopped, and :meth:`stop` puts the serving device back."""

    _active: "LocalRun | None" = None

    def __init__(self, name: str, app: str | Path, instance: str | Path | None = None,
                 secrets: str | Path | None = None, gateway_port: int = 8091,
                 device: str = "cuda", host: str = "127.0.0.1"):
        from langstream_tpu_torch._device import require_device

        require_device(device, "langstream_tpu_torch.cli run")
        self.name = name
        self.app = Path(app)
        self.instance = Path(instance).read_text() if instance else None
        self.secrets = Path(secrets).read_text() if secrets else None
        self.device = device
        self.registry = GatewayRegistry()
        self.compute = LocalComputeRuntime(gateway_registry=self.registry)
        self.gateway = GatewayServer(registry=self.registry, port=gateway_port, host=host)

    async def start(self) -> "LocalRun":
        from langstream_tpu_torch.agents import services

        if LocalRun._active is not None:
            raise RuntimeError(
                f"application {LocalRun._active.name!r} is already served in this "
                "process; stop it before starting another")
        LocalRun._active = self
        self._previous_device = services.SERVING_DEVICE
        services.set_serving_device(self.device)
        stored = StoredApplication(
            tenant=TENANT, name=self.name, files=collect_files(self.app),
            instance=self.instance, secrets=self.secrets,
        )
        try:
            await self.gateway.start()
            await self.compute.deploy(stored)
        except BaseException:
            await self.stop()
            raise
        return self

    @property
    def runner(self):
        """The application's :class:`LocalApplicationRunner`."""
        return self.compute.runners[(TENANT, self.name)]

    def url(self, kind: str, gateway: str, **params: str) -> str:
        """``ws://host:port/v1/<kind>/default/<name>/<gateway>?param:k=v``."""
        from urllib.parse import urlencode

        query = urlencode({f"param:{k}": v for k, v in params.items()})
        base = f"ws://{self.gateway.host}:{self.gateway.port}/v1/{kind}/{TENANT}/{self.name}/{gateway}"
        return f"{base}?{query}" if query else base

    async def stop(self) -> None:
        from langstream_tpu_torch.agents import services

        try:
            await self.gateway.stop()
            await self.compute.close()
        finally:
            try:
                await close_engines()
            finally:
                services.set_serving_device(self._previous_device)
                LocalRun._active = None

    async def __aenter__(self) -> "LocalRun":
        return await self.start()

    async def __aexit__(self, *exc: Any) -> None:
        await self.stop()


async def close_engines() -> None:
    """Close and forget every serving engine the port started in this
    process (their dispatch threads end with them)."""
    from langstream_tpu_torch.serving.engine import TorchServingEngine

    engines = list(TorchServingEngine._instances.values())
    TorchServingEngine.reset_instances()
    for engine in engines:
        await engine.close()


async def run(name: str, app: str, instance: str | None = None, secrets: str | None = None,
              gateway_port: int = 8091, device: str = "cuda") -> int:
    """Serve ``app`` until SIGINT or SIGTERM, then stop cleanly (exit 0)."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    local = LocalRun(name, app, instance, secrets, gateway_port=gateway_port, device=device)
    await local.start()
    print(f"application {name!r} deployed", flush=True)
    print(f"gateway:       ws://127.0.0.1:{local.gateway.port}", flush=True)
    try:
        await stop.wait()
    finally:
        await local.stop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)
    print("stopped", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m langstream_tpu_torch.cli",
        description="LangStream applications through the PyTorch port.")
    commands = parser.add_subparsers(dest="command", required=True)
    run_cmd = commands.add_parser(
        "run", help="single-process dev mode: deploy the application and serve "
                    "its gateways until interrupted")
    run_cmd.add_argument("name")
    run_cmd.add_argument("-app", "--application", dest="app", required=True)
    run_cmd.add_argument("-i", "--instance", default=None)
    run_cmd.add_argument("-s", "--secrets", default=None)
    run_cmd.add_argument("--gateway-port", type=int, default=8091)
    run_cmd.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    for path in (args.app, args.instance, args.secrets):
        if path is not None and not Path(path).exists():
            print(f"error: {path} does not exist", file=sys.stderr)
            return 2
    return asyncio.run(run(args.name, args.app, args.instance, args.secrets,
                           gateway_port=args.gateway_port, device=args.device))
