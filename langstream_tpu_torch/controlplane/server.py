"""The in-process compute runtime of the dev-mode ``run`` (the port's copy
of the part of ``langstream_tpu/controlplane/server.py`` that ``run`` and a
bench use): :func:`parse_stored` and :class:`LocalComputeRuntime`, which
deploys a stored application as an in-process
:class:`~langstream_tpu_torch.runtime.local_runner.LocalApplicationRunner`
and registers its gateways with the port's
:class:`~langstream_tpu_torch.gateway.server.GatewayRegistry`.

The control plane's REST server (``ControlPlaneServer``), its deploy-time
validators, the per-application log capture behind ``/logs``, the engine-
report routes and the shipping of custom Python code are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Any

from langstream_tpu_torch.api.application import Application
from langstream_tpu_torch.controlplane.stores import StoredApplication
from langstream_tpu_torch.core.parser import ModelBuilder
from langstream_tpu_torch.gateway.server import GatewayRegistry
from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner

log = logging.getLogger(__name__)


def parse_stored(stored: StoredApplication) -> Application:
    builder = ModelBuilder()
    for fname, content in sorted(stored.files.items()):
        builder.add_named_file(fname, content)
    if stored.instance:
        builder.add_instance(stored.instance)
    if stored.secrets:
        builder.add_secrets(stored.secrets)
    return builder.build()


class LocalComputeRuntime:
    """Runs deployed applications in-process (dev/single-node mode)."""

    def __init__(self, gateway_registry: GatewayRegistry | None = None):
        self.runners: dict[tuple[str, str], LocalApplicationRunner] = {}
        self.gateway_registry = gateway_registry

    async def deploy(
        self, stored: StoredApplication, application: Application | None = None
    ) -> None:
        if application is None:
            application = parse_stored(stored)
        key = (stored.tenant, stored.name)
        runner = LocalApplicationRunner(
            application, application_id=f"{stored.tenant}-{stored.name}"
        )
        await runner.start()
        self.runners[key] = runner
        log.info("application %s deployed", stored.name)
        if self.gateway_registry is not None:
            # gateways resolve against the *resolved* application
            self.gateway_registry.register(stored.tenant, stored.name, application)

    async def undeploy(self, tenant: str, name: str) -> None:
        key = (tenant, name)
        runner = self.runners.pop(key, None)
        if runner is not None:
            try:
                await runner.stop()
            except Exception:
                log.exception("error stopping %s/%s", tenant, name)
        if self.gateway_registry is not None:
            self.gateway_registry.unregister(tenant, name)

    def agent_info(self, tenant: str, name: str) -> list[dict[str, Any]]:
        runner = self.runners.get((tenant, name))
        return runner.agent_info() if runner else []

    async def close(self) -> None:
        for tenant, name in list(self.runners):
            await self.undeploy(tenant, name)
