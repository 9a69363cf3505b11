"""API-gateway service entrypoint (the port's copy of
``langstream_tpu/gateway/__main__.py``; the deploy manifests run this).

    python -m langstream_tpu_torch.gateway

Env: ``LS_PORT`` (default 8091), ``LS_CONTROL_PLANE_URL`` — the gateway
keeps its application registry in sync by polling the control plane's
application list (the reference's gateway reads the same store the
webservice writes; over HTTP here so the two services stay independently
deployable). The sync speaks HTTP through the port's stdlib client
(:func:`langstream_tpu_torch.gateway.wire.http_request`). SIGINT or SIGTERM
stops the gateway.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal

log = logging.getLogger(__name__)

#: seconds between two polls of the control plane
SYNC_INTERVAL_S = 5.0


async def _sync_registry(registry, control_plane_url: str) -> None:
    """Poll the control plane and keep the gateway registry consistent:
    deployed apps (re)register, deleted apps unregister. When the control
    plane runs with admin auth, ``LS_CONTROL_PLANE_TOKEN`` carries the
    bearer token; that same auth is what entitles the sync to the full view
    including secrets (placeholder resolution for gateway auth configs)."""
    from langstream_tpu_torch.controlplane.server import parse_stored
    from langstream_tpu_torch.controlplane.stores import StoredApplication

    from langstream_tpu_torch.core.placeholders import resolve_placeholders
    from langstream_tpu_torch.gateway.wire import http_request

    headers = {}
    token = os.environ.get("LS_CONTROL_PLANE_TOKEN")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    known: dict[tuple[str, str], str] = {}

    async def get_json(path: str):
        status, reason, _, payload = await http_request(
            "GET", f"{control_plane_url}{path}", body=None, headers=headers)
        if status >= 400:
            raise RuntimeError(f"GET {path}: {status} {reason}")
        return json.loads(payload)

    async def sync_one(tenant: str, app_name: str) -> None:
        body = await get_json(f"/api/applications/{tenant}/{app_name}?files=true")
        files = body.get("files") or {}
        # fingerprint the whole deployable state: instance/secrets-only
        # updates (broker moves, credential rotation) must propagate too
        fingerprint = str(
            (sorted(files.items()), body.get("instance"), body.get("secrets"))
        )
        if known.get((tenant, app_name)) == fingerprint:
            return
        stored = StoredApplication(
            tenant=tenant,
            name=app_name,
            files=files,
            instance=body.get("instance"),
            secrets=body.get("secrets"),
        )
        application = parse_stored(stored)
        # the gateway serves the RESOLVED app (auth configs and streaming
        # clusters reference ${secrets.*}/${globals.*}) — exactly what the
        # compute runtime resolves before deploying. Fail CLOSED on
        # unresolvable placeholders: serving a gateway whose auth secret is
        # the literal '${secrets...}' string would let anyone who reads the
        # config pass authentication.
        try:
            resolve_placeholders(application)
        except Exception as e:
            log.error(
                "app %s/%s not served: %s. The control plane withholds "
                "secrets unless admin auth is enabled — set LS_ADMIN_AUTH "
                "on the control plane and LS_CONTROL_PLANE_TOKEN here.",
                tenant, app_name, e,
            )
            known[(tenant, app_name)] = fingerprint  # don't retry-spam
            return
        registry.register(tenant, app_name, application)
        known[(tenant, app_name)] = fingerprint

    async def sync_fleet(tenant: str, app_name: str) -> None:
        """Replica-router feed (docs/FLEET.md): the control plane's
        autoscaler already fans in per-replica observations — the
        gateway consumes the same snapshot for least-loaded routing and
        session affinity. Polled only for apps whose own resources
        declare an enabled ``autoscale:`` section — everything else
        would answer ``{"enabled": false}`` forever, and N apps x one
        extra round-trip per 5 s tick is pure waste. The 5 s cadence
        keeps snapshots inside the router's 15 s freshness window."""
        from langstream_tpu_torch.controlplane.autoscaler import (
            application_autoscale_spec,
        )

        app = registry.application(tenant, app_name)
        if app is None or application_autoscale_spec(app) is None:
            return
        body = await get_json(f"/api/applications/{tenant}/{app_name}/autoscaler")
        if body.get("enabled") and body.get("replicas"):
            registry.update_fleet(tenant, app_name, body["replicas"])
        elif body.get("enabled") and body.get("pools"):
            # disaggregated app (docs/DISAGG.md): one autoscaler status
            # per pool — feed each pool's replicas under its own source
            # so the router keeps the union of both pools
            for pool, status in body["pools"].items():
                if status.get("replicas"):
                    registry.update_fleet(
                        tenant, app_name, status["replicas"], source=pool
                    )

    while True:
        try:
            tenants = await get_json("/api/tenants")
            current: set[tuple[str, str]] = set()
            for tenant in tenants:
                apps = await get_json(f"/api/applications/{tenant}")
                for app_name in apps:
                    current.add((tenant, app_name))
                    try:
                        # one broken app must not block the rest of the
                        # sync (or the unregistration pass below)
                        await sync_one(tenant, app_name)
                    except Exception as e:
                        log.warning(
                            "sync of %s/%s failed: %s", tenant, app_name, e
                        )
                        continue
                    try:
                        await sync_fleet(tenant, app_name)
                    except Exception as e:
                        # the registration above stands — a failed
                        # fleet poll only leaves the router feed
                        # stale, and the 15 s freshness window
                        # degrades that to stamping nothing
                        log.debug(
                            "fleet sync of %s/%s failed: %s",
                            tenant, app_name, e,
                        )
            # deleted apps must stop resolving (their gateways would
            # otherwise keep serving stale topic access forever)
            for tenant, app_name in set(known) - current:
                registry.unregister(tenant, app_name)
                del known[(tenant, app_name)]
        except Exception as e:
            log.warning("registry sync failed: %s", e)
        await asyncio.sleep(SYNC_INTERVAL_S)


async def main() -> None:
    from langstream_tpu_torch.gateway.server import GatewayRegistry, GatewayServer

    port = int(os.environ.get("LS_PORT", "8091"))
    registry = GatewayRegistry()
    server = GatewayServer(
        registry=registry, port=port,
        host=os.environ.get("LS_BIND", "0.0.0.0"),
    )
    await server.start()
    log.info("api gateway up on :%d", server.port)
    print(f"api gateway: ws://127.0.0.1:{server.port}", flush=True)
    sync_task = None
    control_plane = os.environ.get("LS_CONTROL_PLANE_URL")
    if control_plane:
        sync_task = asyncio.ensure_future(
            _sync_registry(registry, control_plane.rstrip("/"))
        )
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    if sync_task is not None:
        sync_task.cancel()
    await server.stop()
    print("stopped", flush=True)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    asyncio.run(main())
