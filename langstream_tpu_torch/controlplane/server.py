"""REST control plane + in-process compute runtime: the port's copy of
``langstream_tpu/controlplane/server.py``, on the port's stdlib HTTP server
(:mod:`langstream_tpu_torch.gateway.wire`) instead of aiohttp. The admin-JWT
check is a wrapper around every handler (the server's ``middleware``), and a
``multipart/form-data`` deploy is parsed with the standard library's
``email`` package. The same wrapper answers 400 to a tenant or application
name that is not one plain path segment (``stores.validate_name``): the
file-system store and the code directory join both names to paths.

Endpoints (parity: ``ApplicationResource.java:79``, ``TenantResource.java:45``):

- PUT/GET/DELETE ``/api/tenants/{tenant}``; GET ``/api/tenants``
- POST   ``/api/applications/{tenant}/{name}`` — deploy (JSON body:
  ``{"files": {"pipeline.yaml": "...", ...}, "instance": "...",
  "secrets": "..."}``; multipart zip also accepted)
- PATCH  — update (revalidated against the running plan)
- GET    — describe (status); DELETE — undeploy
- GET    ``/api/applications/{tenant}`` — list
- GET    ``/api/applications/{tenant}/{name}/logs`` — recent log lines

Deploy path mirrors the reference: parse → ``createImplementation`` (plan,
validation; ``ApplicationService.java:71-98``) → store → hand to the
compute runtime. In dev/single-node mode the compute runtime is in-process
(agents run as asyncio tasks, the role of the reference's tester); under
the k8s layer the same store contents drive the operator (the port's k8s
compute runtime is still to come: ``python -m
langstream_tpu_torch.controlplane`` refuses ``LS_MODE=k8s`` by name).
"""

from __future__ import annotations

import io
import logging
import zipfile
from collections import deque
from typing import Any

from langstream_tpu_torch.api.application import Application
from langstream_tpu_torch.controlplane.stores import (
    ApplicationStore,
    InMemoryApplicationStore,
    StoredApplication,
    validate_name,
)
from langstream_tpu_torch.controlplane.autoscaler import (
    FleetAutoscaler,
    application_autoscale_specs,
    validate_application_autoscale,
)
from langstream_tpu_torch.core.parser import ModelBuilder
from langstream_tpu_torch.gateway import wire
from langstream_tpu_torch.gateway.auth import validate_gateway_authentication
from langstream_tpu_torch.gateway.server import GatewayRegistry
from langstream_tpu_torch.serving.adapters import validate_application_adapter_store
from langstream_tpu_torch.serving.health import validate_application_slo
from langstream_tpu_torch.serving.prefixstore import validate_application_prefix_store
from langstream_tpu_torch.serving.qos import validate_application_qos
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
        self.logs: dict[tuple[str, str], deque[str]] = {}
        self._log_handlers: dict[tuple[str, str], logging.Handler] = {}
        self._code_dirs: dict[tuple[str, str], str] = {}

    def _materialize_code(
        self,
        key: tuple[str, str],
        stored: StoredApplication,
        application: Application,
    ) -> None:
        """Write the app's shipped ``python/`` files to a temp package dir so
        custom agents can import them (the dev-mode stand-in for the code
        archive an agent pod's init container downloads)."""
        if application.directory:
            return  # parsed straight from a real directory
        python_files = {
            name: content
            for name, content in stored.files.items()
            if name.startswith("python/")
        }
        if not python_files:
            return
        import shutil
        import tempfile

        old = self._code_dirs.pop(key, None)
        if old:
            shutil.rmtree(old, ignore_errors=True)
        code_dir = tempfile.mkdtemp(prefix=f"ls-app-{stored.name}-")
        from pathlib import Path as _Path

        for name, content in python_files.items():
            target = _Path(code_dir) / name
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text(content)
        self._code_dirs[key] = code_dir
        application.directory = code_dir

    async def deploy(
        self, stored: StoredApplication, application: Application | None = None
    ) -> None:
        if application is None:
            application = parse_stored(stored)
        key = (stored.tenant, stored.name)
        self._materialize_code(key, stored, application)
        runner = LocalApplicationRunner(
            application, application_id=f"{stored.tenant}-{stored.name}"
        )
        self._attach_log_capture(key)
        try:
            await runner.start()
        except Exception:
            # failed deploys must not leave the capture handler attached
            self._detach_log_capture(key)
            raise
        self.runners[key] = runner
        self.append_log(*key, f"application {stored.name} deployed")
        if self.gateway_registry is not None:
            # gateways resolve against the *resolved* application
            self.gateway_registry.register(stored.tenant, stored.name, application)
            # dev-mode agent-proxy targets: a service agent that declares
            # ``service-port`` is reachable on localhost here (in-cluster the
            # registry falls back to the agent's headless-service name)
            for agent in application.all_agents():
                port = (agent.configuration or {}).get("service-port")
                if port:
                    self.gateway_registry.register_service_uri(
                        stored.tenant, stored.name, agent.id,
                        f"http://127.0.0.1:{int(port)}",
                    )

    async def undeploy(self, tenant: str, name: str) -> None:
        key = (tenant, name)
        runner = self.runners.pop(key, None)
        if runner is not None:
            try:
                await runner.stop()
            except Exception:
                log.exception("error stopping %s/%s", tenant, name)
        self._detach_log_capture(key)
        self.logs.pop(key, None)  # buffers die with the app (no slow leak)
        code_dir = self._code_dirs.pop(key, None)
        if code_dir:
            import shutil

            shutil.rmtree(code_dir, ignore_errors=True)
        if self.gateway_registry is not None:
            self.gateway_registry.unregister(tenant, name)

    def _detach_log_capture(self, key: tuple[str, str]) -> None:
        handler = self._log_handlers.pop(key, None)
        if handler is not None:
            logging.getLogger("langstream_tpu_torch").removeHandler(handler)

    def _attach_log_capture(self, key: tuple[str, str]) -> None:
        """Capture framework log lines for the /logs endpoint (the role pod
        log streaming plays in the reference, ``ApplicationResource.java:318``).
        Dev-mode caveat: all in-process apps share the logger namespace, so
        each app's buffer sees the whole process's framework logs."""
        buffer = self.logs.setdefault(key, deque(maxlen=1000))

        class _Capture(logging.Handler):
            def emit(self, record: logging.LogRecord) -> None:
                try:
                    buffer.append(self.format(record))
                except Exception:
                    # stderr via logging's own raiseExceptions machinery;
                    # logging from inside a handler would recurse
                    self.handleError(record)

        handler = _Capture(level=logging.INFO)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
        )
        logging.getLogger("langstream_tpu_torch").addHandler(handler)
        self._log_handlers[key] = handler

    def append_log(self, tenant: str, name: str, line: str) -> None:
        self.logs.setdefault((tenant, name), deque(maxlen=1000)).append(line)

    def pod_logs(
        self, tenant: str, name: str, tail: int = 200
    ) -> dict[str, list[str]]:
        """Dev mode runs agents in-process — there are no pods, so no
        per-pod log files; everything lands in the framework buffer."""
        return {}

    def traces(
        self, tenant: str, name: str, trace_id: str | None = None
    ) -> list[dict[str, Any]]:
        """Trace data for the /traces aggregation route. Dev mode runs every
        agent (and the gateway) in-process, so the process-global span
        buffer already IS the aggregate; scope to traces that touched this
        application by its runners' EXACT agent ids — prefix matching would
        leak traces across dash-prefixed app ids (``app`` vs ``app-b``),
        the same bug pod_logs fixed with label selectors."""
        from langstream_tpu_torch.core.tracing import SPANS

        runner = self.runners.get((tenant, name))
        agent_ids = (
            {r.agent_id for r in runner.runners} if runner is not None else set()
        )
        if trace_id is not None:
            # the full trace, cross-service (gateway + agent + engine
            # spans) — but only once the trace verifiably touched this
            # app, so one tenant's route can't read another's spans
            spans = SPANS.spans(trace_id)
            if any(s.get("service") in agent_ids for s in spans):
                return spans
            return []
        return [
            summary
            for summary in SPANS.summaries()
            if any(svc in agent_ids for svc in summary["services"])
        ]

    def journey(self, tenant: str, name: str, journey_id: str) -> dict[str, Any]:
        """Stitched request journey for the
        ``/api/applications/{t}/{n}/journey/{id}`` route. Dev mode runs
        every agent, the gateway, and the engines in-process, so the
        process-global ledger (serving/journey.py) already holds the
        whole journey — the "stitch" is over one partial. Scoped like
        :meth:`traces`: the journey must verifiably touch one of the
        app's declared models (the engine's submit/import/finish edges
        carry ``model``), so one tenant's route can't read another's
        request lifecycles. Wait-free (graftcheck OBS506): snapshot
        reads + stitch arithmetic only."""
        from langstream_tpu_torch.serving.journey import JOURNEYS, stitch

        models = self._declared_models(tenant, name) or set()
        events = JOURNEYS.events(journey_id)
        if not any(e.get("model") in models for e in events):
            return {}
        return stitch(journey_id, [events])

    def qos(self, tenant: str, name: str) -> dict[str, Any]:
        """QoS status for the /qos route: the app's declared qos sections
        plus each live engine's scheduler counters (per-class queued/
        admitted/shed/preempted, tenant throttles). Reads the same
        ``stats()["scheduler"]`` section the pod's ``/flight/summary``
        carries, scoped to the app's declared models like :meth:`flight`
        — no extra engine surface."""
        from langstream_tpu_torch.serving.engine import flight_report

        runner = self.runners.get((tenant, name))
        if runner is None:
            return {"configured": {}, "engines": []}
        models = self._declared_models(tenant, name) or set()
        configured = {
            res_name: (res.configuration or {}).get("qos")
            for res_name, res in runner.application.resources.items()
            if res.type == "tpu-serving-configuration"
        }
        engines = [
            {"model": e["model"], "scheduler": e.get("scheduler")}
            for e in flight_report(summary_only=True)
            if e["model"] in models
        ]
        return {"configured": configured, "engines": engines}

    def _declared_models(self, tenant: str, name: str) -> set[str] | None:
        """Models the app's serving resources declare (None when the app
        isn't deployed here) — the scope every engine-reading route
        applies, since dev-mode engines are process-global and one
        tenant's route must not read another's telemetry."""
        runner = self.runners.get((tenant, name))
        if runner is None:
            return None
        return {
            (res.configuration or {}).get("model", "tiny")
            for res in runner.application.resources.values()
            if res.type == "tpu-serving-configuration"
        }

    def health(self, tenant: str, name: str) -> dict[str, Any]:
        """Fleet health for the /health route: the watchdog verdicts of
        this app's in-process engines (serving/health.py), worst-state
        aggregated. Dev mode has no pods, so ``pods`` carries one
        synthetic in-process member per engine."""
        from langstream_tpu_torch.serving.engine import health_report
        from langstream_tpu_torch.serving.health import worst_state

        models = self._declared_models(tenant, name)
        if models is None:
            return {"status": "ok", "pods": []}
        engines = [e for e in health_report() if e.get("model") in models]
        return {
            "status": worst_state(e.get("state", "wedged") for e in engines),
            "pods": [
                {"pod": "in-process", "status": e.get("state"), "engines": [e]}
                for e in engines
            ],
        }

    def slo(self, tenant: str, name: str) -> dict[str, Any]:
        """SLO status for the /slo route: declared objectives (from the
        app's serving resources) plus each live engine's burn-rate
        evaluation — the same ``slo`` section the pod's /flight/summary
        carries, scoped to the app's declared models like :meth:`qos`."""
        from langstream_tpu_torch.serving.engine import flight_report

        runner = self.runners.get((tenant, name))
        if runner is None:
            return {"configured": {}, "engines": []}
        models = self._declared_models(tenant, name) or set()
        configured = {
            res_name: (res.configuration or {}).get("slo")
            for res_name, res in runner.application.resources.items()
            if res.type == "tpu-serving-configuration"
        }
        engines = [
            {"model": e["model"], "slo": e.get("slo")}
            for e in flight_report(summary_only=True)
            if e["model"] in models
        ]
        return {"configured": configured, "engines": engines}

    def flight(self, tenant: str, name: str) -> list[dict[str, Any]]:
        """Engine flight-recorder data for the /flight aggregation route,
        scoped to the models the application's serving resources declare —
        engines are process-global in dev mode, and without the scope one
        tenant's route would read every other in-process tenant's engine
        telemetry (the same leak shape the traces route closes with exact
        agent ids). Two apps declaring the same model genuinely share one
        engine and both see it. Empty when the app isn't deployed here or
        declares no TPU serving resource (the mock provider has no
        engine)."""
        from langstream_tpu_torch.serving.engine import flight_report

        models = self._declared_models(tenant, name)
        if models is None:
            return []
        return [e for e in flight_report() if e["model"] in models]

    def attribution(self, tenant: str, name: str) -> list[dict[str, Any]]:
        """Device-attribution payloads for the /attribution aggregation
        route (per-program cost ledger + HBM memory ledger,
        serving/attribution.py), scoped to the app's declared models
        exactly like :meth:`flight` — dev-mode engines are
        process-global, and one tenant's route must not read another's
        device economics."""
        from langstream_tpu_torch.serving.engine import attribution_report

        models = self._declared_models(tenant, name)
        if models is None:
            return []
        return [
            e for e in attribution_report() if e.get("model") in models
        ]

    def incidents(
        self, tenant: str, name: str, bundle_id: str | None = None
    ) -> list[dict[str, Any]]:
        """Incident-bundle index (or one full bundle) for the /incidents
        aggregation route (serving/incident.py), scoped to the app's
        declared models exactly like :meth:`flight` — a breach bundle
        carries one tenant's journeys and config, so the scope is a
        confidentiality boundary, not a convenience."""
        from langstream_tpu_torch.serving.engine import incident_report

        models = self._declared_models(tenant, name)
        if models is None:
            return []
        return [
            e
            for e in incident_report(bundle_id)
            if e.get("model") in models
        ]

    def agent_info(self, tenant: str, name: str) -> list[dict[str, Any]]:
        runner = self.runners.get((tenant, name))
        return runner.agent_info() if runner else []

    async def close(self) -> None:
        for tenant, name in list(self.runners):
            await self.undeploy(tenant, name)


class ControlPlaneServer:
    def __init__(
        self,
        store: ApplicationStore | None = None,
        compute: LocalComputeRuntime | None = None,
        port: int = 8090,
        archetypes_path: str | None = None,
        admin_auth: dict[str, Any] | None = None,
        host: str = "127.0.0.1",
    ):
        self.store = store or InMemoryApplicationStore()
        self.compute = compute or LocalComputeRuntime()
        self.port = port
        self.host = host
        self.archetypes_path = archetypes_path
        self.admin_auth = admin_auth

        async def check_names(request, handler):
            for key, kind in (("tenant", "tenant"), ("name", "application")):
                value = request.match_info.get(key)
                if value is not None:
                    try:
                        validate_name(kind, value)
                    except ValueError as e:
                        raise wire.HTTPException(400, str(e))
            return await handler(request)

        middleware = check_names
        if admin_auth:
            # admin JWT on every /api route (parity: TokenAuthFilter)
            from langstream_tpu_torch.auth.jwt import JwtError, JwtValidator

            validator = JwtValidator.from_config(admin_auth)

            async def auth_middleware(request, handler):
                # the wire strips a header value's trailing blanks, which
                # aiohttp keeps: "Bearer " with no token is still "missing"
                auth_header = request.headers.get("authorization", "") + " "
                token = auth_header.removeprefix("Bearer ").strip()
                if not token:
                    raise wire.HTTPException(401, "missing bearer token")
                try:
                    request.principal = validator.validate(token)
                except JwtError as e:
                    raise wire.HTTPException(401, str(e))
                return await check_names(request, handler)

            middleware = auth_middleware
        self.server = wire.HttpServer(
            [
                ("GET", "/api/tenants", self._list_tenants),
                ("PUT", "/api/tenants/{tenant}", self._put_tenant),
                ("GET", "/api/tenants/{tenant}", self._get_tenant),
                ("DELETE", "/api/tenants/{tenant}", self._delete_tenant),
                ("GET", "/api/applications/{tenant}", self._list_apps),
                ("POST", "/api/applications/{tenant}/{name}", self._deploy),
                ("PATCH", "/api/applications/{tenant}/{name}", self._update),
                ("GET", "/api/applications/{tenant}/{name}", self._get_app),
                ("DELETE", "/api/applications/{tenant}/{name}", self._delete_app),
                ("GET", "/api/applications/{tenant}/{name}/logs", self._logs),
                ("GET", "/api/applications/{tenant}/{name}/traces", self._traces),
                ("GET", "/api/applications/{tenant}/{name}/traces/{trace_id}", self._trace),
                ("GET", "/api/applications/{tenant}/{name}/flight", self._flight),
                ("GET", "/api/applications/{tenant}/{name}/attribution", self._attribution),
                ("GET", "/api/applications/{tenant}/{name}/journey/{journey_id}", self._journey),
                ("GET", "/api/applications/{tenant}/{name}/incidents", self._incidents),
                ("GET", "/api/applications/{tenant}/{name}/incidents/{bundle_id}",
                 self._incidents),
                ("GET", "/api/applications/{tenant}/{name}/qos", self._qos),
                ("GET", "/api/applications/{tenant}/{name}/health", self._health),
                ("GET", "/api/applications/{tenant}/{name}/slo", self._slo),
                ("GET", "/api/applications/{tenant}/{name}/autoscaler", self._autoscaler),
                ("GET", "/api/applications/{tenant}/{name}/code", self._download_code),
                ("GET", "/api/applications/{tenant}/{name}/agents", self._agents),
                # archetypes (parity: ArchetypeResource)
                ("GET", "/api/archetypes/{tenant}", self._list_archetypes),
                ("GET", "/api/archetypes/{tenant}/{id}", self._get_archetype),
                ("POST", "/api/archetypes/{tenant}/{id}/applications/{name}",
                 self._deploy_from_archetype),
                # agent-type documentation (parity: DocumentationGenerator)
                ("GET", "/api/docs/agents", self._agent_docs),
            ],
            host=host,
            port=port,
            middleware=middleware,
            max_body=64 * 1024 * 1024,
        )
        # per-application fleet autoscalers (controlplane/autoscaler.py):
        # created at deploy for apps whose serving resource declares an
        # enabled autoscale section AND whose compute runtime can scale
        # (the k8s runtime; dev mode has no replicas to scale). A
        # disaggregated app (pools: section, docs/DISAGG.md) runs one
        # reconcile loop PER POOL — prefill scales on queue depth,
        # decode on KV reserved fraction, each against its own STS.
        self.autoscalers: dict[tuple[str, str], list[FleetAutoscaler]] = {}

    async def start(self) -> None:
        """Listen; with ``port=0`` a free port is bound and ``port`` holds it."""
        await self.server.start()
        self.port = self.server.port
        log.info("control plane listening on :%d", self.port)

    async def stop(self) -> None:
        for key in list(self.autoscalers):
            await self._stop_autoscaler(key)
        await self.compute.close()
        await self.server.stop()

    # ---- fleet autoscaler lifecycle --------------------------------------

    async def _stop_autoscaler(self, key: tuple[str, str]) -> None:
        scalers = self.autoscalers.pop(key, None)
        for scaler in scalers or []:
            await scaler.stop()

    async def _sync_autoscaler(self, stored: StoredApplication, application) -> None:
        """(Re)start the app's fleet autoscaler(s) after a deploy: one
        reconcile loop per enabled ``autoscale:`` policy — a single loop
        for a classic fleet, one per pool for a disaggregated split
        (docs/DISAGG.md) — driving the compute runtime's scaling
        backend. Dev-mode compute has no replicas, so apps there simply
        never get one."""
        key = (stored.tenant, stored.name)
        await self._stop_autoscaler(key)
        specs = application_autoscale_specs(application)
        if not specs:
            return
        backend_factory = getattr(self.compute, "autoscaler_backend", None)
        if backend_factory is None:
            log.info(
                "application %s/%s declares autoscale but the %s cannot "
                "scale replicas; skipping",
                stored.tenant, stored.name, type(self.compute).__name__,
            )
            return
        registry = getattr(self.compute, "gateway_registry", None)
        scalers: list[FleetAutoscaler] = []
        for spec in specs:
            backend = backend_factory(stored.tenant, stored.name, spec)
            if backend is None:
                continue
            on_observation = None
            if registry is not None:
                tenant, name = stored.tenant, stored.name
                source = spec.pool or ""

                def on_observation(
                    obs, _t=tenant, _n=name, _r=registry, _s=source
                ):
                    # the router consumes the same fleet snapshot the
                    # scaler judges — one fan-in, two consumers; split
                    # fleets tag the source pool so the router keeps
                    # the union of both pools' observations
                    _r.update_fleet(_t, _n, obs, source=_s)

            scaler = FleetAutoscaler(
                spec, backend, on_observation=on_observation
            )
            scaler.start()
            scalers.append(scaler)
        if scalers:
            self.autoscalers[key] = scalers

    async def _autoscaler(self, request: wire.Request) -> wire.Response:
        """Per-application autoscaler status: declared policy, latest
        per-replica observations, and the decision ring (scale events
        with their evidence). Apps without an active autoscaler answer
        ``{"enabled": false}``; a disaggregated app answers a
        ``pools`` mapping with one status per pool policy (a classic
        single-policy app keeps the flat payload engine_top and the
        autoscaler tests consume)."""
        key = (request.match_info["tenant"], request.match_info["name"])
        scalers = self.autoscalers.get(key)
        if not scalers:
            return wire.json_response({"enabled": False})
        if len(scalers) == 1 and scalers[0].spec.pool is None:
            return wire.json_response(scalers[0].status())
        return wire.json_response(
            {
                "enabled": True,
                "pools": {
                    (scaler.spec.pool or "default"): scaler.status()
                    for scaler in scalers
                },
            }
        )

    # ---- tenants ---------------------------------------------------------

    async def _list_tenants(self, request: wire.Request) -> wire.Response:
        return wire.json_response(self.store.list_tenants())

    async def _put_tenant(self, request: wire.Request) -> wire.Response:
        config = {}
        if request.can_read_body:
            try:
                config = await request.json()
            except Exception:
                config = {}
        self.store.put_tenant(request.match_info["tenant"], config)
        return wire.json_response({"status": "OK"})

    async def _get_tenant(self, request: wire.Request) -> wire.Response:
        tenants = self.store.list_tenants()
        tenant = request.match_info["tenant"]
        if tenant not in tenants:
            raise wire.HTTPException(404)
        return wire.json_response({"name": tenant, **tenants[tenant]})

    async def _delete_tenant(self, request: wire.Request) -> wire.Response:
        tenant = request.match_info["tenant"]
        for name in self.store.list_applications(tenant):
            await self._stop_autoscaler((tenant, name))
            await self.compute.undeploy(tenant, name)
        self.store.delete_tenant(tenant)
        return wire.json_response({"status": "OK"})

    # ---- applications ----------------------------------------------------

    def _require_tenant(self, tenant: str) -> None:
        if not self.store.tenant_exists(tenant):
            raise wire.HTTPException(404, f"unknown tenant {tenant!r}")

    async def _read_app_payload(self, request: wire.Request) -> StoredApplication:
        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        content_type = request.content_type or ""
        files: dict[str, str] = {}
        instance = secrets = None
        if "multipart" in content_type:
            for part_name, data in wire.multipart_parts(
                request.body, request.headers.get("content-type", "")
            ):
                if part_name == "app":
                    with zipfile.ZipFile(io.BytesIO(data)) as zf:
                        for entry in zf.namelist():
                            top_level_yaml = entry.endswith(
                                (".yaml", ".yml")
                            ) and "/" not in entry.strip("/")
                            app_code = entry.startswith("python/") and (
                                entry.endswith(".py")
                            )
                            if top_level_yaml or app_code:
                                files[entry] = zf.read(entry).decode()
                elif part_name == "instance":
                    instance = data.decode()
                elif part_name == "secrets":
                    secrets = data.decode()
        else:
            payload = await request.json()
            files = payload.get("files", {})
            instance = payload.get("instance")
            secrets = payload.get("secrets")
        if not files:
            raise wire.HTTPException(400, "no application files provided")
        from langstream_tpu_torch.controlplane.stores import validate_filenames

        try:
            validate_filenames(files)
        except ValueError as e:
            raise wire.HTTPException(400, str(e))
        return StoredApplication(
            tenant=tenant, name=name, files=files, instance=instance, secrets=secrets
        )

    async def _deploy(self, request: wire.Request) -> wire.Response:
        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        self._require_tenant(tenant)
        if self.store.get_application(tenant, name) is not None:
            raise wire.HTTPException(409, f"application {name!r} already exists")
        stored = await self._read_app_payload(request)
        return await self._do_deploy(stored)

    async def _update(self, request: wire.Request) -> wire.Response:
        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        self._require_tenant(tenant)
        existing = self.store.get_application(tenant, name)
        if existing is None:
            raise wire.HTTPException(404)
        stored = await self._read_app_payload(request)
        # merge: unchanged files/instance/secrets carry over
        merged_files = {**existing.files, **stored.files}
        stored.files = merged_files
        stored.instance = stored.instance or existing.instance
        stored.secrets = stored.secrets or existing.secrets
        # validate BEFORE undeploying the running app — a bad update must
        # leave the old deployment untouched (parity: update validation in
        # ApplicationService.validateAgentsUpdate)
        from langstream_tpu_torch.core.deployer import ApplicationDeployer

        try:
            application = parse_stored(stored)
            ApplicationDeployer().create_implementation(
                f"{stored.tenant}-{stored.name}", application
            )
            validate_gateway_authentication(application.gateways)
            validate_application_qos(application)
            validate_application_slo(application)
            validate_application_autoscale(application)
            validate_application_prefix_store(application)
            validate_application_adapter_store(application)
        except wire.HTTPException:
            raise
        except Exception as e:
            raise wire.HTTPException(400, f"invalid application: {e}")
        await self._stop_autoscaler((tenant, name))
        await self.compute.undeploy(tenant, name)
        return await self._do_deploy(stored, application)

    async def _do_deploy(
        self, stored: StoredApplication, application: Application | None = None
    ) -> wire.Response:
        # validation = full plan (parity: createImplementation before store);
        # callers that already validated pass the parsed application through
        from langstream_tpu_torch.core.deployer import ApplicationDeployer

        if application is None:
            try:
                application = parse_stored(stored)
                plan = ApplicationDeployer().create_implementation(
                    f"{stored.tenant}-{stored.name}", application
                )
                validate_gateway_authentication(application.gateways)
                validate_application_qos(application)
                validate_application_slo(application)
                validate_application_autoscale(application)
                validate_application_prefix_store(application)
                validate_application_adapter_store(application)
            except Exception as e:
                raise wire.HTTPException(400, f"invalid application: {e}")
        else:
            plan = ApplicationDeployer().create_implementation(
                f"{stored.tenant}-{stored.name}", application
            )
        # per-tenant unit quota (parity: ApplicationService.java:98-121):
        # a unit = parallelism × size; the app's own previous usage releases
        stored.units = sum(
            max(1, node.resources.parallelism) * max(1, node.resources.size)
            for node in plan.agents.values()
        )
        max_units = (self.store.list_tenants().get(stored.tenant) or {}).get(
            "max-units"
        )
        if max_units is not None:
            used = sum(
                (self.store.get_application(stored.tenant, other) or
                 StoredApplication(stored.tenant, other, {})).units
                for other in self.store.list_applications(stored.tenant)
                if other != stored.name
            )
            if used + stored.units > int(max_units):
                raise wire.HTTPException(409, (
                        f"tenant quota exceeded: {used} units in use, "
                        f"{stored.units} requested, limit {max_units}"
                    )
                )
        stored.status = "DEPLOYING"
        self.store.put_application(stored)
        try:
            await self.compute.deploy(stored, application)
            stored.status = "DEPLOYED"
        except Exception as e:
            stored.status = "ERROR"
            stored.error = str(e)
            log.exception("deploy failed")
        self.store.put_application(stored)
        if stored.status == "DEPLOYED":
            # fleet autoscaler rides the deployed app's lifecycle
            await self._sync_autoscaler(stored, application)
        return wire.json_response(stored.public_view())

    async def _get_app(self, request: wire.Request) -> wire.Response:
        stored = self.store.get_application(
            request.match_info["tenant"], request.match_info["name"]
        )
        if stored is None:
            raise wire.HTTPException(404)
        if request.query.get("files") == "true":
            # full view for in-cluster peers (the api-gateway's registry
            # sync needs files + instance to parse the app the way the
            # compute runtime did). Secrets ride along ONLY when admin auth
            # is enabled — then the auth middleware has already vetted this
            # request; on an unauthenticated control plane the full view
            # must not become a secrets-disclosure endpoint.
            full = {
                **stored.public_view(),
                "files": stored.files,
                "instance": stored.instance,
            }
            if self.admin_auth:
                full["secrets"] = stored.secrets
            return wire.json_response(full)
        return wire.json_response(stored.public_view())

    async def _download_code(self, request: wire.Request) -> wire.Response:
        """The deployed application directory back as a zip — the code
        archive, without instance/secrets (parity:
        ``ApplicationResource.java:467`` code download)."""
        stored = self.store.get_application(
            request.match_info["tenant"], request.match_info["name"]
        )
        if stored is None:
            raise wire.HTTPException(404)
        import io
        import re
        import zipfile

        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for fname, content in sorted(stored.files.items()):
                zf.writestr(fname, content)
        # app names come straight from the URL path: header-unsafe chars
        # (quotes, control bytes, non-latin-1) would malform the header or
        # 500 the response — keep a conservative subset for the filename
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", stored.name) or "application"
        return wire.Response(
            body=buf.getvalue(),
            content_type="application/zip",
            headers={
                "Content-Disposition": f'attachment; filename="{safe}.zip"'
            },
        )

    async def _list_apps(self, request: wire.Request) -> wire.Response:
        tenant = request.match_info["tenant"]
        self._require_tenant(tenant)
        return wire.json_response(self.store.list_applications(tenant))

    async def _delete_app(self, request: wire.Request) -> wire.Response:
        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        await self._stop_autoscaler((tenant, name))
        await self.compute.undeploy(tenant, name)
        self.store.delete_application(tenant, name)
        return wire.json_response({"status": "OK"})

    async def _logs(self, request: wire.Request) -> wire.Response:
        """Framework log lines plus, in k8s mode, each pod's ``pod.log``
        tail (parity: ``ApplicationResource.java:318`` streams the role
        pods' container logs, not webservice-internal lines)."""
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        lines = list(self.compute.logs.get((tenant, name), []))
        # pod.log reads are filesystem I/O — off the event loop
        per_pod = await asyncio.to_thread(self.compute.pod_logs, tenant, name)
        for pod_name, pod_lines in per_pod.items():
            lines.append(f"---- pod {pod_name} (pod.log) ----")
            lines.extend(pod_lines)
        return wire.Response(body="\n".join(lines))

    async def _traces(self, request: wire.Request) -> wire.Response:
        """Per-application trace index, aggregated the way /logs aggregates
        pod.log (in-process buffer in dev mode; per-pod /traces endpoints
        under the k8s compute runtime)."""
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        # k8s-mode aggregation does pod HTTP round-trips — off the loop
        traces = await asyncio.to_thread(self.compute.traces, tenant, name)
        return wire.json_response(traces)

    async def _flight(self, request: wire.Request) -> wire.Response:
        """Per-application engine flight-recorder aggregation (the same
        fan-in shape /traces uses: in-process engines in dev mode, per-pod
        /flight endpoints under the k8s compute runtime)."""
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        report = await asyncio.to_thread(self.compute.flight, tenant, name)
        return wire.json_response(report)

    async def _attribution(self, request: wire.Request) -> wire.Response:
        """Per-application device-attribution aggregation (beside
        /flight, same fan-in shape): per-program achieved-vs-expected
        ledger + HBM memory ledger — in-process engines in dev mode,
        per-pod /attribution endpoints under the k8s compute runtime."""
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        report = await asyncio.to_thread(
            self.compute.attribution, tenant, name
        )
        return wire.json_response(report)

    async def _qos(self, request: wire.Request) -> wire.Response:
        """Per-application QoS status: declared policy + live per-class
        scheduler counters (dev mode reads in-process engines; the k8s
        runtime fans in the pods' /flight/summary scheduler sections)."""
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        report = await asyncio.to_thread(self.compute.qos, tenant, name)
        return wire.json_response(report)

    async def _health(self, request: wire.Request) -> wire.Response:
        """Per-application fleet health: dev mode judges the in-process
        engines' watchdogs; the k8s runtime fans in the pods' /healthz —
        with timed-out pods reported as unreachable members, never
        dropped."""
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        report = await asyncio.to_thread(self.compute.health, tenant, name)
        return wire.json_response(report)

    async def _slo(self, request: wire.Request) -> wire.Response:
        """Per-application SLO status: declared objectives + live burn
        rates (dev mode in-process; k8s via the pods' /flight/summary
        slo sections)."""
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        report = await asyncio.to_thread(self.compute.slo, tenant, name)
        return wire.json_response(report)

    async def _incidents(self, request: wire.Request) -> wire.Response:
        """Per-application incident-bundle aggregation (beside /flight,
        same fan-in shape): the bounded index of breach-triggered
        evidence bundles, or one full bundle by id — in-process
        recorders in dev mode, per-pod ``/incidents`` endpoints under
        the k8s compute runtime."""
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        bundle_id = request.match_info.get("bundle_id")
        report = await asyncio.to_thread(
            self.compute.incidents, tenant, name, bundle_id
        )
        if bundle_id and not report:
            raise wire.HTTPException(404, f"unknown incident bundle {bundle_id!r}"
            )
        return wire.json_response(report)

    async def _journey(self, request: wire.Request) -> wire.Response:
        """One request's stitched cross-pod journey: the pods' partial
        ledgers merged into a single ordered timeline with its segment
        decomposition (serving/journey.py stitch; the disaggregated case
        — prefill pod + decode pod + bounced replicas — is the point).
        Dev mode stitches the in-process ledger; the k8s runtime fans in
        the pods' ``/journey/{id}`` endpoints."""
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        journey_id = request.match_info["journey_id"]
        stitched = await asyncio.to_thread(
            self.compute.journey, tenant, name, journey_id
        )
        if not stitched or not stitched.get("events"):
            raise wire.HTTPException(404, f"unknown journey {journey_id!r}")
        return wire.json_response(stitched)

    async def _trace(self, request: wire.Request) -> wire.Response:
        import asyncio

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        trace_id = request.match_info["trace_id"]
        spans = await asyncio.to_thread(
            self.compute.traces, tenant, name, trace_id
        )
        if not spans:
            raise wire.HTTPException(404, f"unknown trace {trace_id!r}")
        return wire.json_response(spans)

    async def _agents(self, request: wire.Request) -> wire.Response:
        return wire.json_response(
            self.compute.agent_info(
                request.match_info["tenant"], request.match_info["name"]
            )
        )

    # ---- archetypes ------------------------------------------------------

    def _archetypes(self):
        from langstream_tpu_torch.core.archetypes import list_archetypes

        if not self.archetypes_path:
            return []
        return list_archetypes(self.archetypes_path)

    async def _list_archetypes(self, request: wire.Request) -> wire.Response:
        self._require_tenant(request.match_info["tenant"])
        return wire.json_response(
            [{"id": a.id, "title": a.title} for a in self._archetypes()]
        )

    async def _get_archetype(self, request: wire.Request) -> wire.Response:
        self._require_tenant(request.match_info["tenant"])
        wanted = request.match_info["id"]
        for archetype in self._archetypes():
            if archetype.id == wanted:
                return wire.json_response(archetype.public_view())
        raise wire.HTTPException(404, f"unknown archetype {wanted!r}")

    async def _deploy_from_archetype(self, request: wire.Request) -> wire.Response:
        from langstream_tpu_torch.core.archetypes import ArchetypeError, instantiate

        tenant = request.match_info["tenant"]
        name = request.match_info["name"]
        self._require_tenant(tenant)
        if self.store.get_application(tenant, name) is not None:
            raise wire.HTTPException(409, f"application {name!r} already exists")
        wanted = request.match_info["id"]
        archetype = next(
            (a for a in self._archetypes() if a.id == wanted), None
        )
        if archetype is None:
            raise wire.HTTPException(404, f"unknown archetype {wanted!r}")
        payload = await request.json() if request.can_read_body else {}
        try:
            files = instantiate(archetype, payload.get("parameters") or {})
        except ArchetypeError as e:
            raise wire.HTTPException(400, str(e))
        # archetype-rendered apps obey the same filename rules as uploads
        from langstream_tpu_torch.controlplane.stores import validate_filenames

        try:
            validate_filenames(files)
        except ValueError as e:
            raise wire.HTTPException(400, f"archetype renders {e}")
        stored = StoredApplication(
            tenant=tenant,
            name=name,
            files=files,
            instance=payload.get("instance"),
            secrets=payload.get("secrets"),
        )
        return await self._do_deploy(stored)

    async def _agent_docs(self, request: wire.Request) -> wire.Response:
        from langstream_tpu_torch.core.docsgen import agent_docs

        return wire.json_response(agent_docs())
