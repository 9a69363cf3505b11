"""The gateway server (HTTP + WebSocket in one listener): the port's copy of
``langstream_tpu/gateway/server.py``, on the port's stdlib HTTP/WebSocket
server (:mod:`langstream_tpu_torch.gateway.wire`) instead of aiohttp.

Endpoints (parity: ``WebSocketConfig.java:47-49``, ``GatewayResource.java``):

- WS  ``/v1/produce/{tenant}/{application}/{gateway}``
- WS  ``/v1/consume/{tenant}/{application}/{gateway}``
- WS  ``/v1/chat/{tenant}/{application}/{gateway}``
- POST ``/api/gateways/produce/{tenant}/{application}/{gateway}``
- GET  ``/api/gateways/service/{tenant}/{application}/{gateway}`` (+ POST)

Client protocol (reference-compatible shapes):
- query params: ``param:<name>=value`` for declared gateway parameters,
  ``credentials=`` for auth, ``option:position=earliest|latest`` for
  consume starting position.
- produce message: ``{"key":..., "value":..., "headers": {...}}``
- consume push:   ``{"record": {...}, "offset": "..."}``
- chat: client sends produce messages, receives consume pushes on one
  socket, correlated by the gateway's header mappings.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from typing import Any

from langstream_tpu_torch.api.application import Application, Gateway
from langstream_tpu_torch.api.record import Record, make_record
from langstream_tpu_torch.api.topics import (
    OFFSET_HEADER,
    TopicConnectionsRuntimeRegistry,
)
from langstream_tpu_torch.core.tracing import TRACE_HEADER, TraceContext, start_span
from langstream_tpu_torch.gateway import wire
from langstream_tpu_torch.gateway.auth import (
    AuthenticationException,
    get_auth_provider,
)
from langstream_tpu_torch.gateway.router import REPLICA_HEADER, ReplicaRouter
from langstream_tpu_torch.gateway.wire import WSMsgType
from langstream_tpu_torch.serving.adapters import ADAPTER_HEADER
from langstream_tpu_torch.serving.handoff import DEADLINE_HEADER
from langstream_tpu_torch.serving.prefixstore import (
    PREFIX_HEADER,
    prefix_digest_for_text,
)
from langstream_tpu_torch.serving.journey import JOURNEYS
from langstream_tpu_torch.serving.streaming import STREAMS
from langstream_tpu_torch.serving.qos import (
    QosSpec,
    TenantLimiter,
    normalize_priority,
)

log = logging.getLogger(__name__)

#: record headers the gateway stamps so downstream AI agents hand the
#: engine the same QoS identity the gateway throttled on
QOS_TENANT_HEADER = "langstream-qos-tenant"
QOS_PRIORITY_HEADER = "langstream-qos-priority"
#: response header naming the throttled tenant on a 429
THROTTLED_HEADER = "langstream-throttled"
#: per-message stream identity stamped on streaming-flagged produces —
#: the AI agents forward it into engine options as ``stream-key``, the
#: per-chunk stream records carry it back for frame matching, and a
#: client disconnect cancels the engine future registered under it
#: (serving/streaming.py, docs/OBSERVABILITY.md Streaming)
STREAM_ID_HEADER = "langstream-stream-id"
#: header the agents' stream writer sets ``true`` on a stream's final
#: record (agents/ai.py ``_StreamWriter``)
STREAM_LAST_HEADER = "stream-last-message"


class GatewayRegistry:
    """Resolves (tenant, application, gateway-id) → (Gateway, streaming
    cluster config). Backed by the application store in the control plane,
    or by directly-registered local apps in dev mode."""

    AGENT_SERVICE_PORT = 8790

    def __init__(self) -> None:
        self._apps: dict[tuple[str, str], Application] = {}
        self._service_uris: dict[tuple[str, str, str], str] = {}
        # per-app QoS limiter (built lazily from the app's
        # tpu-serving-configuration resource's qos section; invalidated on
        # register/unregister so a redeploy picks up new limits)
        self._qos_limiters: dict[tuple[str, str], TenantLimiter | None] = {}
        # per-app replica router (gateway/router.py): exists only once
        # someone — the control plane's autoscaler loop, a poller, tests
        # — pushes fleet snapshots via update_fleet; without fresh
        # snapshots produce paths stamp nothing and the topic's normal
        # partition spread routes
        self._routers: dict[tuple[str, str], ReplicaRouter] = {}
        # per-source (pool) fleet snapshots feeding each router, each
        # stamped with its push time: split fleets have one autoscaler
        # per pool, and the router needs the union of their latest
        # observations — with per-source aging so a removed pool's
        # replicas drop out of the merge (docs/DISAGG.md)
        self._fleet_sources: dict[
            tuple[str, str],
            dict[str, tuple[float, list[dict[str, Any]]]],
        ] = {}

    def register(self, tenant: str, app_id: str, application: Application) -> None:
        self._apps[(tenant, app_id)] = application
        self._qos_limiters.pop((tenant, app_id), None)

    def application(self, tenant: str, app_id: str) -> Application | None:
        return self._apps.get((tenant, app_id))

    def unregister(self, tenant: str, app_id: str) -> None:
        self._apps.pop((tenant, app_id), None)
        self._qos_limiters.pop((tenant, app_id), None)
        self._routers.pop((tenant, app_id), None)
        self._fleet_sources.pop((tenant, app_id), None)
        for key in [k for k in self._service_uris if k[:2] == (tenant, app_id)]:
            del self._service_uris[key]

    def update_fleet(
        self,
        tenant: str,
        app_id: str,
        snapshots: list[dict[str, Any]],
        source: str = "",
    ) -> None:
        """Feed the app's router fresh per-replica observations (the
        autoscaler's observe() output — it already fans in exactly the
        evidence routing needs, so the two consume one snapshot).
        ``source`` names the feeding pool for disaggregated fleets
        (docs/DISAGG.md): each pool's autoscaler observes only its own
        StatefulSet, so the router's view is the union of the latest
        snapshot from EVERY source — one pool's push must not evict the
        other pool's replicas. Each source's contribution carries its
        own freshness: a source that stops pushing (a pool removed on
        redeploy, a dead autoscaler loop) ages out of the merge within
        the router's freshness window instead of keeping ghost replicas
        routable forever just because a sibling source stays live."""
        key = (tenant, app_id)
        router = self._routers.setdefault(key, ReplicaRouter())
        now = time.monotonic()
        sources = self._fleet_sources.setdefault(key, {})
        sources[source] = (now, list(snapshots))
        for stale in [
            s
            for s, (stamped, _) in sources.items()
            if now - stamped > router.fresh_s
        ]:
            del sources[stale]
        merged = [
            snap for _, chunk in sources.values() for snap in chunk
        ]
        router.observe(merged)

    def router(self, tenant: str, app_id: str) -> ReplicaRouter | None:
        return self._routers.get((tenant, app_id))

    def route_replica(
        self,
        tenant: str,
        app_id: str,
        qos_tenant: str | None,
        prefix: str | None = None,
        adapter: str | None = None,
    ) -> str | None:
        """The replica one produced record should land on (None = don't
        stamp): least-loaded eligible member, with session affinity on
        the QoS tenant so a conversation keeps its prefix-cache blocks,
        and — more specifically — prefix affinity on the stamped
        prompt-prefix digest so shared-preamble traffic from ANY tenant
        returns to the replica whose prefix tiers hold its blocks
        (docs/PREFIX.md). Gateway-produced records are NEW requests, so
        a disaggregated fleet routes them to the prefill pool (phase
        filtering is a no-op while every replica is combined —
        docs/DISAGG.md)."""
        router = self._routers.get((tenant, app_id))
        if router is None:
            return None
        return router.pick(
            qos_tenant, phase="prefill", prefix=prefix, adapter=adapter
        )

    def qos_limiter(self, tenant: str, app_id: str) -> TenantLimiter | None:
        """The app's gateway-side QoS limiter (None when the app declares
        no enabled qos section). The same :class:`QosSpec` the engine
        enforces — buckets are enforced at BOTH ends: the gateway sheds
        before a record ever enters the broker, the engine backstops
        produce paths that bypass the gateway."""
        key = (tenant, app_id)
        if key not in self._qos_limiters:
            limiter = None
            app = self._apps.get(key)
            for res in (getattr(app, "resources", None) or {}).values():
                if getattr(res, "type", None) != "tpu-serving-configuration":
                    continue
                try:
                    spec = QosSpec.from_dict(
                        (res.configuration or {}).get("qos")
                    )
                except ValueError as e:
                    # deploy validation rejects malformed specs; a stale
                    # app that slipped through must not break produce
                    log.warning("ignoring invalid qos section: %s", e)
                    continue
                if spec is not None and spec.enabled:
                    limiter = TenantLimiter(spec)
                    break
            self._qos_limiters[key] = limiter
        return self._qos_limiters[key]

    def register_service_uri(
        self, tenant: str, app_id: str, agent_id: str, uri: str
    ) -> None:
        """Dev-mode/in-process agents register where they listen; in-cluster
        the naming-convention fallback below needs no registration."""
        self._service_uris[(tenant, app_id, agent_id)] = uri.rstrip("/")

    def service_uri(self, tenant: str, app_id: str, agent_id: str) -> str:
        explicit = self._service_uris.get((tenant, app_id, agent_id))
        if explicit:
            return explicit
        # k8s: the agent's headless service lives in the TENANT namespace
        # (cluster_runtime.tenant_namespace), not the gateway's own — the
        # qualified name is what resolves from the gateway pod. The port is
        # the agent's own declared service-port (a headless service resolves
        # to pod IPs, so the declared Service ports don't constrain it);
        # AGENT_SERVICE_PORT is only the convention-default.
        port = self.AGENT_SERVICE_PORT
        app = self._apps.get((tenant, app_id))
        if app is not None:
            for agent in app.all_agents():
                if agent.id == agent_id:
                    port = int(
                        (agent.configuration or {}).get("service-port", port)
                    )
                    break
        name = f"{app_id}-{agent_id}".lower().replace("_", "-")
        namespace = f"langstream-{tenant}".lower()
        return f"http://{name}.{namespace}.svc:{port}"

    def resolve(
        self, tenant: str, app_id: str, gateway_id: str
    ) -> tuple[Gateway, dict[str, Any]]:
        app = self._apps.get((tenant, app_id))
        if app is None:
            raise wire.HTTPException(404, f"unknown application {tenant}/{app_id}")
        for gw in app.gateways:
            if gw.id == gateway_id:
                streaming = app.instance.streaming_cluster
                return gw, {
                    "type": streaming.type,
                    "configuration": streaming.configuration,
                }
        raise wire.HTTPException(404, f"unknown gateway {gateway_id!r}")


class GatewayServer:
    def __init__(self, registry: GatewayRegistry | None = None, port: int = 8091,
                 host: str = "127.0.0.1"):
        self.registry = registry or GatewayRegistry()
        self.port = port
        self.host = host
        self.server = wire.HttpServer(
            [
                ("GET", "/v1/produce/{tenant}/{application}/{gateway}", self._ws_produce),
                ("GET", "/v1/consume/{tenant}/{application}/{gateway}", self._ws_consume),
                ("GET", "/v1/chat/{tenant}/{application}/{gateway}", self._ws_chat),
                (
                    "POST",
                    "/api/gateways/produce/{tenant}/{application}/{gateway}",
                    self._http_produce,
                ),
                (
                    "*",
                    "/api/gateways/service/{tenant}/{application}/{gateway}",
                    self._http_service,
                ),
                (
                    "*",
                    "/api/gateways/service/{tenant}/{application}/{gateway}/{tail:.*}",
                    self._http_service,
                ),
            ],
            host=host,
            port=port,
        )
        # per-QoS-tenant throttle counters (lazily created: tenants are
        # client identities, unknown until the first 429)
        self._m_throttled: dict[str, Any] = {}

    async def start(self) -> None:
        """Listen; with ``port=0`` a free port is bound and ``port`` holds it."""
        await self.server.start()
        self.port = self.server.port
        log.info("gateway listening on :%d", self.port)

    async def stop(self) -> None:
        await self.server.stop()

    # ------------------------------------------------------------------
    # shared plumbing
    # ------------------------------------------------------------------

    def _context(self, request: wire.Request):
        tenant = request.match_info["tenant"]
        app_id = request.match_info["application"]
        gateway_id = request.match_info["gateway"]
        gateway, streaming = self.registry.resolve(tenant, app_id, gateway_id)
        params: dict[str, str] = {}
        options: dict[str, str] = {}
        for k, v in request.query.items():
            if k.startswith("param:"):
                params[k[6:]] = v
            elif k.startswith("option:"):
                options[k[7:]] = v
        missing = [p for p in gateway.parameters if p not in params]
        if missing:
            raise wire.HTTPException(400, f"missing parameters: {missing}")
        credentials = request.query.get("credentials")
        return tenant, app_id, gateway, streaming, params, options, credentials

    async def _authenticate(
        self, gateway: Gateway, credentials: str | None
    ) -> dict[str, Any]:
        if not gateway.authentication:
            return {}
        provider = get_auth_provider(
            gateway.authentication.get("provider", "test"),
            gateway.authentication.get("configuration", {}),
        )
        try:
            return await provider.authenticate(credentials)
        except AuthenticationException:
            raise
        except Exception as e:
            # provider infrastructure failure (endpoint down, bad config):
            # an auth failure to the client, not a 500 with a traceback
            log.warning("auth provider failure: %s", e)
            raise AuthenticationException(f"authentication unavailable: {e}")

    @staticmethod
    def _mapped_headers(
        mappings, params: dict[str, str], principal: dict[str, Any]
    ) -> dict[str, Any]:
        headers: dict[str, Any] = {}
        for m in mappings:
            if m.value_from_parameters:
                value = params.get(m.value_from_parameters)
            elif m.value_from_authentication:
                value = principal.get(m.value_from_authentication)
            else:
                value = m.literal_value
            key = m.key or (
                f"langstream-client-{m.value_from_parameters or m.value_from_authentication}"
            )
            if value is not None:
                headers[key] = value
        return headers

    @staticmethod
    async def _json_body(request: wire.Request) -> dict[str, Any]:
        """Parse a JSON object body; malformed input is a client error (400),
        not a front-door 500."""
        try:
            payload = await request.json()
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise wire.HTTPException(400, "body is not valid JSON")
        if not isinstance(payload, dict):
            raise wire.HTTPException(400, "body must be a JSON object")
        return payload

    @staticmethod
    def _record_json(record: Record) -> dict[str, Any]:
        offset = None
        headers = {}
        for k, v in record.headers:
            if k == OFFSET_HEADER:
                offset = f"{v.topic}:{v.partition}:{v.offset}"
            else:
                headers[k] = v
        return {
            "record": {"key": record.key, "value": record.value, "headers": headers},
            "offset": offset,
        }

    @staticmethod
    def _traced_headers(
        headers: dict[str, Any], span_name: str
    ) -> tuple[dict[str, Any], Any]:
        """Open the gateway-side span for one produced record and stamp its
        context into the record headers (honoring a client-supplied
        ``langstream-trace`` traceparent as the parent). Returns
        ``(headers, span)``; the header value is echoed back to the client
        so it can fetch ``/traces/<trace_id>`` afterwards."""
        span = start_span(
            span_name, service="gateway", parent=headers.get(TRACE_HEADER)
        )
        headers = dict(headers)
        headers[TRACE_HEADER] = span.context().to_header()
        return headers, span

    # ------------------------------------------------------------------
    # QoS: tenant identity + gateway-side throttling
    # ------------------------------------------------------------------

    @staticmethod
    def _qos_identity(
        params: dict[str, str], principal: dict[str, Any]
    ) -> tuple[str, str]:
        """(qos tenant, priority class) for one client: the authenticated
        subject is the tenant when auth is on (clients cannot spoof it);
        an explicit ``param:tenant`` covers unauthenticated dev setups.
        Priority comes from ``param:priority``, clamped to a known class."""
        tenant = str(
            principal.get("subject") or params.get("tenant") or "anonymous"
        )
        return tenant, normalize_priority(params.get("priority"))

    def _qos_headers(
        self,
        limiter: TenantLimiter | None,
        params: dict[str, str],
        principal: dict[str, Any],
    ) -> dict[str, str]:
        """Record headers carrying the QoS identity downstream (the AI
        agents forward them into engine options, so the engine's own
        buckets and priority classes see the same tenant the gateway
        throttled). Stamped only when the app has QoS configured or the
        client asked for special treatment — otherwise record headers
        stay byte-identical to the pre-QoS gateway."""
        if (
            limiter is None
            and "tenant" not in params
            and "priority" not in params
        ):
            return {}
        tenant, priority = self._qos_identity(params, principal)
        out = {QOS_TENANT_HEADER: tenant, QOS_PRIORITY_HEADER: priority}
        if limiter is not None:
            # tenant config names the LoRA adapter this tenant decodes
            # with (docs/ADAPTERS.md): stamped here so the agents, the
            # engine, and the router all see the SAME adapter identity
            # the gateway resolved — clients cannot steer themselves
            # onto another tenant's fine-tune
            policy = limiter.spec.tenant_policy(tenant)
            if policy is not None and policy.adapter:
                out[ADAPTER_HEADER] = policy.adapter
        return out

    def _stamp_deadline(
        self,
        headers: dict[str, Any],
        limiter: TenantLimiter | None,
        params: dict[str, str],
        priority: str,
    ) -> dict[str, Any]:
        """Stamp the record's end-to-end deadline (in place):
        ``langstream-deadline`` = absolute epoch seconds, enforced
        504-shaped by every engine on the request's path (serving/
        handoff.py, docs/RESILIENCE.md). A client-supplied header wins;
        a ``deadline-s`` query param is a client-relative budget; and an
        app whose qos section opts in (``deadline-headers: true``) gets
        the per-class default stamped on everything else. No deadline
        anywhere → headers stay byte-identical (the default-config
        pin)."""
        if headers.get(DEADLINE_HEADER):
            return headers  # explicit client budget: honored end to end
        raw = params.get("deadline-s")
        if raw is not None:
            try:
                headers[DEADLINE_HEADER] = repr(
                    time.time() + max(0.0, float(raw))
                )
            except (TypeError, ValueError):
                pass  # malformed param degrades to "no deadline"
            return headers
        if limiter is not None and limiter.spec.deadline_headers:
            headers[DEADLINE_HEADER] = repr(
                time.time() + limiter.spec.class_policy(priority).deadline_s
            )
        return headers

    def _stamp_replica(
        self,
        headers: dict[str, Any],
        tenant: str,
        app_id: str,
        params: dict[str, Any],
        principal: dict[str, Any],
        value: Any = None,
    ) -> dict[str, Any]:
        """Stamp the routing choice onto one produced record (in place).
        Per-message, not per-connection: load shifts and affinity pins
        between messages on one WebSocket. The affinity key is the SAME
        QoS identity the limiter throttled on (resolved here from the
        same params/principal so the two can never disagree) — except
        that the shared ``anonymous`` fallback gets no affinity pin:
        every unauthenticated client shares that name, and pinning it
        would funnel all anonymous traffic onto one replica, defeating
        least-loaded routing exactly in the common dev/bench setup. A
        client-supplied stamp is honored — explicit targeting (debug,
        pinned benchmarks) beats the router's heuristic.

        ``value`` is the record's prompt payload: when it is long
        enough, its chained prefix digest is stamped as the
        ``langstream-prefix-digest`` header and routes by prefix
        affinity — N tenants sharing one system prompt converge on the
        replica whose prefix tiers hold its blocks (docs/PREFIX.md).
        Short or absent values stamp nothing and route exactly as
        before."""
        prefix = prefix_digest_for_text(value)
        if prefix is not None and PREFIX_HEADER not in headers:
            headers[PREFIX_HEADER] = prefix
        if REPLICA_HEADER in headers:
            return headers
        qos_tenant, _ = self._qos_identity(params, principal)
        affinity = qos_tenant if qos_tenant != "anonymous" else None
        # adapter identity was already injected from tenant config (or a
        # client header on adapter-permissive setups): route by adapter
        # affinity beside the prefix pins (docs/ADAPTERS.md)
        adapter = headers.get(ADAPTER_HEADER) or None
        if prefix is not None or adapter is not None:
            replica = self.registry.route_replica(
                tenant, app_id, affinity, prefix=prefix, adapter=adapter
            )
        else:
            # prefix-less traffic keeps the pre-tier call shape exactly
            replica = self.registry.route_replica(tenant, app_id, affinity)
        if replica is not None:
            headers[REPLICA_HEADER] = replica
        return headers

    @staticmethod
    def _journey_produce(headers: dict[str, Any]) -> None:
        """Record the gateway-side journey edge (serving/journey.py) for
        one ADMITTED produce, keyed by the trace id stamped into the
        record — the engine's submit/admit edges chain onto it, so the
        gateway→engine gap ("ingest": broker + agent hop) becomes a
        named TTFT segment. Called only after the QoS gate admits the
        message: a throttled request never entered the system, and a
        burst of 429s must not FIFO-evict live journeys from the
        bounded ledger."""
        ctx = TraceContext.parse(headers.get(TRACE_HEADER))
        if ctx is not None:
            JOURNEYS.record(
                ctx.trace_id, "gateway-produce",
                replica=headers.get(REPLICA_HEADER),
            )

    #: max distinct tenant labels on the throttle counter — tenant names
    #: can be client-chosen on unauthenticated gateways, and Prometheus
    #: label cardinality (and this dict) must not grow with them
    _MAX_THROTTLE_LABELS = 256

    def _count_throttle(self, tenant: str) -> None:
        if (
            tenant not in self._m_throttled
            and len(self._m_throttled) >= self._MAX_THROTTLE_LABELS
        ):
            tenant = "<other>"
        counter = self._m_throttled.get(tenant)
        if counter is None:
            from langstream_tpu_torch.core.metrics import PrometheusMetricsReporter

            counter = PrometheusMetricsReporter(
                prefix="langstream_gateway", agent_id=tenant
            ).counter(
                "throttled_total",
                "produce requests refused with 429 for this QoS tenant",
            )
            self._m_throttled[tenant] = counter
        counter(1)

    @staticmethod
    def _retry_after_header(retry: float) -> str:
        # Retry-After is integral seconds; round UP so a client honoring
        # it never retries into a still-empty bucket
        return str(max(1, -(-int(retry * 1000) // 1000)))

    def _throttle_http(
        self, tenant: str, retry: float, trace: str | None = None
    ) -> wire.Response:
        """Structured 429: machine-readable body + ``Retry-After`` +
        ``langstream-throttled`` naming the tenant (so a shared proxy can
        tell whose budget was hit) + the trace header when a span was
        already opened for the rejected produce."""
        self._count_throttle(tenant)
        headers = {
            "Retry-After": self._retry_after_header(retry),
            THROTTLED_HEADER: tenant,
        }
        body: dict[str, Any] = {
            "status": "THROTTLED",
            "reason": f"tenant {tenant!r} over its rate limit",
            "retry-after": round(retry, 3),
        }
        if trace:
            headers[TRACE_HEADER] = trace
            body["trace"] = trace
        return wire.json_response(body, status=429, headers=headers)

    def _ws_throttle_gate(
        self, limiter: TenantLimiter | None, tenant: str
    ) -> None:
        """WS upgrade gate: a tenant whose bucket is already empty gets
        the 429 at the handshake (read-only peek — the upgrade itself
        costs no budget; per-message debits happen on each produce)."""
        if limiter is None:
            return
        retry = limiter.retry_after(tenant)
        if retry is not None:
            self._count_throttle(tenant)
            raise wire.HTTPException(
                429,
                f"tenant {tenant!r} over its rate limit",
                headers={
                    "Retry-After": self._retry_after_header(retry),
                    THROTTLED_HEADER: tenant,
                },
            )

    def _filters_match(
        self, gateway: Gateway, params, principal, record: Record
    ) -> bool:
        expected = self._mapped_headers(gateway.consume_filters, params, principal)
        record_headers = record.header_map()
        return all(record_headers.get(k) == v for k, v in expected.items())

    async def _emit_event(self, gateway: Gateway, streaming, event_type: str,
                          tenant: str, app_id: str) -> None:
        """Client lifecycle events (parity: ``EventRecord.java:29-44``)."""
        if not gateway.events_topic:
            return
        try:
            runtime = TopicConnectionsRuntimeRegistry.get_runtime(streaming)
            producer = runtime.create_producer("gateway-events", {"topic": gateway.events_topic})
            await producer.start()
            await producer.write(
                make_record(
                    value={
                        "type": event_type,
                        "tenant": tenant,
                        "application": app_id,
                        "gateway": gateway.id,
                    }
                )
            )
            await producer.close()
            await runtime.close()
        except Exception:
            log.exception("failed to emit gateway event")

    # ------------------------------------------------------------------
    # produce
    # ------------------------------------------------------------------

    async def _ws_produce(self, request: wire.Request) -> wire.WebSocketResponse:
        tenant, app_id, gateway, streaming, params, options, credentials = (
            self._context(request)
        )
        if gateway.type != Gateway.PRODUCE:
            raise wire.HTTPException(400, "not a produce gateway")
        try:
            principal = await self._authenticate(gateway, credentials)
        except AuthenticationException as e:
            raise wire.HTTPException(401, str(e))
        limiter = self.registry.qos_limiter(tenant, app_id)
        qos_tenant, qos_priority = self._qos_identity(params, principal)
        # an already-empty bucket refuses the upgrade itself with a real
        # 429 (per-message throttling below covers mid-stream exhaustion)
        self._ws_throttle_gate(limiter, qos_tenant)
        ws = wire.WebSocketResponse()
        await ws.prepare(request)
        await self._emit_event(gateway, streaming, "ClientConnected", tenant, app_id)
        runtime = TopicConnectionsRuntimeRegistry.get_runtime(streaming)
        producer = runtime.create_producer("gateway-produce", {"topic": gateway.topic})
        await producer.start()
        stream_on = (
            self._stream_requested(options) and gateway.stream_topic is not None
        )
        active_streams: set[str] = set()
        stream_reader = None
        stream_pusher = None
        if stream_on:
            # the chunk reader goes live BEFORE any produce is accepted:
            # started after a write, it could miss the first frames of a
            # fast stream (read position is `latest`)
            stream_reader = runtime.create_reader(
                {"topic": gateway.stream_topic}, initial_position="latest"
            )
            await stream_reader.start()
            stream_pusher = asyncio.ensure_future(
                self._stream_push_loop(ws, stream_reader, active_streams)
            )
        inject = {
            **self._mapped_headers(gateway.produce_headers, params, principal),
            **self._qos_headers(limiter, params, principal),
        }
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                try:
                    payload = json.loads(msg.data)
                    headers, span = self._traced_headers(
                        {**(payload.get("headers") or {}), **inject},
                        "gateway.produce",
                    )
                    self._stamp_replica(
                        headers, tenant, app_id, params, principal,
                        value=payload.get("value"),
                    )
                    self._stamp_deadline(
                        headers, limiter, params, qos_priority
                    )
                    retry = (
                        limiter.admit_request(qos_tenant)
                        if limiter is not None
                        else None
                    )
                    if retry is not None:
                        # the span records the rejection (error label),
                        # and the structured ack mirrors the HTTP 429
                        span.end(error="throttled")
                        self._count_throttle(qos_tenant)
                        await ws.send_json(
                            {
                                "status": "THROTTLED",
                                "reason": f"tenant {qos_tenant!r} over its "
                                          f"rate limit",
                                "retry-after": round(retry, 3),
                                "trace": headers[TRACE_HEADER],
                            }
                        )
                        continue
                    stream_id = None
                    if stream_on:
                        # per-message, not per-connection: one socket
                        # can carry many concurrent streams, each its
                        # own engine-side cancellation handle
                        stream_id = str(uuid.uuid4())
                        headers[STREAM_ID_HEADER] = stream_id
                        active_streams.add(stream_id)
                    self._journey_produce(headers)
                    record = make_record(
                        value=payload.get("value"),
                        key=payload.get("key"),
                        headers=headers,
                    )
                    with span:
                        await producer.write(record)
                    ack = {"status": "OK", "trace": headers[TRACE_HEADER]}
                    if stream_id is not None:
                        ack["stream-id"] = stream_id
                    await ws.send_json(ack)
                except Exception as e:
                    await ws.send_json({"status": "BAD_REQUEST", "reason": str(e)})
        finally:
            if stream_pusher is not None:
                stream_pusher.cancel()
            if stream_reader is not None:
                await stream_reader.close()
            for sid in active_streams:
                # disconnect IS cancellation: cancel the engine future
                # registered under each still-open stream so the decode
                # slot frees at the next chunk boundary (a completed
                # stream already left the registry — no-op)
                STREAMS.cancel(sid)
            await producer.close()
            await runtime.close()
            await self._emit_event(
                gateway, streaming, "ClientDisconnected", tenant, app_id
            )
        return ws

    @staticmethod
    def _stream_requested(options: dict[str, str]) -> bool:
        """``option:streaming`` truthiness (query options are strings)."""
        return str(options.get("streaming", "")).lower() in (
            "1", "true", "yes", "on",
        )

    async def _stream_push_loop(self, ws, reader, active: set) -> None:
        """Forward per-chunk stream records to one streaming-flagged
        produce socket. Frame-writer discipline (graftcheck STRM1501):
        the loop body is reads, header matches, and frame writes only —
        no locks, no blocking I/O, no host syncs — because every stall
        here lands directly in the client's time-between-tokens."""
        try:
            while not ws.closed:
                records = await reader.read(timeout=0.5)
                for record in records:
                    headers = record.header_map()
                    sid = headers.get(STREAM_ID_HEADER)
                    if sid is None or sid not in active:
                        continue
                    await ws.send_json(self._record_json(record))
                    if str(headers.get(STREAM_LAST_HEADER)).lower() == "true":
                        # completed stream: nothing to cancel on
                        # disconnect anymore
                        active.discard(sid)
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        except Exception:
            log.exception("stream push loop failed")

    async def _http_produce(self, request: wire.Request) -> wire.Response:
        tenant, app_id, gateway, streaming, params, options, credentials = (
            self._context(request)
        )
        if gateway.type != Gateway.PRODUCE:
            raise wire.HTTPException(400, "not a produce gateway")
        try:
            principal = await self._authenticate(gateway, credentials)
        except AuthenticationException as e:
            raise wire.HTTPException(401, str(e))
        payload = await self._json_body(request)
        limiter = self.registry.qos_limiter(tenant, app_id)
        qos_tenant, qos_priority = self._qos_identity(params, principal)
        inject = {
            **self._mapped_headers(gateway.produce_headers, params, principal),
            **self._qos_headers(limiter, params, principal),
        }
        headers, span = self._traced_headers(
            {**(payload.get("headers") or {}), **inject}, "gateway.produce"
        )
        self._stamp_replica(
            headers, tenant, app_id, params, principal,
            value=payload.get("value"),
        )
        self._stamp_deadline(headers, limiter, params, qos_priority)
        if limiter is not None:
            retry = limiter.admit_request(qos_tenant)
            if retry is not None:
                span.end(error="throttled")
                return self._throttle_http(
                    qos_tenant, retry, headers[TRACE_HEADER]
                )
        self._journey_produce(headers)
        runtime = TopicConnectionsRuntimeRegistry.get_runtime(streaming)
        if self._stream_requested(options) and gateway.stream_topic is not None:
            # SSE variant: hold the response open and deliver each chunk
            # record as a `data:` frame (closes the runtime itself)
            return await self._sse_produce(
                request, gateway, runtime, payload, headers, span
            )
        producer = runtime.create_producer("gateway-produce", {"topic": gateway.topic})
        await producer.start()
        try:
            with span:
                await producer.write(
                    make_record(
                        value=payload.get("value"),
                        key=payload.get("key"),
                        headers=headers,
                    )
                )
        finally:
            await producer.close()
            await runtime.close()
        return wire.json_response(
            {"status": "OK", "trace": headers[TRACE_HEADER]},
            headers={TRACE_HEADER: headers[TRACE_HEADER]},
        )

    async def _sse_produce(
        self,
        request: wire.Request,
        gateway: Gateway,
        runtime,
        payload: dict[str, Any],
        headers: dict[str, Any],
        span,
    ) -> wire.StreamResponse:
        """The SSE variant of the HTTP produce route: one POST with
        ``option:streaming=true`` against a stream-topic gateway holds
        the response open (``text/event-stream``) and delivers each
        chunk record as a ``data:`` frame. Heartbeat comments go out on
        idle polls so a gone client surfaces as a write failure — which
        maps to cancellation of the engine future, exactly like a WS
        disconnect. Frame-writer discipline applies (graftcheck
        STRM1501): the delivery loop is reads and frame writes only."""
        stream_id = str(uuid.uuid4())
        headers[STREAM_ID_HEADER] = stream_id
        response = wire.StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                TRACE_HEADER: headers[TRACE_HEADER],
                STREAM_ID_HEADER: stream_id,
            },
        )
        await response.prepare(request)
        # the chunk reader goes live BEFORE the produce: started after,
        # it could miss the first frames of a fast stream (`latest`)
        reader = runtime.create_reader(
            {"topic": gateway.stream_topic}, initial_position="latest"
        )
        await reader.start()
        producer = runtime.create_producer(
            "gateway-produce", {"topic": gateway.topic}
        )
        await producer.start()
        try:
            with span:
                await producer.write(
                    make_record(
                        value=payload.get("value"),
                        key=payload.get("key"),
                        headers=headers,
                    )
                )
            done = False
            while not done:
                records = await reader.read(timeout=0.5)
                if not records:
                    # comment frame: keeps intermediaries from timing
                    # the idle stream out AND probes the socket — a dead
                    # client raises here instead of leaking the slot
                    await response.write(b": keep-alive\n\n")
                    continue
                for record in records:
                    rec_headers = record.header_map()
                    if rec_headers.get(STREAM_ID_HEADER) != stream_id:
                        continue
                    frame = json.dumps(self._record_json(record))
                    await response.write(f"data: {frame}\n\n".encode())
                    if str(rec_headers.get(STREAM_LAST_HEADER)).lower() == "true":
                        done = True
        except asyncio.CancelledError:
            # the server cancels the handler on client disconnect:
            # disconnect IS cancellation (no-op for a finished stream)
            STREAMS.cancel(stream_id)
            raise
        except ConnectionResetError:
            STREAMS.cancel(stream_id)
        finally:
            await producer.close()
            await reader.close()
            await runtime.close()
        try:
            await response.write_eof()
        except ConnectionResetError:
            pass
        return response

    # ------------------------------------------------------------------
    # consume
    # ------------------------------------------------------------------

    async def _ws_consume(self, request: wire.Request) -> wire.WebSocketResponse:
        tenant, app_id, gateway, streaming, params, options, credentials = (
            self._context(request)
        )
        if gateway.type != Gateway.CONSUME:
            raise wire.HTTPException(400, "not a consume gateway")
        try:
            principal = await self._authenticate(gateway, credentials)
        except AuthenticationException as e:
            raise wire.HTTPException(401, str(e))
        ws = wire.WebSocketResponse()
        await ws.prepare(request)
        await self._emit_event(gateway, streaming, "ClientConnected", tenant, app_id)
        runtime = TopicConnectionsRuntimeRegistry.get_runtime(streaming)
        reader = runtime.create_reader(
            {"topic": gateway.topic},
            initial_position=options.get("position", "latest"),
        )
        await reader.start()
        pusher = asyncio.ensure_future(
            self._push_loop(ws, reader, gateway, params, principal)
        )
        try:
            async for msg in ws:
                if msg.type == WSMsgType.TEXT:
                    pass  # client acks are accepted and ignored (at-most-once push)
        finally:
            pusher.cancel()
            await reader.close()
            await runtime.close()
            await self._emit_event(
                gateway, streaming, "ClientDisconnected", tenant, app_id
            )
        return ws

    async def _push_loop(self, ws, reader, gateway, params, principal) -> None:
        try:
            while not ws.closed:
                records = await reader.read(timeout=0.5)
                for record in records:
                    if self._filters_match(gateway, params, principal, record):
                        await ws.send_json(self._record_json(record))
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        except Exception:
            log.exception("consume push loop failed")

    # ------------------------------------------------------------------
    # chat: produce + consume on one socket
    # ------------------------------------------------------------------

    async def _ws_chat(self, request: wire.Request) -> wire.WebSocketResponse:
        tenant, app_id, gateway, streaming, params, options, credentials = (
            self._context(request)
        )
        if gateway.type != Gateway.CHAT:
            raise wire.HTTPException(400, "not a chat gateway")
        try:
            principal = await self._authenticate(gateway, credentials)
        except AuthenticationException as e:
            raise wire.HTTPException(401, str(e))
        chat = gateway.chat_options
        questions_topic = chat.get("questions-topic")
        answers_topic = chat.get("answers-topic")
        if not questions_topic or not answers_topic:
            raise wire.HTTPException(400, "chat gateway needs questions/answers topics")
        limiter = self.registry.qos_limiter(tenant, app_id)
        qos_tenant, qos_priority = self._qos_identity(params, principal)
        self._ws_throttle_gate(limiter, qos_tenant)
        ws = wire.WebSocketResponse()
        await ws.prepare(request)
        await self._emit_event(gateway, streaming, "ClientConnected", tenant, app_id)
        runtime = TopicConnectionsRuntimeRegistry.get_runtime(streaming)
        producer = runtime.create_producer("gateway-chat", {"topic": questions_topic})
        await producer.start()
        reader = runtime.create_reader(
            {"topic": answers_topic}, initial_position="latest"
        )
        await reader.start()
        inject = {
            **self._mapped_headers(gateway.produce_headers, params, principal),
            **self._qos_headers(limiter, params, principal),
        }
        # streaming-flagged chat sockets get per-message stream ids: the
        # answers topic already carries the agent's chunk records back
        # (headers copy through the stream writer), so frames need no
        # extra reader — the id exists for disconnect-as-cancellation
        chat_stream = self._stream_requested(options)
        active_streams: set[str] = set()
        # the same headers injected on produce are the consume-side filters
        # (that's how chat correlates answers to this session)
        pusher = asyncio.ensure_future(
            self._chat_push_loop(ws, reader, inject, active_streams)
        )
        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                try:
                    payload = json.loads(msg.data)
                    headers, span = self._traced_headers(
                        {**(payload.get("headers") or {}), **inject},
                        "gateway.chat",
                    )
                    self._stamp_replica(
                        headers, tenant, app_id, params, principal,
                        value=payload.get("value"),
                    )
                    self._stamp_deadline(
                        headers, limiter, params, qos_priority
                    )
                    retry = (
                        limiter.admit_request(qos_tenant)
                        if limiter is not None
                        else None
                    )
                    if retry is not None:
                        span.end(error="throttled")
                        self._count_throttle(qos_tenant)
                        await ws.send_json(
                            {
                                "status": "THROTTLED",
                                "reason": f"tenant {qos_tenant!r} over its "
                                          f"rate limit",
                                "retry-after": round(retry, 3),
                                "trace": headers[TRACE_HEADER],
                            }
                        )
                        continue
                    stream_id = None
                    if chat_stream:
                        stream_id = str(uuid.uuid4())
                        headers[STREAM_ID_HEADER] = stream_id
                        active_streams.add(stream_id)
                    self._journey_produce(headers)
                    with span:
                        await producer.write(
                            make_record(
                                value=payload.get("value"),
                                key=payload.get("key"),
                                headers=headers,
                            )
                        )
                    ack = {"status": "OK", "trace": headers[TRACE_HEADER]}
                    if stream_id is not None:
                        ack["stream-id"] = stream_id
                    await ws.send_json(ack)
                except Exception as e:
                    await ws.send_json({"status": "BAD_REQUEST", "reason": str(e)})
        finally:
            pusher.cancel()
            for sid in active_streams:
                # disconnect IS cancellation: free the decode slot of
                # every stream still open on this socket (no-op for
                # completed streams — they left the registry)
                STREAMS.cancel(sid)
            await producer.close()
            await reader.close()
            await runtime.close()
            await self._emit_event(
                gateway, streaming, "ClientDisconnected", tenant, app_id
            )
        return ws

    async def _chat_push_loop(
        self,
        ws,
        reader,
        inject: dict[str, Any],
        active: set | None = None,
    ) -> None:
        try:
            while not ws.closed:
                records = await reader.read(timeout=0.5)
                for record in records:
                    headers = record.header_map()
                    if all(headers.get(k) == v for k, v in inject.items()):
                        await ws.send_json(self._record_json(record))
                        if (
                            active
                            and str(headers.get(STREAM_LAST_HEADER)).lower()
                            == "true"
                        ):
                            # completed stream: drop its cancel handle
                            active.discard(headers.get(STREAM_ID_HEADER))
        except (asyncio.CancelledError, ConnectionResetError):
            pass
        except Exception:
            log.exception("chat push loop failed")

    # ------------------------------------------------------------------
    # service gateway: agent proxy
    # ------------------------------------------------------------------

    _HOP_HEADERS = {
        "connection", "keep-alive", "proxy-authenticate",
        "proxy-authorization", "te", "trailers", "transfer-encoding",
        "upgrade", "host", "content-length",
        # the proxy decompresses gzip/deflate upstream bodies (as aiohttp
        # does for the JAX gateway), so forwarding the upstream
        # Content-Encoding would declare an encoding the payload no longer
        # has
        "content-encoding",
    }

    async def _proxy_to_agent(
        self, request: wire.Request, tenant: str, app_id: str, agent_id: str
    ) -> wire.Response:
        base = self.registry.service_uri(tenant, app_id, agent_id)
        tail = request.match_info.get("tail", "")
        url = f"{base}/{tail}" if tail else base
        if request.query_string:
            url += f"?{request.query_string}"
        headers = {
            k: v
            for k, v in request.headers.items()
            if k.lower() not in self._HOP_HEADERS
        }
        body = await request.read() if request.can_read_body else None
        try:
            status, _, upstream_headers, payload = await wire.http_request(
                request.method, url, body=body, headers=headers,
                timeout=60.0, decompress=True,
            )
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                ValueError) as e:
            raise wire.HTTPException(
                502, f"agent {agent_id!r} service unreachable: {e}"
            )
        out_headers = {
            k: v
            for k, v in upstream_headers.items()
            if k.lower() not in self._HOP_HEADERS
        }
        content_type = out_headers.pop("content-type", "application/octet-stream")
        return wire.Response(
            status=status, body=payload, headers=out_headers,
            content_type=content_type,
        )

    # ------------------------------------------------------------------
    # service gateway: request/response over topics
    # ------------------------------------------------------------------

    async def _http_service(self, request: wire.Request) -> wire.Response:
        tenant, app_id, gateway, streaming, params, options, credentials = (
            self._context(request)
        )
        if gateway.type != Gateway.SERVICE:
            raise wire.HTTPException(400, "not a service gateway")
        try:
            principal = await self._authenticate(gateway, credentials)
        except AuthenticationException as e:
            raise wire.HTTPException(401, str(e))
        service = gateway.service_options
        agent_id = service.get("agent-id")
        if agent_id:
            # agent-proxy mode (parity: GatewayResource.java:235-241):
            # forward the request to the agent's service URI verbatim
            return await self._proxy_to_agent(
                request, tenant, app_id, agent_id
            )
        input_topic = service.get("input-topic")
        output_topic = service.get("output-topic")
        if not input_topic or not output_topic:
            raise wire.HTTPException(
                400,
                "service gateway needs input-topic/output-topic "
                "(topic mode) or agent-id (proxy mode)"
            )
        correlation = str(uuid.uuid4())
        payload = await self._json_body(request) if request.can_read_body else {}
        runtime = TopicConnectionsRuntimeRegistry.get_runtime(streaming)
        reader = runtime.create_reader(
            {"topic": output_topic}, initial_position="latest"
        )
        await reader.start()
        producer = runtime.create_producer("gateway-service", {"topic": input_topic})
        await producer.start()
        # service round-trips stamp the QoS identity too (the engine's own
        # buckets backstop them); gateway-side shedding stays on the
        # produce/chat paths where a retry hint is actionable
        limiter = self.registry.qos_limiter(tenant, app_id)
        _, qos_priority = self._qos_identity(params, principal)
        inject = {
            **self._mapped_headers(gateway.produce_headers, params, principal),
            **self._qos_headers(limiter, params, principal),
        }
        headers, span = self._traced_headers(
            {
                **(payload.get("headers") or {}),
                **inject,
                "langstream-service-request-id": correlation,
            },
            "gateway.service",
        )
        self._stamp_replica(
            headers, tenant, app_id, params, principal,
            value=payload.get("value"),
        )
        self._stamp_deadline(headers, limiter, params, qos_priority)
        self._journey_produce(headers)
        try:
            # `with span:` so a broker failure mid-write/read still closes
            # the span with its error (end() is idempotent — the explicit
            # ends below keep their timings and error labels)
            with span:
                await producer.write(
                    make_record(
                        value=payload.get("value", payload),
                        key=payload.get("key"),
                        headers=headers,
                    )
                )
                deadline = asyncio.get_event_loop().time() + float(
                    service.get("timeout-seconds", 30)
                )
                while asyncio.get_event_loop().time() < deadline:
                    for record in await reader.read(timeout=0.5):
                        if (
                            record.header("langstream-service-request-id")
                            == correlation
                        ):
                            span.end()
                            return wire.json_response(
                                self._record_json(record),
                                headers={TRACE_HEADER: headers[TRACE_HEADER]},
                            )
                span.end(error="timeout")
                raise wire.HTTPException(504, "no response on output topic")
        finally:
            await producer.close()
            await reader.close()
            await runtime.close()
