"""Kubernetes compute runtime for the control plane (the port's copy of
``langstream_tpu/k8s/compute.py``).

The in-cluster twin of
:class:`langstream_tpu_torch.controlplane.server.LocalComputeRuntime` (same
duck-typed interface the ControlPlaneServer drives: ``deploy`` /
``undeploy`` / ``agent_info`` / ``logs`` / ``close``): instead of running
agents in-process, it plans the application and writes Agent custom
resources + config Secrets for the operator to reconcile into
StatefulSets — the role the reference's webservice plays against
``langstream-k8s-deployer`` (``ApplicationLifecycleService`` →
``AppResourcesFactory``).
"""

from __future__ import annotations

import logging
from collections import deque
from pathlib import Path
from typing import Any, Callable

from langstream_tpu_torch.controlplane.stores import StoredApplication
from langstream_tpu_torch.core.codestorage import make_code_storage
from langstream_tpu_torch.core.deployer import ApplicationDeployer
from langstream_tpu_torch.k8s.client import KubeApi
from langstream_tpu_torch.k8s.cluster_runtime import DEFAULT_IMAGE, KubernetesClusterRuntime

log = logging.getLogger(__name__)


class KubernetesComputeRuntime:
    """Plans apps and manages their Agent CRs in the cluster."""

    def __init__(
        self,
        api: KubeApi,
        image: str = DEFAULT_IMAGE,
        code_storage_config: dict[str, Any] | None = None,
        pods_root: Path | str | None = None,
        pod_address: Callable[[str, str], str | None] | None = None,
    ):
        self.api = api
        # (namespace, pod) -> the pod's base URL, where the cluster DNS name
        # does not reach it (the process kubelet's pods, ``mini up``)
        self.pod_address = pod_address
        # the ProcessKubelet root: pod subprocess stdout/stderr lands in
        # <pods_root>/pods/<namespace>/<pod>/pod.log, which /logs surfaces
        self.pods_root = Path(pods_root) if pods_root is not None else None
        self.code_storage_config = code_storage_config
        self.code_storage = (
            make_code_storage(code_storage_config) if code_storage_config else None
        )
        self.runtime = KubernetesClusterRuntime(
            api, image=image, code_storage=code_storage_config
        )
        self.deployer = ApplicationDeployer()
        self.logs: dict[tuple[str, str], deque[str]] = {}
        self._plans: dict[tuple[str, str], Any] = {}

    def append_log(self, tenant: str, name: str, line: str) -> None:
        self.logs.setdefault((tenant, name), deque(maxlen=1000)).append(line)

    async def deploy(self, stored: StoredApplication, application=None) -> None:
        from langstream_tpu_torch.controlplane.server import parse_stored

        if application is None:
            application = parse_stored(stored)
        key = (stored.tenant, stored.name)
        plan = self.deployer.create_implementation(stored.name, application)
        await self.deployer.setup(plan)

        code_archive_id = None
        if self.code_storage is not None:
            # ship the application package so agent pods' init containers
            # can download custom-agent code
            import io
            import zipfile

            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
                for filename, content in stored.files.items():
                    zf.writestr(f"app/{filename}", content)
            code_archive_id = self.code_storage.store(
                stored.tenant, stored.name, buf.getvalue()
            )
        # stamp the archive onto the stored app: the caller's follow-up
        # put_application persists it into the Application CR, and the
        # operator's deployer Job then writes byte-identical Agent CRs
        stored.code_archive_id = code_archive_id
        crs = self.runtime.deploy(stored.tenant, plan, code_archive_id)
        self._plans[key] = plan
        self.append_log(
            *key, f"wrote {len(crs)} agent CRs (operator reconciles them)"
        )

    async def undeploy(self, tenant: str, name: str) -> None:
        from langstream_tpu_torch.k8s.cluster_runtime import tenant_namespace

        key = (tenant, name)
        plan = self._plans.pop(key, None)
        if plan is not None:
            self.runtime.delete(tenant, plan)
        else:
            # control plane restarted since deploy: delete by listing the
            # application's live CRs instead of re-planning
            namespace = tenant_namespace(tenant)
            for existing in self.runtime.current_agents(tenant, name):
                cr_name = existing["metadata"]["name"]
                self.api.delete("Agent", namespace, cr_name)
                self.api.delete("Secret", namespace, f"{cr_name}-config")
        self.logs.pop(key, None)

    def pod_logs(
        self, tenant: str, name: str, tail: int = 200
    ) -> dict[str, list[str]]:
        """Pod name → last ``tail`` lines of its ``pod.log``.

        Pod names come from the application's live StatefulSets and Jobs,
        matched by their ``langstream-application`` label — name-prefix
        matching against kubelet directories would leak logs across
        applications whose ids prefix each other (``chat`` vs ``chat-2``).
        STS pods are ``<sts>-<ordinal>``; a Job's pod shares the Job's
        name (see ``ProcessKubelet``). Synchronous file I/O by design:
        the /logs handler offloads it to an executor.
        """
        from langstream_tpu_torch.k8s.cluster_runtime import tenant_namespace

        if self.pods_root is None:
            return {}
        namespace = tenant_namespace(tenant)
        ns_dir = self.pods_root / "pods" / namespace
        if not ns_dir.is_dir():
            return {}
        selector = {"langstream-application": name}
        pod_names: set[str] = set()
        for sts in self.api.list(
            "StatefulSet", namespace, label_selector=selector
        ):
            sts_name = sts["metadata"]["name"]
            replicas = int(sts["spec"].get("replicas", 1))
            pod_names.update(f"{sts_name}-{i}" for i in range(replicas))
        for job in self.api.list("Job", namespace, label_selector=selector):
            pod_names.add(job["metadata"]["name"])
        out: dict[str, list[str]] = {}
        for pod_name in sorted(pod_names):
            log_path = ns_dir / pod_name / "pod.log"
            if not log_path.is_file():
                continue
            # bounded tail read: pod.log is append-only and never rotated,
            # so reading the whole file would grow without limit
            window = max(tail * 512, 65536)
            try:
                with log_path.open("rb") as f:
                    f.seek(0, 2)
                    size = f.tell()
                    f.seek(max(0, size - window))
                    chunk = f.read(window)
            except OSError:
                continue
            lines = chunk.decode(errors="replace").splitlines()
            if size > window:
                lines = lines[1:]  # window start lands mid-line; drop it
            out[pod_name] = lines[-tail:]
        return out

    def _pod_addresses(self, tenant: str, name: str) -> dict[str, str]:
        """Pod name → in-cluster base URL for the runtime's :8080 server,
        via the STS headless service (``<pod>.<service>.<ns>.svc``)."""
        from langstream_tpu_torch.k8s.cluster_runtime import tenant_namespace
        from langstream_tpu_torch.k8s.resources import AGENT_PORT

        namespace = tenant_namespace(tenant)
        selector = {"langstream-application": name}
        out: dict[str, str] = {}
        for sts in self.api.list(
            "StatefulSet", namespace, label_selector=selector
        ):
            sts_name = sts["metadata"]["name"]
            service = sts["spec"].get("serviceName", sts_name)
            for i in range(int(sts["spec"].get("replicas", 1))):
                pod = f"{sts_name}-{i}"
                address = (self.pod_address(namespace, pod)
                           if self.pod_address is not None else None)
                out[pod] = address or (
                    f"http://{pod}.{service}.{namespace}.svc:{AGENT_PORT}"
                )
        return out

    def _pod_json_fanin(
        self, tenant: str, name: str, path: str
    ) -> list[tuple[str, Any]]:
        """(pod, parsed JSON payload) for every application pod serving
        ``path`` on its runtime HTTP port. Best-effort: an unreachable pod
        contributes ``None`` — aggregation must not 502 because one
        replica is restarting. Member-shaped aggregates (flight, qos,
        health, slo) MUST surface the ``None`` as an ``unreachable``
        member rather than dropping it (an operator reading an aggregate
        that silently omits the one pod that timed out would conclude
        the fleet is fine precisely when it is not); :meth:`traces` is
        the one exception — its payload is a span/rollup list keyed by
        trace_id with no per-pod member shape to hang the marker on.
        Non-2xx answers parse like any other body (probe
        endpoints speak JSON at 503 too). Synchronous by design (handlers
        run it in a thread); pods are fetched concurrently — serial 2 s
        timeouts against a rolling restart would cost replicas x 2 s per
        request."""
        import json as _json
        import urllib.error
        import urllib.request
        from concurrent.futures import ThreadPoolExecutor

        def _fetch(pod_base: tuple[str, str]) -> tuple[str, Any]:
            pod, base = pod_base
            try:
                with urllib.request.urlopen(base + path, timeout=2) as resp:
                    return pod, _json.loads(resp.read())
            except urllib.error.HTTPError as e:
                # the pod answered: a 503 probe body is a report, not an
                # outage — read it. The read itself can still stall/fail
                # (status line sent, body never arrives — the wedged-pod
                # shape), so OSError here means unreachable too, never a
                # 500 out of the aggregate route
                try:
                    return pod, _json.loads(e.read())
                except (OSError, ValueError):
                    log.debug("pod %s %s: unreadable %s body", pod, path, e.code)
                    return pod, None
            except (urllib.error.URLError, OSError, ValueError) as e:
                log.debug("pod %s %s unreachable: %s", pod, path, e)
                return pod, None

        pods = sorted(self._pod_addresses(tenant, name).items())
        if not pods:
            return []
        with ThreadPoolExecutor(max_workers=min(8, len(pods))) as pool:
            return list(pool.map(_fetch, pods))

    def traces(
        self, tenant: str, name: str, trace_id: str | None = None
    ) -> list[dict[str, Any]]:
        """Aggregate the application pods' ``/traces`` ring buffers (the
        same fan-in /logs does for pod.log, but over the pods' HTTP
        endpoints)."""
        path = f"/traces/{trace_id}" if trace_id else "/traces"
        merged: list[dict[str, Any]] = []
        for _pod, chunk in self._pod_json_fanin(tenant, name, path):
            if isinstance(chunk, list):
                merged.extend(chunk)
        if trace_id is None:
            # index entries are per-pod PARTIAL rollups of the same trace
            # (each agent pod buffered its own hop): merge them per
            # trace_id or a client keying by id sees duplicate rows with
            # conflicting span counts/durations
            merged = self._merge_summaries(merged)
        merged.sort(key=lambda s: s.get("start_ms", 0.0))
        return merged

    @staticmethod
    def _merge_summaries(
        partials: list[dict[str, Any]]
    ) -> list[dict[str, Any]]:
        by_trace: dict[str, dict[str, Any]] = {}
        for part in partials:
            trace_id = part.get("trace_id")
            agg = by_trace.get(trace_id)
            if agg is None:
                by_trace[trace_id] = dict(part)
                continue
            start = min(agg["start_ms"], part.get("start_ms", 0.0))
            end = max(
                agg["start_ms"] + agg.get("duration_ms", 0.0),
                part.get("start_ms", 0.0) + part.get("duration_ms", 0.0),
            )
            if part.get("start_ms", 0.0) < agg["start_ms"]:
                # root-most span name comes from the earliest partial
                agg["root"] = part.get("root")
            agg["start_ms"] = start
            agg["duration_ms"] = round(end - start, 3)
            agg["spans"] = agg.get("spans", 0) + part.get("spans", 0)
            agg["errors"] = agg.get("errors", 0) + part.get("errors", 0)
            agg["services"] = sorted(
                {*agg.get("services", []), *part.get("services", [])}
            )
        return list(by_trace.values())

    def journey(
        self, tenant: str, name: str, journey_id: str
    ) -> dict[str, Any]:
        """Stitch one request's journey across the application's pods
        (the ``/api/applications/{t}/{n}/journey/{id}`` route): each pod
        serves its PARTIAL event ledger on ``/journey/{id}``, and the
        merge orders every pod's edges into one timeline with its
        segment decomposition — the disaggregated case is the point
        (prefill pod, decode pod, and any bounced replica each hold a
        partial; docs/OBSERVABILITY.md "Request journey plane"). Events
        are tagged with their pod before stitching so the waterfall
        names where each edge happened. Unreachable pods simply
        contribute nothing — a partial timeline with a flagged gap
        beats a 502."""
        from langstream_tpu_torch.serving.journey import stitch

        partials: list[list[dict[str, Any]]] = []
        for pod, chunk in self._pod_json_fanin(
            tenant, name, f"/journey/{journey_id}"
        ):
            if isinstance(chunk, list) and chunk:
                partials.append(
                    [
                        {"pod": pod, **event}
                        for event in chunk
                        if isinstance(event, dict)
                    ]
                )
        if not partials:
            return {}
        return stitch(journey_id, partials)

    def flight(self, tenant: str, name: str) -> list[dict[str, Any]]:
        """Fan in the application pods' ``/flight`` reports. Unlike traces
        (one logical trace spans pods, so partial rollups merge), a flight
        entry is one engine on one pod — entries concatenate, each tagged
        with its pod so ``engine_top`` and operators can tell replicas
        apart. A pod whose fetch timed out appears as an ``unreachable``
        member: during an incident the missing replica IS the signal, and
        silently dropping it made the aggregate read healthy exactly when
        a pod hung."""
        merged: list[dict[str, Any]] = []
        for pod, chunk in self._pod_json_fanin(tenant, name, "/flight"):
            if chunk is None:
                merged.append({"pod": pod, "unreachable": True})
                continue
            for entry in chunk if isinstance(chunk, list) else []:
                if isinstance(entry, dict):
                    merged.append({"pod": pod, **entry})
        return merged

    def attribution(self, tenant: str, name: str) -> list[dict[str, Any]]:
        """Fan in the application pods' ``/attribution`` payloads —
        device attribution (per-program cost ledger + HBM memory
        ledger) concatenates per engine per pod exactly like
        :meth:`flight`, with timed-out pods surfaced as ``unreachable``
        members, never dropped."""
        merged: list[dict[str, Any]] = []
        for pod, chunk in self._pod_json_fanin(tenant, name, "/attribution"):
            if chunk is None:
                merged.append({"pod": pod, "unreachable": True})
                continue
            for entry in chunk if isinstance(chunk, list) else []:
                if isinstance(entry, dict):
                    merged.append({"pod": pod, **entry})
        return merged

    def incidents(
        self, tenant: str, name: str, bundle_id: str | None = None
    ) -> list[dict[str, Any]]:
        """Fan in the application pods' ``/incidents`` payloads — the
        bounded breach-bundle index per engine per pod (or one full
        bundle by id), concatenated exactly like :meth:`flight`, with
        timed-out pods surfaced as ``unreachable`` members: during an
        incident the replica that stopped answering is evidence, not
        noise."""
        path = "/incidents" + (f"/{bundle_id}" if bundle_id else "")
        merged: list[dict[str, Any]] = []
        for pod, chunk in self._pod_json_fanin(tenant, name, path):
            if chunk is None:
                if bundle_id is None:
                    merged.append({"pod": pod, "unreachable": True})
                continue
            for entry in chunk if isinstance(chunk, list) else []:
                if isinstance(entry, dict):
                    merged.append({"pod": pod, **entry})
        return merged

    def _summary_section_fanin(
        self, tenant: str, name: str, section: str
    ) -> dict[str, Any]:
        """Shared shape of the qos/slo aggregates: fan in the pods'
        ``/flight/summary`` entries and keep one ``section`` per engine,
        tagged per pod like :meth:`flight`; timed-out pods surface as
        ``unreachable`` members. The declared policy lives in the stored
        application (the control plane serves it from the app files), so
        ``configured`` stays empty here — the dev-mode runtime fills
        it."""
        engines: list[dict[str, Any]] = []
        for pod, chunk in self._pod_json_fanin(tenant, name, "/flight/summary"):
            if chunk is None:
                engines.append({"pod": pod, "unreachable": True})
                continue
            for entry in chunk if isinstance(chunk, list) else []:
                if isinstance(entry, dict):
                    engines.append(
                        {
                            "pod": pod,
                            "model": entry.get("model"),
                            section: entry.get(section),
                        }
                    )
        return {"configured": {}, "engines": engines}

    def qos(self, tenant: str, name: str) -> dict[str, Any]:
        """QoS status: the per-engine ``scheduler`` sections (per-class
        queued/admitted/shed/preempted counters + tenant throttles) off
        ``/flight/summary`` — the engine exposes no dedicated QoS
        endpoint by design."""
        return self._summary_section_fanin(tenant, name, "scheduler")

    def health(self, tenant: str, name: str) -> dict[str, Any]:
        """Fleet health: fan in the pods' ``/healthz`` verdicts (each a
        dict — status + per-engine watchdog sections, runtime/pod.py) and
        aggregate worst-state. Unreachable pods are first-class members,
        ranked ``degraded`` for the aggregate: a pod that cannot answer
        its own health probe may be restarting (routine) or hung (the
        r03 shape) — the member entry carries the evidence either way,
        and its own liveness probe is what escalates a hang to a
        reschedule."""
        from langstream_tpu_torch.serving.health import worst_state

        pods: list[dict[str, Any]] = []
        states: list[str] = []
        for pod, payload in self._pod_json_fanin(tenant, name, "/healthz"):
            if not isinstance(payload, dict):
                pods.append({"pod": pod, "unreachable": True})
                states.append("degraded")
                continue
            pods.append({"pod": pod, **payload})
            states.append(payload.get("status", "wedged"))
        return {"status": worst_state(states), "pods": pods}

    def slo(self, tenant: str, name: str) -> dict[str, Any]:
        """SLO status: the per-engine ``slo`` sections (burn rates,
        budget remaining, alerting objectives) off ``/flight/summary``."""
        return self._summary_section_fanin(tenant, name, "slo")

    def agent_info(self, tenant: str, name: str) -> list[dict[str, Any]]:
        """Agent CR specs + operator-written statuses."""
        return [
            {
                "agent-id": cr["spec"].get("agentId"),
                "type": "k8s-agent",
                "status": cr.get("status", {}),
                "resources": cr["spec"].get("resources", {}),
            }
            for cr in self.runtime.current_agents(tenant, name)
        ]

    # ------------------------------------------------------------------
    # fleet plane: observe / scale / drain (docs/FLEET.md)
    # ------------------------------------------------------------------

    def serving_statefulsets(
        self, tenant: str, name: str
    ) -> list[dict[str, Any]]:
        """The application's *scalable* StatefulSets: single-host agents
        whose replicas are data-parallel pods. Multi-host ICI slices are
        excluded — their STS replica count is the slice's HOST count
        (one torch.distributed world), and "scaling" it would tear the
        collective topology, not add serving capacity; slice fan-out is
        the factory's per-logical-replica STS split instead."""
        from langstream_tpu_torch.k8s.cluster_runtime import tenant_namespace

        namespace = tenant_namespace(tenant)
        out = []
        for sts in self.api.list(
            "StatefulSet", namespace,
            label_selector={"langstream-application": name},
        ):
            template = (
                (sts["spec"].get("template") or {}).get("spec") or {}
            )
            env = {
                e.get("name"): e.get("value")
                for c in template.get("containers", [])
                for e in c.get("env", [])
            }
            if int(env.get("LS_SLICE_HOSTS") or 1) > 1:
                continue
            out.append(sts)
        return out

    def fleet_observe(
        self, tenant: str, name: str, sts_name: str
    ) -> list[dict[str, Any]]:
        """One :class:`ReplicaObservation` dict per pod of ``sts_name``,
        folded from the pods' ``/flight/summary`` fan-in (queue depths,
        occupancy, KV pressure, health/drain posture, SLO alerts).
        Timed-out pods surface as ``unreachable`` members — the
        autoscaler treats a missing replica as a reason NOT to scale
        down, never as absent capacity."""
        from langstream_tpu_torch.controlplane.autoscaler import (
            observation_from_summary,
        )

        prefix = f"{sts_name}-"
        observations = []
        for pod, chunk in self._pod_json_fanin(tenant, name, "/flight/summary"):
            # exact-STS match: the tail must be the pod ORDINAL, or a
            # sibling STS whose name extends this one's ("chat-ai" vs
            # "chat-ai-extra") would leak its pods into this fleet —
            # the same dash-prefix leak shape pod_logs fixed with label
            # selectors
            if not pod.startswith(prefix) or not pod[len(prefix):].isdigit():
                continue
            observations.append(observation_from_summary(pod, chunk).to_dict())
        return observations

    def scale_statefulset(
        self, tenant: str, name: str, sts_name: str, replicas: int
    ) -> None:
        """Patch the StatefulSet's replica count, stamping the autoscale
        annotation so the operator's level-triggered reconcile preserves
        the live value instead of resetting it to the CR's parallelism
        (``AgentController._preserve_autoscaled_replicas``)."""
        from langstream_tpu_torch.controlplane.autoscaler import AUTOSCALE_ANNOTATION
        from langstream_tpu_torch.k8s.cluster_runtime import tenant_namespace

        namespace = tenant_namespace(tenant)
        sts = self.api.get("StatefulSet", namespace, sts_name)
        if sts is None:
            raise KeyError(f"StatefulSet {sts_name!r} not found in {namespace}")
        sts["spec"]["replicas"] = int(replicas)
        sts.setdefault("metadata", {}).setdefault("annotations", {})[
            AUTOSCALE_ANNOTATION
        ] = "true"
        self.api.apply(sts)
        self.append_log(
            tenant, name, f"autoscaler: {sts_name} replicas -> {replicas}"
        )

    def drain_pod(
        self, tenant: str, name: str, pod: str, grace_s: float = 30.0
    ) -> dict[str, Any] | None:
        """Hit one pod's ``/drain`` endpoint and block until it settles
        (the endpoint answers only after the engines requeued their work
        or the grace budget expired). ``None`` when the pod is already
        unreachable — for the scale-down path that is equivalent to a
        drained pod: there is nothing left to lose on it. Synchronous by
        design (the autoscaler runs backend calls in a worker thread)."""
        import json as _json
        import urllib.error
        import urllib.request

        base = self._pod_addresses(tenant, name).get(pod)
        if base is None:
            return None
        url = f"{base}/drain?grace-s={float(grace_s):g}"
        try:
            with urllib.request.urlopen(url, timeout=grace_s + 10) as resp:
                return _json.loads(resp.read())
        except (urllib.error.URLError, OSError, ValueError) as e:
            log.warning("drain of pod %s failed (%s); treating as gone", pod, e)
            return None

    def autoscaler_backend(self, tenant: str, name: str, spec) -> Any:
        """A :class:`FleetAutoscaler` backend for the app's serving
        StatefulSet (``spec.agent`` disambiguates when the app has
        several scalable agents). STS resolution is LAZY — at deploy
        time the operator has not reconciled the Agent CRs into
        StatefulSets yet, so the backend re-resolves per observation
        until one exists (an unresolved fleet observes as empty, which
        the autoscaler treats as "nothing to decide")."""
        return StatefulSetFleetBackend(self, tenant, name, spec)

    async def close(self) -> None:
        pass


class StatefulSetFleetBackend:
    """The duck-typed backend a :class:`FleetAutoscaler` drives against a
    live cluster: observe = pod ``/flight/summary`` fan-in, scale =
    StatefulSet replica patch, drain = pod ``/drain``. All methods are
    synchronous (pod HTTP + API-server round-trips); the autoscaler runs
    them in a worker thread so the control plane's event loop — and the
    wait-free decide() — never block on a slow pod."""

    def __init__(
        self,
        runtime: KubernetesComputeRuntime,
        tenant: str,
        name: str,
        spec: Any = None,
    ):
        self.runtime = runtime
        self.tenant = tenant
        self.name = name
        self.spec = spec
        self._sts_name: str | None = None

    def resolve(self) -> str | None:
        """The target StatefulSet's name, re-resolved until the operator
        has materialized it (cached afterwards — STS names are stable
        for an app's lifetime)."""
        if self._sts_name is not None:
            return self._sts_name
        from langstream_tpu_torch.k8s.resources import AgentResourcesFactory

        candidates = self.runtime.serving_statefulsets(self.tenant, self.name)
        if self.spec is not None and getattr(self.spec, "agent", None):
            wanted = AgentResourcesFactory.agent_resource_name(
                self.name, self.spec.agent
            )
            pool = getattr(self.spec, "pool", None)
            wanted_names = {wanted}
            if pool:
                wanted_names.add(f"{wanted}-{pool}")
            candidates = [
                s
                for s in candidates
                if s["metadata"]["name"] in wanted_names
            ]
        if self.spec is not None and getattr(self.spec, "pool", None):
            # disaggregated split (docs/DISAGG.md): each pool's policy
            # scales ITS StatefulSet — the factory names them
            # `<agent-sts>-<role>`
            suffix = f"-{self.spec.pool}"
            pooled = [
                s
                for s in candidates
                if s["metadata"]["name"].endswith(suffix)
            ]
            if candidates and not pooled:
                # StatefulSets exist but none carries this pool's
                # suffix: the app declared a pools: autoscale policy
                # without the agent-level pool-roles split — a
                # misconfiguration, not a not-yet-materialized STS, so
                # say so instead of lazily resolving forever
                log.warning(
                    "application %s/%s declares a pools.%s autoscale "
                    "policy but no '-%s' StatefulSet exists (agents: "
                    "%s) — declare pool-roles on the serving agent so "
                    "the fleet actually splits (docs/DISAGG.md)",
                    self.tenant, self.name, self.spec.pool,
                    self.spec.pool,
                    sorted(s["metadata"]["name"] for s in candidates),
                )
            candidates = pooled
        if not candidates:
            return None
        if len(candidates) > 1:
            log.warning(
                "application %s/%s has %d scalable StatefulSets and no "
                "autoscale.agent — scaling %s",
                self.tenant, self.name, len(candidates),
                sorted(s["metadata"]["name"] for s in candidates)[0],
            )
        self._sts_name = sorted(
            s["metadata"]["name"] for s in candidates
        )[0]
        return self._sts_name

    def observe(self) -> list[dict[str, Any]]:
        sts_name = self.resolve()
        if sts_name is None:
            return []
        return self.runtime.fleet_observe(self.tenant, self.name, sts_name)

    def set_replicas(self, replicas: int) -> None:
        sts_name = self.resolve()
        if sts_name is None:
            raise KeyError(
                f"no scalable StatefulSet for {self.tenant}/{self.name}"
            )
        self.runtime.scale_statefulset(
            self.tenant, self.name, sts_name, replicas
        )

    def drain(self, replica: str, grace_s: float) -> dict[str, Any] | None:
        return self.runtime.drain_pod(
            self.tenant, self.name, replica, grace_s
        )
