"""The operator: reconcilers for Application and Agent CRs (the port's copy
of ``langstream_tpu/k8s/operator.py``).

Parity: ``langstream-k8s-deployer-operator`` —
``AppController.reconcile`` (Application CR → setup Job, then deployer Job;
``controllers/apps/AppController.java:54,314``) and
``AgentController.reconcile`` (Agent CR → StatefulSet(s) + headless Service,
status DEPLOYING/DEPLOYED from STS readiness;
``controllers/agents/AgentController.java:49-92``), with infinite retry
(``InfiniteRetry.java``) expressed as a poll loop that never gives up on a
failing resource.

The reconcilers are pure functions of (CR, cluster state) → (writes, status),
so they run identically against :class:`InMemoryKubeApi` in tests and
:class:`HttpKubeApi` in a cluster.

The port's departures: the manifests are the port's
(:mod:`langstream_tpu_torch.k8s.resources`): agents with a device mesh are
placed on the H100 node pool that ``LS_ACCELERATOR`` names
(:func:`~langstream_tpu_torch.k8s.resources.accelerator_from_env`: ``h100``
when unset; a TPU name such as the JAX operator's default ``v5e`` is
refused when the operator is built, before its loop starts), and every pod
and Job starts as ``python -m serve_torch --device <device> pod ...``, the
device the operator was given.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import time
from typing import Any

from langstream_tpu_torch.k8s.client import KubeApi
from langstream_tpu_torch.k8s.crds import (
    AgentCustomResource,
    ApplicationCustomResource,
    config_checksum,
)
from langstream_tpu_torch.k8s.diff import specs_equal
from langstream_tpu_torch.k8s.resources import (
    AgentResourcesFactory,
    AppResourcesFactory,
    accelerator_from_env,
    gpu_placement,
)

log = logging.getLogger(__name__)

# Application/Agent lifecycle statuses (parity: ApplicationLifecycleStatus)
DEPLOYING = "DEPLOYING"
DEPLOYED = "DEPLOYED"
ERROR_DEPLOYING = "ERROR_DEPLOYING"
DELETING = "DELETING"


def apply_if_changed(api: KubeApi, obj: dict[str, Any]) -> dict[str, Any]:
    """Level-triggered writes without churn: skip the PUT when the desired
    spec/data/labels/ownerReferences already match (every tick would
    otherwise rewrite every object, hammering the API server and bumping
    resourceVersions). ownerReferences participate so dependents created
    before owner-stamping existed still get their refs on the next tick —
    without them, deleting the owning CR would orphan them forever."""
    meta = obj.get("metadata") or {}
    existing = api.get(obj["kind"], meta.get("namespace"), meta["name"])
    existing_meta = (existing or {}).get("metadata") or {}
    if existing is not None and all(
        specs_equal(obj.get(k), existing.get(k)) for k in ("spec", "data")
    ) and specs_equal(meta.get("labels"), existing_meta.get("labels")) and specs_equal(
        meta.get("ownerReferences"), existing_meta.get("ownerReferences")
    ):
        return existing
    return api.apply(obj)


class AgentController:
    """Agent CR → StatefulSet(s) + headless Service; status from readiness.
    ``accelerator`` is a port placement entry (default: ``LS_ACCELERATOR``,
    else ``h100``), ``device`` the pods' ``--device``."""

    def __init__(self, api: KubeApi, accelerator: str | None = None, device: str = "cuda"):
        self.api = api
        self.accelerator = accelerator or accelerator_from_env()
        gpu_placement(self.accelerator, 1)  # an unknown entry fails here
        self.device = device

    @staticmethod
    def _own(obj: dict[str, Any], cr_dict: dict[str, Any]) -> dict[str, Any]:
        """Stamp the Agent CR as controller-owner so deleting the CR
        cascades to its dependents via server-side garbage collection
        (parity: fabric8 dependents in AgentController.java — dependents
        carry owner references, the API server GC does the deletion)."""
        meta = cr_dict.get("metadata") or {}
        if meta.get("uid"):
            obj.setdefault("metadata", {})["ownerReferences"] = [{
                "apiVersion": "langstream.tpu/v1alpha1",
                "kind": "Agent",
                "name": meta["name"],
                "uid": meta["uid"],
                "controller": True,
                "blockOwnerDeletion": True,
            }]
        return obj

    def _preserve_autoscaled_replicas(self, sts: dict[str, Any]) -> None:
        """The fleet autoscaler owns the replica count of StatefulSets it
        has stamped (``langstream.tpu/autoscale``): the level-triggered
        reconcile must carry the LIVE count (and the stamp) into the
        desired spec, or every tick would fight the autoscaler back to
        the CR's parallelism — exactly the churn HPA-managed Deployments
        avoid by omitting ``replicas``."""
        from langstream_tpu_torch.controlplane.autoscaler import AUTOSCALE_ANNOTATION

        meta = sts["metadata"]
        existing = self.api.get("StatefulSet", meta["namespace"], meta["name"])
        if existing is None:
            return
        annotations = (existing.get("metadata") or {}).get("annotations") or {}
        if annotations.get(AUTOSCALE_ANNOTATION) != "true":
            return
        live = (existing.get("spec") or {}).get("replicas")
        if live is not None:
            sts["spec"]["replicas"] = int(live)
        meta.setdefault("annotations", {})[AUTOSCALE_ANNOTATION] = "true"

    def reconcile(self, cr_dict: dict[str, Any]) -> str:
        cr = AgentCustomResource.from_dict(cr_dict)
        service = self._own(
            AgentResourcesFactory.generate_headless_service(cr_dict), cr_dict
        )
        apply_if_changed(self.api, service)
        statefulsets = [
            self._own(sts, cr_dict)
            for sts in AgentResourcesFactory.generate_statefulsets(
                cr_dict, accelerator=self.accelerator, device=self.device
            )
        ]
        for sts in statefulsets:
            self._preserve_autoscaled_replicas(sts)
        # voluntary-eviction protection: one PDB per STS (maxUnavailable 1)
        # so node drains take serving pods one at a time through the same
        # preStop /drain path the autoscaler's scale-down uses
        pdbs = [
            self._own(pdb, cr_dict)
            for pdb in AgentResourcesFactory.generate_pod_disruption_budgets(
                cr_dict, statefulsets
            )
        ]
        # prune StatefulSets (and their PDBs) from a previous shape (e.g.
        # parallelism shrank or the agent moved between single- and
        # multi-host)
        wanted = {sts["metadata"]["name"] for sts in statefulsets}
        selector = {
            "langstream-application": cr.spec.application_id,
            "langstream-agent": cr.spec.agent_id,
        }
        for kind in ("StatefulSet", "PodDisruptionBudget"):
            for obj in self.api.list(kind, cr.namespace, label_selector=selector):
                if obj["metadata"]["name"] not in wanted:
                    self.api.delete(kind, cr.namespace, obj["metadata"]["name"])
        for pdb in pdbs:
            apply_if_changed(self.api, pdb)
        ready = True
        for sts in statefulsets:
            applied = apply_if_changed(self.api, sts)
            status = (applied or {}).get("status") or {}
            if status.get("readyReplicas", 0) < sts["spec"]["replicas"]:
                ready = False
        phase = DEPLOYED if ready else DEPLOYING
        if (cr.status or {}).get("status") != phase:
            self.api.update_status(
                {**cr_dict, "status": {**cr.status, "status": phase}}
            )
        return phase

    def cleanup(self, cr_dict: dict[str, Any]) -> None:
        cr = AgentCustomResource.from_dict(cr_dict)
        selector = {
            "langstream-application": cr.spec.application_id,
            "langstream-agent": cr.spec.agent_id,
        }
        for kind in ("StatefulSet", "PodDisruptionBudget"):
            for obj in self.api.list(kind, cr.namespace, label_selector=selector):
                self.api.delete(kind, cr.namespace, obj["metadata"]["name"])
        name = AgentResourcesFactory.agent_resource_name(
            cr.spec.application_id, cr.spec.agent_id
        )
        self.api.delete("Service", cr.namespace, name)


class AppController:
    """Application CR → setup Job → deployer Job (two-phase deploy); the
    Jobs' pods start on ``device``."""

    def __init__(self, api: KubeApi, device: str = "cuda"):
        self.api = api
        self.device = device

    def _ensure_app_config_secret(
        self, cr: ApplicationCustomResource
    ) -> tuple[str, str]:
        """Materialize the config document the setup/deployer Jobs mount:
        the parsed files + instance from the Application CR, the secrets
        YAML from the companion ``<app>-secrets`` Secret, and code-storage
        coordinates (what :func:`runtime.pod.run_setup`/``run_deployer``
        read). Returns (secret name, config checksum) — the checksum keys
        the Jobs' identity so an updated app re-runs them."""
        name = f"{cr.name}-app-config"
        payload = json.loads(cr.spec.application or "{}")
        secrets_yaml = None
        secrets_obj = self.api.get("Secret", cr.namespace, f"{cr.name}-secrets")
        if secrets_obj is not None:
            raw = (secrets_obj.get("data") or {}).get("secrets", "")
            secrets_yaml = base64.b64decode(raw).decode() if raw else None
        config = {
            "applicationId": cr.name,
            "tenant": cr.spec.tenant,
            "image": cr.spec.image,
            "files": payload.get("files") or {},
            "instance": payload.get("instance"),
            "secrets": secrets_yaml,
            "codeArchiveId": cr.spec.code_archive_id,
            "codeStorage": (cr.spec.options or {}).get("codeStorage") or {},
        }
        apply_if_changed(
            self.api,
            {
                "apiVersion": "v1",
                "kind": "Secret",
                "metadata": {
                    "name": name,
                    "namespace": cr.namespace,
                    "labels": {"langstream-application": cr.name},
                },
                "data": {
                    "config": base64.b64encode(
                        json.dumps(config).encode()
                    ).decode()
                },
            },
        )
        return name, config_checksum(config)

    def _prune_stale_jobs(
        self, cr: ApplicationCustomResource, keep: set[str]
    ) -> None:
        for job in self.api.list(
            "Job", cr.namespace, label_selector={"langstream-application": cr.name}
        ):
            if job["metadata"]["name"] not in keep:
                self.api.delete("Job", cr.namespace, job["metadata"]["name"])

    def reconcile(self, cr_dict: dict[str, Any]) -> str:
        cr = ApplicationCustomResource.from_dict(cr_dict)
        image = cr.spec.image
        config_secret, checksum = self._ensure_app_config_secret(cr)
        suffix = f"-{checksum[:8]}"
        setup_job = AppResourcesFactory.generate_setup_job(
            cr.spec.tenant, cr.name, cr.namespace, image, config_secret,
            name_suffix=suffix, device=self.device,
        )
        deployer_job = AppResourcesFactory.generate_deployer_job(
            cr.spec.tenant, cr.name, cr.namespace, image, config_secret,
            name_suffix=suffix, device=self.device,
        )
        # an updated app produces a new checksum → fresh jobs; older
        # generations' jobs are pruned
        self._prune_stale_jobs(
            cr,
            keep={
                setup_job["metadata"]["name"],
                deployer_job["metadata"]["name"],
            },
        )
        existing_setup = self.api.get(
            "Job", cr.namespace, setup_job["metadata"]["name"]
        )
        if existing_setup is None:
            self.api.apply(setup_job)
            return self._set_status(cr_dict, DEPLOYING, "setup job created")
        if not _job_succeeded(existing_setup):
            return self._set_status(cr_dict, DEPLOYING, "waiting for setup job")

        existing_deployer = self.api.get(
            "Job", cr.namespace, deployer_job["metadata"]["name"]
        )
        if existing_deployer is None:
            self.api.apply(deployer_job)
            return self._set_status(cr_dict, DEPLOYING, "deployer job created")
        if not _job_succeeded(existing_deployer):
            return self._set_status(cr_dict, DEPLOYING, "waiting for deployer job")
        return self._set_status(cr_dict, DEPLOYED, "deployed")

    def cleanup(self, cr_dict: dict[str, Any]) -> str:
        """Delete path: run the deployer job with ``delete`` to tear down
        Agent CRs, then remove every job and the config Secret."""
        cr = ApplicationCustomResource.from_dict(cr_dict)
        config_secret = f"{cr.name}-app-config"
        delete_job = AppResourcesFactory.generate_deployer_job(
            cr.spec.tenant, cr.name, cr.namespace, cr.spec.image,
            config_secret, delete=True, device=self.device,
        )
        existing = self.api.get("Job", cr.namespace, delete_job["metadata"]["name"])
        if existing is None:
            self.api.apply(delete_job)
            return DELETING
        if not _job_succeeded(existing):
            return DELETING
        self._prune_stale_jobs(cr, keep=set())
        # the config Secret carries the full app (incl. secrets YAML) —
        # never leave it behind
        self.api.delete("Secret", cr.namespace, config_secret)
        return "DELETED"

    def _set_status(self, cr_dict: dict[str, Any], phase: str, reason: str) -> str:
        current = (cr_dict.get("status") or {})
        if current.get("status") != phase or current.get("reason") != reason:
            self.api.update_status(
                {**cr_dict, "status": {"status": phase, "reason": reason}}
            )
        return phase


def _job_succeeded(job: dict[str, Any]) -> bool:
    return ((job.get("status") or {}).get("succeeded") or 0) >= 1


class Operator:
    """Poll-based reconcile loop over all namespaces.

    The reference uses informer-driven reconciliation with leader election;
    here a single loop lists CRs on an interval — the reconcilers themselves
    are level-triggered and idempotent, so missed events only cost latency.
    Infinite retry: reconcile failures are logged and retried next tick.
    """

    def __init__(
        self,
        api: KubeApi,
        interval: float = 2.0,
        accelerator: str | None = None,
        watch: bool = False,
        device: str = "cuda",
    ):
        self.api = api
        self.interval = interval
        self.apps = AppController(api, device=device)
        self.agents = AgentController(api, accelerator=accelerator, device=device)
        self._stop = asyncio.Event()
        # watch mode: CR events wake the loop immediately instead of
        # waiting out the poll interval (the poll remains as the resync
        # backstop — informer semantics without an informer cache)
        self.watch = watch and hasattr(api, "watch")
        self._wake: asyncio.Event = asyncio.Event()
        self._watch_threads: list = []

    def reconcile_once(self) -> dict[str, str]:
        statuses: dict[str, str] = {}
        for cr in self.api.list("Application"):
            name = cr["metadata"]["name"]
            try:
                statuses[f"app/{name}"] = self.apps.reconcile(cr)
            except Exception as e:  # infinite retry: next tick
                log.exception("app reconcile failed for %s", name)
                statuses[f"app/{name}"] = f"RETRY: {e}"
        for cr in self.api.list("Agent"):
            name = cr["metadata"]["name"]
            try:
                statuses[f"agent/{name}"] = self.agents.reconcile(cr)
            except Exception as e:
                log.exception("agent reconcile failed for %s", name)
                statuses[f"agent/{name}"] = f"RETRY: {e}"
        return statuses

    def _start_watchers(self, loop: asyncio.AbstractEventLoop) -> None:
        import threading

        def _watch_kind(kind: str) -> None:
            while not self._stop.is_set():
                try:
                    for _event, _obj in self.api.watch(kind, timeout_s=30):
                        if self._stop.is_set():
                            return
                        loop.call_soon_threadsafe(self._wake.set)
                except Exception:
                    # watch streams are best-effort wake-ups; the poll
                    # backstop guarantees progress — back off and redial
                    if self._stop.is_set():
                        return
                    time.sleep(1.0)

        for kind in ("Application", "Agent"):
            t = threading.Thread(
                target=_watch_kind, args=(kind,),
                name=f"operator-watch-{kind}", daemon=True,
            )
            t.start()
            self._watch_threads.append(t)

    async def run(self) -> None:
        if self.watch:
            self._start_watchers(asyncio.get_running_loop())
        while not self._stop.is_set():
            self._wake.clear()
            await asyncio.get_running_loop().run_in_executor(
                None, self.reconcile_once
            )
            stop_task = asyncio.ensure_future(self._stop.wait())
            wake_task = asyncio.ensure_future(self._wake.wait())
            try:
                await asyncio.wait(
                    {stop_task, wake_task},
                    timeout=self.interval,
                    return_when=asyncio.FIRST_COMPLETED,
                )
            finally:
                stop_task.cancel()
                wake_task.cancel()

    def stop(self) -> None:
        self._stop.set()


def main(argv: list[str] | None = None) -> None:
    """Operator service entrypoint (the deploy manifests run ``python -m
    serve_torch --device <device> operator``, which lands here; ``python -m
    langstream_tpu_torch.k8s.operator [--device cuda|cpu]`` alone). Env:
    ``LS_ACCELERATOR`` (a port entry, ``h100`` when unset; any other name
    fails here, before the loop starts), ``LS_RECONCILE_INTERVAL`` seconds,
    ``LS_OPERATOR_WATCH`` (``0`` polls only)."""
    import argparse
    import os
    import signal

    from langstream_tpu_torch.k8s.client import HttpKubeApi

    parser = argparse.ArgumentParser(prog="python -m langstream_tpu_torch.k8s.operator")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = parser.parse_args(argv).device
    accelerator = accelerator_from_env()
    logging.basicConfig(level=logging.INFO)
    operator = Operator(
        HttpKubeApi.in_cluster(),
        interval=float(os.environ.get("LS_RECONCILE_INTERVAL", "2.0")),
        accelerator=accelerator,
        watch=os.environ.get("LS_OPERATOR_WATCH", "1") != "0",
        device=device,
    )

    async def _run() -> None:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, operator.stop)
        await operator.run()

    asyncio.run(_run())


if __name__ == "__main__":
    main()
