"""ProcessKubelet: run StatefulSet and Job pods as local OS processes (the
port's copy of ``langstream_tpu/k8s/kubelet.py``).

The mini-cluster lane (parity: ``mini-langstream``'s minikube — the
reference stands its whole control plane up in a local cluster and runs
REAL pods; no container runtime exists in this image, so pods here are
subprocesses). Combined with the in-memory/HTTP kube API server, the
operator, the control plane in k8s mode, and the native tsbroker, this
executes the ENTIRE production deploy path — Application CR → setup Job →
deployer Job → Agent CRs → StatefulSets → running agent processes — with
the same manifests and the same pod entrypoint
(``python -m serve_torch --device <device> pod``, the port's
:mod:`langstream_tpu_torch.runtime.pod`) the real cluster runs.

kubelet-isms implemented:
- volumes: ``secret`` (keys materialized as files), ``emptyDir``,
  ``persistentVolumeClaim``/``volumeClaimTemplates`` (a per-claim dir under
  the state root — data survives pod restarts, like a PVC);
- mountPaths: pods are processes, so absolute container paths
  (``/app-config``) are rewritten to per-pod dirs in the command argv;
- env: literal values and the ``fieldRef: metadata.name`` downward API;
- initContainers run to completion before the main container starts;
- Jobs: run once, then the Job's ``status.succeeded/failed`` is patched so
  the operator's two-phase deploy advances;
- StatefulSet scale-up/down/update: pods are (re)started when the template
  changes (hash-tracked) and killed on scale-down/delete; readyReplicas is
  patched back into status so Agent CR statuses progress to DEPLOYED.

The port adds one kubelet-ism the JAX kubelet lacks: in a cluster every
pod owns its :8080, but processes on one host share one port space, so
with the JAX kubelet only the first pod's info server binds and every later
pod serves no probe, metric or profile route. Here each StatefulSet pod
gets a free port of its own in ``LS_HTTP_PORT`` (kept across its restarts
and written to ``<pod dir>/http-port``), and
:meth:`ProcessKubelet.pod_address` answers the pod's base URL, the address
the control plane's pod fan-in
(:class:`~langstream_tpu_torch.k8s.compute.KubernetesComputeRuntime`'s
``pod_address``) reaches it at instead of the cluster DNS name.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from langstream_tpu_torch.k8s.client import KubeApi

log = logging.getLogger("langstream_tpu_torch.kubelet")


@dataclass
class _Pod:
    name: str
    namespace: str
    kind: str               # "StatefulSet" | "Job"
    owner: str              # owning object name
    template_hash: str
    proc: subprocess.Popen | None = None
    root: Path | None = None
    log_path: Path | None = None
    init_ok: bool = True
    failed: bool = False
    reported: bool = False  # job completion already patched
    env: dict[str, str] = field(default_factory=dict)


def _hash_template(template: dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(template, sort_keys=True).encode()
    ).hexdigest()[:16]


class ProcessKubelet:
    """Reconciles StatefulSets + Jobs from a KubeApi into subprocesses."""

    def __init__(
        self,
        api: KubeApi,
        root: Path | str,
        env_extra: dict[str, str] | None = None,
        python: str | None = None,
    ):
        self.api = api
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        # handed to every pod: LS_KUBE_API_URL (so in_cluster() reaches the
        # mini API server), the repository on PYTHONPATH, ...
        self.env_extra = dict(env_extra or {})
        self.http_ports: dict[tuple[str, str], int] = {}  # (ns, pod) -> port
        self.python = python or sys.executable
        self.pods: dict[tuple[str, str], _Pod] = {}  # (ns, pod name)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- pod mechanics -----------------------------------------------------

    def _materialize_volumes(
        self, pod: _Pod, pod_spec: dict[str, Any], sts_claims: list[dict]
    ) -> dict[str, Path]:
        """volume name → host dir. Secret keys become files; PVCs map to
        stable per-claim dirs so state survives restarts."""
        mounts: dict[str, Path] = {}
        for vol in pod_spec.get("volumes", []):
            name = vol["name"]
            if "secret" in vol:
                target = pod.root / "volumes" / name
                target.mkdir(parents=True, exist_ok=True)
                secret = self.api.get(
                    "Secret", pod.namespace, vol["secret"]["secretName"]
                )
                if secret is None:
                    raise FileNotFoundError(
                        f"secret {vol['secret']['secretName']} not found "
                        f"for pod {pod.name}"
                    )
                for key, b64 in (secret.get("data") or {}).items():
                    (target / key).write_bytes(base64.b64decode(b64))
                mounts[name] = target
            elif "emptyDir" in vol:
                target = pod.root / "volumes" / name
                target.mkdir(parents=True, exist_ok=True)
                mounts[name] = target
            elif "persistentVolumeClaim" in vol:
                claim = vol["persistentVolumeClaim"]["claimName"]
                target = self.root / "pvc" / pod.namespace / claim
                target.mkdir(parents=True, exist_ok=True)
                mounts[name] = target
            else:  # configMap etc. — none emitted by our factories yet
                target = pod.root / "volumes" / name
                target.mkdir(parents=True, exist_ok=True)
                mounts[name] = target
        for claim in sts_claims:
            # volumeClaimTemplates: claim name <template>-<pod>
            name = claim["metadata"]["name"]
            target = self.root / "pvc" / pod.namespace / f"{name}-{pod.name}"
            target.mkdir(parents=True, exist_ok=True)
            mounts[name] = target
        return mounts

    def _container_cmd(
        self, container: dict[str, Any], mounts: dict[str, Path]
    ) -> list[str]:
        """Rewrite absolute container mount paths in argv to host dirs, and
        run the image's python entrypoint with THIS interpreter."""
        path_map = {
            vm["mountPath"]: str(mounts[vm["name"]])
            for vm in container.get("volumeMounts", [])
            if vm["name"] in mounts
        }
        cmd = []
        for arg in container.get("command", []) + container.get("args", []):
            for cpath, hpath in path_map.items():
                if arg == cpath or arg.startswith(cpath + "/"):
                    arg = hpath + arg[len(cpath):]
                    break
            cmd.append(arg)
        if cmd and cmd[0] == "python":
            cmd[0] = self.python
        return cmd

    def _container_env(
        self, pod: _Pod, container: dict[str, Any]
    ) -> dict[str, str]:
        env = dict(os.environ)
        env.update(self.env_extra)
        for e in container.get("env", []):
            if "value" in e:
                env[e["name"]] = str(e["value"])
            elif (
                e.get("valueFrom", {})
                .get("fieldRef", {})
                .get("fieldPath")
                == "metadata.name"
            ):
                env[e["name"]] = pod.name
        if pod.kind == "StatefulSet":
            key = (pod.namespace, pod.name)
            if key not in self.http_ports:
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    self.http_ports[key] = sock.getsockname()[1]
                (pod.root / "http-port").write_text(str(self.http_ports[key]))
            env["LS_HTTP_PORT"] = str(self.http_ports[key])
        return env

    def pod_address(self, namespace: str, pod: str) -> str | None:
        """The base URL of a StatefulSet pod's info server, None for a pod
        this kubelet has not started."""
        port = self.http_ports.get((namespace, pod))
        return f"http://127.0.0.1:{port}" if port is not None else None

    def _start_pod(
        self,
        pod: _Pod,
        template: dict[str, Any],
        sts_claims: list[dict] | None = None,
    ) -> None:
        pod.root = self.root / "pods" / pod.namespace / pod.name
        pod.root.mkdir(parents=True, exist_ok=True)
        pod.log_path = pod.root / "pod.log"
        pod_spec = template["spec"]
        try:
            mounts = self._materialize_volumes(
                pod, pod_spec, sts_claims or []
            )
        except FileNotFoundError as e:
            log.warning("pod %s: %s (will retry)", pod.name, e)
            pod.failed = True
            return
        log_f = open(pod.log_path, "ab")
        for init in pod_spec.get("initContainers", []):
            cmd = self._container_cmd(init, mounts)
            rc = subprocess.call(
                cmd, env=self._container_env(pod, init),
                stdout=log_f, stderr=subprocess.STDOUT,
            )
            if rc != 0:
                log.warning(
                    "pod %s init container %s failed rc=%d (log: %s)",
                    pod.name, init.get("name"), rc, pod.log_path,
                )
                pod.failed = True
                log_f.close()
                return
        containers = pod_spec.get("containers", [])
        main = containers[0]
        cmd = self._container_cmd(main, mounts)
        pod.env = self._container_env(pod, main)
        pod.proc = subprocess.Popen(
            cmd, env=pod.env, stdout=log_f, stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        log_f.close()
        log.info("pod %s/%s started (pid %d): %s",
                 pod.namespace, pod.name, pod.proc.pid, " ".join(cmd[-3:]))

    def _kill_pod(self, pod: _Pod) -> None:
        if pod.proc is not None and pod.proc.poll() is None:
            try:
                os.killpg(pod.proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pod.proc.terminate()
            try:
                pod.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(pod.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pod.proc.kill()
                pod.proc.wait()
        pod.proc = None

    # -- reconcile ---------------------------------------------------------

    def _namespaces(self) -> list[str]:
        return [
            ns["metadata"]["name"] for ns in self.api.list("Namespace", None)
        ]

    def reconcile_once(self) -> None:
        desired: set[tuple[str, str]] = set()
        for ns in self._namespaces():
            for sts in self.api.list("StatefulSet", ns):
                desired |= self._sync_statefulset(ns, sts)
            for job in self.api.list("Job", ns):
                desired |= self._sync_job(ns, job)
        # pods whose owner is gone
        for key, pod in list(self.pods.items()):
            if key not in desired:
                log.info("pod %s/%s: owner gone, stopping", *key)
                self._kill_pod(pod)
                del self.pods[key]

    def _sync_statefulset(
        self, ns: str, sts: dict[str, Any]
    ) -> set[tuple[str, str]]:
        name = sts["metadata"]["name"]
        replicas = int(sts["spec"].get("replicas", 1))
        template = sts["spec"]["template"]
        claims = sts["spec"].get("volumeClaimTemplates", [])
        thash = _hash_template(template)
        keys: set[tuple[str, str]] = set()
        ready = 0
        for i in range(replicas):
            pod_name = f"{name}-{i}"
            key = (ns, pod_name)
            keys.add(key)
            pod = self.pods.get(key)
            if pod is not None and pod.template_hash != thash:
                self._kill_pod(pod)
                pod = None
            if pod is not None and pod.failed:
                # secret not yet present / init failure: retry from scratch
                self._kill_pod(pod)
                pod = None
            if pod is None:
                pod = _Pod(
                    name=pod_name, namespace=ns, kind="StatefulSet",
                    owner=name, template_hash=thash,
                )
                self.pods[key] = pod
                self._start_pod(pod, template, claims)
            elif pod.proc is not None and pod.proc.poll() is not None:
                log.warning(
                    "pod %s/%s exited rc=%s; restarting",
                    ns, pod_name, pod.proc.returncode,
                )
                self._start_pod(pod, template, claims)
            if pod.proc is not None and pod.proc.poll() is None:
                ready += 1
        status = sts.get("status") or {}
        if (
            status.get("readyReplicas") != ready
            or status.get("replicas") != replicas
        ):
            sts["status"] = {"readyReplicas": ready, "replicas": replicas}
            try:
                self.api.update_status(sts)
            except Exception as e:
                log.debug("sts status update conflict (next pass re-reads): %s", e)
        return keys

    def _sync_job(self, ns: str, job: dict[str, Any]) -> set[tuple[str, str]]:
        name = job["metadata"]["name"]
        key = (ns, name)
        status = job.get("status") or {}
        if status.get("succeeded") or status.get("failed"):
            return {key} if key in self.pods else set()
        template = job["spec"]["template"]
        thash = _hash_template(template)
        pod = self.pods.get(key)
        if pod is None:
            pod = _Pod(
                name=name, namespace=ns, kind="Job", owner=name,
                template_hash=thash,
            )
            self.pods[key] = pod
            self._start_pod(pod, template)
            if pod.failed:
                # config secret may land a moment after the Job: retry next
                # pass rather than marking the Job failed
                del self.pods[key]
                return set()
        if pod.proc is not None and pod.proc.poll() is not None and not pod.reported:
            rc = pod.proc.returncode
            job["status"] = (
                {"succeeded": 1} if rc == 0 else {"failed": 1}
            )
            if rc != 0:
                log.warning(
                    "job %s/%s failed rc=%d (log: %s)",
                    ns, name, rc, pod.log_path,
                )
            try:
                self.api.update_status(job)
                pod.reported = True
            except Exception as e:
                log.debug("job status update conflict (next pass retries): %s", e)
        return {key}

    # -- lifecycle ---------------------------------------------------------

    def start(self, interval: float = 0.5) -> "ProcessKubelet":
        def _run() -> None:
            while not self._stop.is_set():
                try:
                    self.reconcile_once()
                except Exception:
                    log.exception("kubelet reconcile pass failed")
                self._stop.wait(interval)

        self._thread = threading.Thread(
            target=_run, name="process-kubelet", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(15)
        for pod in self.pods.values():
            self._kill_pod(pod)
        self.pods.clear()
