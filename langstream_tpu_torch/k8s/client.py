"""Kubernetes API access: a thin typed-by-kind client facade (the port's
copy of ``langstream_tpu/k8s/client.py``; it speaks to either package's API
server, and either package's client to the port's).

Parity: ``langstream-k8s-common`` (shared fabric8 client factory +
``KubeTestServer`` mock). Everything above (deployer, operator, stores) codes
against :class:`KubeApi`; tests and the dev-mode runner use
:class:`InMemoryKubeApi` (the ``KubeTestServer`` role), real clusters use
:class:`HttpKubeApi` — stdlib-only (urllib + in-cluster service-account
auth), since no kubernetes client library is baked into the image.
"""

from __future__ import annotations

import json
import ssl
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Callable

# kind → (api prefix, plural, namespaced)
KIND_ROUTES: dict[str, tuple[str, str, bool]] = {
    "Application": ("/apis/langstream.tpu/v1alpha1", "applications", True),
    "Agent": ("/apis/langstream.tpu/v1alpha1", "agents", True),
    "Secret": ("/api/v1", "secrets", True),
    "ConfigMap": ("/api/v1", "configmaps", True),
    "Service": ("/api/v1", "services", True),
    "Pod": ("/api/v1", "pods", True),
    "PersistentVolumeClaim": ("/api/v1", "persistentvolumeclaims", True),
    "Namespace": ("/api/v1", "namespaces", False),
    "StatefulSet": ("/apis/apps/v1", "statefulsets", True),
    "Job": ("/apis/batch/v1", "jobs", True),
    "PodDisruptionBudget": ("/apis/policy/v1", "poddisruptionbudgets", True),
    "CustomResourceDefinition": (
        "/apis/apiextensions.k8s.io/v1",
        "customresourcedefinitions",
        False,
    ),
}


class KubeConflictError(RuntimeError):
    """409 from the API server: optimistic-concurrency loss (stale
    resourceVersion) or create of an existing object."""


class KubeNotFoundError(RuntimeError):
    """404 on a write: the target (or its namespace) does not exist."""


class KubeApi:
    """Minimal CRUD surface the control/data-plane layers need."""

    def get(self, kind: str, namespace: str | None, name: str) -> dict | None:
        raise NotImplementedError

    def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: dict[str, str] | None = None,
    ) -> list[dict]:
        raise NotImplementedError

    def apply(self, obj: dict) -> dict:
        """Create-or-replace by (kind, namespace, name)."""
        raise NotImplementedError

    def delete(self, kind: str, namespace: str | None, name: str) -> bool:
        raise NotImplementedError

    def update_status(self, obj: dict) -> dict:
        raise NotImplementedError

    # convenience
    def exists(self, kind: str, namespace: str | None, name: str) -> bool:
        return self.get(kind, namespace, name) is not None


def _match_labels(obj: dict, selector: dict[str, str] | None) -> bool:
    if not selector:
        return True
    labels = (obj.get("metadata") or {}).get("labels") or {}
    return all(labels.get(k) == v for k, v in selector.items())


class InMemoryKubeApi(KubeApi):
    """The fake API server used by tests and `docker run` dev mode.

    Keeps every applied object; records mutations in ``events`` so tests can
    assert on CR writes the way the reference's ``KubeTestServer`` spies do.
    Optional ``on_apply`` hooks let tests simulate controller behavior
    (e.g. marking StatefulSets ready).
    """

    def __init__(self) -> None:
        self.objects: dict[tuple[str, str | None, str], dict] = {}
        self.events: list[tuple[str, str, str | None, str]] = []  # op, kind, ns, name
        self.on_apply: list[Callable[[dict], None]] = []

    def _key(self, kind: str, namespace: str | None, name: str):
        if kind not in KIND_ROUTES:
            raise ValueError(f"unknown kind {kind!r}")
        namespaced = KIND_ROUTES[kind][2]
        return (kind, namespace if namespaced else None, name)

    def get(self, kind: str, namespace: str | None, name: str) -> dict | None:
        obj = self.objects.get(self._key(kind, namespace, name))
        return json.loads(json.dumps(obj)) if obj is not None else None

    def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: dict[str, str] | None = None,
    ) -> list[dict]:
        out = []
        for (k, ns, _), obj in self.objects.items():
            if k != kind:
                continue
            if namespace is not None and ns != namespace:
                continue
            if _match_labels(obj, label_selector):
                out.append(json.loads(json.dumps(obj)))
        return out

    def apply(self, obj: dict) -> dict:
        kind = obj["kind"]
        meta = obj.get("metadata") or {}
        key = self._key(kind, meta.get("namespace"), meta["name"])
        existing = self.objects.get(key)
        if existing is not None and "status" not in obj and "status" in existing:
            obj = {**obj, "status": existing["status"]}
        obj = json.loads(json.dumps(obj))
        # stable uid across updates (owner references point at it)
        if existing is not None and existing.get("metadata", {}).get("uid"):
            obj.setdefault("metadata", {})["uid"] = existing["metadata"]["uid"]
        else:
            import uuid

            obj.setdefault("metadata", {}).setdefault("uid", str(uuid.uuid4()))
        self.objects[key] = obj
        self.events.append(
            ("apply", kind, meta.get("namespace"), meta["name"])
        )
        for hook in self.on_apply:
            hook(self.objects[key])
        return self.get(kind, meta.get("namespace"), meta["name"])

    def delete(self, kind: str, namespace: str | None, name: str) -> bool:
        key = self._key(kind, namespace, name)
        removed = self.objects.pop(key, None)
        if removed is None:
            return False
        self.events.append(("delete", kind, namespace, name))
        # garbage-collect dependents (what the real API server's GC
        # controller does for ownerReferences; dev mode matches clusters)
        uid = (removed.get("metadata") or {}).get("uid")
        if uid:
            doomed = [
                (k, ns, n)
                for (k, ns, n), o in list(self.objects.items())
                if any(
                    ref.get("uid") == uid
                    for ref in (o.get("metadata") or {}).get(
                        "ownerReferences", []
                    )
                )
            ]
            for k, ns, n in doomed:
                self.delete(k, ns, n)
        return True

    def update_status(self, obj: dict) -> dict:
        kind = obj["kind"]
        meta = obj.get("metadata") or {}
        key = self._key(kind, meta.get("namespace"), meta["name"])
        if key not in self.objects:
            raise KeyError(f"{kind}/{meta['name']} not found")
        self.objects[key]["status"] = json.loads(json.dumps(obj.get("status") or {}))
        self.events.append(("status", kind, meta.get("namespace"), meta["name"]))
        return self.get(kind, meta.get("namespace"), meta["name"])

    # test helpers (KubeTestServer.spyAgentCustomResources role)
    def applied(self, kind: str) -> list[str]:
        return [n for op, k, _, n in self.events if op == "apply" and k == kind]


class HttpKubeApi(KubeApi):
    """Real API server over stdlib HTTP.

    In-cluster: reads the service-account token + CA from the standard
    mount; out-of-cluster: pass ``base_url``/``token``/``ca_file`` directly.
    """

    SA_DIR = Path("/var/run/secrets/kubernetes.io/serviceaccount")

    def __init__(
        self,
        base_url: str,
        token: str | None = None,
        ca_file: str | None = None,
        insecure: bool = False,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        if insecure:
            self.ssl_context = ssl._create_unverified_context()
        elif ca_file:
            self.ssl_context = ssl.create_default_context(cafile=ca_file)
        else:
            self.ssl_context = ssl.create_default_context()

    @classmethod
    def in_cluster(cls) -> "HttpKubeApi":
        import os

        # mini-cluster lane: process-pods (k8s/kubelet.py) are plain OS
        # processes, not containers — the kubelet hands them the API
        # server address directly instead of a service-account mount
        override = os.environ.get("LS_KUBE_API_URL")
        if override:
            return cls(override, token=os.environ.get("LS_KUBE_API_TOKEN"))
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        token = (cls.SA_DIR / "token").read_text().strip()
        return cls(
            f"https://{host}:{port}",
            token=token,
            ca_file=str(cls.SA_DIR / "ca.crt"),
        )

    def _url(self, kind: str, namespace: str | None, name: str | None = None) -> str:
        prefix, plural, namespaced = KIND_ROUTES[kind]
        parts = [self.base_url, prefix.lstrip("/")]
        if namespaced and namespace:
            parts += ["namespaces", namespace]
        parts.append(plural)
        if name:
            parts.append(name)
        return "/".join(parts)

    def _request(
        self, method: str, url: str, body: dict | None = None
    ) -> dict | None:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            context = self.ssl_context if url.startswith("https") else None
            with urllib.request.urlopen(req, context=context) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else None
        except urllib.error.HTTPError as e:
            if e.code == 404 and method in ("GET", "DELETE"):
                # object absence is an answer for reads/deletes; for a
                # create/update a 404 is a real failure (e.g. the target
                # namespace does not exist) and must not vanish into None
                return None
            detail = e.read()[:500]
            if e.code == 404:
                raise KubeNotFoundError(
                    f"kube api {method} {url}: 404 {detail!r}"
                ) from e
            if e.code == 409:
                raise KubeConflictError(
                    f"kube api {method} {url}: 409 {detail!r}"
                ) from e
            raise RuntimeError(
                f"kube api {method} {url} failed: {e.code} {detail!r}"
            ) from e

    def get(self, kind: str, namespace: str | None, name: str) -> dict | None:
        return self._request("GET", self._url(kind, namespace, name))

    def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: dict[str, str] | None = None,
    ) -> list[dict]:
        url = self._url(kind, namespace)
        if label_selector:
            sel = ",".join(f"{k}={v}" for k, v in label_selector.items())
            url += f"?labelSelector={urllib.request.quote(sel)}"
        result = self._request("GET", url) or {}
        return result.get("items", [])

    RETRIES = 5

    def apply(self, obj: dict) -> dict:
        """Create-or-replace with optimistic-concurrency retries: a 409
        (another writer bumped resourceVersion between our GET and PUT, or
        created the object before our POST) re-reads and retries — the
        level-triggered reconcilers re-derive the full desired state, so
        last-writer-wins on the spec is the correct outcome."""
        kind = obj["kind"]
        meta = obj["metadata"]
        namespace, name = meta.get("namespace"), meta["name"]
        for _ in range(self.RETRIES):
            existing = self.get(kind, namespace, name)
            if existing is None:
                try:
                    return self._request("POST", self._url(kind, namespace), obj)
                except KubeConflictError:
                    continue  # created concurrently: retry as an update
                # a POST 404 (missing namespace) is permanent — let the
                # KubeNotFoundError propagate, retrying cannot fix it
            try:
                # deep-copy before injecting resourceVersion: the caller's
                # manifest must stay reusable (a stale resourceVersion
                # poisons later applies)
                candidate = json.loads(json.dumps(obj))
                candidate.setdefault("metadata", {})["resourceVersion"] = (
                    existing["metadata"]["resourceVersion"]
                )
                return self._request(
                    "PUT", self._url(kind, namespace, name), candidate
                )
            except KubeNotFoundError:
                continue  # deleted underneath us: retry as a create
            except KubeConflictError:
                continue
        raise KubeConflictError(
            f"apply of {kind}/{name} kept conflicting after "
            f"{self.RETRIES} attempts"
        )

    def delete(self, kind: str, namespace: str | None, name: str) -> bool:
        return (
            self._request("DELETE", self._url(kind, namespace, name)) is not None
        )

    def update_status(self, obj: dict) -> dict:
        kind = obj["kind"]
        meta = obj["metadata"]
        url = self._url(kind, meta.get("namespace"), meta["name"]) + "/status"
        for _ in range(self.RETRIES):
            current = self.get(kind, meta.get("namespace"), meta["name"])
            if current is None:
                raise KeyError(f"{kind}/{meta['name']} not found")
            merged = {**current, "status": obj.get("status") or {}}
            try:
                return self._request("PUT", url, merged)
            except KubeNotFoundError:
                raise KeyError(f"{kind}/{meta['name']} not found") from None
            except KubeConflictError:
                continue
        raise KubeConflictError(
            f"status update of {kind}/{meta['name']} kept conflicting "
            f"after {self.RETRIES} attempts"
        )

    def watch(
        self,
        kind: str,
        namespace: str | None = None,
        resource_version: str | None = None,
        timeout_s: float = 30.0,
    ):
        """Yield ``(event_type, object)`` from a server watch stream
        (ADDED/MODIFIED/DELETED) until the server closes it — the
        level-triggered poll loop's wake-up signal, not a state store."""
        url = self._url(kind, namespace)
        params = {"watch": "true", "timeoutSeconds": str(int(timeout_s))}
        if resource_version is not None:
            params["resourceVersion"] = str(resource_version)
        url += "?" + "&".join(f"{k}={v}" for k, v in params.items())
        req = urllib.request.Request(url, method="GET")
        req.add_header("Accept", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        context = self.ssl_context if url.startswith("https") else None
        with urllib.request.urlopen(
            req, context=context, timeout=timeout_s + 10
        ) as resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                yield event.get("type"), event.get("object")
