"""Kubernetes-backed application + tenant stores (the port's copy of
``langstream_tpu/k8s/stores.py``; the CRs, Secrets and ConfigMaps are the
JAX store's, so an application stored by either package reads back in the
other). As the port's file-system store does, it refuses a tenant or
application name that is not one plain path segment
(:func:`~langstream_tpu_torch.controlplane.stores.validate_name`).

Parity: ``langstream-k8s-storage`` — ``KubernetesApplicationStore`` (app
definitions as Application CRs + Secrets in per-tenant namespaces
``langstream-<tenant>``; ``KubernetesApplicationStore.java:67,138,201``) and
``KubernetesGlobalMetadataStore`` (tenants as ConfigMaps). Implements the
same :class:`ApplicationStore` ABC the control plane already uses for its
in-memory and filesystem stores, so the webservice swaps stores by config.
"""

from __future__ import annotations

import base64
import json
from typing import Any

from langstream_tpu_torch.controlplane.stores import (
    ApplicationStore,
    StoredApplication,
    validate_filenames,
    validate_name,
)
from langstream_tpu_torch.k8s.client import KubeApi
from langstream_tpu_torch.k8s.cluster_runtime import tenant_namespace
from langstream_tpu_torch.k8s.crds import (
    ApplicationCustomResource,
    ApplicationSpec,
)

GLOBAL_NAMESPACE = "langstream-system"
TENANT_CM_PREFIX = "langstream-tenant-"


class KubernetesApplicationStore(ApplicationStore):
    def __init__(self, api: KubeApi, runtime_image: str = "",
                 code_storage_config: dict | None = None):
        self.api = api
        self.runtime_image = runtime_image
        # flows into ApplicationSpec.options so the operator's setup/
        # deployer Jobs know where archives live (AppController reads
        # options.codeStorage into the job config document)
        self.code_storage_config = code_storage_config

    # ---- tenants (GlobalMetadataStore role) ------------------------------

    def put_tenant(self, tenant: str, config: dict[str, Any] | None = None) -> None:
        validate_name("tenant", tenant)
        self.api.apply(
            {
                "apiVersion": "v1",
                "kind": "Namespace",
                "metadata": {
                    "name": tenant_namespace(tenant),
                    "labels": {"app": "langstream-tpu", "langstream-tenant": tenant},
                },
            }
        )
        self.api.apply(
            {
                "apiVersion": "v1",
                "kind": "ConfigMap",
                "metadata": {
                    "name": f"{TENANT_CM_PREFIX}{tenant}",
                    "namespace": GLOBAL_NAMESPACE,
                    "labels": {"app": "langstream-tpu-tenant"},
                },
                "data": {"tenant": json.dumps(config or {})},
            }
        )

    def delete_tenant(self, tenant: str) -> None:
        self.api.delete(
            "ConfigMap", GLOBAL_NAMESPACE, f"{TENANT_CM_PREFIX}{tenant}"
        )
        self.api.delete("Namespace", None, tenant_namespace(tenant))

    def list_tenants(self) -> dict[str, dict[str, Any]]:
        out: dict[str, dict[str, Any]] = {}
        for cm in self.api.list(
            "ConfigMap", GLOBAL_NAMESPACE,
            label_selector={"app": "langstream-tpu-tenant"},
        ):
            name = cm["metadata"]["name"]
            if name.startswith(TENANT_CM_PREFIX):
                out[name[len(TENANT_CM_PREFIX):]] = json.loads(
                    (cm.get("data") or {}).get("tenant", "{}")
                )
        return out

    # ---- applications ----------------------------------------------------

    def put_application(self, app: StoredApplication) -> None:
        validate_name("tenant", app.tenant)
        validate_name("application", app.name)
        validate_filenames(app.files)
        namespace = tenant_namespace(app.tenant)
        serialized = json.dumps(
            {
                "files": app.files,
                "instance": app.instance,
                "created_at": app.created_at,
                "units": app.units,
            }
        )
        cr = ApplicationCustomResource(
            name=app.name,
            namespace=namespace,
            spec=ApplicationSpec(
                tenant=app.tenant,
                image=self.runtime_image,
                application=serialized,
                code_archive_id=app.code_archive_id,
                options=(
                    {"codeStorage": self.code_storage_config}
                    if self.code_storage_config else {}
                ),
            ),
            status={"status": app.status, "error": app.error},
        )
        self.api.apply(cr.to_dict())
        self.api.update_status(cr.to_dict())
        # secrets live in a Secret next to the CR, never inside it
        # (parity: KubernetesApplicationStore.java:201)
        self.api.apply(
            {
                "apiVersion": "v1",
                "kind": "Secret",
                "metadata": {
                    "name": f"{app.name}-secrets",
                    "namespace": namespace,
                    "labels": {"langstream-application": app.name},
                },
                "data": {
                    "secrets": base64.b64encode(
                        (app.secrets or "").encode()
                    ).decode()
                },
            }
        )

    def get_application(self, tenant: str, name: str) -> StoredApplication | None:
        namespace = tenant_namespace(tenant)
        cr_dict = self.api.get("Application", namespace, name)
        if cr_dict is None:
            return None
        cr = ApplicationCustomResource.from_dict(cr_dict)
        payload = json.loads(cr.spec.application or "{}")
        secret = self.api.get("Secret", namespace, f"{name}-secrets")
        secrets = None
        if secret is not None:
            raw = (secret.get("data") or {}).get("secrets", "")
            secrets = base64.b64decode(raw).decode() if raw else None
        return StoredApplication(
            tenant=tenant,
            name=name,
            files=payload.get("files") or {},
            instance=payload.get("instance"),
            secrets=secrets or None,
            status=(cr.status or {}).get("status", "CREATED"),
            error=(cr.status or {}).get("error"),
            created_at=payload.get("created_at", 0),
            units=int(payload.get("units", 0)),
        )

    def delete_application(self, tenant: str, name: str) -> None:
        namespace = tenant_namespace(tenant)
        self.api.delete("Application", namespace, name)
        self.api.delete("Secret", namespace, f"{name}-secrets")

    def list_applications(self, tenant: str) -> list[str]:
        return sorted(
            cr["metadata"]["name"]
            for cr in self.api.list("Application", tenant_namespace(tenant))
        )
