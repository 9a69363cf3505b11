"""Compute-cluster runtime for Kubernetes (the port's copy of
``langstream_tpu/k8s/cluster_runtime.py``; the Agent CRs name the port's
runtime image unless given another).

Parity: ``KubernetesClusterRuntime``
(``langstream-k8s-runtime/.../k8s/KubernetesClusterRuntime.java:55,93,394``):
``deploy`` converts an :class:`ExecutionPlan` into one Agent CR + one
agent-config Secret per agent node in the tenant namespace
(``langstream-<tenant>``); ``delete`` removes them. The operator
(:mod:`langstream_tpu_torch.k8s.operator`) reconciles the CRs into StatefulSets.
"""

from __future__ import annotations

import base64
import json
from typing import Any

from langstream_tpu_torch.api.execution_plan import ExecutionPlan
from langstream_tpu_torch.k8s.client import KubeApi
from langstream_tpu_torch.k8s.crds import (
    AgentCustomResource,
    AgentResourcesCR,
    AgentSpec,
    DiskSpecCR,
    config_checksum,
)
from langstream_tpu_torch.k8s.podconfig import pod_configuration
from langstream_tpu_torch.k8s.resources import AgentResourcesFactory

DEFAULT_IMAGE = "langstream-tpu/runtime-torch:latest"


def tenant_namespace(tenant: str) -> str:
    return f"langstream-{tenant}"


class KubernetesClusterRuntime:
    def __init__(
        self,
        api: KubeApi,
        image: str = DEFAULT_IMAGE,
        code_storage: dict[str, Any] | None = None,
    ):
        self.api = api
        self.image = image
        # code-storage client config shipped to every pod so the
        # agent-code-download init container can pull the archive
        self.code_storage = code_storage or {}

    def deploy(
        self, tenant: str, plan: ExecutionPlan, code_archive_id: str | None = None
    ) -> list[AgentCustomResource]:
        namespace = tenant_namespace(tenant)
        crs: list[AgentCustomResource] = []
        for node in plan.agents.values():
            config = pod_configuration(plan, node)
            config["tenant"] = tenant
            if code_archive_id:
                config["codeArchiveId"] = code_archive_id
                config["codeStorage"] = {
                    **self.code_storage,
                    "codeArchiveId": code_archive_id,
                }
            checksum = config_checksum(config)
            name = AgentResourcesFactory.agent_resource_name(
                plan.application_id, node.id
            )
            secret_name = f"{name}-config"
            self.api.apply(
                {
                    "apiVersion": "v1",
                    "kind": "Secret",
                    "metadata": {
                        "name": secret_name,
                        "namespace": namespace,
                        "labels": {
                            "langstream-application": plan.application_id,
                            "langstream-agent": node.id,
                        },
                    },
                    "data": {
                        "config": base64.b64encode(
                            json.dumps(config).encode()
                        ).decode()
                    },
                }
            )
            disk = node.resources.disk
            # disaggregated serving pools (docs/DISAGG.md): an agent
            # whose configuration declares `pool-roles` splits into one
            # StatefulSet per role (the manifest factory reads the CR
            # option; pods learn their role via LS_POOL_ROLE)
            node_cfg = getattr(node, "configuration", None) or {}
            pool_roles = node_cfg.get("pool-roles") or node_cfg.get(
                "pool_roles"
            )
            options: dict[str, Any] = {"codeArchiveId": code_archive_id}
            if pool_roles:
                options["poolRoles"] = pool_roles
            cr = AgentCustomResource(
                name=name,
                namespace=namespace,
                spec=AgentSpec(
                    tenant=tenant,
                    application_id=plan.application_id,
                    agent_id=node.id,
                    image=self.image,
                    agent_config_secret_ref=secret_name,
                    agent_config_secret_ref_checksum=checksum,
                    resources=AgentResourcesCR(
                        parallelism=node.resources.parallelism,
                        size=node.resources.size,
                        device_mesh=node.resources.device_mesh,
                    ),
                    disk=(
                        DiskSpecCR(
                            enabled=disk.enabled, size=disk.size, type=disk.type
                        )
                        if disk
                        else None
                    ),
                    options=options,
                ),
            )
            self.api.apply(cr.to_dict())
            crs.append(cr)
        # prune agents dropped from the plan (a redeploy that removes a
        # pipeline step must tear its pods down, not leak them)
        wanted = {cr.name for cr in crs}
        for existing in self.current_agents(tenant, plan.application_id):
            name = existing["metadata"]["name"]
            if name not in wanted:
                self.api.delete("Agent", namespace, name)
                self.api.delete("Secret", namespace, f"{name}-config")
        return crs

    def delete(self, tenant: str, plan: ExecutionPlan) -> None:
        namespace = tenant_namespace(tenant)
        for node in plan.agents.values():
            name = AgentResourcesFactory.agent_resource_name(
                plan.application_id, node.id
            )
            self.api.delete("Agent", namespace, name)
            self.api.delete("Secret", namespace, f"{name}-config")

    def current_agents(self, tenant: str, application_id: str) -> list[dict[str, Any]]:
        return self.api.list(
            "Agent",
            tenant_namespace(tenant),
            label_selector={"langstream-application": application_id},
        )
