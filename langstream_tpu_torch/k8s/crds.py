"""Custom-resource models + CRD manifests (the port's copy of
``langstream_tpu/k8s/crds.py``: the same CRs on the wire).

Parity: ``langstream-k8s-deployer-api`` CR POJOs —
``ApplicationCustomResource``/``ApplicationSpec`` (serialized app +
codeArchiveId) and ``AgentCustomResource``/``AgentSpec``
(``.../crds/agents/AgentSpec.java:33-57``: agentId, applicationId,
``agentConfigSecretRef`` + checksum, resources{parallelism, size}, disks).

CRs are plain dicts on the wire (what the API server stores); the dataclasses
here are the typed view both the deployer and the operator share.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any

GROUP = "langstream.tpu"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"


@dataclass
class ApplicationSpec:
    tenant: str
    image: str = ""
    application: str = ""  # serialized application (JSON)
    code_archive_id: str | None = None
    options: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "tenant": self.tenant,
            "image": self.image,
            "application": self.application,
            "codeArchiveId": self.code_archive_id,
            "options": self.options,
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "ApplicationSpec":
        return cls(
            tenant=data.get("tenant", ""),
            image=data.get("image", ""),
            application=data.get("application", ""),
            code_archive_id=data.get("codeArchiveId"),
            options=data.get("options") or {},
        )


@dataclass
class DiskSpecCR:
    enabled: bool = False
    size: str = "128M"
    type: str = "default"

    def to_dict(self) -> dict[str, Any]:
        return {"enabled": self.enabled, "size": self.size, "type": self.type}


@dataclass
class AgentResourcesCR:
    parallelism: int = 1
    size: int = 1
    # the device mesh one logical replica needs (cards = product of the
    # axis sizes); absent → an agent pod without a card.
    device_mesh: dict[str, int] | None = None

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"parallelism": self.parallelism, "size": self.size}
        if self.device_mesh:
            out["deviceMesh"] = self.device_mesh
        return out

    @classmethod
    def from_dict(cls, data: dict[str, Any] | None) -> "AgentResourcesCR":
        data = data or {}
        return cls(
            parallelism=int(data.get("parallelism", 1)),
            size=int(data.get("size", 1)),
            device_mesh=data.get("deviceMesh"),
        )


@dataclass
class AgentSpec:
    tenant: str
    application_id: str
    agent_id: str
    image: str = ""
    agent_config_secret_ref: str = ""
    agent_config_secret_ref_checksum: str = ""
    resources: AgentResourcesCR = field(default_factory=AgentResourcesCR)
    disk: DiskSpecCR | None = None
    options: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        out = {
            "tenant": self.tenant,
            "applicationId": self.application_id,
            "agentId": self.agent_id,
            "image": self.image,
            "agentConfigSecretRef": self.agent_config_secret_ref,
            "agentConfigSecretRefChecksum": self.agent_config_secret_ref_checksum,
            "resources": self.resources.to_dict(),
            "options": self.options,
        }
        if self.disk is not None:
            out["disk"] = self.disk.to_dict()
        return out

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "AgentSpec":
        disk = data.get("disk")
        return cls(
            tenant=data.get("tenant", ""),
            application_id=data.get("applicationId", ""),
            agent_id=data.get("agentId", ""),
            image=data.get("image", ""),
            agent_config_secret_ref=data.get("agentConfigSecretRef", ""),
            agent_config_secret_ref_checksum=data.get(
                "agentConfigSecretRefChecksum", ""
            ),
            resources=AgentResourcesCR.from_dict(data.get("resources")),
            disk=DiskSpecCR(**disk) if disk else None,
            options=data.get("options") or {},
        )


def _meta(name: str, namespace: str, labels: dict[str, str] | None = None) -> dict:
    meta: dict[str, Any] = {"name": name, "namespace": namespace}
    if labels:
        meta["labels"] = labels
    return meta


@dataclass
class ApplicationCustomResource:
    name: str
    namespace: str
    spec: ApplicationSpec
    status: dict[str, Any] = field(default_factory=dict)

    PLURAL = "applications"
    KIND = "Application"

    def to_dict(self) -> dict[str, Any]:
        return {
            "apiVersion": API_VERSION,
            "kind": self.KIND,
            "metadata": _meta(self.name, self.namespace),
            "spec": self.spec.to_dict(),
            "status": self.status,
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "ApplicationCustomResource":
        return cls(
            name=data["metadata"]["name"],
            namespace=data["metadata"].get("namespace", "default"),
            spec=ApplicationSpec.from_dict(data.get("spec") or {}),
            status=data.get("status") or {},
        )


@dataclass
class AgentCustomResource:
    name: str
    namespace: str
    spec: AgentSpec
    status: dict[str, Any] = field(default_factory=dict)

    PLURAL = "agents"
    KIND = "Agent"

    def to_dict(self) -> dict[str, Any]:
        return {
            "apiVersion": API_VERSION,
            "kind": self.KIND,
            "metadata": _meta(
                self.name,
                self.namespace,
                labels={
                    "app": "langstream-tpu-runtime",
                    "langstream-application": self.spec.application_id,
                    "langstream-agent": self.spec.agent_id,
                },
            ),
            "spec": self.spec.to_dict(),
            "status": self.status,
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "AgentCustomResource":
        return cls(
            name=data["metadata"]["name"],
            namespace=data["metadata"].get("namespace", "default"),
            spec=AgentSpec.from_dict(data.get("spec") or {}),
            status=data.get("status") or {},
        )


def config_checksum(config: dict[str, Any]) -> str:
    """Checksum of an agent's pod configuration; a changed checksum is what
    forces the operator to roll the StatefulSet (parity: the reference's
    ``agentConfigSecretRefChecksum``)."""
    canon = json.dumps(config, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def crd_manifests() -> list[dict[str, Any]]:
    """CRD definitions (parity: ``helm/crds/*.yml``)."""

    def crd(kind: str, plural: str, short: str) -> dict[str, Any]:
        return {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "CustomResourceDefinition",
            "metadata": {"name": f"{plural}.{GROUP}"},
            "spec": {
                "group": GROUP,
                "names": {
                    "kind": kind,
                    "plural": plural,
                    "singular": kind.lower(),
                    "shortNames": [short],
                },
                "scope": "Namespaced",
                "versions": [
                    {
                        "name": VERSION,
                        "served": True,
                        "storage": True,
                        "subresources": {"status": {}},
                        "schema": {
                            "openAPIV3Schema": {
                                "type": "object",
                                "properties": {
                                    "spec": {
                                        "type": "object",
                                        "x-kubernetes-preserve-unknown-fields": True,
                                    },
                                    "status": {
                                        "type": "object",
                                        "x-kubernetes-preserve-unknown-fields": True,
                                    },
                                },
                            }
                        },
                    }
                ],
            },
        }

    return [
        crd(ApplicationCustomResource.KIND, ApplicationCustomResource.PLURAL, "lsapp"),
        crd(AgentCustomResource.KIND, AgentCustomResource.PLURAL, "lsagent"),
    ]
