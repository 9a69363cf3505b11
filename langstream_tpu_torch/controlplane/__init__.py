"""L6 control plane: multi-tenant REST API over application stores (the
port's copy of ``langstream_tpu/controlplane``).

Parity: ``langstream-webservice`` (Spring REST control plane —
``ApplicationResource.java:79``: deploy/update/delete/get/logs;
``TenantResource.java:45``) with the k8s stores
(``KubernetesApplicationStore``) replaced by pluggable in-memory /
filesystem stores, and the deployer Jobs replaced by an in-process compute
runtime in dev mode.
"""

from langstream_tpu_torch.controlplane.server import (
    ControlPlaneServer,
    LocalComputeRuntime,
    parse_stored,
)
from langstream_tpu_torch.controlplane.stores import (
    ApplicationStore,
    FileSystemApplicationStore,
    InMemoryApplicationStore,
    StoredApplication,
)

__all__ = [
    "ControlPlaneServer",
    "LocalComputeRuntime",
    "parse_stored",
    "ApplicationStore",
    "InMemoryApplicationStore",
    "FileSystemApplicationStore",
    "StoredApplication",
]
