"""The port's Kubernetes control and data plane (copies of
``langstream_tpu/k8s``), importing nothing of JAX or of ``langstream_tpu``:

- CR models and CRD manifests → :mod:`crds`;
- the manifests for an Agent CR and the setup/deployer Jobs of an
  Application CR, placed on NVIDIA H100 node pools, every pod and Job
  started through the port's pod entrypoint → :mod:`resources`;
- Agent CRs and their config Secrets from an execution plan →
  :mod:`cluster_runtime` (the pod configuration: :mod:`podconfig`);
- the operator's reconcilers → :mod:`operator`;
- the application and tenant stores → :mod:`stores`; the control plane's
  compute runtime for a cluster → :mod:`compute`;
- spec diffing and tenant limits → :mod:`diff`;
- the kube API client (``KubeApi``, ``InMemoryKubeApi``, ``HttpKubeApi``)
  → :mod:`client`, the embedded API server → :mod:`apiserver`, and the
  process kubelet that runs pods as local processes → :mod:`kubelet`.
"""

from langstream_tpu_torch.k8s.client import InMemoryKubeApi, KubeApi
from langstream_tpu_torch.k8s.cluster_runtime import KubernetesClusterRuntime
from langstream_tpu_torch.k8s.crds import AgentCustomResource, ApplicationCustomResource

__all__ = [
    "AgentCustomResource",
    "ApplicationCustomResource",
    "InMemoryKubeApi",
    "KubeApi",
    "KubernetesClusterRuntime",
]
