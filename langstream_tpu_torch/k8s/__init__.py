"""The port's Kubernetes manifests (port of ``langstream_tpu/k8s/resources.py``'s
agent factory): the same StatefulSets, headless Service and PDBs for an
Agent CR, with the port's pods placed on NVIDIA H100 node pools and started
through the port's pod entrypoint (see :mod:`langstream_tpu_torch.k8s.resources`).
The platform's operator reaches it through ``serve_torch.register``."""
