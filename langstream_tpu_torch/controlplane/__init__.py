"""The port's control-plane pieces for the dev-mode ``run``: the
in-process compute runtime and the stored form of an application."""

from langstream_tpu_torch.controlplane.server import LocalComputeRuntime, parse_stored
from langstream_tpu_torch.controlplane.stores import StoredApplication

__all__ = [
    "LocalComputeRuntime",
    "StoredApplication",
    "parse_stored",
]
