"""The port's runtime: the in-memory broker, the agent runner and the
dev-mode application runner (copies of ``langstream_tpu/runtime``), and the
pod's slice seam (:mod:`langstream_tpu_torch.runtime.pod`).

Importing this package registers the ``memory`` streaming runtime with
:class:`~langstream_tpu_torch.api.topics.TopicConnectionsRuntimeRegistry`.
The JAX package's other transports (Kafka, Pulsar, Pravega, the native
``tpustream`` broker) are not ported yet and are refused by name.
"""

from langstream_tpu_torch.api.topics import TopicConnectionsRuntimeRegistry
from langstream_tpu_torch.runtime.memory_broker import MemoryTopicConnectionsRuntime

TopicConnectionsRuntimeRegistry.register("memory", MemoryTopicConnectionsRuntime)

from langstream_tpu_torch.runtime.runner import AgentRunner  # noqa: E402
from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner  # noqa: E402

__all__ = [
    "AgentRunner",
    "LocalApplicationRunner",
    "MemoryTopicConnectionsRuntime",
]
