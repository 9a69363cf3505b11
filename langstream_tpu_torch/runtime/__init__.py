"""The port's runtime: the in-memory broker, the tpustream client, the agent
runner, the dev-mode application runner and the pod entrypoint (copies of
``langstream_tpu/runtime``).

Importing this package registers the ``memory`` and ``tpustream``
streaming runtimes with
:class:`~langstream_tpu_torch.api.topics.TopicConnectionsRuntimeRegistry`.
The JAX package's other transports (Kafka, Pulsar, Pravega) are not ported
yet and are refused by name.
"""

from langstream_tpu_torch.api.topics import TopicConnectionsRuntimeRegistry
from langstream_tpu_torch.runtime.memory_broker import MemoryTopicConnectionsRuntime

TopicConnectionsRuntimeRegistry.register("memory", MemoryTopicConnectionsRuntime)

# ``tpustream``: the native C++ broker (langstream_tpu_torch/native/tsbroker.cc);
# the module registers itself
from langstream_tpu_torch.runtime.tsb import TsbTopicConnectionsRuntime  # noqa: E402

from langstream_tpu_torch.runtime.runner import AgentRunner  # noqa: E402
from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner  # noqa: E402

__all__ = [
    "AgentRunner",
    "LocalApplicationRunner",
    "MemoryTopicConnectionsRuntime",
    "TsbTopicConnectionsRuntime",
]
