"""The port's runtime: the streaming transports, the agent runner, the
dev-mode application runner and the pod entrypoint (copies of
``langstream_tpu/runtime``).

Importing this package registers the streaming runtimes with
:class:`~langstream_tpu_torch.api.topics.TopicConnectionsRuntimeRegistry`,
as the JAX package's ``runtime/__init__.py`` does:

- ``memory``: the in-process partitioned broker;
- ``tpustream``: the native C++ broker (``langstream_tpu_torch/native/tsbroker.cc``);
- ``kafka``: always; the selector picks the backend from the ``client``
  key (``wire``, ``sdk``, or ``auto``: ``confluent_kafka`` when it imports,
  else the wire client written in the repository);
- ``pulsar`` and ``pravega``: when their client libraries import. Asked for
  without them, the registry refuses them naming the library.
"""

from langstream_tpu_torch.api.topics import TopicConnectionsRuntimeRegistry
from langstream_tpu_torch.runtime.memory_broker import MemoryTopicConnectionsRuntime

TopicConnectionsRuntimeRegistry.register("memory", MemoryTopicConnectionsRuntime)

# ``tpustream``: the native C++ broker (langstream_tpu_torch/native/tsbroker.cc);
# the module registers itself
from langstream_tpu_torch.runtime.tsb import TsbTopicConnectionsRuntime  # noqa: E402

# ``type: kafka`` always registers: the selector picks the backend per the
# ``client`` config key (wire|sdk|auto)
from langstream_tpu_torch.runtime.kafka_wire_runtime import (  # noqa: E402
    KafkaTopicConnectionsRuntimeSelector,
)

TopicConnectionsRuntimeRegistry.register("kafka", KafkaTopicConnectionsRuntimeSelector)

try:
    import pulsar  # noqa: F401

    from langstream_tpu_torch.runtime.pulsar_broker import PulsarTopicConnectionsRuntime

    TopicConnectionsRuntimeRegistry.register("pulsar", PulsarTopicConnectionsRuntime)
except ImportError:
    pass

try:
    import pravega_client  # noqa: F401

    from langstream_tpu_torch.runtime.pravega_broker import PravegaTopicConnectionsRuntime

    TopicConnectionsRuntimeRegistry.register("pravega", PravegaTopicConnectionsRuntime)
except ImportError:
    pass

from langstream_tpu_torch.runtime.runner import AgentRunner  # noqa: E402
from langstream_tpu_torch.runtime.local_runner import LocalApplicationRunner  # noqa: E402

__all__ = [
    "AgentRunner",
    "KafkaTopicConnectionsRuntimeSelector",
    "LocalApplicationRunner",
    "MemoryTopicConnectionsRuntime",
    "TsbTopicConnectionsRuntime",
]
