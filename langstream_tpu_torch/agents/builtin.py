"""Registration of every agent type (the port's copy of
``langstream_tpu/agents/builtin.py``: its 46 types), with the JAX package's
component types (``_METADATA``) so the planner fuses sources, sinks and
services as the JAX planner does, and the JAX package's planning-time
config validator (``camel-source``). Importing the store modules registers
their asset managers
(:class:`~langstream_tpu_torch.agents.assets.AssetManagerRegistry`); the
Cassandra ones register when :mod:`.cassandra_cql` is first imported, as in
the JAX package. The four ``grpc-*`` types load the sidecar lane
(:mod:`langstream_tpu_torch.grpc`) only when an application uses one.

A type no registry knows plans as a composable processor and fails when
its agent starts, with the registry's ``ValueError``, as in the JAX
package.
"""

from __future__ import annotations

from langstream_tpu_torch.api.agent import ComponentType
from langstream_tpu_torch.api.registry import AgentCodeProvider, AgentCodeRegistry
from langstream_tpu_torch.core.planner import register_agent_type, register_config_validator

from langstream_tpu_torch.agents import ai, connect, flow, python_custom, text, transform, vector
from langstream_tpu_torch.agents import camel, http, storage, webcrawler
from langstream_tpu_torch.agents import jdbc, opensearch  # noqa: F401  (asset managers)
from langstream_tpu_torch.agents import astra, milvus, solr  # noqa: F401  (asset managers)

SOURCE = ComponentType.SOURCE
PROCESSOR = ComponentType.PROCESSOR
SINK = ComponentType.SINK
SERVICE = ComponentType.SERVICE

_FACTORIES = {
    # GenAI transform steps
    "cast": transform.CastStep,
    "compute": transform.ComputeStep,
    "drop": transform.DropStep,
    "drop-fields": transform.DropFieldsStep,
    "flatten": transform.FlattenStep,
    "merge-key-value": transform.MergeKeyValueStep,
    "unwrap-key-value": transform.UnwrapKeyValueStep,
    # AI
    "ai-chat-completions": ai.ChatCompletionsAgent,
    "ai-text-completions": ai.TextCompletionsAgent,
    "compute-ai-embeddings": ai.ComputeAIEmbeddingsAgent,
    "query": ai.QueryAgent,
    "re-rank": ai.ReRankAgent,
    "flare-controller": ai.FlareControllerAgent,
    # text processing
    "text-extractor": text.TextExtractorAgent,
    "text-splitter": text.TextSplitterAgent,
    "text-normaliser": text.TextNormaliserAgent,
    "language-detector": text.LanguageDetectorAgent,
    "document-to-json": text.DocumentToJsonAgent,
    # flow control
    "dispatch": flow.DispatchAgent,
    "timer-source": flow.TimerSource,
    "trigger-event": flow.TriggerEventProcessor,
    "log-event": flow.LogEventProcessor,
    # vector stores
    "vector-db-sink": vector.VectorDBSinkAgent,
    "query-vector-db": vector.QueryVectorDBAgent,
    # http
    "http-request": http.HttpRequestAgent,
    "langserve-invoke": http.LangServeInvokeAgent,
    # sources
    "camel-source": camel.CamelSource,
    "webcrawler": webcrawler.WebCrawlerSource,
    "local-storage-source": storage.LocalStorageSource,
    "s3-source": storage.make_s3_source,
    "azure-blob-storage-source": storage.make_azure_source,
    # Kafka-Connect-style bridge (reference: KafkaConnectCodeProvider.java:26)
    "sink": connect.ConnectSinkBridge,
    "source": connect.ConnectSourceBridge,
    # custom python (in-process; no gRPC hop needed — see python_custom.py)
    "python-processor": python_custom.PythonProcessorAgent,
    "python-function": python_custom.PythonProcessorAgent,
    "experimental-python-processor": python_custom.PythonProcessorAgent,
    "python-source": python_custom.PythonSourceAgent,
    "experimental-python-source": python_custom.PythonSourceAgent,
    "python-sink": python_custom.PythonSinkAgent,
    "experimental-python-sink": python_custom.PythonSinkAgent,
    "python-service": python_custom.PythonServiceAgent,
    "experimental-python-service": python_custom.PythonServiceAgent,
}


# out-of-process python/any-language agents over the sidecar gRPC protocol
# (parity: the reference's default python-* execution; here opt-in, since
# in-process is the zero-overhead default). Lazy imports: the gRPC lane
# loads only when an application actually uses these types.
def _grpc_processor():
    from langstream_tpu_torch.grpc.client import GrpcAgentProcessor

    return GrpcAgentProcessor()


def _grpc_source():
    from langstream_tpu_torch.grpc.client import GrpcAgentSource

    return GrpcAgentSource()


def _grpc_sink():
    from langstream_tpu_torch.grpc.client import GrpcAgentSink

    return GrpcAgentSink()


_FACTORIES.update(
    {
        "grpc-python-processor": _grpc_processor,
        "grpc-agent": _grpc_processor,  # external endpoint, any language
        "grpc-python-source": _grpc_source,
        "grpc-python-sink": _grpc_sink,
    }
)

#: component type and composability of the types that are not composable
#: processors (the JAX ``_METADATA``)
_METADATA = {
    "timer-source": (SOURCE, True),
    "camel-source": (SOURCE, True),
    "webcrawler": (SOURCE, True),
    "local-storage-source": (SOURCE, True),
    "s3-source": (SOURCE, True),
    "azure-blob-storage-source": (SOURCE, True),
    "python-source": (SOURCE, True),
    "experimental-python-source": (SOURCE, True),
    "vector-db-sink": (SINK, True),
    "python-sink": (SINK, True),
    "experimental-python-sink": (SINK, True),
    "python-service": (SERVICE, False),
    "experimental-python-service": (SERVICE, False),
    "grpc-python-source": (SOURCE, True),
    "grpc-python-sink": (SINK, True),
    "source": (SOURCE, True),
    "sink": (SINK, True),
}

AgentCodeRegistry.register_provider(AgentCodeProvider(dict(_FACTORIES)))

for name in _FACTORIES:
    component_type, composable = _METADATA.get(name, (PROCESSOR, True))
    register_agent_type(name, component_type, composable)

# planning-time config validation (unsupported camel schemes fail in the
# planner with the descope rationale, not at pod start)
register_config_validator("camel-source", camel.validate_camel_config)
