"""L1 kernel: the SPIs every other layer codes against.

Mirrors the reference's ``langstream-api`` module (SURVEY.md §2.1): the record
model, the agent contracts (source/processor/sink/service), the topic
contracts, the application model, and the execution plan. Everything here is
pure Python with no JAX dependency so that control-plane code can import it
without touching an accelerator.

The port's copy of ``langstream_tpu/api/__init__.py``; it imports only the port.
"""

from langstream_tpu_torch.api.record import Record, SimpleRecord, MutableRecord
from langstream_tpu_torch.api.agent import (
    AgentCode,
    AgentContext,
    AgentSource,
    AgentProcessor,
    AgentSink,
    AgentService,
    ComponentType,
    RecordSink,
    SourceRecordAndResult,
)
from langstream_tpu_torch.api.topics import (
    TopicConsumer,
    TopicProducer,
    TopicReader,
    TopicAdmin,
    TopicConnectionsRuntime,
    TopicConnectionsRuntimeRegistry,
    TopicOffset,
)
from langstream_tpu_torch.api.application import (
    Application,
    Module,
    Pipeline,
    AgentConfiguration,
    TopicDefinition,
    Gateway,
    Resource,
    Secret,
    Secrets,
    ErrorsSpec,
    ResourcesSpec,
    DiskSpec,
    AssetDefinition,
    ComputeCluster,
    StreamingCluster,
    Instance,
)
from langstream_tpu_torch.api.execution_plan import ExecutionPlan, AgentNode, Connection
from langstream_tpu_torch.api.registry import AgentCodeRegistry, AgentCodeProvider

__all__ = [name for name in dir() if not name.startswith("_")]
