"""The application model: what a parsed YAML application is.

Parity: the reference's model records (``langstream-api/.../model/*.java``) —
``Application``, ``Module``, ``Pipeline``, ``AgentConfiguration``,
``TopicDefinition``, ``Gateway`` (types produce/consume/chat/service with
header mappings; ``Gateway.java:54-162``), ``Resource``, ``Secrets``,
``ErrorsSpec`` (``ErrorsSpec.java:28-37``), ``ResourcesSpec``,
``AssetDefinition``, and the instance (streaming + compute cluster + globals).

The port's copy of ``langstream_tpu/api/application.py``; it imports only the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

DEFAULT_MODULE = "default"


@dataclass
class ErrorsSpec:
    """Record-level failure policy: ``on-failure: fail|skip|dead-letter`` and
    ``retries`` (parity: ``ErrorsSpec.java:28-37``)."""

    FAIL = "fail"
    SKIP = "skip"
    DEAD_LETTER = "dead-letter"

    retries: int = 0
    on_failure: str = FAIL

    @classmethod
    def from_dict(cls, data: dict[str, Any] | None) -> "ErrorsSpec | None":
        if data is None:
            return None
        return cls(
            retries=int(data.get("retries", 0)),
            on_failure=data.get("on-failure", cls.FAIL),
        )

    def with_defaults(self, parent: "ErrorsSpec | None") -> "ErrorsSpec":
        base = parent or ErrorsSpec()
        return ErrorsSpec(
            retries=self.retries if self.retries else base.retries,
            on_failure=self.on_failure or base.on_failure,
        )


@dataclass
class DiskSpec:
    """Durable per-replica disk → persistent state directory
    (parity: ``AgentSpec.Disk``, k8s PVC template)."""

    enabled: bool = False
    size: str = "128M"
    type: str = "default"

    @classmethod
    def from_dict(cls, data: dict[str, Any] | None) -> "DiskSpec | None":
        if data is None:
            return None
        return cls(
            enabled=bool(data.get("enabled", True)),
            size=str(data.get("size", "128M")),
            type=data.get("type", "default"),
        )


@dataclass
class ResourcesSpec:
    """Replication spec: ``parallelism`` = replica count (the data-parallel
    fan-out unit, mapped to partition assignment), ``size`` = resource units.
    TPU extension: ``device_mesh`` asks the scheduler for an ICI mesh shape
    per replica (e.g. ``{"tp": 8}``)."""

    parallelism: int = 1
    size: int = 1
    disk: DiskSpec | None = None
    device_mesh: dict[str, int] | None = None

    @classmethod
    def from_dict(cls, data: dict[str, Any] | None) -> "ResourcesSpec":
        if data is None:
            return cls()
        return cls(
            parallelism=int(data.get("parallelism", 1)),
            size=int(data.get("size", 1)),
            disk=DiskSpec.from_dict(data.get("disk")),
            device_mesh=data.get("device-mesh"),
        )


@dataclass
class TopicDefinition:
    CREATE_IF_NOT_EXISTS = "create-if-not-exists"
    NONE = "none"

    name: str
    creation_mode: str = NONE
    deletion_mode: str = NONE
    partitions: int = 1
    implicit: bool = False
    schema: dict[str, Any] | None = None
    options: dict[str, Any] = field(default_factory=dict)
    config: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "TopicDefinition":
        return cls(
            name=data["name"],
            creation_mode=data.get("creation-mode", cls.NONE),
            deletion_mode=data.get("deletion-mode", cls.NONE),
            partitions=int(data.get("partitions", 1)),
            schema=data.get("schema"),
            options=data.get("options") or {},
            config=data.get("config") or {},
        )


@dataclass
class AgentConfiguration:
    """One pipeline step as declared in YAML."""

    id: str
    name: str
    type: str
    input: str | None = None
    output: str | None = None
    configuration: dict[str, Any] = field(default_factory=dict)
    resources: ResourcesSpec = field(default_factory=ResourcesSpec)
    errors: ErrorsSpec | None = None


@dataclass
class Pipeline:
    id: str
    name: str | None = None
    resources: ResourcesSpec = field(default_factory=ResourcesSpec)
    errors: ErrorsSpec | None = None
    agents: list[AgentConfiguration] = field(default_factory=list)


@dataclass
class AssetDefinition:
    """Provisionable external resource (tables, collections, buckets…);
    parity: ``AssetDefinition.java`` + asset managers."""

    id: str
    name: str
    asset_type: str
    creation_mode: str = "none"
    deletion_mode: str = "none"
    config: dict[str, Any] = field(default_factory=dict)
    events_topic: str | None = None


@dataclass
class Module:
    id: str = DEFAULT_MODULE
    pipelines: dict[str, Pipeline] = field(default_factory=dict)
    topics: dict[str, TopicDefinition] = field(default_factory=dict)
    assets: list[AssetDefinition] = field(default_factory=list)


@dataclass
class GatewayHeaderMapping:
    """produce-side header injection / consume-side filter: the value comes
    from a declared client parameter or from the authenticated principal
    (parity: ``Gateway.java:149-162`` value-from-parameters /
    value-from-authentication)."""

    key: str | None = None
    value_from_parameters: str | None = None
    value_from_authentication: str | None = None
    literal_value: Any = None

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "GatewayHeaderMapping":
        return cls(
            key=data.get("key"),
            value_from_parameters=data.get("value-from-parameters"),
            value_from_authentication=data.get("value-from-authentication"),
            literal_value=data.get("value"),
        )


@dataclass
class Gateway:
    PRODUCE = "produce"
    CONSUME = "consume"
    CHAT = "chat"
    SERVICE = "service"

    id: str
    type: str
    topic: str | None = None
    parameters: list[str] = field(default_factory=list)
    authentication: dict[str, Any] | None = None
    produce_headers: list[GatewayHeaderMapping] = field(default_factory=list)
    consume_filters: list[GatewayHeaderMapping] = field(default_factory=list)
    chat_options: dict[str, Any] = field(default_factory=dict)
    service_options: dict[str, Any] = field(default_factory=dict)
    events_topic: str | None = None
    # topic the AI agents write per-chunk stream records to: a produce
    # gateway with a stream-topic can serve incremental frames back to
    # streaming-flagged clients (``option:streaming=true``); absent, the
    # produce path is byte-identical to the pre-streaming gateway
    stream_topic: str | None = None

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "Gateway":
        produce_headers = [
            GatewayHeaderMapping.from_dict(h)
            for h in (data.get("produce-options") or {}).get("headers", [])
        ]
        consume_filters = [
            GatewayHeaderMapping.from_dict(h)
            for h in ((data.get("consume-options") or {}).get("filters") or {}).get(
                "headers", []
            )
        ]
        chat_options = data.get("chat-options") or {}
        # chat headers apply to the produce side of the chat socket
        if chat_options.get("headers"):
            produce_headers.extend(
                GatewayHeaderMapping.from_dict(h) for h in chat_options["headers"]
            )
        return cls(
            id=data["id"],
            type=data["type"],
            topic=data.get("topic"),
            parameters=data.get("parameters") or [],
            authentication=data.get("authentication"),
            produce_headers=produce_headers,
            consume_filters=consume_filters,
            chat_options=chat_options,
            service_options=data.get("service-options") or {},
            events_topic=data.get("events-topic"),
            stream_topic=(
                data.get("stream-topic")
                or (data.get("produce-options") or {}).get("stream-topic")
            ),
        )


@dataclass
class Resource:
    """Shared config block (model providers, datasources…), referenced from
    agent configs by name (parity: ``configuration.yaml`` resources)."""

    id: str
    name: str
    type: str
    configuration: dict[str, Any] = field(default_factory=dict)


@dataclass
class Secret:
    id: str
    name: str
    data: dict[str, Any] = field(default_factory=dict)


@dataclass
class Secrets:
    secrets: dict[str, Secret] = field(default_factory=dict)


@dataclass
class StreamingCluster:
    type: str = "memory"
    configuration: dict[str, Any] = field(default_factory=dict)


@dataclass
class ComputeCluster:
    type: str = "local"
    configuration: dict[str, Any] = field(default_factory=dict)


@dataclass
class Instance:
    streaming_cluster: StreamingCluster = field(default_factory=StreamingCluster)
    compute_cluster: ComputeCluster = field(default_factory=ComputeCluster)
    globals_: dict[str, Any] = field(default_factory=dict)


@dataclass
class Application:
    """A fully parsed application (pre-planning)."""

    modules: dict[str, Module] = field(default_factory=dict)
    gateways: list[Gateway] = field(default_factory=list)
    resources: dict[str, Resource] = field(default_factory=dict)
    dependencies: list[dict[str, Any]] = field(default_factory=list)
    instance: Instance = field(default_factory=Instance)
    secrets: Secrets = field(default_factory=Secrets)
    # where the application package lives on disk (its python/ dir feeds
    # custom agents); None when parsed from an in-memory files map
    directory: str | None = None

    def get_module(self, module_id: str = DEFAULT_MODULE) -> Module:
        if module_id not in self.modules:
            self.modules[module_id] = Module(id=module_id)
        return self.modules[module_id]

    def all_agents(self):
        for module in self.modules.values():
            for pipeline in module.pipelines.values():
                yield from pipeline.agents
