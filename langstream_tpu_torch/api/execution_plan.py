"""The execution plan: the planner's output, the deployer's input.

Parity: ``ExecutionPlan`` (``langstream-api/.../runtime/ExecutionPlan.java:32``)
— maps of logical topics, assets, and agent nodes; each agent node knows its
input/output connection, its runtime configuration, and its replication spec.

The port's copy of ``langstream_tpu/api/execution_plan.py``; it imports only the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from langstream_tpu_torch.api.application import (
    AgentConfiguration,
    Application,
    AssetDefinition,
    ErrorsSpec,
    ResourcesSpec,
    TopicDefinition,
)


@dataclass
class Connection:
    """An agent's input or output endpoint: today always a topic (the
    planner inserts implicit topics between non-fused stages; fused stages
    connect in-memory inside one composite node)."""

    topic: str
    deadletter_enabled: bool = False


@dataclass
class AgentNode:
    """One deployable unit: a (possibly composite/fused) agent.

    ``agents`` holds the chain of underlying agent configurations — length 1
    for a plain agent, >1 after fusion (parity: the reference's composite
    agent produced by ``ComposableAgentExecutionPlanOptimiser``).
    """

    id: str
    agent_type: str
    component_type: str
    input: Connection | None = None
    output: Connection | None = None
    agents: list[AgentConfiguration] = field(default_factory=list)
    resources: ResourcesSpec = field(default_factory=ResourcesSpec)
    errors: ErrorsSpec = field(default_factory=ErrorsSpec)
    configuration: dict[str, Any] = field(default_factory=dict)

    @property
    def is_composite(self) -> bool:
        return len(self.agents) > 1


@dataclass
class ExecutionPlan:
    application_id: str
    application: Application
    topics: dict[str, TopicDefinition] = field(default_factory=dict)
    assets: list[AssetDefinition] = field(default_factory=list)
    agents: dict[str, AgentNode] = field(default_factory=dict)

    def logical_topics(self) -> list[TopicDefinition]:
        return list(self.topics.values())

    def get_agent(self, agent_id: str) -> AgentNode:
        return self.agents[agent_id]
