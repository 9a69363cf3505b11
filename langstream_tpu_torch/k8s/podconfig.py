"""Runtime pod configuration: what an agent pod needs to boot one replica
(the port's copy of ``langstream_tpu/k8s/podconfig.py``, over the port's
application model; the document is the JAX package's).

Parity: ``RuntimePodConfiguration(input, output, agent, streamingCluster)``
(``langstream-runtime-api/.../agent/RuntimePodConfiguration.java:21``) — the
deployer serializes this per agent into the agent-config Secret; the pod
entrypoint (:mod:`langstream_tpu_torch.runtime.pod`) deserializes it and rebuilds
the minimal plan/node pair the :class:`AgentRunner` runs on.
"""

from __future__ import annotations

from typing import Any

from langstream_tpu_torch.api.application import (
    AgentConfiguration,
    Application,
    ErrorsSpec,
    Instance,
    Resource,
    ResourcesSpec,
    StreamingCluster,
)
from langstream_tpu_torch.api.execution_plan import AgentNode, Connection, ExecutionPlan


def pod_configuration(plan: ExecutionPlan, node: AgentNode) -> dict[str, Any]:
    """Serialize one agent node + its application context for a pod."""
    app = plan.application
    return {
        "applicationId": plan.application_id,
        "input": (
            {
                "topic": node.input.topic,
                "deadletter": node.input.deadletter_enabled,
            }
            if node.input
            else None
        ),
        "output": {"topic": node.output.topic} if node.output else None,
        "agent": {
            "id": node.id,
            "type": node.agent_type,
            "componentType": node.component_type,
            "configuration": node.configuration,
            "agents": [
                {
                    "id": a.id,
                    "name": a.name,
                    "type": a.type,
                    "configuration": a.configuration,
                }
                for a in node.agents
            ],
            "errors": {
                "retries": node.errors.retries,
                "on-failure": node.errors.on_failure,
            },
            "resources": {
                "parallelism": node.resources.parallelism,
                "size": node.resources.size,
                "device-mesh": node.resources.device_mesh,
            },
        },
        "streamingCluster": {
            "type": app.instance.streaming_cluster.type,
            "configuration": app.instance.streaming_cluster.configuration,
        },
        # ambient context agents resolve at init time
        "resources": {
            rid: {"type": r.type, "name": r.name, "configuration": r.configuration}
            for rid, r in app.resources.items()
        },
        "globals": app.instance.globals_,
    }


def plan_and_node(config: dict[str, Any]) -> tuple[ExecutionPlan, AgentNode]:
    """Rebuild the (plan, node) pair a pod's AgentRunner needs."""
    agent = config["agent"]
    node = AgentNode(
        id=agent["id"],
        agent_type=agent["type"],
        component_type=agent.get("componentType", "PROCESSOR"),
        input=(
            Connection(
                topic=config["input"]["topic"],
                deadletter_enabled=bool(config["input"].get("deadletter")),
            )
            if config.get("input")
            else None
        ),
        output=(
            Connection(topic=config["output"]["topic"])
            if config.get("output")
            else None
        ),
        agents=[
            AgentConfiguration(
                id=a["id"],
                name=a.get("name", a["id"]),
                type=a["type"],
                configuration=a.get("configuration") or {},
            )
            for a in agent.get("agents", [])
        ],
        resources=ResourcesSpec.from_dict(agent.get("resources")),
        errors=ErrorsSpec.from_dict(agent.get("errors")) or ErrorsSpec(),
        configuration=agent.get("configuration") or {},
    )
    streaming = config.get("streamingCluster") or {}
    app = Application(
        instance=Instance(
            streaming_cluster=StreamingCluster(
                type=streaming.get("type", "memory"),
                configuration=streaming.get("configuration") or {},
            ),
            globals_=config.get("globals") or {},
        ),
        resources={
            rid: Resource(
                id=rid,
                name=r.get("name", rid),
                type=r.get("type", ""),
                configuration=r.get("configuration") or {},
            )
            for rid, r in (config.get("resources") or {}).items()
        },
    )
    plan = ExecutionPlan(
        application_id=config.get("applicationId", "app"),
        application=app,
        agents={node.id: node},
    )
    return plan, node
