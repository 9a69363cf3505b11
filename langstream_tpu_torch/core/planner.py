"""Planner: Application → ExecutionPlan.

Parity: ``BasicClusterRuntime.buildExecutionPlan`` →
``detectTopics`` / ``detectAssets`` / ``detectAgents``
(``langstream-core/.../common/BasicClusterRuntime.java:50-147``) plus the
agent-fusion optimisation (``ComposableAgentExecutionPlanOptimiser.java:34``,
``BasicClusterRuntime.java:233-249``): consecutive *composable* agents with
equal resource specs and no explicit topic between them are merged into one
composite node, removing a broker round-trip. Stages that are not fused are
joined by implicit topics.

The port's copy of ``langstream_tpu/core/planner.py``. A type no registry
knows plans as a composable processor (:func:`get_metadata`) and fails
when its agent starts, with the registry's ``ValueError``, as in the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from langstream_tpu_torch.api.agent import ComponentType
from langstream_tpu_torch.api.application import (
    AgentConfiguration,
    Application,
    ErrorsSpec,
    Pipeline,
    TopicDefinition,
)
from langstream_tpu_torch.api.execution_plan import AgentNode, Connection, ExecutionPlan


@dataclass
class AgentTypeMetadata:
    component_type: ComponentType
    composable: bool = True


# Planner-side metadata per agent ``type:`` string. The agents package
# extends this on import (parity: the per-agent planner providers under
# ``langstream-k8s-runtime/.../k8s/agents/*.java``).
AGENT_TYPE_METADATA: dict[str, AgentTypeMetadata] = {}


def register_agent_type(
    agent_type: str,
    component_type: ComponentType,
    composable: bool = True,
) -> None:
    AGENT_TYPE_METADATA[agent_type] = AgentTypeMetadata(component_type, composable)


def get_metadata(agent_type: str) -> AgentTypeMetadata:
    # Ensure built-in agents had a chance to register their metadata.
    import langstream_tpu_torch.agents  # noqa: F401

    if agent_type in AGENT_TYPE_METADATA:
        return AGENT_TYPE_METADATA[agent_type]
    # Unknown types (e.g. custom python) default to composable processors.
    return AgentTypeMetadata(ComponentType.PROCESSOR, True)


class PlanningError(ValueError):
    pass


# Per-type configuration validators, run at planning time (parity: the
# reference validates agent configs in the planner-side agent providers,
# langstream-k8s-runtime/.../k8s/agents/*.java, not in the pod). A validator
# raises ValueError; the planner wraps it with the agent/pipeline context.
AGENT_CONFIG_VALIDATORS: dict[str, Callable[[dict], None]] = {}


def register_config_validator(agent_type: str, validator: Callable[[dict], None]):
    AGENT_CONFIG_VALIDATORS[agent_type] = validator


class Planner:
    def __init__(self, application_id: str, application: Application):
        self.application_id = application_id
        self.application = application

    def build(self) -> ExecutionPlan:
        plan = ExecutionPlan(
            application_id=self.application_id, application=self.application
        )
        self._detect_topics(plan)
        self._detect_assets(plan)
        self._detect_agents(plan)
        return plan

    def _detect_topics(self, plan: ExecutionPlan) -> None:
        for module in self.application.modules.values():
            for topic in module.topics.values():
                if topic.name in plan.topics:
                    continue
                plan.topics[topic.name] = topic

    def _detect_assets(self, plan: ExecutionPlan) -> None:
        for module in self.application.modules.values():
            plan.assets.extend(module.assets)

    def _detect_agents(self, plan: ExecutionPlan) -> None:
        for module in self.application.modules.values():
            for pipeline in module.pipelines.values():
                self._plan_pipeline(plan, pipeline)

    def _plan_pipeline(self, plan: ExecutionPlan, pipeline: Pipeline) -> None:
        agents = pipeline.agents
        if not agents:
            return

        for agent in agents:
            validator = AGENT_CONFIG_VALIDATORS.get(agent.type)
            if validator is not None:
                try:
                    validator(agent.configuration)
                except PlanningError:
                    raise
                except Exception as e:
                    # any validator crash IS a planning failure — wrap it so
                    # the user always gets the agent/pipeline context instead
                    # of a bare traceback (e.g. a string where a map belongs
                    # raising AttributeError inside the validator)
                    detail = str(e) if isinstance(e, ValueError) else f"{type(e).__name__}: {e}"
                    raise PlanningError(
                        f"agent {agent.id!r} in pipeline {pipeline.id!r}: {detail}"
                    ) from None

        # 1. group consecutive fusable agents
        groups: list[list[AgentConfiguration]] = []
        for agent in agents:
            if groups and self._can_fuse(groups[-1][-1], agent):
                groups[-1].append(agent)
            else:
                groups.append([agent])

        # 2. wire groups with topics
        previous_output: str | None = None
        for gi, group in enumerate(groups):
            head, tail = group[0], group[-1]
            head_meta = get_metadata(head.type)
            tail_meta = get_metadata(tail.type)

            # input connection
            input_topic = head.input or previous_output
            if input_topic is None and head_meta.component_type != ComponentType.SOURCE \
                    and head_meta.component_type != ComponentType.SERVICE:
                raise PlanningError(
                    f"agent {head.id!r} in pipeline {pipeline.id!r} has no input "
                    f"topic and is not a source"
                )
            if input_topic is not None and input_topic not in plan.topics:
                raise PlanningError(
                    f"agent {head.id!r} references undeclared topic {input_topic!r}"
                )

            # output connection
            is_last = gi == len(groups) - 1
            output_topic = tail.output
            if output_topic is None and not is_last:
                nxt = groups[gi + 1][0]
                if nxt.input is None:
                    # implicit topic between this group and the next
                    output_topic = self._implicit_topic(plan, pipeline, tail)
                    nxt.input = output_topic
            if output_topic is not None and output_topic not in plan.topics:
                raise PlanningError(
                    f"agent {tail.id!r} references undeclared topic {output_topic!r}"
                )

            errors = self._effective_errors(pipeline, head)
            node = AgentNode(
                id=group[0].id,
                agent_type="composite" if len(group) > 1 else head.type,
                component_type=self._composite_component_type(group).value,
                input=(
                    Connection(
                        input_topic,
                        deadletter_enabled=errors.on_failure == ErrorsSpec.DEAD_LETTER,
                    )
                    if input_topic
                    else None
                ),
                output=Connection(output_topic) if output_topic else None,
                agents=list(group),
                resources=head.resources,
                errors=errors,
                configuration=dict(head.configuration) if len(group) == 1 else {},
            )
            if node.id in plan.agents:
                raise PlanningError(f"duplicate agent id {node.id!r}")
            plan.agents[node.id] = node
            previous_output = output_topic
            if tail_meta.component_type == ComponentType.SINK:
                previous_output = None

    def _can_fuse(self, prev: AgentConfiguration, nxt: AgentConfiguration) -> bool:
        if prev.output is not None or nxt.input is not None:
            return False
        prev_meta, nxt_meta = get_metadata(prev.type), get_metadata(nxt.type)
        if not (prev_meta.composable and nxt_meta.composable):
            return False
        # a source may fuse with following processors; processors fuse with
        # processors and a trailing sink (parity: composite agent rules)
        ok_prev = prev_meta.component_type in (
            ComponentType.SOURCE,
            ComponentType.PROCESSOR,
        )
        ok_next = nxt_meta.component_type in (
            ComponentType.PROCESSOR,
            ComponentType.SINK,
        )
        if not (ok_prev and ok_next):
            return False
        # equal scaling requirements only (BasicClusterRuntime.java:233-249)
        if (prev.resources.parallelism, prev.resources.size) != (
            nxt.resources.parallelism,
            nxt.resources.size,
        ):
            return False
        if prev.resources.device_mesh != nxt.resources.device_mesh:
            return False
        # per-agent error policies survive fusion in our runtime, so they do
        # not block it.
        return True

    def _composite_component_type(self, group: list[AgentConfiguration]) -> ComponentType:
        first = get_metadata(group[0].type).component_type
        last = get_metadata(group[-1].type).component_type
        if first == ComponentType.SOURCE:
            return ComponentType.SOURCE
        if last == ComponentType.SINK:
            return ComponentType.SINK
        return first if len(group) == 1 else ComponentType.PROCESSOR

    def _implicit_topic(
        self, plan: ExecutionPlan, pipeline: Pipeline, after: AgentConfiguration
    ) -> str:
        name = f"{self.application_id}-{pipeline.id}-{after.id}-output"
        if name not in plan.topics:
            plan.topics[name] = TopicDefinition(
                name=name,
                creation_mode=TopicDefinition.CREATE_IF_NOT_EXISTS,
                deletion_mode="delete",
                implicit=True,
            )
        return name

    def _effective_errors(
        self, pipeline: Pipeline, agent: AgentConfiguration
    ) -> ErrorsSpec:
        if agent.errors is not None:
            return agent.errors.with_defaults(pipeline.errors)
        return pipeline.errors or ErrorsSpec()


def build_execution_plan(application_id: str, application: Application) -> ExecutionPlan:
    return Planner(application_id, application).build()
