"""Mermaid pipeline diagrams from an execution plan (the port's copy of
``langstream_tpu/core/diagram.py``).

Parity: the CLI's diagram generator
(``langstream-cli/.../applications/MermaidAppDiagramGenerator.java``) — a
flowchart of topics (cylinders), agents (boxes, fused chains annotated),
and gateways (stadium shapes).
"""

from __future__ import annotations

from langstream_tpu_torch.api.execution_plan import ExecutionPlan


def _safe(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def mermaid_diagram(plan: ExecutionPlan) -> str:
    lines = ["flowchart LR"]
    for topic in plan.topics.values():
        label = topic.name + (" (implicit)" if topic.implicit else "")
        lines.append(f'  T_{_safe(topic.name)}[("{label}")]')
    for node in plan.agents.values():
        if node.is_composite:
            chain = " → ".join(a.type for a in node.agents)
            label = f"{node.id}<br/><i>{chain}</i>"
        else:
            label = f"{node.id}<br/><i>{node.agent_type}</i>"
        lines.append(f'  A_{_safe(node.id)}["{label}"]')
        if node.input is not None:
            lines.append(f"  T_{_safe(node.input.topic)} --> A_{_safe(node.id)}")
            if node.input.deadletter_enabled:
                dl = node.input.topic + "-deadletter"
                lines.append(f'  T_{_safe(dl)}[("{dl}")]')
                lines.append(f"  A_{_safe(node.id)} -.-> T_{_safe(dl)}")
        if node.output is not None:
            lines.append(f"  A_{_safe(node.id)} --> T_{_safe(node.output.topic)}")
    for gateway in plan.application.gateways:
        gid = _safe(gateway.id)
        lines.append(f'  G_{gid}(["gateway: {gateway.id} ({gateway.type})"])')
        if gateway.type in ("produce", "chat"):
            topic = gateway.topic or gateway.chat_options.get("questions-topic")
            if topic:
                lines.append(f"  G_{gid} --> T_{_safe(topic)}")
        if gateway.type in ("consume", "chat"):
            topic = gateway.topic or gateway.chat_options.get("answers-topic")
            if topic:
                lines.append(f"  T_{_safe(topic)} --> G_{gid}")
    return "\n".join(lines)
