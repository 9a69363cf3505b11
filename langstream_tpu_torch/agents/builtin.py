"""Registration of every agent type the port carries (the port's copy of
``langstream_tpu/agents/builtin.py``, for the types ported so far).

The planner refuses any other type by name
(:mod:`langstream_tpu_torch.core.planner`), so an application that needs
one of the JAX package's other agents fails when it is planned, never at
run time.
"""

from __future__ import annotations

from langstream_tpu_torch.api.agent import ComponentType
from langstream_tpu_torch.api.registry import AgentCodeProvider, AgentCodeRegistry
from langstream_tpu_torch.core.planner import register_agent_type

from langstream_tpu_torch.agents import ai, text

PROCESSOR = ComponentType.PROCESSOR

_FACTORIES = {
    # AI
    "ai-chat-completions": ai.ChatCompletionsAgent,
    "ai-text-completions": ai.TextCompletionsAgent,
    "compute-ai-embeddings": ai.ComputeAIEmbeddingsAgent,
    # text processing
    "text-splitter": text.TextSplitterAgent,
    "language-detector": text.LanguageDetectorAgent,
    "document-to-json": text.DocumentToJsonAgent,
}

AgentCodeRegistry.register_provider(AgentCodeProvider(dict(_FACTORIES)))

for name in _FACTORIES:
    register_agent_type(name, PROCESSOR, True)
