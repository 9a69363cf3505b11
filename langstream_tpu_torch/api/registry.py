"""Agent code registry: maps YAML ``type:`` strings to implementations.

Parity: ``AgentCodeRegistry`` + the ``AgentCodeProvider`` SPI discovered from
NAR files in the reference (``langstream-core/.../nar/NarFileHandler.java``).
Python needs no classloader isolation, so providers are plain modules that
register factories; the built-in agent library self-registers on import of
``langstream_tpu_torch.agents``.

The port's copy of ``langstream_tpu/api/registry.py``; it imports only the port.
"""

from __future__ import annotations

from typing import Callable

from langstream_tpu_torch.api.agent import AgentCode

AgentFactory = Callable[[], AgentCode]


class AgentCodeProvider:
    """A provider contributes factories for a set of agent type strings."""

    def __init__(self, factories: dict[str, AgentFactory]):
        self.factories = factories

    def supports(self, agent_type: str) -> bool:
        return agent_type in self.factories

    def create(self, agent_type: str) -> AgentCode:
        return self.factories[agent_type]()


class AgentCodeRegistry:
    _providers: list[AgentCodeProvider] = []

    @classmethod
    def register_provider(cls, provider: AgentCodeProvider) -> None:
        cls._providers.append(provider)

    @classmethod
    def register(cls, agent_type: str, factory: AgentFactory) -> None:
        cls.register_provider(AgentCodeProvider({agent_type: factory}))

    @classmethod
    def get_agent_code(cls, agent_type: str) -> AgentCode:
        cls._ensure_builtins()
        for provider in reversed(cls._providers):
            if provider.supports(agent_type):
                agent = provider.create(agent_type)
                agent.agent_type = agent_type
                return agent
        raise ValueError(
            f"no agent implementation for type {agent_type!r}; known: "
            f"{sorted(cls.known_types())}"
        )

    @classmethod
    def known_types(cls) -> set[str]:
        cls._ensure_builtins()
        types: set[str] = set()
        for provider in cls._providers:
            types.update(provider.factories)
        return types

    @classmethod
    def _ensure_builtins(cls) -> None:
        import langstream_tpu_torch.agents  # noqa: F401  (self-registers)

    # test helper
    @classmethod
    def _reset_for_tests(cls, providers: list[AgentCodeProvider]) -> None:
        cls._providers = providers

