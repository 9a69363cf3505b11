"""The port's agents: the model-service SPI and provider registry
(:mod:`~langstream_tpu_torch.agents.services`), the provider that serves
through the port's engines (:mod:`~langstream_tpu_torch.agents.provider`),
and the agent types ported so far.

Importing this package registers those types with
:class:`~langstream_tpu_torch.api.registry.AgentCodeRegistry` and their
planner metadata (:mod:`~langstream_tpu_torch.agents.builtin`).
"""

from langstream_tpu_torch.agents import builtin  # noqa: F401  (registers the ported types)
