"""The model-service SPI the platform's AI agents call (the port's copy of
the interfaces in ``langstream_tpu/agents/services.py``; that module loads
JAX, so the port keeps its own).

The agents read only the fields of :class:`Chunk` and
:class:`CompletionResult` and make no ``isinstance`` check on them, so the
port's dataclasses carry across by their fields.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Chunk:
    """One streamed completion fragment."""

    text: str
    index: int
    last: bool = False


@dataclass
class CompletionResult:
    text: str
    num_prompt_tokens: int = 0
    num_completion_tokens: int = 0
    finish_reason: str = "stop"
    # engine-side TTFT decomposition (seconds)
    ttft_s: float = 0.0
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0


StreamingChunksConsumer = Callable[[Chunk], Any]


class CompletionsService(abc.ABC):
    @abc.abstractmethod
    async def chat_completions(
        self,
        messages: list[dict[str, str]],
        options: dict[str, Any],
        consumer: StreamingChunksConsumer | None = None,
    ) -> CompletionResult: ...

    @abc.abstractmethod
    async def text_completions(
        self,
        prompt: str,
        options: dict[str, Any],
        consumer: StreamingChunksConsumer | None = None,
    ) -> CompletionResult: ...


class EmbeddingsService(abc.ABC):
    @abc.abstractmethod
    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]: ...


class ServiceProvider(abc.ABC):
    @abc.abstractmethod
    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService: ...

    @abc.abstractmethod
    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService: ...

    async def close(self) -> None:
        pass
