"""The model-service SPI the AI agents call, and the registry that picks a
provider from an application's resources (the port's copy of
``langstream_tpu/agents/services.py``).

The agents read only the fields of :class:`Chunk` and
:class:`CompletionResult` and make no ``isinstance`` check on them, so the
port's dataclasses carry across by their fields.

``tpu-serving-configuration`` resolves to the port's
:class:`~langstream_tpu_torch.agents.provider.TorchServiceProvider` on
:data:`SERVING_DEVICE` (the card unless a caller, such as ``run
--device cpu``, sets it with :func:`set_serving_device`);
``mock-serving-configuration`` to the deterministic mock;
``open-ai-configuration`` and ``ollama-configuration`` to the OpenAI-compatible
HTTP provider (:mod:`langstream_tpu_torch.agents.http_providers`).
"""

from __future__ import annotations

import abc
import asyncio
from dataclasses import dataclass, field
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


# ---------------------------------------------------------------------------
# provider resolution from application resources
# ---------------------------------------------------------------------------

# resource ``type:`` -> provider factory name. Mirrors the reference's
# resource types so existing configuration.yaml files keep working.
_PROVIDER_RESOURCE_TYPES = [
    "tpu-serving-configuration",
    "mock-serving-configuration",
    "open-ai-configuration",
    "hugging-face-configuration",
    "ollama-configuration",
    "vertex-configuration",
    "bedrock-configuration",
]

_provider_factories: dict[str, Callable[[dict[str, Any]], ServiceProvider]] = {}

#: the device ``tpu-serving-configuration`` resources serve on
SERVING_DEVICE = "cuda"


def set_serving_device(device: str) -> None:
    """Serve every ``tpu-serving-configuration`` resolved from now on on
    ``device`` (``"cuda"`` or ``"cpu"``)."""
    global SERVING_DEVICE
    SERVING_DEVICE = device


def register_provider(
    resource_type: str, factory: Callable[[dict[str, Any]], ServiceProvider]
) -> None:
    _provider_factories[resource_type] = factory


def resolve_service_provider(resources: dict[str, dict[str, Any]]) -> ServiceProvider:
    """Pick the provider from the application's shared resources (parity:
    the GenAI toolkit scans configured resources for a supported type)."""
    for rtype in _PROVIDER_RESOURCE_TYPES:
        for resource in resources.values():
            if resource.get("type") == rtype and rtype in _provider_factories:
                return _provider_factories[rtype](resource)
    # No explicit provider: default to the serving engine when configured
    # globally, else the deterministic mock (tests, dry runs).
    if "tpu-serving-configuration" in _provider_factories:
        for resource in resources.values():
            if resource.get("type") == "tpu-serving-configuration":
                return _provider_factories["tpu-serving-configuration"](resource)
    return MockServiceProvider({})


# ---------------------------------------------------------------------------
# mock provider (deterministic; the WireMock analogue for tests)
# ---------------------------------------------------------------------------


class MockCompletionsService(CompletionsService):
    def __init__(self, config: dict[str, Any]):
        self.config = config
        self.reply = config.get("reply")
        self.chunk_delay = float(config.get("chunk-delay", 0))

    def _answer(self, prompt: str) -> str:
        if self.reply is not None:
            return str(self.reply)
        return f"mock-answer:{prompt[-40:]}"

    async def _stream(
        self, text: str, consumer: StreamingChunksConsumer | None
    ) -> None:
        if consumer is None:
            return
        words = text.split(" ")
        for i, w in enumerate(words):
            chunk = Chunk(
                text=w if i == 0 else " " + w, index=i, last=i == len(words) - 1
            )
            result = consumer(chunk)
            if asyncio.iscoroutine(result):
                await result
            if self.chunk_delay:
                await asyncio.sleep(self.chunk_delay)

    async def chat_completions(
        self,
        messages: list[dict[str, str]],
        options: dict[str, Any],
        consumer: StreamingChunksConsumer | None = None,
    ) -> CompletionResult:
        prompt = " ".join(m.get("content", "") for m in messages)
        text = self._answer(prompt)
        await self._stream(text, consumer)
        return CompletionResult(
            text=text,
            num_prompt_tokens=len(prompt.split()),
            num_completion_tokens=len(text.split()),
        )

    async def text_completions(
        self,
        prompt: str,
        options: dict[str, Any],
        consumer: StreamingChunksConsumer | None = None,
    ) -> CompletionResult:
        text = self._answer(prompt)
        await self._stream(text, consumer)
        return CompletionResult(
            text=text,
            num_prompt_tokens=len(prompt.split()),
            num_completion_tokens=len(text.split()),
        )


class MockEmbeddingsService(EmbeddingsService):
    """Deterministic hash-bucket embeddings: equal texts -> equal vectors."""

    def __init__(self, config: dict[str, Any]):
        self.dimensions = int(config.get("dimensions", 8))

    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]:
        out = []
        for text in texts:
            vec = [0.0] * self.dimensions
            for tok in text.lower().split():
                vec[hash(tok) % self.dimensions] += 1.0
            norm = sum(v * v for v in vec) ** 0.5 or 1.0
            out.append([v / norm for v in vec])
        return out


@dataclass
class MockServiceProvider(ServiceProvider):
    config: dict[str, Any] = field(default_factory=dict)

    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService:
        return MockCompletionsService({**self.config, **config})

    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService:
        return MockEmbeddingsService({**self.config, **config})


register_provider("mock-serving-configuration", lambda cfg: MockServiceProvider(cfg))


def _torch_provider(cfg: dict[str, Any]) -> ServiceProvider:
    # lazy import: the engine (and torch's CUDA state) loads only when an
    # application names a serving resource
    from langstream_tpu_torch.agents.provider import TorchServiceProvider

    return TorchServiceProvider(cfg, device=SERVING_DEVICE)


register_provider("tpu-serving-configuration", _torch_provider)


def _openai_provider(cfg: dict[str, Any]) -> ServiceProvider:
    from langstream_tpu_torch.agents.http_providers import OpenAICompatProvider

    return OpenAICompatProvider(cfg)


register_provider("open-ai-configuration", _openai_provider)
register_provider("ollama-configuration", _openai_provider)
