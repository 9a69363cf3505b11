"""The port's ``tpu-serving-configuration`` provider (port of
``langstream_tpu/agents/tpu_provider.py``): the AI agents' completions and
embeddings served by :class:`~langstream_tpu_torch.serving.engine.TorchServingEngine`
and :class:`~langstream_tpu_torch.serving.embeddings.EmbeddingEngine` on
one card, tokens streamed into the agent's chunk consumer.

The resource (``configuration.yaml``) is the JAX provider's: engine
topology (model, slots, checkpoint, ...) comes from the resource, the
per-request options (max-tokens, temperature, ...) from the agent at call
time, so every agent of an application shares one engine per resource.
Which package serves is not a resource key: ``serve_torch.py`` at the
repository root registers this provider with the platform, and hands it
the platform's stream registry, so a gateway's disconnect cancels the
port's requests by their ``stream-key``.
"""

from __future__ import annotations

from typing import Any

from langstream_tpu_torch.agents.services import (
    Chunk,
    CompletionResult,
    CompletionsService,
    EmbeddingsService,
    ServiceProvider,
    StreamingChunksConsumer,
)
from langstream_tpu_torch.serving.embeddings import EmbeddingEngine
from langstream_tpu_torch.serving.engine import (
    ServingConfig,
    TorchServingEngine,
    _normalize_stop,
)
from langstream_tpu_torch.serving.streaming import StreamCancelRegistry


def _render_chat_prompt(messages: list[dict[str, str]]) -> str:
    """Default chat template (the JAX provider's)."""
    parts = []
    for m in messages:
        parts.append(f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}")
    parts.append("<|assistant|>\n")
    return "\n".join(parts)


class _StreamAdapter:
    """Bridges engine ``on_token`` callbacks to the agents' chunk consumers,
    detokenising incrementally (only complete UTF-8 prefixes are emitted).
    Stop sequences are excluded from the stream: text that could still
    grow into a stop match is held back, and a match truncates the stream
    at its start (as the engine truncates the final text). Each token
    re-decodes the whole id list, as the JAX provider does: the chunk
    boundaries are part of what the two providers share."""

    def __init__(self, tokenizer, consumer: StreamingChunksConsumer,
                 stop: list[str] | None = None):
        self.tokenizer = tokenizer
        self.consumer = consumer
        self.stop = _normalize_stop(stop)
        self.ids: list[int] = []
        self.emitted = ""
        self.index = 0
        self.closed = False

    def _stop_holdback(self, text: str) -> int:
        """Chars at the end of ``text`` that are a prefix of some stop
        string: unsafe to emit until the match resolves either way."""
        hold = 0
        for s in self.stop:
            for k in range(min(len(s) - 1, len(text)), 0, -1):
                if s.startswith(text[-k:]):
                    hold = max(hold, k)
                    break
        return hold

    async def on_token(self, token: int, logprob: float, last: bool) -> None:
        if self.closed:
            return
        self.ids.append(token)
        text = self.tokenizer.decode(self.ids)
        # hold back a trailing replacement char (partial multi-byte sequence)
        safe = text[:-1] if text.endswith("�") and not last else text
        if self.stop:
            hits = [i for i in (safe.find(s) for s in self.stop) if i >= 0]
            if hits:
                safe = safe[: min(hits)]
                last = True
            elif not last:
                safe = safe[: len(safe) - self._stop_holdback(safe)]
        delta = safe[len(self.emitted):]
        if delta or last:
            self.emitted = safe
            self.closed = last
            result = self.consumer(Chunk(delta, self.index, last=last))
            if hasattr(result, "__await__"):
                await result
            self.index += 1


class _ChunkAdapter:
    """Bridges engine ``on_chunk`` deliveries to the agents' chunk consumers
    on a ``streaming: true`` engine. The engine has already detokenised the
    delta, held back partial UTF-8 sequences and possible stop-prefix tails
    and cut at stop matches, so this only reshapes ``(new_ids, new_text,
    is_final)`` into :class:`Chunk` calls; each delivery is what the
    engine's TBT digests time."""

    def __init__(self, consumer: StreamingChunksConsumer):
        self.consumer = consumer
        self.index = 0

    async def on_chunk(self, new_ids: list, new_text: str, is_final: bool) -> None:
        result = self.consumer(Chunk(new_text, self.index, last=is_final))
        if hasattr(result, "__await__"):
            await result
        self.index += 1


class TorchCompletionsService(CompletionsService):
    def __init__(self, engine: TorchServingEngine):
        self.engine = engine

    async def _generate(self, prompt: str, options: dict[str, Any],
                        consumer: StreamingChunksConsumer | None) -> CompletionResult:
        if consumer is not None and self.engine.config.streaming:
            # a streaming engine delivers at the chunk boundary (timed for
            # TBT) and holds back itself
            result = await self.engine.generate(
                prompt, options, on_chunk=_ChunkAdapter(consumer).on_chunk)
        else:
            adapter = (
                _StreamAdapter(self.engine.tokenizer, consumer, stop=options.get("stop"))
                if consumer is not None else None
            )
            result = await self.engine.generate(
                prompt, options, on_token=adapter.on_token if adapter else None,
            )
        return CompletionResult(
            text=result["text"],
            num_prompt_tokens=result["num_prompt_tokens"],
            num_completion_tokens=result["num_completion_tokens"],
            finish_reason=result["finish_reason"],
            ttft_s=result.get("ttft", 0.0),
            queue_wait_s=result.get("queue_wait", 0.0),
            prefill_s=result.get("prefill", 0.0),
        )

    async def chat_completions(
        self,
        messages: list[dict[str, str]],
        options: dict[str, Any],
        consumer: StreamingChunksConsumer | None = None,
    ) -> CompletionResult:
        return await self._generate(_render_chat_prompt(messages), options, consumer)

    async def text_completions(
        self,
        prompt: str,
        options: dict[str, Any],
        consumer: StreamingChunksConsumer | None = None,
    ) -> CompletionResult:
        return await self._generate(prompt, options, consumer)


class TorchEmbeddingsService(EmbeddingsService):
    def __init__(self, engine: EmbeddingEngine):
        self.engine = engine

    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]:
        return await self.engine.embed(texts)


class TorchServiceProvider(ServiceProvider):
    """The provider for one ``tpu-serving-configuration`` resource (its
    ``type`` and ``name`` stripped), on ``device`` (the card unless the
    caller asks for the CPU). ``streams`` is the stream registry its
    engine registers ``stream-key`` requests with (``None``: the port's
    own)."""

    def __init__(self, resource_config: dict[str, Any], *, device="cuda",
                 streams: StreamCancelRegistry | None = None):
        self.resource_config = resource_config
        self.device = device
        self.streams = streams

    def _engine_config(self) -> dict[str, Any]:
        return {k: v for k, v in self.resource_config.items() if k not in ("type", "name")}

    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService:
        engine = TorchServingEngine.get_or_create(
            ServingConfig.from_dict(self._engine_config()), device=self.device,
            streams=self.streams)
        return TorchCompletionsService(engine)

    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService:
        cfg = self._engine_config()
        engine = EmbeddingEngine.get_or_create(
            model=cfg.get("embeddings-model", "minilm-l6"),
            tokenizer=cfg.get("tokenizer"),
            checkpoint=cfg.get("embeddings-checkpoint"),
            mesh=cfg.get("mesh"),
            device=self.device,
        )
        return TorchEmbeddingsService(engine)
