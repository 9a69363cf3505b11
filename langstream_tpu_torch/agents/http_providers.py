"""OpenAI-compatible HTTP model providers (external services).

Parity: the reference's ``OpenAIServiceProvider`` / ``OllamaProvider`` etc.
(``langstream-ai-agents/.../services/impl/*.java``). Kept for compatibility —
in this framework the first-party path is the in-tree TPU provider; these
gate on network availability.

The port's copy of ``langstream_tpu/agents/http_providers.py``, on the
port's own client (:func:`langstream_tpu_torch.gateway.wire.open_response`)
instead of aiohttp: a streamed answer is read line by line as it arrives.
"""

from __future__ import annotations

import json
from typing import Any

from langstream_tpu_torch.agents.services import (
    Chunk,
    CompletionResult,
    CompletionsService,
    EmbeddingsService,
    ServiceProvider,
    StreamingChunksConsumer,
)
from langstream_tpu_torch.gateway import wire


class OpenAICompatCompletions(CompletionsService):
    def __init__(self, config: dict[str, Any]):
        self.base_url = (config.get("url") or "https://api.openai.com/v1").rstrip("/")
        self.access_key = config.get("access-key", "")

    async def _request(self, path: str, payload: dict[str, Any], stream: bool):
        headers = {"Content-Type": "application/json"}
        if self.access_key:
            headers["Authorization"] = f"Bearer {self.access_key}"
        return await wire.open_response(
            "POST", f"{self.base_url}{path}", json_body=payload, headers=headers
        )

    @staticmethod
    def _options_payload(options: dict[str, Any]) -> dict[str, Any]:
        mapping = {
            "model": "model",
            "max-tokens": "max_tokens",
            "temperature": "temperature",
            "top-p": "top_p",
            "stop": "stop",
            "presence-penalty": "presence_penalty",
            "frequency-penalty": "frequency_penalty",
        }
        return {
            dst: options[src] for src, dst in mapping.items() if src in options
        }

    async def chat_completions(
        self,
        messages: list[dict[str, str]],
        options: dict[str, Any],
        consumer: StreamingChunksConsumer | None = None,
    ) -> CompletionResult:
        payload = {"messages": messages, **self._options_payload(options)}
        if consumer is not None:
            payload["stream"] = True
            resp = await self._request("/chat/completions", payload, True)
            try:
                full: list[str] = []
                i = 0
                async for line in resp:
                    decoded = line.decode().strip()
                    if not decoded.startswith("data:"):
                        continue
                    data = decoded[5:].strip()
                    if data == "[DONE]":
                        break
                    delta = (
                        json.loads(data)["choices"][0].get("delta", {}).get("content")
                    )
                    if delta:
                        full.append(delta)
                        result = consumer(Chunk(delta, i))
                        if hasattr(result, "__await__"):
                            await result
                        i += 1
                result = consumer(Chunk("", i, last=True))
                if hasattr(result, "__await__"):
                    await result
                return CompletionResult(text="".join(full))
            finally:
                resp.close()
        resp = await self._request("/chat/completions", payload, False)
        try:
            data = await resp.json()
            choice = data["choices"][0]
            usage = data.get("usage", {})
            return CompletionResult(
                text=choice["message"]["content"],
                num_prompt_tokens=usage.get("prompt_tokens", 0),
                num_completion_tokens=usage.get("completion_tokens", 0),
                finish_reason=choice.get("finish_reason", "stop"),
            )
        finally:
            resp.close()

    async def text_completions(
        self,
        prompt: str,
        options: dict[str, Any],
        consumer: StreamingChunksConsumer | None = None,
    ) -> CompletionResult:
        payload = {"prompt": prompt, **self._options_payload(options)}
        resp = await self._request("/completions", payload, False)
        try:
            data = await resp.json()
            choice = data["choices"][0]
            text = choice.get("text", "")
            if consumer is not None:
                result = consumer(Chunk(text, 0, last=True))
                if hasattr(result, "__await__"):
                    await result
            return CompletionResult(text=text)
        finally:
            resp.close()


class OpenAICompatEmbeddings(EmbeddingsService):
    def __init__(self, config: dict[str, Any]):
        self.base_url = (config.get("url") or "https://api.openai.com/v1").rstrip("/")
        self.access_key = config.get("access-key", "")
        self.model = config.get("model", "text-embedding-ada-002")

    async def compute_embeddings(self, texts: list[str]) -> list[list[float]]:
        headers = {"Content-Type": "application/json"}
        if self.access_key:
            headers["Authorization"] = f"Bearer {self.access_key}"
        async with await wire.open_response(
            "POST",
            f"{self.base_url}/embeddings",
            json_body={"input": texts, "model": self.model},
            headers=headers,
        ) as resp:
            data = await resp.json()
        return [d["embedding"] for d in data["data"]]


class OpenAICompatProvider(ServiceProvider):
    def __init__(self, config: dict[str, Any]):
        self.config = config

    def get_completions_service(self, config: dict[str, Any]) -> CompletionsService:
        return OpenAICompatCompletions({**self.config, **config})

    def get_embeddings_service(self, config: dict[str, Any]) -> EmbeddingsService:
        return OpenAICompatEmbeddings({**self.config, **config})
