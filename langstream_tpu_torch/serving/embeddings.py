"""Batched encoder serving (port of the JAX package's ``EmbeddingEngine``,
``langstream_tpu/serving/engine.py``): what the ``compute-ai-embeddings``
agent reaches through the provider's embeddings service."""

from __future__ import annotations

import asyncio
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from langstream_tpu_torch._device import require_device
from langstream_tpu_torch.core import metrics
from langstream_tpu_torch.models.encoder import (
    EncoderConfig,
    encode,
    init_encoder_params,
    load_from_sentence_transformers,
)
from langstream_tpu_torch.models.tokenizer import load_tokenizer
from langstream_tpu_torch.serving.engine import _bucket, _to_device


class EmbeddingEngine:
    """One encoder per ``(model, tokenizer, checkpoint, device)`` in the
    process. ``embed`` clips ids into the encoder's vocab, pads to the
    length bucket ``_bucket(lo=16, hi=max_position)`` and the rows to a
    power of two (all-padding rows are safe: pooling and norm are guarded),
    runs the encoder on the one executor thread and slices the real rows
    back. Random weights come from a CPU generator seeded 0 and are moved to
    the device, so the card and the CPU hold the same numbers."""

    _instances: dict[Any, "EmbeddingEngine"] = {}
    _instances_lock = threading.Lock()

    @classmethod
    def get_or_create(cls, model: str = "minilm-l6", tokenizer: str | None = None,
                      checkpoint: str | None = None, mesh: dict | None = None,
                      device="cuda") -> "EmbeddingEngine":
        if mesh:
            raise NotImplementedError(
                "not in this port yet: mesh: the embeddings engine's mesh "
                "(encoder_param_specs, dp fan-out) is ROADMAP.md Queue 1 item 13b")
        key = (model, tokenizer, checkpoint, str(torch.device(device)))
        with cls._instances_lock:
            if key not in cls._instances:
                cls._instances[key] = cls(model, tokenizer, checkpoint, device=device)
            return cls._instances[key]

    @classmethod
    def reset_instances(cls) -> None:
        with cls._instances_lock:
            cls._instances.clear()

    def __init__(self, model: str = "minilm-l6", tokenizer: str | None = None,
                 checkpoint: str | None = None, *, device="cuda"):
        self.device = require_device(device, "EmbeddingEngine")
        if model in ("tiny", "tiny-encoder"):
            self.config = EncoderConfig.tiny()
        else:
            self.config = EncoderConfig.minilm_l6()
        self.tokenizer = load_tokenizer(tokenizer)
        if checkpoint:
            self.config, params = load_from_sentence_transformers(checkpoint)
        else:
            params = init_encoder_params(
                self.config, torch.Generator().manual_seed(0), device="cpu")
        self.params = _to_device(params, self.device)
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="torch-embed")
        self._m_embeddings = metrics.REPORTER(
            prefix="langstream_serving", agent_id=model).counter(
            "embeddings_total", "embedding vectors computed")

    def _encode(self, tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        out = encode(self.config, self.params,
                     torch.from_numpy(tokens).to(self.device),
                     torch.from_numpy(mask).to(self.device))
        return out.cpu().numpy()

    async def embed(self, texts: list[str]) -> list[list[float]]:
        if not texts:
            return []
        max_pos = self.config.max_position
        V = self.config.vocab_size
        # clip ids into the encoder vocab (byte fallback on a tiny vocab)
        ids = [[t % V for t in self.tokenizer.encode(text)[:max_pos]] for text in texts]
        bucket = _bucket(max(len(r) for r in ids), lo=16, hi=max_pos)
        B = len(ids)
        Bp = _bucket(B, lo=1)  # rows: the smallest power of two >= B
        tokens = np.zeros((Bp, bucket), dtype=np.int64)
        mask = np.zeros((Bp, bucket), dtype=np.int64)
        for i, row in enumerate(ids):
            tokens[i, : len(row)] = row
            mask[i, : len(row)] = 1
        out = await asyncio.get_running_loop().run_in_executor(
            self._executor, self._encode, tokens, mask)
        self._m_embeddings(len(texts))
        return out[:B].tolist()

    def close(self) -> None:
        self._executor.shutdown(wait=True)
