"""Batched encoder serving (port of the JAX package's ``EmbeddingEngine``,
``langstream_tpu/serving/engine.py``): what the ``compute-ai-embeddings``
agent reaches through the provider's embeddings service.

Under a ``mesh`` of more than one rank every rank is a process, as for the
serving engine (started by the engine when no world is joined,
:func:`~langstream_tpu_torch.parallel.launch.ensure_world`, or shared with
a serving engine of the same mesh size): rank 0 leads, and each encoder
call is replayed on every
rank (the ``embed`` frame of :mod:`langstream_tpu_torch.serving.lockstep`,
carrying the padded tokens and mask), or the first ``tp`` sum would wait
forever. The mesh, its groups and the weights' shards are made at the
first call, on every rank alike (the followers build their engine from
that frame). The leader shares the lockstep channel of a serving engine of
the same process, so one resource's two agents make one channel a rank.
"""

from __future__ import annotations

import asyncio
import json
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
    shard_encoder_params,
)
from langstream_tpu_torch.parallel import launch
from langstream_tpu_torch.parallel.mesh import make_mesh, rank_device
from langstream_tpu_torch.models.tokenizer import load_tokenizer
from langstream_tpu_torch.serving.engine import _bucket, _to_device


class EmbeddingEngine:
    """One encoder per ``(model, tokenizer, checkpoint, mesh, device)`` in
    the process. ``embed`` clips ids into the encoder's vocab, pads to the
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
        key = (model, tokenizer, checkpoint, tuple((mesh or {}).items()),
               str(torch.device(device)))
        with cls._instances_lock:
            if key not in cls._instances:
                cls._instances[key] = cls(model, tokenizer, checkpoint, mesh=mesh,
                                          device=device)
            return cls._instances[key]

    @classmethod
    def reset_instances(cls) -> None:
        with cls._instances_lock:
            cls._instances.clear()

    def __init__(self, model: str = "minilm-l6", tokenizer: str | None = None,
                 checkpoint: str | None = None, *, mesh: dict | None = None,
                 device="cuda", lockstep_role: str | None = None):
        self.device = require_device(device, "EmbeddingEngine")
        self.model, self.tokenizer_name, self.checkpoint = model, tokenizer, checkpoint
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
        self.mesh = None
        self.mesh_axes = dict(mesh) if mesh else None
        self.lockstep_role = lockstep_role
        self._lockstep = None
        self._full_params = None
        # the world whose ranks this process started (None: none started)
        self._launched, started = (launch.ensure_world(self.mesh_axes, self.device)
                                   if lockstep_role != "follower" else (None, False))
        if self.mesh_axes:
            try:
                # the sizes against the world now (no collective); the
                # groups and shards at the first call, which every rank makes
                probe = make_mesh(self.mesh_axes, groups=False)
                if probe.world_size > 1 and lockstep_role != "follower":
                    self._lead(probe)
            except BaseException as e:
                if started:  # no rank waits on an engine that failed
                    launch.abandon(e)
                raise
            self.device = rank_device(self.device, probe.rank)
            self._full_params, self.params = params, None
        else:
            self.params = _to_device(params, self.device)
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="torch-embed")
        self._m_embeddings = metrics.REPORTER(
            prefix="langstream_serving", agent_id=model).counter(
            "embeddings_total", "embedding vectors computed")

    def _lead(self, probe) -> None:
        """Rank 0 leads the lockstep channel (a serving engine's, when this
        process has one on the port); other ranks replay."""
        from langstream_tpu_torch.serving import lockstep

        if probe.rank != 0:
            raise ValueError(
                f"rank {probe.rank} of a lockstep group replays the leader's "
                f"embed calls: build it through LockstepFollower")
        self._lockstep, _ = lockstep.lead_world({}, probe.world_size - 1, self._launched)
        self.lockstep_role = "leader"

    def _place(self) -> None:
        """The mesh, its groups and this rank's shards (every rank, at the
        first call)."""
        self.mesh = make_mesh(self.mesh_axes)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.params = _to_device(
            shard_encoder_params(self._full_params, self.config, self.mesh), self.device)
        self._full_params = None

    def mesh_section(self) -> dict[str, Any] | None:
        """The mesh, this rank's place in it and its collectives; None
        without a mesh or before the first call."""
        if self.mesh is None:
            return None
        return {**self.mesh.describe(), "lockstep-role": self.lockstep_role,
                "launched": self._launched.describe() if self._launched else None}

    def _encode(self, tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        if self._lockstep is not None:
            self._lockstep.broadcast({
                "op": "embed", "model": self.model, "tokenizer": self.tokenizer_name,
                "checkpoint": self.checkpoint, "mesh_json": json.dumps(self.mesh_axes),
                "tokens": tokens, "mask": mask})
        if self.params is None:
            self._place()
        out = encode(self.config, self.params,
                     torch.from_numpy(tokens).to(self.device),
                     torch.from_numpy(mask).to(self.device), mesh=self.mesh)
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
        # the last user of the channel sends "stop", and the world ends
        # (the ranks this process started reaped; one that failed raises)
        channel, self._lockstep = self._lockstep, None
        if channel is not None and channel.close():
            launch.end_world(barrier=not channel.broken)
