"""Continuous-batching serving engine (port of the main path of
``langstream_tpu/serving/engine.py``).

Execution model:

- A fixed pool of ``slots`` (the decode batch dimension). FIFO admission:
  queued requests prefill in batches of up to ``prefill-batch`` prompts
  that share a length bucket (:func:`_bucket`); the first token is sampled
  on the device and the request joins the decode batch.
- Paged layout with ``prefix-cache`` (the default): a prompt that starts
  with a cached block chain adopts those blocks and prefills only its
  suffix through the continuation path; every finished prefill publishes
  its full prompt blocks. With ``prefill-chunk > 0`` a prompt whose
  remaining tokens exceed the chunk claims its slot at admission and then
  prefills one chunk per loop pass (continuation path again), interleaved
  with the decode chunks of the other slots.
- Decode runs in bursts of chunks over the active slots:
  ``decode-chunk-light`` fused steps per chunk while at most
  :meth:`TorchServingEngine._light_threshold` slots are active (the TTFT
  regime), ``decode-chunk`` above it, halved while every request needs
  fewer. The KV cache — dense ``(L, slots, S, Kh, D)`` read through
  identity block tables, or the paged pool — is read-only inside a chunk;
  one commit writes the chunk's rows.
- Heavy bursts run the JAX engine's depth-2 **pipelined loop**
  (``pipeline: true``, the default; ``LS_TPU_PIPELINE=0`` turns it off):
  chunk N+1 is dispatched from chunk N's device-resident final tokens and
  lengths before chunk N's tokens reach the host, so the host's work on
  chunk N runs while N+1 executes. Slots that finish inside a chunk freeze
  in the device active mask from the next dispatch on (their over-run
  tokens are dropped on the host, never billed); their blocks are
  released when the burst ends. A burst that ends because queued work can
  be admitted leaves its last chunk in flight: the admission prefill is
  queued behind it on the same stream, and the loop applies the chunk
  afterwards, per slot only to the request it ran for. The light regime,
  penalty bursts and ``pipeline: false`` run the sequential loop (one
  chunk at a time, the burst ends on any finish), the reference the
  pipelined loop is tested against.
- Each chunk ends with exactly ONE device-to-host copy: the tokens and
  their logprobs packed into one int32 tensor on the device, copied into
  one of two pinned host buffers without blocking and waited for through
  a CUDA event (``stats()["decode-chunks"]["host_fetches_per_chunk"] ==
  1.0``). Nothing else on the dispatch path syncs: the block tables and
  the sampler settings upload through content-keyed device caches
  (``stats()["device-cache"]``), the rest from pinned memory.
- Observability (carried from the JAX package): ``self.flight``, the
  flight recorder (wall time split into device, exposed host and stall;
  ``flight.summary()``), and ``self.attribution``, the per-program ledger
  of expected (bytes at the card's bandwidth) against measured device
  time (``stats()["attribution"]``); ``self.profiler`` captures a
  ``torch.profiler`` trace of the first chunks when ``LS_TPU_PROFILE_DIR``
  is set.
- Paged layout with ``speculative-drafts: N``: while no active request has
  penalties, decode runs as speculative steps instead of chunks. One
  dispatch drafts N tokens per slot by prompt lookup over device-resident
  context rows, verifies N + 1 positions (greedy acceptance, or rejection
  sampling for sampled requests) and extends the rows; one packed fetch
  per step. A plain K=1 chunk every ``_spec_cal_every`` steps measures the
  uplift; below 1 speculation turns off until ``_spec_retry_plain`` plain
  chunks have run (``stats()["speculative"]``).
- Under ``mesh`` every rank is a process (``torch.distributed``), serving
  Megatron TP, dp over the attention reads and expert parallelism on its
  shards (``models/llama.py``, ``models/moe.py``). Rank 0 leads: it
  consumes requests, admits, samples and, before every dispatch,
  broadcasts a step descriptor that the other ranks replay on their own
  engines (:mod:`langstream_tpu_torch.serving.lockstep`); only the leader
  fetches. A broken group fails the work in flight and stops the engine.
  ``sp`` is ROADMAP.md Queue 1 item 13b.
- Device work runs on one executor thread, so the asyncio loop stays live.
- ``warmup-on-start``: the first request starts one shared warmup task (a
  lone greedy probe, then a concurrent wave) and every early request awaits
  it; see :meth:`TorchServingEngine.warmup`.
- Mixtral-family models (``moe-tiny``, ``moe-8x7b``, ``mixtral-8x7b``)
  serve on the same paths: the engine passes ``moe_serving_ffn`` as the
  ``ffn=`` hook of every model call. Capacity follows the padded batch,
  so a MoE prefill pads its rows to a power of two with copies of the last
  row, as the JAX engine does for every model; the copies take expert
  capacity as there, and only the last copy commits its K/V (the JAX
  scatter's last write on the CPU).
- Submit-time refusals, as in the JAX engine: a request naming an
  ``adapter`` on an engine without an adapter store raises ``ValueError``; one whose
  ``deadline``/``deadline-s`` budget is spent raises
  :class:`~langstream_tpu_torch.serving.handoff.DeadlineExceeded`; both
  before the request queues.
- Admission plane (``serving/scheduler.py``, ``serving/qos.py``): every
  request enters through ``self.scheduler`` — FIFO by default, the QoS
  scheduler under ``qos:`` (priority classes with WDRR dequeue, bounded
  class queues and tenant token buckets, whose refusals raise
  :class:`~langstream_tpu_torch.serving.qos.RateLimited`). At admission a
  request whose ``deadline`` budget cannot cover the median recent
  prefill is shed. Under QoS, when the head of the queue stalls on KV
  blocks, the loop's safe point (no chunk in flight) preempts the
  policy's victim: its slot and blocks free at once and it requeues at
  the front of its class; on readmission it re-prefills its prompt plus
  the tokens it generated (``_Request.context_tokens``) and continues.
- Delivery plane (``serving/streaming.py``): ``on_chunk`` consumers get one
  delivery per request per flush; with ``streaming: true`` each delivery's
  gap feeds a per-request and a per-class TBT digest, gaps longer than
  ``stream-stall-s`` (or the class's ``tbt-p99-s``) count as stalls, and a
  class with ``tbt-p99-s`` gets its own burn-rate tracker. A
  ``stream-key`` registers the request's future with the stream registry,
  so a gateway's disconnect cancels it; the slot frees at the next chunk
  boundary.
- Health plane (``serving/health.py``): the watchdog is beaten at every
  flight boundary; :meth:`TorchServingEngine.health` judges it (wait-free)
  with the degradation predicates, ``slo:`` objectives are tracked with
  multi-window burn rates (:meth:`TorchServingEngine.slo_status`), and
  :func:`health_report` lists every live engine's verdict.

- KV off the card (``serving/kvtransfer.py``, ``serving/prefixstore.py``):
  with ``prefix-store`` the paged prefix cache is T0 of three tiers. Over
  ``t0-bytes`` the loop's safe point (no chunk in flight) demotes LRU
  cache-only leaf blocks to host RAM (T1, one timed fetch per pass), T1
  overflow serializes to object storage (T2, on a hydrator thread), and an
  admission whose prompt chain continues in T1 promotes those rows into
  fresh blocks (pinned uploads, one scatter); one whose chain continues in
  T2 waits off the queue for the hydration, or computes cold after
  ``hydrate-timeout-s``. ``pool-role: prefill`` exports each finished
  prefill as an LSKV payload (:meth:`TorchServingEngine.take_export`) and
  frees its slot; ``pool-role: decode`` admits payloads through
  :meth:`TorchServingEngine.import_handoff` with no prefill. Payloads and
  blobs are byte-compatible with the JAX package's.
- Multi-LoRA (``serving/adapters.py``): with ``adapter-store`` (paged layout
  only) a request's ``adapter`` resolves at admission to a pinned row of
  the stacked device A/B buffers (T0; a T1 host copy loads into a free or
  unpinned row on the dispatch thread, a T2 blob hydrates while the request
  waits off the queue, an unknown one is refused with
  :class:`~langstream_tpu_torch.serving.adapters.AdapterUnavailable`).
  Every paged prefill, continuation, decode chunk and speculative step
  then adds each row's ``lora_delta`` to the q/k/v/o projections, row 0
  being the base model; adapter requests stay out of the prefix cache both
  ways. Without the section no delta is computed.

- Device-survival plane (``serving/faults.py``, ``serving/journal.py``):
  ``faults`` (or ``LS_TPU_FAULTS``) arms deterministic fault plans at the
  engine's seams (``pool-grow``, ``prefill``, ``scatter``, ``fetch``,
  ``t2-get``); a production engine has no injector. A device error that
  :meth:`TorchServingEngine._resource_exhausted` classifies as an allocator
  failure (an injected one, the block manager's ``pool exhausted`` or a
  CUDA out-of-memory) does not fail the in-flight work: the loop withholds
  ``shrink-fraction`` of the KV admission budget, requeues the slots whose
  prefill never landed and the lowest-class victims until the
  reservations fit, and restores one quantum per quiet
  ``shrink-recovery-s`` (``pool-shrink``/``pool-restore`` flight events).
  With ``journal-dir`` every accepted request is journaled at submit and
  retired when the caller is answered; a new engine on the same directory
  replays what its predecessor never answered, front of class, on its
  loop's first pass.
- Drain (:meth:`TorchServingEngine.drain`): admission closes (submissions
  shed with ``RateLimited("draining")``), the loop's safe point requeues
  every running request once, the backlog is served within the grace and
  what is left past it fails loudly.
- Request evidence (``core/tracing.py``, ``serving/journey.py``,
  ``serving/incident.py``): every request carries a journey id (its trace
  id when ``generate`` runs under an ambient trace) and records the JAX
  engine's lifecycle edges in :data:`~langstream_tpu_torch.serving.journey.JOURNEYS`
  as wait-free appends at the sites where the host learns them; a traced
  request's phases become ``engine.*`` spans at completion. With
  ``incident-dir`` a breach (health transition, SLO or TBT fast burn,
  breaker or adapter storm) captures a bundle on the recorder's writer
  thread (:func:`incident_report`).
- Prometheus plane (``core/metrics.py``): the engine registers the JAX
  engine's ``langstream_serving_*`` series under its conditions (the QoS,
  SLO, split-pool, tier, paged-pool and journal families only with their
  planes; the breaker gauge, the deadline counter and the per-class
  streaming TBT histograms at first use) and feeds them host numbers it
  already holds at the JAX engine's sites; a traced request stamps its
  journey id on its TTFT, TBT and KV-transfer buckets (exemplars). The
  flight ring also gets the JAX engine's ``recompile`` (a shape's first
  dispatch), ``spec-auto-disable``/``spec-auto-enable`` and ``warmup``
  events.
- Cross-replica handoff (``serving/handoff.py``): the export's wire header
  carries the trace and journey; :class:`~langstream_tpu_torch.serving.handoff.HandoffChainer`
  drives an export through :meth:`TorchServingEngine.take_export_entry`,
  a router's decode picks and :meth:`TorchServingEngine.import_handoff`,
  falling back to the prefill engine itself (``local_fallback``), and
  counts its re-offers and fallbacks through the ``note_*`` hooks.

Settings whose feature this slice lacks raise ``NotImplementedError`` naming
the ``ROADMAP.md`` item; settings that only change latency are accepted and
logged once. The engine runs on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; it never falls back on its own.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import math
import os
import re
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from langstream_tpu_torch._device import require_device
from langstream_tpu_torch.core import metrics
from langstream_tpu_torch.core.tracing import (
    TraceContext,
    current_context,
    fresh_trace_id,
    record_span,
)
from langstream_tpu_torch.models.checkpoints import (
    load_llama_checkpoint,
    load_moe_checkpoint,
)
from langstream_tpu_torch.models.kvquant import (
    init_kv_cache_int8,
    is_quant_cache,
    quantize_rows,
)
from langstream_tpu_torch.models.llama import (
    LlamaConfig,
    init_llama_params,
    llama_param_specs,
    local_config,
    param_count,
    prefill_forward,
    rank_specs,
)
from langstream_tpu_torch.models.llama_paged import (
    llama_decode_chunk_dense_pallas,
    llama_decode_chunk_paged,
    llama_prefill_continue_paged,
    llama_prefill_paged,
    llama_spec_step_paged,
    pack_tokens_logprobs,
)
from langstream_tpu_torch.models.moe import (
    MoEConfig,
    init_moe_params,
    moe_param_specs,
    moe_serving_ffn,
)
from langstream_tpu_torch.models.paged import (
    BlockManager,
    PagedLayout,
    init_paged_kv_cache,
    init_paged_kv_cache_int8,
)
from langstream_tpu_torch.models.quant import (
    LLAMA_QUANT_AXES,
    MOE_QUANT_AXES,
    QTensor,
    init_llama_params_q8,
    init_moe_params_q8,
    quantize_llama_params,
    quantize_moe_params,
    quantize_specs,
    quantize_tensor,
)
from langstream_tpu_torch.parallel.mesh import (
    PartitionSpec,
    make_mesh,
    rank_device,
    shard_tree,
)
from langstream_tpu_torch.models.tokenizer import Tokenizer, load_tokenizer
from langstream_tpu_torch.ops.flash_attention import flash_attention
from langstream_tpu_torch.ops.paged_attention import (
    _paged_attention_partial_q8,
    paged_attention_multiquery_partial,
    paged_attention_partial,
)
from langstream_tpu_torch.serving.adapters import (
    FACTOR_KEYS,
    AdapterStore,
    AdapterStoreSpec,
    AdapterUnavailable,
)
from langstream_tpu_torch.serving.attribution import (
    ModelShape,
    ProgramLedger,
    decode_cost,
    memory_ledger,
    prefill_cost,
    tree_device_bytes,
    verify_cost,
)
from langstream_tpu_torch.serving.handoff import (
    DeadlineExceeded,
    deadline_from_options,
    parse_deadline,
    remaining_s,
)
from langstream_tpu_torch.serving.faults import (
    FaultInjector,
    FaultPlan,
    InjectedFault,
    plans_from_env,
)
from langstream_tpu_torch.serving.flight import FlightRecorder
from langstream_tpu_torch.serving import kvtransfer
from langstream_tpu_torch.serving.health import (
    EngineWatchdog,
    SloObjective,
    SloSpec,
    SloTracker,
)
from langstream_tpu_torch.serving.profiling import (
    ProfilerHooks,
    detect_generation,
    detect_hbm_capacity,
    detect_hbm_gbps,
)
from langstream_tpu_torch.serving.incident import (
    IncidentRecorder,
    adapter_eviction_storm,
    breaker_storm,
    worst_journeys,
)
from langstream_tpu_torch.serving.journal import RequestJournal, request_entry
from langstream_tpu_torch.serving.journey import JOURNEYS
from langstream_tpu_torch.serving.lockstep import LockstepBroken, LockstepLeader
from langstream_tpu_torch.serving.prefixstore import PrefixStore, PrefixStoreSpec
from langstream_tpu_torch.serving.qos import (
    PRIORITY_CLASSES,
    QosSpec,
    RateLimited,
    normalize_priority,
    priority_rank,
)
from langstream_tpu_torch.serving.sampler import K_MAX, sample_tokens
from langstream_tpu_torch.serving.scheduler import make_scheduler
from langstream_tpu_torch.serving.streaming import STREAMS, StreamCancelRegistry, TbtDigest

log = logging.getLogger(__name__)

_MODEL_CONFIGS = {
    "tiny": LlamaConfig.tiny,
    "llama-1b": LlamaConfig.llama_1b,
    "llama3-8b": LlamaConfig.llama3_8b,
    "llama-3-8b": LlamaConfig.llama3_8b,
    "llama3-70b": LlamaConfig.llama3_70b,
    "llama-3-70b": LlamaConfig.llama3_70b,
}
# MoE (Mixtral-family) models serve on the same engine through the FFN hook
_MOE_MODELS = {
    "moe-tiny": MoEConfig.tiny,
    "moe-8x7b": MoEConfig.mixtral_8x7b,
    "mixtral-8x7b": MoEConfig.mixtral_8x7b,
}
_DTYPES = {
    "float32": torch.float32, "f32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}
#: the model dtypes as the JAX engine's fingerprint spells them
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

#: adaptive pool shrink: the preempt-and-retry rounds a request whose
#: dispatch keeps failing gets before it is shed loudly (the bound that
#: keeps a deterministic failure from livelocking admit, fail, requeue)
_SHRINK_RETRY_CAP = 3

#: allocator-failure spellings: the JAX package's (XLA's, and the block
#: manager's "pool exhausted") and PyTorch's (the caching allocator's
#: "CUDA out of memory", the runtime's "CUDA error: out of memory",
#: cuBLAS's workspace refusal). One regex so every catch site agrees.
_RESOURCE_EXHAUSTED_RE = re.compile(
    r"RESOURCE_EXHAUSTED"
    r"|pool exhausted"
    r"|Out of memory"
    r"|Failed to allocate"
    r"|Allocation .* exceeds"
    r"|CUDA out of memory"
    r"|CUDA error: out of memory"
    r"|CUBLAS_STATUS_ALLOC_FAILED"
)
#: PyTorch's out-of-memory exception types (``torch.OutOfMemoryError`` and
#: its older alias under ``torch.cuda``), classified by type
_OOM_TYPES = tuple({t for t in (getattr(torch, "OutOfMemoryError", None),
                                getattr(torch.cuda, "OutOfMemoryError", None))
                    if t is not None})


def _parse_bool(v: Any) -> bool:
    """YAML/env values arrive as strings; bool("false") is True, so parse."""
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The ``tpu-serving-configuration`` resource: the same fields, kebab
    keys and defaults as the JAX package's ``ServingConfig``. ``qos``,
    ``slo``, ``prefix-store`` and ``adapter-store`` parse into their frozen
    specs and ``faults`` into :class:`FaultPlan` entries (so the config
    stays hashable)."""

    model: str = "tiny"
    slots: int = 8
    max_seq_len: int = 512
    tokenizer: str | None = None
    checkpoint: str | None = None
    mesh: tuple[tuple[str, int], ...] = ()
    default_max_tokens: int = 128
    seed: int = 0
    decode_chunk: int = 16
    decode_chunk_light: int = 8
    light_load_slots: int | None = None
    warmup_on_start: bool = False
    prefill_batch: int = 8
    model_dtype: str | None = None
    quantize: str | None = None
    kv_quantize: str | None = None
    kv_layout: str = "dense"
    kv_block_size: int = 64
    kv_pool_fraction: float = 0.5
    kv_pool_blocks: int | None = None
    paged_kernel: str = "auto"
    dense_kernel: str = "auto"
    prefix_cache: bool = True
    speculative_drafts: int = 0
    prefill_chunk: int = 0
    qos: QosSpec | None = None
    pipeline: bool = True
    wedge_window_s: float = 60.0
    slo: SloSpec | None = None
    streaming: bool = False
    stream_stall_s: float = 2.0
    pool_role: str = "combined"
    prefix_store: PrefixStoreSpec | None = None
    adapter_store: AdapterStoreSpec | None = None
    shrink_fraction: float = 0.125
    shrink_recovery_s: float = 30.0
    faults: tuple = ()
    journal_dir: str | None = None
    incident_dir: str | None = None
    prefix_cache_max_suffix: int = 4096

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServingConfig":
        def get(key: str, default=None):
            return d.get(key, d.get(key.replace("-", "_"), default))

        def opt_int(key: str):
            v = get(key)
            return int(v) if v is not None else None

        mesh = tuple((k, int(v)) for k, v in (d.get("mesh") or {}).items())
        return cls(
            model=d.get("model", "tiny"),
            slots=int(d.get("slots", 8)),
            max_seq_len=int(get("max-seq-len", 512)),
            tokenizer=d.get("tokenizer"),
            checkpoint=d.get("checkpoint"),
            mesh=mesh,
            default_max_tokens=int(d.get("max-tokens", 128)),
            seed=int(d.get("seed", 0)),
            decode_chunk=int(d.get("decode-chunk", 16)),
            decode_chunk_light=int(get("decode-chunk-light", 8)),
            light_load_slots=opt_int("light-load-slots"),
            warmup_on_start=_parse_bool(get("warmup-on-start", False)),
            prefill_batch=int(d.get("prefill-batch", 8)),
            model_dtype=get("model-dtype"),
            quantize=d.get("quantize"),
            kv_quantize=get("kv-quantize"),
            kv_layout=get("kv-layout", "dense"),
            kv_block_size=int(get("kv-block-size", 64)),
            kv_pool_fraction=float(get("kv-pool-fraction", 0.5)),
            kv_pool_blocks=(
                int(d.get("kv-pool-blocks") or d.get("kv_pool_blocks"))
                if (d.get("kv-pool-blocks") or d.get("kv_pool_blocks"))
                else None
            ),
            paged_kernel=get("paged-kernel", "auto"),
            dense_kernel=get("dense-kernel", "auto"),
            prefix_cache=_parse_bool(get("prefix-cache", True)),
            prefix_cache_max_suffix=int(get("prefix-cache-max-suffix", 4096)),
            prefix_store=PrefixStoreSpec.from_dict(get("prefix-store")),
            adapter_store=AdapterStoreSpec.from_dict(get("adapter-store")),
            prefill_chunk=int(get("prefill-chunk", 0)),
            speculative_drafts=int(get("speculative-drafts", 0)),
            qos=QosSpec.from_dict(d.get("qos")),
            pool_role=str(get("pool-role", os.environ.get("LS_POOL_ROLE") or "combined")),
            pipeline=_parse_bool(d.get("pipeline", True)),
            wedge_window_s=float(get("wedge-window-s", 60.0)),
            slo=SloSpec.from_dict(d.get("slo")),
            streaming=_parse_bool(d.get("streaming", False)),
            stream_stall_s=float(get("stream-stall-s", 2.0)),
            shrink_fraction=float(get("shrink-fraction", 0.125)),
            shrink_recovery_s=float(get("shrink-recovery-s", 30.0)),
            faults=tuple(FaultPlan.from_dict(p) for p in (d.get("faults") or ())),
            journal_dir=get("journal-dir", os.environ.get("LS_TPU_JOURNAL_DIR") or None),
            incident_dir=get("incident-dir", os.environ.get("LS_TPU_INCIDENT_DIR") or None),
        )

    def to_dict(self) -> dict[str, Any]:
        """Kebab-case dict that :meth:`from_dict` round-trips (the JAX
        config's keys; an incident bundle carries it as ``config``)."""
        return {
            "model": self.model,
            "slots": self.slots,
            "max-seq-len": self.max_seq_len,
            "tokenizer": self.tokenizer,
            "checkpoint": self.checkpoint,
            "mesh": dict(self.mesh),
            "max-tokens": self.default_max_tokens,
            "seed": self.seed,
            "decode-chunk": self.decode_chunk,
            "decode-chunk-light": self.decode_chunk_light,
            "light-load-slots": self.light_load_slots,
            "warmup-on-start": self.warmup_on_start,
            "prefill-batch": self.prefill_batch,
            "quantize": self.quantize,
            "kv-quantize": self.kv_quantize,
            "kv-layout": self.kv_layout,
            "kv-block-size": self.kv_block_size,
            "kv-pool-fraction": self.kv_pool_fraction,
            "kv-pool-blocks": self.kv_pool_blocks,
            "paged-kernel": self.paged_kernel,
            "dense-kernel": self.dense_kernel,
            "prefix-cache": self.prefix_cache,
            "prefix-cache-max-suffix": self.prefix_cache_max_suffix,
            "prefix-store": (self.prefix_store.to_dict()
                             if self.prefix_store is not None else None),
            "adapter-store": (self.adapter_store.to_dict()
                              if self.adapter_store is not None else None),
            "prefill-chunk": self.prefill_chunk,
            "speculative-drafts": self.speculative_drafts,
            "model-dtype": self.model_dtype,
            "qos": self.qos.to_dict() if self.qos is not None else None,
            "pool-role": self.pool_role,
            "pipeline": self.pipeline,
            "wedge-window-s": self.wedge_window_s,
            "slo": self.slo.to_dict() if self.slo is not None else None,
            "streaming": self.streaming,
            "stream-stall-s": self.stream_stall_s,
            "shrink-fraction": self.shrink_fraction,
            "shrink-recovery-s": self.shrink_recovery_s,
            "faults": [p.to_dict() for p in self.faults],
            "journal-dir": self.journal_dir,
            "incident-dir": self.incident_dir,
        }


#: settings this slice does not serve: (predicate, message)
_UNSUPPORTED: tuple[tuple[Callable[[ServingConfig], bool], str], ...] = (
    (lambda c: dict(c.mesh).get("sp", 1) != 1,
     "mesh axis sp: sequence parallelism (ring/Ulysses prefill) is ROADMAP.md "
     "Queue 1 item 13b"),
)


def _multi_rank(config: ServingConfig) -> bool:
    """A mesh of more than one rank (every such mesh is multi-process)."""
    sizes = [n for _, n in config.mesh]
    return -1 in sizes or math.prod(sizes) > 1

#: accepted settings that change only latency here (the kernel choices the
#: JAX engine makes between Pallas and XLA paths); logged once when set
_LATENCY_ONLY = ("paged_kernel", "dense_kernel")


def _check_supported(config: ServingConfig) -> None:
    for unsupported, message in _UNSUPPORTED:
        if unsupported(config):
            raise NotImplementedError(f"not in this port yet: {message}")
    # the adaptive pool shrink's bounds, the JAX engine's messages
    if not 0.0 < config.shrink_fraction <= 1.0:
        raise ValueError("shrink_fraction must be in (0, 1]")
    if config.shrink_recovery_s <= 0:
        raise ValueError("shrink_recovery_s must be > 0")
    if config.quantize not in (None, "none", "int8"):
        raise ValueError(f"unknown quantize mode {config.quantize!r}")
    if config.kv_quantize not in (None, "none", "int8"):
        raise ValueError(f"unknown kv_quantize mode {config.kv_quantize!r}")
    if config.kv_layout not in ("dense", "paged"):
        raise ValueError(f"unknown kv_layout {config.kv_layout!r}")
    if config.model not in _MODEL_CONFIGS and config.model not in _MOE_MODELS:
        raise ValueError(
            f"unknown model {config.model!r}; known: "
            f"{sorted(_MODEL_CONFIGS) + sorted(_MOE_MODELS)}"
        )
    if config.model_dtype is not None and config.model_dtype not in _DTYPES:
        raise ValueError(
            f"unknown model_dtype {config.model_dtype!r}; known: {sorted(_DTYPES)}"
        )
    if config.prefill_chunk > 0 and config.kv_layout != "paged":
        raise ValueError(
            "prefill-chunk requires kv-layout=paged (chunked prefill "
            "commits through the paged continuation path)"
        )
    if config.speculative_drafts > 0 and config.kv_layout != "paged":
        raise ValueError(
            "speculative-drafts requires kv-layout=paged (the verify "
            "step commits through the paged continuation path)"
        )
    if config.pool_role not in ("combined", "prefill", "decode"):
        raise ValueError(
            f"unknown pool_role {config.pool_role!r}; known: combined, prefill, decode"
        )
    if config.pool_role != "combined" and config.kv_layout != "paged":
        raise ValueError(
            "pool-role prefill/decode requires kv-layout=paged (the KV handoff "
            "serializes paged blocks; a dense cache has no block tables)"
        )
    if (config.adapter_store is not None and config.adapter_store.enabled
            and config.kv_layout != "paged"):
        raise ValueError(
            "adapter-store requires kv-layout=paged (batched ragged adapter "
            "application rides the paged decode/prefill programs)"
        )
    if _multi_rank(config):
        # lockstep followers replay only the model dispatches: no descriptor
        # carries adapter rows, KV tier moves, or LSKV exports and imports
        if config.adapter_store is not None and config.adapter_store.enabled:
            raise ValueError(
                "adapter-store is incompatible with multi-host "
                "lockstep (followers replay positional dispatch "
                "descriptors that carry no adapter rows)"
            )
        if config.prefix_store is not None and config.prefix_store.enabled:
            raise ValueError(
                "prefix-store is incompatible with a multi-rank mesh: the "
                "lockstep followers replay no descriptor for KV tier moves "
                "(demotion gathers and promotion scatters of pool blocks)"
            )
        if config.pool_role != "combined":
            raise ValueError(
                "pool-role prefill/decode is incompatible with a multi-rank "
                "mesh: the lockstep followers replay no descriptor for LSKV "
                "exports and imports"
            )
    if config.prefix_store is not None and config.prefix_store.enabled:
        if config.kv_layout != "paged":
            raise ValueError(
                "prefix-store requires kv-layout=paged (the tiers demote and "
                "promote content-addressed pool blocks; a dense cache has none)"
            )
        if not config.prefix_cache:
            raise ValueError(
                "prefix-store requires prefix-cache=true (T0 is the automatic "
                "prefix cache; without it there is nothing to demote or promote)"
            )


@dataclasses.dataclass
class _Slot:
    request: "_Request | None" = None
    # chunked prefill: prompt tokens committed so far / mid-prefill flag
    # (the slot holds its reservation but stays out of decode until done)
    prefilling: bool = False
    prefill_done: int = 0

    @property
    def free(self) -> bool:
        return self.request is None


@dataclasses.dataclass
class _Request:
    prompt_tokens: list[int]
    max_tokens: int
    temperature: float
    top_k: int
    top_p: float
    future: asyncio.Future
    on_token: Callable | None = None
    on_chunk: Callable | None = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    generated: list[int] = dataclasses.field(default_factory=list)
    logprobs: list[float] = dataclasses.field(default_factory=list)
    enqueue_time: float = 0.0
    admit_time: float | None = None
    first_token_time: float | None = None
    # stop sequences: generation halts when any string appears in the
    # decoded output; the final text is cut at the match (match excluded)
    stop: list = dataclasses.field(default_factory=list)
    stop_matched: bool = False
    # warmup probes bypass QoS policy and stay out of the latency records
    warmup: bool = False
    # QoS identity: the priority class drives WDRR dequeue and preemption
    # eligibility, the tenant keys the token buckets; the defaults are the
    # unprivileged middle ground, so a QoS-off engine behaves as before
    tenant: str = ""
    priority: str = "default"
    # times preempted so far (capped by qos.max-preemptions) and, while
    # requeued, when the preemption happened (the resume wait)
    preemptions: int = 0
    preempt_time: float | None = None
    # end-to-end deadline: absolute epoch seconds, None = none
    deadline: float | None = None
    # streaming delivery: the sent counters drive the deltas (chunks tile
    # the final text), stream_tbt is the bounded inter-emit digest (only on
    # streaming engines), stream_key the gateway's stream id, the handle
    # disconnect cancellation grabs
    stream_key: str | None = None
    stream_sent_tokens: int = 0
    stream_sent_chars: int = 0
    stream_first_emit: float | None = None
    stream_last_emit: float | None = None
    stream_emits: int = 0
    stream_stalls: int = 0
    stream_closed: bool = False
    stream_tbt: TbtDigest | None = None
    # counted once as a cancelled stream when the engine frees its slot
    stream_cancel_counted: bool = False
    # tiered prefix store: True once admission stashed this request for a
    # T2 hydration; it never stashes twice, so a failed or timed-out
    # hydration falls back to cold compute
    hydrate_attempted: bool = False
    # KV handoff: admitted through import_handoff on a decode-role engine
    # (its KV arrived over the wire; admission skipped prefill)
    imported: bool = False
    # multi-LoRA: the adapter the request named ("" = base model), the
    # T0 row resolved at admission, whether it stashed once for a T2
    # hydration, and whether it holds a pin on the row
    adapter: str = ""
    adapter_row: int = 0
    adapter_hydrate_attempted: bool = False
    adapter_pinned: bool = False
    # the journey ledger's and the journal's key: the trace id when the
    # request is traced, a fresh trace-id-shaped id otherwise (warmup
    # probes have none); the trace is the ambient context at submit (the
    # wire header's on an import), the parent of the request's spans
    journey_id: str | None = None
    trace: TraceContext | None = None
    # the times an import's scatter failed on an allocator refusal and was
    # retried
    import_retries: int = 0
    # an import's generated-token count on arrival, and whether its first
    # new token was recorded (the decode-admission segment's end)
    import_base_tokens: int = 0
    first_step_noted: bool = False

    @property
    def context_tokens(self) -> list[int]:
        """The model context: the prompt plus everything generated so far.
        Equals ``prompt_tokens`` until a preemption; a resumed request
        re-prefills it to rebuild its KV, so a greedy continuation equals
        the unpreempted one (the generated tokens and the request's sampling
        settings are the whole snapshot)."""
        if not self.generated:
            return self.prompt_tokens
        return self.prompt_tokens + self.generated


def _exemplar(request: "_Request") -> str | None:
    """The trace id a traced request stamps on the buckets it lands in (its
    journey id); None for untraced traffic, which records no exemplar."""
    return request.journey_id if request.trace is not None else None


def _normalize_stop(value) -> list[str]:
    """A string becomes a singleton list, falsy entries drop, non-string
    entries are coerced to strings."""
    if not value:
        return []
    if isinstance(value, str):
        value = [value]
    return [s if isinstance(s, str) else str(s) for s in value if s]


def _bucket(n: int, lo: int = 32, hi: int = 32768) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def _pow2(n: int) -> int:
    """Smallest power of two >= n: the JAX engine pads a prefill batch to
    it, so program ids name that row count and censuses compare."""
    p = 1
    while p < n:
        p *= 2
    return p


def _dev_cache_cap() -> int:
    try:
        return max(1, int(os.environ.get("LS_TPU_DEV_CACHE_CAP", "32")))
    except ValueError:
        return 32


class _DeviceLru:
    """Content-keyed device-upload cache with an LRU bound (the JAX
    engine's): the block tables and the sampler tuple change rarely between
    chunks, and an upload from the host is a copy on the stream. The bound
    and the eviction counter (``stats()["device-cache"]``) keep a
    long-lived engine from holding one device copy per content it ever
    saw. Touched from the dispatch thread and read by ``stats()`` on the
    loop, so the bookkeeping sits behind a lock that is never held across
    the upload."""

    def __init__(self, cap: int | None = None):
        self.cap = cap if cap is not None else _dev_cache_cap()
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_put(self, key: bytes, factory: Callable[[], Any]) -> Any:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry
            self.misses += 1
        entry = factory()
        with self._lock:
            self._entries[key] = entry
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)
                self.evictions += 1
        return entry

    def device_bytes(self) -> int:
        """Bytes held by the cached entries (the memory ledger's
        ``device-lru`` and ``sampler-state`` owners); a snapshot read."""
        return sum(tree_device_bytes(e) for e in list(self._entries.values()))

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "size": len(self._entries),
                "cap": self.cap,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


class TorchServingEngine:
    """The serving engine of the port. ``params=None`` means the weights of
    ``config.checkpoint`` when set (an HF-format Llama or Mixtral directory,
    see :mod:`langstream_tpu_torch.models.checkpoints`), else random init
    from ``config.seed`` (``init_llama_params_q8``/``init_moe_params_q8``
    for ``quantize: int8``, else ``init_llama_params``/``init_moe_params``);
    otherwise ``params`` is a port parameter tree (see
    :func:`langstream_tpu_torch.models.convert.params_from_numpy`). Trees
    not yet int8 are quantized here when the config asks for int8.

    :meth:`get_or_create` shares one engine per ``(config, device)`` in the
    process, as the JAX engine does per config: every agent of an
    application that names the same resource reaches the same engine.
    ``streams`` is the stream registry a ``stream-key`` registers with
    (``None``: the port's :data:`~langstream_tpu_torch.serving.streaming.STREAMS`);
    the engine calls only its ``register(key, future, loop)``."""

    _instances: dict[tuple, "TorchServingEngine"] = {}
    _instances_lock = threading.Lock()

    @classmethod
    def get_or_create(cls, config: ServingConfig, device="cuda",
                      streams: StreamCancelRegistry | None = None) -> "TorchServingEngine":
        """The process's engine for ``(config, device, streams)``, made on
        first use. An engine that was closed, or whose event loop has closed
        (a finished ``asyncio.run``), is replaced: its loop task and events
        cannot serve another loop."""
        _check_supported(config)  # before hashing: rejected keys hold dicts
        key = (config, str(torch.device(device)), streams or STREAMS)
        with cls._instances_lock:
            engine = cls._instances.get(key)
            if engine is None or engine._stale():
                if engine is not None:
                    engine._executor.shutdown(wait=False)
                    engine._fetch_executor.shutdown(wait=False)
                engine = cls._instances[key] = cls(config, device=device,
                                                   streams=streams)
            return engine

    @classmethod
    def reset_instances(cls) -> None:
        """Forget every shared engine (the caller closes them)."""
        with cls._instances_lock:
            cls._instances.clear()

    def __init__(self, config: ServingConfig, *, device="cuda",
                 params: dict | None = None,
                 streams: StreamCancelRegistry | None = None,
                 lockstep_role: str | None = None):
        _check_supported(config)
        self.device = require_device(device, "TorchServingEngine")
        self._init_mesh(config, lockstep_role)
        self.config = config
        self.is_moe = config.model in _MOE_MODELS
        factory = (_MOE_MODELS if self.is_moe else _MODEL_CONFIGS)[config.model]
        mc = factory(max_seq_len=config.max_seq_len)
        if config.model_dtype is not None:
            mc = dataclasses.replace(mc, dtype=_DTYPES[config.model_dtype])
        self.model_config = mc
        self.tokenizer: Tokenizer = load_tokenizer(config.tokenizer)
        if self.tokenizer.vocab_size > mc.vocab_size:
            raise ValueError(
                f"tokenizer vocab {self.tokenizer.vocab_size} exceeds model "
                f"vocab {mc.vocab_size}"
            )
        defaults = ServingConfig()
        ignored = {
            name: getattr(config, name) for name in _LATENCY_ONLY
            if getattr(config, name) != getattr(defaults, name)
        }
        if ignored:
            log.info(
                "latency-only settings accepted, not acted on by this engine "
                "(ROADMAP.md Queue 1 item 4): %s", ignored,
            )
        if config.speculative_drafts > 0 and config.kv_quantize == "int8":
            # verify quantizes K/V at other commit boundaries than the
            # decode chunk: greedy streams may differ at near-tie argmaxes
            log.info(
                "speculative-drafts with kv-quantize=int8: greedy streams "
                "may diverge from non-speculative runs (int8 KV commit-"
                "boundary quantization differs under the verify path)"
            )
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(config.seed)
        self._init_model(params)
        # lockstep: the dispatch counter; on a leader whose caller asks for
        # it (a dict here), the tokens each dispatch sampled by dispatch
        # number, to hold against the followers' (the demo and the tests)
        self._ls_seq = 0
        self._ls_carry = None  # the last decode chunk's device tokens
        self.lockstep_tokens: dict[int, tuple[str, np.ndarray]] | None = None

        self.slots = [_Slot() for _ in range(config.slots)]
        # admission: FIFO, or the QoS scheduler under a qos section
        self.scheduler = make_scheduler(config.qos)
        self._qos_enabled = config.qos is not None and config.qos.enabled
        self.streams = streams or STREAMS
        self._wake = asyncio.Event()
        self._stop = False
        self._loop_task: asyncio.Task | None = None
        # the event loop of the first request: the engine's task, event and
        # warmup belong to it (get_or_create replaces the engine once it
        # has closed)
        self._event_loop: asyncio.AbstractEventLoop | None = None
        self._warmup_task: asyncio.Task | None = None
        self._warmup_result: dict | None = None
        self.deadline_sheds = 0
        # the latency record of each served request (the JAX engine's keys:
        # queue_wait, prefill, ttft, decode, tokens, tbt_*), bounded; the
        # admission estimate reads its recent prefill times
        self.request_timings: deque[dict[str, float]] = deque(maxlen=4096)
        # one dispatch thread: device work is serialised, asyncio stays live
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-engine"
        )
        self._lengths = np.zeros(config.slots, dtype=np.int32)
        self._current = np.zeros(config.slots, dtype=np.int64)
        self._temps = np.zeros(config.slots, dtype=np.float32)
        self._topks = np.zeros(config.slots, dtype=np.int32)
        self._topps = np.ones(config.slots, dtype=np.float32)
        self._pres = np.zeros(config.slots, dtype=np.float32)
        self._freq = np.zeros(config.slots, dtype=np.float32)
        self._pending_emits: list = []
        self._finished_requests: list = []
        self.total_generated = 0
        self.completed_requests = 0
        self._decode_dispatches = 0
        self._decode_fetches = 0
        self._decode_steps = 0
        self._decode_s = 0.0
        self._prefill_calls = 0
        self._continue_calls = 0
        # prefix cache: admissions that reused cached blocks, and the
        # prompt tokens they did not prefill
        self.prefix_hits = 0
        self.prefix_tokens = 0
        # speculation: verify steps, accepted and rejected real drafts, and
        # the one-fetch ledger (one dispatch, one packed fetch per step)
        self.spec_steps = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self._spec_dispatches = 0
        self._spec_fetches = 0
        # the device context rows the drafter reads, (slots, S + 1) int32
        # with a sentinel column, made at the first speculative step and
        # touched only on the dispatch thread; the host ledger counts the
        # leading entries of each row known to hold the slot's current
        # request (plain decode chunks leave it stale, release resets it)
        self._ctx_dev: torch.Tensor | None = None
        self._ctx_synced = np.zeros(config.slots, dtype=np.int64)
        # measured-uplift auto-disable: rolling (tokens, seconds) windows of
        # speculative steps and of plain K=1 calibration chunks; uplift =
        # speculative tok/s over plain tok/s, below 1 over a full window
        # turns speculation off until _spec_retry_plain plain decode chunks
        # have run
        win = max(int(os.environ.get("LS_TPU_SPEC_UPLIFT_WINDOW", "32")), 1)
        self._spec_window: deque = deque(maxlen=win)
        self._plain_window: deque = deque(maxlen=win)
        self._spec_cal_every = int(os.environ.get("LS_TPU_SPEC_CALIBRATE_EVERY", "32"))
        self._spec_retry_plain = int(os.environ.get("LS_TPU_SPEC_RETRY_CHUNKS", "256"))
        self._spec_steps_since_cal = 0
        self._spec_auto_disabled = False
        self._spec_plain_since_disable = 0
        self._spec_last_uplift: float | None = None
        self._spec_flips = 0  # auto-disables plus re-enables
        # decode chunks dispatched in the light and the heavy regime, and
        # the host seconds spent launching decode chunks
        self._light_chunks = 0
        self._heavy_chunks = 0
        self._decode_launch_s = 0.0
        # the pipelined loop: the config key, with LS_TPU_PIPELINE=0 as the
        # escape hatch to the sequential loop (the JAX engine's rule). The
        # wait for chunk N's copy runs on a second thread, so the host works
        # on chunk N while the dispatch thread still launches chunk N+1 (an
        # eager chunk's launches take about its device time)
        self._pipeline_on = config.pipeline and (
            os.environ.get("LS_TPU_PIPELINE", "1") != "0"
        )
        self._fetch_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-fetch")
        # a dispatched, unprocessed decode chunk carried across the burst
        # boundary, so the admission prefill is queued behind it: (out,
        # active slots, their requests at dispatch, K, program id)
        self._pending_chunk: tuple | None = None
        # set while no decode burst runs and no chunk is pending
        self._settled = asyncio.Event()
        self._settled.set()
        # inside a pipelined burst, finished slots' blocks are released when
        # the burst ends: an in-flight chunk still commits through the
        # tables taken at its dispatch, and a block handed to a live slot
        # mid-burst would take that stale commit on top of its rows
        self._defer_release = False
        self._deferred_releases: list[int] = []
        # device-upload caches (content-keyed, LRU-bounded) and the two
        # pinned host buffers of the packed fetch (at most two chunks are
        # in flight)
        self._tables_dev_cache = _DeviceLru()
        self._sampler_dev_cache = _DeviceLru()
        self._fetch_bufs: list[torch.Tensor | None] = [None, None]
        self._fetch_turn = 0
        # observability planes: flight recorder, profiler hooks, and the
        # per-program attribution ledger with the static facts it needs
        self.flight = FlightRecorder(slots=config.slots)
        self.profiler = ProfilerHooks()
        self.attribution = ProgramLedger()
        self._init_attribution()
        # health plane: the watchdog is beaten at every flight boundary and
        # judged (wait-free) by health(); the SLO tracker exists only with a
        # declared slo section
        self.watchdog = EngineWatchdog(wedge_window_s=config.wedge_window_s)
        self.slo = SloTracker(config.slo) if config.slo is not None else None
        # delivery plane: counters and per-class digests stay empty on
        # non-streaming engines; one TBT burn tracker per class that
        # declares tbt-p99-s, windowed like the slo section when there is one
        self.stream_emits_total = 0
        self.stream_stalls_total = 0
        self.stream_cancels_total = 0
        self.stream_reclaims_total = 0
        self._stream_tbt_by_class: dict[str, TbtDigest] = {}
        self._stream_slo: dict[str, SloTracker] = {}
        # slots freed by a cancelled stream whose blocks are still held by a
        # pipelined burst: counted reclaimed when the release happens
        self._reclaim_pending: set[int] = set()
        if config.streaming and config.qos is not None:
            windows = config.slo or SloSpec()
            for policy in config.qos.classes:
                if policy.tbt_p99_s is None:
                    continue
                self._stream_slo[policy.name] = SloTracker(SloSpec(
                    objectives=(SloObjective("tbt", 0.99, policy.tbt_p99_s * 1000.0),),
                    fast_window_s=windows.fast_window_s,
                    slow_window_s=windows.slow_window_s,
                    fast_burn=windows.fast_burn,
                ))
        # KV handoff (pool roles): exports are finished-prefill payloads
        # keyed by request id awaiting pickup (bounded: an abandoned
        # handoff must not pin host memory for good); imports queue here
        # and land at the loop's safe point, like admission. The bytes in
        # transit are the memory ledger's ``in-transit`` owner.
        self._pool_role = config.pool_role
        self._exports: "OrderedDict[str, dict[str, Any]]" = OrderedDict()
        self._export_seq = 0
        self._export_cap = max(8, int(os.environ.get("LS_TPU_KV_EXPORT_CAP", "256") or 256))
        self._pending_imports: deque = deque()
        self._kv_in_transit_bytes = 0
        self.kv_exports_total = 0
        self.kv_exports_evicted = 0
        self.kv_imports_total = 0
        self.kv_import_sheds = 0
        self.kv_export_bytes = 0
        self.kv_import_bytes = 0
        # device-survival plane. A default engine has no injector (each
        # seam is one attribute test) and no journal; the recovery probe is
        # one None test per loop pass. Fired faults hand off to the loop
        # through a deque: the seams run on the loop, the dispatch and fetch
        # threads and the hydrators, the flight ring is the loop's.
        plans = tuple(config.faults) or plans_from_env()
        self._faults: FaultInjector | None = FaultInjector(plans) if plans else None
        self._fault_fired: deque = deque()
        self.pool_shrinks = 0
        self.pool_restores = 0
        self.shrink_preempted = 0
        # the cross-replica failure domain (serving/handoff.py): chainer
        # re-offers and local fallbacks, and completions past their deadline
        self.handoff_retries = 0
        self.handoff_fallbacks = 0
        self.deadline_overruns = 0
        self._shrink_recover_at: float | None = None
        # requeues and sheds made at a catch site (the chunked-prefill grow,
        # an import's scatter) before the loop's shrink pass: the pass
        # counts them as adaptation, so a pool already at its budget floor
        # does not fall through to failing every request in flight
        self._shrink_inline_preempted = 0
        self._shrink_inline_shed = 0
        self.journal: RequestJournal | None = None
        self._journal_replay_pending: list = []
        if config.journal_dir:
            self.journal = RequestJournal(
                config.journal_dir,
                on_evict=lambda rid: self.flight.event("journal-evict", request=rid),
                # entries of another model or tokenizer are refused at
                # replay: their token ids mean nothing here
                fingerprint={"model": config.model,
                             "tokenizer": config.tokenizer or "byte"},
            )
            self._journal_replay_pending = self.journal.pending()
        # a prefill pool's exports keep their journal entry live until the
        # decode side answers (:meth:`handoff_settled`): export id -> id
        self._handoff_journal: "OrderedDict[str, str]" = OrderedDict()
        # a prefill pool's own exports (export id -> prompt digest), the
        # only payloads its local fallback admits; bounded like the mapping
        self._own_exports: "OrderedDict[str, str]" = OrderedDict()
        # incident capture (serving/incident.py): breach-triggered evidence
        # bundles. None (the default, and "") keeps every observe path one
        # attribute test
        self.incidents: IncidentRecorder | None = None
        if config.incident_dir:
            self.incidents = IncidentRecorder(
                config.incident_dir,
                on_evict=lambda bid: self.flight.event("incident-evict", bundle=bid),
            )
        # drain: admission closed, the one preempt pass at the safe point
        # pending or done, and the counts of the drain in progress or done
        self._draining = False
        self._drain_pass_done = False
        self._drain_requeued = 0
        self._drain_shed = 0
        self._drain_base_completed = 0
        self._drain_report: dict[str, Any] | None = None
        # tiered prefix store: T1 host RAM and T2 object storage under the
        # T0 prefix cache (paged engines with the cache on, checked above).
        # Requests waiting on a T2 hydration are stashed off the scheduler,
        # so they never block the head of the queue.
        self.prefix_store: PrefixStore | None = None
        self._prefix_hydrating: list = []  # (request, deadline_m, digests)
        self.prefix_t0_evictions = 0
        self.prefix_demote_fetches = 0
        self.prefix_demote_s = 0.0
        if (config.prefix_store is not None and config.prefix_store.enabled
                and self.block_mgr is not None and config.prefix_cache):
            self.prefix_store = PrefixStore(
                config.prefix_store, fingerprint=self.kv_fingerprint(),
                block_bytes=self._kv_block_bytes,
                rows_per_block=self.paged_layout.block_size,
                fault_injector=self._faults,
            )
            # pool-pressure evictions bypass demotion: record the loss
            self.block_mgr.on_prefix_evict = self._note_prefix_pool_evict
        # tiered multi-LoRA adapter store (serving/adapters.py): T0 rows of
        # the stacked device A/B buffers, T1 host RAM, T2 object storage.
        # Requests whose adapter is hydrating are stashed off the
        # scheduler, as for the prefix store. Without an enabled section
        # the engine has no store, no buffers and computes no delta.
        self.adapter_store: AdapterStore | None = None
        self._adapter_hydrating: list = []  # (request, deadline_m, name)
        self.adapter_refusals = 0  # cold refusals (unknown or timed out)
        # the stacked buffers (L, 1 + t0-entries, d_in, rank) and (L, 1 +
        # t0-entries, rank, d_out) in the model dtype: row 0 stays zero
        # (adapter-less slots), rows 1.. back T0. A row is written in place
        # on the dispatch thread, so on the stream after every chunk
        # dispatched before it; T0 evicts only unpinned rows, so no live
        # slot reads a row while it is written. ``_ad_rows`` is the
        # loop-side slot -> row mirror, snapshotted at every dispatch.
        self._ad_layers: dict[str, torch.Tensor] | None = None
        self._ad_rows: np.ndarray | None = None
        if config.adapter_store is not None and config.adapter_store.enabled:
            self.adapter_store = AdapterStore(
                config.adapter_store, fingerprint=self.adapter_fingerprint(),
                entry_bytes=self._adapter_entry_bytes(), fault_injector=self._faults,
            )
            n_rows = config.adapter_store.t0_entries + 1
            self._ad_layers = {
                k: torch.zeros((mc.layers, n_rows, *shape), dtype=mc.dtype,
                               device=self.device)
                for k, shape in self._adapter_factor_shapes().items()
            }
            self._ad_rows = np.zeros(config.slots, dtype=np.int32)
        self._init_metrics()

    # ------------------------------------------------------------------
    # model + cache
    # ------------------------------------------------------------------

    def _init_mesh(self, config: ServingConfig, lockstep_role: str | None) -> None:
        """Under ``mesh``: lead the lockstep group (rank 0 of a joined
        ``torch.distributed`` world of more than one rank; the followers
        must be connected before the mesh's groups are made, which every
        rank joins), make this rank's mesh and take this rank's card."""
        self.mesh = None
        self._dp_span = None  # the slots this rank's dp replica serves
        self._dp_prefill_split = False  # prefill splits over dp too
        # the order admission fills free slots in: under a dp split the
        # replicas take turns, so a light load spreads over them
        self._slot_order = list(range(config.slots))
        self._lockstep = None
        self.lockstep_role = lockstep_role
        if not config.mesh:
            return
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        if lockstep_role != "follower" and world > 1:
            if rank != 0:
                raise ValueError(
                    f"rank {rank} of a lockstep group replays the leader's "
                    f"dispatches: build it through LockstepFollower")
            port = int(os.environ.get("LS_LOCKSTEP_PORT", "0")) or None
            self._lockstep = LockstepLeader(
                {"config_json": json.dumps(config.to_dict())},
                expected_followers=world - 1, port=port,
                token=os.environ.get("LS_LOCKSTEP_TOKEN", ""),
            )
            self.lockstep_role = "leader"
            log.info("lockstep leader on :%d awaiting %d followers",
                     self._lockstep.port, world - 1)
            self._lockstep.wait_ready()
        self.mesh = make_mesh(dict(config.mesh))
        self._dp_span = self.mesh.dp_rows(config.slots)
        if self._dp_span is not None:
            per = self._dp_span[1] - self._dp_span[0]
            self._slot_order.sort(key=lambda slot: (slot % per, slot // per))
            # a slot's decode and verify rows live in its replica's cache
            # alone; the prefix cache hands prompt blocks across slots, so
            # with it every replica prefills every row (the prompt rows
            # then lie in every replica's pool)
            self._dp_prefill_split = not (config.kv_layout == "paged"
                                          and config.prefix_cache)
        self.device = rank_device(self.device, self.mesh.rank)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def mesh_section(self) -> dict[str, Any] | None:
        """The mesh, this rank's place in it, its backend and why, the
        lockstep role, the slots its dp replica serves, its weights' device
        bytes and the device bytes their placement peaked at (None on the
        CPU); None without a mesh."""
        if self.mesh is None:
            return None
        return {**self.mesh.describe(), "lockstep-role": self.lockstep_role,
                "lockstep-dispatches": self._ls_seq,
                "attention-split": bool(self.model_config.shard.attention),
                "dp-slots": None if self._dp_span is None else list(self._dp_span),
                "dp-prefill-split": self._dp_prefill_split,
                "weights-bytes": self._weights_bytes,
                "load-peak-bytes": self._load_peak_bytes}

    def _warn_random_init(self) -> None:
        log.warning(
            "no checkpoint configured for model %r: using random-init "
            "weights (offline/dev mode)", self.config.model,
        )

    def _place_shards(self, params: dict | None, mc, load, init, int8: bool) -> dict:
        """This rank's shards on its device, leaf by leaf, never the whole
        tree there: each leaf of the checkpoint (read leaf by leaf on the
        host) or of the random init (drawn on the device, the draws a
        one-rank engine's) is, in the model dtype, quantized (int8; a
        stacked weight one layer at a time on the device, so the scales are
        the whole tree's) and sharded, and only the shard is kept. The peak
        is the shards plus one whole leaf."""
        specs = self._param_specs(mc)
        axes = (MOE_QUANT_AXES if self.is_moe else LLAMA_QUANT_AXES) if int8 else {}
        mesh, dev = self.mesh, self.device

        def shard(leaf, spec):
            return shard_tree(leaf, quantize_specs(spec, leaf), mesh)

        def place(path, leaf):
            spec = specs
            for key in path.split("."):
                spec = spec[key]
            axis = axes.get(path)
            if axis is None or isinstance(leaf, QTensor):
                return _to_device(shard(leaf, spec), dev)  # only the shard moves
            if not path.startswith("layers."):
                return shard(quantize_tensor(leaf.to(dev), axis), spec)
            per_layer = PartitionSpec(*tuple(spec)[1:])
            parts = [shard(quantize_tensor(w.to(dev), axis - 1), per_layer) for w in leaf]
            return QTensor(q=torch.stack([t.q for t in parts]),
                           s=torch.stack([t.s for t in parts]), dtype=leaf.dtype)

        if params is not None:
            raise ValueError(
                "under a mesh every rank builds its own weights from the "
                "configuration (checkpoint or seed): params cannot be passed")
        if self.config.checkpoint:
            return load(self.config.checkpoint, mc, place=place)
        self._warn_random_init()
        return init(mc, self._generator, device=dev, place=place)

    def _param_specs(self, mc) -> dict:
        """The model's specs with absent mesh axes removed: only ``ep`` may
        be absent (the experts are then replicated, with a warning); any
        other absent axis is a misconfigured mesh (the JAX engine's
        ``_present`` rule)."""
        axes = set(self.mesh.axis_names)
        base = moe_param_specs(mc) if self.is_moe else llama_param_specs(mc)

        def present(entry):
            if entry is None:
                return None
            names = entry if isinstance(entry, tuple) else (entry,)
            for a in names:
                if a in axes:
                    continue
                if a != "ep":
                    raise ValueError(
                        f"model {self.config.model!r} shards over mesh "
                        f"axis {a!r} but the configured mesh has axes "
                        f"{sorted(axes)}; add {a!r} to the mesh"
                    )
                log.warning("mesh has no 'ep' axis: expert weights will be "
                            "replicated on every device")
            kept = tuple(a for a in names if a in axes)
            if isinstance(entry, tuple):
                return kept or None
            return kept[0] if kept else None

        def walk(tree):
            if isinstance(tree, dict):
                return {k: walk(v) for k, v in tree.items()}
            return PartitionSpec(*(present(e) for e in tree))

        return rank_specs(walk(base), mc, self.mesh)

    def _dense_slots(self) -> int:
        """The slots this rank's dense cache holds: its dp replica's (the
        cache spec), or all of them when dp does not split them."""
        span = self._dp_span
        return self.config.slots if span is None else span[1] - span[0]

    def _dp_rows(self, slot_ids: np.ndarray) -> np.ndarray | None:
        """The rows of a prefill that this rank's dp replica runs: those of
        the slots it serves. None when dp does not split the slots (every
        rank runs every row, the JAX rule's degradation)."""
        if self._dp_span is None:
            return None
        lo, hi = self._dp_span
        return np.flatnonzero((slot_ids >= lo) & (slot_ids < hi))

    def _dp_gather(self, packed: torch.Tensor, rows, batch: int, segments) -> torch.Tensor:
        """A dispatch's packed int32 output made whole from each replica's
        ``rows`` (a slice or an index tensor into a batch of ``batch``):
        each segment ``(lead, width)`` holds ``(lead, rows, width)`` values;
        zero-padded to the batch and summed over ``dp``, exact since every
        row is one replica's. One collective per dispatch."""
        n_rows = rows.stop - rows.start if isinstance(rows, slice) else len(rows)
        whole, off = [], 0
        for lead, width in segments:
            n = lead * n_rows * width
            seg = packed[off:off + n].view(lead, n_rows, width)
            off += n
            full = seg.new_zeros((lead, batch, width))
            full[:, rows] = seg
            whole.append(full.reshape(-1))
        return self.mesh.sum(torch.cat(whole), "dp", tag="dp-rows")

    @torch.no_grad()
    def _init_model(self, params: dict | None) -> None:
        mc, dev = self.model_config, self.device
        int8 = self.config.quantize == "int8"
        # the routed expert FFN for MoE models; None: the dense SwiGLU
        self._ffn = moe_serving_ffn(mc) if self.is_moe else None
        if self.is_moe:
            load, init, init_q8, quantize = (
                load_moe_checkpoint, init_moe_params, init_moe_params_q8,
                quantize_moe_params)
        else:
            load, init, init_q8, quantize = (
                load_llama_checkpoint, init_llama_params, init_llama_params_q8,
                quantize_llama_params)
        if self.mesh is not None:
            cuda = dev.type == "cuda"
            if cuda:  # the device bytes the placement peaks at, reported
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            params = self._place_shards(params, mc, load, init_q8 if int8 else init, int8)
            self._load_peak_bytes = (torch.cuda.max_memory_allocated(dev) - base
                                     if cuda else None)
            self.global_model_config = mc
            # the model runs on one dp replica's rows: its mesh has no dp
            replica = self.mesh.replica()
            self.model_config = mc = local_config(mc, replica)
            self._ffn = moe_serving_ffn(mc, mesh=replica) if self.is_moe else None
        else:
            if params is None and self.config.checkpoint:
                # loaded on the CPU in the model dtype, then (int8)
                # quantized: the JAX engine's order, so the bf16 rounding
                # happens before the quantizer as there. A MoE tree is
                # quantized before it moves: an int8 Mixtral-8x7B fits the
                # card, a bf16 one not
                params = load(self.config.checkpoint, mc)
                if int8 and self.is_moe:
                    params = quantize(params)
            if params is None:
                self._warn_random_init()
                params = (init_q8 if int8 else init)(mc, self._generator, device=dev)
            else:
                params = _to_device(params, dev)
                if int8 and not isinstance(params["layers"]["wq"], QTensor):
                    params = quantize(params)
        self.params = params
        self.block_mgr = None
        self.paged_layout = None
        if self.config.kv_layout == "paged":
            self.paged_layout = PagedLayout.for_model(
                mc.max_seq_len, self.config.slots,
                block_size=self.config.kv_block_size,
                hbm_fraction_of_dense=self.config.kv_pool_fraction,
                num_blocks=self.config.kv_pool_blocks,
            )
            self.block_mgr = BlockManager(self.paged_layout, self.config.slots)
            init_pool = (
                init_paged_kv_cache_int8 if self.config.kv_quantize == "int8"
                else init_paged_kv_cache
            )
            self.cache_k, self.cache_v = init_pool(mc, self.paged_layout, device=dev)
        elif self.config.kv_quantize == "int8":
            # (L, slots, S, Kh, D) int8 rows and (L, slots, S, Kh) scales: the
            # dense decode views them as the int8 pool layout with no copy
            # (under a mesh this rank's slots on dp and heads on tp)
            self.cache_k, self.cache_v = init_kv_cache_int8(
                mc, self._dense_slots(), device=dev)
        else:
            shape = (mc.layers, self._dense_slots(), mc.max_seq_len,
                     mc.kv_heads, mc.head_dim)
            self.cache_k = torch.zeros(shape, dtype=mc.dtype, device=dev)
            self.cache_v = torch.zeros(shape, dtype=mc.dtype, device=dev)

    # ------------------------------------------------------------------
    # Prometheus plane (core/metrics.py)
    # ------------------------------------------------------------------

    def _init_metrics(self) -> None:
        """Register the JAX engine's ``langstream_serving_*`` series under
        its conditions, so a configuration's scrape surface is the JAX
        engine's: the always-on families, then the SLO, QoS, split-pool,
        prefix-tier, adapter-tier, paged-pool and journal families only
        when those planes exist. ``breaker_open_replicas``,
        ``deadline_shed_total`` and the per-class streaming TBT histograms
        register at first use. Every update site feeds a host number the
        engine already holds: no device read, no fetch."""
        cfg = self.config
        # the seam is read once, here: every series of this engine goes to
        # one registry
        self._reporter_cls = metrics.REPORTER
        reporter = self._reporter = self._reporter_cls(prefix="langstream_serving",
                                                       agent_id=cfg.model)
        self._m_tokens = reporter.counter(
            "tokens_generated_total", "tokens generated by the engine")
        self._m_tokens_seen = 0  # total_generated already counted
        self._m_requests = reporter.counter(
            "requests_completed_total", "completed generation requests")
        self._m_ttft = reporter.gauge(
            "last_ttft_seconds", "time to first token of the last request")
        # a traced request stamps its journey id on its TTFT bucket
        self._m_ttft_hist = reporter.exemplar_histogram(
            "ttft_seconds", "engine time-to-first-token (enqueue to token 1)")
        self._m_queue_wait_hist = reporter.histogram(
            "queue_wait_seconds", "enqueue to slot admission")
        self._m_active = reporter.gauge("slots_active", "decode slots currently generating")
        self._m_queued = reporter.gauge("queued_requests", "requests awaiting a free slot")
        self._m_prefix_hits = reporter.counter(
            "prefix_cache_hits_total", "admissions that adopted cached prefix blocks")
        self._m_prefix_tokens = reporter.counter(
            "prefix_cache_tokens_reused_total",
            "prompt tokens served from cached prefix blocks (prefill skipped)")
        self._m_spec_steps = reporter.counter(
            "speculative_steps_total", "speculative verify steps run")
        self._m_spec_accepted = reporter.counter(
            "speculative_drafts_accepted_total",
            "draft tokens accepted by verify steps (free extra tokens)")
        self._m_slo_burn: dict[str, Any] = {}
        self._m_slo_budget: dict[str, Any] = {}
        if cfg.slo is not None:
            for objective in cfg.slo.objectives:
                self._m_slo_burn[objective.name] = reporter.gauge(
                    f"slo_burn_rate_{objective.name}",
                    f"fast-window error-budget burn rate for the {objective.name} "
                    f"objective (1.0 = budget exhausts exactly at the window's end)")
                self._m_slo_budget[objective.name] = reporter.gauge(
                    f"slo_budget_remaining_{objective.name}",
                    f"slow-window error budget remaining for the {objective.name} "
                    f"objective (1 - slow burn; negative = overspent)")
        self._m_tbt_hist: dict[str, Any] = {}
        self._m_step_hist = {
            "decode": reporter.histogram(
                "decode_step_seconds", "wall time per dispatched decode chunk"),
            "prefill": reporter.histogram(
                "prefill_step_seconds", "wall time per dispatched prefill batch"),
            "verify": reporter.histogram(
                "verify_step_seconds", "wall time per speculative verify step"),
        }
        self._m_host_overhead = reporter.histogram(
            "host_overhead_seconds",
            "host-side share of each dispatched burst (wall - device wait)")
        self._m_kv_used = reporter.gauge(
            "kv_pool_used_ratio",
            "paged KV block-pool RESERVED fraction (0-1): the admission pressure "
            "that produces no-kv-blocks, not physical fullness")
        self._m_stall = {
            reason: reporter.counter(
                f"admission_stall_{reason.replace('-', '_')}_seconds_total",
                f"seconds admission could not proceed: {reason} (accrues while the "
                f"engine is busy decoding too — queue pressure, not engine "
                f"idleness; the flight rollup's stall_ms is the idle component)")
            for reason in ("no-free-slot", "no-kv-blocks", "prefill-in-flight",
                           "queue-empty")
        }
        self._m_spec_rejected = reporter.counter(
            "speculative_drafts_rejected_total", "draft tokens rejected by verify steps")
        self._m_spec_ratio = reporter.gauge(
            "speculative_accept_ratio", "accepted / drafted ratio over the engine's life")
        self._m_spec_uplift = reporter.gauge(
            "speculative_uplift",
            "rolling measured speculative-vs-plain tokens/s ratio (the auto-disable "
            "verdict input; 0 until the first full window)")
        self._m_recompiles = reporter.counter(
            "recompiles_total",
            "jit program variants/shapes compiled (bucket or sampler-mode misses; "
            "each is a potential mid-traffic convoy)")
        # the (kind, shape key) pairs dispatched so far, and the sampler
        # modes of the plain prefills (the JAX engine's prefill variants)
        self._compiled_shapes: set = set()
        self._prefill_modes: set = set()
        self._m_class_depth: dict[str, Any] = {}
        self._m_shed = self._m_preempted = None
        self._m_resume_hist = self._m_preempt_hist = None
        if self._qos_enabled:
            self._m_class_depth = {
                cls: reporter.gauge(f"qos_queue_depth_{cls}",
                                    f"requests queued in the {cls} priority class")
                for cls in PRIORITY_CLASSES
            }
            self._m_shed = reporter.counter(
                "qos_shed_total",
                "requests refused by QoS policy (tenant throttle or a full class queue)")
            self._m_preempted = reporter.counter(
                "qos_preempted_total",
                "running requests preempted under KV pressure (snapshot + requeue for "
                "transparent resume)")
            self._m_resume_hist = reporter.histogram(
                "qos_resume_seconds",
                "preemption → re-admission wall time (how long preempted work waited "
                "to resume)")
            self._m_preempt_hist = reporter.histogram(
                "qos_preempted_run_seconds",
                "how long a victim had been running when preempted (the decode "
                "progress the preemption put at risk)")
        self._m_handoff_retries = self._m_handoff_fallbacks = None
        self._m_kv_export_hist = self._m_kv_import_hist = None
        self._m_kv_export_bytes = self._m_kv_import_bytes = None
        self._m_deadline_shed = self._m_breaker_open = None
        if self._pool_role != "combined":
            self._m_handoff_retries = reporter.counter(
                "handoff_retries_total",
                "KV handoff offers re-routed to another decode replica after a "
                "timeout/refusal/shed (serving/handoff.py)")
            self._m_handoff_fallbacks = reporter.counter(
                "handoff_fallbacks_total",
                "KV handoffs decoded LOCALLY after the re-offer cap (every decode "
                "replica dead, held, or refusing)")
            self._m_kv_export_hist = reporter.exemplar_histogram(
                "kv_export_seconds",
                "device gather + serialization wall time per KV handoff export "
                "(prefill pool)")
            self._m_kv_import_hist = reporter.exemplar_histogram(
                "kv_import_seconds",
                "block allocation + device scatter wall time per KV handoff import "
                "(decode pool)")
            self._m_kv_export_bytes = reporter.counter(
                "kv_export_bytes_total",
                "serialized KV handoff bytes exported to decode replicas")
            self._m_kv_import_bytes = reporter.counter(
                "kv_import_bytes_total",
                "serialized KV handoff bytes imported from prefill replicas")
        # refreshed where the attribution section is computed
        self._m_hbm_owner = {
            owner: reporter.gauge(
                f"hbm_bytes_{owner.replace('-', '_')}",
                f"resident HBM bytes attributed to {owner} (serving/attribution.py "
                f"memory ledger; slack = detected limit minus every accounted owner)")
            for owner in ("weights", "kv-pool", "sampler-state", "device-lru",
                          "in-transit", "slack")
        }
        self._m_prefix_tier: dict[str, Any] = {}
        if self.prefix_store is not None:
            self._m_prefix_tier = {
                "t0_bytes": reporter.gauge(
                    "prefix_tier_t0_bytes",
                    "HBM bytes held by cached prefix blocks (the paged pool's prefix "
                    "sub-owner; budget = prefix-store t0-bytes)"),
                "t1_bytes": reporter.gauge(
                    "prefix_tier_t1_bytes", "host-RAM bytes held by T1 spilled prefix blocks"),
                "t2_bytes": reporter.gauge(
                    "prefix_tier_t2_bytes", "object-storage payload bytes indexed in T2"),
                "t1_hits": reporter.counter(
                    "prefix_t1_promotions_total", "prefix blocks promoted T1→T0 at admission"),
                "t2_hits": reporter.counter(
                    "prefix_t2_hydrations_total",
                    "prefix blocks hydrated T2→T1 for an admission"),
                "demotions": reporter.counter(
                    "prefix_demotions_total",
                    "prefix blocks demoted down-tier (T0→T1 and T1→T2)"),
                "evictions": reporter.counter(
                    "prefix_evictions_total",
                    "prefix blocks evicted from any tier (bytes left the store — "
                    "counted, never silent)"),
            }
        self._m_adapters: dict[str, Any] = {}
        if self.adapter_store is not None:
            self._m_adapters = {
                "t0_bytes": reporter.gauge(
                    "adapter_tier_t0_bytes",
                    "HBM bytes held by device-resident LoRA adapter rows (budget = "
                    "adapter-store t0-entries x entry bytes)"),
                "t1_bytes": reporter.gauge(
                    "adapter_tier_t1_bytes", "host-RAM bytes held by T1 spilled LoRA adapters"),
                "t2_bytes": reporter.gauge(
                    "adapter_tier_t2_bytes",
                    "object-storage payload bytes indexed in adapter T2"),
                "loads": reporter.counter(
                    "adapter_loads_total",
                    "LoRA adapter rows loaded into the device buffers (T1→T0 promotions)"),
                "hydrations": reporter.counter(
                    "adapter_hydrations_total",
                    "LoRA adapters hydrated T2→T1 for an admission"),
                "demotions": reporter.counter(
                    "adapter_demotions_total",
                    "LoRA adapters demoted T1→T2 under host-RAM pressure"),
                "evictions": reporter.counter(
                    "adapter_evictions_total",
                    "LoRA adapters evicted from any tier (bytes left the store — counted, "
                    "never silent)"),
            }
        self._m_shrinks = self._m_restores = self._m_budget = None
        if self.block_mgr is not None:
            self._m_shrinks = reporter.counter(
                "pool_shrinks_total",
                "adaptive KV-budget shrinks after a device allocator failure "
                "(degrade-don't-die: evidence rides the pool-shrink flight events)")
            self._m_restores = reporter.counter(
                "pool_restores_total",
                "shrink quanta restored by the recovery probe after a quiet window")
            self._m_budget = reporter.gauge(
                "kv_budget_blocks",
                "live paged-KV admission budget in blocks (configured pool minus "
                "blocks withheld by adaptive shrink)")
            self._m_budget(self.block_mgr.usable_blocks)
        self._m_journal_depth = None
        if self.journal is not None:
            self._m_journal_depth = reporter.gauge(
                "journal_depth",
                "admitted-but-unfinished requests in the crash-requeue journal")

    def _note_compile(self, kind: str, key) -> None:
        """A ``recompile`` flight event and ``recompiles_total`` the first
        time a ``(kind, shape key)`` pair is dispatched, at the JAX engine's
        keys: ``decode`` (sampler mode, window, K, penalties), ``prefill``
        (sampler mode, bucket, padded rows), ``prefill-continue`` (sampler
        mode, read blocks, padded rows, chunk) and ``spec_step`` (read
        blocks, sampler mode). The port compiles nothing: a shape's first
        PyTorch dispatch is where its first-call costs land (the caching
        allocator's growth, cuBLAS's choice of kernels for the shape, a
        kernel's first load), so the event marks the same boundary. Loop
        thread; a set test per dispatch."""
        shape_key = (kind, repr(key))
        if shape_key in self._compiled_shapes:
            return
        self._compiled_shapes.add(shape_key)
        self.flight.event("recompile", what=kind, variant=repr(key))
        self._m_recompiles(1)

    def _stream_tbt_hist(self, cls_name: str):
        """The class's ``langstream_stream_tbt_seconds{agent_id="<class>"}``
        exemplar histogram, registered at the class's first measured gap
        (streaming engines only; classes are the QoS vocabulary, so the map
        stays bounded)."""
        h = self._m_tbt_hist.get(cls_name)
        if h is None:
            h = self._m_tbt_hist[cls_name] = self._reporter_cls(
                prefix="langstream_stream", agent_id=cls_name).exemplar_histogram(
                "tbt_seconds",
                "streaming inter-chunk interval (time between token deliveries) "
                "by QoS class")
        return h

    # ------------------------------------------------------------------
    # attribution plane (serving/attribution.py)
    # ------------------------------------------------------------------

    def _init_attribution(self) -> None:
        """The static facts the cost models and the memory ledger need,
        computed once (the shapes are fixed for the engine's life), and
        the card's capacity and bandwidth."""
        mc = self.model_config
        self._weights_bytes = tree_device_bytes(self.params)
        self._kv_cache_bytes = (
            tree_device_bytes(self.cache_k) + tree_device_bytes(self.cache_v))
        self._kv_block_bytes = (
            self._kv_cache_bytes // self.paged_layout.num_blocks
            if self.block_mgr is not None else 0
        )
        act_bytes = torch.empty((), dtype=mc.dtype).element_size()
        if self.is_moe:
            # routed experts: which ones fire is the data's, so the
            # operations term counts parameters from the measured weight
            # bytes over the weights' width (the JAX engine's estimate)
            n_params = self._weights_bytes // (
                1 if self.config.quantize == "int8" else act_bytes)
        else:
            n_params = param_count(mc)
        if self.config.kv_quantize == "int8":
            kv_row_bytes = mc.head_dim + 4  # int8 row + f32 scale
        else:
            kv_row_bytes = mc.head_dim * act_bytes
        self._prog_shape = ModelShape(
            layers=mc.layers, hidden=mc.hidden, heads=mc.heads,
            kv_heads=mc.kv_heads, head_dim=mc.head_dim,
            intermediate=mc.moe_intermediate if self.is_moe else mc.intermediate,
            vocab=mc.vocab_size,
            weight_bytes=self._weights_bytes, param_count=n_params,
            kv_row_bytes=kv_row_bytes, act_bytes=act_bytes,
        )
        self._hbm_limit, self._hbm_limit_source = (
            detect_hbm_capacity() if self.device.type == "cuda" else (None, "unknown"))
        self._hbm_gbps = detect_hbm_gbps()
        self._hbm_generation = (
            detect_generation() if self.device.type == "cuda" else None)

    @staticmethod
    def _sampler_code(sampler_mode: tuple) -> str:
        """Compact sampler-variant tag for program ids."""
        use_top_p, use_top_k, all_greedy = sampler_mode
        if all_greedy:
            return "greedy"
        tag = "sample"
        if use_top_k:
            tag += "-tk"
        if use_top_p:
            tag += "-tp"
        return tag

    def _window_rows(self, window: int | None) -> int:
        """Cache rows a decode variant sweeps per slot: block-table columns
        on the paged pool, a row window on the dense cache (None = all)."""
        if self.block_mgr is not None:
            blocks = window or self.paged_layout.max_blocks_per_slot
            return blocks * self.paged_layout.block_size
        return window or self.model_config.max_seq_len

    def _program(self, program: str, cost: Callable[[], Any]) -> str:
        if not self.attribution.known(program):
            self.attribution.register(program, cost())
        return program

    def _program_decode(self, window: int | None, k_steps: int,
                        sampler_mode: tuple, pen: bool) -> str:
        """Program id of a decode-chunk variant (the JAX engine's id);
        registers its cost on first sight."""
        rows = self._window_rows(window)
        self._note_compile("decode", (sampler_mode, window, k_steps, pen))
        return self._program(
            f"decode:w{rows}:k{k_steps}:{self._sampler_code(sampler_mode)}"
            + (":pen" if pen else ""),
            lambda: decode_cost(self._prog_shape, slots=self.config.slots,
                                window_rows=rows, k_steps=k_steps,
                                hbm_gbps=self._hbm_gbps),
        )

    def _program_prefill(self, bucket: int, rows: int, sampler_mode: tuple) -> str:
        self._prefill_modes.add(sampler_mode)
        self._note_compile("prefill", (sampler_mode, bucket, rows))
        return self._program(
            f"prefill:p{bucket}:b{rows}:{self._sampler_code(sampler_mode)}",
            lambda: prefill_cost(self._prog_shape, rows=rows, tokens_per_row=bucket,
                                 prefix_rows=0, hbm_gbps=self._hbm_gbps),
        )

    def _program_prefill_continue(self, nrb: int, rows: int, chunk: int,
                                  sampler_mode: tuple) -> str:
        self._note_compile("prefill-continue", (sampler_mode, nrb, rows, chunk))
        return self._program(
            f"prefill-continue:nrb{nrb}:b{rows}:c{chunk}:"
            f"{self._sampler_code(sampler_mode)}",
            lambda: prefill_cost(self._prog_shape, rows=rows, tokens_per_row=chunk,
                                 prefix_rows=nrb * self.paged_layout.block_size,
                                 hbm_gbps=self._hbm_gbps),
        )

    def _program_spec_step(self, nrb: int, sampler_mode: tuple) -> str:
        drafts = self.config.speculative_drafts
        self._note_compile("spec_step", (nrb, sampler_mode))
        return self._program(
            f"specstep:nrb{nrb}:d{drafts}:{self._sampler_code(sampler_mode)}",
            lambda: verify_cost(self._prog_shape, slots=self.config.slots,
                                window_rows=nrb * self.paged_layout.block_size,
                                drafts=drafts, hbm_gbps=self._hbm_gbps),
        )

    def _admission_stall(self) -> str | None:
        """Why queued work is not admitted right now (None: the queue is
        empty or the next pass admits). The head's need is the JAX engine's
        ``prompt + max-tokens + 1``, so both engines stall on the same
        head."""
        if self.scheduler.empty():
            return None
        if not any(s.free for s in self.slots):
            return "no-free-slot"
        if self.block_mgr is not None:
            head = self.scheduler.peek()  # loop thread only
            if head is None:
                return None
            if not self.block_mgr.can_admit(len(head.prompt_tokens) + head.max_tokens + 1):
                return "no-kv-blocks"
        if self._has_prefilling():
            return "prefill-in-flight"
        return None

    def _kv_used(self) -> float | None:
        return self.block_mgr.used_ratio() if self.block_mgr is not None else None

    def _flight_record(self, phase: str, device_s: float, tokens: int = 0,
                       overlapped_s: float = 0.0, spec_accepted: int = 0,
                       spec_rejected: int = 0, program: str | None = None,
                       span_s: float | None = None) -> None:
        """One flight sample per dispatch (see flight.py): ``device_s`` is
        the host's blocked wait for the dispatch's fetch, ``overlapped_s``
        host work credited while a later chunk still ran. ``program`` also
        feeds the attribution ledger with the dispatch's device time: on
        the card ``span_s``, the CUDA-event span from its first launch to
        its fetch (an eager dispatch launches for about as long as the card
        runs it, so the wait alone would read near 0); on the CPU, as the
        JAX engine, the wait plus the overlapped share."""
        if program is not None:
            self.attribution.observe(
                program, span_s if span_s is not None else device_s + overlapped_s)
        stall, kv_used, depths = self._admission_stall(), self._kv_used(), self.scheduler.depths()
        sample = self.flight.sample(
            phase, device_s=device_s, overlapped_s=overlapped_s, tokens=tokens,
            occupancy=sum(1 for s in self.slots if not s.free),
            queue_depth=self.scheduler.qsize(), stall=stall,
            kv_used=kv_used, prefix_hits=self.prefix_hits,
            spec_accepted=spec_accepted, spec_rejected=spec_rejected,
            queue_by_class=depths, program=program,
        )
        # watchdog heartbeat: a recorded dispatch is step progress
        self.watchdog.beat(sample["queue_depth"])
        if self._shrink_recover_at is not None:
            # the pool shrink's recovery probe runs at every dispatch as well
            # as at the loop's passes: a long burst does not hold the
            # budget down past its quiet windows
            self._shrink_step()
        if phase == "decode":
            self._decode_s += sample["wall_ms"] / 1000.0
            if self.config.speculative_drafts > 0 and self._spec_auto_disabled:
                self._spec_count_plain_chunk()
        # the Prometheus mirrors: the class depths, the step's wall, its
        # exposed host share, the pool's reserved ratio and the stall
        if depths:
            for cls, gauge in self._m_class_depth.items():
                gauge(depths.get(cls, 0))
        hist = self._m_step_hist.get(phase)
        if hist is not None:
            hist(sample["wall_ms"] / 1000.0)
        self._m_host_overhead(sample["host_ms"] / 1000.0)
        if kv_used is not None:
            self._m_kv_used(kv_used)
        if stall is not None:
            self._m_stall[stall](sample["wall_ms"] / 1000.0)

    def _flight_stall(self, reason: str) -> None:
        """An idle gap of the loop, recorded as stall time; it beats the
        watchdog too, so an idle engine never reads as wedged."""
        sample = self.flight.stall(
            reason, occupancy=sum(1 for s in self.slots if not s.free),
            queue_depth=self.scheduler.qsize(), kv_used=self._kv_used(),
            queue_by_class=self.scheduler.depths(),
        )
        self.watchdog.beat(sample["queue_depth"])
        self._m_stall[reason](sample["wall_ms"] / 1000.0)

    def attribution_section(self) -> dict[str, Any]:
        """``stats()["attribution"]``: the per-program achieved-vs-expected
        ledger and the device-memory ledger (the JAX engine's keys);
        snapshot reads and arithmetic only. The ``hbm_bytes_<owner>`` gauges
        refresh here, so every reader keeps the scrape current."""
        memory = self._memory_ledger()
        owners = memory["hbm_bytes_by_owner"]
        for owner, gauge in self._m_hbm_owner.items():
            gauge(owners.get(owner) or 0)
        return {
            "model": self.config.model,
            "slots": self.config.slots,
            "generation": self._hbm_generation,
            "hbm_gbps_assumed": self._hbm_gbps,
            "programs": self.attribution.report(),
            "memory": memory,
        }

    def _memory_ledger(self) -> dict[str, Any]:
        """Device bytes by owner; the limit is the card's total memory.
        ``in-transit`` names the serialized handoff payloads awaiting
        pickup; ``kv_pool_withheld_bytes`` the budget the pool shrink
        withholds (a share of the pool's bytes, which do not move)."""
        return memory_ledger(
            weights_bytes=self._weights_bytes,
            kv_pool_bytes=self._kv_cache_bytes,
            prefix_blocks=(self.block_mgr.prefix_block_count()
                           if self.block_mgr is not None else 0),
            bytes_per_block=self._kv_block_bytes,
            sampler_bytes=self._sampler_dev_cache.device_bytes(),
            tables_bytes=self._tables_dev_cache.device_bytes(),
            limit_bytes=self._hbm_limit,
            limit_source=self._hbm_limit_source,
            in_transit_bytes=self._kv_in_transit_bytes,
            kv_withheld_bytes=(self.block_mgr.budget_reduction * self._kv_block_bytes
                               if self.block_mgr is not None else 0),
        )

    # ------------------------------------------------------------------
    # read-window buckets
    # ------------------------------------------------------------------

    @staticmethod
    def _sampler_mode(temps, topks, topps) -> tuple:
        """(use_top_p, use_top_k, all_greedy) for the given active rows."""
        use_top_p = bool((topps < 1.0).any())
        use_top_k = bool((topks > 0).any())
        all_greedy = bool((temps <= 0).all()) and not use_top_p and not use_top_k
        return (use_top_p, use_top_k, all_greedy)

    def _window_for(self, max_len: int) -> int | None:
        """Smallest 128-multiple cache window covering ``max_len`` rows up to
        1024, powers of two beyond; None = the whole cache."""
        S = self.model_config.max_seq_len
        if max_len <= 1024:
            w = max(128, -(-max_len // 128) * 128)
        else:
            w = 2048
            while w < max_len:
                w *= 2
        return None if w >= S else w

    def _read_blocks_for(self, max_len: int) -> int:
        """Paged analogue of :meth:`_window_for`: block-table columns the
        read may cover."""
        bs = self.paged_layout.block_size
        window = self._window_for(max_len) or self.model_config.max_seq_len
        return max(1, min(-(-window // bs), self.paged_layout.max_blocks_per_slot))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    async def generate(
        self,
        prompt: str | list[int],
        options: dict[str, Any] | None = None,
        on_token: Callable[[int, float, bool], Any] | None = None,
        on_chunk: Callable[[list, str, bool], Any] | None = None,
        _warmup_probe: bool = False,
    ) -> dict[str, Any]:
        """Generate a completion. ``on_token(token_id, logprob, last)`` fires
        per token; ``on_chunk(new_token_ids, new_text, is_final)`` once per
        request per decode chunk, with text deltas that concatenate to the
        final ``text`` (both sync or async). Returns
        ``{"tokens", "text", "logprobs", "num_prompt_tokens", "ttft"}``.

        Options of the serving planes: ``qos-tenant`` and ``priority`` (the
        QoS scheduler's tenant and class), ``stream-key`` (registered with
        the stream registry: a cancel by that key cancels the request),
        ``deadline``/``deadline-s`` (shed at admission when the budget left
        cannot cover the median recent prefill).

        ``adapter`` names a LoRA adapter of the engine's ``adapter-store``
        (resolved at admission; :class:`AdapterUnavailable` when no tier
        can produce it).

        Refused before the request queues: ``adapter`` on an engine with no
        adapter store (``ValueError``), a spent ``deadline``/``deadline-s``
        budget (:class:`DeadlineExceeded`) and, under QoS, a full class
        queue or an empty tenant bucket (:class:`RateLimited`).
        ``_warmup_probe`` is internal: warmup's own requests skip the warmup
        gate (they are the warmup) and QoS policy."""
        if self._stop:
            raise RuntimeError(
                "serving engine is stopped (closed or lockstep group broken)")
        self._event_loop = self._event_loop or asyncio.get_running_loop()
        options = options or {}
        if self.config.warmup_on_start and not _warmup_probe:
            # one shared task: every early arrival awaits it; a warmup
            # failure is logged by the task's callback, never surfaced as
            # this request's failure
            task = self._warmup_begun()
            if not task.done():
                try:
                    await asyncio.shield(task)
                except Exception:
                    pass
        tokens = (
            self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        )
        S = self.model_config.max_seq_len
        if len(tokens) > S - 2:
            tokens = tokens[-(S - 2):]
        top_k = int(options.get("top-k", 0))
        if top_k > K_MAX:
            log.warning("top-k %d exceeds the window of %d; clamping", top_k, K_MAX)
            top_k = K_MAX
        max_tokens = min(
            int(options.get("max-tokens", self.config.default_max_tokens)),
            S - len(tokens) - 1,
        )
        if self.block_mgr is not None and not self.block_mgr.fits_ever(
            len(tokens) + max_tokens + 1
        ):
            raise ValueError(
                f"request needs {len(tokens) + max_tokens + 1} tokens of KV, "
                f"more than the paged pool can ever hold; lower max-tokens or "
                f"grow kv-pool-blocks/kv-pool-fraction"
            )
        adapter = str(options.get("adapter", "") or "")
        if adapter and self.adapter_store is None:
            # refused loudly at submit: a silently-ignored adapter would
            # serve base-model output under the tenant's fine-tune name
            raise ValueError(
                f"request names adapter {adapter!r} but this engine has "
                "no adapter store configured (serving adapter-store)"
            )
        loop = asyncio.get_running_loop()
        request = _Request(
            prompt_tokens=tokens,
            max_tokens=max_tokens,
            temperature=float(options.get("temperature", 0.0)),
            top_k=top_k,
            top_p=float(options.get("top-p", 1.0)),
            future=loop.create_future(),
            on_token=on_token,
            on_chunk=on_chunk,
            presence_penalty=float(options.get("presence-penalty", 0.0)),
            frequency_penalty=float(options.get("frequency-penalty", 0.0)),
            enqueue_time=time.monotonic(),
            stop=_normalize_stop(options.get("stop")),
            warmup=_warmup_probe,
            tenant=str(options.get("qos-tenant", "") or ""),
            priority=normalize_priority(options.get("priority")),
            deadline=deadline_from_options(options),
            stream_key=str(options["stream-key"]) if options.get("stream-key") else None,
            adapter=adapter,
            # warmup probes attach no spans to the record whose task
            # happened to start the warmup
            trace=None if _warmup_probe else current_context(),
        )
        if on_chunk is not None and self.config.streaming:
            # the bounded per-request TBT digest: only streaming engines pay
            request.stream_tbt = TbtDigest()
        if not _warmup_probe:
            # the journey's (and the journal's) key: the trace id when
            # traced, the one id that spans gateway, broker and engine and
            # rides the handoff header; a fresh one of the same shape else
            request.journey_id = (request.trace.trace_id if request.trace is not None
                                  else fresh_trace_id())
            self._journey(request, "submit", model=self.config.model,
                          role=self._pool_role, prompt_tokens=len(tokens),
                          max_tokens=max_tokens)
        if request.deadline is not None and not _warmup_probe:
            left = remaining_s(request.deadline)
            if left <= 0.0:
                # an unmeetable budget is refused before it queues: never a
                # silent late completion
                raise self._note_deadline_shed(request, "submit", left)
        try:
            if self._draining and not _warmup_probe:
                # admission is closed: an explicit shed with a retry hint,
                # so the gateway resends to a live replica
                raise RateLimited(
                    "draining", 1.0,
                    "engine is draining (scale-down or pod termination in "
                    "progress); retry against another replica",
                )
            self.scheduler.submit(request)
        except RateLimited as e:
            # load shed or tenant throttle, refused before any slot or block
            # was touched; callers map it to 429 with Retry-After
            self.flight.event("shed", reason=e.reason, tenant=request.tenant,
                              priority=request.priority, retry_after_s=e.retry_after)
            self._journey(request, "shed", reason=e.reason, retry_after_s=e.retry_after)
            if e.reason == "draining":
                self._drain_shed += 1
            if self._m_shed is not None:
                self._m_shed(1)
            if not _warmup_probe:
                self._slo_record("shed-rate", False)
            raise
        if not _warmup_probe:
            # the shed-rate objective counts every submission: admitted good
            self._slo_record("shed-rate", True)
            if self.journal is not None:
                # accepted now: journaled before the caller holds a future,
                # retired when finish, shed or failure answers it
                self.journal.admit(request_entry(request))
                self._m_journal_depth(self.journal.depth())
            if request.stream_key is not None:
                # the disconnect-as-cancellation bridge: a cancel by this
                # key cancels the future (at once if the key was cancelled
                # already); the entry self-cleans when the future resolves
                self.streams.register(request.stream_key, request.future, loop)
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.ensure_future(self._run_loop())
        self._wake.set()
        return await request.future

    def stats(self) -> dict[str, Any]:
        out = {
            "model": self.config.model,
            "device": str(self.device),
            "slots": self.config.slots,
            "active": sum(1 for s in self.slots if not s.free),
            "queued": self.scheduler.qsize(),
            "total-generated": self.total_generated,
            # admission policy counters: FIFO totals, or per class, shed,
            # preempted and resumed under QoS
            "scheduler": self.scheduler.stats(),
            "completed": self.completed_requests,
            # prefill dispatches, and those of them through the
            # continuation path (prefix-cache hits and prefill chunks)
            "prefill-calls": self._prefill_calls,
            "prefill-continue-calls": self._continue_calls,
            "prefix": {
                "hits": self.prefix_hits, "tokens_reused": self.prefix_tokens,
            },
            "decode-chunks": {
                "light": self._light_chunks,
                "heavy": self._heavy_chunks,
                "dispatched": self._decode_dispatches,
                "fetched": self._decode_fetches,
                # the one-fetch invariant: above 1.0 means the decode tail
                # crosses the host boundary more than once per chunk
                "host_fetches_per_chunk": (
                    round(self._decode_fetches / self._decode_dispatches, 4)
                    if self._decode_dispatches else 0.0
                ),
                # fused steps dispatched; the loop's wall seconds of the
                # decode samples (flight recorder: they tile the timeline,
                # so pipelined chunks are not counted twice); the host
                # seconds spent launching the chunks
                "steps": self._decode_steps,
                "seconds": self._decode_s,
                "launch_seconds": self._decode_launch_s,
            },
            # the loop posture and the bounded device-upload caches
            "pipeline": self._pipeline_on,
            "device-cache": {
                "tables": self._tables_dev_cache.stats(),
                "sampler": self._sampler_dev_cache.stats(),
            },
            # dispatches by phase (flight recorder)
            "steps": dict(self.flight.steps_by_phase),
            # per-program expected against measured device time, and the
            # device-memory ledger
            "attribution": self.attribution_section(),
            # the watchdog's verdict and the readiness posture
            "health": self.health(),
            # the drain's posture and its last counts
            "drain": self._drain_section(),
            # the live KV budget against the configured one, shrink and
            # restore counts, the armed faults and the journal
            "survival": self.survival_section(),
            # launch counters of the port's kernels in this process
            "kernels": {
                "flash_attention": flash_attention.launches,
                "paged_attention": paged_attention_partial.launches,
                "paged_attention_q8": _paged_attention_partial_q8.launches,
                "paged_attention_multiquery": paged_attention_multiquery_partial.launches,
            },
        }
        if self._pool_role != "combined":
            # the KV handoff's counters and in-transit posture (a combined
            # engine's stats stay as they were)
            out["kvtransfer"] = self.kv_transfer_section()
        if self.prefix_store is not None:
            # per-tier bytes and budgets, hits, demotions, evictions and the
            # exact byte ledger
            out["prefixstore"] = self.prefix_store_section()
        if self.adapter_store is not None:
            # the adapter tiers: per-tier bytes and budgets, hits, loads,
            # evictions, the resident rows and the exact byte ledger
            out["adapters"] = self.adapter_store_section()
        if self.block_mgr is not None:
            out["kv"] = {"layout": "paged", **self.block_mgr.stats()}
        if self.config.speculative_drafts > 0:
            out["speculative"] = self.speculative_section()
        if self.incidents is not None:
            # captured, suppressed, written and evicted bundle counts
            out["incidents"] = self.incidents.stats()
        slo = self.slo_status()
        if slo is not None:
            out["slo"] = slo
        if self.config.streaming:
            out["streaming"] = self.streaming_section()
        if self.mesh is not None:
            out["mesh"] = self.mesh_section()
        out["deadline-sheds"] = self.deadline_sheds
        out["warmup"] = {"state": self._warmup_state(), **(self._warmup_result or {})}
        return out

    def speculative_section(self) -> dict[str, Any]:
        """``stats()["speculative"]``: the keys of the JAX engine's section.
        ``dispatches`` and ``fetches`` track ``steps`` one to one (one
        packed fetch per draft+verify step); ``uplift`` is the last measured
        speculative/plain tokens-per-second ratio (None until a full
        window and a calibration sample exist)."""
        return {
            "steps": self.spec_steps,
            "drafts_accepted": self.spec_accepted,
            "rejected": self.spec_rejected,
            "dispatches": self._spec_dispatches,
            "fetches": self._spec_fetches,
            "uplift": self._spec_last_uplift,
            "auto_disabled": self._spec_auto_disabled,
            "flips": self._spec_flips,
            "window_steps": len(self._spec_window),
            "window_plain": len(self._plain_window),
        }

    # ------------------------------------------------------------------
    # health plane (serving/health.py)
    # ------------------------------------------------------------------

    def health(self) -> dict[str, Any]:
        """Wait-free health snapshot, callable while the engine is wedged:
        snapshot reads and arithmetic only, no device work, no locks. Judges
        the watchdog's heartbeat against the live queue and occupancy and
        runs the degradation predicates over the flight window; a state
        transition is recorded as a ``health`` flight event. The keys are
        the JAX engine's: a draining engine is alive but not ready, and
        ``budget_withheld`` is what the pool shrink withholds now. The
        ``recompile`` events stay out of the verdict: they mark a shape's
        first eager dispatch, which compiles nothing, so a cluster of them
        is no compile storm here."""
        queued = self.scheduler.qsize()
        occupancy = sum(1 for s in self.slots if not s.free)
        tbt_burn = self._tbt_burning()
        events = [e for e in self.flight.recent_events(256) if e.get("kind") != "recompile"]
        verdict = self.watchdog.evaluate(
            queued=queued, occupancy=occupancy,
            samples=self.flight.recent(240), events=events,
            stopped=self._stop,
            extra_reasons=tuple(
                f"tbt burn-rate alert: class {name!r} is burning its tbt-p99-s "
                f"error budget at page rate" for name in tbt_burn),
        )
        if verdict.pop("transition"):
            self.flight.event(
                "health", state=verdict["state"], previous=verdict["previous"],
                reasons=list(verdict["reasons"]),
                last_step_age_s=verdict["last_step_age_s"], queued=queued,
                occupancy=occupancy,
            )
            if self.incidents is not None and verdict["state"] in ("degraded", "wedged"):
                # a worsening transition pages: the trigger is the dominant
                # reason, so the bundle's worst journeys rank by the
                # segment that reason indicts
                reasons = list(verdict["reasons"])
                if verdict["state"] == "wedged":
                    kind = "health-wedged"
                elif any("memory pressure" in r for r in reasons):
                    kind = "shrink-pressure"
                elif any("tbt burn" in r for r in reasons):
                    kind = "tbt-burn"
                else:
                    kind = "health-degraded"
                self._incident_capture(kind, {
                    "source": "health", "state": verdict["state"],
                    "previous": verdict["previous"], "reasons": reasons,
                    "queued": queued, "occupancy": occupancy,
                })
        if self.incidents is not None:
            # the storm predicates over the snapshotted event tail, whatever
            # the watchdog says: a replica fan-out melting down (the
            # router's breaker events mirror into this ring) or one adapter
            # bouncing out of the tiers inside one hydrate window
            tail = self.flight.recent_events(256)
            storm = breaker_storm(tail, time.monotonic())
            if storm is not None:
                self._incident_capture("breaker-storm", {"source": "health", **storm})
            if self.adapter_store is not None:
                thrash = adapter_eviction_storm(
                    tail, time.monotonic(),
                    window_s=self.adapter_store.spec.hydrate_timeout_s)
                if thrash is not None:
                    self._incident_capture("adapter-storm", {"source": "health", **thrash},
                                           dedup_key=thrash["adapter"])
        warmup = self._warmup_state()
        out = {
            "model": self.config.model,
            "slots": self.config.slots,
            **verdict,
            "warmup": warmup,
            "draining": self._draining,
            "ready": (warmup not in ("pending", "running") and verdict["state"] != "wedged"
                      and not self._draining),
            "budget_withheld": (self.block_mgr.budget_reduction
                                if self.block_mgr is not None else 0),
        }
        if self.config.streaming:
            out["tbt_burn"] = tbt_burn
        return out

    def slo_status(self) -> dict[str, Any] | None:
        """``stats()["slo"]`` (None without a declared slo section);
        wait-free like :meth:`health`."""
        return self.slo.status() if self.slo is not None else None

    def _slo_record(self, objective: str, good: bool) -> None:
        """Record one event against an SLO objective (loop thread only; a
        no-op without a spec or for an undeclared objective)."""
        if self.slo is not None:
            self._slo_emit(objective, self.slo.record(objective, good))

    def _slo_record_latency(self, objective: str, seconds: float) -> None:
        """Record a measured latency; the tracker judges it against the
        objective's declared threshold."""
        if self.slo is not None:
            self._slo_emit(objective, self.slo.record_latency(objective, seconds * 1000.0))

    def _slo_emit(self, objective: str, verdict: dict | None) -> None:
        """Mirror one evaluation onto the objective's burn and budget
        gauges, and an ``alert`` flight event when its multi-window fast
        burn starts or stops: alerts fire at record time, so an unwatched
        engine still leaves the evidence in its event ring."""
        if verdict is None:
            return
        gauge = self._m_slo_burn.get(objective)
        if gauge is not None:
            gauge(verdict["burn_rate_fast"] or 0.0)
        gauge = self._m_slo_budget.get(objective)
        if gauge is not None:
            gauge(verdict["budget_remaining"])
        if verdict["transition"]:
            self.flight.event(
                "alert", objective=objective,
                state="firing" if verdict["alerting"] else "resolved",
                burn_rate_fast=verdict["burn_rate_fast"],
                burn_rate_slow=verdict["burn_rate_slow"],
                budget_remaining=verdict["budget_remaining"], target=verdict["target"],
            )
            if verdict["alerting"] and self.incidents is not None:
                # the page threshold was crossed: the evidence at the breach
                # instant (per-objective cooldown in the recorder)
                self._incident_capture("slo-fast-burn", {
                    "source": "slo", "objective": objective,
                    "burn_rate_fast": verdict["burn_rate_fast"],
                    "burn_rate_slow": verdict["burn_rate_slow"],
                    "budget_remaining": verdict["budget_remaining"],
                    "target": verdict["target"],
                }, dedup_key=objective)

    def _incident_capture(self, kind: str, evidence: dict[str, Any],
                          dedup_key: str | None = None) -> None:
        """Assemble one incident bundle at the breach site and hand it to
        the recorder's writer thread (the JAX engine's bundle, key for
        key). Wait-free: the cooldown gate is GIL-atomic dict work, every
        section is a snapshot read, and the handoff is a deque append; it
        runs inside ``health()`` and the finish path."""
        rec = self.incidents
        if rec is None or not rec.should_capture(kind, dedup_key):
            return
        # only events past the recorder's high-water mark: overlapping
        # captures never report one event twice
        events = self.flight.recent_events(256)
        watermark = rec.last_event_seq
        fresh = [e for e in events if e.get("seq", 0) > watermark]
        if events:
            rec.last_event_seq = max(watermark, events[-1].get("seq", 0))
        bundle: dict[str, Any] = {
            # a wall anchor for cross-pod alignment, never subtracted
            "captured_at_ms": round(time.time() * 1000.0, 3),
            "model": self.config.model,
            "trigger": {"kind": kind, **evidence},
            "flight": self.flight.summary(),
            "events": fresh,
            "worst_journeys": worst_journeys(kind),
            "attribution": self.attribution_section(),
            "survival": self.survival_section(),
            "kvtransfer": self.kv_transfer_section(),
            "breakers": {
                "open": self.flight.events_by_type.get("breaker-open", 0),
                "close": self.flight.events_by_type.get("breaker-close", 0),
            },
            "slo": self.slo_status(),
            "streaming": self.streaming_section() if self.config.streaming else None,
            "config": self.config.to_dict(),
        }
        if self.adapter_store is not None:
            bundle["adapters"] = self.adapter_store_section()
        bundle_id = rec.submit(bundle)
        self.flight.event("incident", bundle=bundle_id, trigger=kind)

    def streaming_section(self) -> dict[str, Any]:
        """``stats()["streaming"]`` (streaming engines only): streams that
        hold a slot, emit/stall/cancel/reclaim counters and the per-class
        TBT digests; counter snapshots only."""
        return {
            "active": sum(1 for s in self.slots
                          if s.request is not None and s.request.on_chunk is not None),
            "emits": self.stream_emits_total,
            "stalls": self.stream_stalls_total,
            "cancelled": self.stream_cancels_total,
            "reclaimed": self.stream_reclaims_total,
            "tbt": {name: digest.summary()
                    for name, digest in sorted(self._stream_tbt_by_class.items())},
            "tbt_burn": self._tbt_burning(),
        }

    def _tbt_burning(self) -> list[str]:
        """Classes whose ``tbt-p99-s`` tracker is paging (committed alert
        state, so ``health()`` and the streaming section agree)."""
        return sorted(name for name, tracker in self._stream_slo.items()
                      if tracker.alerting.get("tbt"))

    def _stale(self) -> bool:
        """Closed, or bound to an event loop that has closed."""
        return self._stop or (
            self._event_loop is not None and self._event_loop.is_closed()
        )

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------

    def _warmup_state(self) -> str:
        """``not-required`` (no ``warmup-on-start``, no explicit call),
        ``pending`` (``warmup-on-start``, no request yet), ``running``,
        ``done`` or ``failed``."""
        task = self._warmup_task
        if task is None:
            return "pending" if self.config.warmup_on_start else "not-required"
        if not task.done():
            return "running"
        return "failed" if task.cancelled() or task.exception() else "done"

    def _warmup_begun(self) -> asyncio.Task:
        """The one shared warmup task, created on first need (an explicit
        :meth:`warmup` call or the ``warmup-on-start`` gate) and credited
        to both."""
        if self._warmup_task is None:
            self._warmup_task = asyncio.ensure_future(self._do_warmup())

            def _log_done(task: asyncio.Task) -> None:
                if task.cancelled():
                    return
                if task.exception() is not None:
                    log.error("engine warmup failed; serving continues cold",
                              exc_info=task.exception())
                else:
                    log.info("engine warmup complete: %s", task.result())

            self._warmup_task.add_done_callback(_log_done)
        return self._warmup_task

    async def warmup(self) -> dict[str, Any]:
        """Run the serving path once before real traffic (see
        :meth:`_do_warmup`). Idempotent: shares one task with the
        ``warmup-on-start`` gate, so the probe and wave never repeat."""
        return await asyncio.shield(self._warmup_begun())

    async def _do_warmup(self) -> dict[str, Any]:
        """A lone greedy probe of ``max(decode-chunk, decode-chunk-light) +
        1`` tokens (single-row prefill, a light-regime burst), then a
        concurrent wave of ``min(slots, max(2, light threshold + 1,
        prefill-batch))`` probes (padded batch prefill, a heavy-regime
        burst), as the JAX engine's warmup. There it settles XLA compiles;
        here it settles what the first requests would otherwise pay: the
        kernels' first build and load and their first launches, the
        caching allocator's first growth, and cuBLAS's handles and
        workspaces. Probe tokens count toward the engine's counters (they
        ran on the device); probe results go to no caller."""
        t0 = time.monotonic()
        text = "engine warmup probe text. " * 4
        k = max(self.config.decode_chunk, self.config.decode_chunk_light) + 1
        opts = {"max-tokens": k, "temperature": 0}
        self.flight.event("warmup", stage="begin")
        await self.generate(text, dict(opts), _warmup_probe=True)
        wave = min(
            self.config.slots,
            max(2, self._light_threshold() + 1, self.config.prefill_batch),
        )
        await asyncio.gather(*(
            self.generate(text, dict(opts), _warmup_probe=True)
            for _ in range(wave)
        ))
        # the wave's pipelined burst applies its over-run chunk after the
        # results: warmup ends when it has, so the first request finds the
        # loop free
        await self.settled()
        self._warmup_result = {"probe_tokens": k, "wave": wave,
                               "seconds": time.monotonic() - t0}
        # the JAX engine's details: the variants its warmup compiled
        self.flight.event(
            "warmup", stage="end",
            decode_variants=sum(1 for kind, _ in self._compiled_shapes if kind == "decode"),
            prefill_variants=len(self._prefill_modes))
        return self._warmup_result

    async def settled(self) -> None:
        """Return once no decode burst runs and no chunk is pending (a
        pipelined burst applies its last chunk after the results it
        finished were delivered), or the engine closes."""
        await self._settled.wait()

    async def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._settled.set()
        if self._warmup_task is not None and not self._warmup_task.done():
            self._warmup_task.cancel()
        if self._loop_task is not None and not self._loop_task.done():
            await self._loop_task
        self._executor.shutdown(wait=True)
        self._fetch_executor.shutdown(wait=True)
        if self._lockstep is not None:
            self._lockstep.close()  # "stop": the followers' replay ends
        if self.prefix_store is not None:
            self.prefix_store.close()
        if self.adapter_store is not None:
            self.adapter_store.close()
        if self.journal is not None:
            # flush the retire tail: the journal left behind replays exactly
            # the work this process never answered
            self.journal.close()
        if self.incidents is not None:
            # flush the bundles in flight: evidence captured just before a
            # shutdown is the evidence worth keeping
            self.incidents.close()
        closed = RuntimeError("serving engine closed")
        stashed = [entry[0] for entry in self._prefix_hydrating + self._adapter_hydrating]
        imports = [entry[2] for entry in self._pending_imports]
        self._prefix_hydrating = []
        self._adapter_hydrating = []
        self._pending_imports.clear()
        for request in self.scheduler.drain() + stashed + imports:
            if not request.future.done():
                request.future.set_exception(closed)

    # ------------------------------------------------------------------
    # drain before termination
    # ------------------------------------------------------------------

    async def drain(self, grace_s: float = 30.0) -> dict[str, Any]:
        """Drain this engine for termination: admission closes (submissions
        and imports are shed with :class:`RateLimited` ``"draining"``), the
        loop's safe point requeues every running request once (its tokens
        and sampling settings are the snapshot; a greedy resume equals the
        undisturbed run) together with the requests stashed for a T2
        hydration, and the backlog is served. What is left when the grace
        runs out fails explicitly with :class:`RateLimited`, never silently.

        Returns ``{"requeued", "completed", "shed", "duration_s"}`` (also a
        ``drain`` flight event and ``stats()["drain"]``). A second call
        joins the drain with its own grace. Draining is terminal for
        admission; the engine still answers ``stats()`` and ``health()``."""
        if self._stop:
            return {"requeued": 0, "completed": 0, "shed": 0, "duration_s": 0.0,
                    "stopped": True}
        start = time.monotonic()
        if not self._draining:
            self._draining = True
            self._drain_pass_done = False
            self._drain_requeued = 0
            self._drain_shed = 0
            self._drain_base_completed = self.completed_requests
            self._drain_report = None
            self.flight.event("drain", stage="begin", queued=self.scheduler.qsize(),
                              inflight=sum(1 for s in self.slots if not s.free))
        self._event_loop = self._event_loop or asyncio.get_running_loop()
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.ensure_future(self._run_loop())
        self._wake.set()
        deadline = start + grace_s
        while time.monotonic() < deadline:
            if (self.scheduler.empty() and all(s.free for s in self.slots)
                    and self._pending_chunk is None and not self._pending_imports
                    and not self._prefix_hydrating and not self._adapter_hydrating):
                break
            await asyncio.sleep(0.02)
        leftovers = (
            self.scheduler.qsize() + len(self._pending_imports)
            + len(self._prefix_hydrating) + len(self._adapter_hydrating)
            + sum(1 for s in self.slots
                  if s.request is not None and not s.request.future.done())
        )
        if leftovers:
            # grace spent: _fail_inflight releases every slot and block and
            # fails the running, queued and stashed futures; the error
            # carries the retry hint of a 429
            self._fail_inflight(RateLimited(
                "draining", 1.0,
                f"engine drained with {leftovers} requests unfinished after "
                f"{grace_s:.1f}s grace; retry another replica",
            ))
            self._drain_shed += leftovers
        report = {
            "requeued": self._drain_requeued,
            "completed": self.completed_requests - self._drain_base_completed,
            "shed": self._drain_shed,
            "duration_s": round(time.monotonic() - start, 3),
        }
        self._drain_report = report
        self.flight.event("drain", stage="end", **report)
        return report

    def _drain_preempt_pass(self) -> int:
        """The drain's one preempt-and-requeue of every occupied slot, at
        the loop's safe point (no chunk in flight, the pending chunk
        applied, the deferred releases done). Requests stashed for a T2
        prefix or adapter hydration rejoin the queue too: a drain serves or
        sheds every accepted request. Returns the requests requeued."""
        requeued = 0
        # newest first: each requeues at the front, so arrival order holds.
        # A prefix stash closes its hydrate segment as the JAX engine's
        # drain does; an adapter stash (which the JAX drain leaves behind)
        # closes its adapter-hydrate segment the same way
        for request, _deadline_m, what in reversed(self._prefix_hydrating
                                                   + self._adapter_hydrating):
            if request.future.done():
                continue
            if isinstance(what, str):
                self._journey(request, "adapter-hydrate-done", adapter=what,
                              timeout=True, drain=True)
            else:
                self._journey(request, "hydrate-done", timeout=True, drain=True)
            self.scheduler.requeue_front(request)
            requeued += 1
        self._prefix_hydrating = []
        self._adapter_hydrating = []
        for slot_id, slot in enumerate(self.slots):
            request = slot.request
            if request is None or request.future.done():
                continue
            self._preempt_slot(slot_id, reason="drain")
            requeued += 1
        return requeued

    def _drain_section(self) -> dict[str, Any]:
        """``stats()["drain"]``: the final report once a drain finished,
        live counters while it runs."""
        out: dict[str, Any] = {"draining": self._draining}
        if self._drain_report is not None:
            out.update(self._drain_report)
        elif self._draining:
            out.update({
                "requeued": self._drain_requeued,
                "completed": self.completed_requests - self._drain_base_completed,
                "shed": self._drain_shed,
            })
        return out

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    async def _run_loop(self) -> None:
        loop = asyncio.get_running_loop()
        # the loop starts at the first request: the gap since construction
        # is no sample's wall time, and the wedge window measures from here
        self.flight.mark()
        self.watchdog.beat(self.scheduler.qsize())
        if self._journal_replay_pending:
            # the previous process died with accepted work unanswered:
            # requeue it front of class before any new admission
            self._replay_journal(loop)
        while not self._stop:
            try:
                if self._fault_fired:
                    # injected faults reach the ring before what they caused
                    self._drain_fault_events()
                if self._shrink_recover_at is not None:
                    # the pool shrink's recovery probe: a quiet window
                    # restores one quantum (wait-free)
                    self._shrink_step()
                if self.prefix_store is not None:
                    # tier bookkeeping first: hydrations that landed requeue
                    # at their class's front, so the admission below sees them
                    self._prefix_tier_step()
                if self.adapter_store is not None:
                    # adapter hydrations settle at the same safe point:
                    # requeue at the class's front, or a counted refusal
                    self._adapter_tier_step()
                if self._pending_imports:
                    # KV handoff imports land at the safe point, like
                    # admission: a free slot and a worst-case reservation,
                    # then the rows scatter in and the request decodes with
                    # no prefill (queued behind any chunk still in flight)
                    await self._apply_imports(loop)
                if not self.scheduler.empty():
                    await self._admit(loop)
                # a pipelined burst may have left a chunk in flight: applied
                # only after admission, so the prefill above was queued
                # behind it, and before preemption, so a victim's state is
                # settled (the JAX engine's order)
                if self._pending_chunk is not None:
                    await self._drain_pending(loop)
                if self._draining and not self._drain_pass_done:
                    # the drain's one preempt-and-requeue sweep, at the safe
                    # point; the requeued work re-admits below
                    self._drain_pass_done = True
                    self._drain_requeued += self._drain_preempt_pass()
                if not self.scheduler.empty():
                    # the slots the drained chunk freed admit at once; then,
                    # under QoS, a head stalled on KV blocks may preempt a
                    # lower class's victim and land in this pass
                    await self._admit(loop)
                    if self._maybe_preempt():
                        await self._admit(loop)
                if self.prefix_store is not None:
                    # T0 byte-budget demotion at the same safe point: no
                    # chunk is in flight (the pending one is applied, the
                    # burst's deferred releases are done), so the gather
                    # reads settled rows and a freed block cannot be written
                    # by a chunk dispatched before it was freed
                    await self._demote_prefix_blocks(loop)
                if self._has_prefilling():
                    # one bounded chunk per loop pass: long prefills make
                    # progress without stalling the decode chunks below
                    await self._advance_prefills(loop)
                if self._pool_role == "prefill":
                    # a prefill pool exports every slot whose prefill just
                    # finished and releases it instead of decoding
                    await self._export_ready_slots(loop)
                active = [
                    i for i, s in enumerate(self.slots)
                    if not s.free and not s.prefilling
                ]
                self._m_active(len(active))
                self._m_queued(self.scheduler.qsize())
                if not active:
                    if self.scheduler.empty() and not self._has_prefilling():
                        self._wake.clear()
                        # a stashed hydration resolves on the hydrator
                        # thread and a T0 cache over budget has demotions
                        # to run: poll tightly while either is pending
                        idle_s = (0.02 if self._prefix_hydrating
                                  or self._adapter_hydrating
                                  or self._prefix_demote_pending() else 1.0)
                        try:
                            await asyncio.wait_for(self._wake.wait(), timeout=idle_s)
                        except asyncio.TimeoutError:
                            pass
                        # the whole gap was idle: a stall sample keeps the
                        # flight timeline contiguous
                        self._flight_stall("queue-empty")
                    continue
                if self._speculating(active):
                    await self._speculative_burst(loop, active)
                else:
                    await self._decode_burst(loop, active)
            except Exception as e:  # device/runtime error
                if (self._lockstep is None and self._resource_exhausted(e)
                        and self._maybe_pool_shrink(e)):
                    # memory pressure is a load signal: the budget shrank,
                    # the victims requeued front of class, nothing failed
                    continue
                # otherwise fail the in-flight work, free the slots, keep
                # serving (callers see the exception)
                log.exception("serving engine step failed")
                if self._lockstep is not None and not isinstance(e, LockstepBroken):
                    # leading a group: any step failure is group-fatal (the
                    # followers may have replayed collectives this process
                    # aborted mid-step, or a collective timed out on a dead
                    # peer), so wrap it in the one loud type
                    e = LockstepBroken(f"multi-host step failed: {type(e).__name__}: {e}")
                self._fail_inflight(e)
                if isinstance(e, LockstepBroken):
                    # a lost follower is unrecoverable for this group: stop
                    # serving, so the slice restarts as a unit
                    log.error("lockstep group broken; engine stops serving")
                    self.flight.event("lockstep-divergence", error=str(e)[:200])
                    self._stop = True
        if self._pending_chunk is not None:
            # a stop between a pipelined burst and the next pass leaves one
            # chunk in flight: apply it, so dispatches and fetches stay 1:1
            await self._drain_pending(loop)

    def _has_prefilling(self) -> bool:
        return any(s.prefilling for s in self.slots)

    def _fail_inflight(self, error: Exception) -> None:
        self.flight.event(
            "preempt", error=f"{type(error).__name__}: {error}"[:200],
            inflight=sum(1 for s in self.slots if not s.free),
        )
        # a pending chunk belongs to the failed dispatch stream: dropped;
        # the releases a pipelined burst deferred happen now
        self._pending_chunk = None
        self._settled.set()
        self._defer_release = False
        self._flush_deferred_releases()
        # stale inline-adaptation counts must not reach a later shrink
        self._shrink_inline_preempted = 0
        self._shrink_inline_shed = 0
        error_text = f"{type(error).__name__}: {error}"[:160]
        for slot_id, slot in enumerate(self.slots):
            request = slot.request
            if request is None:
                continue
            self._release_slot(slot_id)
            if not request.future.done():
                request.future.set_exception(error)
                self._journey(request, "fail", error=error_text)
                if not request.warmup:
                    self._slo_record("availability", False)
            # an explicitly failed request was answered: a restart must not
            # replay a served error
            self._journal_retire(request)
        # queued work, imports not yet landed and hydration stashes fail
        # with the loop's error too, as in the JAX engine: a stash outliving
        # the failure would strand its future
        for request in (self.scheduler.drain()
                        + [entry[2] for entry in self._pending_imports]
                        + [entry[0] for entry in self._prefix_hydrating]
                        + [entry[0] for entry in self._adapter_hydrating]):
            self._adapter_release(request)  # a pin kept while queued
            if not request.future.done():
                request.future.set_exception(error)
                self._journey(request, "fail", error=error_text)
                if not request.warmup:
                    self._slo_record("availability", False)
            self._journal_retire(request)
        self._pending_imports.clear()
        self._prefix_hydrating = []
        self._adapter_hydrating = []
        self._pending_emits.clear()
        self._finished_requests.clear()

    def _release_slot(self, slot_id: int) -> None:
        slot = self.slots[slot_id]
        request = slot.request
        if (request is not None and request.future.cancelled()
                and request.on_chunk is not None and self.config.streaming
                and not request.stream_cancel_counted):
            # a cancelled stream held this slot: counted once here, and
            # reclaimed when its blocks are released
            request.stream_cancel_counted = True
            self.stream_cancels_total += 1
            self._reclaim_pending.add(slot_id)
        slot.request = None
        slot.prefilling = False
        slot.prefill_done = 0
        self._lengths[slot_id] = 0
        self._ctx_synced[slot_id] = 0
        if request is not None:
            self._adapter_release(request)
        if self._ad_rows is not None:
            # the slot computes the base model again: a chunk dispatched
            # after this reads row 0 for it (an in-flight one still reads
            # the pinned row it was dispatched with)
            self._ad_rows[slot_id] = 0
        self._release_blocks(slot_id)

    def _release_blocks(self, slot_id: int) -> None:
        """Free a slot's blocks: at once between bursts, at the end of the
        burst inside a pipelined one (its in-flight chunk still commits
        through the tables taken at dispatch). Between bursts an immediate
        release is safe: the prefill that takes the blocks is queued behind
        any chunk still in flight, on the same stream, so it writes last."""
        if self.block_mgr is not None and self._defer_release:
            self._deferred_releases.append(slot_id)
            return
        if self.block_mgr is not None:
            self.block_mgr.release(slot_id)
        self._note_reclaimed(slot_id)

    def _flush_deferred_releases(self) -> None:
        for slot_id in self._deferred_releases:
            self.block_mgr.release(slot_id)
            self._note_reclaimed(slot_id)
        self._deferred_releases.clear()

    def _note_reclaimed(self, slot_id: int) -> None:
        if slot_id in self._reclaim_pending:
            self._reclaim_pending.discard(slot_id)
            self.stream_reclaims_total += 1

    # ------------------------------------------------------------------
    # admission plane: deadline shed, preemption and resume
    # ------------------------------------------------------------------

    def _note_deadline_shed(self, request: _Request, where: str, left: float,
                            estimate: float = 0.0) -> DeadlineExceeded:
        """Record one deadline refusal (counter, ``deadline-exceeded``
        flight event, a bad shed-rate event) and build the error the caller
        raises or sets."""
        self.deadline_sheds += 1
        if self._m_deadline_shed is None:
            # registered at first use: a deadline-less engine's scrape
            # surface stays the default one
            self._m_deadline_shed = self._reporter.counter(
                "deadline_shed_total",
                "requests refused because the remaining langstream-deadline budget "
                "could not cover the admission estimate (504-shaped; "
                "docs/RESILIENCE.md)")
        self._m_deadline_shed(1)
        self.flight.event("deadline-exceeded", where=where, remaining_s=round(left, 6),
                          estimate_s=round(estimate, 6), tenant=request.tenant,
                          priority=request.priority)
        self._journey(request, "deadline-exceeded", where=where,
                      remaining_s=round(left, 6))
        if not request.warmup:
            self._slo_record("shed-rate", False)
        return DeadlineExceeded(
            f"deadline exceeded at {where}: {left:.3f}s of budget left, "
            f"admission estimate {estimate:.3f}s",
            overrun_s=max(0.0, estimate - left),
        )

    def _admit_estimate_s(self) -> float:
        """What a deadline must still cover at admission: the median of the
        last 32 served requests' prefill times (0.0 without history, so a
        fresh engine sheds only spent budgets)."""
        vals = sorted(t.get("prefill", 0.0) for t in list(self.request_timings)[-32:]
                      if not t.get("imported"))
        return vals[len(vals) // 2] if vals else 0.0

    def _maybe_preempt(self) -> bool:
        """Under QoS, when admission stalls on ``no-kv-blocks`` and the
        scheduler's cost model names a running victim (a strictly lower
        class than the stalled head, preemptions left, more deadline slack
        than the head), preempt it so the head's blocks free at once. True
        when a slot was preempted (the caller admits again). Runs at the
        loop's safe point: no chunk is in flight and no release deferred,
        so the victim's blocks can go to the head's prefill at once."""
        if not self._qos_enabled or self.block_mgr is None:
            return False
        if self._admission_stall() != "no-kv-blocks":
            return False
        head = self.scheduler.peek()
        if head is None:
            return False
        running = [(i, s.request) for i, s in enumerate(self.slots)
                   if s.request is not None and not s.prefilling]
        victim = self.scheduler.preempt_candidate(head, running)
        if victim is None:
            return False
        self._preempt_slot(victim)
        return True

    def _preempt_slot(self, slot_id: int, reason: str = "no-kv-blocks") -> None:
        """Preempt one running request: its generated tokens and sampling
        settings are its snapshot (a resume re-prefills
        ``context_tokens``). The slot, its device length and its blocks
        free now; the request requeues at the front of its class, so its
        resume waits on the pressure, not the backlog."""
        request = self.slots[slot_id].request
        now = time.monotonic()
        self._release_slot(slot_id)
        # the release dropped the adapter pin (the row may evict meanwhile):
        # re-admission re-resolves, and may hydrate again
        request.adapter_hydrate_attempted = False
        request.preemptions += 1
        request.preempt_time = now
        self.scheduler.note_preempted(request)
        self.scheduler.requeue_front(request)
        if self._m_preempted is not None:
            self._m_preempted(1)
        if self._m_preempt_hist is not None and request.admit_time is not None:
            self._m_preempt_hist(now - request.admit_time)
        self.flight.event("preempt", reason=reason, priority=request.priority,
                          tenant=request.tenant, generated=len(request.generated))
        self._journey(request, "preempt", reason=reason, generated=len(request.generated))
        if request.trace is not None:
            record_span("engine.preempt", f"engine:{self.config.model}", request.trace,
                        now, now, attributes={"generated": len(request.generated)})

    def _note_resume(self, request: _Request) -> None:
        """A preempted request was just readmitted: a ``resume`` flight
        event with the wait since its preemption."""
        if request.preempt_time is None:
            return
        now = time.monotonic()
        waited = now - request.preempt_time
        if self._m_resume_hist is not None:
            self._m_resume_hist(waited)
        self.flight.event("resume", priority=request.priority, tenant=request.tenant,
                          generated=len(request.generated),
                          waited_ms=round(waited * 1000.0, 3))
        self._journey(request, "resume", waited_ms=round(waited * 1000.0, 3),
                      generated=len(request.generated))
        if request.trace is not None:
            record_span("engine.resume", f"engine:{self.config.model}", request.trace,
                        request.preempt_time, now,
                        attributes={"generated": len(request.generated)})
        request.preempt_time = None

    def _journey(self, request: _Request, kind: str, **detail: Any) -> None:
        """Append one lifecycle edge to the request's journey
        (serving/journey.py): a wait-free append, so it may run on the
        loop or the dispatch thread. Warmup probes have no journey id and
        record nothing."""
        if request.journey_id is not None:
            JOURNEYS.record(request.journey_id, kind, **detail)

    # ------------------------------------------------------------------
    # device-survival plane: fault seams, adaptive pool shrink, journal
    # ------------------------------------------------------------------

    @staticmethod
    def _resource_exhausted(error: BaseException) -> bool:
        """True for a device allocator failure: PyTorch's out-of-memory
        types, or a message with one of the JAX package's spellings (an
        injected fault, the block manager's ``pool exhausted``) or
        PyTorch's (``CUDA out of memory``, ``CUDA error: out of memory``,
        ``CUBLAS_STATUS_ALLOC_FAILED``). A spelling this misses fails the
        in-flight work instead of adapting, so each is pinned by a test."""
        if _OOM_TYPES and isinstance(error, _OOM_TYPES):
            return True
        return bool(_RESOURCE_EXHAUSTED_RE.search(f"{type(error).__name__}: {error}"))

    def _fault(self, site: str) -> None:
        """The fault-injection seam (tests and chaos drills only): one
        attribute test on an engine without plans. A fired fault is queued
        for a ``fault-injected`` flight event at the loop's next safe point
        (the seams run on several threads, the ring is the loop's), then
        acted on: an ``oom`` raises :class:`InjectedFault`, a ``hang``
        stalls the calling thread (the heartbeat stops; ``health()`` reads
        WEDGED until it ends)."""
        faults = self._faults
        if faults is None:
            return
        action = faults.fire(site)
        if action is None:
            return
        self._fault_fired.append({
            "site": site, "shape": action.shape, "fire": action.seq,
            "hang_ms": action.hang_ms if action.shape == "hang" else None,
        })
        if action.shape == "hang":
            time.sleep(action.hang_ms / 1000.0)
            return
        raise InjectedFault(site, action.message)

    def _drain_fault_events(self) -> None:
        """Emit the queued ``fault-injected`` events (loop thread), before
        any ``pool-shrink`` they cause: the ring reads cause, then effect."""
        while self._fault_fired:
            self.flight.event("fault-injected", **self._fault_fired.popleft())

    def _shed_stranded(self, slot_id: int, error: Exception) -> None:
        """Shed a request whose prefill keeps failing past
        ``_SHRINK_RETRY_CAP`` retries: the card cannot serve it now, so the
        answer is :class:`RateLimited` ``"device-oom"`` with a retry hint
        (another replica may have the memory), never a livelock and never a
        silent drop."""
        request = self.slots[slot_id].request
        self._release_slot(slot_id)
        self.flight.event("shed", reason="device-oom", tenant=request.tenant,
                          priority=request.priority, retry_after_s=2.0,
                          retries=request.preemptions)
        self._journey(request, "shed", reason="device-oom", retries=request.preemptions)
        if self._m_shed is not None:
            self._m_shed(1)
        if not request.warmup:
            self._slo_record("availability", False)
        self._journal_retire(request)
        if not request.future.done():
            request.future.set_exception(RateLimited(
                "device-oom", 2.0,
                f"device memory pressure persisted across {request.preemptions} "
                f"adaptation retries ({type(error).__name__}: {error}); retry "
                f"another replica",
            ))

    def _shrink_victim(self) -> int | None:
        """The next victim under memory pressure: the occupied slot of the
        lowest priority class, the least generated progress breaking ties
        (the cheapest resume). Mid-prefill slots qualify: their worst-case
        reservations are the blocks the shrink needs back."""
        best = best_key = None
        for slot_id, slot in enumerate(self.slots):
            request = slot.request
            if request is None:
                continue
            key = (-priority_rank(request.priority), len(request.generated))
            if best_key is None or key < best_key:
                best, best_key = slot_id, key
        return best

    def _maybe_pool_shrink(self, error: Exception) -> bool:
        """Adapt to an allocator failure instead of failing the work in
        flight: withhold one quantum (``shrink-fraction`` of the configured
        pool) from the admission budget, requeue the slots whose monolithic
        prefill never landed (``_lengths == 0``: no row of theirs is
        trustworthy, the failed dispatch may have been theirs) or shed them
        past the retry cap, preempt the lowest-class victims until the
        reservations fit the budget, and arm the recovery probe. Runs on
        the loop at the exception edge, where nothing is in flight (the
        pipelined burst fetched its dispatched chunks before re-raising;
        their host state is unchanged, so the next dispatch rewrites their
        rows). False when nothing could be adapted: the caller fails the
        work loudly."""
        bm = self.block_mgr
        if bm is None:
            return False
        self._drain_fault_events()  # cause before effect in the ring
        quantum = max(1, int(bm.configured_blocks * self.config.shrink_fraction))
        reduced = bm.reduce_budget(quantum)
        reserved_before = bm.reserved_blocks
        preempted, shed = self._shrink_inline_preempted, self._shrink_inline_shed
        self._shrink_inline_preempted = self._shrink_inline_shed = 0
        for slot_id, slot in enumerate(self.slots):
            if (slot.request is not None and not slot.prefilling
                    and int(self._lengths[slot_id]) == 0):
                if slot.request.preemptions >= _SHRINK_RETRY_CAP:
                    self._shed_stranded(slot_id, error)
                    shed += 1
                else:
                    self._preempt_slot(slot_id, reason="pool-shrink")
                    preempted += 1
        while bm.reserved_blocks > bm.usable_blocks:
            victim = self._shrink_victim()
            if victim is None:
                break
            self._preempt_slot(victim, reason="pool-shrink")
            preempted += 1
        if reduced == 0 and preempted == 0 and shed == 0:
            return False
        self.pool_shrinks += 1
        self.shrink_preempted += preempted
        self._m_shrinks(1)
        self._m_budget(bm.usable_blocks)
        self._shrink_recover_at = time.monotonic() + self.config.shrink_recovery_s
        freed = reserved_before - bm.reserved_blocks
        # the evidence precedes any admission against the new budget
        self.flight.event(
            "pool-shrink",
            site=getattr(error, "fault_site", None) or "device",
            error=f"{type(error).__name__}: {error}"[:160],
            withheld_blocks=reduced, withheld_bytes=reduced * self._kv_block_bytes,
            freed_blocks=freed, freed_bytes=freed * self._kv_block_bytes,
            preempted=preempted, shed=shed, budget_blocks=bm.usable_blocks,
            configured_blocks=bm.configured_blocks,
            recovery_s=self.config.shrink_recovery_s,
        )
        log.warning("device memory pressure (%s): KV budget shrunk to %d/%d blocks, "
                    "%d victims requeued front of class", type(error).__name__,
                    bm.usable_blocks, bm.configured_blocks, preempted)
        return True

    def _shrink_step(self) -> None:
        """The recovery probe (loop thread, wait-free: at each loop pass and
        each recorded dispatch): restore one quantum for every quiet
        ``shrink-recovery-s`` window that has closed since the last
        allocator failure (which pushed the first window out). The windows
        keep their schedule whatever the probe's rate (a K=32 chunk can
        outlast a window), and the budget still comes back one quantum per
        window, so pressure that persists re-shrinks at once and shows as
        repeated shrinks, not as a swinging budget. Host bookkeeping only: a
        restore inside a burst changes what the next admission may
        reserve."""
        at = self._shrink_recover_at
        bm = self.block_mgr
        now = time.monotonic()
        if at is None or bm is None or now < at:
            return
        quantum = max(1, int(bm.configured_blocks * self.config.shrink_fraction))
        while at <= now and bm.budget_reduction:
            restored = bm.restore_budget(quantum)
            self.pool_restores += 1
            self._m_restores(1)
            self._m_budget(bm.usable_blocks)
            self.flight.event("pool-restore", restored_blocks=restored,
                              restored_bytes=restored * self._kv_block_bytes,
                              budget_blocks=bm.usable_blocks,
                              configured_blocks=bm.configured_blocks)
            at += self.config.shrink_recovery_s
        if bm.budget_reduction == 0:
            self._shrink_recover_at = None
            self._wake.set()  # restored headroom may admit
        else:
            self._shrink_recover_at = at

    def _replay_journal(self, loop) -> None:
        """Requeue the previous process's accepted, unanswered entries
        front of class (the preemption resume path), ahead of anything this
        process accepted. Each gets a fresh future whose completion or
        explicit failure retires the entry, so each entry retires once. The
        clamps of :meth:`generate` apply (this engine may have a shorter
        context or a smaller pool); an entry that no longer fits, or a
        corrupt one, is retired loudly, never left to block admission."""
        entries, self._journal_replay_pending = self._journal_replay_pending, []
        replayed = 0
        S = self.model_config.max_seq_len
        for entry in reversed(entries):  # each to the front: order holds
            try:
                tokens = [int(t) for t in entry["prompt"]]
                if len(tokens) > S - 2:
                    tokens = tokens[-(S - 2):]
                max_tokens = min(int(entry["max-tokens"]), S - len(tokens) - 1)
                if max_tokens < 1 or (self.block_mgr is not None and not
                                      self.block_mgr.fits_ever(len(tokens) + max_tokens + 1)):
                    raise ValueError("request no longer fits the restarted engine's KV pool")
                request = _Request(
                    prompt_tokens=tokens, max_tokens=max_tokens,
                    temperature=float(entry.get("temperature", 0.0)),
                    top_k=int(entry.get("top-k", 0)),
                    top_p=float(entry.get("top-p", 1.0)),
                    future=loop.create_future(),
                    presence_penalty=float(entry.get("presence-penalty", 0.0)),
                    frequency_penalty=float(entry.get("frequency-penalty", 0.0)),
                    enqueue_time=time.monotonic(),
                    stop=_normalize_stop(entry.get("stop")),
                    tenant=str(entry.get("tenant", "") or ""),
                    priority=normalize_priority(entry.get("priority")),
                    # the original budget: the admission gate sheds it if
                    # the crash outlived it
                    deadline=parse_deadline(entry.get("deadline")),
                )
            except (KeyError, TypeError, ValueError) as e:
                log.error("journal entry unreplayable (%s): %r", e, entry)
                self.journal.retire(entry.get("id"))
                continue
            request.journey_id = entry.get("id")
            self._journey(request, "journal-replay")
            # nobody awaits a replayed future: retrieve its outcome so a
            # shed replay does not log "exception never retrieved"
            request.future.add_done_callback(
                lambda f: f.exception() if not f.cancelled() else None)
            self.scheduler.requeue_front(request)
            replayed += 1
        if replayed:
            self.journal.note_replayed(replayed)
            self.flight.event("journal-replay", requests=replayed)
            log.info("journal replay: %d accepted, unanswered requests requeued "
                     "front of class", replayed)

    def _journal_retire(self, request: _Request) -> None:
        """Retire a request's journal entry on a path that answered its
        caller (a deque append; warmup probes were never journaled)."""
        if self.journal is not None and not request.warmup:
            self.journal.retire(request.journey_id)
            self._m_journal_depth(self.journal.depth())

    def handoff_settled(self, request_id: str) -> None:
        """The decode side answered this handoff (a result or a terminal
        refusal): the prefill-side journal entry retires. Until then it
        stays live, so a decode pod dying mid-handoff leaves the request to
        replay here. Idempotent."""
        journal_id = self._handoff_journal.pop(request_id, None)
        if journal_id is not None and self.journal is not None:
            self.journal.retire(journal_id)
            self._m_journal_depth(self.journal.depth())

    def survival_section(self) -> dict[str, Any]:
        """``stats()["survival"]``: the live budget against the configured
        one, shrink and restore counts, the deadline and cross-replica
        counters, the armed faults and the journal (the JAX engine's keys).
        Attribute reads and small copies."""
        bm = self.block_mgr
        out: dict[str, Any] = {
            "shrinks": self.pool_shrinks,
            "restores": self.pool_restores,
            "shrink_preempted": self.shrink_preempted,
            "recovery_s": self.config.shrink_recovery_s,
            "recovering": self._shrink_recover_at is not None,
            "deadline_sheds": self.deadline_sheds,
            "deadline_overruns": self.deadline_overruns,
            "handoff_retries": self.handoff_retries,
            "handoff_fallbacks": self.handoff_fallbacks,
        }
        if bm is not None:
            out["budget_blocks"] = bm.usable_blocks
            out["configured_blocks"] = bm.configured_blocks
            out["withheld_blocks"] = bm.budget_reduction
            out["withheld_bytes"] = bm.budget_reduction * self._kv_block_bytes
        if self._faults is not None:
            out["faults"] = self._faults.stats()
        if self.journal is not None:
            out["journal"] = self.journal.stats()
        return out

    # ------------------------------------------------------------------
    # tiered prefix store (serving/prefixstore.py)
    # ------------------------------------------------------------------

    def _note_prefix_pool_evict(self, digest_hex: str, block: int) -> None:
        """Pool pressure evicted a cached prefix block with no demotion
        (``BlockManager._evict_one``): the T0 loss is counted and evented,
        never silent."""
        self.prefix_t0_evictions += 1
        if self._m_prefix_tier:
            self._m_prefix_tier["evictions"](1)
        self.flight.event("prefix-evict", tier="t0", digest=digest_hex[:16],
                          bytes=self._kv_block_bytes, reason="pool-pressure")

    def _emit_store_events(self, events) -> None:
        """Drain a tier store's pending events (prefix or adapter) into the
        flight ring and mirror each transition onto its counter: the one
        emission path of both stores, so the scrape never drifts from the
        events."""
        for kind, detail in events:
            self.flight.event(kind, **detail)
            if kind.startswith("adapter-"):
                if not self._m_adapters:
                    continue
                if kind == "adapter-evict":
                    self._m_adapters["evictions"](1)
                elif kind == "adapter-demote":
                    self._m_adapters["demotions"](1)
                elif kind == "adapter-load":
                    self._m_adapters["loads"](1)
                elif kind == "adapter-hydrate" and detail.get("stage") == "fetched":
                    self._m_adapters["hydrations"](1)
                continue
            if not self._m_prefix_tier:
                continue
            if kind == "prefix-demote":
                self._m_prefix_tier["demotions"](1)
            elif kind == "prefix-evict":
                self._m_prefix_tier["evictions"](1)
            elif kind == "prefix-promote":
                self._m_prefix_tier["t1_hits"](detail.get("blocks") or 1)
            elif kind == "prefix-hydrate" and detail.get("stage") == "fetched":
                self._m_prefix_tier["t2_hits"](1)

    def _prefix_tier_step(self) -> None:
        """Tier bookkeeping at the loop's safe point (wait-free): apply the
        hydrator's results, emit the store's events, and settle the
        hydration stash. A request whose T2 fetches landed in T1, failed
        or timed out requeues at the FRONT of its class, so the admission
        right after finds it; a timeout is a counted cold compute."""
        store = self.prefix_store
        store.apply_results()
        self._emit_store_events(self.prefix_store.drain_events())
        if not self._prefix_hydrating:
            return
        now = time.monotonic()
        still_waiting = []
        # newest first: each settled request requeues at the front, so the
        # oldest ends at the head and arrival order survives
        for request, deadline_m, digests in reversed(self._prefix_hydrating):
            if request.future.cancelled():
                self._journey(request, "cancelled", stage="prefix-hydrate")
                continue
            ready = all(store.t1_has(d) for d in digests)
            pending = any(store.hydrating(d) for d in digests)
            if not ready and pending and now < deadline_m:
                still_waiting.append((request, deadline_m, digests))
                continue
            # ready, failed or timed out: admission promotes what T1 holds
            # and prefills the rest
            hit = sum(1 for d in digests if store.t1_has(d))
            timed_out = not ready and now >= deadline_m
            if timed_out:
                store.hydrate_failures += 1
            self.flight.event("prefix-hydrate", stage="timeout" if timed_out else "done",
                              blocks=hit, requested=len(digests))
            self._journey(request, "hydrate-done", blocks=hit, requested=len(digests),
                          timeout=timed_out)
            self.scheduler.requeue_front(request)
        still_waiting.reverse()
        self._prefix_hydrating = still_waiting

    def _prefix_demote_pending(self) -> bool:
        """The T0 prefix cache is over its byte budget and has demotion
        candidates (the idle loop polls tightly while it is)."""
        store = self.prefix_store
        if store is None or store.spec.t0_bytes is None:
            return False
        if self.block_mgr.prefix_block_count() * self._kv_block_bytes <= store.spec.t0_bytes:
            return False
        return bool(self.block_mgr.evictable_prefixes(1))

    def _chain_t2_candidates(self, chain: list[bytes]) -> list[str]:
        """The chain digests an admission should wait for: the consecutive
        run, from where T0 and T1 coverage ends, of digests the T2 index
        knows (empty: nothing worth stashing for). Membership tests only."""
        store = self.prefix_store
        out: list[str] = []
        for d in chain:
            if self.block_mgr.prefix_has(d):
                continue
            h = d.hex()
            if store.t1_has(h):
                continue
            if store.t2_has(h) or store.hydrating(h):
                out.append(h)
            else:
                break  # a gap: deeper links are unreachable anyway
        return out

    async def _promote_prefix(self, loop, request: _Request, chain: list[bytes]) -> int:
        """Promote the T1 run that extends this prompt's T0 chain into
        freshly allocated pool blocks (T1 -> T0): take the entries, install
        cache-owned blocks, and scatter the host rows in on the dispatch
        thread through :func:`kvtransfer.scatter_slot` (pinned uploads
        without blocking, then one timed wait for the scatter). The
        ``match_prefix`` after it sees the longer chain. Returns the blocks
        promoted (0: nothing to do, or no pool space)."""
        store = self.prefix_store
        run: list[tuple[bytes, bytes]] = []  # (digest, parent)
        prev = b""
        for d in chain:
            if self.block_mgr.prefix_has(d):
                prev = d
                continue
            if not store.t1_has(d.hex()):
                break
            run.append((d, prev))
            prev = d
        if not run:
            return 0
        entries = []
        for d, _parent in run:
            entry = store.take_t1(d.hex())
            if entry is None:  # raced with a shrink: the run ends here
                break
            entries.append(entry)
        run = run[: len(entries)]
        if not entries:
            return 0
        blocks = self.block_mgr.install_prefix_chain(run)
        if blocks is None:
            # no pool space even after eviction: the entries go back (MRU,
            # they were just wanted) and the prompt computes cold
            for (d, parent), entry in zip(run, entries):
                store.insert_t1(d.hex(), parent.hex() if parent else "",
                                entry["arrays"], source="t2")
            return 0
        rows = len(blocks) * self.paged_layout.block_size
        # rows pad to the import path's power-of-two bucket and the table
        # row to the slot's width (pad rows go to the scratch block)
        padded = _bucket(rows, hi=self.model_config.max_seq_len)
        table_row = np.zeros(self.paged_layout.max_blocks_per_slot, dtype=np.int32)
        table_row[: len(blocks)] = blocks
        # each name's per-block rows in chain order (the scatter uploads them
        # block by block: demoted blocks are pinned already)
        arrays = {name: [e["arrays"][name] for e in entries] for name in entries[0]["arrays"]}
        try:
            device_s = await loop.run_in_executor(
                self._executor, partial(self._run_scatter, arrays, table_row, rows, padded))
        except Exception:
            # the installed blocks never received their rows: unpublish them
            # (leaf first) and hand the entries back to T1 before the error
            # goes on to the loop
            for (d, parent), entry in reversed(list(zip(run, entries))):
                self.block_mgr.drop_prefix(d)
                store.insert_t1(d.hex(), parent.hex() if parent else "",
                                entry["arrays"], source="t2")
            raise
        nbytes = sum(e["nbytes"] for e in entries)
        store.note_promoted(len(blocks), nbytes, device_ms=device_s * 1e3)
        self._emit_store_events(self.prefix_store.drain_events())
        return len(blocks)

    @torch.no_grad()
    def _run_scatter(self, arrays, table_row, rows: int, padded: int) -> float:
        """Dispatch thread: write host rows into the pools through one
        block-table row (a promotion or an import), then wait for the
        scatter. Returns its device seconds: the CUDA-event span on the
        card, the wall of the (synchronous) scatter on the CPU."""
        self._fault("scatter")
        start = self._timing_event()
        t0 = time.monotonic()
        self.cache_k, self.cache_v = kvtransfer.scatter_slot(
            self.cache_k, self.cache_v, arrays, table_row, rows, padded)
        end = self._timing_event()
        if end is None:
            return time.monotonic() - t0
        end.synchronize()
        return self._span_s(start, end)

    async def _demote_prefix_blocks(self, loop) -> None:
        """T0 byte-budget enforcement at the loop's safe point: while the
        prefix cache is over ``t0-bytes``, gather up to four LRU cache-only
        leaf blocks to host in ONE timed fetch, hand their rows to T1, then
        free the pool blocks. Bounded per pass, so a storm never starves
        admission."""
        store = self.prefix_store
        budget = store.spec.t0_bytes
        if budget is None or self._kv_block_bytes <= 0:
            return
        over = self.block_mgr.prefix_block_count() * self._kv_block_bytes - budget
        if over <= 0:
            return
        candidates = self.block_mgr.evictable_prefixes(min(4, -(-over // self._kv_block_bytes)))
        if not candidates:
            return
        table_row = np.asarray([b for _, b, _ in candidates], dtype=np.int32)
        blocks, device_s = await loop.run_in_executor(
            self._executor, partial(self._run_gather, table_row, None))
        self.prefix_demote_fetches += 1
        self.prefix_demote_s += device_s
        for (digest, _block, parent), rows in zip(candidates, blocks):
            if self.block_mgr.drop_prefix(digest) is None:
                continue  # re-referenced while gathering: it stays in T0
            store.insert_t1(digest.hex(), parent.hex() if parent else "", rows)
        self._emit_store_events(self.prefix_store.drain_events())

    @torch.no_grad()
    def _run_gather(self, table_row, rows: int | None):
        """Dispatch thread: gather the blocks of one table row and fetch
        them in one timed device-to-host fetch: their first ``rows`` rows
        (:func:`kvtransfer.fetch_rows`, an export), or block by block with
        ``rows=None`` (:func:`kvtransfer.fetch_blocks`, a demotion)."""
        gathered_k, gathered_v = kvtransfer.gather_slot(
            self.cache_k, self.cache_v, table_row, len(table_row))
        if rows is None:
            return kvtransfer.fetch_blocks(gathered_k, gathered_v, len(table_row))
        return kvtransfer.fetch_rows(gathered_k, gathered_v, rows)

    def prefix_store_section(self) -> dict[str, Any]:
        """``stats()["prefixstore"]``: per-tier bytes against budget, hit,
        demotion and eviction counters and the exact byte ledger (the JAX
        engine's keys); snapshot reads and arithmetic."""
        store = self.prefix_store
        t0_blocks = self.block_mgr.prefix_block_count()
        self._m_prefix_tier["t0_bytes"](t0_blocks * self._kv_block_bytes)
        self._m_prefix_tier["t1_bytes"](store.t1_bytes)
        self._m_prefix_tier["t2_bytes"](store.t2_bytes)
        return {
            "t0": {
                "blocks": t0_blocks,
                "bytes": t0_blocks * self._kv_block_bytes,
                "budget_bytes": store.spec.t0_bytes,
                "hits": self.prefix_hits,
                "tokens_reused": self.prefix_tokens,
                "pool_evictions": self.prefix_t0_evictions,
                # the demotion's device-to-host fetches and their waits
                "demote_fetches": self.prefix_demote_fetches,
                "demote_seconds": self.prefix_demote_s,
            },
            "hydrating_requests": len(self._prefix_hydrating),
            **store.stats(),
        }

    # ------------------------------------------------------------------
    # multi-LoRA adapter tiers (serving/adapters.py)
    # ------------------------------------------------------------------

    def adapter_fingerprint(self) -> dict[str, Any]:
        """The facts a LoRA adapter blob must agree on before its factors
        may touch the device buffers, spelled as the JAX engine spells them
        (so both packages' blobs cross): serialized into every T2 header
        and checked on fetch (a mismatch is refused AND deleted).
        Attribute reads only."""
        mc = self.model_config
        spec = self.config.adapter_store
        return {
            "model": self.config.model,
            "dtype": _DTYPE_NAMES[mc.dtype],
            "rank": spec.rank if spec is not None else 0,
            "layers": mc.layers,
            "hidden": mc.hidden,
            "heads": mc.heads,
            "kv-heads": mc.kv_heads,
            "head-dim": mc.head_dim,
        }

    def _adapter_factor_shapes(self) -> dict[str, tuple[int, int]]:
        """One layer's shape of each LoRA factor at the store's rank."""
        mc = self.model_config
        r = self.config.adapter_store.rank
        q_dim = mc.heads * mc.head_dim
        kv_dim = mc.kv_heads * mc.head_dim
        return {
            "wq_a": (mc.hidden, r), "wq_b": (r, q_dim),
            "wk_a": (mc.hidden, r), "wk_b": (r, kv_dim),
            "wv_a": (mc.hidden, r), "wv_b": (r, kv_dim),
            "wo_a": (q_dim, r), "wo_b": (r, mc.hidden),
        }

    def _adapter_entry_bytes(self) -> int:
        """Device bytes one resident adapter row occupies across the eight
        stacked factor buffers (all layers, model dtype)."""
        mc = self.model_config
        per_layer = sum(a * b for a, b in self._adapter_factor_shapes().values())
        return mc.layers * per_layer * torch.empty((), dtype=mc.dtype).element_size()

    def install_adapter(self, name: str, arrays: dict[str, Any]) -> None:
        """Install LoRA factors into the store's T1 tier directly (the local
        load path: tests, bench seeding, a sidecar that fetched them out of
        band). Shapes are checked against the model here, so a wrong-rank
        adapter fails at install, not mid-decode."""
        if self.adapter_store is None:
            raise ValueError("adapter store not configured (serving adapter-store)")
        layers = self.model_config.layers
        for k, shape in self._adapter_factor_shapes().items():
            expect = (layers, *shape)
            got = tuple(arrays[k].shape) if k in arrays else None
            if got != expect:
                raise ValueError(
                    f"adapter {name!r} factor {k}: shape {got}, model expects {expect}"
                )
        self.adapter_store.install(name, arrays)

    async def _resolve_adapter(self, loop, request: _Request) -> str:
        """Admission-side adapter resolve. Returns one of:

        - ``"ready"``: a device row holds the adapter; the request is pinned
          against eviction and carries the row index;
        - ``"wait"``: the adapter is hydrating T2 -> T1; the request was
          popped and stashed off the scheduler (it never blocks the head);
        - ``"refused"``: unknown adapter or a spent hydration attempt; the
          request was popped and failed with :class:`AdapterUnavailable`;
        - ``"backpressure"``: every T0 row is pinned by in-flight requests;
          the caller ends the admission pass and retries after decode frees
          pins.

        Wait-free on the loop side apart from the one awaited row copy (the
        T2 I/O runs on the hydrator)."""
        store = self.adapter_store
        name = request.adapter
        row = store.t0_row(name)
        if row is None and store.t1_has(name):
            row = store.t0_assign(name)
            if row is None:
                return "backpressure"
            await self._load_adapter_row(loop, name, row)
        if row is not None:
            request.adapter_row = row
            store.pin(name)
            request.adapter_pinned = True
            return "ready"
        if (not request.adapter_hydrate_attempted and not self._draining
                and (store.t2_has(name) or store.hydrating(name))):
            request.adapter_hydrate_attempted = True
            if store.request_hydration([name]):
                self.scheduler.pop()
                deadline_m = time.monotonic() + store.spec.hydrate_timeout_s
                self._adapter_hydrating.append((request, deadline_m, name))
                store.hydrations += 1
                self.flight.event("adapter-hydrate", stage="begin", adapter=name)
                self._journey(request, "adapter-hydrate", adapter=name)
                return "wait"
        self.scheduler.pop()
        self.adapter_refusals += 1
        self.flight.event("adapter-refused", adapter=name)
        self._journal_retire(request)
        if not request.future.done():
            request.future.set_exception(AdapterUnavailable(
                f"adapter {name!r} unavailable: not resident in any tier "
                "(install it or publish it to the T2 origin)"))
        return "refused"

    async def _load_adapter_row(self, loop, name: str, row: int) -> None:
        """Copy a T1-resident adapter's factors into device row ``row`` (T1
        -> T0) on the dispatch thread, the only thread that touches the
        buffers: the copy is queued on the stream behind every chunk
        dispatched before it, which still reads the old row."""
        store = self.adapter_store
        arrays = store.t1_peek(name)["arrays"]
        device_ms = await loop.run_in_executor(
            self._executor, partial(self._run_adapter_load, arrays, row))
        store.note_loaded(name, row, device_ms)

    @torch.no_grad()
    def _run_adapter_load(self, arrays: dict[str, Any], row: int) -> float:
        """Dispatch thread: write one adapter's factors into row ``row`` of
        the stacked buffers in place. Each host factor uploads from pinned
        memory without blocking (the caching host allocator keeps the
        staging block until its copy has run) and converts to the model
        dtype on the card; one timed wait for the copies. Returns their
        device milliseconds: the CUDA-event span on the card, the wall on
        the CPU."""
        start = self._timing_event()
        t0 = time.monotonic()
        for k in FACTOR_KEYS:
            self._ad_layers[k][:, row].copy_(kvtransfer.upload(arrays[k], self.device))
        end = self._timing_event()
        if end is None:
            return (time.monotonic() - t0) * 1e3
        end.synchronize()
        return self._span_s(start, end) * 1e3

    def _adapter_release(self, request: _Request) -> None:
        """Release a finished, failed or preempted request's pin on its
        adapter row (wait-free)."""
        if request.adapter_pinned:
            request.adapter_pinned = False
            if self.adapter_store is not None:
                self.adapter_store.unpin(request.adapter)

    def _adapter_tier_step(self) -> None:
        """Adapter bookkeeping at the loop's safe point (wait-free): apply
        the hydrator's results, emit the store's events, and settle the
        hydration stash. A request whose adapter landed in T1 requeues at
        the FRONT of its class; a failed or timed-out hydration is a cold
        refusal (:class:`AdapterUnavailable`): unlike a prefix miss there is
        no cheaper fallback compute, and base-model output under the
        adapter's name would be wrong."""
        store = self.adapter_store
        store.apply_results()
        self._emit_store_events(store.drain_events())
        if not self._adapter_hydrating:
            return
        now = time.monotonic()
        still_waiting = []
        # newest first: each settled request requeues at the front, so the
        # oldest ends at the head and arrival order survives
        for request, deadline_m, name in reversed(self._adapter_hydrating):
            if request.future.cancelled():
                self._journey(request, "cancelled", stage="adapter-hydrate")
                self._journal_retire(request)
                continue
            if store.t1_has(name):
                self.flight.event("adapter-hydrate", stage="done", adapter=name)
                self._journey(request, "adapter-hydrate-done", adapter=name)
                self.scheduler.requeue_front(request)
                continue
            if store.hydrating(name) and now < deadline_m:
                still_waiting.append((request, deadline_m, name))
                continue
            store.hydrate_failures += 1
            self.adapter_refusals += 1
            self.flight.event("adapter-hydrate", stage="timeout", adapter=name)
            self.flight.event("adapter-refused", adapter=name)
            self._journey(request, "adapter-hydrate-done", adapter=name, timeout=True)
            self._journal_retire(request)
            if not request.future.done():
                request.future.set_exception(AdapterUnavailable(
                    f"adapter {name!r} hydration timed out after "
                    f"{store.spec.hydrate_timeout_s:.1f}s"))
        still_waiting.reverse()
        self._adapter_hydrating = still_waiting

    def adapter_store_section(self) -> dict[str, Any]:
        """``stats()["adapters"]``: per-tier bytes against budget, hit, load
        and eviction counters, the resident row map and the exact byte
        ledger (the JAX engine's keys); the tier gauges refresh here.
        Snapshot reads."""
        store = self.adapter_store
        section = {
            "hydrating_requests": len(self._adapter_hydrating),
            "refusals": self.adapter_refusals,
            **store.stats(),
        }
        self._m_adapters["t0_bytes"](section["t0"]["bytes"])
        self._m_adapters["t1_bytes"](store.t1_bytes)
        self._m_adapters["t2_bytes"](store.t2_bytes)
        return section

    def _adapters_device(self, rows: np.ndarray | None) -> dict | None:
        """The ``adapters`` argument of a model call for per-row adapter
        rows (a loop-thread snapshot of ``_ad_rows``): the row ids upload
        through the content-keyed device cache of the block tables, so an
        unchanged mix costs no copy. None without a store."""
        if rows is None:
            return None
        ids = self._tables_dev_cache.get_or_put(
            b"adapter-rows:" + rows.tobytes(),
            lambda: self._upload(rows.astype(np.int64)))
        return {"ids": ids, "layers": self._ad_layers}

    # ------------------------------------------------------------------
    # KV handoff: prefill and decode pools (serving/kvtransfer.py)
    # ------------------------------------------------------------------

    def kv_fingerprint(self) -> dict[str, Any]:
        """The layout facts a KV handoff or a T2 prefix blob must agree on,
        spelled as the JAX engine spells them (so the packages' payloads
        and blobs cross); attribute reads only."""
        mc = self.model_config
        return {
            "model": self.config.model,
            "dtype": _DTYPE_NAMES[mc.dtype],
            "kv-quantize": self.config.kv_quantize or None,
            "kv-block-size": self.config.kv_block_size,
            "layers": mc.layers,
            "kv-heads": mc.kv_heads,
            "head-dim": mc.head_dim,
            "max-seq-len": mc.max_seq_len,
        }

    def kv_transfer_section(self) -> dict[str, Any]:
        """``stats()["kvtransfer"]``: transfer counters, the in-transit
        posture, the chainer's re-offers and fallbacks, and the exports whose
        journal entry awaits the decode side's answer."""
        return {
            "role": self._pool_role,
            "exports": self.kv_exports_total,
            "exports_evicted": self.kv_exports_evicted,
            "imports": self.kv_imports_total,
            "import_sheds": self.kv_import_sheds,
            "export_bytes": self.kv_export_bytes,
            "import_bytes": self.kv_import_bytes,
            "pending_exports": len(self._exports),
            "pending_imports": len(self._pending_imports),
            "in_transit_bytes": self._kv_in_transit_bytes,
            "retries": self.handoff_retries,
            "fallbacks": self.handoff_fallbacks,
            "unsettled_handoffs": len(self._handoff_journal),
        }

    def note_handoff_retry(self, request_id: str, replica: str | None = None,
                           attempt: int = 0, reason: str = "") -> None:
        """One re-offer by the chainer (serving/handoff.py): a counter and
        a ``handoff-retry`` flight event. Wait-free."""
        self.handoff_retries += 1
        if self._m_handoff_retries is not None:
            self._m_handoff_retries(1)
        self.flight.event("handoff-retry", request=request_id, replica=replica,
                          attempt=attempt, reason=str(reason)[:160])

    def note_handoff_fallback(self, request_id: str, attempts: int = 0) -> None:
        """The chainer gave up on the decode pool and imports the payload
        here: a counter and a ``handoff-fallback`` flight event (this
        prefill replica now pays a decode)."""
        self.handoff_fallbacks += 1
        if self._m_handoff_fallbacks is not None:
            self._m_handoff_fallbacks(1)
        self.flight.event("handoff-fallback", request=request_id, attempts=attempts)

    def note_breaker_open(self, open_replicas: int = 0) -> None:
        """The router's breaker pressure, mirrored into the
        ``breaker_open_replicas`` gauge. It registers at the first breaker
        event, so a fleet that never trips one keeps the default scrape
        surface; the chainer records a ``breaker-open`` flight event beside
        this call."""
        if self._m_breaker_open is None:
            self._m_breaker_open = self._reporter.gauge(
                "breaker_open_replicas",
                "replicas currently excluded from routing by an OPEN circuit breaker "
                "(gateway/router.py; docs/RESILIENCE.md)")
        self._m_breaker_open(open_replicas)

    def note_fault_fired(self, **detail: Any) -> None:
        """The ``fault-injected`` event of a network seam (the chainer runs
        on the loop, so the cause lands in the ring before the retry or
        fallback it triggers)."""
        self.flight.event("fault-injected", **detail)

    def take_export_entry(self, request_id: str, settle: bool = True) -> dict[str, Any] | None:
        """Pop one export entry (the payload and its stashed trace, journey
        and deadline); the payload leaves the in-transit ledger and the
        pickup is the journey's ``export-taken`` edge. Wait-free.

        ``settle`` (the pull model, the pod's ``/kv/export`` pickup): the
        pickup is the last this engine sees of the handoff, so the journal
        entry retires here. The chainer passes False and settles on the
        decode side's answer (:meth:`handoff_settled`)."""
        if self._faults is not None:
            # the http-export network seam: a dropped pickup answers None
            # without popping, so a retried pickup can still succeed
            action = self._faults.fire("http-export")
            if action is not None:
                self._fault_fired.append({"site": "http-export", "shape": action.shape,
                                          "fire": action.seq, "hang_ms": None})
                if action.shape == "delay-ms":
                    time.sleep(action.hang_ms / 1000.0)
                elif action.shape == "error":
                    raise RuntimeError(action.message)
                else:
                    return None
        entry = self._exports.pop(request_id, None)
        if entry is None:
            return None
        self._kv_in_transit_bytes -= entry["bytes"]
        if settle:
            self.handoff_settled(request_id)
        JOURNEYS.record(entry.get("journey"), "export-taken", handoff=request_id,
                        bytes=entry["bytes"])
        return entry

    def take_export(self, request_id: str) -> bytes | None:
        """Pop one serialized handoff payload (once: a second take is None)."""
        entry = self.take_export_entry(request_id)
        return None if entry is None else entry["payload"]

    async def _export_ready_slots(self, loop) -> None:
        """Prefill-pool half of the handoff: every slot whose prefill
        finished (it would join decode on a combined engine) exports its
        KV rows and request snapshot and releases, so the slot and its
        reservation serve the next prompt at once. Runs at the loop's safe
        point."""
        for slot_id, slot in enumerate(self.slots):
            request = slot.request
            if request is None or slot.prefilling or request.imported:
                continue
            if request.future.cancelled():
                # the caller gave up between prefill and export: nothing to
                # hand off; the tenant's post-debit still happens
                self._release_slot(slot_id)
                self.scheduler.on_finished(request)
                self._journey(request, "cancelled")
                continue
            if request.future.done():
                continue
            await self._export_slot(loop, slot_id, request)

    async def _export_slot(self, loop, slot_id: int, request: _Request) -> None:
        """Export one finished-prefill slot: gather its pool rows (the one
        device sync, :func:`kvtransfer.fetch_rows`, timed on the dispatch
        thread), serialize, stash the payload for pickup, release the slot
        and resolve the caller's future with the handoff ticket."""
        t_start = time.monotonic()
        rows = int(self._lengths[slot_id])
        blocks_live = self.block_mgr.blocks_needed(max(rows, 1))
        table_row = self.block_mgr.tables[slot_id, :blocks_live].copy()
        arrays, device_s = await loop.run_in_executor(
            self._executor, partial(self._run_gather, table_row, rows))
        self._export_seq += 1
        rid = f"{self.config.model}-{self._export_seq:08d}"
        now = time.monotonic()
        first = request.first_token_time or now
        admit = request.admit_time or first
        timings = {
            "queue_wait": admit - request.enqueue_time,
            "prefill": first - admit,
            "ttft": first - request.enqueue_time,
        }
        header = {
            "fingerprint": self.kv_fingerprint(),
            "request": rid,
            # the decode pool parents its spans under this trace and records
            # its edges under this journey: one trace id end to end
            "trace": request.trace.to_header() if request.trace is not None else None,
            "journey": request.journey_id,
            "prompt-digest": kvtransfer.prompt_digest(request.prompt_tokens),
            "prompt-tokens": list(request.prompt_tokens),
            "generated": list(request.generated),
            "logprobs": list(request.logprobs),
            "current-token": int(self._current[slot_id]),
            "kv-rows": rows,
            "max-tokens": request.max_tokens,
            "temperature": request.temperature,
            "top-k": request.top_k,
            "top-p": request.top_p,
            "presence-penalty": request.presence_penalty,
            "frequency-penalty": request.frequency_penalty,
            "stop": list(request.stop),
            "tenant": request.tenant,
            "priority": request.priority,
            "deadline": request.deadline,
            "timings": {k: round(v, 6) for k, v in timings.items()},
        }
        payload = kvtransfer.serialize_handoff(header, arrays)
        if not request.warmup:
            self._own_exports[rid] = header["prompt-digest"]
            while len(self._own_exports) > 4 * self._export_cap:
                self._own_exports.popitem(last=False)
        # released before stashing: the slot serves the next prompt now;
        # published prefix blocks stay cached (the cache holds its refs)
        self._release_slot(slot_id)
        if not request.warmup:
            # the trace and journey ride beside the payload, so the pickup
            # echoes the trace and closes the handoff-wait edge without
            # parsing it; the chainer derives its timeouts from the deadline
            self._exports[rid] = {"payload": payload, "bytes": len(payload),
                                  "blocks": blocks_live, "m_s": now,
                                  "trace": header["trace"],
                                  "journey": request.journey_id,
                                  "deadline": request.deadline}
            self._kv_in_transit_bytes += len(payload)
            while len(self._exports) > self._export_cap:
                # an evicted export is a LOST handoff (its blocks went at
                # export time): the pickup misses and the caller re-prefills
                evicted_rid, evicted = self._exports.popitem(last=False)
                self._kv_in_transit_bytes -= evicted["bytes"]
                self.kv_exports_evicted += 1
                self.flight.event("kv-export-dropped", request=evicted_rid,
                                  bytes=evicted["bytes"],
                                  age_s=round(now - evicted["m_s"], 3),
                                  cap=self._export_cap)
            self.kv_exports_total += 1
            self.kv_export_bytes += len(payload)
            self.request_timings.append({**{k: round(v, 6) for k, v in timings.items()},
                                         "decode": 0.0,
                                         "tokens": float(len(request.generated)),
                                         "handoff": 1.0})
            self._m_ttft_hist(timings["ttft"], _exemplar(request))
            self._m_queue_wait_hist(timings["queue_wait"])
            self._slo_record("availability", True)
            self._slo_record_latency("ttft", timings["ttft"])
            self._slo_record_latency("queue-wait", timings["queue_wait"])
        elapsed = time.monotonic() - t_start
        ms = round(elapsed * 1000.0, 3)
        self._m_kv_export_hist(elapsed, _exemplar(request))
        if not request.warmup:
            self._m_kv_export_bytes(len(payload))
        self.flight.event("kv-export", request=rid, bytes=len(payload),
                          blocks=blocks_live, rows=rows, ms=ms,
                          device_ms=round(device_s * 1000.0, 3), warmup=request.warmup)
        self._journey(request, "export", handoff=rid, bytes=len(payload), rows=rows,
                      ms=ms, device_ms=round(device_s * 1000.0, 3),
                      model=self.config.model, role=self._pool_role)
        if request.trace is not None and not request.warmup:
            # a handoff never reaches the finish path: its prefill-side
            # phases become spans here, the trace the decode side joins
            svc = f"engine:{self.config.model}"
            record_span("engine.queue", svc, request.trace, request.enqueue_time, admit)
            record_span("engine.prefill", svc, request.trace, admit, first,
                        attributes={"prompt-tokens": len(request.prompt_tokens)})
            record_span("engine.kv-export", svc, request.trace, t_start, time.monotonic(),
                        attributes={"bytes": len(payload), "rows": rows})
        self.scheduler.on_finished(request)
        self.completed_requests += 1
        if self.journal is not None and not request.warmup:
            # not the request's end for the journal: the decode side may
            # still die before it answers. The entry stays live until
            # handoff_settled; the mapping is bounded (an overflow drops the
            # mapping loudly, the entry stays live for the journal's bound)
            self._handoff_journal[rid] = request.journey_id
            while len(self._handoff_journal) > 4 * self._export_cap:
                old_rid, _ = self._handoff_journal.popitem(last=False)
                self.flight.event("handoff-settle-evict", request=old_rid)
        if not request.future.done():
            request.future.set_result({
                "handoff": rid,
                "tokens": list(request.generated),
                "text": self.tokenizer.decode(request.generated),
                "logprobs": list(request.logprobs),
                "num_prompt_tokens": len(request.prompt_tokens),
                "num_completion_tokens": len(request.generated),
                "ttft": timings["ttft"],
                "queue_wait": timings["queue_wait"],
                "prefill": timings["prefill"],
                "finish_reason": "handoff",
            })

    async def import_handoff(self, payload: bytes, header: dict[str, Any] | None = None,
                             trace_header: str | None = None,
                             deadline: float | None = None,
                             local_fallback: bool = False) -> dict[str, Any]:
        """Decode-pool half of the handoff: admit a request whose KV state
        arrived over the wire. Blocks allocate through the block manager,
        the rows scatter back through ``write_rows`` and the request joins
        decode directly (prefill skipped; its ``request_timings`` entry
        carries ``imported``). The wire header's ``trace`` and ``journey``
        (else ``trace_header``, the pod request's ``langstream-trace``)
        join this engine's spans and edges to the prefill side's. Raises
        :class:`~langstream_tpu_torch.serving.kvtransfer.LayoutMismatch` on a
        wire or fingerprint mismatch (a refusal) and :class:`RateLimited`
        when the pool cannot take it now (retry another decode replica).

        A prefill pool refuses imports, but for ``local_fallback``: the
        chainer's way back when no decode replica takes the payload, which
        the prefill engine then decodes itself on the combined path (the
        snapshot is the whole request state)."""
        if self._stop:
            raise RuntimeError(
                "serving engine is stopped (closed or lockstep group broken)")
        if self._pool_role == "prefill" and not local_fallback:
            raise kvtransfer.LayoutMismatch("prefill-role engine does not accept KV imports")
        if self.block_mgr is None:
            raise kvtransfer.LayoutMismatch(
                "kv-layout=dense engine cannot accept a paged KV handoff")
        self._event_loop = self._event_loop or asyncio.get_running_loop()
        header, arrays = kvtransfer.deserialize_handoff(payload, header)
        kvtransfer.check_fingerprint(self.kv_fingerprint(), header.get("fingerprint") or {})
        if self._pool_role == "prefill":
            # the fallback takes back exactly this engine's own export, once
            rid = header.get("request")
            if self._own_exports.get(rid) != header.get("prompt-digest"):
                raise kvtransfer.LayoutMismatch(
                    "a prefill pool's local fallback admits only its own exports")
            del self._own_exports[rid]
        if self._draining:
            raise RateLimited("draining", 1.0,
                              "engine is draining; retry another decode replica")
        prompt = [int(t) for t in header.get("prompt-tokens") or []]
        generated = [int(t) for t in header.get("generated") or []]
        rows = int(header.get("kv-rows") or 0)
        max_tokens = int(header.get("max-tokens") or 0)
        if rows < 1 or rows >= self.model_config.max_seq_len:
            raise kvtransfer.LayoutMismatch(
                f"handoff kv-rows {rows} outside (0, {self.model_config.max_seq_len})")
        for name, arr in arrays.items():
            if arr.shape[0] != self.model_config.layers or arr.shape[1] < rows:
                raise kvtransfer.LayoutMismatch(
                    f"handoff array {name!r} shape {tuple(arr.shape)} does not cover "
                    f"{self.model_config.layers} layers x {rows} rows")
        if not self.block_mgr.fits_ever(len(prompt) + max_tokens + 1):
            raise ValueError(
                f"imported request needs {len(prompt) + max_tokens + 1} tokens of "
                f"KV, more than this pool can ever hold")
        loop = asyncio.get_running_loop()
        wire_deadline = header.get("deadline")
        # the wire's trace first (the prefill engine stamped it), then the
        # pod request's header
        trace = kvtransfer.trace_context(header) or TraceContext.parse(trace_header)
        request = _Request(
            prompt_tokens=prompt,
            max_tokens=max_tokens,
            temperature=float(header.get("temperature") or 0.0),
            top_k=int(header.get("top-k") or 0),
            top_p=float(header.get("top-p") or 1.0),
            future=loop.create_future(),
            presence_penalty=float(header.get("presence-penalty") or 0.0),
            frequency_penalty=float(header.get("frequency-penalty") or 0.0),
            generated=generated,
            logprobs=[float(x) for x in header.get("logprobs") or []],
            enqueue_time=time.monotonic(),
            stop=_normalize_stop(header.get("stop")),
            tenant=str(header.get("tenant") or ""),
            priority=normalize_priority(header.get("priority")),
            imported=True,
            trace=trace,
            # the wire's stamp (the prefill side's original budget) first
            deadline=(float(wire_deadline) if wire_deadline else
                      float(deadline) if deadline else None),
            import_base_tokens=len(generated),
        )
        request.journey_id = kvtransfer.journey_id(header) or (
            trace.trace_id if trace is not None else fresh_trace_id())
        self._journey(request, "import-received", bytes=len(payload),
                      handoff=header.get("request"), model=self.config.model,
                      role=self._pool_role)
        if request.deadline is not None and remaining_s(request.deadline) <= 0.0:
            # expired in transit: refused before any block or device work,
            # after the journey id is bound (a terminal edge, not a gap)
            raise self._note_deadline_shed(request, "kv-import", 0.0)
        self._pending_imports.append((header, arrays, request, len(payload)))
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.ensure_future(self._run_loop())
        self._wake.set()
        return await request.future

    def _shed_import(self, request: _Request, reason: str, detail: str) -> None:
        """Refuse one pending import explicitly: ``RateLimited`` with a retry
        hint, so the caller retries another decode replica (never a silent
        loss)."""
        self.kv_import_sheds += 1
        self.flight.event("shed", reason=reason, tenant=request.tenant,
                          priority=request.priority, retry_after_s=1.0, imported=True)
        self._journey(request, "shed", reason=reason, imported=True)
        if not request.future.done():
            request.future.set_exception(RateLimited(reason, 1.0, detail))

    async def _apply_imports(self, loop) -> None:
        """Admit every queued KV import at the loop's safe point: a free
        slot and the worst-case block reservation, as admission needs; a
        refusal is an explicit retryable shed. An allocator failure in the
        scatter puts the import back at the front and re-raises, so the
        loop's pool shrink adapts and the next pass retries it; past
        ``_SHRINK_RETRY_CAP`` retries it is shed (``kv-import-oom``)."""
        while self._pending_imports:
            header, arrays, request, nbytes = self._pending_imports.popleft()
            if request.future.done():
                continue  # the caller gave up while queued
            if request.deadline is not None:
                left = remaining_s(request.deadline)
                if left <= 0.0:
                    err = self._note_deadline_shed(request, "kv-import", left)
                    if not request.future.done():
                        request.future.set_exception(err)
                    continue
            if self._draining:
                self._shed_import(request, "draining",
                                  "engine is draining; retry another decode replica")
                continue
            free = next((i for i, s in enumerate(self.slots) if s.free), None)
            total = len(request.prompt_tokens) + request.max_tokens + 1
            if free is None:
                self._shed_import(request, "no-free-slot",
                                  "decode pool has no free slot; retry another replica")
                continue
            if not self.block_mgr.can_admit(total):
                self._shed_import(
                    request, "kv-import-capacity",
                    "decode pool cannot reserve the request's worst-case KV "
                    "blocks; retry another replica")
                continue
            rows = int(header["kv-rows"])
            t_start = time.monotonic()
            try:
                self.block_mgr.admit(free, total)
                self.block_mgr.ensure_capacity(free, rows)
            except RuntimeError as e:
                # the allocator refused: a shed, never a request failure
                self.block_mgr.release(free)
                self._shed_import(request, "kv-import-capacity",
                                  f"block allocation failed ({e}); retry another replica")
                continue
            table_row = self.block_mgr.tables[free].copy()
            padded = _bucket(rows, hi=self.model_config.max_seq_len)
            try:
                device_s = await loop.run_in_executor(
                    self._executor,
                    partial(self._run_scatter, arrays, table_row, rows, padded))
            except Exception as e:
                self.block_mgr.release(free)
                if not self._resource_exhausted(e):
                    raise
                if request.import_retries >= _SHRINK_RETRY_CAP:
                    self._shed_import(request, "kv-import-oom",
                                      f"device allocation failed mid-scatter ({e}); "
                                      f"retry another replica")
                    self._shrink_inline_shed += 1
                    continue
                request.import_retries += 1
                self._pending_imports.appendleft((header, arrays, request, nbytes))
                self._shrink_inline_preempted += 1
                raise
            slot = self.slots[free]
            slot.request = request
            slot.prefilling = False
            slot.prefill_done = 0
            self._lengths[free] = rows
            self._current[free] = int(header["current-token"])
            self._temps[free] = request.temperature
            self._topks[free] = request.top_k
            self._topps[free] = request.top_p
            self._pres[free] = request.presence_penalty
            self._freq[free] = request.frequency_penalty
            now = time.monotonic()
            # prefill is skipped: admission is the first-token boundary
            # (the first token was produced on the prefill pool)
            request.admit_time = now
            request.first_token_time = now
            self.kv_imports_total += 1
            self.kv_import_bytes += nbytes
            if self._m_kv_import_hist is not None:  # a combined engine has none
                self._m_kv_import_hist(time.monotonic() - t_start, _exemplar(request))
                self._m_kv_import_bytes(nbytes)
            self.flight.event(
                "kv-import", request=header.get("request"),
                digest=header.get("prompt-digest"), bytes=nbytes,
                blocks=self.block_mgr.blocks_needed(max(rows, 1)), rows=rows,
                ms=round((time.monotonic() - t_start) * 1000.0, 3),
                device_ms=round(device_s * 1000.0, 3),
            )
            self._journey(request, "import", bytes=nbytes, rows=rows,
                          ms=round((time.monotonic() - t_start) * 1000.0, 3),
                          device_ms=round(device_s * 1000.0, 3),
                          model=self.config.model, role=self._pool_role)
            if request.trace is not None:
                # the block admit and scatter under the prefill side's trace;
                # the decode phase follows at finish
                record_span("engine.kv-import", f"engine:{self.config.model}",
                            request.trace, t_start, now,
                            attributes={"bytes": nbytes, "rows": rows})

    # ------------------------------------------------------------------
    # admission + prefill
    # ------------------------------------------------------------------

    async def _admit(self, loop) -> None:
        """Admit queued requests in the scheduler's order in batched prefill
        calls (one batch per length bucket of the tokens to prefill, up to
        ``prefill-batch`` rows). A request whose deadline budget cannot
        cover the admission estimate is shed here, before any device work.

        With the paged prefix cache on, each request first matches its
        prompt against cached block chains; a matched request adopts the
        shared blocks and prefills only its SUFFIX, and a batch with any
        such row goes through the continuation path. A resumed request
        prefills its whole context (prompt and generated tokens) and stays
        out of the prefix cache both ways, as in the JAX engine: its chain
        mixes generated tokens into what looks like a prompt. A request that
        names an adapter first resolves it to a pinned T0 row (or is
        stashed for a T2 hydration, or refused) and stays out of the prefix
        plane both ways too: its KV is coloured by the adapter. With
        ``prefill-chunk`` a request with more tokens to prefill than the
        chunk claims its slot and reservation here and prefills in
        :meth:`_advance_prefills`.
        """
        S = self.model_config.max_seq_len
        cfg = self.config
        use_prefix = self.block_mgr is not None and cfg.prefix_cache
        while not self.scheduler.empty():
            free = [i for i in self._slot_order if self.slots[i].free]
            if not free:
                return
            batch: list[tuple[int, _Request, int]] = []  # (slot, request, reuse)
            bucket = None
            while not self.scheduler.empty() and len(batch) < min(len(free), cfg.prefill_batch):
                # the next candidate: the FIFO head, or the WDRR-selected
                # class head under QoS
                request = self.scheduler.peek()
                if request is None:
                    break
                if request.future.cancelled():
                    self.scheduler.pop()  # caller gave up while queued
                    self._adapter_release(request)  # a pin kept from an earlier pass
                    self._journal_retire(request)
                    continue
                if request.deadline is not None:
                    left = remaining_s(request.deadline)
                    estimate = self._admit_estimate_s()
                    if left <= estimate:
                        self.scheduler.pop()
                        self._adapter_release(request)
                        self._journal_retire(request)
                        err = self._note_deadline_shed(request, "admission", left, estimate)
                        if not request.future.done():
                            request.future.set_exception(err)
                        continue
                if (self.adapter_store is not None and request.adapter
                        and not request.adapter_pinned):
                    # the request admits only once its adapter holds a
                    # device row; "wait" and "refused" popped it. A request
                    # left queued with its pin (a bucket break, KV
                    # backpressure) keeps its row and does not pin twice.
                    verdict = await self._resolve_adapter(loop, request)
                    if verdict == "backpressure":
                        break  # every T0 row pinned: finishing slots unpin
                    if verdict != "ready":
                        continue
                    if self.scheduler.peek() is not request:
                        # the row copy yielded to the event loop: another
                        # request heads the queue now; this one keeps its
                        # pinned row for its turn
                        continue
                ctx = request.context_tokens
                total = len(request.prompt_tokens) + request.max_tokens + 1
                # one chain-digest walk per admission attempt, shared by the
                # hydration check, the promotion and match_prefix
                chain = (
                    self.block_mgr.chain_digests(ctx)
                    if self.prefix_store is not None and use_prefix
                    and not request.preemptions and not request.adapter else None
                )
                if chain is not None and not request.hydrate_attempted and not self._draining:
                    # the prompt's chain reaches into T2: stash the request
                    # off the queue while the hydrator pulls the blobs into
                    # T1; it requeues at its class's front when they land or
                    # the timeout sends it to cold compute
                    request.hydrate_attempted = True
                    missing = self._chain_t2_candidates(chain)
                    if missing and self.prefix_store.request_hydration(missing):
                        self.scheduler.pop()
                        deadline_m = time.monotonic() + self.prefix_store.spec.hydrate_timeout_s
                        self._prefix_hydrating.append((request, deadline_m, missing))
                        self.flight.event("prefix-hydrate", stage="begin",
                                          blocks=len(missing))
                        self._journey(request, "hydrate-begin", blocks=len(missing))
                        continue
                if self.block_mgr is not None and not self.block_mgr.can_admit(total):
                    # paged backpressure: finishing slots free reservations
                    # (under QoS the loop may preempt a lower-class victim)
                    break
                blocks, reuse = [], 0
                # adapter requests bypass the shared prefix plane both ways:
                # a base or other-adapter chain would splice foreign KV
                # under them, and theirs would poison adapter-less traffic
                if use_prefix and not request.preemptions and not request.adapter:
                    if chain is not None and await self._promote_prefix(loop, request, chain):
                        # the scatter yielded to the event loop: a request
                        # submitted meanwhile may head the queue now, and
                        # this one keeps its promoted blocks for its turn
                        if self.scheduler.peek() is not request:
                            continue
                    blocks, reuse = self.block_mgr.match_prefix(ctx, digests=chain)
                    if reuse and len(ctx) - reuse > cfg.prefix_cache_max_suffix:
                        blocks, reuse = [], 0  # long suffix, small saving
                to_prefill = len(ctx) - reuse
                if cfg.prefill_chunk > 0 and to_prefill > cfg.prefill_chunk:
                    # chunked prefill: claim the slot and its reservation
                    # now, feed the prompt one chunk per loop pass
                    slot_id = free.pop(len(batch))
                    self.scheduler.pop()
                    self.block_mgr.admit(slot_id, total)
                    if blocks:
                        self.block_mgr.adopt_prefix(slot_id, blocks)
                    slot = self.slots[slot_id]
                    # the slot is claimed before the grow: a failure below is
                    # then visible to the failure paths. It undoes itself: a
                    # mid-prefill slot whose table never grew would write
                    # its chunks to the scratch block, and the shrink's
                    # sweep leaves mid-prefill slots alone
                    slot.request = request
                    slot.prefilling = True
                    slot.prefill_done = reuse
                    if self._ad_rows is not None:
                        self._ad_rows[slot_id] = request.adapter_row
                    try:
                        self._fault("pool-grow")
                        self.block_mgr.ensure_capacity(slot_id, len(ctx))
                    except Exception as e:
                        # the batch members popped and reserved this pass
                        # sit in no slot yet: back to the queue, in order
                        for sid, req, _ in reversed(batch):
                            self.block_mgr.release(sid)
                            self.scheduler.requeue_front(req)
                        batch.clear()
                        if not self._resource_exhausted(e):
                            raise
                        if request.preemptions >= _SHRINK_RETRY_CAP:
                            self._shed_stranded(slot_id, e)
                            self._shrink_inline_shed += 1
                        else:
                            self._preempt_slot(slot_id, reason="pool-shrink")
                            self._shrink_inline_preempted += 1
                        raise
                    request.admit_time = time.monotonic()
                    self._note_resume(request)
                    self._journey(request, "admit", chunked=True)
                    if reuse:
                        self.prefix_hits += 1
                        self.prefix_tokens += reuse
                        self._m_prefix_hits(1)
                        self._m_prefix_tokens(reuse)
                    continue
                b = _bucket(to_prefill, hi=S)
                if bucket is None:
                    bucket = b
                elif b != bucket:
                    break
                slot_id = free[len(batch)]
                self.scheduler.pop()
                if self.block_mgr is not None:
                    # reserve at pop time: the next can_admit sees it
                    self.block_mgr.admit(slot_id, total)
                    if blocks:
                        self.block_mgr.adopt_prefix(slot_id, blocks)
                batch.append((slot_id, request, reuse))
            if not batch:
                return
            now = time.monotonic()
            for slot_id, request, _ in batch:
                self.slots[slot_id].request = request
                if self._ad_rows is not None:
                    self._ad_rows[slot_id] = request.adapter_row
                request.admit_time = now
                self._note_resume(request)
                self._journey(request, "admit")
            # the grows come after every member holds its slot: an allocator
            # failure here is then seen by the shrink's sweep of the slots
            # whose prefill never landed
            if self.block_mgr is not None:
                self._fault("pool-grow")
                for slot_id, request, _ in batch:
                    self.block_mgr.ensure_capacity(slot_id, len(request.context_tokens))
            B = len(batch)
            rows = self._prefill_rows(B)
            padded = np.zeros((len(rows), bucket), dtype=np.int64)
            lengths = np.zeros(len(rows), dtype=np.int32)
            starts = np.zeros(len(rows), dtype=np.int32)
            slot_ids = np.zeros(len(rows), dtype=np.int64)
            temps = np.zeros(len(rows), dtype=np.float32)
            topks = np.zeros(len(rows), dtype=np.int32)
            topps = np.ones(len(rows), dtype=np.float32)
            for i, j in enumerate(rows):
                slot_id, request, reuse = batch[j]
                suffix = request.context_tokens[reuse:]
                padded[i, : len(suffix)] = suffix
                lengths[i] = len(suffix)
                starts[i] = reuse
                slot_ids[i] = slot_id
                temps[i] = request.temperature
                topks[i] = request.top_k
                topps[i] = request.top_p
            tables = (
                self.block_mgr.tables[slot_ids].copy()
                if self.block_mgr is not None else None
            )
            # a batch with any reused prefix goes through the continuation
            # path; its rows with start 0 merge to suffix-only attention
            cont = (
                (starts, self._read_blocks_for(int(starts.max())))
                if starts.any() else None
            )
            mode = self._sampler_mode(temps, topks, topps)
            program = (
                self._program_prefill_continue(cont[1], _pow2(B), bucket, mode)
                if cont is not None else self._program_prefill(bucket, _pow2(B), mode)
            )
            # per-row adapter rows (a loop-thread snapshot)
            ad_rows = self._ad_rows[slot_ids].copy() if self._ad_rows is not None else None
            next_np, logprob_np, wait_s, span_s = await loop.run_in_executor(
                self._executor,
                partial(self._run_prefill, padded, lengths, slot_ids, tables,
                        temps, topks, topps, mode, cont, ad_rows),
            )
            if use_prefix:
                for slot_id, request, reuse in batch:
                    if request.preemptions or request.adapter:
                        continue  # a resumed or adapter context is no shareable prompt
                    self.block_mgr.register_prefix(slot_id, request.prompt_tokens)
                    if reuse:
                        self.prefix_hits += 1
                        self.prefix_tokens += reuse
                        self._m_prefix_hits(1)
                        self._m_prefix_tokens(reuse)
            now = time.monotonic()
            for i, (slot_id, request, _) in enumerate(batch):
                self._start_decoding(slot_id, request, int(next_np[i]), now)
                self._emit_token(slot_id, int(next_np[i]), float(logprob_np[i]))
            self._flight_record("prefill", wait_s, tokens=B, program=program,
                                span_s=span_s)
            await self._flush_emits()

    def _prefill_rows(self, n: int) -> list[int]:
        """Batch index of each row of an ``n``-request prefill. A routed FFN
        takes its capacity from the padded batch, so MoE pads to the JAX
        engine's rows: a power of two, the extra rows copies of the last
        request. A dense FFN is row-independent and runs the ``n`` rows."""
        if not self.is_moe:
            return list(range(n))
        return [min(i, n - 1) for i in range(_pow2(n))]

    def _start_decoding(self, slot_id: int, request: "_Request", token: int,
                        now: float) -> None:
        """The slot's context is in the cache and ``token`` is the next
        generated token: set the slot's decode state. A resumed request
        keeps its first token's time (TTFT is what the client saw)."""
        self._lengths[slot_id] = len(request.context_tokens)
        self._current[slot_id] = token
        self._temps[slot_id] = request.temperature
        self._topks[slot_id] = request.top_k
        self._topps[slot_id] = request.top_p
        self._pres[slot_id] = request.presence_penalty
        self._freq[slot_id] = request.frequency_penalty
        if request.first_token_time is None:
            request.first_token_time = now
            # stamped where the host learns the token: after the prefill's
            # one fetch, never through an extra device sync
            self._journey(request, "first-token")

    async def _advance_prefills(self, loop) -> None:
        """One chunk of at most ``prefill-chunk`` prompt tokens for every
        mid-prefill slot, batched through the continuation path with
        ``starts`` at the rows already committed. The final chunk's sampled
        token is the request's first generated token; the slot then joins
        decode."""
        for slot_id, slot in enumerate(self.slots):
            if slot.prefilling and slot.request.future.cancelled():
                self._journal_retire(slot.request)
                self._release_slot(slot_id)  # frees the reservation too
        pre = [i for i, s in enumerate(self.slots) if s.prefilling]
        if not pre:
            return
        C = self.config.prefill_chunk
        B = len(pre)
        rows = self._prefill_rows(B)
        tokens = np.zeros((len(rows), C), dtype=np.int64)
        starts = np.zeros(len(rows), dtype=np.int32)
        suffix_lens = np.zeros(len(rows), dtype=np.int32)
        temps = np.zeros(len(rows), dtype=np.float32)
        topks = np.zeros(len(rows), dtype=np.int32)
        topps = np.ones(len(rows), dtype=np.float32)
        for i, j in enumerate(rows):
            slot_id = pre[j]
            slot = self.slots[slot_id]
            request = slot.request
            chunk = request.context_tokens[slot.prefill_done: slot.prefill_done + C]
            tokens[i, : len(chunk)] = chunk
            starts[i] = slot.prefill_done
            suffix_lens[i] = len(chunk)
            temps[i] = request.temperature
            topks[i] = request.top_k
            topps[i] = request.top_p
        slot_ids = np.asarray([pre[j] for j in rows], dtype=np.int64)
        cont = (starts, self._read_blocks_for(max(int(starts.max()), 1)))
        mode = self._sampler_mode(temps, topks, topps)
        program = self._program_prefill_continue(cont[1], _pow2(B), C, mode)
        ad_rows = self._ad_rows[slot_ids].copy() if self._ad_rows is not None else None
        next_np, logprob_np, wait_s, span_s = await loop.run_in_executor(
            self._executor,
            partial(self._run_prefill, tokens, suffix_lens, slot_ids,
                    self.block_mgr.tables[slot_ids].copy(), temps, topks,
                    topps, mode, cont, ad_rows),
        )
        now = time.monotonic()
        done = 0
        for i, slot_id in enumerate(pre):
            slot = self.slots[slot_id]
            request = slot.request
            slot.prefill_done += int(suffix_lens[i])
            if slot.prefill_done < len(request.context_tokens):
                continue
            done += 1
            slot.prefilling = False
            self._start_decoding(slot_id, request, int(next_np[i]), now)
            # register BEFORE emitting: a max-tokens=1 or instant-EOS
            # request is released inside _emit_token, and registering
            # against a released slot's empty table publishes nothing
            if self.config.prefix_cache and not request.preemptions and not request.adapter:
                self.block_mgr.register_prefix(slot_id, request.prompt_tokens)
            self._emit_token(slot_id, int(next_np[i]), float(logprob_np[i]))
        self._flight_record("prefill", wait_s, tokens=done, program=program,
                            span_s=span_s)
        await self._flush_emits()

    def _timing_event(self):
        """A CUDA timing event recorded on the stream now; None on the CPU."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    @staticmethod
    def _span_s(start, end) -> float | None:
        """Seconds of the card's timeline between two completed events."""
        return None if start is None else start.elapsed_time(end) / 1e3

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without syncing the stream
        (a blocking upload would wait for every chunk queued before it): on
        the card a pinned copy and an asynchronous copy, the caching host
        allocator keeping the pinned block until the copy has run; on the
        CPU a copy (the caller may change the array afterwards)."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _sample_fn(self, temps_t, topks_t, topps_t, mode, pres_t=None, freq_t=None,
                   draw=None):
        """A ``sample_fn`` closure over device tensors of the rows' settings
        (``draw``: the rows' ``(batch, index)`` under a dp split)."""
        use_top_p, use_top_k, all_greedy = mode
        pen = pres_t is not None

        def sample_fn(logits, counts=None):
            return sample_tokens(
                logits, self._generator, temps_t, topks_t,
                use_top_p=use_top_p, top_ps=topps_t, use_top_k=use_top_k,
                all_greedy=all_greedy, use_penalties=pen, presences=pres_t,
                frequencies=freq_t, counts=counts, rows=draw,
            )

        return sample_fn

    def _sampler_device(self, active_mask, temps, topks, topps) -> tuple:
        """Device copies of (active mask, temps, top-ks, top-ps), uploaded
        only on a content miss (:class:`_DeviceLru`)."""
        key = active_mask.tobytes() + temps.tobytes() + topks.tobytes() + topps.tobytes()
        return self._sampler_dev_cache.get_or_put(
            key, lambda: tuple(self._upload(a) for a in (active_mask, temps, topks, topps)))

    def _tables_device(self, tables: np.ndarray | None):
        """Device copy of the block tables, uploaded only on a content miss
        (most chunks allocate no block)."""
        if tables is None:
            return None
        return self._tables_dev_cache.get_or_put(tables.tobytes(),
                                                 lambda: self._upload(tables))

    def _ls_broadcast(self, op: str, **fields) -> int | None:
        """Leader: broadcast the descriptor of the dispatch about to run,
        with the generator's state (every rank samples the same gathered
        logits from it); returns the dispatch's number, None without a
        lockstep group. ``None`` fields are left out."""
        if self._lockstep is None:
            return None
        seq = self._ls_seq
        self._ls_seq += 1
        desc = {"op": op}
        desc.update((k, v) for k, v in fields.items() if v is not None)
        desc["gen"] = self._generator.get_state().numpy()  # uint8, a copy
        self._lockstep.broadcast(desc)
        return seq

    def _ls_note(self, seq: int | None, op: str, tokens: np.ndarray) -> None:
        """Leader: the tokens dispatch ``seq`` sampled, kept when the caller
        asked for :attr:`lockstep_tokens`."""
        if seq is not None and self.lockstep_tokens is not None:
            self.lockstep_tokens[seq] = (op, tokens.copy())

    @torch.no_grad()
    def _run_prefill(self, padded, lengths, slot_ids, tables, temps, topks,
                     topps, mode, cont=None, ad_rows=None):
        """Dispatch thread: one batched prefill + first-token sample; one
        packed device-to-host copy. ``cont = (starts, num_read_blocks)``
        sends the batch through the continuation path (``padded`` then
        holds each row's suffix); ``ad_rows`` are the rows' adapter rows
        (None without a store). Returns (tokens, logprobs) numpy, the
        seconds the copy waited for the card and the dispatch's span on
        the card (None on the CPU)."""
        self._fault("prefill")
        op = "prefill" if cont is None else "prefill_continue"
        seq = self._ls_broadcast(
            op, tokens=padded, lengths=lengths, slot_ids=np.asarray(slot_ids),
            tables=tables, temps=temps, topks=topks, topps=topps,
            sampler_mode=[bool(x) for x in mode],
            starts=None if cont is None else cont[0],
            nrb=None if cont is None else int(cont[1]),
        )
        mc, up = self.model_config, self._upload
        start = self._timing_event()
        B = len(lengths)
        slot_ids = np.asarray(slot_ids)
        # a slot named by several rows (a padded batch) commits its last row
        commit = np.array([s not in slot_ids[i + 1:] for i, s in enumerate(slot_ids)])
        own = self._dp_rows(slot_ids) if self._dp_prefill_split else None
        if own is not None:
            # this dp replica runs the rows of its own slots
            padded, lengths, slot_ids, commit = (
                padded[own], lengths[own], slot_ids[own], commit[own])
            temps, topks, topps = temps[own], topks[own], topps[own]
            tables = None if tables is None else tables[own]
            ad_rows = None if ad_rows is None else ad_rows[own]
            cont = None if cont is None else (cont[0][own], cont[1])
        if own is not None and not len(own):
            nxt = torch.zeros(0, dtype=torch.int32, device=self.device)
            lps = torch.zeros(0, dtype=torch.float32, device=self.device)
        else:
            nxt, lps = self._prefill_own(padded, lengths, slot_ids, tables, temps,
                                         topks, topps, mode, cont, ad_rows, commit,
                                         None if own is None else (B, up(own)))
        self._prefill_calls += 1
        packed = pack_tokens_logprobs(nxt, lps)
        if own is not None:
            packed = self._dp_gather(packed, up(own), B, [(1, 1), (1, 1)])
        end = self._timing_event()
        t0 = time.monotonic()
        host = packed.cpu().numpy()  # the prefill's one device-to-host copy
        wait_s = time.monotonic() - t0
        self._ls_note(seq, op, host[:B])
        return host[:B], host[B:].view(np.float32), wait_s, self._span_s(start, end)

    def _prefill_own(self, padded, lengths, slot_ids, tables, temps, topks, topps,
                     mode, cont, ad_rows, commit, draw):
        """The prefill forward and first-token sample of the rows this rank
        runs (``draw``: their ``(batch, index)`` under a dp split, for the
        sampler's draws). Returns the device tokens and logprobs."""
        mc, up = self.model_config, self._upload
        tokens = up(padded)
        lengths_t = up(lengths)
        commit_t = None if commit.all() else up(commit)
        adapters = self._adapters_device(ad_rows)
        if cont is not None:
            starts, nrb = cont
            logits, _, _ = llama_prefill_continue_paged(
                mc, self.params, tokens, up(starts), lengths_t, self.cache_k,
                self.cache_v, up(tables), num_read_blocks=nrb, ffn=self._ffn,
                commit_rows=commit_t, adapters=adapters,
            )
            self._continue_calls += 1
        elif self.block_mgr is not None:
            logits, _, _ = llama_prefill_paged(
                mc, self.params, tokens, lengths_t, self.cache_k, self.cache_v,
                up(tables), ffn=self._ffn, commit_rows=commit_t, adapters=adapters,
            )
        else:
            logits, ks, vs = prefill_forward(mc, self.params, tokens, lengths_t,
                                             ffn=self._ffn)
            Pn = tokens.shape[1]
            # the dense cache holds this replica's slots, from its first
            slots = slot_ids - (self._dp_span[0] if self._dp_span else 0)
            if commit_t is None:
                sel = up(slots)
            else:
                sel = up(slots[commit])
                keep = up(np.flatnonzero(commit))
                ks, vs = ks[:, keep], vs[:, keep]
            for cache, rows in ((self.cache_k, ks), (self.cache_v, vs)):
                if is_quant_cache(cache):
                    # an int8 cache takes the rows quantized, one scale each
                    rows = quantize_rows(rows)
                    cache["q"][:, sel, :Pn] = rows["q"]
                    cache["s"][:, sel, :Pn] = rows["s"]
                else:
                    cache[:, sel, :Pn] = rows
        return self._sample_fn(up(temps), up(topks), up(topps), mode, draw=draw)(logits)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _light_threshold(self) -> int:
        """Active-slot count at or below which bursts run
        ``decode-chunk-light`` steps per chunk (the TTFT regime); 0 when the
        light chunk is off or would not be shorter."""
        cfg = self.config
        if cfg.decode_chunk_light <= 0 or cfg.decode_chunk_light >= cfg.decode_chunk:
            return 0
        if cfg.light_load_slots is not None:
            return cfg.light_load_slots
        return max(1, cfg.slots // 8)

    def _burst_steps(self, active: list[int]) -> tuple[int, bool]:
        """(K, light) of a burst over ``active``, the JAX engine's rule: the
        light or the full chunk, halved while it is at least twice the
        longest remaining budget (and twice the light chunk)."""
        cfg = self.config
        light = len(active) <= self._light_threshold()
        K = cfg.decode_chunk_light if light else cfg.decode_chunk
        max_remaining = 1
        for slot_id in active:
            request = self.slots[slot_id].request
            max_remaining = max(max_remaining, request.max_tokens - len(request.generated))
        while K >= 2 * max(max_remaining, cfg.decode_chunk_light, 1):
            K //= 2
        return K, light

    def _burst_should_yield(self, finished: bool, pipelined: bool = False) -> bool:
        """A burst ends when the loop can make progress elsewhere: the
        engine stops, a prefill is mid-flight, queued work can land in a
        free slot (a queue with every slot busy keeps the burst going), or
        a slot finished. A pipelined burst survives a finish while nobody
        is queued: the slot freezes in the device mask instead."""
        if self._stop or self._has_prefilling():
            return True
        if self._draining and not self._drain_pass_done:
            # a drain preempts at the loop's safe point after this chunk,
            # not after the whole burst
            return True
        if finished:
            return not (pipelined and self.scheduler.empty())
        if self.scheduler.empty():
            return False
        return any(s.free for s in self.slots)

    def _penalized(self, active: list[int]) -> bool:
        return bool((self._pres[active] != 0).any() or (self._freq[active] != 0).any())

    def _grow_blocks(self, active: list[int], K: int, pending_chunks: int):
        """Paged: allocate blocks for this dispatch's chunk and for the
        ``pending_chunks`` dispatched chunks the host lengths do not show
        yet (0 in the sequential loop, 1 in the pipelined one), capped at
        each request's own budget. Returns a host copy of the tables."""
        if self.block_mgr is None:
            return None
        self._fault("pool-grow")
        S = self.model_config.max_seq_len
        grown_blocks = grown_slots = 0
        for slot_id in active:
            request = self.slots[slot_id].request
            if request is None:
                continue
            cap = len(request.prompt_tokens) + request.max_tokens + 1
            need = min(int(self._lengths[slot_id]) + (pending_chunks + 1) * K, cap, S)
            n = self.block_mgr.ensure_capacity(slot_id, need)
            grown_blocks += n
            grown_slots += bool(n)
        if grown_blocks:
            self.flight.event("pool-grow", slots=grown_slots, blocks=grown_blocks,
                              bytes=grown_blocks * self._kv_block_bytes, phase="decode")
        return self.block_mgr.tables.copy()

    def _window(self, max_len: int) -> int | None:
        """The read bucket of a chunk over slots of up to ``max_len`` rows."""
        if self.block_mgr is not None:
            return self._read_blocks_for(max_len)
        return self._window_for(max_len)

    async def _decode_burst(self, loop, active: list[int]) -> None:
        """Decode chunks of one K over the active slots until
        :meth:`_burst_should_yield`: the pipelined loop for heavy bursts,
        the sequential one (one chunk at a time, the reference) for the
        light regime, penalty bursts and ``pipeline: false``."""
        K, light = self._burst_steps(active)
        self._settled.clear()
        try:
            if light or self._penalized(active) or not self._pipeline_on:
                while not self._burst_should_yield(
                    await self._decode_chunk(loop, active, K, light)
                ):
                    pass
            else:
                await self._pipelined_burst(loop, active, K)
        finally:
            if self._pending_chunk is None:
                self._settled.set()

    async def _decode_chunk(self, loop, active: list[int], K: int,
                            light: bool | None = None) -> bool:
        """One chunk of ``K`` fused decode steps over the active slots, one
        packed fetch, then per-token host processing; True when a slot
        finished. ``light`` names the regime it counts under (None: a
        speculative calibration chunk, counted under neither)."""
        cfg = self.config
        active_mask = np.zeros(cfg.slots, dtype=bool)
        active_mask[active] = True
        mode = self._sampler_mode(
            self._temps[active_mask], self._topks[active_mask],
            self._topps[active_mask],
        )
        pen = self._penalized(active)
        counts = None
        if pen:
            counts = np.zeros((cfg.slots, self.model_config.vocab_size), dtype=np.int32)
            for slot_id in active:
                for t in self.slots[slot_id].request.generated:
                    counts[slot_id, t] += 1
        window = self._window(int(self._lengths[active].max()))
        tables = self._grow_blocks(active, K, 0)
        program = self._program_decode(window, K, mode, pen)
        if light is not None:
            if light:
                self._light_chunks += 1
            else:
                self._heavy_chunks += 1
        chunk_t, chunk_lp, wait_s, span_s = await loop.run_in_executor(
            self._executor,
            partial(
                self._run_decode, self._current.copy(), self._lengths.copy(),
                active_mask, tables, window, K, mode, self._temps.copy(),
                self._topks.copy(), self._topps.copy(),
                self._pres.copy() if pen else None,
                self._freq.copy() if pen else None, counts,
                self._ad_rows.copy() if self._ad_rows is not None else None,
            ),
        )
        before = self.total_generated
        finished = self._process_chunk(chunk_t, chunk_lp, active)
        self._flight_record("decode", wait_s, tokens=self.total_generated - before,
                            program=program, span_s=span_s)
        await self._flush_emits()
        return finished

    async def _pipelined_burst(self, loop, active: list[int], K: int) -> None:
        """The depth-2 pipelined loop (the JAX engine's, ``engine.py``
        ``_decode_burst``): chunk N+1 is dispatched from chunk N's
        device-resident final tokens and lengths, then the host fetches and
        applies chunk N while N+1 executes; that host work is credited as
        overlapped while a readiness probe shows N+1 still running. Slots
        that finish freeze in the device mask from the next dispatch on;
        their over-run tokens are dropped by :meth:`_process_chunk`. When
        the burst yields for queued work, its last chunk stays in flight
        as ``_pending_chunk`` (see :meth:`_drain_pending`)."""
        mask = np.zeros(self.config.slots, dtype=bool)
        mask[active] = True
        mode = self._sampler_mode(self._temps[mask], self._topks[mask], self._topps[mask])
        base_max = int(self._lengths[active].max())
        programs: list[str] = []  # ids of the dispatched, unrecorded chunks

        def submit(tokens, lengths, pending_chunks: int):
            """Loop-thread half of a dispatch (bucket, program id, block
            growth, snapshots); the dispatch thread launches the chunk."""
            window = self._window(base_max)
            programs.append(self._program_decode(window, K, mode, False))
            tables = self._grow_blocks(active, K, pending_chunks)
            sampler = (mask.copy(), self._temps.copy(), self._topks.copy(),
                       self._topps.copy())
            # the slot -> adapter-row mirror, snapshotted here on the loop
            # thread: admission rewrites it between bursts
            ad_rows = self._ad_rows.copy() if self._ad_rows is not None else None
            self._heavy_chunks += 1
            return loop.run_in_executor(
                self._executor,
                partial(self._dispatch_decode, tokens, lengths, sampler, tables,
                        window, K, mode, ad_rows=ad_rows),
            )

        def busy(task) -> bool:
            """The card still works on the chunk ``task`` dispatches."""
            return not task.done() or not self._chunk_ready(task.result()[0])

        out = await submit(self._current.copy(), self._lengths.copy(), 0)
        self._defer_release = self.block_mgr is not None
        finished = False
        # on an error the burst fetches what it dispatched and nothing
        # fetched (``unfetched``: a dispatched chunk; ``next_task``: a
        # dispatch not awaited) before the error reaches the loop, so its
        # failure path finds no chunk in flight and one fetch per chunk holds
        unfetched, next_task = out, None
        try:
            while True:
                if finished:
                    live = [i for i in active if self.slots[i].request is not None]
                    if not live:  # all done: apply the over-run chunk, end
                        unfetched = None
                        await self._apply_chunk(loop, out, active, [None] * len(active),
                                                K, programs.pop(0))
                        return
                    if len(live) != len(active):
                        active = live
                        mask = np.zeros(self.config.slots, dtype=bool)
                        mask[active] = True
                base_max += K
                next_task = submit(out[1], out[2], 1)
                unfetched = None  # _fetch_chunk fetches it, or waits for it and raises
                chunk_t, chunk_lp, wait_s, span_s = await loop.run_in_executor(
                    self._fetch_executor, partial(self._fetch_chunk, out[0], K))
                before = self.total_generated
                t_overlap = time.monotonic()
                in_flight = busy(next_task)
                finished = self._process_chunk(chunk_t, chunk_lp, active)
                await self._flush_emits()
                elapsed = time.monotonic() - t_overlap
                if not in_flight:
                    overlapped_s = 0.0  # the card was done before the host began
                elif busy(next_task):
                    overlapped_s = elapsed  # the card outlasted the host's work
                else:
                    overlapped_s = elapsed / 2.0  # it finished in between
                out, next_task = await next_task, None
                unfetched = out
                self._flight_record("decode", wait_s, tokens=self.total_generated - before,
                                    overlapped_s=overlapped_s, program=programs.pop(0),
                                    span_s=span_s)
                if self._burst_should_yield(finished, pipelined=True):
                    expected = [self.slots[i].request for i in active]
                    unfetched = None
                    if self._stop:  # nothing will drain it later
                        await self._apply_chunk(loop, out, active, expected, K,
                                                programs.pop(0))
                    else:
                        self._pending_chunk = (out, list(active), expected, K,
                                               programs.pop(0))
                    return
        except Exception:
            await self._settle_abandoned(loop, next_task, unfetched, K)
            raise
        finally:
            self._defer_release = False
            self._flush_deferred_releases()

    async def _settle_abandoned(self, loop, task, out, K: int) -> None:
        """A pipelined burst failed: wait for the dispatch it left running
        (``task``) and fetch every chunk it dispatched and never fetched,
        their tokens dropped. Host state never saw them, so the next
        dispatch re-derives their steps and rewrites their rows; what
        matters here is that none is still in flight when the loop's
        failure path frees blocks, and that each chunk is fetched once."""
        handles = [] if out is None else [out[0]]
        if task is not None:
            try:
                handles.append((await task)[0])
            except Exception:
                log.exception("an abandoned decode dispatch failed too")
        for handle in handles:
            try:
                await loop.run_in_executor(self._fetch_executor,
                                           partial(self._wait_chunk, handle, K))
            except Exception:
                log.exception("an abandoned decode chunk failed")

    async def _apply_chunk(self, loop, out, active: list[int], expected: list,
                           K: int, program: str) -> None:
        """Fetch and apply a dispatched chunk, each slot's tokens only to
        the request it ran for when the chunk was dispatched."""
        chunk_t, chunk_lp, wait_s, span_s = await loop.run_in_executor(
            self._fetch_executor, partial(self._fetch_chunk, out[0], K))
        before = self.total_generated
        self._process_chunk(chunk_t, chunk_lp, active, expected=expected)
        self._flight_record("decode", wait_s, tokens=self.total_generated - before,
                            program=program, span_s=span_s)
        await self._flush_emits()

    async def _drain_pending(self, loop) -> None:
        """Apply the chunk the last pipelined burst left in flight. The
        loop runs it after admission, so the admission prefill was queued
        behind it; a slot re-admitted since its dispatch ignores the old
        request's tokens."""
        pending, self._pending_chunk = self._pending_chunk, None
        try:
            if pending is not None:
                await self._apply_chunk(loop, *pending)
        finally:
            self._settled.set()

    @torch.no_grad()
    def _run_decode(self, tokens, lengths, active_mask, tables, window, K, mode,
                    temps, topks, topps, pres, freq, counts, ad_rows=None):
        """Dispatch thread, sequential loop: one chunk from host state,
        then its fetch. Returns what ``_fetch_chunk`` returns."""
        out = self._dispatch_decode(
            tokens, lengths, (active_mask, temps, topks, topps), tables, window,
            K, mode, None if pres is None else (pres, freq, counts), ad_rows,
        )
        return self._fetch_chunk(out[0], K)

    @torch.no_grad()
    def _dispatch_decode(self, tokens, lengths, sampler: tuple, tables, window,
                         K: int, mode: tuple, penalties: tuple | None = None,
                         ad_rows: np.ndarray | None = None):
        """Dispatch thread: launch one decode chunk and start its packed
        fetch; nothing here waits for the card. ``tokens``/``lengths`` are
        host arrays (a burst's first chunk, uploaded) or the previous
        chunk's device outputs; ``ad_rows`` the slots' adapter rows at
        dispatch (None without a store). Returns (fetch handle, final tokens, final
        lengths), the last two on the device."""
        t0 = time.monotonic()
        seq = None
        if self._lockstep is not None:
            op = "decode" if isinstance(tokens, np.ndarray) else "decode_cont"
            if op == "decode_cont" and tokens is not self._ls_carry:
                # a follower chains its own last chunk's outputs
                raise RuntimeError("a chained decode chunk must follow the last one dispatched")
            pen_fields = {}
            if penalties is not None:
                pen_fields = dict(pen=True, pres=penalties[0], freq=penalties[1],
                                  counts=penalties[2])
            seq = self._ls_broadcast(
                op, tokens=tokens if op == "decode" else None,
                lengths=lengths if op == "decode" else None,
                active=sampler[0], temps=sampler[1], topks=sampler[2], topps=sampler[3],
                tables=tables, window=None if window is None else int(window),
                k=int(K), sampler_mode=[bool(x) for x in mode], **pen_fields,
            )
        self.profiler.on_decode_chunk()
        start = self._timing_event()
        rows = None if self._dp_span is None else slice(*self._dp_span)
        if rows is not None:
            # this dp replica runs its own slots' rows (a chained chunk's
            # device tokens and lengths are its rows already)
            if isinstance(tokens, np.ndarray):
                tokens, lengths = tokens[rows], lengths[rows]
            sampler = tuple(a[rows] for a in sampler)
            tables = None if tables is None else tables[rows]
            penalties = None if penalties is None else tuple(a[rows] for a in penalties)
            ad_rows = None if ad_rows is None else ad_rows[rows]
        if isinstance(tokens, np.ndarray):
            tokens, lengths = self._upload(tokens), self._upload(lengths)
        amask, temps_t, topks_t, topps_t = self._sampler_device(*sampler)
        pres_t = freq_t = extras = None
        if penalties is not None:
            pres_t, freq_t, counts_t = (self._upload(a) for a in penalties)
            extras = (None, None, counts_t)
        sample_fn = self._sample_fn(temps_t, topks_t, topps_t, mode, pres_t, freq_t,
                                    draw=None if rows is None else (self.config.slots, rows))
        mc = self.model_config
        if self.block_mgr is not None:
            out = llama_decode_chunk_paged(
                mc, self.params, tokens, lengths, amask, self.cache_k, self.cache_v,
                self._tables_device(tables), sample_fn, K, num_read_blocks=window,
                sample_extras=extras, return_packed=True, ffn=self._ffn,
                adapters=self._adapters_device(ad_rows),
            )
        else:
            out = llama_decode_chunk_dense_pallas(
                mc, self.params, tokens, lengths, amask, self.cache_k, self.cache_v,
                sample_fn, K, window, sample_extras=extras, return_packed=True,
                ffn=self._ffn,
            )
        self._decode_dispatches += 1
        self._decode_steps += K
        packed = out[0]
        if rows is not None:
            packed = self._dp_gather(packed, rows, self.config.slots, [(K, 1), (K, 1)])
        handle = self._start_fetch(packed, start, None if seq is None else (op, seq))
        if seq is not None:
            self._ls_carry = out[1]
        self._decode_launch_s += time.monotonic() - t0
        return handle, out[1], out[2]

    def _start_fetch(self, packed: torch.Tensor, start=None, note=None) -> tuple:
        """Begin the chunk's one device-to-host copy without blocking: into
        one of the two pinned buffers (at most two chunks are in flight),
        with a CUDA event behind it (``start``: the event before the
        chunk's first launch). On the CPU the tensor is the result.
        ``note``: the lockstep ``(op, dispatch number)`` it carries to
        :meth:`_ls_note`."""
        if packed.device.type != "cuda":
            return packed, None, None, note
        n = packed.numel()
        buf = self._fetch_bufs[self._fetch_turn]
        if buf is None or buf.numel() < n:
            cap = 2 * self.config.slots * max(self.config.decode_chunk,
                                              self.config.decode_chunk_light, 1)
            buf = torch.empty(max(n, cap), dtype=torch.int32, pin_memory=True)
            self._fetch_bufs[self._fetch_turn] = buf
        self._fetch_turn ^= 1
        view = buf[:n]
        view.copy_(packed, non_blocking=True)
        return view, self._timing_event(), start, note

    @staticmethod
    def _chunk_ready(handle: tuple) -> bool:
        """Non-blocking probe: the chunk's copy has landed (always on the
        CPU, where the dispatch computed it)."""
        return handle[1] is None or handle[1].query()

    def _fetch_chunk(self, handle: tuple, K: int):
        """The chunk's ONE device-to-host copy behind the ``fetch`` fault
        seam: an injected failure still waits for the chunk (its fetch
        counted) before it raises, so nothing of the chunk is in flight
        when the error reaches the loop. See :meth:`_wait_chunk`."""
        try:
            self._fault("fetch")
        except InjectedFault:
            self._wait_chunk(handle, K)
            raise
        return self._wait_chunk(handle, K)

    def _wait_chunk(self, handle: tuple, K: int):
        """Wait for a chunk's copy, split the packed int32 into tokens (K,
        B) and logprobs (K, B); then the seconds blocked on the card and
        the chunk's span on the card (None on the CPU)."""
        view, event, start, note = handle
        t0 = time.monotonic()
        if event is not None:
            event.synchronize()
        flat = view.numpy().copy()  # the pinned buffer serves a later chunk
        wait_s = time.monotonic() - t0
        self._decode_fetches += 1
        B = self.config.slots
        n = K * B
        if note is not None:
            self._ls_note(note[1], note[0], flat[:n].reshape(K, B))
        return (flat[:n].reshape(K, B), flat[n:].view(np.float32).reshape(K, B), wait_s,
                self._span_s(start, event))

    # ------------------------------------------------------------------
    # speculation (prompt lookup, paged pool)
    # ------------------------------------------------------------------

    def _speculating(self, active: list[int]) -> bool:
        """Speculate when configured and not auto-disabled, unless an active
        request has penalties: they change the distribution per emitted
        token and the verify step keeps no counts, so those batches decode
        plainly."""
        return (
            self.config.speculative_drafts > 0
            and not self._spec_auto_disabled
            and not ((self._pres[active] != 0).any() or (self._freq[active] != 0).any())
        )

    def _sync_ctx_rows(self, live: list[int]):
        """The stale rows of the device context buffer, as ``(slot ids,
        rows (n, S) int32)`` or ``(None, None)``. A row is current when the
        ledger holds ``lengths + 1`` (history plus the pending current
        token); speculative steps extend rows on the device, so only slots
        fresh from prefill or from plain decode chunks upload, one full row
        each. Loop thread only (it updates the ledger)."""
        S = self.model_config.max_seq_len
        rows, vals = [], []
        for slot_id in live:
            request = self.slots[slot_id].request
            n = min(int(self._lengths[slot_id]) + 1, S)
            if int(self._ctx_synced[slot_id]) == n:
                continue
            ctx = request.prompt_tokens + request.generated
            row = np.zeros(S, dtype=np.int32)
            m = min(n, len(ctx))
            row[:m] = ctx[:m]
            rows.append(slot_id)
            vals.append(row)
            self._ctx_synced[slot_id] = n
        if not rows:
            return None, None
        return np.asarray(rows, dtype=np.int64), np.stack(vals)

    def _fetch_spec(self, packed: torch.Tensor, d1: int) -> tuple:
        """The step's ONE device-to-host copy, split into emitted tokens,
        advance counts, next tokens, new lengths, real-draft counts and
        logprobs; with the seconds the copy waited for the card."""
        B = self.config.slots
        nE = B * d1
        try:
            self._fault("fetch")
        except InjectedFault:
            packed.cpu()  # the step lands before the error leaves (see _fetch_chunk)
            self._spec_fetches += 1
            raise
        t0 = time.monotonic()
        flat = packed.cpu().numpy()
        wait_s = time.monotonic() - t0
        self._spec_fetches += 1
        return (
            flat[:nE].reshape(B, d1),
            flat[nE:nE + B],
            flat[nE + B:nE + 2 * B],
            flat[nE + 2 * B:nE + 3 * B],
            flat[nE + 3 * B:nE + 4 * B],
            flat[nE + 4 * B:].view(np.float32).reshape(B, d1),
        ), wait_s

    def _spec_note_step(self, tokens: int, wall_s: float) -> None:
        if tokens > 0 and wall_s > 0:
            self._spec_window.append((tokens, wall_s))

    def _spec_note_plain(self, tokens: int, wall_s: float) -> None:
        if tokens > 0 and wall_s > 0:
            self._plain_window.append((tokens, wall_s))

    def _spec_uplift(self) -> float | None:
        """Speculative tokens/s over plain tokens/s; None until the
        speculative window is full and a plain sample exists."""
        if len(self._spec_window) < (self._spec_window.maxlen or 1):
            return None
        if not self._plain_window:
            return None
        spec_n = sum(n for n, _ in self._spec_window)
        spec_t = sum(w for _, w in self._spec_window)
        plain_n = sum(n for n, _ in self._plain_window)
        plain_t = sum(w for _, w in self._plain_window)
        if spec_t <= 0 or plain_t <= 0 or plain_n <= 0:
            return None
        return (spec_n / spec_t) / (plain_n / plain_t)

    def _spec_check_uplift(self) -> bool:
        """Turn speculation off when the measured uplift is below 1; True
        when that happened (the burst returns to plain decode)."""
        uplift = self._spec_uplift()
        if uplift is None:
            return False
        self._spec_last_uplift = uplift
        self._m_spec_uplift(uplift)
        if uplift >= 1.0:
            return False
        self._spec_auto_disabled = True
        self._spec_plain_since_disable = 0
        self._spec_flips += 1
        self.flight.event("spec-auto-disable", uplift=round(uplift, 4),
                          window_steps=len(self._spec_window),
                          plain_samples=len(self._plain_window))
        log.info("speculation auto-disabled: measured uplift %.4f over %d steps "
                 "and %d plain samples", uplift, len(self._spec_window),
                 len(self._plain_window))
        self._spec_window.clear()
        self._plain_window.clear()
        return True

    def _spec_count_plain_chunk(self) -> None:
        """One plain decode chunk ran while speculation was auto-disabled;
        after ``_spec_retry_plain`` of them speculation re-auditions, with a
        calibration chunk due at once."""
        self._spec_plain_since_disable += 1
        if self._spec_plain_since_disable < self._spec_retry_plain:
            return
        self._spec_auto_disabled = False
        self._spec_plain_since_disable = 0
        self._spec_steps_since_cal = self._spec_cal_every
        self._spec_window.clear()
        self._plain_window.clear()
        self._spec_flips += 1
        self.flight.event("spec-auto-enable", plain_chunks=self._spec_retry_plain)
        log.info("speculation re-enabled after %d plain decode chunks",
                 self._spec_retry_plain)

    def _spec_cal_due(self) -> bool:
        return self._spec_steps_since_cal >= self._spec_cal_every

    async def _speculative_burst(self, loop, active: list[int]) -> None:
        """Prompt-lookup speculative decoding over the paged pool: per step
        one dispatch drafts each slot's continuation from the device
        context rows, verifies ``drafts + 1`` positions and extends the
        rows, and one packed fetch brings back all the host needs. Every
        ``_spec_cal_every`` steps a plain K=1 decode chunk calibrates the
        uplift verdict. Returns to the loop when a slot finishes, work
        waits (queue, prefills) or speculation turns itself off."""
        D1 = self.config.speculative_drafts + 1
        S = self.model_config.max_seq_len
        while not self._spec_auto_disabled:
            live = [i for i in active
                    if self.slots[i].request is not None and not self.slots[i].prefilling]
            if not live:
                return
            if self._spec_cal_due():
                t_wall = time.monotonic()
                before = self.total_generated
                await self._decode_chunk(loop, live, 1)
                self._spec_note_plain(self.total_generated - before,
                                      time.monotonic() - t_wall)
                self._spec_steps_since_cal = 0
                if self._spec_check_uplift() or self._should_yield(live):
                    return
                continue  # the chunk advanced the lengths
            self._fault("pool-grow")
            for slot_id in live:
                self.block_mgr.ensure_capacity(
                    slot_id, min(int(self._lengths[slot_id]) + D1, S))
            active_mask = np.zeros(self.config.slots, dtype=bool)
            active_mask[live] = True
            nrb = self._read_blocks_for(max(int(self._lengths[live].max()), 1))
            mode = self._sampler_mode(
                self._temps[active_mask], self._topks[active_mask],
                self._topps[active_mask],
            )
            ctx_rows, ctx_vals = self._sync_ctx_rows(live)
            program = self._program_spec_step(nrb, mode)
            t_wall = time.monotonic()
            fetched, wait_s, span_s = await loop.run_in_executor(
                self._executor,
                partial(self._run_spec_step, ctx_rows, ctx_vals, self._current.copy(),
                        self._lengths.copy(), active_mask,
                        self.block_mgr.tables.copy(), nrb, mode, self._temps.copy(),
                        self._topks.copy(), self._topps.copy(),
                        self._ad_rows.copy() if self._ad_rows is not None else None),
            )
            emitted, adv, nxt, _, n_real, logprobs = fetched
            self._m_spec_steps(1)
            self.spec_steps += 1
            self._spec_steps_since_cal += 1
            emitted_before = self.total_generated
            accepted_before, rejected_before = self.spec_accepted, self.spec_rejected
            for slot_id in live:
                a = int(adv[slot_id])
                base = int(self._lengths[slot_id])
                done = False
                accepted = 0
                for j in range(a):
                    # advance the length BEFORE each emit, so the emit's
                    # context-cap guard sees the true context size
                    self._lengths[slot_id] = base + j + 1
                    done = self._emit_token(slot_id, int(emitted[slot_id, j]),
                                            float(logprobs[slot_id, j]))
                    if j > 0:
                        accepted += 1
                    if done:
                        break
                if not done:
                    self._current[slot_id] = int(nxt[slot_id])
                    # the step appended the emitted run to the device row
                    self._ctx_synced[slot_id] = base + a + 1
                self.spec_accepted += accepted
                # only real drafts count as rejected; drafts left unread by
                # a stop or EOS inside the run were wasted positions too
                self.spec_rejected += max(0, int(n_real[slot_id]) - accepted)
            self._m_spec_accepted(self.spec_accepted - accepted_before)
            self._m_spec_rejected(self.spec_rejected - rejected_before)
            drafted = self.spec_accepted + self.spec_rejected
            if drafted:
                self._m_spec_ratio(self.spec_accepted / drafted)
            self._spec_note_step(self.total_generated - emitted_before,
                                 time.monotonic() - t_wall)
            self._flight_record(
                "verify", wait_s, tokens=self.total_generated - emitted_before,
                spec_accepted=self.spec_accepted - accepted_before,
                spec_rejected=self.spec_rejected - rejected_before, program=program,
                span_s=span_s)
            disabled = self._spec_check_uplift()
            await self._flush_emits()
            if disabled or self._should_yield(live):
                return

    def _should_yield(self, live: list[int]) -> bool:
        """A burst hands back to the loop when a slot finished or other work
        waits: queued requests, mid-prefill slots, a stop."""
        return (
            any(self.slots[i].request is None for i in live)
            or not self.scheduler.empty() or self._stop or self._has_prefilling()
            or (self._draining and not self._drain_pass_done)
        )

    @torch.no_grad()
    def _run_spec_step(self, ctx_rows, ctx_vals, current, lengths, active_mask,
                       tables, nrb, mode, temps, topks, topps, ad_rows=None):
        """Dispatch thread: patch the stale context rows, one
        ``llama_spec_step_paged``, one packed fetch. Returns the fetched
        parts, the seconds the fetch waited and the step's span on the card
        (None on the CPU)."""
        S = self.model_config.max_seq_len
        seq = self._ls_broadcast(
            "spec_step", ctx_rows=ctx_rows, ctx_vals=ctx_vals, current=current,
            lengths=lengths, active=active_mask, tables=tables, nrb=int(nrb),
            sampler_mode=[bool(x) for x in mode], temps=temps, topks=topks, topps=topps,
        )
        up = self._upload
        start = self._timing_event()
        rows = None if self._dp_span is None else slice(*self._dp_span)
        if rows is not None:
            # this dp replica runs its own slots' rows; its context rows
            # are theirs, from its first slot
            current, lengths, active_mask, tables, temps, topks, topps = (
                a[rows] for a in (current, lengths, active_mask, tables, temps,
                                  topks, topps))
            ad_rows = None if ad_rows is None else ad_rows[rows]
            if ctx_rows is not None:
                mine = (ctx_rows >= rows.start) & (ctx_rows < rows.stop)
                ctx_rows, ctx_vals = ctx_rows[mine] - rows.start, ctx_vals[mine]
        if self._ctx_dev is None:
            self._ctx_dev = torch.zeros((len(active_mask), S + 1), dtype=torch.int32,
                                        device=self.device)
        if ctx_rows is not None and len(ctx_rows):
            self._ctx_dev[up(ctx_rows), :S] = up(ctx_vals)
        greedy = mode[2]
        packed, self._ctx_dev, self.cache_k, self.cache_v = llama_spec_step_paged(
            self.model_config, self.params, self._ctx_dev, up(current), up(lengths),
            up(active_mask), self.cache_k, self.cache_v, up(tables),
            num_drafts=self.config.speculative_drafts, num_read_blocks=nrb,
            generator=self._generator,
            temps=None if greedy else up(temps),
            topks=None if greedy else up(topks),
            topps=None if greedy else up(topps),
            sampler_mode=mode, ffn=self._ffn, adapters=self._adapters_device(ad_rows),
            sample_rows=None if rows is None else (self.config.slots, rows),
        )
        d1 = self.config.speculative_drafts + 1
        if rows is not None:
            packed = self._dp_gather(packed, rows, self.config.slots,
                                     [(1, d1), (1, 1), (1, 1), (1, 1), (1, 1), (1, d1)])
        self._spec_dispatches += 1
        end = self._timing_event()
        parts, wait_s = self._fetch_spec(packed, d1)
        self._ls_note(seq, "spec_step", parts[0])
        return parts, wait_s, self._span_s(start, end)

    # ------------------------------------------------------------------
    # host-side token handling
    # ------------------------------------------------------------------

    def _process_chunk(self, chunk_tokens, chunk_lps, active: list[int],
                       expected: list | None = None) -> bool:
        """Apply a chunk's tokens; True when a slot finished. A slot's
        tokens after its request finished (the pipelined loop's over-run)
        are dropped, never billed; with ``expected`` (the requests the
        slots ran when the chunk was dispatched) a slot that now runs
        another request is skipped."""
        K = chunk_tokens.shape[0]
        finished = False
        for pos, slot_id in enumerate(active):
            request = self.slots[slot_id].request
            if request is None or (expected is not None and request is not expected[pos]):
                continue
            for k in range(K):
                if self.slots[slot_id].request is not request:
                    break  # finished mid-chunk; discard the tail
                self._lengths[slot_id] += 1
                token = int(chunk_tokens[k, slot_id])
                self._current[slot_id] = token
                finished |= self._emit_token(slot_id, token,
                                             float(chunk_lps[k, slot_id]))
        return finished

    def _emit_token(self, slot_id: int, token: int, logprob: float) -> bool:
        """Apply one token to its request; returns True when it finished."""
        request = self.slots[slot_id].request
        if request is None:
            return False
        is_eos = token == self.tokenizer.eos_id
        if not is_eos:
            request.generated.append(token)
            request.logprobs.append(logprob)
        stop_matched = False
        if request.stop and not is_eos:
            # decode only a tail window: any new match involves the newest
            # token, and every token decodes from at least one byte
            window = max(len(s.encode("utf-8")) for s in request.stop) + 8
            tail = self.tokenizer.decode(request.generated[-window:])
            if any(s in tail for s in request.stop):
                request.stop_matched = stop_matched = True
        self.total_generated += 1
        done = bool(
            is_eos
            or stop_matched
            or len(request.generated) >= request.max_tokens
            or self._lengths[slot_id] + 1 >= self.model_config.max_seq_len
            or request.future.cancelled()
        )
        if request.on_token is not None or request.on_chunk is not None:
            self._pending_emits.append((request, token, logprob, done))
        if done:
            self._release_slot(slot_id)
            self._finished_requests.append((request, is_eos))
        return done

    def _final_text(self, request: _Request) -> str:
        """Full decode, cut at the earliest stop match (match excluded)."""
        text = self.tokenizer.decode(request.generated)
        if request.stop_matched:
            hits = [i for i in (text.find(s) for s in request.stop) if i >= 0]
            if hits:
                text = text[: min(hits)]
        return text

    def _stream_text(self, request: _Request, is_final: bool) -> str:
        """The stream-safe decoded prefix: the final text when final, else
        the decode minus a trailing UTF-8 partial and minus any tail that
        could still grow into a stop match."""
        if is_final:
            return self._final_text(request)
        text = self.tokenizer.decode(request.generated)
        if text.endswith("�"):
            text = text[:-1]
        if request.stop:
            hits = [i for i in (text.find(s) for s in request.stop) if i >= 0]
            if hits:
                return text[: min(hits)]
            hold = 0
            for s in request.stop:
                for k in range(min(len(s) - 1, len(text)), 0, -1):
                    if s.startswith(text[-k:]):
                        hold = max(hold, k)
                        break
            if hold:
                text = text[: len(text) - hold]
        return text

    def _stream_stall_threshold(self, cls_name: str) -> float:
        """A class's stall line: its ``tbt-p99-s`` when it declares one,
        ``stream-stall-s`` otherwise."""
        if self.config.qos is not None:
            tbt = self.config.qos.class_policy(cls_name).tbt_p99_s
            if tbt is not None:
                return tbt
        return self.config.stream_stall_s

    async def _deliver_chunk(self, request: _Request, is_final: bool, now: float) -> None:
        """Deliver one flush's delta to the request's ``on_chunk`` consumer
        and, on a streaming engine, record its gap since the last delivery
        (the TBT digests, stall count, one ``stream-emit`` event per
        stream). A cancelled request gets nothing more."""
        if request.stream_closed:
            return
        if request.future.cancelled():
            request.stream_closed = True
            return
        safe = self._stream_text(request, is_final)
        delta = safe[request.stream_sent_chars:]
        new_ids = request.generated[request.stream_sent_tokens:]
        if not delta and not new_ids and not is_final:
            return  # the holdback kept the whole chunk back
        request.stream_sent_chars = max(request.stream_sent_chars, len(safe))
        request.stream_sent_tokens = len(request.generated)
        if request.stream_tbt is not None:
            if request.stream_first_emit is None:
                request.stream_first_emit = now
                self._journey(request, "first-emit")
            else:
                interval = now - (request.stream_last_emit or now)
                request.stream_tbt.add(interval)
                digest = self._stream_tbt_by_class.get(request.priority)
                if digest is None:
                    digest = self._stream_tbt_by_class[request.priority] = TbtDigest()
                digest.add(interval)
                self._stream_tbt_hist(request.priority)(interval, _exemplar(request))
                threshold = self._stream_stall_threshold(request.priority)
                if interval > threshold:
                    request.stream_stalls += 1
                    self.stream_stalls_total += 1
                    self.flight.event("stream-stall", request=request.journey_id,
                                      interval_s=round(interval, 6),
                                      threshold_s=threshold, priority=request.priority,
                                      tokens=len(request.generated))
            request.stream_last_emit = now
            request.stream_emits += 1
            self.stream_emits_total += 1
        if is_final:
            request.stream_closed = True
            if request.stream_tbt is not None:
                # one summarized event per stream, never one per chunk
                summary = request.stream_tbt.summary()
                self.flight.event(
                    "stream-emit", request=request.journey_id, emits=request.stream_emits,
                    tokens=len(request.generated), tbt_p50_s=summary["p50"],
                    tbt_p99_s=summary["p99"], tbt_max_s=summary["max"],
                    stalls=request.stream_stalls, priority=request.priority,
                )
                self._journey(request, "last-emit", emits=request.stream_emits)
        result = request.on_chunk(new_ids, delta, is_final)
        if asyncio.iscoroutine(result):
            await result

    async def _flush_emits(self) -> None:
        # one counter update per flush, before any caller hears of a token:
        # every emit path (prefill, chunk, speculative step) flushes
        tokens_new = self.total_generated - self._m_tokens_seen
        if tokens_new:
            self._m_tokens_seen = self.total_generated
            self._m_tokens(tokens_new)
        emits, self._pending_emits = self._pending_emits, []
        # on_token consumers get every token; on_chunk consumers one delivery
        # per request per flush, in first-appearance order
        chunks: "OrderedDict[int, list]" = OrderedDict()
        for request, token, logprob, done in emits:
            if request.on_token is not None:
                result = request.on_token(token, logprob, done)
                if asyncio.iscoroutine(result):
                    await result
            if request.on_chunk is not None:
                entry = chunks.setdefault(id(request), [request, False])
                entry[1] = entry[1] or done
        if chunks:
            # one clock per flush: emission is what the client observes
            now = time.monotonic()
            for request, done in chunks.values():
                await self._deliver_chunk(request, done, now)
        # an import's first new token closes its decode-admission segment:
        # read off the slots (an import streams nothing), one attribute
        # test per slot and flush
        for slot in self.slots:
            request = slot.request
            if (request is not None and request.imported and not request.first_step_noted
                    and len(request.generated) > request.import_base_tokens):
                request.first_step_noted = True
                self._journey(request, "first-step")
        finished, self._finished_requests = self._finished_requests, []
        for request, is_eos in finished:
            # the tenant's tokens/s post-debit; a cancelled request's tokens
            # burned capacity too
            self.scheduler.on_finished(request)
            # answered (a result or a cancellation): nothing left to replay
            self._journal_retire(request)
            if request.imported and not request.first_step_noted:
                # finished inside its first flush: its slot is released
                request.first_step_noted = True
                self._journey(request, "first-step")
            if request.future.done():
                # cancelled by the caller: not a served request (its slot
                # and the stream-cancel count went with _release_slot)
                if request.stream_cancel_counted:
                    self.flight.event(
                        "stream-cancel", request=request.journey_id,
                        tokens_generated=len(request.generated),
                        tokens_delivered=request.stream_sent_tokens,
                        tokens_wasted=len(request.generated) - request.stream_sent_tokens,
                        emits=request.stream_emits, priority=request.priority,
                        tenant=request.tenant, slot_reclaimed=True,
                    )
                self._journey(request, "cancelled")
                continue
            self.completed_requests += 1
            self._m_requests()
            if request.first_token_time is not None:
                self._m_ttft(request.first_token_time - request.enqueue_time)
            done_t = time.monotonic()
            first = request.first_token_time or done_t
            admit = request.admit_time or first
            if request.deadline is not None:
                # a completion past its budget still answers; the overrun is
                # recorded
                overrun = time.time() - request.deadline
                if overrun > 0:
                    self.deadline_overruns += 1
                    self.flight.event("deadline-overrun", overrun_s=round(overrun, 6),
                                      tokens=len(request.generated), tenant=request.tenant)
                    self._journey(request, "deadline-overrun", overrun_s=round(overrun, 6))
            timing = {
                "queue_wait": admit - request.enqueue_time,
                "prefill": first - admit,
                "ttft": first - request.enqueue_time,
                "decode": done_t - first,
                "tokens": float(len(request.generated)),
            }
            if request.imported:
                # admitted through import_handoff: prefill was skipped (the
                # prefill pool's share rode the handoff header)
                timing["imported"] = 1.0
            if request.stream_tbt is not None and request.stream_tbt.count:
                summary = request.stream_tbt.summary()
                timing["tbt_p50"] = summary["p50"]
                timing["tbt_p99"] = summary["p99"]
                timing["tbt_max"] = summary["max"]
                timing["tbt_count"] = float(summary["count"])
            if not request.warmup:
                self.request_timings.append(timing)
                # a traced request's journey id rides its TTFT bucket
                self._m_ttft_hist(timing["ttft"], _exemplar(request))
                self._m_queue_wait_hist(timing["queue_wait"])
                # SLO evidence (no-ops without a declared objective)
                self._slo_record("availability", True)
                self._slo_record_latency("ttft", timing["ttft"])
                self._slo_record_latency("queue-wait", timing["queue_wait"])
                if request.stream_tbt is not None and request.stream_tbt.count:
                    # one tbt event per finished stream: its own p99 gap,
                    # against slo.tbt and the class's tbt-p99-s tracker
                    p99 = request.stream_tbt.quantile(0.99)
                    self._slo_record_latency("tbt", p99)
                    tracker = self._stream_slo.get(request.priority)
                    if tracker is not None:
                        verdict = tracker.record_latency("tbt", p99 * 1000.0)
                        if verdict is not None and verdict["transition"]:
                            self.flight.event(
                                "alert", objective=f"tbt:{request.priority}",
                                state="firing" if verdict["alerting"] else "resolved",
                                burn_rate_fast=verdict["burn_rate_fast"],
                                burn_rate_slow=verdict["burn_rate_slow"],
                                budget_remaining=verdict["budget_remaining"],
                                target=verdict["target"],
                            )
                            if verdict["alerting"]:
                                # the class's streaming objective paged:
                                # capture, deduplicated per class
                                self._incident_capture("tbt-burn", {
                                    "source": "stream-slo",
                                    "objective": f"tbt:{request.priority}",
                                    "tbt_p99_s": p99,
                                    "burn_rate_fast": verdict["burn_rate_fast"],
                                    "budget_remaining": verdict["budget_remaining"],
                                    "target": verdict["target"],
                                }, dedup_key=request.priority)
            finish_reason = "stop" if is_eos or request.stop_matched else "length"
            self._journey(request, "finish", reason=finish_reason,
                          tokens=len(request.generated), model=self.config.model)
            if request.trace is not None:
                # the request's phases as child spans of its trace, from the
                # stamps above (no clock in the decode loop)
                svc = f"engine:{self.config.model}"
                record_span("engine.queue", svc, request.trace, request.enqueue_time, admit)
                record_span("engine.prefill", svc, request.trace, admit, first,
                            attributes={"prompt-tokens": len(request.prompt_tokens)})
                record_span("engine.decode", svc, request.trace, first, done_t,
                            attributes={"tokens": len(request.generated)})
            request.future.set_result({
                "tokens": request.generated,
                "text": self._final_text(request),
                "logprobs": request.logprobs,
                "num_prompt_tokens": len(request.prompt_tokens),
                "num_completion_tokens": len(request.generated),
                "ttft": timing["ttft"],
                "queue_wait": timing["queue_wait"],
                "prefill": timing["prefill"],
                "finish_reason": finish_reason,
            })

def _to_device(tree, device):
    if isinstance(tree, QTensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def health_report() -> list[dict[str, Any]]:
    """Every live shared engine's :meth:`TorchServingEngine.health` verdict,
    for a pod's liveness and readiness probes. Wait-free: the instance map
    is copied without its lock, so a probe never queues behind a
    constructor holding it; a torn read at worst misses a brand-new
    engine for one poll."""
    return [engine.health() for engine in list(TorchServingEngine._instances.values())]


def kick_warmups() -> None:
    """Begin the warmup of every live ``warmup-on-start`` engine that has not
    begun it (the readiness probe calls this, so a fresh pod warms inside its
    not-ready window). Task creation only: it runs on the engines' event
    loop and never waits."""
    for engine in list(TorchServingEngine._instances.values()):
        if engine.config.warmup_on_start and engine._warmup_task is None and not engine._stop:
            engine._warmup_begun()


def take_kv_export(request_id: str) -> dict[str, Any] | None:
    """Pop one KV handoff export entry (``{"payload", "bytes", ...}``) from
    whichever live engine holds it (a pod's ``GET /kv/export/{request}``).
    Wait-free: an instance-map snapshot and one dict pop per engine."""
    for engine in list(TorchServingEngine._instances.values()):
        entry = engine.take_export_entry(request_id)
        if entry is not None:
            return entry
    return None


def flight_report(summary_only: bool = False, samples: int = 240) -> list[dict[str, Any]]:
    """The flight-recorder payload of every live shared engine (the pod's
    ``/flight`` and ``/flight/summary``): per engine its model, the rollup,
    the scheduler, health, drain, pool-role, survival and the sections of
    the planes it runs, with the JAX engine's keys; unless
    ``summary_only``, the recent samples and the event tail too."""
    with TorchServingEngine._instances_lock:
        engines = list(TorchServingEngine._instances.values())
    report: list[dict[str, Any]] = []
    for engine in engines:
        entry: dict[str, Any] = {
            "model": engine.config.model,
            "slots": engine.config.slots,
            "summary": engine.flight.summary(),
            "scheduler": engine.scheduler.stats(),
            "health": engine.health(),
            "drain": engine._drain_section(),
            "pool_role": engine.config.pool_role,
            "kvtransfer": engine.kv_transfer_section(),
            "survival": engine.survival_section(),
        }
        if engine.prefix_store is not None:
            entry["prefixstore"] = engine.prefix_store_section()
        if engine.adapter_store is not None:
            entry["adapters"] = engine.adapter_store_section()
        if engine.config.streaming:
            entry["streaming"] = engine.streaming_section()
        if engine.config.speculative_drafts > 0:
            entry["speculative"] = engine.speculative_section()
        if engine.incidents is not None:
            # the capture posture and the newest bundles (incident-dir only)
            entry["incidents"] = {**engine.incidents.stats(),
                                  "recent": engine.incidents.list()[-4:]}
        slo = engine.slo_status()
        if slo is not None:
            entry["slo"] = slo
        if not summary_only:
            entry["samples"] = engine.flight.recent(samples)
            entry["events"] = engine.flight.recent_events()
        report.append(entry)
    return report


def incident_report(bundle_id: str | None = None) -> list[dict[str, Any]]:
    """Every live engine's incident payload (the pod's ``/incidents``): per
    engine with an ``incident-dir`` its bundle index and capture stats, or,
    with ``bundle_id``, the full bundle from whichever engine holds it. The
    instance map is copied without its lock, as in :func:`health_report`;
    the recorder's own table lock is never the loop's."""
    report: list[dict[str, Any]] = []
    for engine in list(TorchServingEngine._instances.values()):
        rec = engine.incidents
        if rec is None:
            continue
        entry: dict[str, Any] = {"model": engine.config.model}
        if bundle_id is not None:
            bundle = rec.get(bundle_id)
            if bundle is None:
                continue
            entry["bundle"] = bundle
        else:
            entry["incidents"] = rec.list()
            entry["stats"] = rec.stats()
        report.append(entry)
    return report


def attribution_report() -> list[dict[str, Any]]:
    """Every live shared engine's ``attribution_section()`` (the pod's
    ``/attribution`` and ``/memory``). Wait-free like :func:`health_report`:
    the instance map is copied without its lock."""
    return [engine.attribution_section()
            for engine in list(TorchServingEngine._instances.values())]


async def drain_engines(grace_s: float = 30.0) -> dict[str, Any]:
    """Drain every live shared engine (the pod's ``/drain`` and its preStop
    hook) under ONE deadline for the whole pod: each engine drains in the
    time left to it (at least 0.5 s, so the last engines still shed their
    leftovers explicitly). Sequential: the engines share a loop and a card.
    Returns the drain report by model."""
    with TorchServingEngine._instances_lock:
        engines = list(TorchServingEngine._instances.values())
    deadline = time.monotonic() + grace_s
    reports: dict[str, Any] = {}
    for engine in engines:
        remaining = max(0.5, deadline - time.monotonic())
        reports[engine.config.model] = await engine.drain(remaining)
    return reports


def import_candidates(model: str | None) -> list[TorchServingEngine]:
    """The live shared engines that can take a KV handoff of ``model``: paged,
    not a prefill pool; decode pools first (a combined paged engine also
    accepts, the dev and test posture)."""
    candidates = [
        engine for engine in list(TorchServingEngine._instances.values())
        if engine.config.model == model and engine.block_mgr is not None
        and engine.config.pool_role != "prefill"
    ]
    candidates.sort(key=lambda e: 0 if e.config.pool_role == "decode" else 1)
    return candidates


async def import_kv_handoff(payload: bytes, trace_header: str | None = None,
                            deadline_header: str | None = None) -> dict[str, Any]:
    """Route one KV handoff payload to this process's engine for its model
    (the pod's ``POST /kv/import``): the header's fingerprint names the
    model, decode pools first. ``deadline_header`` (the request's
    ``langstream-deadline``) is the budget when the wire header carries
    none; ``trace_header`` (its ``langstream-trace``) parents the import's
    spans when the payload carries no trace, and is echoed as the result's
    ``trace``. Raises
    :class:`~langstream_tpu_torch.serving.kvtransfer.LayoutMismatch` when
    no engine here can take it, and what :meth:`TorchServingEngine.import_handoff`
    raises."""
    header = kvtransfer.peek_header(payload)
    model = (header.get("fingerprint") or {}).get("model")
    candidates = import_candidates(model)
    if not candidates:
        raise kvtransfer.LayoutMismatch(
            f"no decode-capable paged engine for model {model!r} in this pod")
    result = await candidates[0].import_handoff(
        payload, header=header, trace_header=trace_header,
        deadline=parse_deadline(deadline_header))
    trace = header.get("trace") or trace_header
    if trace and "trace" not in result:
        result = {**result, "trace": trace}
    return result


def profile_engines(action: str, trace_dir: str | None = None) -> dict[str, bool]:
    """Start or stop the ``torch.profiler`` capture of the live shared
    engines (the pod's ``/profile/{start,stop}``); by model, whether their
    capture started or stopped. ``torch.profiler`` records the whole
    process and runs one session at a time, so one engine's capture covers
    every engine (a second session would fail)."""
    if action not in ("start", "stop"):
        raise ValueError(f"unknown profile action {action!r} (start|stop)")
    with TorchServingEngine._instances_lock:
        engines = list(TorchServingEngine._instances.values())
    if action == "start":
        done = False
        for engine in engines:
            done = done or engine.profiler.start_trace(trace_dir)
    else:
        done = any([engine.profiler.stop_trace() for engine in engines])
    return {engine.config.model: done for engine in engines}
