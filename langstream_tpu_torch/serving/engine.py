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
  ``adapter`` (no adapter store here) raises ``ValueError``; one whose
  ``deadline``/``deadline-s`` budget is spent raises
  :class:`~langstream_tpu_torch.serving.deadline.DeadlineExceeded`; both
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

Settings whose feature this slice lacks raise ``NotImplementedError`` naming
the ``ROADMAP.md`` item; settings that only change latency are accepted and
logged once. The engine runs on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; it never falls back on its own.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from langstream_tpu_torch._device import require_device
from langstream_tpu_torch.models.checkpoints import (
    load_llama_checkpoint,
    load_moe_checkpoint,
)
from langstream_tpu_torch.models.llama import (
    LlamaConfig,
    init_llama_params,
    param_count,
    prefill_forward,
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
    moe_serving_ffn,
)
from langstream_tpu_torch.models.paged import (
    BlockManager,
    PagedLayout,
    init_paged_kv_cache,
    init_paged_kv_cache_int8,
)
from langstream_tpu_torch.models.quant import (
    QTensor,
    init_llama_params_q8,
    init_moe_params_q8,
    quantize_llama_params,
    quantize_moe_params,
)
from langstream_tpu_torch.models.tokenizer import Tokenizer, load_tokenizer
from langstream_tpu_torch.ops.flash_attention import flash_attention
from langstream_tpu_torch.ops.paged_attention import (
    _paged_attention_partial_q8,
    paged_attention_multiquery_partial,
    paged_attention_partial,
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
from langstream_tpu_torch.serving.deadline import (
    DeadlineExceeded,
    deadline_from_options,
    remaining_s,
)
from langstream_tpu_torch.serving.flight import FlightRecorder
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
from langstream_tpu_torch.serving.qos import QosSpec, RateLimited, normalize_priority
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


def _parse_bool(v: Any) -> bool:
    """YAML/env values arrive as strings; bool("false") is True, so parse."""
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The ``tpu-serving-configuration`` resource: the same fields, kebab
    keys and defaults as the JAX package's ``ServingConfig``. ``qos`` and
    ``slo`` parse into their frozen specs (so the config stays hashable);
    sections of planes this port does not carry yet (prefix-store,
    adapter-store, faults) are kept as the raw mapping the resource gave."""

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
    prefix_store: Any = None
    adapter_store: Any = None
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
            prefix_store=get("prefix-store"),
            adapter_store=get("adapter-store"),
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
            faults=tuple(d.get("faults") or ()),
            journal_dir=get("journal-dir", os.environ.get("LS_TPU_JOURNAL_DIR") or None),
            incident_dir=get("incident-dir", os.environ.get("LS_TPU_INCIDENT_DIR") or None),
        )


#: settings this slice does not serve: (predicate, message)
_UNSUPPORTED: tuple[tuple[Callable[[ServingConfig], bool], str], ...] = (
    (lambda c: bool(c.mesh),
     "mesh: multi-GPU serving (expert parallelism too) is ROADMAP.md Queue 1 item 13"),
    (lambda c: c.kv_quantize == "int8" and c.kv_layout == "dense",
     "kv-quantize: int8 with kv-layout: dense: the port serves int8 KV from "
     "the paged pool only (ROADMAP.md Queue 1 item 3); use kv-layout: paged"),
    (lambda c: c.adapter_store is not None,
     "adapter-store: multi-LoRA is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.prefix_store is not None,
     "prefix-store: the tiered prefix store is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.pool_role != "combined",
     "pool-role other than combined: KV handoff is ROADMAP.md Queue 1 item 10"),
    (lambda c: bool(c.faults), "faults: fault injection is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.journal_dir is not None,
     "journal-dir: the crash-requeue journal is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.incident_dir is not None,
     "incident-dir: incident capture is ROADMAP.md Queue 1 item 9"),
)

#: accepted settings that change only latency here; logged once when set
_LATENCY_ONLY = (
    "paged_kernel", "dense_kernel", "shrink_fraction", "shrink_recovery_s",
)


def _check_supported(config: ServingConfig) -> None:
    for unsupported, message in _UNSUPPORTED:
        if unsupported(config):
            raise NotImplementedError(f"not in this port yet: {message}")
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
                 streams: StreamCancelRegistry | None = None):
        _check_supported(config)
        self.device = require_device(device, "TorchServingEngine")
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

    # ------------------------------------------------------------------
    # model + cache
    # ------------------------------------------------------------------

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
        if params is None and self.config.checkpoint:
            # loaded on the CPU in the model dtype, then (int8) quantized:
            # the JAX engine's order, so the bf16 rounding happens before
            # the quantizer as there. A MoE tree is quantized before it
            # moves: an int8 Mixtral-8x7B fits the card, a bf16 one not
            params = load(self.config.checkpoint, mc)
            if int8 and self.is_moe:
                params = quantize(params)
        if params is None:
            log.warning(
                "no checkpoint configured for model %r: using random-init "
                "weights (offline/dev mode)", self.config.model,
            )
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
        else:
            shape = (mc.layers, self.config.slots, mc.max_seq_len,
                     mc.kv_heads, mc.head_dim)
            self.cache_k = torch.zeros(shape, dtype=mc.dtype, device=dev)
            self.cache_v = torch.zeros(shape, dtype=mc.dtype, device=dev)

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
        return self._program(
            f"decode:w{rows}:k{k_steps}:{self._sampler_code(sampler_mode)}"
            + (":pen" if pen else ""),
            lambda: decode_cost(self._prog_shape, slots=self.config.slots,
                                window_rows=rows, k_steps=k_steps,
                                hbm_gbps=self._hbm_gbps),
        )

    def _program_prefill(self, bucket: int, rows: int, sampler_mode: tuple) -> str:
        return self._program(
            f"prefill:p{bucket}:b{rows}:{self._sampler_code(sampler_mode)}",
            lambda: prefill_cost(self._prog_shape, rows=rows, tokens_per_row=bucket,
                                 prefix_rows=0, hbm_gbps=self._hbm_gbps),
        )

    def _program_prefill_continue(self, nrb: int, rows: int, chunk: int,
                                  sampler_mode: tuple) -> str:
        return self._program(
            f"prefill-continue:nrb{nrb}:b{rows}:c{chunk}:"
            f"{self._sampler_code(sampler_mode)}",
            lambda: prefill_cost(self._prog_shape, rows=rows, tokens_per_row=chunk,
                                 prefix_rows=nrb * self.paged_layout.block_size,
                                 hbm_gbps=self._hbm_gbps),
        )

    def _program_spec_step(self, nrb: int, sampler_mode: tuple) -> str:
        drafts = self.config.speculative_drafts
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
        sample = self.flight.sample(
            phase, device_s=device_s, overlapped_s=overlapped_s, tokens=tokens,
            occupancy=sum(1 for s in self.slots if not s.free),
            queue_depth=self.scheduler.qsize(), stall=self._admission_stall(),
            kv_used=self._kv_used(), prefix_hits=self.prefix_hits,
            spec_accepted=spec_accepted, spec_rejected=spec_rejected,
            queue_by_class=self.scheduler.depths(), program=program,
        )
        # watchdog heartbeat: a recorded dispatch is step progress
        self.watchdog.beat(sample["queue_depth"])
        if phase == "decode":
            self._decode_s += sample["wall_ms"] / 1000.0
            if self.config.speculative_drafts > 0 and self._spec_auto_disabled:
                self._spec_count_plain_chunk()

    def _flight_stall(self, reason: str) -> None:
        """An idle gap of the loop, recorded as stall time; it beats the
        watchdog too, so an idle engine never reads as wedged."""
        sample = self.flight.stall(
            reason, occupancy=sum(1 for s in self.slots if not s.free),
            queue_depth=self.scheduler.qsize(), kv_used=self._kv_used(),
            queue_by_class=self.scheduler.depths(),
        )
        self.watchdog.beat(sample["queue_depth"])

    def attribution_section(self) -> dict[str, Any]:
        """``stats()["attribution"]``: the per-program achieved-vs-expected
        ledger and the device-memory ledger (the JAX engine's keys);
        snapshot reads and arithmetic only."""
        return {
            "model": self.config.model,
            "slots": self.config.slots,
            "generation": self._hbm_generation,
            "hbm_gbps_assumed": self._hbm_gbps,
            "programs": self.attribution.report(),
            "memory": self._memory_ledger(),
        }

    def _memory_ledger(self) -> dict[str, Any]:
        """Device bytes by owner; the limit is the card's total memory.
        No KV handoff (ROADMAP.md Queue 1 item 10) and no pool shrink
        (item 9) in this port: their terms are 0."""
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

        Refused before the request queues: ``adapter`` (``ValueError``: no
        adapter store in this port), a spent ``deadline``/``deadline-s``
        budget (:class:`DeadlineExceeded`) and, under QoS, a full class
        queue or an empty tenant bucket (:class:`RateLimited`).
        ``_warmup_probe`` is internal: warmup's own requests skip the warmup
        gate (they are the warmup) and QoS policy."""
        if self._stop:
            raise RuntimeError("serving engine is stopped (closed)")
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
        if adapter:
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
        )
        if on_chunk is not None and self.config.streaming:
            # the bounded per-request TBT digest: only streaming engines pay
            request.stream_tbt = TbtDigest()
        if request.deadline is not None and not _warmup_probe:
            left = remaining_s(request.deadline)
            if left <= 0.0:
                # an unmeetable budget is refused before it queues: never a
                # silent late completion
                raise self._note_deadline_shed(request, "submit", left)
        try:
            self.scheduler.submit(request)
        except RateLimited as e:
            # load shed or tenant throttle, refused before any slot or block
            # was touched; callers map it to 429 with Retry-After
            self.flight.event("shed", reason=e.reason, tenant=request.tenant,
                              priority=request.priority, retry_after_s=e.retry_after)
            if not _warmup_probe:
                self._slo_record("shed-rate", False)
            raise
        if not _warmup_probe:
            # the shed-rate objective counts every submission: admitted good
            self._slo_record("shed-rate", True)
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
            # launch counters of the port's kernels in this process
            "kernels": {
                "flash_attention": flash_attention.launches,
                "paged_attention": paged_attention_partial.launches,
                "paged_attention_q8": _paged_attention_partial_q8.launches,
                "paged_attention_multiquery": paged_attention_multiquery_partial.launches,
            },
        }
        if self.block_mgr is not None:
            out["kv"] = {"layout": "paged", **self.block_mgr.stats()}
        if self.config.speculative_drafts > 0:
            out["speculative"] = self.speculative_section()
        slo = self.slo_status()
        if slo is not None:
            out["slo"] = slo
        if self.config.streaming:
            out["streaming"] = self.streaming_section()
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
        the JAX engine's (``draining`` and ``budget_withheld`` stay at their
        idle values: the drain and pool-shrink planes are not ported)."""
        queued = self.scheduler.qsize()
        occupancy = sum(1 for s in self.slots if not s.free)
        tbt_burn = self._tbt_burning()
        verdict = self.watchdog.evaluate(
            queued=queued, occupancy=occupancy,
            samples=self.flight.recent(240), events=self.flight.recent_events(256),
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
        warmup = self._warmup_state()
        out = {
            "model": self.config.model,
            "slots": self.config.slots,
            **verdict,
            "warmup": warmup,
            "draining": False,
            "ready": warmup not in ("pending", "running") and verdict["state"] != "wedged",
            "budget_withheld": 0,
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
        """An ``alert`` flight event when an objective's multi-window fast
        burn starts or stops: alerts fire at record time, so an unwatched
        engine still leaves the evidence in its event ring."""
        if verdict is not None and verdict["transition"]:
            self.flight.event(
                "alert", objective=objective,
                state="firing" if verdict["alerting"] else "resolved",
                burn_rate_fast=verdict["burn_rate_fast"],
                burn_rate_slow=verdict["burn_rate_slow"],
                budget_remaining=verdict["budget_remaining"], target=verdict["target"],
            )

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
        closed = RuntimeError("serving engine closed")
        for request in self.scheduler.drain():
            if not request.future.done():
                request.future.set_exception(closed)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    async def _run_loop(self) -> None:
        loop = asyncio.get_running_loop()
        # the loop starts at the first request: the gap since construction
        # is no sample's wall time, and the wedge window measures from here
        self.flight.mark()
        self.watchdog.beat(self.scheduler.qsize())
        while not self._stop:
            try:
                if not self.scheduler.empty():
                    await self._admit(loop)
                # a pipelined burst may have left a chunk in flight: applied
                # only after admission, so the prefill above was queued
                # behind it, and before preemption, so a victim's state is
                # settled (the JAX engine's order)
                if self._pending_chunk is not None:
                    await self._drain_pending(loop)
                if not self.scheduler.empty():
                    # the slots the drained chunk freed admit at once; then,
                    # under QoS, a head stalled on KV blocks may preempt a
                    # lower class's victim and land in this pass
                    await self._admit(loop)
                    if self._maybe_preempt():
                        await self._admit(loop)
                if self._has_prefilling():
                    # one bounded chunk per loop pass: long prefills make
                    # progress without stalling the decode chunks below
                    await self._advance_prefills(loop)
                active = [
                    i for i, s in enumerate(self.slots)
                    if not s.free and not s.prefilling
                ]
                if not active:
                    if self.scheduler.empty() and not self._has_prefilling():
                        self._wake.clear()
                        try:
                            await asyncio.wait_for(self._wake.wait(), timeout=1.0)
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
            except Exception as e:  # device/runtime error: fail in-flight work,
                # free the slots, keep serving (callers see the exception)
                log.exception("serving engine step failed")
                self._fail_inflight(e)
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
        for slot_id, slot in enumerate(self.slots):
            request = slot.request
            if request is None:
                continue
            self._release_slot(slot_id)
            if not request.future.done():
                request.future.set_exception(error)
                if not request.warmup:
                    self._slo_record("availability", False)
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
        self.flight.event("deadline-exceeded", where=where, remaining_s=round(left, 6),
                          estimate_s=round(estimate, 6), tenant=request.tenant,
                          priority=request.priority)
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
        vals = sorted(t.get("prefill", 0.0) for t in list(self.request_timings)[-32:])
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
        request.preemptions += 1
        request.preempt_time = now
        self.scheduler.note_preempted(request)
        self.scheduler.requeue_front(request)
        self.flight.event("preempt", reason=reason, priority=request.priority,
                          tenant=request.tenant, generated=len(request.generated))

    def _note_resume(self, request: _Request) -> None:
        """A preempted request was just readmitted: a ``resume`` flight
        event with the wait since its preemption."""
        if request.preempt_time is None:
            return
        waited = time.monotonic() - request.preempt_time
        self.flight.event("resume", priority=request.priority, tenant=request.tenant,
                          generated=len(request.generated),
                          waited_ms=round(waited * 1000.0, 3))
        request.preempt_time = None

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
        mixes generated tokens into what looks like a prompt. With
        ``prefill-chunk`` a request with more tokens to prefill than the
        chunk claims its slot and reservation here and prefills in
        :meth:`_advance_prefills`.
        """
        S = self.model_config.max_seq_len
        cfg = self.config
        use_prefix = self.block_mgr is not None and cfg.prefix_cache
        while not self.scheduler.empty():
            free = [i for i, s in enumerate(self.slots) if s.free]
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
                    continue
                if request.deadline is not None:
                    left = remaining_s(request.deadline)
                    estimate = self._admit_estimate_s()
                    if left <= estimate:
                        self.scheduler.pop()
                        err = self._note_deadline_shed(request, "admission", left, estimate)
                        if not request.future.done():
                            request.future.set_exception(err)
                        continue
                ctx = request.context_tokens
                total = len(request.prompt_tokens) + request.max_tokens + 1
                if self.block_mgr is not None and not self.block_mgr.can_admit(total):
                    # paged backpressure: finishing slots free reservations
                    # (under QoS the loop may preempt a lower-class victim)
                    break
                blocks, reuse = [], 0
                if use_prefix and not request.preemptions:
                    blocks, reuse = self.block_mgr.match_prefix(ctx)
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
                    slot.request = request
                    slot.prefilling = True
                    slot.prefill_done = reuse
                    self.block_mgr.ensure_capacity(slot_id, len(ctx))
                    request.admit_time = time.monotonic()
                    self._note_resume(request)
                    if reuse:
                        self.prefix_hits += 1
                        self.prefix_tokens += reuse
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
                request.admit_time = now
                self._note_resume(request)
                if self.block_mgr is not None:
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
            next_np, logprob_np, wait_s, span_s = await loop.run_in_executor(
                self._executor,
                partial(self._run_prefill, padded, lengths, slot_ids, tables,
                        temps, topks, topps, mode, cont),
            )
            if use_prefix:
                for slot_id, request, reuse in batch:
                    if request.preemptions:
                        continue  # a resumed context is no shareable prompt
                    self.block_mgr.register_prefix(slot_id, request.prompt_tokens)
                    if reuse:
                        self.prefix_hits += 1
                        self.prefix_tokens += reuse
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

    async def _advance_prefills(self, loop) -> None:
        """One chunk of at most ``prefill-chunk`` prompt tokens for every
        mid-prefill slot, batched through the continuation path with
        ``starts`` at the rows already committed. The final chunk's sampled
        token is the request's first generated token; the slot then joins
        decode."""
        for slot_id, slot in enumerate(self.slots):
            if slot.prefilling and slot.request.future.cancelled():
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
        next_np, logprob_np, wait_s, span_s = await loop.run_in_executor(
            self._executor,
            partial(self._run_prefill, tokens, suffix_lens, slot_ids,
                    self.block_mgr.tables[slot_ids].copy(), temps, topks,
                    topps, mode, cont),
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
            if self.config.prefix_cache and not request.preemptions:
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

    def _sample_fn(self, temps_t, topks_t, topps_t, mode, pres_t=None, freq_t=None):
        """A ``sample_fn`` closure over device tensors of the rows' settings."""
        use_top_p, use_top_k, all_greedy = mode
        pen = pres_t is not None

        def sample_fn(logits, counts=None):
            return sample_tokens(
                logits, self._generator, temps_t, topks_t,
                use_top_p=use_top_p, top_ps=topps_t, use_top_k=use_top_k,
                all_greedy=all_greedy, use_penalties=pen, presences=pres_t,
                frequencies=freq_t, counts=counts,
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

    @torch.no_grad()
    def _run_prefill(self, padded, lengths, slot_ids, tables, temps, topks,
                     topps, mode, cont=None):
        """Dispatch thread: one batched prefill + first-token sample; one
        packed device-to-host copy. ``cont = (starts, num_read_blocks)``
        sends the batch through the continuation path (``padded`` then
        holds each row's suffix). Returns (tokens, logprobs) numpy, the
        seconds the copy waited for the card and the dispatch's span on
        the card (None on the CPU)."""
        mc, up = self.model_config, self._upload
        start = self._timing_event()
        tokens = up(padded)
        lengths_t = up(lengths)
        # a slot named by several rows (a padded batch) commits its last row
        commit = np.array([s not in slot_ids[i + 1:] for i, s in enumerate(slot_ids)])
        commit_t = None if commit.all() else up(commit)
        if cont is not None:
            starts, nrb = cont
            logits, _, _ = llama_prefill_continue_paged(
                mc, self.params, tokens, up(starts), lengths_t, self.cache_k,
                self.cache_v, up(tables), num_read_blocks=nrb, ffn=self._ffn,
                commit_rows=commit_t,
            )
            self._continue_calls += 1
        elif self.block_mgr is not None:
            logits, _, _ = llama_prefill_paged(
                mc, self.params, tokens, lengths_t, self.cache_k, self.cache_v,
                up(tables), ffn=self._ffn, commit_rows=commit_t,
            )
        else:
            logits, ks, vs = prefill_forward(mc, self.params, tokens, lengths_t,
                                             ffn=self._ffn)
            Pn = tokens.shape[1]
            if commit_t is None:
                sel = up(slot_ids)
            else:
                sel = up(slot_ids[commit])
                keep = up(np.flatnonzero(commit))
                ks, vs = ks[:, keep], vs[:, keep]
            self.cache_k[:, sel, :Pn] = ks
            self.cache_v[:, sel, :Pn] = vs
        nxt, lps = self._sample_fn(up(temps), up(topks), up(topps), mode)(logits)
        self._prefill_calls += 1
        packed = pack_tokens_logprobs(nxt, lps)
        end = self._timing_event()
        t0 = time.monotonic()
        host = packed.cpu().numpy()  # the prefill's one device-to-host copy
        wait_s = time.monotonic() - t0
        B = len(lengths)
        return host[:B], host[B:].view(np.float32), wait_s, self._span_s(start, end)

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
            self._heavy_chunks += 1
            return loop.run_in_executor(
                self._executor,
                partial(self._dispatch_decode, tokens, lengths, sampler, tables,
                        window, K, mode),
            )

        def busy(task) -> bool:
            """The card still works on the chunk ``task`` dispatches."""
            return not task.done() or not self._chunk_ready(task.result()[0])

        out = await submit(self._current.copy(), self._lengths.copy(), 0)
        self._defer_release = self.block_mgr is not None
        finished = False
        try:
            while True:
                if finished:
                    live = [i for i in active if self.slots[i].request is not None]
                    if not live:  # all done: apply the over-run chunk, end
                        await self._apply_chunk(loop, out, active, [None] * len(active),
                                                K, programs.pop(0))
                        return
                    if len(live) != len(active):
                        active = live
                        mask = np.zeros(self.config.slots, dtype=bool)
                        mask[active] = True
                base_max += K
                next_task = submit(out[1], out[2], 1)
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
                out = await next_task
                self._flight_record("decode", wait_s, tokens=self.total_generated - before,
                                    overlapped_s=overlapped_s, program=programs.pop(0),
                                    span_s=span_s)
                if self._burst_should_yield(finished, pipelined=True):
                    expected = [self.slots[i].request for i in active]
                    if self._stop:  # nothing will drain it later
                        await self._apply_chunk(loop, out, active, expected, K,
                                                programs.pop(0))
                    else:
                        self._pending_chunk = (out, list(active), expected, K,
                                               programs.pop(0))
                    return
        finally:
            self._defer_release = False
            self._flush_deferred_releases()

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
        if pending is not None:
            await self._apply_chunk(loop, *pending)
        self._settled.set()

    @torch.no_grad()
    def _run_decode(self, tokens, lengths, active_mask, tables, window, K, mode,
                    temps, topks, topps, pres, freq, counts):
        """Dispatch thread, sequential loop: one chunk from host state,
        then its fetch. Returns what ``_fetch_chunk`` returns."""
        out = self._dispatch_decode(
            tokens, lengths, (active_mask, temps, topks, topps), tables, window,
            K, mode, None if pres is None else (pres, freq, counts),
        )
        return self._fetch_chunk(out[0], K)

    @torch.no_grad()
    def _dispatch_decode(self, tokens, lengths, sampler: tuple, tables, window,
                         K: int, mode: tuple, penalties: tuple | None = None):
        """Dispatch thread: launch one decode chunk and start its packed
        fetch; nothing here waits for the card. ``tokens``/``lengths`` are
        host arrays (a burst's first chunk, uploaded) or the previous
        chunk's device outputs. Returns (fetch handle, final tokens, final
        lengths), the last two on the device."""
        t0 = time.monotonic()
        self.profiler.on_decode_chunk()
        start = self._timing_event()
        if isinstance(tokens, np.ndarray):
            tokens, lengths = self._upload(tokens), self._upload(lengths)
        amask, temps_t, topks_t, topps_t = self._sampler_device(*sampler)
        pres_t = freq_t = extras = None
        if penalties is not None:
            pres_t, freq_t, counts_t = (self._upload(a) for a in penalties)
            extras = (None, None, counts_t)
        sample_fn = self._sample_fn(temps_t, topks_t, topps_t, mode, pres_t, freq_t)
        mc = self.model_config
        if self.block_mgr is not None:
            out = llama_decode_chunk_paged(
                mc, self.params, tokens, lengths, amask, self.cache_k, self.cache_v,
                self._tables_device(tables), sample_fn, K, num_read_blocks=window,
                sample_extras=extras, return_packed=True, ffn=self._ffn,
            )
        else:
            out = llama_decode_chunk_dense_pallas(
                mc, self.params, tokens, lengths, amask, self.cache_k, self.cache_v,
                sample_fn, K, window, sample_extras=extras, return_packed=True,
                ffn=self._ffn,
            )
        self._decode_dispatches += 1
        self._decode_steps += K
        handle = self._start_fetch(out[0], start)
        self._decode_launch_s += time.monotonic() - t0
        return handle, out[1], out[2]

    def _start_fetch(self, packed: torch.Tensor, start=None) -> tuple:
        """Begin the chunk's one device-to-host copy without blocking: into
        one of the two pinned buffers (at most two chunks are in flight),
        with a CUDA event behind it (``start``: the event before the
        chunk's first launch). On the CPU the tensor is the result."""
        if packed.device.type != "cuda":
            return packed, None, None
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
        return view, self._timing_event(), start

    @staticmethod
    def _chunk_ready(handle: tuple) -> bool:
        """Non-blocking probe: the chunk's copy has landed (always on the
        CPU, where the dispatch computed it)."""
        return handle[1] is None or handle[1].query()

    def _fetch_chunk(self, handle: tuple, K: int):
        """The chunk's ONE device-to-host copy: wait for its event, split
        the packed int32 into tokens (K, B) and logprobs (K, B); then the
        seconds blocked on the card and the chunk's span on the card (None
        on the CPU)."""
        view, event, start = handle
        t0 = time.monotonic()
        if event is not None:
            event.synchronize()
        flat = view.numpy().copy()  # the pinned buffer serves a later chunk
        wait_s = time.monotonic() - t0
        self._decode_fetches += 1
        B = self.config.slots
        n = K * B
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
        if uplift >= 1.0:
            return False
        self._spec_auto_disabled = True
        self._spec_plain_since_disable = 0
        self._spec_flips += 1
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
                        self._topks.copy(), self._topps.copy()),
            )
            emitted, adv, nxt, _, n_real, logprobs = fetched
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
        )

    @torch.no_grad()
    def _run_spec_step(self, ctx_rows, ctx_vals, current, lengths, active_mask,
                       tables, nrb, mode, temps, topks, topps):
        """Dispatch thread: patch the stale context rows, one
        ``llama_spec_step_paged``, one packed fetch. Returns the fetched
        parts, the seconds the fetch waited and the step's span on the card
        (None on the CPU)."""
        S = self.model_config.max_seq_len
        up = self._upload
        start = self._timing_event()
        if self._ctx_dev is None:
            self._ctx_dev = torch.zeros((self.config.slots, S + 1), dtype=torch.int32,
                                        device=self.device)
        if ctx_rows is not None:
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
            sampler_mode=mode, ffn=self._ffn,
        )
        self._spec_dispatches += 1
        end = self._timing_event()
        parts, wait_s = self._fetch_spec(packed, self.config.speculative_drafts + 1)
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
            else:
                interval = now - (request.stream_last_emit or now)
                request.stream_tbt.add(interval)
                digest = self._stream_tbt_by_class.get(request.priority)
                if digest is None:
                    digest = self._stream_tbt_by_class[request.priority] = TbtDigest()
                digest.add(interval)
                threshold = self._stream_stall_threshold(request.priority)
                if interval > threshold:
                    request.stream_stalls += 1
                    self.stream_stalls_total += 1
                    self.flight.event("stream-stall", interval_s=round(interval, 6),
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
                    "stream-emit", emits=request.stream_emits,
                    tokens=len(request.generated), tbt_p50_s=summary["p50"],
                    tbt_p99_s=summary["p99"], tbt_max_s=summary["max"],
                    stalls=request.stream_stalls, priority=request.priority,
                )
        result = request.on_chunk(new_ids, delta, is_final)
        if asyncio.iscoroutine(result):
            await result

    async def _flush_emits(self) -> None:
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
        finished, self._finished_requests = self._finished_requests, []
        for request, is_eos in finished:
            # the tenant's tokens/s post-debit; a cancelled request's tokens
            # burned capacity too
            self.scheduler.on_finished(request)
            if request.future.done():
                # cancelled by the caller: not a served request (its slot
                # and the stream-cancel count went with _release_slot)
                if request.stream_cancel_counted:
                    self.flight.event(
                        "stream-cancel", tokens_generated=len(request.generated),
                        tokens_delivered=request.stream_sent_tokens,
                        tokens_wasted=len(request.generated) - request.stream_sent_tokens,
                        emits=request.stream_emits, priority=request.priority,
                        tenant=request.tenant, slot_reclaimed=True,
                    )
                continue
            self.completed_requests += 1
            done_t = time.monotonic()
            first = request.first_token_time or done_t
            admit = request.admit_time or first
            if request.deadline is not None:
                # a completion past its budget still answers; the overrun is
                # recorded
                overrun = time.time() - request.deadline
                if overrun > 0:
                    self.flight.event("deadline-overrun", overrun_s=round(overrun, 6),
                                      tokens=len(request.generated), tenant=request.tenant)
            timing = {
                "queue_wait": admit - request.enqueue_time,
                "prefill": first - admit,
                "ttft": first - request.enqueue_time,
                "decode": done_t - first,
                "tokens": float(len(request.generated)),
            }
            if request.stream_tbt is not None and request.stream_tbt.count:
                summary = request.stream_tbt.summary()
                timing["tbt_p50"] = summary["p50"]
                timing["tbt_p99"] = summary["p99"]
                timing["tbt_max"] = summary["max"]
                timing["tbt_count"] = float(summary["count"])
            if not request.warmup:
                self.request_timings.append(timing)
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
            request.future.set_result({
                "tokens": request.generated,
                "text": self._final_text(request),
                "logprobs": request.logprobs,
                "num_prompt_tokens": len(request.prompt_tokens),
                "num_completion_tokens": len(request.generated),
                "ttft": timing["ttft"],
                "queue_wait": timing["queue_wait"],
                "prefill": timing["prefill"],
                "finish_reason": (
                    "stop" if is_eos or request.stop_matched else "length"
                ),
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
