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
- Decode runs in bursts of chunks over the active slots, the JAX engine's
  sequential loop: ``decode-chunk-light`` fused steps per chunk while at
  most :meth:`TorchServingEngine._light_threshold` slots are active (the
  TTFT regime), ``decode-chunk`` above it, halved while every request
  needs fewer; a burst keeps its K until a slot finishes or queued work
  can land in a free slot. The KV cache — dense
  ``(L, slots, S, Kh, D)`` read through identity block tables, or the paged
  pool — is read-only inside a chunk; one commit writes the chunk's rows.
- Each chunk ends with exactly ONE device-to-host copy: the tokens and
  their logprobs packed into one int32 tensor on the device
  (``stats()["decode-chunks"]["host_fetches_per_chunk"] == 1.0``).
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
- Submit-time refusals, as in the JAX engine: a request naming an
  ``adapter`` (no adapter store here) raises ``ValueError``; one whose
  ``deadline``/``deadline-s`` budget is spent raises
  :class:`~langstream_tpu_torch.serving.deadline.DeadlineExceeded`; both
  before the request queues.

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
from langstream_tpu_torch.models.checkpoints import load_llama_checkpoint
from langstream_tpu_torch.models.llama import (
    LlamaConfig,
    init_llama_params,
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
from langstream_tpu_torch.models.paged import (
    BlockManager,
    PagedLayout,
    init_paged_kv_cache,
    init_paged_kv_cache_int8,
)
from langstream_tpu_torch.models.quant import (
    QTensor,
    init_llama_params_q8,
    quantize_llama_params,
)
from langstream_tpu_torch.models.tokenizer import Tokenizer, load_tokenizer
from langstream_tpu_torch.ops.flash_attention import flash_attention
from langstream_tpu_torch.ops.paged_attention import (
    _paged_attention_partial_q8,
    paged_attention_multiquery_partial,
    paged_attention_partial,
)
from langstream_tpu_torch.serving.deadline import (
    DeadlineExceeded,
    deadline_from_options,
    remaining_s,
)
from langstream_tpu_torch.serving.sampler import K_MAX, sample_tokens

log = logging.getLogger(__name__)

_MODEL_CONFIGS = {
    "tiny": LlamaConfig.tiny,
    "llama-1b": LlamaConfig.llama_1b,
    "llama3-8b": LlamaConfig.llama3_8b,
    "llama-3-8b": LlamaConfig.llama3_8b,
    "llama3-70b": LlamaConfig.llama3_70b,
    "llama-3-70b": LlamaConfig.llama3_70b,
}
_MOE_MODELS = ("moe-tiny", "moe-8x7b", "mixtral-8x7b")
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
    keys and defaults as the JAX package's ``ServingConfig``. Sections of
    planes this port does not carry yet (qos, slo, prefix-store,
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
    qos: Any = None
    pipeline: bool = True
    wedge_window_s: float = 60.0
    slo: Any = None
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
            qos=d.get("qos"),
            pool_role=str(get("pool-role", os.environ.get("LS_POOL_ROLE") or "combined")),
            pipeline=_parse_bool(d.get("pipeline", True)),
            wedge_window_s=float(get("wedge-window-s", 60.0)),
            slo=d.get("slo"),
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
    (lambda c: bool(c.mesh), "mesh: multi-GPU serving is ROADMAP.md Queue 1 item 13"),
    (lambda c: c.kv_quantize == "int8" and c.kv_layout == "dense",
     "kv-quantize: int8 with kv-layout: dense: the port serves int8 KV from "
     "the paged pool only (ROADMAP.md Queue 1 item 3); use kv-layout: paged"),
    (lambda c: c.adapter_store is not None,
     "adapter-store: multi-LoRA is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.prefix_store is not None,
     "prefix-store: the tiered prefix store is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.qos is not None, "qos: scheduling/QoS is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.slo is not None, "slo: the health/SLO plane is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.streaming, "streaming: the streaming/TBT plane is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.pool_role != "combined",
     "pool-role other than combined: KV handoff is ROADMAP.md Queue 1 item 10"),
    (lambda c: bool(c.faults), "faults: fault injection is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.journal_dir is not None,
     "journal-dir: the crash-requeue journal is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.incident_dir is not None,
     "incident-dir: incident capture is ROADMAP.md Queue 1 item 9"),
    (lambda c: c.model in _MOE_MODELS and bool(c.checkpoint),
     "checkpoint: MoE checkpoints (load_moe_checkpoint) are ROADMAP.md Queue 1 "
     "item 12"),
    (lambda c: c.model in _MOE_MODELS, "MoE models are ROADMAP.md Queue 1 item 12"),
)

#: accepted settings that change only latency here; logged once when set
_LATENCY_ONLY = (
    "pipeline", "paged_kernel", "dense_kernel", "wedge_window_s",
    "stream_stall_s", "shrink_fraction", "shrink_recovery_s",
)

#: request options the agents forward whose plane this port lacks: accepted,
#: logged once per engine, not acted on
_UNACTED_OPTIONS = {
    "stream-key": "client-disconnect cancellation is the streaming plane, "
                  "ROADMAP.md Queue 1 item 9",
    "qos-tenant": "tenant scheduling is the QoS plane, ROADMAP.md Queue 1 item 9",
    "priority": "priority classes are the QoS plane, ROADMAP.md Queue 1 item 9",
    "deadline": "only spent budgets are refused; the admission-estimate shed "
                "is the scheduler plane, ROADMAP.md Queue 1 item 9",
    "deadline-s": "only spent budgets are refused; the admission-estimate shed "
                  "is the scheduler plane, ROADMAP.md Queue 1 item 9",
}


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
    if config.model not in _MODEL_CONFIGS:
        raise ValueError(
            f"unknown model {config.model!r}; known: {sorted(_MODEL_CONFIGS)}"
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
    stream_sent_tokens: int = 0
    stream_sent_chars: int = 0


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


class TorchServingEngine:
    """The serving engine of the port. ``params=None`` means the weights of
    ``config.checkpoint`` when set (an HF-format Llama directory, see
    :func:`~langstream_tpu_torch.models.checkpoints.load_llama_checkpoint`),
    else random init from ``config.seed`` (``init_llama_params_q8`` for
    ``quantize: int8``, else ``init_llama_params``); otherwise ``params`` is
    a port parameter tree (see
    :func:`langstream_tpu_torch.models.convert.params_from_numpy`). Trees
    not yet int8 are quantized here when the config asks for int8.

    :meth:`get_or_create` shares one engine per ``(config, device)`` in the
    process, as the JAX engine does per config: every agent of an
    application that names the same resource reaches the same engine."""

    _instances: dict[tuple, "TorchServingEngine"] = {}
    _instances_lock = threading.Lock()

    @classmethod
    def get_or_create(cls, config: ServingConfig, device="cuda") -> "TorchServingEngine":
        """The process's engine for ``(config, device)``, made on first
        use. An engine that was closed, or whose event loop has closed (a
        finished ``asyncio.run``), is replaced: its loop task and events
        cannot serve another loop."""
        _check_supported(config)  # before hashing: rejected keys hold dicts
        key = (config, str(torch.device(device)))
        with cls._instances_lock:
            engine = cls._instances.get(key)
            if engine is None or engine._stale():
                if engine is not None:
                    engine._executor.shutdown(wait=False)
                engine = cls._instances[key] = cls(config, device=device)
            return engine

    @classmethod
    def reset_instances(cls) -> None:
        """Forget every shared engine (the caller closes them)."""
        with cls._instances_lock:
            cls._instances.clear()

    def __init__(self, config: ServingConfig, *, device="cuda",
                 params: dict | None = None):
        _check_supported(config)
        self.device = require_device(device, "TorchServingEngine")
        self.config = config
        mc = _MODEL_CONFIGS[config.model](max_seq_len=config.max_seq_len)
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
        self._queue: deque[_Request] = deque()
        self._wake = asyncio.Event()
        self._stop = False
        self._loop_task: asyncio.Task | None = None
        # the event loop of the first request: the engine's task, event and
        # warmup belong to it (get_or_create replaces the engine once it
        # has closed)
        self._event_loop: asyncio.AbstractEventLoop | None = None
        self._warmup_task: asyncio.Task | None = None
        self._warmup_result: dict | None = None
        self._unacted_logged: set[str] = set()
        self.deadline_sheds = 0
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

    # ------------------------------------------------------------------
    # model + cache
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _init_model(self, params: dict | None) -> None:
        mc, dev = self.model_config, self.device
        int8 = self.config.quantize == "int8"
        if params is None and self.config.checkpoint:
            # loaded on the CPU in the model dtype, then moved and (int8)
            # quantized: the JAX engine's order, so the bf16 rounding
            # happens before the quantizer as there
            params = load_llama_checkpoint(self.config.checkpoint, mc)
        if params is None:
            log.warning(
                "no checkpoint configured for model %r: using random-init "
                "weights (offline/dev mode)", self.config.model,
            )
            init = init_llama_params_q8 if int8 else init_llama_params
            params = init(mc, self._generator, device=dev)
        else:
            params = _to_device(params, dev)
            if int8 and not isinstance(params["layers"]["wq"], QTensor):
                params = quantize_llama_params(params)
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

        Refused before the request queues: ``adapter`` (``ValueError``: no
        adapter store in this port) and a spent ``deadline``/``deadline-s``
        budget (:class:`DeadlineExceeded`). ``_warmup_probe`` is internal:
        warmup's own requests skip the warmup gate (they are the warmup)."""
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
        self._log_unacted(options)
        deadline = deadline_from_options(options)
        if deadline is not None and not _warmup_probe:
            left = remaining_s(deadline)
            if left <= 0.0:
                # an unmeetable budget is refused before it queues: never
                # a silent late completion
                self.deadline_sheds += 1
                raise DeadlineExceeded(
                    f"deadline exceeded at submit: {left:.3f}s of budget "
                    f"left, admission estimate 0.000s",
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
        )
        self._queue.append(request)
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
            "queued": len(self._queue),
            "total-generated": self.total_generated,
            "completed": self.completed_requests,
            # prefill dispatches, and those of them through the
            # continuation path (prefix-cache hits and prefill chunks)
            "prefill-calls": self._prefill_calls,
            "prefill-continue-calls": self._continue_calls,
            "prefix": {
                "hits": self.prefix_hits, "tokens_reused": self.prefix_tokens,
            },
            "decode-chunks": {
                "dispatched": self._decode_dispatches,
                "fetched": self._decode_fetches,
                # the one-fetch invariant: above 1.0 means the decode tail
                # crosses the host boundary more than once per chunk
                "host_fetches_per_chunk": (
                    round(self._decode_fetches / self._decode_dispatches, 4)
                    if self._decode_dispatches else 0.0
                ),
                # fused steps and host-clock seconds from dispatch to the
                # end of the fetch (the fetch waits for the device)
                "steps": self._decode_steps,
                "seconds": self._decode_s,
            },
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

    def _log_unacted(self, options: dict) -> None:
        for key, why in _UNACTED_OPTIONS.items():
            if key not in self._unacted_logged and options.get(key) not in (None, ""):
                self._unacted_logged.add(key)
                log.info("request option %r accepted, not acted on by this "
                         "engine: %s", key, why)

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
        self._warmup_result = {"probe_tokens": k, "wave": wave,
                               "seconds": time.monotonic() - t0}
        return self._warmup_result

    async def close(self) -> None:
        self._stop = True
        self._wake.set()
        if self._warmup_task is not None and not self._warmup_task.done():
            self._warmup_task.cancel()
        if self._loop_task is not None and not self._loop_task.done():
            await self._loop_task
        self._executor.shutdown(wait=True)
        closed = RuntimeError("serving engine closed")
        for request in list(self._queue):
            if not request.future.done():
                request.future.set_exception(closed)
        self._queue.clear()

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    async def _run_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._stop:
            try:
                if self._queue:
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
                    if not self._queue and not self._has_prefilling():
                        self._wake.clear()
                        try:
                            await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                        except asyncio.TimeoutError:
                            pass
                    continue
                if self._speculating(active):
                    await self._speculative_burst(loop, active)
                else:
                    await self._decode_burst(loop, active)
            except Exception as e:  # device/runtime error: fail in-flight work,
                # free the slots, keep serving (callers see the exception)
                log.exception("serving engine step failed")
                self._fail_inflight(e)

    def _has_prefilling(self) -> bool:
        return any(s.prefilling for s in self.slots)

    def _fail_inflight(self, error: Exception) -> None:
        for slot_id, slot in enumerate(self.slots):
            request = slot.request
            if request is None:
                continue
            self._release_slot(slot_id)
            if not request.future.done():
                request.future.set_exception(error)
        self._pending_emits.clear()
        self._finished_requests.clear()

    def _release_slot(self, slot_id: int) -> None:
        slot = self.slots[slot_id]
        slot.request = None
        slot.prefilling = False
        slot.prefill_done = 0
        self._lengths[slot_id] = 0
        self._ctx_synced[slot_id] = 0
        if self.block_mgr is not None:
            self.block_mgr.release(slot_id)

    # ------------------------------------------------------------------
    # admission + prefill
    # ------------------------------------------------------------------

    async def _admit(self, loop) -> None:
        """Admit queued requests FIFO in batched prefill calls (one batch per
        length bucket of the tokens to prefill, up to ``prefill-batch``
        rows).

        With the paged prefix cache on, each request first matches its
        prompt against cached block chains; a matched request adopts the
        shared blocks and prefills only its SUFFIX, and a batch with any
        such row goes through the continuation path. With ``prefill-chunk``
        a request with more tokens to prefill than the chunk claims its
        slot and reservation here and prefills in :meth:`_advance_prefills`.
        """
        S = self.model_config.max_seq_len
        cfg = self.config
        use_prefix = self.block_mgr is not None and cfg.prefix_cache
        while self._queue:
            free = [i for i, s in enumerate(self.slots) if s.free]
            if not free:
                return
            batch: list[tuple[int, _Request, int]] = []  # (slot, request, reuse)
            bucket = None
            while self._queue and len(batch) < min(len(free), cfg.prefill_batch):
                request = self._queue[0]
                if request.future.cancelled():
                    self._queue.popleft()  # caller gave up while queued
                    continue
                prompt = request.prompt_tokens
                total = len(prompt) + request.max_tokens + 1
                if self.block_mgr is not None and not self.block_mgr.can_admit(total):
                    break  # paged backpressure: finishing slots free reservations
                blocks, reuse = [], 0
                if use_prefix:
                    blocks, reuse = self.block_mgr.match_prefix(prompt)
                    if reuse and len(prompt) - reuse > cfg.prefix_cache_max_suffix:
                        blocks, reuse = [], 0  # long suffix, small saving
                to_prefill = len(prompt) - reuse
                if cfg.prefill_chunk > 0 and to_prefill > cfg.prefill_chunk:
                    # chunked prefill: claim the slot and its reservation
                    # now, feed the prompt one chunk per loop pass
                    slot_id = free.pop(len(batch))
                    self._queue.popleft()
                    self.block_mgr.admit(slot_id, total)
                    if blocks:
                        self.block_mgr.adopt_prefix(slot_id, blocks)
                    slot = self.slots[slot_id]
                    slot.request = request
                    slot.prefilling = True
                    slot.prefill_done = reuse
                    self.block_mgr.ensure_capacity(slot_id, len(prompt))
                    request.admit_time = time.monotonic()
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
                self._queue.popleft()
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
                if self.block_mgr is not None:
                    self.block_mgr.ensure_capacity(slot_id, len(request.prompt_tokens))
            B = len(batch)
            padded = np.zeros((B, bucket), dtype=np.int64)
            lengths = np.zeros(B, dtype=np.int32)
            starts = np.zeros(B, dtype=np.int32)
            slot_ids = np.zeros(B, dtype=np.int64)
            temps = np.zeros(B, dtype=np.float32)
            topks = np.zeros(B, dtype=np.int32)
            topps = np.ones(B, dtype=np.float32)
            for i, (slot_id, request, reuse) in enumerate(batch):
                suffix = request.prompt_tokens[reuse:]
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
            next_np, logprob_np = await loop.run_in_executor(
                self._executor,
                partial(self._run_prefill, padded, lengths, slot_ids, tables,
                        temps, topks, topps, mode, cont),
            )
            if use_prefix:
                for slot_id, request, reuse in batch:
                    self.block_mgr.register_prefix(slot_id, request.prompt_tokens)
                    if reuse:
                        self.prefix_hits += 1
                        self.prefix_tokens += reuse
            now = time.monotonic()
            for i, (slot_id, request, _) in enumerate(batch):
                self._start_decoding(slot_id, request, int(next_np[i]), now)
                self._emit_token(slot_id, int(next_np[i]), float(logprob_np[i]))
            await self._flush_emits()

    def _start_decoding(self, slot_id: int, request: "_Request", token: int,
                        now: float) -> None:
        """The slot's prompt is in the cache and ``token`` is its first
        generated token: set the slot's decode state."""
        self._lengths[slot_id] = len(request.prompt_tokens)
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
        tokens = np.zeros((B, C), dtype=np.int64)
        starts = np.zeros(B, dtype=np.int32)
        suffix_lens = np.zeros(B, dtype=np.int32)
        temps = np.zeros(B, dtype=np.float32)
        topks = np.zeros(B, dtype=np.int32)
        topps = np.ones(B, dtype=np.float32)
        for i, slot_id in enumerate(pre):
            slot = self.slots[slot_id]
            request = slot.request
            chunk = request.prompt_tokens[slot.prefill_done: slot.prefill_done + C]
            tokens[i, : len(chunk)] = chunk
            starts[i] = slot.prefill_done
            suffix_lens[i] = len(chunk)
            temps[i] = request.temperature
            topks[i] = request.top_k
            topps[i] = request.top_p
        slot_ids = np.asarray(pre, dtype=np.int64)
        cont = (starts, self._read_blocks_for(max(int(starts.max()), 1)))
        mode = self._sampler_mode(temps, topks, topps)
        next_np, logprob_np = await loop.run_in_executor(
            self._executor,
            partial(self._run_prefill, tokens, suffix_lens, slot_ids,
                    self.block_mgr.tables[slot_ids].copy(), temps, topks,
                    topps, mode, cont),
        )
        now = time.monotonic()
        for i, slot_id in enumerate(pre):
            slot = self.slots[slot_id]
            request = slot.request
            slot.prefill_done += int(suffix_lens[i])
            if slot.prefill_done < len(request.prompt_tokens):
                continue
            slot.prefilling = False
            self._start_decoding(slot_id, request, int(next_np[i]), now)
            # register BEFORE emitting: a max-tokens=1 or instant-EOS
            # request is released inside _emit_token, and registering
            # against a released slot's empty table publishes nothing
            if self.config.prefix_cache:
                self.block_mgr.register_prefix(slot_id, request.prompt_tokens)
            self._emit_token(slot_id, int(next_np[i]), float(logprob_np[i]))
        await self._flush_emits()

    def _device_sampler(self, temps, topks, topps, mode, pres=None, freq=None):
        """A ``sample_fn`` closure over device copies of the rows' settings."""
        dev = self.device
        use_top_p, use_top_k, all_greedy = mode
        temps_t = torch.from_numpy(temps).to(dev)
        topks_t = torch.from_numpy(topks).to(dev)
        topps_t = torch.from_numpy(topps).to(dev)
        pen = pres is not None
        pres_t = torch.from_numpy(pres).to(dev) if pen else None
        freq_t = torch.from_numpy(freq).to(dev) if pen else None

        def sample_fn(logits, counts=None):
            return sample_tokens(
                logits, self._generator, temps_t, topks_t,
                use_top_p=use_top_p, top_ps=topps_t, use_top_k=use_top_k,
                all_greedy=all_greedy, use_penalties=pen, presences=pres_t,
                frequencies=freq_t, counts=counts,
            )

        return sample_fn

    @torch.no_grad()
    def _run_prefill(self, padded, lengths, slot_ids, tables, temps, topks,
                     topps, mode, cont=None):
        """Dispatch thread: one batched prefill + first-token sample; one
        packed device-to-host copy. ``cont = (starts, num_read_blocks)``
        sends the batch through the continuation path (``padded`` then
        holds each row's suffix). Returns (tokens, logprobs) numpy."""
        dev, mc = self.device, self.model_config
        tokens = torch.from_numpy(padded).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        if cont is not None:
            starts, nrb = cont
            logits, _, _ = llama_prefill_continue_paged(
                mc, self.params, tokens, torch.from_numpy(starts).to(dev),
                lengths_t, self.cache_k, self.cache_v,
                torch.from_numpy(tables).to(dev), num_read_blocks=nrb,
            )
            self._continue_calls += 1
        elif self.block_mgr is not None:
            logits, _, _ = llama_prefill_paged(
                mc, self.params, tokens, lengths_t, self.cache_k, self.cache_v,
                torch.from_numpy(tables).to(dev),
            )
        else:
            logits, ks, vs = prefill_forward(mc, self.params, tokens, lengths_t)
            sel = torch.from_numpy(slot_ids).to(dev)
            Pn = tokens.shape[1]
            self.cache_k[:, sel, :Pn] = ks
            self.cache_v[:, sel, :Pn] = vs
        nxt, lps = self._device_sampler(temps, topks, topps, mode)(logits)
        self._prefill_calls += 1
        packed = pack_tokens_logprobs(nxt, lps).cpu().numpy()
        B = len(lengths)
        return packed[:B], packed[B:].view(np.float32)

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

    def _burst_steps(self, active: list[int]) -> int:
        """K of a burst over ``active``, the JAX engine's rule: the light or
        the full chunk, halved while it is at least twice the longest
        remaining budget (and twice the light chunk)."""
        cfg = self.config
        light = len(active) <= self._light_threshold()
        K = cfg.decode_chunk_light if light else cfg.decode_chunk
        max_remaining = 1
        for slot_id in active:
            request = self.slots[slot_id].request
            max_remaining = max(max_remaining, request.max_tokens - len(request.generated))
        while K >= 2 * max(max_remaining, cfg.decode_chunk_light, 1):
            K //= 2
        return K

    def _burst_should_yield(self, finished: bool) -> bool:
        """A burst ends when the loop can make progress elsewhere: a slot
        finished, a prefill is mid-flight, the engine stops, or queued work
        can land in a free slot (a queue with every slot busy keeps the
        burst going)."""
        if self._stop or self._has_prefilling() or finished:
            return True
        if not self._queue:
            return False
        return any(s.free for s in self.slots)

    async def _decode_burst(self, loop, active: list[int]) -> None:
        """Decode chunks of one K over a fixed set of active slots, one at a
        time, until :meth:`_burst_should_yield` (the JAX engine's
        sequential loop: its light-load, penalty and ``pipeline: false``
        posture)."""
        K = self._burst_steps(active)
        while not self._burst_should_yield(await self._decode_chunk(loop, active, K)):
            pass

    async def _decode_chunk(self, loop, active: list[int], K: int) -> bool:
        """One chunk of ``K`` fused decode steps over the active slots, one
        packed fetch, then per-token host processing; True when a slot
        finished."""
        cfg = self.config
        active_mask = np.zeros(cfg.slots, dtype=bool)
        active_mask[active] = True
        mode = self._sampler_mode(
            self._temps[active_mask], self._topks[active_mask],
            self._topps[active_mask],
        )
        pen = bool(
            (self._pres[active_mask] != 0).any() or (self._freq[active_mask] != 0).any()
        )
        counts = None
        if pen:
            counts = np.zeros((cfg.slots, self.model_config.vocab_size), dtype=np.int32)
            for slot_id in active:
                for t in self.slots[slot_id].request.generated:
                    counts[slot_id, t] += 1
        base_max = int(self._lengths[active].max())
        tables = None
        if self.block_mgr is not None:
            S = self.model_config.max_seq_len
            for slot_id in active:
                request = self.slots[slot_id].request
                cap = len(request.prompt_tokens) + request.max_tokens + 1
                need = min(int(self._lengths[slot_id]) + K, cap, S)
                self.block_mgr.ensure_capacity(slot_id, need)
            tables = self.block_mgr.tables.copy()
            window = self._read_blocks_for(base_max)
        else:
            window = self._window_for(base_max)
        packed = await loop.run_in_executor(
            self._executor,
            partial(
                self._run_decode, self._current.copy(), self._lengths.copy(),
                active_mask, tables, window, K, mode, self._temps.copy(),
                self._topks.copy(), self._topps.copy(),
                self._pres.copy() if pen else None,
                self._freq.copy() if pen else None, counts,
            ),
        )
        n = K * cfg.slots
        chunk_t = packed[:n].reshape(K, cfg.slots)
        chunk_lp = packed[n:].view(np.float32).reshape(K, cfg.slots)
        finished = self._process_chunk(chunk_t, chunk_lp, active)
        await self._flush_emits()
        if cfg.speculative_drafts > 0 and self._spec_auto_disabled:
            self._spec_count_plain_chunk()
        return finished

    @torch.no_grad()
    def _run_decode(self, tokens, lengths, active_mask, tables, window, K, mode,
                    temps, topks, topps, pres, freq, counts):
        """Dispatch thread: one decode chunk; returns the packed host copy."""
        dev, mc = self.device, self.model_config
        t0 = time.monotonic()
        sample_fn = self._device_sampler(temps, topks, topps, mode, pres, freq)
        extras = None
        if counts is not None:
            extras = (None, None, torch.from_numpy(counts).to(dev))
        args = (
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.from_numpy(active_mask).to(dev),
        )
        if self.block_mgr is not None:
            out = llama_decode_chunk_paged(
                mc, self.params, *args, self.cache_k, self.cache_v,
                torch.from_numpy(tables).to(dev), sample_fn, K,
                num_read_blocks=window, sample_extras=extras,
                return_packed=True,
            )
        else:
            out = llama_decode_chunk_dense_pallas(
                mc, self.params, *args, self.cache_k, self.cache_v,
                sample_fn, K, window, sample_extras=extras, return_packed=True,
            )
        self._decode_dispatches += 1
        packed = out[0].cpu().numpy()  # the chunk's one device-to-host copy
        self._decode_fetches += 1
        self._decode_steps += K
        self._decode_s += time.monotonic() - t0
        return packed

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

    def _fetch_spec(self, packed: torch.Tensor, d1: int) -> tuple[np.ndarray, ...]:
        """The step's ONE device-to-host copy, split into emitted tokens,
        advance counts, next tokens, new lengths, real-draft counts and
        logprobs."""
        B = self.config.slots
        nE = B * d1
        flat = packed.cpu().numpy()
        self._spec_fetches += 1
        return (
            flat[:nE].reshape(B, d1),
            flat[nE:nE + B],
            flat[nE + B:nE + 2 * B],
            flat[nE + 2 * B:nE + 3 * B],
            flat[nE + 3 * B:nE + 4 * B],
            flat[nE + 4 * B:].view(np.float32).reshape(B, d1),
        )

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
            t_wall = time.monotonic()
            emitted, adv, nxt, _, n_real, logprobs = await loop.run_in_executor(
                self._executor,
                partial(self._run_spec_step, ctx_rows, ctx_vals, self._current.copy(),
                        self._lengths.copy(), active_mask,
                        self.block_mgr.tables.copy(), nrb, mode, self._temps.copy(),
                        self._topks.copy(), self._topps.copy()),
            )
            self.spec_steps += 1
            self._spec_steps_since_cal += 1
            emitted_before = self.total_generated
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
            disabled = self._spec_check_uplift()
            await self._flush_emits()
            if disabled or self._should_yield(live):
                return

    def _should_yield(self, live: list[int]) -> bool:
        """A burst hands back to the loop when a slot finished or other work
        waits: queued requests, mid-prefill slots, a stop."""
        return (
            any(self.slots[i].request is None for i in live)
            or bool(self._queue) or self._stop or self._has_prefilling()
        )

    @torch.no_grad()
    def _run_spec_step(self, ctx_rows, ctx_vals, current, lengths, active_mask,
                       tables, nrb, mode, temps, topks, topps):
        """Dispatch thread: patch the stale context rows, one
        ``llama_spec_step_paged``, one packed fetch."""
        dev = self.device
        S = self.model_config.max_seq_len
        if self._ctx_dev is None:
            self._ctx_dev = torch.zeros((self.config.slots, S + 1), dtype=torch.int32,
                                        device=dev)
        if ctx_rows is not None:
            self._ctx_dev[torch.from_numpy(ctx_rows).to(dev), :S] = (
                torch.from_numpy(ctx_vals).to(dev))
        greedy = mode[2]
        packed, self._ctx_dev, self.cache_k, self.cache_v = llama_spec_step_paged(
            self.model_config, self.params, self._ctx_dev,
            torch.from_numpy(current).to(dev), torch.from_numpy(lengths).to(dev),
            torch.from_numpy(active_mask).to(dev), self.cache_k, self.cache_v,
            torch.from_numpy(tables).to(dev),
            num_drafts=self.config.speculative_drafts, num_read_blocks=nrb,
            generator=self._generator,
            temps=None if greedy else torch.from_numpy(temps).to(dev),
            topks=None if greedy else torch.from_numpy(topks).to(dev),
            topps=None if greedy else torch.from_numpy(topps).to(dev),
            sampler_mode=mode,
        )
        self._spec_dispatches += 1
        return self._fetch_spec(packed, self.config.speculative_drafts + 1)

    # ------------------------------------------------------------------
    # host-side token handling
    # ------------------------------------------------------------------

    def _process_chunk(self, chunk_tokens, chunk_lps, active: list[int]) -> bool:
        """Apply a chunk's tokens; True when a slot finished."""
        K = chunk_tokens.shape[0]
        finished = False
        for slot_id in active:
            for k in range(K):
                if self.slots[slot_id].request is None:
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

    async def _flush_emits(self) -> None:
        emits, self._pending_emits = self._pending_emits, []
        chunks: "OrderedDict[int, list]" = OrderedDict()
        for request, token, logprob, done in emits:
            if request.on_token is not None:
                result = request.on_token(token, logprob, done)
                if asyncio.iscoroutine(result):
                    await result
            if request.on_chunk is not None:
                entry = chunks.setdefault(id(request), [request, False])
                entry[1] = entry[1] or done
        for request, done in chunks.values():
            text = self._stream_text(request, done)
            new_tokens = request.generated[request.stream_sent_tokens:]
            new_text = text[request.stream_sent_chars:]
            request.stream_sent_tokens = len(request.generated)
            request.stream_sent_chars = max(request.stream_sent_chars, len(text))
            result = request.on_chunk(new_tokens, new_text, done)
            if asyncio.iscoroutine(result):
                await result
        finished, self._finished_requests = self._finished_requests, []
        now = time.monotonic()
        for request, is_eos in finished:
            if request.future.done():
                continue  # cancelled by the caller
            self.completed_requests += 1
            first = request.first_token_time or now
            admit = request.admit_time or first
            request.future.set_result({
                "tokens": request.generated,
                "text": self._final_text(request),
                "logprobs": request.logprobs,
                "num_prompt_tokens": len(request.prompt_tokens),
                "num_completion_tokens": len(request.generated),
                "ttft": first - request.enqueue_time,
                "queue_wait": admit - request.enqueue_time,
                "prefill": first - admit,
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
