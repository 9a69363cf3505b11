"""Profiling hooks and the decode roofline (port of
``langstream_tpu/serving/profiling.py``).

Activation (off by default, no cost when unset):

- ``LS_TPU_PROFILE_DIR=/path``: the engine captures a ``torch.profiler``
  trace (CPU and CUDA activity) of the first ``LS_TPU_PROFILE_CHUNKS``
  (default 4) decode chunks into ``/path`` as a Chrome trace
  (``trace-<n>.json``; open it in Perfetto or ``chrome://tracing``).
- :meth:`ProfilerHooks.start_trace` / :meth:`ProfilerHooks.stop_trace`
  drive the same capture programmatically.
- ``LS_TPU_HLO_DUMP_DIR`` is accepted for the JAX engine's sake, but an
  eager port compiles no program, so :meth:`ProfilerHooks.dump_hlo`
  logs once that there is nothing to dump.

Also here: the decode roofline. Decode is bound by memory bandwidth: each
step streams every weight byte plus the attention window of the KV cache.
:func:`decode_step_bytes` gives that floor, so a measurement can report its
share of the roofline beside a bare tok/s. The bandwidth table holds the
cards the port has been measured on (the H100 SXM's 3,350 GB/s from the
data sheet); elsewhere ``generation`` is ``None`` and the report says
which bandwidth it assumed.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Any

import torch

log = logging.getLogger(__name__)


class ProfilerHooks:
    """Trace capture state for one engine. ``start_trace``/``stop_trace``
    may run on the event loop while :meth:`on_decode_chunk` runs on the
    dispatch thread, so the state changes sit behind a lock; the profiler
    calls and file I/O run outside it (a reservation flag keeps two
    starts apart). A failing capture is logged, never raised into
    serving."""

    def __init__(self) -> None:
        self.profile_dir = os.environ.get("LS_TPU_PROFILE_DIR")
        self.auto_chunks = int(os.environ.get("LS_TPU_PROFILE_CHUNKS", "4"))
        self.hlo_dir = os.environ.get("LS_TPU_HLO_DUMP_DIR")
        self._state_lock = threading.Lock()
        self._tracing = False
        self._auto_remaining = self.auto_chunks if self.profile_dir else 0
        self._target: str | None = None
        self._profiler: Any = None
        self._traces = 0
        self._hlo_logged = False

    # -- trace capture --------------------------------------------------

    def start_trace(self, trace_dir: str | None = None) -> bool:
        """Begin a ``torch.profiler`` capture (idempotent). True if a
        capture started."""
        target = trace_dir or self.profile_dir
        if not target:
            return False
        with self._state_lock:
            if self._tracing:
                return False
            self._tracing = True  # reserve: concurrent callers back off
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(target, exist_ok=True)
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception as e:  # profiling must never break serving
            log.warning("profiler trace start failed: %s", e)
            with self._state_lock:
                self._tracing = False
                self._auto_remaining = 0
            return False
        self._profiler, self._target = prof, target
        log.info("torch profiler trace started -> %s", target)
        return True

    def stop_trace(self) -> bool:
        """End the capture and write ``<dir>/trace-<n>.json``."""
        with self._state_lock:
            if not self._tracing:
                return False
            self._tracing = False
        prof, self._profiler = self._profiler, None
        if prof is None:
            return False
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            self._traces += 1
            path = os.path.join(self._target, f"trace-{self._traces}.json")
            prof.export_chrome_trace(path)
        except Exception as e:
            log.warning("profiler trace stop failed: %s", e)
            return False
        log.info("torch profiler trace written: %s", path)
        return True

    def on_decode_chunk(self) -> None:
        """Called once per dispatched decode chunk: drives the env-var
        capture of the first N chunks."""
        with self._state_lock:
            if self._auto_remaining <= 0:
                return
            need_start = not self._tracing
        if need_start and not self.start_trace():
            return
        with self._state_lock:
            if self._auto_remaining <= 0:
                return
            self._auto_remaining -= 1
            should_stop = self._auto_remaining == 0
        if should_stop:
            self.stop_trace()

    # -- HLO dumps ------------------------------------------------------

    def dump_hlo(self, name: str, *args: Any, **kwargs: Any) -> None:
        """The JAX engine writes each compiled program's HLO here. An eager
        port has no compiled program: with ``LS_TPU_HLO_DUMP_DIR`` set this
        logs that once and writes nothing."""
        if self.hlo_dir and not self._hlo_logged:
            self._hlo_logged = True
            log.info("LS_TPU_HLO_DUMP_DIR is set, but the eager port compiles "
                     "no program: there is no HLO to dump (%s)", name)
        return None


# ---------------------------------------------------------------------------
# roofline model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodeRoofline:
    weight_bytes: int          # streamed once per step (all slots share it)
    cache_bytes_per_step: int  # KV window read across all slots
    total_bytes_per_step: int
    hbm_gbps: float            # assumed device bandwidth
    # the detected card, so a report says which roof it was measured
    # against; None off the known cards
    generation: str | None = None
    hbm_bytes: int | None = None    # device memory when known

    def min_step_ms(self) -> float:
        return self.total_bytes_per_step / (self.hbm_gbps * 1e9) * 1e3

    def utilization(self, achieved_step_ms: float) -> float:
        return self.min_step_ms() / max(achieved_step_ms, 1e-9)


# published memory bandwidth by card (GB/s, NVIDIA data sheets)
_HBM_GBPS = {"h100-sxm": 3350.0}
#: the bandwidth assumed where no card is detected (the CPU): the H100
#: SXM's, the card the port serves on
DEFAULT_HBM_GBPS = _HBM_GBPS["h100-sxm"]

# torch.cuda.get_device_name substrings -> generation key
_DEVICE_NAME_GEN = (("h100", "h100-sxm"),)


def detect_generation() -> str | None:
    """The card's key from ``torch.cuda.get_device_name``; None without a
    card or for a card not in the table."""
    if not torch.cuda.is_available():
        return None
    try:
        name = torch.cuda.get_device_name(0).lower()
    except Exception:  # no usable device: just unknown
        return None
    for pattern, key in _DEVICE_NAME_GEN:
        if pattern in name:
            return key
    return None


def detect_hbm_capacity() -> tuple[int | None, str]:
    """(device memory bytes, source): ``total_memory`` of card 0
    (``"device_properties"``), else ``(None, "unknown")``."""
    if torch.cuda.is_available():
        try:
            return (int(torch.cuda.get_device_properties(0).total_memory),
                    "device_properties")
        except Exception as e:
            log.debug("device properties unavailable: %s", e)
    return None, "unknown"


def detect_hbm_bytes() -> int | None:
    """Device memory of card 0 (see :func:`detect_hbm_capacity`)."""
    return detect_hbm_capacity()[0]


def detect_hbm_gbps(default: float = DEFAULT_HBM_GBPS) -> float:
    """Bandwidth of the detected card; ``default`` when none is detected."""
    return _HBM_GBPS.get(detect_generation(), default)


def decode_step_bytes(
    model_config: Any,
    slots: int,
    window: int,
    quantize: str | None = None,
    kv_dtype_bytes: int = 2,
    kv_quantize: str | None = None,
) -> DecodeRoofline:
    """Bytes that MUST cross device memory for one decode step of ``slots``
    slots with an attention window of ``window`` cache rows per slot: every
    parameter once (int8: 1 byte, scales negligible), and the K and V
    windows of every slot and layer (int8 rows carry a 4-byte scale)."""
    from langstream_tpu_torch.models.llama import param_count

    c = model_config
    wbytes = param_count(c) * (1 if quantize == "int8" else 2)
    if kv_quantize == "int8":
        row_bytes = c.head_dim + 4
    else:
        row_bytes = c.head_dim * kv_dtype_bytes
    cache = c.layers * slots * window * c.kv_heads * row_bytes * 2
    return DecodeRoofline(
        weight_bytes=wbytes,
        cache_bytes_per_step=cache,
        total_bytes_per_step=wbytes + cache,
        hbm_gbps=detect_hbm_gbps(),
        generation=detect_generation(),
        hbm_bytes=detect_hbm_bytes(),
    )
