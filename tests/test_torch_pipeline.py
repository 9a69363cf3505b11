"""The port's pipelined decode loop (``TorchServingEngine._pipelined_burst``).

The tiny model in f32 on the mixed workload of ``tests/test_pipeline.py``
(more requests than slots, budgets straddling chunk boundaries, every other
request streamed): the pipelined loop gives byte-identical greedy output to
the port's sequential loop (tokens, streamed emissions, text, finish
reasons, billed tokens), and equals the JAX engine's pipelined loop in
dense f32, paged and paged int8 KV (tokens and text exactly, logprobs
within ``rtol = atol = 1e-4``) with an equal attribution census. Between
the two loops byte identity holds in f32 only: an int8 pool quantizes the
rows at each chunk's commit, and the two loops commit at other boundaries.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu.serving.engine import _DeviceLru as JaxDeviceLru
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving.engine import (
    ServingConfig,
    TorchServingEngine,
    _DeviceLru,
)
from test_torch_engine import flatten_jax_params

BASE = {"model": "tiny", "slots": 4, "max-seq-len": 128, "decode-chunk": 8,
        "decode-chunk-light": 0, "model-dtype": "float32"}
LAYOUTS = {
    "dense": {},
    "paged": {"kv-layout": "paged", "kv-block-size": 16, "prefix-cache": False},
    "paged-int8": {"kv-layout": "paged", "kv-block-size": 16, "prefix-cache": False,
                   "kv-quantize": "int8"},
}
# tests/test_pipeline.py's workload
WORKLOAD = [
    ("the quick brown fox", 5),
    ("pack my box with five dozen", 12),
    ("jumps over the lazy dog", 9),
    ("sphinx of black quartz", 16),
    ("judge my vow", 7),
    ("abcdefgh", 21),
]


def _engine(layout: str, pipeline: bool, params=None, **extra) -> TorchServingEngine:
    cfg = ServingConfig.from_dict({**BASE, **LAYOUTS[layout], "pipeline": pipeline, **extra})
    return TorchServingEngine(cfg, device="cpu", params=params)


async def _run_workload(engine, eos_id=None):
    """All requests at once; returns (results, streamed (token, last) lists,
    stats read after the engine closed)."""
    if eos_id is not None:
        engine.tokenizer.eos_id = eos_id
    streams = {}

    def collector(i):
        streams[i] = []
        return lambda token, logprob, last: streams[i].append((token, last))

    try:
        results = await asyncio.gather(*(
            engine.generate(prompt, {"max-tokens": budget, "temperature": 0},
                            on_token=collector(i) if i % 2 == 0 else None)
            for i, (prompt, budget) in enumerate(WORKLOAD)
        ))
    finally:
        await engine.close()
    return results, streams, engine.stats()


def _probe_eos(layout: str) -> int:
    """A token the model emits fourth for the first prompt: made EOS, so
    completions end early and mid-chunk."""
    engine = _engine(layout, False)

    async def probe():
        try:
            return await engine.generate(WORKLOAD[0][0], {"max-tokens": 12, "temperature": 0})
        finally:
            await engine.close()

    tokens = asyncio.run(probe())["tokens"]
    assert len(tokens) >= 4
    return tokens[3]


@pytest.mark.parametrize("eos", [False, True], ids=["budgets", "early-eos"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_pipelined_loop_matches_sequential_loop(layout, eos):
    """Tokens, streamed emissions, final text, finish reasons and billed
    tokens identical to the sequential loop; the pipelined engine ran heavy
    chunks and closed its ledgers (one fetch per chunk, no block held)."""
    eos_id = _probe_eos(layout) if eos else None
    seq, seq_streams, seq_stats = asyncio.run(_run_workload(_engine(layout, False), eos_id))
    pipe, pipe_streams, pipe_stats = asyncio.run(_run_workload(_engine(layout, True), eos_id))
    for i, (s, p) in enumerate(zip(seq, pipe)):
        assert p["tokens"] == s["tokens"], i
        assert p["text"] == s["text"], i
        assert p["finish_reason"] == s["finish_reason"], i
        assert p["num_completion_tokens"] == len(p["tokens"]) == s["num_completion_tokens"]
    assert pipe_streams == seq_streams
    if eos:
        assert any(r["finish_reason"] == "stop" for r in pipe)
    # over-run tokens are never billed: the same count as the sequential
    # loop, which decodes none (EOS counts as generated, not as a token)
    assert pipe_stats["total-generated"] == seq_stats["total-generated"] == sum(
        len(r["tokens"]) + (r["finish_reason"] == "stop") for r in pipe)
    dc = pipe_stats["decode-chunks"]
    assert pipe_stats["pipeline"] is True and dc["heavy"] > 0 and dc["light"] == 0
    assert dc["dispatched"] == dc["fetched"] > 0
    assert dc["host_fetches_per_chunk"] == 1.0
    assert pipe_stats["completed"] == len(WORKLOAD) and pipe_stats["active"] == 0
    if layout == "paged":
        kv = pipe_stats["kv"]
        assert kv["reserved_blocks"] == 0 and kv["live_blocks"] == 0


def _jax_and_port(layout: str):
    cfg = {**BASE, **LAYOUTS[layout]}
    ref = TpuServingEngine(JaxServingConfig.from_dict(cfg))
    params = params_from_numpy(flatten_jax_params(ref.params), device="cpu",
                               dtype=torch.float32)
    return ref, _engine(layout, True, params)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipelined_loop_matches_jax_pipelined_loop(layout):
    """Both engines pipelined (the default) on the same parameters: equal
    tokens and text, logprobs within 1e-4, equal streams, and an equal
    census of program ids and dispatch counts (every request submitted
    before either loop starts)."""
    ref, port = _jax_and_port(layout)
    want, want_streams, _ = asyncio.run(_run_workload(ref))
    got, got_streams, stats = asyncio.run(_run_workload(port))
    assert ref._pipeline_on and port._pipeline_on
    for i, (w, g) in enumerate(zip(want, got)):
        assert g["tokens"] == w["tokens"], (layout, i)
        assert g["text"] == w["text"], (layout, i)
        assert g["finish_reason"] == w["finish_reason"], (layout, i)
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], rtol=1e-4, atol=1e-4)
    assert got_streams == want_streams
    assert port.attribution.census() == ref.attribution.census()
    assert any(p.startswith("decode:") for p in port.attribution.census())
    assert stats["steps"] == dict(ref.flight.steps_by_phase)


def test_stats_carry_the_jax_keys():
    ref, port = _jax_and_port("paged")
    asyncio.run(_run_workload(ref))
    asyncio.run(_run_workload(port))
    want, got = ref.stats(), port.stats()
    for key in ("pipeline", "device-cache", "steps", "decode-chunks", "attribution"):
        assert key in got, key
    assert set(want["decode-chunks"]) <= set(got["decode-chunks"])
    assert got["decode-chunks"]["light"] == want["decode-chunks"]["light"]
    assert got["decode-chunks"]["heavy"] == want["decode-chunks"]["heavy"]
    assert got["pipeline"] is want["pipeline"] is True
    assert set(got["device-cache"]) == set(want["device-cache"]) == {"tables", "sampler"}
    for name in ("tables", "sampler"):
        assert set(got["device-cache"][name]) == set(want["device-cache"][name])
        assert got["device-cache"][name]["misses"] >= 1
    assert got["steps"] == want["steps"]
    assert set(got["attribution"]) == set(want["attribution"])
    assert set(got["attribution"]["memory"]) == set(want["attribution"]["memory"])
    (g_entry, *_), (w_entry, *_) = got["attribution"]["programs"], want["attribution"]["programs"]
    assert set(g_entry) == set(w_entry) and set(g_entry["expected"]) == set(w_entry["expected"])
    # the flight recorder tiles the loop's timeline: wall = device + host + stall
    t = port.flight.summary()["totals"]
    assert port.flight.wall_ms == pytest.approx(
        port.flight.device_ms + port.flight.host_ms + port.flight.stall_ms, rel=1e-12)
    assert t["wall_ms"] == pytest.approx(t["device_ms"] + t["host_ms"] + t["stall_ms"], abs=0.01)
    assert t["steps_by_phase"] == got["steps"]


@pytest.mark.parametrize("env,pipeline", [
    (None, True), (None, False), ("0", True), ("0", False), ("1", True), ("1", False)])
def test_pipeline_key_and_env_gate_as_jax(monkeypatch, env, pipeline):
    """``LS_TPU_PIPELINE=0`` forces the sequential loop whatever the key
    says; the key round-trips from YAML strings; both packages agree."""
    if env is None:
        monkeypatch.delenv("LS_TPU_PIPELINE", raising=False)
    else:
        monkeypatch.setenv("LS_TPU_PIPELINE", env)
    d = {**BASE, "pipeline": str(pipeline).lower()}
    assert ServingConfig.from_dict(d).pipeline is pipeline
    assert ServingConfig.from_dict(BASE).pipeline is True
    port = TorchServingEngine(ServingConfig.from_dict(d), device="cpu")
    ref = TpuServingEngine(JaxServingConfig.from_dict(d))
    assert port._pipeline_on is ref._pipeline_on is (pipeline and env != "0")
    assert port.stats()["pipeline"] is ref.stats()["pipeline"]


def test_device_lru_caps_and_counts_evictions(monkeypatch):
    """The same operations give the JAX cache's counts; the env knob sizes
    the engine's caches."""
    caches = (_DeviceLru(cap=2), JaxDeviceLru(cap=2))
    for lru in caches:
        assert lru.get_or_put(b"a", lambda: 1) == 1
        assert lru.get_or_put(b"b", lambda: 2) == 2
        assert lru.get_or_put(b"a", lambda: 99) == 1  # a hit keeps the value
        lru.get_or_put(b"c", lambda: 3)  # evicts b
        assert lru.get_or_put(b"b", lambda: 4) == 4  # re-inserted
    assert caches[0].stats() == caches[1].stats() == {
        "size": 2, "cap": 2, "hits": 1, "misses": 4, "evictions": 2}
    monkeypatch.setenv("LS_TPU_DEV_CACHE_CAP", "5")
    assert _DeviceLru().cap == 5
    monkeypatch.setenv("LS_TPU_DEV_CACHE_CAP", "junk")
    assert _DeviceLru().cap == 32


@pytest.mark.parametrize("layout", ["paged", "paged-int8"])
def test_bursts_leave_no_deferred_release(layout):
    """Inside a pipelined burst finished slots' releases wait; when each
    burst returns none is left, and at the end the pool holds nothing."""
    engine = _engine(layout, True)
    after_bursts = []
    real = engine._pipelined_burst

    async def burst(loop, active, K):
        await real(loop, active, K)
        after_bursts.append((list(engine._deferred_releases), engine._defer_release,
                             engine.block_mgr.reserved_blocks))

    engine._pipelined_burst = burst
    results, _, stats = asyncio.run(_run_workload(engine))
    assert len(after_bursts) >= 2 and all(r["tokens"] for r in results)
    assert all(d == [] and not on for d, on, _ in after_bursts)
    assert engine._pending_chunk is None and engine._deferred_releases == []
    assert stats["kv"]["reserved_blocks"] == 0 and stats["kv"]["live_blocks"] == 0
    assert stats["kv"]["free_blocks"] == stats["kv"]["num_blocks"] - 1


def test_settled_waits_for_the_overrun_chunk():
    """The last results arrive while the pipelined burst still holds its
    over-run chunk; ``settled()`` returns once the loop applied it (what
    warmup waits for), with the ledgers closed before ``close()``."""
    engine = _engine("paged", True)

    async def main():
        try:
            await asyncio.gather(*(
                engine.generate(p, {"max-tokens": b, "temperature": 0}) for p, b in WORKLOAD))
            await engine.settled()
            return engine.stats()
        finally:
            await engine.close()

    stats = asyncio.run(main())
    dc = stats["decode-chunks"]
    assert dc["dispatched"] == dc["fetched"] > 0 and dc["heavy"] > 0
    assert stats["kv"]["reserved_blocks"] == 0 and stats["kv"]["live_blocks"] == 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_failed_dispatch_inside_a_burst_fails_inflight_and_keeps_serving(layout):
    """A dispatch that raises inside a pipelined burst fails the requests
    in flight with that error, drops the pending chunk, flushes the
    deferred releases, and the engine serves the next request."""
    engine = _engine(layout, True)
    real, calls = engine._dispatch_decode, []

    def dispatch(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected dispatch failure")
        return real(*args, **kwargs)

    engine._dispatch_decode = dispatch

    async def main():
        try:
            first = await asyncio.gather(*(
                engine.generate(p, {"max-tokens": b, "temperature": 0})
                for p, b in WORKLOAD), return_exceptions=True)
            after = await engine.generate("after the failure", {"max-tokens": 12})
            await engine.settled()
            return first, after
        finally:
            await engine.close()

    first, after = asyncio.run(main())
    failed = [r for r in first if isinstance(r, RuntimeError)]
    assert failed and all("injected" in str(e) for e in failed)
    assert len(after["tokens"]) == 12
    assert engine._pending_chunk is None and engine._deferred_releases == []
    assert not engine._defer_release
    if layout == "paged":
        kv = engine.stats()["kv"]
        assert kv["reserved_blocks"] == 0 and kv["live_blocks"] == 0


class _SyncGuard(TorchFunctionMode):
    """Records every call that copies between host and device and blocks
    (or reads a device value on the host): item/tolist/numpy/cpu, Python
    truth or number conversions of a tensor, tensors built from host data,
    and ``to``/``copy_`` naming a device without ``non_blocking=True``."""

    HOST_READS = {"item", "tolist", "numpy", "cpu", "cuda", "__bool__", "__int__",
                  "__float__", "__index__", "as_tensor", "tensor"}

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        names_device = any(isinstance(a, (str, torch.device)) for a in args[1:]) or (
            "device" in kwargs)
        if name in self.HOST_READS or (
            name in ("to", "copy_") and names_device and not kwargs.get("non_blocking")
        ):
            self.calls.append(name)
        return func(*args, **kwargs)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dispatch_path_makes_no_blocking_copy(layout):
    """A guard on the dispatch thread around every pipelined dispatch finds
    no blocking copy and no host read of a device value; after a burst's
    first chunk (host tokens, uploaded) the only uploads are device-cache
    misses, and each chunk has exactly one fetch."""
    check_dispatch_path_makes_no_blocking_copy(_engine(layout, True),
                                               paged=layout != "dense")


def check_dispatch_path_makes_no_blocking_copy(engine, paged: bool):
    """The guard of :func:`test_dispatch_path_makes_no_blocking_copy` over
    ``engine`` serving the workload (also run on a MoE engine)."""
    log = []  # per dispatch: (fed from the device, guarded calls, uploads, misses)
    uploads = []
    real_dispatch, real_upload = engine._dispatch_decode, engine._upload

    def misses():
        """Uploads the device caches' misses made: one per block-table
        miss, four per sampler miss (mask, temperatures, top-k, top-p)."""
        return (engine._tables_dev_cache.stats()["misses"]
                + 4 * engine._sampler_dev_cache.stats()["misses"])

    def upload(array):
        uploads.append(threading.current_thread().name)
        return real_upload(array)

    def dispatch(tokens, *args, **kwargs):
        before_uploads, before_misses = len(uploads), misses()
        with _SyncGuard() as guard:
            out = real_dispatch(tokens, *args, **kwargs)
        log.append((isinstance(tokens, torch.Tensor), guard.calls,
                    len(uploads) - before_uploads, misses() - before_misses))
        return out

    engine._dispatch_decode, engine._upload = dispatch, upload
    results, _, stats = asyncio.run(_run_workload(engine))
    assert all(r["tokens"] for r in results)
    fed = [entry for entry in log if entry[0]]
    assert len(fed) >= 3, log  # chunks dispatched from device-resident feedback
    assert all(calls == [] for _, calls, _, _ in log), log
    assert all(n_up == n_miss for _, _, n_up, n_miss in fed), log
    assert all(n_up == 2 + n_miss for is_fed, _, n_up, n_miss in log if not is_fed), log
    # every upload ran on the dispatch thread, none on the event loop
    assert uploads and all(name.startswith("torch-engine") for name in uploads)
    dc = stats["decode-chunks"]
    assert dc["dispatched"] == dc["fetched"] == len(log)
    assert stats["device-cache"]["sampler"]["hits"] > 0
    if paged:
        assert stats["device-cache"]["tables"]["hits"] > 0
