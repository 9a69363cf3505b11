"""The prefix cache and chunked prefill of ``TorchServingEngine``.

The comparisons run ``TpuServingEngine`` and the port on the same tiny f32
parameters (the JAX engine's own, carried across with
``params_from_numpy``) over two waves, awaited in turn, of prompts that
share a preamble: the second wave hits the blocks the first one cached.
Greedy tokens, text and finish reasons must be identical, logprobs within
1e-4, and the prefix-hit count and the cached block count equal.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from langstream_tpu.models.quant import QTensor as JaxQTensor
from langstream_tpu.serving.engine import (
    ServingConfig as JaxServingConfig,
    TpuServingEngine,
)
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

BASE = {"model": "tiny", "model-dtype": "float32", "slots": 3,
        "max-seq-len": 256, "decode-chunk": 4, "max-tokens": 8,
        "kv-layout": "paged", "kv-block-size": 16}
CONFIGS = {
    "prefix-cache": {"prefix-cache": True},
    "prefix-cache-chunked": {"prefix-cache": True, "prefill-chunk": 32},
    "chunked-only": {"prefix-cache": False, "prefill-chunk": 32},
    "prefix-cache-int8-kv": {"prefix-cache": True, "kv-quantize": "int8"},
}
PREAMBLE = ("System: you answer questions about paged attention and the "
            "KV cache. Be brief. ")  # 79 byte tokens: 4 full blocks of 16
WAVES = [
    [PREAMBLE + "Q: what is a block?", PREAMBLE + "Q: why share a prefix?",
     PREAMBLE + "Q: when is a block evicted?", "short and distinct"],
    [PREAMBLE + "Q: what is a slot?", PREAMBLE + "Q: what does chunking buy?",
     PREAMBLE + "Q: why share a prefix?", "another short one"],
]


def _flatten(tree):
    if isinstance(tree, JaxQTensor):
        return {"q": np.asarray(tree.q), "s": np.asarray(tree.s)}
    if isinstance(tree, dict):
        return {k: _flatten(v) for k, v in tree.items()}
    return np.asarray(tree)


async def _two_waves(engine):
    out = []
    for wave in WAVES:
        out += await asyncio.gather(*(engine.generate(p) for p in wave))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefix_engine_matches_jax_engine(name):
    cfg = {**BASE, **CONFIGS[name]}

    async def run_jax():
        engine = TpuServingEngine(JaxServingConfig.from_dict(cfg))
        try:
            results = await _two_waves(engine)
            return (_flatten(engine.params), results, engine.prefix_hits,
                    engine.block_mgr.stats()["cached_prefix_blocks"])
        finally:
            await engine.close()

    flat, want, want_hits, want_cached = asyncio.run(run_jax())

    async def run_port():
        engine = TorchServingEngine(
            ServingConfig.from_dict(cfg), device="cpu",
            params=params_from_numpy(flat, device="cpu", dtype=torch.float32),
        )
        try:
            results = await _two_waves(engine)
        finally:
            await engine.close()
        # read after close: when the last result is delivered a pipelined
        # burst may still hold its over-run chunk (and the block releases
        # it defers) in flight
        return results, engine.stats()

    got, stats = asyncio.run(run_port())
    prompts = [p for wave in WAVES for p in wave]
    for prompt, w, g in zip(prompts, want, got):
        assert g["tokens"] == w["tokens"], (name, prompt)
        assert g["text"] == w["text"], (name, prompt)
        assert g["finish_reason"] == w["finish_reason"], (name, prompt)
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], rtol=1e-4, atol=1e-4)
    assert stats["prefix"]["hits"] == want_hits
    assert stats["kv"]["cached_prefix_blocks"] == want_cached
    if CONFIGS[name]["prefix-cache"]:
        assert want_hits >= 3  # wave 2's preamble rows reuse wave 1's blocks
        assert stats["prefix"]["tokens_reused"] >= 3 * 64
        assert stats["prefill-continue-calls"] > 0
    else:
        assert want_hits == 0 and want_cached == 0
    if "prefill-chunk" in CONFIGS[name]:
        assert stats["prefill-continue-calls"] > 0
    assert stats["decode-chunks"]["host_fetches_per_chunk"] == 1.0
    assert stats["active"] == 0 and stats["completed"] == len(prompts)
    assert stats["kv"]["live_blocks"] == 0 and stats["kv"]["reserved_blocks"] == 0


def test_prefix_cache_eviction_under_pressure():
    """Port of ``tests/test_paged.py::test_prefix_cache_eviction_under_pressure``:
    cache-held blocks never block admission; when the pool runs dry the LRU
    cache-only blocks are evicted and every request completes."""
    cfg = ServingConfig.from_dict({
        "model": "tiny", "slots": 4, "max-seq-len": 128, "decode-chunk": 4,
        "max-tokens": 8, "kv-layout": "paged", "kv-block-size": 16,
        "kv-pool-blocks": 7, "prefix-cache": True,
    })

    async def main():
        engine = TorchServingEngine(cfg, device="cpu")
        try:
            results = [
                await engine.generate(f"request number {i} with some padding text",
                                      {"max-tokens": 8})
                for i in range(6)  # distinct prompts: every finish caches blocks
            ]
            return results, engine.stats()
        finally:
            await engine.close()

    results, stats = asyncio.run(main())
    assert all(0 < len(r["tokens"]) <= 8 for r in results)
    assert stats["completed"] == 6
    assert 0 < stats["kv"]["cached_prefix_blocks"] <= 6


def test_chunked_prefill_interleaves_with_decode():
    """Port of ``tests/test_paged.py::test_chunked_prefill_interleaves_with_decode``:
    while a long prompt prefills in chunks, an active short request keeps
    streaming — its tokens arrive after the long request was submitted and
    before the long request's first token."""
    cfg = ServingConfig.from_dict({
        "model": "tiny", "slots": 4, "max-seq-len": 512, "decode-chunk": 2,
        "max-tokens": 48, "kv-layout": "paged", "kv-block-size": 16,
        "prefill-chunk": 32, "prefix-cache": False,
    })

    async def main():
        engine = TorchServingEngine(cfg, device="cpu")
        short_times: list[float] = []
        try:
            short_task = asyncio.ensure_future(engine.generate(
                "short active request", {"max-tokens": 48},
                on_token=lambda t, lp, last: short_times.append(time.monotonic()),
            ))
            while len(short_times) < 4:
                await asyncio.sleep(0.01)
            long_submit = time.monotonic()
            long_result = await engine.generate(
                "the long request arrives later. " * 32, {"max-tokens": 4}
            )
            await short_task
            return short_times, long_submit, long_submit + long_result["ttft"]
        finally:
            await engine.close()

    short_times, long_submit, long_first = asyncio.run(main())
    during = [t for t in short_times if long_submit < t < long_first]
    assert during, (
        f"short stream stalled during the chunked prefill "
        f"(window {long_first - long_submit:.3f}s)"
    )


def test_chunked_prefill_max_tokens_one_seeds_cache():
    """Port of ``tests/test_paged.py::test_chunked_prefill_max_tokens_one_seeds_cache``:
    a chunked request finished by its first token still publishes its
    prompt blocks (registration runs before the emit that releases the
    slot), and the same prompt then hits them."""
    cfg = ServingConfig.from_dict({
        "model": "tiny", "slots": 4, "max-seq-len": 512, "decode-chunk": 4,
        "max-tokens": 8, "kv-layout": "paged", "kv-block-size": 16,
        "prefill-chunk": 32, "prefix-cache": True,
    })
    prompt = "a shared classification template prompt. " * 8

    async def main():
        engine = TorchServingEngine(cfg, device="cpu")
        try:
            first = await engine.generate(prompt, {"max-tokens": 1})
            cached = engine.stats()["kv"]["cached_prefix_blocks"]
            second = await engine.generate(prompt, {"max-tokens": 1})
            return first, second, cached, engine.stats()
        finally:
            await engine.close()

    first, second, cached, stats = asyncio.run(main())
    assert cached > 0
    assert stats["prefix"]["hits"] == 1
    assert first["tokens"] == second["tokens"] and len(first["tokens"]) <= 1


def test_paged_layout_with_the_default_prefix_cache_constructs():
    engine = TorchServingEngine(
        ServingConfig.from_dict({"model": "tiny", "kv-layout": "paged"}), device="cpu"
    )
    assert engine.config.prefix_cache and engine.block_mgr is not None
    assert engine.stats()["kernels"]["paged_attention_multiquery"] >= 0


def test_prefill_chunk_with_dense_layout_raises():
    with pytest.raises(ValueError, match="prefill-chunk requires kv-layout=paged"):
        TorchServingEngine(
            ServingConfig.from_dict({"model": "tiny", "prefill-chunk": 32}), device="cpu"
        )
