"""The port's attribution plane and roofline
(``langstream_tpu_torch/serving/{attribution,profiling}.py``) against the
JAX package's: equal program costs from equal ``ModelShape`` fields at
Llama-3-8B and at the tiny shape, equal ledger reports and censuses after
the same observations, equal memory-ledger owners, equal roofline bytes,
and engines that count the same weight and KV-pool bytes. Exact equality
throughout: the cost model is integer arithmetic."""

import asyncio
import dataclasses
import logging

import pytest
import torch

from langstream_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from langstream_tpu.models.llama import param_count as jax_param_count
from langstream_tpu.serving import attribution as jax_attr
from langstream_tpu.serving import profiling as jax_prof
from langstream_tpu.serving.engine import ServingConfig as JaxServingConfig
from langstream_tpu.serving.engine import TpuServingEngine
from langstream_tpu_torch.models.llama import LlamaConfig, param_count
from langstream_tpu_torch.serving import attribution as port_attr
from langstream_tpu_torch.serving import profiling as port_prof
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine


def shape_fields(config, weight_bytes_per_param: int, kv_row_bytes: int, act_bytes: int):
    n = param_count(config)
    return dict(
        layers=config.layers, hidden=config.hidden, heads=config.heads,
        kv_heads=config.kv_heads, head_dim=config.head_dim,
        intermediate=config.intermediate, vocab=config.vocab_size,
        weight_bytes=n * weight_bytes_per_param, param_count=n,
        kv_row_bytes=kv_row_bytes, act_bytes=act_bytes,
    )


SHAPES = {
    # int8 weights (1 byte a parameter), int8 KV rows (head_dim + 4-byte scale)
    "llama3-8b-int8": shape_fields(LlamaConfig.llama3_8b(), 1, 128 + 4, 2),
    "llama3-8b-bf16": shape_fields(LlamaConfig.llama3_8b(), 2, 128 * 2, 2),
    "tiny-f32": shape_fields(LlamaConfig.tiny(), 4, 16 * 4, 4),
}
COSTS = {
    "decode": [("decode_cost", dict(slots=64, window_rows=w, k_steps=k))
               for w, k in ((128, 32), (2048, 8), (512, 1))],
    "prefill": [("prefill_cost", dict(rows=r, tokens_per_row=t, prefix_rows=p))
                for r, t, p in ((4, 512, 0), (1, 32, 0), (8, 64, 1088), (2, 512, 1024))],
    "verify": [("verify_cost", dict(slots=s, window_rows=w, drafts=d))
               for s, w, d in ((64, 2048, 4), (8, 1152, 4), (3, 256, 2))],
}


@pytest.mark.parametrize("kind", list(COSTS))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_program_costs_match_jax(shape, kind):
    port_shape = port_attr.ModelShape(**SHAPES[shape])
    jax_shape = jax_attr.ModelShape(**SHAPES[shape])
    for fn, kwargs in COSTS[kind]:
        got = getattr(port_attr, fn)(port_shape, hbm_gbps=3350.0, **kwargs)
        want = getattr(jax_attr, fn)(jax_shape, hbm_gbps=3350.0, **kwargs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (fn, kwargs)
        assert got.to_dict() == want.to_dict()
        assert got.expected_ms() == want.expected_ms()


def _ledger(module):
    shape = module.ModelShape(**SHAPES["llama3-8b-int8"])
    ledger = module.ProgramLedger(window=4)
    ledger.register("decode:w128:k32:greedy", module.decode_cost(
        shape, slots=64, window_rows=128, k_steps=32, hbm_gbps=3350.0))
    ledger.register("prefill:p512:b8:greedy", module.prefill_cost(
        shape, rows=8, tokens_per_row=512, prefix_rows=0, hbm_gbps=3350.0))
    ledger.register("decode:w128:k32:greedy", module.decode_cost(  # idempotent
        shape, slots=1, window_rows=1, k_steps=1, hbm_gbps=1.0))
    for ms in (2100.0, 1900.0, 2000.0, 2600.0, 1800.0):  # evicts the first
        ledger.observe("decode:w128:k32:greedy", ms / 1000.0)
    ledger.observe("prefill:p512:b8:greedy", 0.25)
    ledger.observe("never-registered", 1.0)  # dropped
    return ledger


def test_program_ledger_report_and_census_match_jax():
    port, ref = _ledger(port_attr), _ledger(jax_attr)
    assert port.report() == ref.report()
    assert port.census() == ref.census() == {
        "decode:w128:k32:greedy": 5, "prefill:p512:b8:greedy": 1}
    assert [e["program"] for e in port.report()] == [
        "decode:w128:k32:greedy", "prefill:p512:b8:greedy"]  # heaviest first


@pytest.mark.parametrize("limit", [80 * 2**30, None], ids=["limit-known", "limit-unknown"])
def test_memory_ledger_matches_jax(limit):
    kwargs = dict(weights_bytes=8_030_000_000, kv_pool_bytes=17_179_869_184,
                  prefix_blocks=17, bytes_per_block=8_650_752, sampler_bytes=832,
                  tables_bytes=8192, limit_bytes=limit,
                  limit_source="device_properties" if limit else "unknown")
    got, want = port_attr.memory_ledger(**kwargs), jax_attr.memory_ledger(**kwargs)
    assert got == want
    if limit is not None:
        assert sum(got["hbm_bytes_by_owner"].values()) == limit


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["bf16-weights", "int8-weights"])
@pytest.mark.parametrize("kv_quantize", [None, "int8"], ids=["bf16-kv", "int8-kv"])
def test_decode_step_bytes_match_jax(quantize, kv_quantize):
    got = port_prof.decode_step_bytes(LlamaConfig.llama3_8b(), 64, 2048,
                                      quantize=quantize, kv_quantize=kv_quantize)
    want = jax_prof.decode_step_bytes(JaxLlamaConfig.llama3_8b(), 64, 2048,
                                      quantize=quantize, kv_quantize=kv_quantize)
    for field in ("weight_bytes", "cache_bytes_per_step", "total_bytes_per_step"):
        assert getattr(got, field) == getattr(want, field), field
    # the port's roof is the H100's, never a TPU generation's
    assert got.hbm_gbps == 3350.0
    assert got.min_step_ms() == got.total_bytes_per_step / 3350e9 * 1e3


@pytest.mark.parametrize("name", ["tiny", "llama_1b", "llama3_8b", "llama3_70b"])
def test_param_count_matches_jax(name):
    assert param_count(getattr(LlamaConfig, name)()) == jax_param_count(
        getattr(JaxLlamaConfig, name)())


def test_roofline_detection_off_the_card():
    """On the CPU: no generation, no capacity, the H100's bandwidth
    assumed; the table holds no TPU row."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert port_prof.detect_generation() is None
    assert port_prof.detect_hbm_capacity() == (None, "unknown")
    assert port_prof.detect_hbm_bytes() is None
    assert port_prof.detect_hbm_gbps() == 3350.0
    assert not any(k.startswith("v") for k in port_prof._HBM_GBPS)


ENGINES = {
    "dense-f32": {},
    "paged-f32": {"kv-layout": "paged", "kv-block-size": 16, "prefix-cache": False},
    "paged-int8": {"kv-layout": "paged", "kv-block-size": 16, "prefix-cache": False,
                   "quantize": "int8", "kv-quantize": "int8"},
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engines_count_the_same_bytes(name):
    """The port engine's weight and KV-pool bytes (``tree_device_bytes``
    over its tensors, a ``QTensor`` counting ``q`` and ``s``) equal the JAX
    engine's; the memory ledgers and attribution sections have the same
    owners and keys."""
    cfg = {"model": "tiny", "model-dtype": "float32", "slots": 3, "max-seq-len": 128,
           **ENGINES[name]}
    ref = TpuServingEngine(JaxServingConfig.from_dict(cfg))
    port = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")
    assert port._weights_bytes == ref._weights_bytes
    assert port._kv_cache_bytes == ref._kv_cache_bytes
    assert port._kv_block_bytes == ref._kv_block_bytes
    assert port._prog_shape == port_attr.ModelShape(**dataclasses.asdict(ref._prog_shape))
    got, want = port._memory_ledger(), ref._memory_ledger()
    assert set(got) == set(want)
    assert set(got["hbm_bytes_by_owner"]) == set(want["hbm_bytes_by_owner"])
    for owner in ("weights", "kv-pool", "in-transit"):
        assert got["hbm_bytes_by_owner"][owner] == want["hbm_bytes_by_owner"][owner]
    assert set(port.attribution_section()) == set(ref.attribution_section())
    asyncio.run(port.close())
    asyncio.run(ref.close())


def test_profiler_hooks_capture_the_first_chunks(monkeypatch, tmp_path, caplog):
    """``LS_TPU_PROFILE_DIR``: a ``torch.profiler`` Chrome trace of the
    first ``LS_TPU_PROFILE_CHUNKS`` decode chunks; ``LS_TPU_HLO_DUMP_DIR``
    is logged once (an eager port has no HLO) and writes nothing."""
    monkeypatch.setenv("LS_TPU_PROFILE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("LS_TPU_PROFILE_CHUNKS", "2")
    monkeypatch.setenv("LS_TPU_HLO_DUMP_DIR", str(tmp_path / "hlo"))
    engine = TorchServingEngine(ServingConfig.from_dict(
        {"model": "tiny", "model-dtype": "float32", "slots": 2, "max-seq-len": 64,
         "decode-chunk": 2, "decode-chunk-light": 0}), device="cpu")

    async def serve():
        try:
            return await engine.generate("profile me", {"max-tokens": 9})
        finally:
            await engine.close()

    with caplog.at_level(logging.INFO, logger="langstream_tpu_torch.serving.profiling"):
        result = asyncio.run(serve())
        engine.profiler.dump_hlo("decode")
        engine.profiler.dump_hlo("prefill")
    assert len(result["tokens"]) == 9
    assert engine.stats()["decode-chunks"]["dispatched"] >= 4
    traces = sorted(p.name for p in (tmp_path / "trace").iterdir())
    assert traces == ["trace-1.json"]
    assert (tmp_path / "trace" / "trace-1.json").stat().st_size > 0
    assert not (tmp_path / "hlo").exists()
    assert sum("no HLO" in r.getMessage() for r in caplog.records) == 1
    assert engine.profiler.start_trace(str(tmp_path / "again"))
    assert not engine.profiler.start_trace()  # already capturing
    assert engine.profiler.stop_trace() and not engine.profiler.stop_trace()
    assert [p.name for p in (tmp_path / "again").iterdir()] == ["trace-2.json"]
