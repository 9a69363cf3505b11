"""Mixtral-family serving: ``TorchServingEngine`` and ``TorchServiceProvider``
on ``moe-tiny`` against the JAX package's engine and provider.

Both engines serve the same f32 parameters (the JAX engine's own, carried
across with ``params_from_numpy``) in two waves, awaited in turn, of more
requests than slots with mixed budgets, so heavy bursts run the pipelined
loop, slots freeze and queued requests are admitted under a pending chunk.
At moe-tiny's capacity factor of 1.25 the 3-slot decode batch drops expert
choices (capacity 2 for 6 choices), and so do some prefills: the greedy
tokens must be identical in every layout all the same, logprobs within
1e-4. Also here: the dispatch path's no-blocking-copy guard on a MoE
engine, the provider on the in-repo Mixtral fixture, and the refusals that
remain.
"""

import asyncio
from pathlib import Path

import numpy as np
import pytest
import torch

from langstream_tpu.agents.tpu_provider import TpuServiceProvider
from langstream_tpu.serving.engine import (
    ServingConfig as JaxServingConfig,
    TpuServingEngine,
)
from langstream_tpu_torch.agents.provider import TorchServiceProvider
from langstream_tpu_torch.models import moe as tm
from langstream_tpu_torch.models.convert import params_from_numpy
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine
from test_torch_engine import flatten_jax_params
from test_torch_pipeline import check_dispatch_path_makes_no_blocking_copy
from test_torch_provider import _serve_provider

FIXTURE = str(Path(__file__).parent / "fixtures" / "moe_tiny_golden")
BASE = {"model": "moe-tiny", "model-dtype": "float32", "slots": 3,
        "max-seq-len": 256, "decode-chunk": 4}
PAGED = {"kv-layout": "paged", "prefix-cache": False, "kv-block-size": 16}
LAYOUTS = {
    "dense": {},
    "paged": PAGED,
    "paged-int8-kv": {**PAGED, "kv-quantize": "int8"},
    "paged-int8-weights": {**PAGED, "quantize": "int8"},
    "prefix-cache-chunked": {**PAGED, "prefix-cache": True, "prefill-chunk": 32},
    "speculative": {**PAGED, "speculative-drafts": 4},
}
PREAMBLE = ("System: you route tokens to experts and answer briefly. ")  # 56 tokens
WAVES = [  # (prompt, max-tokens); the preamble prompts are chunked at 32
    [(PREAMBLE + "Q: what is a router?", 10), ("the cat sat on the mat. " * 3, 16),
     ("a", 7), (PREAMBLE + "Q: why drop tokens?", 12), ("fifth one", 5)],
    # three prompts of one bucket first: a prefill of 3 rows padded to 4
    [("judge my vow", 11), ("abcdefgh, ijklmnop", 13), ("the quick brown fox", 9),
     (PREAMBLE + "Q: what is capacity?", 9), (PREAMBLE + "Q: why drop tokens?", 6)],
]


class _DropCounter:
    """Counts the expert choices of valid tokens that capacity dropped, by
    wrapping ``top2_routing`` (reads device values: not on a guarded path)."""

    def __init__(self, monkeypatch):
        self.drops = 0
        real = tm.top2_routing

        def routing(logits, capacity, valid=None):
            out = real(logits, capacity, valid)
            dropped = out[1] == capacity
            if valid is not None:
                dropped = dropped & valid[:, None]
            self.drops += int(dropped.sum())
            return out

        monkeypatch.setattr(tm, "top2_routing", routing)


async def _waves(engine):
    out = []
    try:
        for wave in WAVES:
            out += await asyncio.gather(*(
                engine.generate(p, {"max-tokens": m, "temperature": 0}) for p, m in wave))
    finally:
        await engine.close()
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_moe_engine_matches_jax_engine(name, monkeypatch):
    cfg = {**BASE, **LAYOUTS[name]}
    ref = TpuServingEngine(JaxServingConfig.from_dict(cfg))
    flat = flatten_jax_params(ref.params)
    want = asyncio.run(_waves(ref))
    port = TorchServingEngine(
        ServingConfig.from_dict(cfg), device="cpu",
        params=params_from_numpy(flat, device="cpu", dtype=torch.float32))
    assert port.params["layers"]["router"].dtype == torch.float32
    counter = _DropCounter(monkeypatch)
    got = asyncio.run(_waves(port))
    stats = port.stats()
    for i, (w, g) in enumerate(zip(want, got)):
        assert g["tokens"] == w["tokens"], (name, i)
        assert g["text"] == w["text"], (name, i)
        assert g["finish_reason"] == w["finish_reason"], (name, i)
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], rtol=1e-4, atol=1e-4)
    assert counter.drops > 0  # capacity dropped choices along the way
    assert stats["completed"] == len(want) and stats["active"] == 0
    if "speculative-drafts" in cfg:
        sp = stats["speculative"]
        assert sp["steps"] > 0 and sp["drafts_accepted"] > 0
        assert sp["steps"] == ref.speculative_section()["steps"]
    else:
        assert stats["decode-chunks"]["heavy"] > 0 and stats["pipeline"]
    if cfg.get("prefix-cache"):
        assert stats["prefix"]["hits"] == ref.prefix_hits > 0


def test_moe_dispatch_path_makes_no_blocking_copy():
    """The pipelined loop's guard on a moe-tiny engine: routing reads no
    device value on the host and takes no shape from the data."""
    engine = TorchServingEngine(ServingConfig.from_dict({
        **BASE, **PAGED, "slots": 4, "decode-chunk": 8, "decode-chunk-light": 0,
        "pipeline": True}), device="cpu")
    check_dispatch_path_makes_no_blocking_copy(engine, paged=True)


def test_moe_provider_matches_jax_provider():
    """A chat through each package's provider with ``model: moe-tiny`` on the
    in-repo Mixtral fixture (``checkpoint:``): identical results and chunks."""
    resource = {"type": "tpu-serving-configuration", "name": "tpu", **BASE,
                **PAGED, "checkpoint": FIXTURE, "max-tokens": 12}
    try:
        want = asyncio.run(_serve_provider(TpuServiceProvider(resource), None))
        got = asyncio.run(_serve_provider(
            TorchServiceProvider(resource, device="cpu"), None))
    finally:
        TorchServingEngine.reset_instances()
        TpuServingEngine.reset_instances()
    assert got == want
    assert all(text for (text, *_), _ in got)


@pytest.mark.parametrize("overrides", [
    {"quantize": "int8"}, {"kv-layout": "paged", "kv-quantize": "int8"}])
def test_moe_checkpoint_engine_matches_jax_engine(overrides):
    """``checkpoint:`` with a MoE model, int8 weights quantized after the
    load as the JAX engine does, or int8 KV."""
    cfg = {**BASE, "checkpoint": FIXTURE, **overrides}
    want = asyncio.run(_waves(TpuServingEngine(JaxServingConfig.from_dict(cfg))))
    got = asyncio.run(_waves(TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")))
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], rtol=1e-4, atol=1e-4)


def test_moe_attribution_counts_params_from_weight_bytes():
    """As the JAX engine: a MoE model's parameter count for the cost
    models is the measured weight bytes over the weights' width, its
    intermediate the experts'."""
    for quantize in (None, "int8"):
        cfg = {**BASE, **({"quantize": quantize} if quantize else {})}
        engine = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu")
        shape = engine._prog_shape
        width = 1 if quantize else 4
        assert shape.param_count == engine._weights_bytes // width
        assert shape.intermediate == tm.MoEConfig.tiny().moe_intermediate
        assert engine.is_moe and engine._ffn is not None


def test_smoke_moe_resource_is_the_example_without_its_mesh():
    """``chip_smoke.py`` path G serves the ``moe-mixtral-ep`` example's
    resource, less the mesh: its ``ep: 4, tp: 2`` needs eight ranks, one
    process each, which a one-process engine refuses naming both counts
    (the mesh itself is served since the multi-GPU slice, path N2)."""
    import yaml

    import chip_smoke

    example = yaml.safe_load((Path(__file__).resolve().parents[1] / "examples"
                              / "applications" / "moe-mixtral-ep"
                              / "configuration.yaml").read_text())
    resource = example["configuration"]["resources"][0]["configuration"]
    assert {k: v for k, v in resource.items() if k != "mesh"} == \
        chip_smoke.MOE_EXAMPLE_RESOURCE
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        TorchServingEngine(ServingConfig.from_dict(resource), device="cpu")
