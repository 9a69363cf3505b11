"""The slice as a whole: ``TorchServingEngine`` against ``TpuServingEngine``.

Both engines serve the same prompts (more requests than slots, per-request
``max-tokens``, a ``stop`` string, EOS) on the same tiny f32 parameters —
the JAX engine's own, carried across with ``params_from_numpy`` — and must
give identical greedy tokens and text. The lm_head column of EOS is made
1.5x the column of a byte token the streams emit, so some end on EOS.
"""

import asyncio
import ast
import json
import subprocess
import sys
from pathlib import Path

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
from langstream_tpu_torch.serving.faults import FaultPlan

REPO = Path(__file__).resolve().parents[1]
EOS = 258
BASE = {"model": "tiny", "model-dtype": "float32", "slots": 3,
        "max-seq-len": 128, "decode-chunk": 4, "max-tokens": 12}
PAGED = {"kv-layout": "paged", "prefix-cache": False, "kv-block-size": 16}
CONFIGS = {  # name: (settings, the token whose lm_head column EOS copies)
    "dense": ({}, 32),
    # int8 KV on the dense layout (the default layout): the decode reads it
    # through the int8 paged kernel's plain version via identity tables, the
    # JAX engine through its XLA einsum
    "dense-int8-kv": ({"kv-quantize": "int8"}, 32),
    "paged": (PAGED, 32),
    "paged-int8-weights": ({**PAGED, "quantize": "int8"}, 116),
    "paged-int8-kv": ({**PAGED, "kv-quantize": "int8"}, 32),
    "paged-spec": ({**PAGED, "speculative-drafts": 4}, 32),
    "paged-int8-kv-spec": ({**PAGED, "kv-quantize": "int8", "speculative-drafts": 4}, 32),
}
REQUESTS = [  # one of them also gets a stop string its greedy text contains
    ("paged cache equivalence", {}),
    ("second prompt!", {}),
    ("a", {"max-tokens": 7}),
    ("and a longer fourth prompt here", {}),
    ("fifth one", {"max-tokens": 5}),
    ("the sixth request, longer than the others by a bit", {}),
]
# speculative configs add a request that repeats itself, so drafts land
REPETITIVE = ("the cat sat on the mat. " * 4, {"max-tokens": 24})


def flatten_jax_params(tree):
    """JAX parameter tree → numpy leaves; ``QTensor`` → ``{"q", "s"}``."""
    if isinstance(tree, JaxQTensor):
        return {"q": np.asarray(tree.q), "s": np.asarray(tree.s)}
    if isinstance(tree, dict):
        return {k: flatten_jax_params(v) for k, v in tree.items()}
    return np.asarray(tree)


def _with_eos_column(params, like: int):
    lm = params["lm_head"]
    if isinstance(lm, JaxQTensor):
        lm = JaxQTensor(
            q=lm.q.at[:, EOS].set(lm.q[:, like]),
            s=lm.s.at[:, EOS].set(1.5 * lm.s[:, like]),
            dtype=lm.dtype,
        )
    else:
        lm = lm.at[:, EOS].set(1.5 * lm[:, like])
    return {**params, "lm_head": lm}


async def _serve(engine, stop=None, requests=REQUESTS):
    """All requests at once; ``stop = (index, string)`` adds a stop string."""
    return await asyncio.gather(*(
        engine.generate(prompt, {
            "max-tokens": BASE["max-tokens"], **opts,
            **({"stop": stop[1]} if stop and stop[0] == i else {}),
        })
        for i, (prompt, opts) in enumerate(requests)
    ))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_engine_matches_jax_engine(name):
    settings, eos_like = CONFIGS[name]
    cfg = {**BASE, **settings}
    spec = cfg.get("speculative-drafts", 0) > 0
    requests = REQUESTS + [REPETITIVE] if spec else REQUESTS

    async def run_jax():
        engine = TpuServingEngine(JaxServingConfig.from_dict(cfg))
        engine.params = _with_eos_column(engine.params, eos_like)
        try:
            flat = flatten_jax_params(engine.params)
            # the second character of the first greedy text that has one
            texts = [r["text"].replace("\ufffd", "")
                     for r in await _serve(engine, requests=requests)]
            i = next(i for i, t in enumerate(texts) if len(t) >= 2)
            stop = (i, texts[i][1])
            return flat, stop, await _serve(engine, stop, requests)
        finally:
            await engine.close()

    flat, stop, want = asyncio.run(run_jax())

    async def run_port(cfg):
        engine = TorchServingEngine(
            ServingConfig.from_dict(cfg), device="cpu",
            params=params_from_numpy(flat, device="cpu", dtype=torch.float32),
        )
        try:
            results = await _serve(engine, stop, requests)
        finally:
            await engine.close()
        # read after close: when the last result is delivered a pipelined
        # burst may still hold its over-run chunk in flight
        return results, engine.stats()

    got, stats = asyncio.run(run_port(cfg))
    # with speculation the streams also equal the port's speculation-off
    # ones; on an int8 pool the verify quantizes K/V at other boundaries
    # than the decode chunk, so there the logprobs differ by more than 1e-4
    wants = [(want, True)]
    if spec:
        plain = asyncio.run(run_port({**cfg, "speculative-drafts": 0}))[0]
        wants.append((plain, "kv-quantize" not in settings))
    for i, ((prompt, opts), g) in enumerate(zip(requests, got)):
        for w, same_logprobs in ((ws[i], same) for ws, same in wants):
            assert g["tokens"] == w["tokens"], (name, prompt)
            assert g["text"] == w["text"], (name, prompt)
            assert g["finish_reason"] == w["finish_reason"], (name, prompt)
            assert g["num_prompt_tokens"] == w["num_prompt_tokens"]
            if same_logprobs:
                np.testing.assert_allclose(g["logprobs"], w["logprobs"],
                                           rtol=1e-4, atol=1e-4)
    # the cases the comparison must have exercised
    reasons = [(r["finish_reason"], len(r["tokens"])) for r in got]
    i, s = stop
    assert got[i]["finish_reason"] == "stop" and s not in got[i]["text"]
    assert any(f == "stop" and n < 12 and j != i and not REQUESTS[j][1]
               for j, (f, n) in enumerate(reasons)), reasons  # an EOS
    assert len(got[4]["tokens"]) <= 5 and any(f == "length" for f, _ in reasons)
    if spec:
        sp = stats["speculative"]
        assert sp["steps"] > 0 and sp["drafts_accepted"] > 0
        assert sp["dispatches"] == sp["fetches"] == sp["steps"]
    else:
        dc = stats["decode-chunks"]
        assert dc["dispatched"] > 0 and dc["host_fetches_per_chunk"] == 1.0
        assert "speculative" not in stats
    assert stats["completed"] == len(requests) and stats["active"] == 0


def test_streaming_callbacks_tile_the_text():
    """on_chunk deltas concatenate to the final text (stop match held back
    and cut); on_token fires once per emitted token, the last one final."""
    cfg = ServingConfig.from_dict({**BASE, **PAGED})
    chunks, token_events = [], []

    async def main():
        engine = TorchServingEngine(cfg, device="cpu")
        try:
            plain = await engine.generate("stream me", {"max-tokens": 12})
            stop = plain["text"][3:5] or plain["text"][:1]
            result = await engine.generate(
                "stream me", {"max-tokens": 12, "stop": stop},
                on_token=lambda t, lp, last: token_events.append(last),
                on_chunk=lambda toks, text, final: chunks.append((toks, text, final)),
            )
            return plain, stop, result
        finally:
            await engine.close()

    plain, stop, result = asyncio.run(main())
    assert "".join(text for _, text, _ in chunks) == result["text"]
    assert sum(len(toks) for toks, _, _ in chunks) == len(result["tokens"])
    assert chunks[-1][2] and not any(final for _, _, final in chunks[:-1])
    assert token_events[-1] and not any(token_events[:-1])
    if stop:
        assert stop not in result["text"]
        assert plain["text"].startswith(result["text"])


def test_engine_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchServingEngine(ServingConfig())


@pytest.mark.parametrize(
    "overrides,match",
    [
        # a mesh is served since the multi-GPU slice (tests/test_torch_tp.py,
        # tests/test_torch_lockstep.py), an sp axis since the sequence-
        # parallel slice (tests/test_torch_ring.py): these two cases keep
        # their ids and check that sp is no longer refused by name, only
        # by the mesh's own count of ranks (one process is no world of 2)
        pytest.param({"mesh": {"sp": 2}}, "sp", id="overrides0-13b"),
        pytest.param({"model": "moe-tiny", "mesh": {"ep": 2, "sp": 2, "tp": 1}}, "sp",
                     id="overrides1-13b"),
        # kv-quantize: int8 on the dense layout is served since the slice
        # of the Prometheus plane (CONFIGS["dense-int8-kv"] above)
        # adapter-store is served since the multi-LoRA slice
        # (tests/test_torch_lora_engine.py); on this dense layout it is the
        # JAX engine's ValueError, not a NotImplementedError
        pytest.param({"adapter-store": {"rank": 4}}, "adapter-store requires kv-layout=paged",
                     id="overrides3-adapter-store"),
        # prefix-store and pool-role are served since the KV-tiers slice
        # (tests/test_torch_prefixstore.py, test_torch_kvtransfer.py); the
        # cases after them keep their ids. faults and journal-dir are served
        # since the device-survival slice (tests/test_torch_faults.py,
        # test_torch_journal.py): their cases hold the armed engine to the
        # JAX engine's. incident-dir is served since the request-evidence
        # slice (tests/test_torch_incident.py): its case serves a request
        # and captures a bundle on both engines
        pytest.param({"faults": [{"site": "prefill"}]}, "faults", id="overrides6-faults"),
        pytest.param({"journal-dir": "j"}, "journal-dir", id="overrides7-journal-dir"),
        pytest.param({"incident-dir": "i"}, "incident-dir", id="overrides8-incident-dir"),
    ],
)
def test_unsupported_settings_raise_naming_the_roadmap(overrides, match, tmp_path):
    jax_overrides = overrides
    if "journal-dir" in overrides:
        overrides = jax_overrides = {"journal-dir": str(tmp_path / overrides["journal-dir"])}
    if "incident-dir" in overrides:
        # one directory per engine: each recorder numbers its own bundles
        overrides = {"incident-dir": str(tmp_path / "port")}
        jax_overrides = {"incident-dir": str(tmp_path / "jax")}
    cfg = ServingConfig.from_dict({"model": "tiny", **overrides})
    if match in ("faults", "journal-dir", "incident-dir"):
        port = TorchServingEngine(cfg, device="cpu")
        jax = TpuServingEngine(JaxServingConfig.from_dict({"model": "tiny", **jax_overrides}))
        try:
            if match == "faults":
                assert port.survival_section()["faults"] == jax.survival_section()["faults"]
                assert port.config.faults == tuple(
                    FaultPlan.from_dict(p) for p in overrides["faults"])
            elif match == "journal-dir":
                assert port.journal.path == jax.journal.path
                assert port.journal.pending() == jax.journal.pending() == []
            else:
                async def serve_and_capture(engine):
                    try:
                        got = await engine.generate("hello", {"max-tokens": 3})
                        engine._incident_capture("health-degraded", {"source": "test"})
                        assert engine.incidents.flush(5.0)
                        return got, engine.stats()["incidents"], engine.incidents.list()
                    finally:
                        await engine.close()

                runs = [asyncio.run(serve_and_capture(engine)) for engine in (port, jax)]
                for got, stats, _ in runs:
                    assert len(got["tokens"]) == 3 and stats["written"] == 1
                assert [b["id"] for b in runs[0][2]] == [b["id"] for b in runs[1][2]] == [
                    "incident-000001-health-degraded"]
                assert (tmp_path / "port" / "incident-000001-health-degraded.json").exists()
        finally:
            asyncio.run(port.close())
            asyncio.run(jax.close())
            TpuServingEngine.reset_instances()
        return
    if match == "sp":
        ranks = int(np.prod(list(overrides["mesh"].values())))
        with pytest.raises(ValueError, match=f"needs {ranks} devices, have 1"):
            TorchServingEngine(cfg, device="cpu")
        return
    if "adapter-store" in overrides:
        with pytest.raises(ValueError, match=match):
            TorchServingEngine(cfg, device="cpu")
        with pytest.raises(ValueError, match=match):
            TpuServingEngine(JaxServingConfig.from_dict({"model": "tiny", **overrides}))
        return
    with pytest.raises(NotImplementedError, match=match) as info:
        TorchServingEngine(cfg, device="cpu")
    assert "ROADMAP.md" in str(info.value)


def test_speculative_drafts_need_the_paged_layout():
    """As in the JAX engine: the verify step commits through the paged
    continuation path, so a dense layout is a ValueError."""
    cfg = ServingConfig.from_dict({"model": "tiny", "speculative-drafts": 4})
    with pytest.raises(ValueError, match="speculative-drafts requires kv-layout=paged"):
        TorchServingEngine(cfg, device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        TpuServingEngine(JaxServingConfig.from_dict({"model": "tiny",
                                                     "speculative-drafts": 4}))


def test_serving_config_parses_the_jax_keys():
    """Every key both packages know parses to the same value."""
    d = {"model": "llama3-8b", "quantize": "int8", "slots": 64,
         "max-seq-len": 2048, "decode-chunk": 32, "kv-layout": "paged",
         "kv-quantize": "int8", "prefix-cache": "false", "kv-block-size": 32,
         "kv-pool-blocks": 900, "prefill-batch": 4, "max-tokens": 77, "seed": 9,
         "decode-chunk-light": 4, "light-load-slots": 2, "pipeline": "false",
         "warmup-on-start": "true", "model-dtype": "bfloat16"}
    j, t = JaxServingConfig.from_dict(d), ServingConfig.from_dict(d)
    for field in ("model", "quantize", "slots", "max_seq_len", "decode_chunk",
                  "kv_layout", "kv_quantize", "prefix_cache", "kv_block_size",
                  "kv_pool_blocks", "kv_pool_fraction", "prefill_batch",
                  "default_max_tokens", "seed", "decode_chunk_light",
                  "light_load_slots", "pipeline", "warmup_on_start", "model_dtype",
                  "paged_kernel", "dense_kernel", "speculative_drafts",
                  "prefill_chunk", "pool_role", "streaming", "journal_dir"):
        assert getattr(t, field) == getattr(j, field), field
    defaults_j, defaults_t = JaxServingConfig(), ServingConfig()
    for field in ("slots", "max_seq_len", "decode_chunk", "prefill_batch",
                  "kv_block_size", "kv_pool_fraction", "default_max_tokens",
                  "prefix_cache", "kv_layout"):
        assert getattr(defaults_t, field) == getattr(defaults_j, field), field


# ---------------------------------------------------------------------------
# the port imports nothing of JAX
# ---------------------------------------------------------------------------


def _port_modules():
    pkg = REPO / "langstream_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py")
    )


def test_importing_the_port_loads_no_jax():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'langstream_tpu' or m.startswith('langstream_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(mods) >= 24
    # the request-evidence and cross-replica modules are among those checked,
    # and the deadline helpers live only in serving/handoff.py
    assert {"langstream_tpu_torch.core.tracing", "langstream_tpu_torch.serving.journey",
            "langstream_tpu_torch.serving.incident",
            "langstream_tpu_torch.serving.handoff"} <= set(mods)
    assert "langstream_tpu_torch.serving.deadline" not in mods


def test_port_sources_import_no_jax():
    files = list((REPO / "langstream_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "langstream_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}: {n}")
    assert offenders == []
