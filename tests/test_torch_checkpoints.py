"""The port's Llama checkpoint loader against the JAX package's, and the
engine's ``checkpoint:`` key against the JAX engine's, on the in-repo HF
fixture (``tests/fixtures/llama_tiny_golden``)."""

import dataclasses
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langstream_tpu.models import checkpoints as jck
from langstream_tpu.models import llama as jl
from langstream_tpu.models.quant import QTensor as JaxQTensor
from langstream_tpu.serving.engine import (
    ServingConfig as JaxServingConfig,
    TpuServingEngine,
)
from langstream_tpu_torch.models import checkpoints as tck
from langstream_tpu_torch.models import llama as tl
from langstream_tpu_torch.models.quant import QTensor
from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

FIXTURES = Path(__file__).parent / "fixtures" / "llama_tiny_golden"


def _flat(tree, prefix=""):
    if isinstance(tree, (JaxQTensor, QTensor)):
        yield prefix + "q", tree.q
        yield prefix + "s", tree.s
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    else:
        yield prefix, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _assert_trees_equal(jax_tree, port_tree):
    want, got = dict(_flat(jax_tree)), dict(_flat(port_tree))
    assert want.keys() == got.keys()
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loader_matches_jax_loader(dtype):
    """Every tensor equal, bf16 rounding included (one cast after
    stacking in both)."""
    jc = dataclasses.replace(jl.LlamaConfig.tiny(128), dtype=getattr(jnp, dtype))
    tc = dataclasses.replace(tl.LlamaConfig.tiny(128), dtype=getattr(torch, dtype))
    got = tck.load_llama_checkpoint(str(FIXTURES), tc)
    _assert_trees_equal(jck.load_llama_checkpoint(str(FIXTURES), jc), got)
    assert all(t.device.type == "cpu" and t.dtype == tc.dtype for _, t in _flat(got))


def test_missing_checkpoint_raises_file_not_found(tmp_path):
    tc = tl.LlamaConfig.tiny(128)
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        tck.load_llama_checkpoint(str(tmp_path / "absent"), tc)
    with pytest.raises(FileNotFoundError, match="no weight files"):
        tck.load_llama_checkpoint(str(tmp_path), tc)
    # the engine never falls back to random weights
    cfg = ServingConfig.from_dict({"model": "tiny", "checkpoint": str(tmp_path)})
    with pytest.raises(FileNotFoundError):
        TorchServingEngine(cfg, device="cpu")


def test_safetensors_checkpoint_matches_jax_loader(tmp_path):
    """The fixture's tensors rewritten as two safetensors shards (HF names
    without the ``model.`` prefix in one of them): both loaders agree."""
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file

    state = torch.load(FIXTURES / "pytorch_model.bin", map_location="cpu", weights_only=True)
    names = sorted(state)
    half = len(names) // 2
    save_file({k.removeprefix("model."): state[k].contiguous() for k in names[:half]},
              str(tmp_path / "model-00001.safetensors"))
    save_file({k: state[k].contiguous() for k in names[half:]},
              str(tmp_path / "model-00002.safetensors"))
    jc = dataclasses.replace(jl.LlamaConfig.tiny(128), dtype=jnp.float32)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(128), dtype=torch.float32)
    _assert_trees_equal(jck.load_llama_checkpoint(str(tmp_path), jc),
                        tck.load_llama_checkpoint(str(tmp_path), tc))


def test_safetensors_without_the_library_raises(tmp_path, monkeypatch):
    shutil.copy(FIXTURES / "pytorch_model.bin", tmp_path / "pytorch_model.bin")
    (tmp_path / "model.safetensors").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(RuntimeError, match="safetensors library is unavailable"):
        tck.load_llama_checkpoint(str(tmp_path), tl.LlamaConfig.tiny(128))


@pytest.mark.parametrize("settings", [
    {"model-dtype": "float32"},
    {"quantize": "int8"},  # bf16 load, then int8 quantization
], ids=["f32", "bf16-int8"])
def test_engine_checkpoint_params_match_jax_engine(settings):
    """``checkpoint:`` is live: the engine's weights equal the JAX engine's
    on the same directory, int8 scales and codes included."""
    cfg = {"model": "tiny", "max-seq-len": 128, "checkpoint": str(FIXTURES), **settings}
    want = TpuServingEngine(JaxServingConfig.from_dict(cfg)).params
    got = TorchServingEngine(ServingConfig.from_dict(cfg), device="cpu").params
    if "quantize" in settings:
        assert isinstance(got["layers"]["wq"], QTensor)
    _assert_trees_equal(want, got)
