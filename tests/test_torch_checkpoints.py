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


# ---------------------------------------------------------------------------
# the writers, across packages both ways
# ---------------------------------------------------------------------------


def _writer_case(kind: str):
    """(JAX tree, port tree on its numpy, JAX config, port config, JAX
    writer and loader, port writer) of a tiny f32 model."""
    import jax

    from langstream_tpu.models import moe as jm
    from langstream_tpu_torch.models import moe as tm
    from langstream_tpu_torch.models.convert import params_from_numpy
    from test_torch_engine import flatten_jax_params

    if kind == "llama":
        jc, tc = jl.LlamaConfig.tiny(128), tl.LlamaConfig.tiny(128)
        tree = jl.init_llama_params(jc, jax.random.PRNGKey(3))
        jax_io = (jck.save_llama_checkpoint, jck.load_llama_checkpoint)
        port_save = tck.save_llama_checkpoint
    else:
        jc, tc = jm.MoEConfig.tiny(128), tm.MoEConfig.tiny(128)
        tree = jm.init_moe_params(jc, jax.random.PRNGKey(3))
        jax_io = (jck.save_moe_checkpoint, jck.load_moe_checkpoint)
        port_save = tck.save_moe_checkpoint
    port_tree = params_from_numpy(flatten_jax_params(tree), device="cpu",
                                  dtype=torch.float32)
    return tree, port_tree, jc, tc, jax_io, port_save


@pytest.mark.parametrize("kind", ["llama", "moe"])
def test_port_writer_is_read_by_the_jax_loader(kind, tmp_path):
    """The port writes, the JAX loader reads: every tensor equals the
    source; the port's own loader reads it back to the port's tree."""
    tree, port_tree, jc, tc, (_, jax_load), port_save = _writer_case(kind)
    port_save(port_tree, tc, str(tmp_path))
    _assert_trees_equal(tree, jax_load(str(tmp_path), jc))
    port_load = tck.load_llama_checkpoint if kind == "llama" else tck.load_moe_checkpoint
    _assert_trees_equal(tree, port_load(str(tmp_path), tc))


@pytest.mark.parametrize("kind", ["llama", "moe"])
def test_both_writers_write_the_same_files(kind, tmp_path):
    """The same params through both writers: state dicts equal tensor for
    tensor (names, order, f32, values) and ``config.json`` equal key for
    key."""
    import json

    tree, port_tree, jc, tc, (jax_save, _), port_save = _writer_case(kind)
    jax_save(tree, jc, str(tmp_path / "jax"))
    port_save(port_tree, tc, str(tmp_path / "port"))
    want = torch.load(tmp_path / "jax" / "pytorch_model.bin", weights_only=True)
    got = torch.load(tmp_path / "port" / "pytorch_model.bin", weights_only=True)
    assert list(got) == list(want)
    for name, tensor in want.items():
        assert got[name].dtype == tensor.dtype == torch.float32, name
        assert torch.equal(got[name], tensor), name
    configs = [json.loads((tmp_path / p / "config.json").read_text()) for p in ("jax", "port")]
    assert configs[1] == configs[0] and list(configs[1]) == list(configs[0])


def test_writers_refuse_a_quantized_tree_as_jax(tmp_path):
    from langstream_tpu.models.quant import quantize_llama_params as jax_quantize
    from langstream_tpu_torch.models.quant import quantize_llama_params

    tree, port_tree, jc, tc, (jax_save, _), port_save = _writer_case("llama")
    with pytest.raises(TypeError):
        jax_save(jax_quantize(tree), jc, str(tmp_path / "jax"))
    with pytest.raises(TypeError, match="float parameters"):
        port_save(quantize_llama_params(port_tree), tc, str(tmp_path / "port"))
    assert not (tmp_path / "port").exists()
