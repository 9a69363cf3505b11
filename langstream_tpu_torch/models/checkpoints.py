"""Checkpoint loading (port of the loaders of
``langstream_tpu/models/checkpoints.py``).

Reads a local HF-format directory (``*.safetensors`` or
``pytorch_model*.bin``, standard Llama or Mixtral tensor names, with or
without the ``model.`` prefix) into the port's stacked-layer tree:
``(L, in, out)`` matrices, ``(L, hidden)`` norms, and for Mixtral ``(L, E,
in, out)`` experts and a float32 ``(L, hidden, E)`` router. Nothing is
downloaded. A missing directory or missing weight files raise
``FileNotFoundError``; the caller never falls back to random weights. The
writer (``save_moe_checkpoint``) is not ported.
"""

from __future__ import annotations

from pathlib import Path

import torch

from langstream_tpu_torch.models.llama import LlamaConfig
from langstream_tpu_torch.models.moe import MoEConfig


def _load_state_dict(path: Path) -> dict[str, torch.Tensor]:
    if not path.is_dir():
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    safetensors = sorted(path.glob("*.safetensors"))
    if safetensors:
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(
                "checkpoint is in safetensors format but the safetensors "
                f"library is unavailable: {e}"
            ) from e
        state: dict[str, torch.Tensor] = {}
        for f in safetensors:
            state.update(load_file(str(f), device="cpu"))
        return state
    bins = sorted(path.glob("pytorch_model*.bin"))
    if bins:
        state = {}
        for f in bins:
            state.update(torch.load(str(f), map_location="cpu", weights_only=True))
        return state
    raise FileNotFoundError(f"no weight files under {path}")


# HF name and whether it is stored (out, in) and needs a transpose
_ATTN_NAMES = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
}
_MLP_NAMES = {
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}


def _getter(state: dict):
    """Resolve a tensor by name, tolerating the ``model.`` prefix."""

    def g(name: str) -> torch.Tensor:
        return state[name if name in state else f"model.{name}"]

    return g


def _stack_layers(g, fmt: str, layers: int, dtype: torch.dtype,
                  transpose: bool = True) -> torch.Tensor:
    """One tensor per layer, stacked on a leading L axis and cast to
    ``dtype`` after stacking (the JAX loader's order: one rounding)."""
    mats = [g(fmt.format(i=i)) for i in range(layers)]
    return torch.stack([m.T if transpose else m for m in mats]).to(dtype).contiguous()


def _load_head_tensors(state: dict, g, dtype: torch.dtype) -> dict:
    """Embedding, final norm and LM head (tied to the embedding when the
    checkpoint has no ``lm_head.weight``), the head as ``(hidden, vocab)``."""
    lm_head = state.get("lm_head.weight", g("embed_tokens.weight"))
    return {
        "embed": g("embed_tokens.weight").to(dtype).contiguous(),
        "final_norm": g("norm.weight").to(dtype).contiguous(),
        "lm_head": lm_head.T.to(dtype).contiguous(),
    }


def load_llama_checkpoint(checkpoint_dir: str, config: LlamaConfig) -> dict:
    """The port's parameter tree from an HF-format Llama directory, on the
    CPU in ``config.dtype`` (the engine moves it to its device and
    quantizes it)."""
    state = _load_state_dict(Path(checkpoint_dir))
    g = _getter(state)
    head = _load_head_tensors(state, g, config.dtype)
    return {
        "embed": head["embed"],
        "layers": {
            ours: _stack_layers(g, "layers.{i}." + hf, config.layers, config.dtype, t)
            for ours, (hf, t) in {**_ATTN_NAMES, **_MLP_NAMES}.items()
        },
        "final_norm": head["final_norm"],
        "lm_head": head["lm_head"],
    }


def load_moe_checkpoint(checkpoint_dir: str, config: MoEConfig) -> dict:
    """The port's MoE parameter tree from an HF-format Mixtral directory, on
    the CPU in ``config.dtype``: ``block_sparse_moe.experts.{e}.w1/w3/w2``
    become ``w_gate``/``w_up``/``w_down`` (transposed), each expert cast
    as it is read (a stacked f32 Mixtral projection would be ~60 GB of
    host memory); ``block_sparse_moe.gate`` becomes the float32 router."""
    state = _load_state_dict(Path(checkpoint_dir))
    c = config
    g = _getter(state)
    head = _load_head_tensors(state, g, c.dtype)

    def experts(w: str) -> torch.Tensor:
        return torch.stack([
            torch.stack([
                g(f"layers.{i}.block_sparse_moe.experts.{e}.{w}.weight").T.to(c.dtype)
                for e in range(c.experts)
            ])
            for i in range(c.layers)
        ]).contiguous()

    return {
        "embed": head["embed"],
        "layers": {
            **{ours: _stack_layers(g, "layers.{i}." + hf, c.layers, c.dtype, t)
               for ours, (hf, t) in _ATTN_NAMES.items()},
            "router": _stack_layers(g, "layers.{i}.block_sparse_moe.gate.weight",
                                    c.layers, torch.float32),
            "w_gate": experts("w1"),
            "w_up": experts("w3"),
            "w_down": experts("w2"),
        },
        "final_norm": head["final_norm"],
        "lm_head": head["lm_head"],
    }
