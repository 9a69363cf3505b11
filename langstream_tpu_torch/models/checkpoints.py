"""Checkpoint loading (port of the loaders of
``langstream_tpu/models/checkpoints.py``).

Reads a local HF-format directory (``*.safetensors`` or
``pytorch_model*.bin``, standard Llama or Mixtral tensor names, with or
without the ``model.`` prefix) into the port's stacked-layer tree:
``(L, in, out)`` matrices, ``(L, hidden)`` norms, and for Mixtral ``(L, E,
in, out)`` experts and a float32 ``(L, hidden, E)`` router. Nothing is
downloaded. A missing directory or missing weight files raise
``FileNotFoundError``; the caller never falls back to random weights.

The writers (:func:`save_llama_checkpoint`, :func:`save_moe_checkpoint`)
are the inverses, as the JAX package writes them: the HF tensor names
(with the ``model.`` prefix), ``(out, in)`` matrices, every tensor f32 in
one ``pytorch_model.bin`` written with ``torch.save``, and a minimal
``config.json``. They take a float parameter tree; a quantized one raises
``TypeError``, as the JAX writer does (write before quantizing).
"""

from __future__ import annotations

import json
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


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


def _host_f32(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """One tensor as a contiguous f32 CPU tensor, ``(out, in)`` when
    ``transpose``."""
    t = t.detach().to("cpu", torch.float32)
    return (t.T if transpose else t).contiguous()


def _check_float(params: dict) -> None:
    """Refuse a quantized tree before anything is written."""
    for leaf in [params["embed"], params["final_norm"], params["lm_head"],
                 *params["layers"].values()]:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(
                f"checkpoint writers take float parameters, not {type(leaf).__name__} "
                "(write the tree before quantizing it)")


def _head_state(params: dict) -> dict[str, torch.Tensor]:
    return {
        "model.embed_tokens.weight": _host_f32(params["embed"]),
        "model.norm.weight": _host_f32(params["final_norm"]),
        "lm_head.weight": _host_f32(params["lm_head"], transpose=True),
    }


def _config_json(c, **arch) -> str:
    return json.dumps({
        **{k: arch[k] for k in ("architectures", "model_type")},
        "vocab_size": c.vocab_size,
        "hidden_size": c.hidden,
        "num_hidden_layers": c.layers,
        "num_attention_heads": c.heads,
        "num_key_value_heads": c.kv_heads,
        "head_dim": c.head_dim,
        **{k: v for k, v in arch.items() if k not in ("architectures", "model_type")},
        "rope_theta": c.rope_theta,
        "rms_norm_eps": c.norm_eps,
        "max_position_embeddings": c.max_seq_len,
        "tie_word_embeddings": False,
        "torch_dtype": "float32",
    }, indent=2)


def save_llama_checkpoint(params: dict, config: LlamaConfig, checkpoint_dir: str) -> None:
    """Write the port's float Llama tree as an HF-format directory
    (``pytorch_model.bin`` + ``config.json``), the inverse of
    :func:`load_llama_checkpoint` and the JAX writer's output."""
    _check_float(params)
    path = Path(checkpoint_dir)
    path.mkdir(parents=True, exist_ok=True)
    c = config
    layers = params["layers"]
    state = _head_state(params)
    for i in range(c.layers):
        for ours, (hf, transpose) in {**_ATTN_NAMES, **_MLP_NAMES}.items():
            state[f"model.layers.{i}.{hf}"] = _host_f32(layers[ours][i], transpose)
    torch.save(state, path / "pytorch_model.bin")
    (path / "config.json").write_text(_config_json(
        c, architectures=["LlamaForCausalLM"], model_type="llama",
        intermediate_size=c.intermediate))


def save_moe_checkpoint(params: dict, config: MoEConfig, checkpoint_dir: str) -> None:
    """Write the port's float Mixtral tree as an HF-format directory: the
    router as ``block_sparse_moe.gate``, expert ``e``'s ``w_gate``/``w_up``/
    ``w_down`` as ``experts.{e}.w1``/``w3``/``w2``; the inverse of
    :func:`load_moe_checkpoint` and the JAX writer's output."""
    _check_float(params)
    path = Path(checkpoint_dir)
    path.mkdir(parents=True, exist_ok=True)
    c = config
    layers = params["layers"]
    state = _head_state(params)
    for i in range(c.layers):
        for ours, (hf, transpose) in _ATTN_NAMES.items():
            state[f"model.layers.{i}.{hf}"] = _host_f32(layers[ours][i], transpose)
        base = f"model.layers.{i}.block_sparse_moe"
        state[f"{base}.gate.weight"] = _host_f32(layers["router"][i], transpose=True)
        for e in range(c.experts):
            for ours, hf in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
                state[f"{base}.experts.{e}.{hf}.weight"] = _host_f32(
                    layers[ours][i, e], transpose=True)
    torch.save(state, path / "pytorch_model.bin")
    (path / "config.json").write_text(_config_json(
        c, architectures=["MixtralForCausalLM"], model_type="mixtral",
        intermediate_size=c.moe_intermediate, num_local_experts=c.experts,
        num_experts_per_tok=c.experts_per_token))
