"""Carry parameters across from the JAX package.

:func:`params_from_numpy` takes the JAX parameter tree after ``np.asarray``
on every leaf — each ``QTensor`` leaf arriving as ``{"q": int8, "s": f32}``
— and returns the port's tree. The helper that flattens a JAX tree into
that numpy form lives with the tests, because this package must not import
the JAX package's ``QTensor``.
"""

from __future__ import annotations

import numpy as np
import torch

from langstream_tpu_torch._device import require_device
from langstream_tpu_torch.models.quant import QTensor


def tensor_from_numpy(a: np.ndarray, *, device="cuda") -> torch.Tensor:
    """numpy → torch on ``device`` (the card unless the caller asks for the
    CPU), bfloat16 included: ``np.asarray`` of a JAX bf16 array has the
    ``ml_dtypes`` bfloat16 dtype, which ``torch.from_numpy`` refuses, so its
    bits pass through as uint16."""
    device = require_device(device, "tensor_from_numpy")
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, *, device="cuda", dtype: torch.dtype | None = None):
    """Port a numpy parameter tree onto ``device`` (the card unless the
    caller asks for the CPU). ``{"q", "s"}`` leaves become
    :class:`QTensor` (dequantizing to ``dtype``, default bfloat16); other
    leaves become tensors, cast to ``dtype`` when given, except a MoE
    tree's ``router``, which stays float32 (a rounded router flips routing
    decisions)."""
    device = require_device(device, "params_from_numpy")
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        return QTensor(
            q=tensor_from_numpy(tree["q"], device=device),
            s=tensor_from_numpy(tree["s"], device=device),
            dtype=dtype or torch.bfloat16,
        )
    if isinstance(tree, dict):
        return {
            name: params_from_numpy(
                leaf, device=device, dtype=None if name == "router" else dtype)
            for name, leaf in tree.items()
        }
    t = tensor_from_numpy(tree, device=device)
    return t.to(dtype) if dtype is not None else t
