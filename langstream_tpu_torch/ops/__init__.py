"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their plain
PyTorch versions. Each wrapper launches its kernel for CUDA tensors (or
raises) and takes its plain version only for CPU tensors.

The kernels have no backward (nor have the JAX package's: it defines no
``custom_vjp``), so on the card a wrapper whose inputs would carry a
gradient raises (:func:`refuse_grad`) rather than return an output cut
from the graph; the serving paths run under ``no_grad``, and training
attends through the plain PyTorch functions of ``parallel/ring.py``.
"""

from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` when autograd would record ``kernel``'s call:
    grad mode is on and a tensor among ``tensors`` (dicts of tensors too,
    as int8 pools are) requires grad."""
    if not torch.is_grad_enabled():
        return
    flat = [t for x in tensors for t in (x.values() if isinstance(x, dict) else (x,))]
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and its inputs require "
            f"grad; call it under torch.no_grad() (serving does), or train through "
            f"the plain attention of parallel/ring.py")


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launches in this process, by kernel name."""
    from langstream_tpu_torch.ops.flash_attention import flash_attention
    from langstream_tpu_torch.ops.paged_attention import (
        _paged_attention_partial_q8,
        paged_attention_multiquery_partial,
        paged_attention_partial,
    )

    return {
        "flash_attention": flash_attention.launches,
        "paged_attention": paged_attention_partial.launches,
        "paged_attention_q8": _paged_attention_partial_q8.launches,
        "paged_attention_multiquery": paged_attention_multiquery_partial.launches,
    }
