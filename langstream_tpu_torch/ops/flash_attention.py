"""Blocked (flash) GQA attention for prefill (port of
``langstream_tpu/ops/flash_attention.py``).

:func:`flash_attention` launches the CUDA kernel ``csrc/flash_attention.cu``
for tensors on the card and takes :func:`flash_attention_reference`, its
plain PyTorch version, for tensors on the CPU. Layout ``(B, S, H, D)``;
``H`` may be a multiple of ``Kh`` (query head ``h`` reads KV head
``h // (H // Kh)``). No block padding is needed: the kernels mask the
ragged edge themselves. bfloat16 at head_dim 64 and 128 (the served
models) runs on the tensor cores (wgmma); float32, and head_dim 16, run
the f32 FMA kernel (see :func:`flash_kernel_route`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from langstream_tpu_torch.ops import refuse_grad
from langstream_tpu_torch.ops._build import load_library

NEG_INF = float(torch.finfo(torch.float32).min)
#: 128 and 64 are the served models' widths; 16 is the tiny test model's
HEAD_DIMS = (16, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: kernel codes of ``flash_attention_fwd``
_KERNEL_CODES = {"fma": 0, "wgmma": 1}


def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def flash_kernel_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which CUDA kernel serves a call: ``"wgmma"`` (tensor cores, bf16 in,
    f32 accumulate) for bfloat16 at head_dim 64 or 128, else ``"fma"``
    (f32 FMA tiles: a TF32 product would miss the f32 tolerance)."""
    if dtype == torch.bfloat16 and head_dim in (64, 128):
        return "wgmma"
    return "fma"


def flash_attention_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Kh, D)
    v: torch.Tensor,  # (B, Sk, Kh, D)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of the kernel: dense GQA attention with f32 scores,
    softmax and value sum, output in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Kh, G, D).to(torch.float32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32)) * scale
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Sk, device=q.device)[None, :]
        scores = scores.masked_fill(~(rows >= cols), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _check(q, k, v):
    if not (k.is_cuda and v.is_cuda and k.device == q.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on the same CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the "
            f"kernel takes one of {sorted(map(str, _DTYPE_CODES))} for all three"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}; want (B,S,H,D) and (B,S,Kh,D)"
        )
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} does not match k "
            f"{tuple(k.shape)} (batch, head_dim, or H not a multiple of Kh)"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if flash_kernel_route(q.dtype, D) == "wgmma" and max(q.numel(), k.numel()) >= 2**31:
        raise ValueError(
            "flash_attention: the tensor-core kernel takes tensors of fewer "
            "than 2^31 elements (32-bit offsets)"
        )


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, Kh, D)
    v: torch.Tensor,  # (B, Sk, Kh, D)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Flash attention over ``(batch, seq, heads, head_dim)`` tensors:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Under a mesh each rank calls it on its own heads (heads on ``tp``) and
    its replica's rows (the engine splits the batch over ``dp``). The
    kernel has no backward: on the card, inputs that require grad under
    grad mode raise ``RuntimeError`` (:func:`~langstream_tpu_torch.ops.refuse_grad`)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if causal and Sq != Sk:
        raise ValueError(
            f"causal flash attention expects self-attention (Sq == Sk), got "
            f"{Sq} vs {Sk}"
        )
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, k.shape[2], D, _DTYPE_CODES[q.dtype], scale,
        int(causal), _KERNEL_CODES[flash_kernel_route(q.dtype, D)],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (CUDA error {rc})")
    flash_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
