"""The device rule of the port: entry points run on the card unless the
caller asks for the CPU, and never fall back on their own."""

from __future__ import annotations

import torch


def require_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a usable card
    raises ``RuntimeError`` naming ``what`` (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the card: torch.cuda is not available here "
            f"(pass device='cpu' to run the plain versions)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {device!r}")
    return dev
