"""PyTorch port of the EBFT reproduction, for NVIDIA Hopper.

It mirrors the JAX package ``repro`` module for module and imports none
of it. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU request it raises
(see :func:`resolve_device`). On a CPU tensor each kernel wrapper runs its
plain PyTorch version; on a CUDA tensor it launches the hand-written
kernel or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
