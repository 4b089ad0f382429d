"""Plain PyTorch version of the masked matmul kernel."""
from __future__ import annotations

import torch


def masked_matmul_plain(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """out = x @ (w ⊙ m), the mask multiplied in w's dtype, accumulated in
    f32 and cast back to x.dtype (``repro.kernels.masked_matmul.ref``)."""
    wm = w * m.to(w.dtype)
    return torch.matmul(x.float(), wm.float()).to(x.dtype)
