"""Plain PyTorch versions of the masked matmul kernel and its gradients."""
from __future__ import annotations

import torch


def _acc(t: torch.Tensor) -> torch.Tensor:
    """Upcast to the f32 accumulator type (f64 stays f64, for gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def masked_matmul_plain(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """out = x @ (w ⊙ m), the mask multiplied in w's dtype, accumulated in
    f32 and cast back to x.dtype (``repro.kernels.masked_matmul.ref``)."""
    wm = w * m.to(w.dtype)
    return torch.matmul(_acc(x), _acc(wm)).to(x.dtype)


def masked_matmul_dx_plain(dy: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """dx = dy @ (w ⊙ m)ᵀ, accumulated in f32, in dy's dtype."""
    wm = w * m.to(w.dtype)
    return torch.matmul(_acc(dy), _acc(wm).T).to(dy.dtype)


def masked_matmul_dw_plain(x: torch.Tensor, dy: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """dw = (xᵀ @ dy) ⊙ m, accumulated in f32, in x's dtype; exactly 0
    wherever the mask is 0."""
    g = torch.matmul(_acc(x).T, _acc(dy))
    return torch.where(m != 0, g, torch.zeros_like(g)).to(x.dtype)


def masked_matmul_dm_plain(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dm = (xᵀ @ dy) ⊙ w, the gradient of ``x @ (w ⊙ m)`` with respect to
    the mask: accumulated in f32, multiplied by w in f32, one rounding to
    x's dtype; pruned slots are not zeroed."""
    g = torch.matmul(_acc(x).T, _acc(dy))
    return (g * _acc(w)).to(x.dtype)
