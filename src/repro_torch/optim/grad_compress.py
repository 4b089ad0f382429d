"""Gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Top-k sparsification per leaf with an error-feedback accumulator (Stich et
al. 2018): the residual that was not sent is added back into the next
step's gradient. The train step uses it when ``compress_ratio < 1``. The
compressed gradient stays dense-shaped (the kept values in place, zeros
elsewhere); the payload a collective would carry, values and indices of
the kept slots, is what :func:`compressed_bytes` counts.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T

MIN_SIZE = 1024  # smaller leaves pass through uncompressed


def init_error_state(params) -> Any:
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params)


def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """1 where |x| is at least the k-th largest |x| (ties all kept)."""
    flat = x.reshape(-1).abs()
    thresh = torch.kthvalue(flat, flat.numel() - k + 1).values
    return (x.abs() >= thresh).to(x.dtype)


def compress_leaf(g: torch.Tensor, err: torch.Tensor,
                  ratio: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (the sparse gradient to send, in g's dtype; the new f32
    residual)."""
    if g.numel() < MIN_SIZE or ratio >= 1.0:
        return g, err
    g32 = g.to(torch.float32) + err
    k = max(1, int(g.numel() * ratio))
    sent = g32 * _topk_mask(g32, k)
    return sent.to(g.dtype), g32 - sent


@torch.no_grad()
def compress(grads, err_state, ratio: float):
    """Tree-wide top-k with error feedback. Returns (grads to send, new
    residuals)."""
    pairs = T.tree_map(lambda g, e: compress_leaf(g, e, ratio), grads, err_state)
    return T.tree_map(lambda pr: pr[0], pairs), T.tree_map(lambda pr: pr[1], pairs)


def compressed_bytes(params, ratio: float) -> int:
    """Collective payload estimate: values (4 B) and indices (4 B) per kept
    slot; a leaf that passes through counts 4 B per element."""
    total = 0
    for _, p in T.leaves_with_path(params):
        if p.numel() < MIN_SIZE or ratio >= 1.0:
            total += p.numel() * 4
        else:
            total += int(p.numel() * ratio) * 8
    return total
