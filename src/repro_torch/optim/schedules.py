"""Learning-rate schedules and the EBFT plateau predicate (port of
``repro.optim.schedules``).

A schedule is a plain callable ``step -> lr``: it takes the int32 step
tensor that ``optimizers._lr_at`` passes (or a Python int) and returns a 0-d
f32 tensor on the step's device, so an optimizer update makes no host
round-trip.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    """Linear warmup to ``peak`` over ``warmup`` steps then cosine to floor."""

    def f(step):
        step = _step(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)

    return f


def linear_decay(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(step):
        step = _step(step)
        warm = peak * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        lin = peak + (floor - peak) * t
        return torch.where(step < warmup, warm, lin)

    return f


def plateau_early_stop(history, patience: int = 3, rel_tol: float = 1e-3) -> bool:
    """Host-side convergence check of the EBFT per-block loop (the paper's
    "loss unchanged or changes within a small range" criterion).

    ``history`` is a list of float losses; returns True when the best loss
    has not improved by ``rel_tol`` (relative) for ``patience`` epochs.
    Degenerate inputs (empty history, ``patience`` longer than the history,
    non-positive ``patience``) never stop.
    """
    if patience <= 0 or len(history) < patience + 1:
        return False
    best_before = min(history[:-patience])
    recent_best = min(history[-patience:])
    return recent_best > best_before * (1.0 - rel_tol)


def plateau_early_stop_device(hist: torch.Tensor, n, patience: int,
                              rel_tol: float) -> torch.Tensor:
    """:func:`plateau_early_stop` on ``hist[:n]`` as a 0-d bool tensor on
    ``hist``'s device, with no host sync: ``hist`` is a fixed-size f32
    buffer whose first ``n`` entries are valid, and ``n`` may be a tensor.
    The same answers, degenerate cases included."""
    if patience <= 0:
        return torch.zeros((), dtype=torch.bool, device=hist.device)
    n = torch.as_tensor(n, device=hist.device).to(torch.int32)
    idx = torch.arange(hist.shape[0], dtype=torch.int32, device=hist.device)
    inf = torch.full((), math.inf, dtype=hist.dtype, device=hist.device)
    best_before = torch.where(idx < n - patience, hist, inf).min()
    recent = (idx >= n - patience) & (idx < n)
    recent_best = torch.where(recent, hist, inf).min()
    fire = recent_best > best_before * (1.0 - rel_tol)
    return fire & (n >= patience + 1)
