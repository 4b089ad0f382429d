"""The EBFT plateau predicate (port of the part of
``repro.optim.schedules`` the tuning slice reads; the warmup schedules
wait for pretraining, the device predicate for a CUDA graph of the epoch
loop)."""
from __future__ import annotations


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
