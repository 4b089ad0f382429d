"""Shared machinery for the calibration-based pruning methods (port of
``repro.core.pruning.common``: statistics and the single-stream walk).

The hidden stream is propagated block by block over the calibration set
in microbatches; the per-linear input activations are tapped
(``sparsity/taps.py``) and per-leaf statistics accumulated in f32:

    n        total tokens seen
    sum      sum_t X[t]      (R,)
    sumsq    sum_t X[t]^2    (R,)   -- Wanda's ||X_j||_2^2

The sums are taken in another order than XLA's, so a score that sits on
its comparison group's threshold can land on the other side of it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import reconstruction as R
from repro_torch.sparsity.taps import dense_taps


def tap_key(path_names: Tuple[str, ...]) -> str:
    """Map a block-param leaf path to its taps-dict key."""
    return "/".join(path_names[-2:])


@dataclasses.dataclass
class LeafStats:
    n: float
    sum: torch.Tensor    # (R,)
    sumsq: torch.Tensor  # (R,)

    @property
    def col_norm(self):
        return torch.sqrt(self.sumsq.clamp_min(0.0))


def _acc_stats(x: torch.Tensor) -> LeafStats:
    """x: (T, R) activation matrix for one microbatch."""
    x32 = x.float()
    return LeafStats(float(x.shape[0]), x32.sum(dim=0), x32.square().sum(dim=0))


def _merge(a: Optional[LeafStats], b: LeafStats) -> LeafStats:
    if a is None:
        return b
    return LeafStats(a.n + b.n, a.sum + b.sum, a.sumsq + b.sumsq)


def collect_block_stats(model, bp, block_index: int, h_mb: List[torch.Tensor],
                        pos_mb: List[torch.Tensor]) -> Dict[str, LeafStats]:
    """Run the taps over each microbatch of the stream; accumulate stats."""
    stats: Dict[str, LeafStats] = {}
    for h, pos in zip(h_mb, pos_mb):
        for key, x in dense_taps(bp, model.cfg, h, pos).items():
            stats[key] = _merge(stats.get(key), _acc_stats(x))
    return stats


def stats_for_leaf(stats: Dict[str, LeafStats], names: Tuple[str, ...]) -> Optional[LeafStats]:
    k2 = tap_key(names)
    if k2 in stats:
        return stats[k2]
    return stats.get(names[-1])


def _make_batches(calib: np.ndarray, microbatch: int, device) -> List[Dict[str, torch.Tensor]]:
    return [{"tokens": torch.as_tensor(calib[s:s + microbatch], device=device)}
            for s in range(0, calib.shape[0], microbatch)]


def walk_blocks(model, params, calib: np.ndarray, visit_fn: Callable, microbatch: int = 8,
                params_student=None, masks=None):
    """Block-by-block calibration walk, single stream (the Wanda/SparseGPT
    convention: the stream advances through the already-updated blocks).

    ``visit_fn(i, bp, ctx)`` returns the block's new params or None; ctx
    holds ``h_mb``, ``pos_mb`` and ``site``. With ``masks`` (a full mask
    tree the visitor fills in), each advance runs the block's masked
    linears through the masked matmul kernel. The reference also hands
    each visit ``target_mb``, the dense block's output on the same input;
    no ported visitor reads it, so the port does not compute it. Returns
    the updated params (``params_student``, updated in place).
    """
    out_params = params_student if params_student is not None else params
    device = params["embed"]["tok"].device
    batch_all = _make_batches(calib, microbatch, device)
    return _walk_blocks_lists(model, out_params, batch_all, visit_fn, masks)


def _walk_blocks_lists(model, out_params, batch_all, visit_fn, masks):
    for seg in R.execution_plan(model):
        hs_mb, pos_mb = [], []
        for b in batch_all:
            h, pos = seg.h0(out_params, b)
            hs_mb.append(h)
            pos_mb.append(pos)
        for (i, site) in seg.visits:
            bp = model.get_block(out_params, i)
            new_bp = visit_fn(i, bp, dict(h_mb=hs_mb, pos_mb=pos_mb, site=site))
            if new_bp is not None:
                out_params = model.set_block(out_params, i, new_bp)
                bp = model.get_block(out_params, i)
            mb = model.get_block(masks, i) if masks is not None else None
            hs_mb = [R.advance_with(model, out_params, i, bp, h, p, mb)
                     for h, p in zip(hs_mb, pos_mb)]
    return out_params
