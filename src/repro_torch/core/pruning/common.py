"""Shared machinery for the calibration-based pruning methods and EBFT
(port of ``repro.core.pruning.common``: statistics, the single-stream walk
of the pruning methods and the dual-stream walk of EBFT).

The hidden stream is propagated block by block over the calibration set
in microbatches; the per-linear input activations are tapped
(``sparsity/taps.py``) and per-leaf statistics accumulated in f32:

    n        total tokens seen
    sum      sum_t X[t]         (R,)   -- DSnoT's expected input (the mean)
    sumsq    sum_t X[t]^2       (R,)   -- Wanda's ||X_j||_2^2, FLAP's fluctuation
    hessian  sum_t X[t] X[t]^T  (R, R) -- SparseGPT's Gram (opt-in), in f64

The sums are taken in another order than XLA's, so a score that sits on
its comparison group's threshold can land on the other side of it. The
Gram is summed in f64 and rounded to f32 where SparseGPT takes it; the
reference sums it in f32. From there SparseGPT works in f32, as the
reference. On the card, a pretrained Llama-width block's f32 sum (the
GEMM's f32 accumulation over 16384 rows a microbatch) left a Gram further
from positive semi-definite than SparseGPT's 1% damping reaches, and its
Cholesky failed; the readings are in PERF.md (``chip_smoke.py``, path A).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import reconstruction as R
from repro_torch.sparsity import sparse_params as SP
from repro_torch.sparsity.taps import dense_taps


def tap_key(path_names: Tuple[str, ...]) -> str:
    """Map a block-param leaf path to its taps-dict key."""
    return "/".join(path_names[-2:])


def lookup_tap(taps: Dict[str, torch.Tensor], names: Tuple[str, ...]):
    k2 = tap_key(names)
    if k2 in taps:
        return taps[k2]
    return taps.get(names[-1])


def iter_prunable(block_params) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path_names, leaf) for every prunable leaf of a block."""
    return [(names, leaf) for names, leaf in T.leaves_with_path(block_params)
            if SP.is_prunable(names, leaf)]


@dataclasses.dataclass
class LeafStats:
    n: float
    sum: torch.Tensor    # (R,)
    sumsq: torch.Tensor  # (R,)
    hessian: Optional[torch.Tensor] = None  # (R, R)

    @property
    def mean(self):
        return self.sum / max(self.n, 1.0)

    @property
    def col_norm(self):
        return torch.sqrt(self.sumsq.clamp_min(0.0))

    @property
    def fluctuation(self):
        """sum_t (X[t] - mean)^2 per column (FLAP's variance mass)."""
        return (self.sumsq - self.n * torch.square(self.mean)).clamp_min(0.0)


def full_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 as the reference takes it: refuses to run where the
    card's f32 matmul is set to round its inputs to TF32."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("an f32 matmul of the pruning methods ran with TF32 allowed; "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    return a @ b


def _acc_stats(x: torch.Tensor, want_hessian: bool = False) -> LeafStats:
    """x: (T, R) activation matrix for one microbatch."""
    x32 = x.float()
    h = None
    if want_hessian:
        x64 = x.double()
        h = x64.T @ x64
    return LeafStats(float(x.shape[0]), x32.sum(dim=0), x32.square().sum(dim=0), h)


def _merge(a: Optional[LeafStats], b: LeafStats) -> LeafStats:
    if a is None:
        return b
    h = None
    if b.hessian is not None:
        h = b.hessian if a.hessian is None else a.hessian + b.hessian
    return LeafStats(a.n + b.n, a.sum + b.sum, a.sumsq + b.sumsq, h)


def collect_block_stats(model, bp, block_index: int, h_mb: List[torch.Tensor],
                        pos_mb: List[torch.Tensor],
                        want_hessian: bool = False) -> Dict[str, LeafStats]:
    """Run the taps over each microbatch of the stream; accumulate stats
    (with ``want_hessian``, each leaf's f64 Gram too)."""
    stats: Dict[str, LeafStats] = {}
    for h, pos in zip(h_mb, pos_mb):
        for key, x in dense_taps(bp, model.cfg, h, pos).items():
            stats[key] = _merge(stats.get(key), _acc_stats(x, want_hessian))
    return stats


def stats_for_leaf(stats: Dict[str, LeafStats], names: Tuple[str, ...]) -> Optional[LeafStats]:
    return lookup_tap(stats, names)


def _make_batches(calib: np.ndarray, microbatch: int, device) -> List[Dict[str, torch.Tensor]]:
    return [{"tokens": torch.as_tensor(calib[s:s + microbatch], device=device)}
            for s in range(0, calib.shape[0], microbatch)]


def walk_blocks(model, params, calib: np.ndarray, visit_fn: Callable, microbatch: int = 8,
                params_student=None, masks=None, dual_stream: bool = False):
    """Block-by-block calibration walk over per-microbatch lists.

    Single-stream mode (the pruning methods, Wanda/SparseGPT convention):
    one stream advances through the already-updated blocks. The reference
    also hands each such visit ``target_mb``, the dense block's output on
    the same input; no ported pruning visitor reads it, so this mode does
    not compute it.

    Dual-stream mode (EBFT, Eq. 3/4): the teacher stream propagates through
    the dense ``params`` and the student stream through
    ``params_student``; each visit sees the student's inputs (``h_mb``) and
    the teacher's outputs (``target_mb``), computed just before the visit
    (the reference's prefetch depth 0). Enqueuing the teacher ahead on the
    same stream overlaps nothing on the card; a side-stream teacher is
    later work (ROADMAP.md).

    ``visit_fn(i, bp, ctx)`` returns the block's new params or None; ctx
    holds ``h_mb``, ``pos_mb``, ``site`` (and ``target_mb`` in dual-stream
    mode). With ``masks`` (a full mask tree, which a pruning visitor fills
    in), each student advance runs the block's masked linears through the
    masked matmul kernel; the teacher runs dense. Returns the updated
    params (``params_student``, updated in place; never ``params`` in
    dual-stream mode).
    """
    out_params = params_student if params_student is not None else params
    if dual_stream and out_params is params:
        raise ValueError("walk_blocks: the dual-stream walk needs a student tree of its own "
                         "(set_block writes in place; the teacher must stay dense)")
    device = params["embed"]["tok"].device
    batch_all = _make_batches(calib, microbatch, device)
    for seg in R.execution_plan(model):
        hs_mb, ht_mb, pos_mb = [], [], []
        with torch.no_grad():
            for b in batch_all:
                h, pos = seg.h0(out_params, b)
                hs_mb.append(h)
                pos_mb.append(pos)
                if dual_stream:
                    ht_mb.append(seg.h0(params, b)[0])
        for (i, site) in seg.visits:
            ctx = dict(h_mb=hs_mb, pos_mb=pos_mb, site=site)
            if dual_stream:
                dense_bp = model.get_block(params, i)
                with torch.no_grad():
                    ht_mb = [R.advance_with(model, params, i, dense_bp, h, p)
                             for h, p in zip(ht_mb, pos_mb)]
                ctx["target_mb"] = ht_mb
            bp = model.get_block(out_params, i)
            new_bp = visit_fn(i, bp, ctx)
            if new_bp is not None:
                out_params = model.set_block(out_params, i, new_bp)
                bp = model.get_block(out_params, i)
            mb = model.get_block(masks, i) if masks is not None else None
            with torch.no_grad():
                hs_mb = [R.advance_with(model, out_params, i, bp, h, p, mb)
                         for h, p in zip(hs_mb, pos_mb)]
    return out_params
