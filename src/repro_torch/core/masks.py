"""Pruning driver: ``prune(model, params, calib, method, ...)`` (port of
``repro.core.masks``, wanda and magnitude branches).

Masks are *full* trees (True for every non-pruned slot, bool arrays of
every leaf's shape) so the model's get_block/set_block slice them like
params. ``pruned_params`` always stores masked weights (zeros at pruned
slots), as the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.pruning import common as C
from repro_torch.core.pruning import magnitude as MAG
from repro_torch.core.pruning import wanda as WANDA
from repro_torch.sparsity import sparse_params as SP

Params = Any


def full_ones_masks(params: Params) -> Params:
    return T.tree_map(lambda p: torch.ones(p.shape, dtype=torch.bool, device=p.device), params)


def expand_masks(params: Params, masks: Params) -> Params:
    """Scalar-placeholder masks -> full arrays (so block slicing works)."""
    return T.tree_map(lambda m, p: m.expand(p.shape).clone() if m.dim() == 0 else m,
                      masks, params)


@torch.no_grad()
def prune(model, params: Params, calib: Optional[np.ndarray], method: str = "wanda",
          sparsity: float = 0.5, pattern: Optional[Tuple[int, int]] = None,
          microbatch: int = 8,
          scores_out: Optional[Dict[Tuple, torch.Tensor]] = None) -> Tuple[Params, Params]:
    """Returns (masks, pruned_params); ``params`` is left as it was.
    ``pattern``=(n, m) for N:M sparsity. ``scores_out``, when a dict, gets
    Wanda's (R, O) score matrix of every pruned leaf, keyed by
    ``(block, *path)``."""
    if method == "magnitude":
        masks = expand_masks(params, MAG.make_masks(params, sparsity, pattern))
        return masks, SP.apply_masks(params, masks)
    if method != "wanda":
        raise NotImplementedError(
            f"pruning method {method!r} is not ported yet (ROADMAP.md queue A.7)")

    masks = full_ones_masks(params)

    def visit(i, bp, ctx):
        stats = C.collect_block_stats(model, bp, i, ctx["h_mb"], ctx["pos_mb"])
        mask_bp = model.get_block(masks, i)
        new_bp = T.tree_map(lambda x: x, bp)
        for names, leaf in T.leaves_with_path(bp):
            if not SP.is_prunable(names, leaf):
                continue
            mat, tag = SP.to_matrix(names[-1], leaf)
            scores = WANDA.leaf_scores(names[-1], mat, C.stats_for_leaf(stats, names))
            if scores_out is not None:
                scores_out[(i, *names)] = scores
            mk = SP.from_matrix(WANDA.mask_from_scores(scores, sparsity, pattern), tag)
            T.set_path(mask_bp, names, mk)
            T.set_path(new_bp, names, leaf * mk.to(leaf.dtype))
        model.set_block(masks, i, mask_bp)
        return new_bp

    student = T.tree_map(torch.clone, params)
    pruned = C.walk_blocks(model, params, calib, visit, microbatch,
                           params_student=student, masks=masks)
    return masks, pruned
