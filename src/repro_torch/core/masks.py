"""Pruning driver: ``prune(model, params, calib, method, ...)`` for the five
methods (port of ``repro.core.masks``).

Masks are *full* trees (True for every non-pruned slot, bool arrays of
every leaf's shape) so the model's get_block/set_block slice them like
params. ``pruned_params`` always stores masked weights (zeros at pruned
slots), as the reference's. The calibration walk follows the
Wanda/SparseGPT convention (inputs propagate through the blocks already
pruned, each student advance through the masked matmul kernel); magnitude
needs no data; DSnoT reselects the masks of another method; FLAP walks
twice (its unit scores are ranked globally, then expanded into masks).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core.pruning import common as C
from repro_torch.core.pruning import dsnot as DSNOT
from repro_torch.core.pruning import flap as FLAP
from repro_torch.core.pruning import magnitude as MAG
from repro_torch.core.pruning import sparsegpt as SGPT
from repro_torch.core.pruning import wanda as WANDA
from repro_torch.sparsity import sparse_params as SP

Params = Any

METHODS = ("magnitude", "wanda", "sparsegpt", "dsnot", "flap")


def full_ones_masks(params: Params) -> Params:
    return T.tree_map(lambda p: torch.ones(p.shape, dtype=torch.bool, device=p.device), params)


def expand_masks(params: Params, masks: Params) -> Params:
    """Scalar-placeholder masks -> full arrays (so block slicing works)."""
    return T.tree_map(lambda m, p: m.expand(p.shape).clone() if m.dim() == 0 else m,
                      masks, params)


@torch.no_grad()
def prune(model, params: Params, calib: Optional[np.ndarray], method: str = "wanda",
          sparsity: float = 0.5, pattern: Optional[Tuple[int, int]] = None,
          microbatch: int = 8, dsnot_init: str = "wanda", dsnot_cycles: int = 30,
          scores_out: Optional[Dict[Tuple, Any]] = None) -> Tuple[Params, Params]:
    """Returns (masks, pruned_params); ``params`` is left as it was.
    ``method`` is one of ``METHODS``; ``pattern``=(n, m) for N:M sparsity.
    DSnoT starts from the masks of ``dsnot_init``.

    ``scores_out``, when a dict, gets what each method ranked, keyed by
    ``(block, *path)`` of each pruned leaf: Wanda's (R, O) scores, SparseGPT's
    (R, O) scores of each 128-row block at its start, DSnoT's per-column
    (|E| of the init mask, |E| of the reselected one, sum_r |W[r,o] mu_r|)
    in f64; for FLAP
    ``(block, "heads" | "channels")`` -> the unit scores before
    standardising."""
    if method == "magnitude":
        masks = expand_masks(params, MAG.make_masks(params, sparsity, pattern))
        return masks, SP.apply_masks(params, masks)
    if method == "flap":
        return _prune_flap(model, params, calib, sparsity, microbatch, scores_out)
    if method == "dsnot":
        init_masks, _ = prune(model, params, calib, dsnot_init, sparsity, pattern, microbatch)
        return _dsnot_walk(model, params, init_masks, calib, microbatch, dsnot_cycles, pattern,
                           scores_out)
    if method not in ("wanda", "sparsegpt"):
        raise ValueError(f"unknown pruning method {method!r}; one of {METHODS}")

    masks = full_ones_masks(params)
    want_h = method == "sparsegpt"

    def visit(i, bp, ctx):
        stats = C.collect_block_stats(model, bp, i, ctx["h_mb"], ctx["pos_mb"],
                                      want_hessian=want_h)
        mask_bp = model.get_block(masks, i)
        new_bp = T.tree_map(lambda x: x, bp)
        for names, leaf in C.iter_prunable(bp):
            st = C.stats_for_leaf(stats, names)
            mat, tag = SP.to_matrix(names[-1], leaf)
            if method == "wanda":
                scores = WANDA.leaf_scores(names[-1], mat, st)
                mk = SP.from_matrix(WANDA.mask_from_scores(scores, sparsity, pattern), tag)
                nw = leaf * mk.to(leaf.dtype)
            else:
                scores = None if st is None or st.hessian is None else \
                    torch.empty(mat.shape, dtype=torch.float32, device=mat.device)
                nw, mk = SGPT.leaf_prune(names[-1], leaf, st, sparsity, pattern, scores)
            if scores_out is not None and scores is not None:
                scores_out[(i, *names)] = scores
            T.set_path(mask_bp, names, mk)
            T.set_path(new_bp, names, nw)
        model.set_block(masks, i, mask_bp)
        return new_bp

    student = T.tree_map(torch.clone, params)
    pruned = C.walk_blocks(model, params, calib, visit, microbatch,
                           params_student=student, masks=masks)
    return masks, pruned


def _dsnot_walk(model, params, init_masks, calib, microbatch, cycles, pattern, scores_out):
    """Reselect ``init_masks`` block by block on the stream of the blocks
    already reselected; each block's statistics come from its init-masked
    weights, its new weights are the dense ones under the new masks."""
    masks = T.tree_map(torch.clone, init_masks)

    def visit(i, bp, ctx):
        stats = C.collect_block_stats(model, bp, i, ctx["h_mb"], ctx["pos_mb"])
        mask_bp = model.get_block(masks, i)
        dense_bp = model.get_block(params, i)
        new_bp = T.tree_map(lambda x: x, bp)
        for names, _ in C.iter_prunable(bp):
            st = C.stats_for_leaf(stats, names)
            dense_leaf = T.get_path(dense_bp, names)
            mk_old = T.get_path(mask_bp, names)
            mk = DSNOT.leaf_reselect(names[-1], dense_leaf, mk_old, st, cycles, pattern)
            if scores_out is not None and st is not None:
                mat, _ = SP.to_matrix(names[-1], dense_leaf)
                mat, mean = mat.double(), st.mean.double()
                scores_out[(i, *names)] = tuple(
                    DSNOT.expected_error(mat, SP.to_matrix(names[-1], m)[0], mean).abs()
                    for m in (mk_old, mk)) + ((mat * mean[:, None]).abs().sum(dim=0),)
            T.set_path(mask_bp, names, mk)
            T.set_path(new_bp, names, dense_leaf * mk.to(dense_leaf.dtype))
        model.set_block(masks, i, mask_bp)
        return new_bp

    student = SP.apply_masks(params, init_masks)
    pruned = C.walk_blocks(model, params, calib, visit, microbatch,
                           params_student=student, masks=masks)
    return masks, pruned


def _prune_flap(model, params, calib, sparsity, microbatch, scores_out):
    """Pass 1 walks the dense stream and scores every block's units; the
    global threshold picks the units; pass 2 expands them into masks."""
    cfg = model.cfg
    scores = []

    def score_visit(i, bp, ctx):
        stats = C.collect_block_stats(model, bp, i, ctx["h_mb"], ctx["pos_mb"])
        scores.append(FLAP.block_unit_scores(bp, stats, cfg))
        if scores_out is not None:
            scores_out.update({(i, kind): s for kind, s in scores[-1].items()})
        return None  # the dense stream goes on unchanged

    C.walk_blocks(model, params, calib, score_visit, microbatch)
    unit_masks = FLAP.global_structured_masks(scores, sparsity)
    masks = full_ones_masks(params)
    for i, unit in enumerate(unit_masks):
        mask_bp = FLAP.expand_block_masks(model.get_block(params, i), unit,
                                          model.get_block(masks, i))
        model.set_block(masks, i, mask_bp)
    return masks, SP.apply_masks(params, masks)
