"""Wanda (Sun et al. 2023): score_ij = |W_ij| * ||X_i||_2 (port of
``repro.core.pruning.wanda``).

The comparison group is per output: each output unit keeps its own top
(1-s) fraction of inputs, or its N best of every M under a pattern. A
Mamba block's ``conv_w`` (K | ch) is scored by its per-channel (output
axis) input norms; under N:M it stays dense (``SP.leaf_nm_mask``).
"""
from __future__ import annotations

import torch

from repro_torch.sparsity import sparse_params as SP


def leaf_scores(name: str, mat: torch.Tensor, stats) -> torch.Tensor:
    """mat: canonical (R, O), or (E, R, O) for an expert leaf with its
    per-expert (E, R) stats. stats: LeafStats for this leaf, or None (no
    tap for this leaf: magnitude scores)."""
    if stats is None:
        return mat.abs()
    if name == "conv_w":  # the taps give per-channel (output axis) norms
        return mat.abs() * stats.col_norm[None, :]
    return mat.abs() * stats.col_norm[..., None]


def mask_from_scores(name: str, scores: torch.Tensor, sparsity: float,
                     pattern=None) -> torch.Tensor:
    if pattern is not None:
        return SP.leaf_nm_mask(name, scores, *pattern)
    return SP.topk_mask_rows(scores, sparsity)


def leaf_mask(name: str, leaf, stats, sparsity: float, pattern=None) -> torch.Tensor:
    """Bool mask of the leaf's shape."""
    mat, tag = SP.to_matrix(name, leaf)
    return SP.from_matrix(mask_from_scores(name, leaf_scores(name, mat, stats), sparsity,
                                            pattern), tag)
