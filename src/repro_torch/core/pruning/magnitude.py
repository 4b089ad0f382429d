"""Magnitude pruning (Han et al. 2015): score = |W|, whole-leaf comparison
(port of ``repro.core.pruning.magnitude``). Needs no calibration data."""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.sparsity import sparse_params as SP


def leaf_mask(name: str, leaf, sparsity: float, pattern=None):
    """pattern: None for unstructured, (n, m) for N:M. Stack-aware: the
    comparison group and the N:M groups stay per layer."""
    mat, tag = SP.to_matrix_stacked(name, leaf)
    scores = mat.abs()
    if pattern is not None:
        mask = SP.nm_mask(scores, *pattern)
    else:
        mask = SP.global_topk_mask(scores, sparsity)
    return SP.from_matrix(mask, tag)


def make_masks(params, sparsity: float, pattern=None):
    """Whole-model magnitude masks; non-prunable leaves get a 0-d True."""
    def g(path, leaf):
        if SP.is_prunable(path, leaf):
            return leaf_mask(path[-1], leaf, sparsity, pattern)
        return torch.ones((), dtype=torch.bool, device=leaf.device)

    return T.map_with_path(g, params)
