"""Mask tuning (the paper's §4.5 ablation; port of
``repro.core.mask_tuning``): move the masks, freeze the weights.

The same block-wise walk and Eq. 4 objective as EBFT, but the variables
are a continuous score per slot of every prunable leaf. The forward pass
thresholds the scores into a hard 0/1 mask at the target sparsity (per
output column, or per M-group under N:M), and a straight-through
estimator passes the mask's gradient to the scores. The weights never
change, which is why it loses to weight tuning (the paper's Tab. 6).

In the port the hard mask goes to the block's masked linears as their
mask (``MaskedMatmulFn``), so each step's backward runs the dX and dM
kernels and no dW: the mask's gradient ``(xᵀ dy) ⊙ w`` is what the
reference's autodiff of ``w * m`` gives.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import reconstruction as R
from repro_torch.core.ebft import EBFTConfig
from repro_torch.core.pruning import common as C
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.optim.schedules import plateau_early_stop
from repro_torch.sparsity import sparse_params as SP

Params = Any


def _hard_mask(name: str, scores_mat: torch.Tensor, sparsity: float, pattern) -> torch.Tensor:
    """The bool mask the (R, O) scores select."""
    if pattern is not None:
        return SP.nm_mask(scores_mat, *pattern)
    return SP.topk_mask_rows(scores_mat, sparsity)


class _STE(torch.autograd.Function):
    """Forward: the hard 0/1 mask of the (R, O) scores, in ``dtype``.
    Backward: the mask's gradient, straight to the scores (d mask / d
    scores = 1); the threshold itself takes no gradient."""

    @staticmethod
    def forward(ctx, scores, name, sparsity, pattern, dtype):
        return _hard_mask(name, scores, sparsity, pattern).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.float32), None, None, None, None


def _ste(scores_mat: torch.Tensor, name: str, sparsity: float, pattern, dtype) -> torch.Tensor:
    return _STE.apply(scores_mat, name, sparsity, pattern, dtype)


def _masked_block(bp: Params, scores: Params, sparsity: float, pattern) -> Params:
    """The block's masks, ``STE(hard_mask(scores))`` in each prunable
    leaf's dtype and shape, for its masked linears: with ``bp`` they give
    the reference's ``W ⊙ STE(hard_mask(scores))``."""
    out: Dict = {}
    for names, w in C.iter_prunable(bp):
        s = T.get_path(scores, names)
        sm, tag = SP.to_matrix(names[-1], s)
        m = SP.from_matrix(_ste(sm, names[-1], sparsity, pattern, w.dtype), tag)
        T.set_path(out, names, m)
    return out


def _final_masks(bp: Params, scores: Params, sparsity: float, pattern) -> Params:
    """The block's full bool mask tree: the hard masks of the scores on the
    prunable leaves, True elsewhere."""
    def g(path, w):
        if not SP.is_prunable(path, w):
            return torch.ones(w.shape, dtype=torch.bool, device=w.device)
        sm, tag = SP.to_matrix(path[-1], T.get_path(scores, path))
        return SP.from_matrix(_hard_mask(path[-1], sm, sparsity, pattern), tag)

    return T.map_with_path(g, bp)


def finetune_masks(model, dense_params: Params, init_masks: Params, sparsity: float,
                   calib: np.ndarray, ecfg: Optional[EBFTConfig] = None,
                   pattern: Optional[Tuple[int, int]] = None, log=None, bonus: float = 0.1,
                   histories: Optional[List[List[float]]] = None,
                   scores_out: Optional[Dict[Tuple, torch.Tensor]] = None
                   ) -> Tuple[Params, Params]:
    """Returns (mask-tuned sparse params, tuned masks): the dense weights
    under the tuned masks. ``init_masks`` is a full mask tree and is not
    written.

    The scores start at the leaf's |W| over its largest |W| (one maximum
    per leaf, as the reference's code takes it), plus ``bonus`` on the
    slots ``init_masks`` keeps, so the first hard mask is about the init
    mask; Adam (lr 2e-2 by default) moves them one step per microbatch, an
    epoch at a time, until the epoch mean loss plateaus.
    ``histories``, when a list, gets each block's epoch mean losses;
    ``scores_out``, when a dict, each prunable leaf's final (R, O) scores,
    keyed by ``(block, *path)``."""
    ecfg = ecfg or EBFTConfig(lr=2e-2)  # scores need a larger step than weights
    masks = T.tree_map(torch.clone, init_masks)
    student = SP.apply_masks(dense_params, masks)

    def visit(i, bp, ctx):
        dense_bp = model.get_block(dense_params, i)
        mask_bp = model.get_block(masks, i)
        scores: Dict = {}
        for names, w in C.iter_prunable(dense_bp):
            a = torch.abs(w.float())
            a = a / torch.clamp_min(a.max(), 1e-9)
            s = a + bonus * T.get_path(mask_bp, names).float()
            T.set_path(scores, names, s.requires_grad_(True))
        leaves = [s for _, s in T.leaves_with_path(scores)]
        opt = adam(ecfg.lr)
        state = opt.init(scores)
        data = list(zip(ctx["h_mb"], ctx["target_mb"], ctx["pos_mb"]))
        history: List[float] = []
        for _ in range(ecfg.epochs):
            losses = []
            for h, t, p in data:
                with torch.enable_grad():
                    mb = _masked_block(dense_bp, scores, sparsity, pattern)
                    loss = R.block_loss(model, i, dense_bp, mb, h, t, p)
                    grads = torch.autograd.grad(loss, leaves)
                it = iter(grads)
                updates, state = opt.update(T.tree_map(lambda _: next(it), scores), state,
                                            scores)
                apply_updates(scores, updates)
                losses.append(loss.detach())
            # the epoch mean, reduced on the device: one scalar read per epoch
            history.append(float(torch.stack(losses).mean()))
            if plateau_early_stop(history, ecfg.patience, ecfg.rel_tol):
                break
        with torch.no_grad():
            mask_bp = _final_masks(dense_bp, scores, sparsity, pattern)
        model.set_block(masks, i, mask_bp)
        if histories is not None:
            histories.append(history)
        if scores_out is not None:
            for names, s in T.leaves_with_path(scores):
                scores_out[(i, *names)] = SP.to_matrix(names[-1], s.detach())[0]
        if log:
            log(f"mask-tune block {i}: E {history[0]:.3e} -> {history[-1]:.3e}")
        return SP.apply_masks(dense_bp, mask_bp)

    result = C.walk_blocks(model, dense_params, calib, visit, microbatch=ecfg.microbatch,
                           params_student=student, masks=masks, dual_stream=True)
    return result, masks
