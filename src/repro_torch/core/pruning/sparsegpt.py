"""SparseGPT (Frantar & Alistarh 2023): OBS pruning and a closed-form
weight update (port of ``repro.core.pruning.sparsegpt``).

In the canonical (R = reduction, O = out) layout:

  H     = X Xᵀ + λ I                        (R, R)  from calibration
  U     = chol(H⁻¹)ᵀ (upper)
  for each reduction block [v, v + b) of b = 128 rows:
      score_ro = W[r,o]² / U[r,r]²          (W as it stands at the block's start)
      choose the block's pruned set (per output column over the block, or
      per M-group under N:M)
      for each row r of the block:
          e     = (W[r,:] ⊙ pruned[r]) / U[r,r]
          W[r+1:, :] -= U[r, r+1:]ᵀ ⊗ e      (error compensation)
          W[r, :]    *= kept[r]

The reference applies each row's compensation to every later row of W at
once, which at ``w_down`` (R = 11008, O = 4096) moves terabytes per leaf.
The port runs the standard lazy-batch form of the same arithmetic: inside
a block the rank-1 updates touch only the block's rows and the rows' e are
kept; at the block's end one matmul applies ``W[v+b:] -= U[v:v+b, v+b:]ᵀ @
E`` to the rest. Only the order of the sums changes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.pruning import wanda
from repro_torch.core.pruning.common import full_f32_matmul
from repro_torch.sparsity import sparse_params as SP

BLOCK = 128


def _hinv_upper(H: torch.Tensor, damp_frac: float = 0.01) -> torch.Tensor:
    """Upper Cholesky factor of the damped inverse Gram: 1% of the diagonal
    mean plus 1e-8 on the diagonal, inverse, then +1e-9 on the diagonal.
    Cholesky is taken of the symmetrised matrix, as ``jnp.linalg.cholesky``
    takes it; where it is not positive definite it raises (the reference
    gets NaN), with no retry."""
    R = H.shape[-1]
    eye = torch.eye(R, dtype=H.dtype, device=H.device)
    damp = damp_frac * torch.diagonal(H, dim1=-2, dim2=-1).mean(dim=-1)
    Hinv = torch.linalg.inv(H + (damp[..., None, None] + 1e-8) * eye)
    A = Hinv + 1e-9 * eye
    return torch.linalg.cholesky((A + A.mT) / 2, upper=True)


@torch.no_grad()
def prune_matrix(W: torch.Tensor, H: torch.Tensor, sparsity: float,
                 pattern: Optional[Tuple[int, int]] = None, block: int = BLOCK,
                 scores_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """W (R, O), H (R, R) -> (updated f32 weights, bool mask), both (R, O).
    ``scores_out``, an (R, O) f32 tensor, gets each block's scores as they
    were ranked (the comparison group is a block's rows of one column, or
    an M-group)."""
    R, O = W.shape
    U = _hinv_upper(H.float())
    du = torch.diagonal(U)
    W = W.float().clone()
    mask = torch.ones((R, O), dtype=torch.bool, device=W.device)
    Bs = min(block, R)
    if pattern is not None:
        n, m = pattern
        Bs = max(Bs - Bs % m, m)  # a block aligns with the M-groups
    v = 0
    while v < R:
        b = min(Bs, R - v)
        Wb = W[v:v + b]  # a view: the row updates write W
        d = du[v:v + b]
        scores = torch.square(Wb) / torch.square(d)[:, None]
        if scores_out is not None:
            scores_out[v:v + b] = scores
        mb = SP.nm_mask(scores, *pattern) if pattern is not None \
            else SP.topk_mask_rows(scores, sparsity)
        pruned = (~mb).to(W.dtype)
        kept = mb.to(W.dtype)
        Ub = U[v:v + b, v:v + b]
        E = torch.empty((b, O), dtype=W.dtype, device=W.device)
        for r in range(b):
            torch.mul(Wb[r], pruned[r], out=E[r])
            E[r].div_(d[r])
            Wb[r + 1:].sub_(Ub[r, r + 1:, None] * E[r])
            Wb[r].mul_(kept[r])
        if v + b < R:  # the block's compensation of every later row, at once
            W[v + b:].sub_(full_f32_matmul(U[v:v + b, v + b:].T, E))
        mask[v:v + b] = mb
        v += b
    return W * mask, mask


def leaf_prune(name: str, leaf: torch.Tensor, stats, sparsity: float, pattern=None,
               scores_out: Optional[torch.Tensor] = None):
    """Returns (new leaf weights in the leaf's dtype, bool mask leaf). A
    leaf without a Gram takes Wanda's mask and no update (and leaves
    ``scores_out``, see :func:`prune_matrix`, as it was)."""
    mat, tag = SP.to_matrix(name, leaf)
    if stats is None or stats.hessian is None:
        mask = wanda.leaf_mask(name, leaf, stats, sparsity, pattern)
        return leaf * mask.to(leaf.dtype), mask
    Wn, mk = prune_matrix(mat, stats.hessian, sparsity, pattern, scores_out=scores_out)
    return SP.from_matrix(Wn.to(leaf.dtype), tag), SP.from_matrix(mk, tag)
