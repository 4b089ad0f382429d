"""DSnoT (Zhang et al. 2023d): training-free mask reselection (port of
``repro.core.pruning.dsnot``).

Starting from any mask, each output unit o repeatedly swaps one pruned
weight in (grow) and one kept weight out (prune) to shrink its expected
reconstruction error

    E_o = sum_{pruned r} W[r,o] * mu_r,   mu_r = E[X_r] (calibration mean)

Grow restores the pruned weight whose contribution best cancels E_o;
prune removes, among the kept weights whose removal also pushes E_o toward
zero, the one with the smallest Wanda score. A swap is committed only when
it strictly reduces |E_o|. Weights never change. Under N:M the prune
candidate must share the grown weight's M-group, so the pattern holds.

Plain tensor ops over the (R, O) view, all columns at once (and all
experts of an (E, R, O) expert view), for a fixed number of cycles.
``torch.argmax``/``argmin`` return the first index on
ties, as ``jnp.argmax``/``argmin``: a column with no pruned slot has all
its gains at -1e30 and grows nothing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.sparsity import sparse_params as SP

_BIG = 1e30


def expected_error(W: torch.Tensor, mask: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """E_o of each output column of the (..., R, O) view, in the dtype of W
    and mean."""
    return torch.where(mask, 0.0, W * mean[..., :, None]).sum(dim=-2)


@torch.no_grad()
def reselect(W: torch.Tensor, mask: torch.Tensor, mean: torch.Tensor, col_norm: torch.Tensor,
             cycles: int = 30, pattern: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """W, mask (..., R, O); mean, col_norm (..., R) -> the reselected bool
    mask. Leading axes (an expert leaf's E) are matrices of their own, as
    the reference's ``vmap`` over E takes them."""
    R = W.shape[-2]
    W = W.float()
    c = W * mean.float()[..., :, None]                 # contribution if kept
    wanda = W.abs() * col_norm.float()[..., :, None]
    if pattern is not None:
        group = torch.arange(R, device=W.device) // pattern[1]
    mask = mask.clone()

    def at(t, r):  # t[..., r[..., o], o] for every column o
        return torch.gather(t, -2, r[..., None, :])[..., 0, :]

    for _ in range(cycles):
        E = torch.where(mask, 0.0, c).sum(dim=-2)      # (..., O)
        cs = c * torch.sign(E)[..., None, :]
        # grow: the pruned weight whose return cuts |E| the most
        gain = torch.where(mask, -_BIG, cs)
        r_g = torch.argmax(gain, dim=-2)               # (..., O)
        g_gain = at(gain, r_g)
        # prune: a kept weight whose removal (E += c) pushes E toward 0,
        # the smallest Wanda score among them
        cand = mask & (cs < 0)
        if pattern is not None:
            cand &= group[:, None] == group[r_g][..., None, :]
        r_p = torch.argmin(torch.where(cand, wanda, _BIG), dim=-2)
        p_cost = at(cs, r_p)
        has_p = at(cand, r_p)
        new_abs = torch.abs(torch.abs(E) - g_gain + p_cost)
        do = has_p & (g_gain > 0) & (new_abs < torch.abs(E))
        mask.scatter_(-2, r_g[..., None, :], (do | at(mask, r_g))[..., None, :])
        mask.scatter_(-2, r_p[..., None, :], (~do & at(mask, r_p))[..., None, :])
    return mask


def leaf_reselect(name: str, leaf: torch.Tensor, mask_leaf: torch.Tensor, stats, cycles=30,
                  pattern=None) -> torch.Tensor:
    """The leaf's reselected bool mask (an expert leaf's experts each on
    its own); a leaf without taps, and a Mamba block's ``conv_w``, keep
    their own, as the reference's."""
    if stats is None or name == "conv_w":
        return mask_leaf
    mat, tag = SP.to_matrix(name, leaf)
    mk, _ = SP.to_matrix(name, mask_leaf)
    return SP.from_matrix(reselect(mat, mk, stats.mean, stats.col_norm, cycles, pattern), tag)
