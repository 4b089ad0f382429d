"""Masked parameter trees + sparsity pattern utilities (port of
``repro.sparsity.sparse_params``, dense-family leaves).

* A **mask tree** mirrors the param tree. The port's masks are ``bool``:
  prunable leaves carry a mask of the leaf's shape; in ``ones_masks``
  non-prunable leaves carry a 0-d True (``core.masks.expand_masks`` makes
  them full so block slicing works). ``repro_torch.interop`` converts to
  and from the reference's f32 masks.
* **Prunable leaves** are the >=2-D linear weights of each block;
  norms, embeddings and the LM head are never pruned.
* Every prunable leaf has a canonical (reduction, out) 2-D view via
  ``to_matrix``; pruning scores and N:M groups run in that view.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree as T

Params = Any

PRUNABLE_NAMES = frozenset({"wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down"})
PROTECTED_PARENTS = frozenset({"router", "embed", "head", "gnorm"})


def is_prunable(path: Tuple[str, ...], leaf) -> bool:
    if not path or path[-1] not in PRUNABLE_NAMES:
        return False
    if any(n in PROTECTED_PARENTS for n in path):
        return False
    return getattr(leaf, "dim", lambda: 0)() >= 2


def map_prunable(fn: Callable, params: Params, *rest) -> Params:
    """Map ``fn(name, leaf, *rest_leaves)`` over prunable leaves; the others
    pass through from ``params``."""
    def g(path, leaf, *r):
        return fn(path[-1], leaf, *r) if is_prunable(path, leaf) else leaf

    return T.map_with_path(g, params, *rest)


def ones_masks(params: Params) -> Params:
    """All-dense masks: prunable leaves get full True, others a 0-d True."""
    def g(path, leaf):
        shape = leaf.shape if is_prunable(path, leaf) else ()
        return torch.ones(shape, dtype=torch.bool, device=leaf.device)

    return T.map_with_path(g, params)


def apply_masks(params: Params, masks: Params) -> Params:
    return T.tree_map(lambda p, m: p * m.to(p.dtype), params, masks)


def sparsity_of(masks: Params, params: Params) -> float:
    """Fraction of *prunable* weights that are zeroed."""
    kept = total = 0
    for path, p in T.leaves_with_path(params):
        if is_prunable(path, p):
            m = T.get_path(masks, path)
            kept += int(torch.count_nonzero(m))
            total += m.numel()
    return 1.0 - kept / max(total, 1)


# ---------------------------------------------------------------------------
# canonical (reduction, out) 2-D views
# ---------------------------------------------------------------------------
# name -> number of leading (logical) axes that are reduction axes
_REDUCTION_LEAD = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_up": 1, "w_gate": 1, "w_down": 1}
# logical (unstacked) rank per prunable leaf; extra leading dims are stack axes
_LOGICAL_NDIM = {"wq": 3, "wk": 3, "wv": 3, "wo": 3, "w_up": 2, "w_gate": 2, "w_down": 2}


def to_matrix(name: str, leaf: torch.Tensor):
    """Leaf -> (R, O) matrix + shape tag."""
    lead = _REDUCTION_LEAD[name]
    r = 1
    for s in leaf.shape[:lead]:
        r *= s
    return leaf.reshape(r, -1), ("flat", tuple(leaf.shape))


def from_matrix(mat: torch.Tensor, tag) -> torch.Tensor:
    return mat.reshape(tag[1])


def to_matrix_stacked(name: str, leaf: torch.Tensor):
    """Like ``to_matrix`` but keeps leading stack axes: (S..., R, O)."""
    n_log = _LOGICAL_NDIM[name]
    lead = _REDUCTION_LEAD[name]
    stack = leaf.shape[: leaf.dim() - n_log]
    logical = leaf.shape[leaf.dim() - n_log:]
    r = 1
    for s in logical[:lead]:
        r *= s
    o = 1
    for s in logical[lead:]:
        o *= s
    return leaf.reshape(*stack, r, o), ("stacked", tuple(leaf.shape))


# ---------------------------------------------------------------------------
# mask construction from scores (stable argsorts, as jnp.argsort)
# ---------------------------------------------------------------------------
def _keep(n: int, sparsity: float) -> int:
    return max(1, int(round(n * (1.0 - sparsity))))


def _rank(scores: torch.Tensor, dim: int) -> torch.Tensor:
    """0 = biggest along ``dim``; ties keep index order."""
    order = torch.argsort(-scores, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True)


def topk_mask_rows(scores: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Per-output-column mask of the (..., R, O) scores: each column keeps
    its top (1-sparsity) fraction along the reduction axis (Wanda)."""
    return _rank(scores, -2) < _keep(scores.shape[-2], sparsity)


def global_topk_mask(scores: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Per-matrix top-k mask (magnitude pruning); with leading stack dims
    the threshold is per stacked slice. Ties at the threshold are kept."""
    r, o = scores.shape[-2:]
    n = r * o
    keep = _keep(n, sparsity)
    flat = scores.reshape(*scores.shape[:-2], n)
    thresh = torch.kthvalue(flat, n - keep + 1, dim=-1).values  # keep-th largest
    return scores >= thresh[..., None, None]


def nm_mask(scores: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """N:M mask along the reduction axis of (..., R, O) scores: each group
    of ``m`` consecutive reduction slots keeps its ``n`` highest."""
    *lead, R, O = scores.shape
    if R % m:
        raise ValueError(f"reduction dim {R} not divisible by M={m}")
    g = scores.reshape(*lead, R // m, m, O)
    # the stable double argsort's rank, as m*m comparisons: slot i is beaten
    # by every slot j with a greater score, or an equal one at j < i
    s_i, s_j = g.unsqueeze(-2), g.unsqueeze(-3)  # (..., m, 1, O), (..., 1, m, O)
    earlier = torch.ones(m, m, dtype=torch.bool, device=g.device).tril(-1)[:, :, None]
    rank = ((s_j > s_i) | ((s_j == s_i) & earlier)).sum(dim=-2)
    return (rank < n).reshape(*lead, R, O)


def thresholds(scores: torch.Tensor, sparsity: float,
               pattern: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Each slot's comparison-group threshold, the lowest kept score (per
    column for ``topk_mask_rows``, per group for ``nm_mask``), in the
    scores' shape."""
    if pattern is not None:
        n, m = pattern
        *lead, R, O = scores.shape
        g = scores.reshape(*lead, R // m, m, O)
        thr = torch.sort(g, dim=-2, descending=True).values[..., n - 1:n, :]
        return thr.expand(g.shape).reshape(scores.shape)
    k = _keep(scores.shape[-2], sparsity)
    thr = torch.sort(scores, dim=-2, descending=True).values[..., k - 1:k, :]
    return thr.expand(scores.shape)


def threshold_gaps(scores: torch.Tensor, sparsity: float,
                   pattern: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Each slot's distance from its comparison group's threshold, relative
    to the threshold. A mask slot that flips between two runs whose sums
    were taken in another order must have a gap near 0."""
    thr = thresholds(scores, sparsity, pattern)
    return (scores - thr).abs() / thr.abs().clamp_min(1e-30)


# ---------------------------------------------------------------------------
# N:M compressed representation (for kernels/nm_spmm)
# ---------------------------------------------------------------------------
def nm_compress(w: torch.Tensor, mask: torch.Tensor, n: int, m: int):
    """Dense (R, O) weight + N:M mask -> (values (R//m*n, O), idx
    (R//m*n, O) int8), as the reference's bit for bit.

    idx holds each kept slot's offset within its M-group (0..m-1), the
    layout the nm_spmm kernel consumes. Kept slots come first within each
    group, in offset order (a stable sort); a group with fewer than n kept
    slots pads with its first dropped ones (value 0), one with more keeps
    its first n."""
    R, O = w.shape
    G = R // m
    wg = (w * mask).reshape(G, m, O)
    mg = mask.reshape(G, m, O)
    order = torch.argsort(-mg.to(torch.float32), dim=1, stable=True)  # kept (1) first
    top = order[:, :n, :]  # (G, n, O) offsets of kept slots
    vals = torch.gather(wg, 1, top)
    return vals.reshape(G * n, O), top.to(torch.int8).reshape(G * n, O)


def nm_decompress(vals: torch.Tensor, idx: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Inverse of :func:`nm_compress` -> dense (R, O)."""
    GN, O = vals.shape
    G = GN // n
    dense = torch.zeros((G, m, O), dtype=vals.dtype, device=vals.device)
    dense.scatter_(1, idx.reshape(G, n, O).long(), vals.reshape(G, n, O))
    return dense.reshape(G * m, O)
