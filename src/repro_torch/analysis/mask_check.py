"""Mask invariants (the port of ``repro.analysis.mask_check``).

EBFT freezes masks and trains only surviving weights; correctness requires
that pruned slots get **exactly zero gradient** (PAPER.md Eq. 4). That
holds iff the forward graph multiplies every prunable weight by its mask
*before* any contraction: d(loss)/dW then carries the mask factor by the
chain rule. This pass proves the property on the aten graph of
``reconstruction.block_loss`` (``graph_utils.trace``):

  * every placeholder of a prunable weight leaf is tainted ``W``
    (unmasked weight), every placeholder of its mask ``M``;
  * taint flows through all ops; a ``mul`` whose operands carry ``W`` and
    ``M`` produces ``WM`` (masked weight) and *clears* ``W``;
  * a contraction (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``matmul``,
    ``convolution``, and any ``einsum`` or ``_scaled_dot_product*`` that
    survives decomposition) consuming a value still tainted ``W`` is an
    unmasked contraction -> MSK001 (error).

The trace runs on the CPU, where ``masked_matmul(x, w, m)`` is its plain
version (``w * m``, then ``mm``). So the pass proves that the model code
routes every prunable leaf through ``masked_matmul`` or ``w * m``; that
the kernel on the card applies ``m`` is what ``chip_smoke.py`` holds by
comparing every kernel with its plain version.

The second half validates concrete mask trees: binary values (MSK002),
exact N:M group counts along the reduction axis (MSK003), and a reduction
axis the pattern divides (MSK004).
"""
from __future__ import annotations

from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import tree as T
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.graph_utils import call_nodes, op_name, placeholders, trace
from repro_torch.sparsity import sparse_params as SP

Taint = FrozenSet[str]
_EMPTY: Taint = frozenset()
_W: Taint = frozenset({"W"})
_M: Taint = frozenset({"M"})

CONTRACTIONS = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul", "convolution",
                          "_convolution", "einsum"})
_MASK_MULS = frozenset({"mul", "mul_"})


def _is_contraction(name: str) -> bool:
    return name in CONTRACTIONS or name.startswith("_scaled_dot_product")


def _path_names(keypath) -> Tuple[str, ...]:
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)


def taint_graph(gm: torch.fx.GraphModule, in_taints: List[Taint], where: str,
                config: str = "") -> List[Finding]:
    """Propagate taints from the placeholders through the graph; one
    MSK001 for each (contraction, operand) that reads an unmasked weight."""
    inputs = placeholders(gm)
    if len(inputs) != len(in_taints):
        raise ValueError(f"{where}: taint arity mismatch ({len(inputs)} placeholders, "
                         f"{len(in_taints)} taints)")
    env: Dict[torch.fx.Node, Taint] = dict(zip(inputs, in_taints))
    sink: Dict[Tuple[str, int], Finding] = {}
    for node in call_nodes(gm):
        name = op_name(node)
        ts = [env.get(a, _EMPTY) for a in node.all_input_nodes]
        union: Taint = frozenset().union(*ts) if ts else _EMPTY
        if _is_contraction(name):
            for pos, a in enumerate(node.all_input_nodes):
                if "W" in env.get(a, _EMPTY):
                    sink.setdefault((name, pos), Finding(
                        code="MSK001", severity="error", pass_name="masks",
                        config=config, location=where,
                        message=(f"unmasked prunable weight reaches a {name} (operand "
                                 f"{pos}) — pruned slots would receive nonzero gradient; "
                                 "route the leaf through masked_matmul(x, w, m) or "
                                 "multiply by the frozen mask before the contraction"),
                    ))
            env[node] = union
        elif name in _MASK_MULS and "W" in union and "M" in union:
            # the mask multiply: W is neutralized, the product is masked
            env[node] = (union - {"W", "M"}) | {"WM"}
        else:
            env[node] = union
    return list(sink.values())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def mask_taints(weights, masks, *args) -> List[Taint]:
    """The taints of the placeholders of a graph traced from ``(weights,
    masks, *args)``: ``W`` on each prunable weight leaf, ``M`` on its mask,
    nothing on the rest."""
    w_flat = pytree.tree_flatten_with_path(weights)[0]
    prunable = [SP.is_prunable(_path_names(p), leaf) for p, leaf in w_flat]
    if len(pytree.tree_leaves(masks)) != len(prunable):
        raise ValueError("weights and masks trees do not match")
    taints: List[Taint] = [_W if p else _EMPTY for p in prunable]
    taints += [_M if p else _EMPTY for p in prunable]
    return taints + [_EMPTY] * len(pytree.tree_leaves(args))


def check_masked_fn(fn, weights, masks, *args, where: str = "block_loss",
                    config: str = "") -> List[Finding]:
    """Trace ``fn(weights, masks, *args)`` and verify no prunable weight
    reaches a contraction unmasked. ``weights`` / ``masks`` are matching
    trees (masks as ``sparse_params.ones_masks`` makes them: full-shape on
    prunable leaves, 0-d elsewhere)."""
    gm = trace(fn, weights, masks, *args)
    return taint_graph(gm, mask_taints(weights, masks, *args), where, config)


def _tensor(a: Any) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def check_mask_tree(masks, params, *, nm: Optional[Tuple[int, int]] = None,
                    config: str = "") -> List[Finding]:
    """Validate a concrete mask tree (tensors or numpy arrays): binary
    values everywhere, and (when ``nm`` is given) exact N:M group counts
    along the reduction axis of every prunable leaf."""
    findings: List[Finding] = []

    def visit(path, leaf, mask):
        loc = "/".join(path)
        leaf, m = _tensor(leaf), _tensor(mask)
        if not bool(((m == 0) | (m == 1)).all()):
            findings.append(Finding(
                code="MSK002", severity="error", pass_name="masks",
                config=config, location=loc,
                message="mask values must be exactly {0,1}",
            ))
            return leaf
        if nm is not None and SP.is_prunable(path, leaf):
            n, mm = nm
            mat = SP.to_matrix(path[-1], m.to(torch.float32))[0]
            R = mat.shape[-2]
            if R % mm != 0:
                findings.append(Finding(
                    code="MSK004", severity="warn", pass_name="masks",
                    config=config, location=loc,
                    message=f"reduction dim {R} not divisible by M={mm}; "
                            f"N:M pattern not applicable",
                ))
                return leaf
            groups = mat.reshape(*mat.shape[:-2], R // mm, mm, mat.shape[-1]).sum(dim=-2)
            if not bool((groups == n).all()):
                bad = int((groups != n).sum())
                findings.append(Finding(
                    code="MSK003", severity="error", pass_name="masks",
                    config=config, location=loc,
                    message=f"{bad} group(s) violate the {n}:{mm} pattern "
                            f"(per-group kept counts range "
                            f"{int(groups.min())}..{int(groups.max())})",
                ))
        return leaf

    T.map_with_path(visit, params, masks)
    return findings
