"""Carry param and mask trees between the JAX reference and the port,
through numpy.

Leaf paths and layouts stay as the reference's
(``repro.models.transformer``): stacked ``blocks/*`` leaves keep their
leading L axis and ``wq`` is (L, d, H, hd). numpy has no bfloat16, so a
bf16 array that arrives as ``ml_dtypes.bfloat16`` is read through its bits,
and a bf16 tensor leaves as an f32 array holding the same values.

Masks: the reference's are f32 {0, 1} arrays on prunable leaves and
either full ones or a scalar 1.0 elsewhere; the port's are bool. On the way
back prunable leaves become f32 arrays and the others a scalar 1.0, as the
reference's ``ones_masks``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.sparsity.sparse_params import is_prunable


def _tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_torch(tree: Any, device=None) -> Any:
    """Onto the card unless ``device="cpu"``; raises with no card."""
    device = resolve_device(device)
    return T.tree_map(lambda a: _tensor(a, device), tree)


def params_to_numpy(tree: Any) -> Any:
    return T.tree_map(_array, tree)


def masks_to_torch(tree: Any, device=None) -> Any:
    device = resolve_device(device)
    return T.tree_map(lambda a: _tensor(np.asarray(a) != 0, device), tree)


def masks_to_numpy(tree: Any) -> Any:
    def g(path, m):
        if is_prunable(path, m):
            return _array(m).astype(np.float32)
        return np.ones((), np.float32)

    return T.map_with_path(g, tree)
