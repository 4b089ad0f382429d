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

LoRA adapters: the reference's tree (``repro.core.lora.init_lora``) holds
``{"A", "B"}`` at each prunable leaf's path and None elsewhere; the port's
holds the adapter dicts alone.
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


def lora_to_torch(tree: Any, device=None) -> Any:
    """A reference adapter tree (numpy arrays, None at the leaves with no
    adapter) as the port's: the ``{"A", "B"}`` dicts at their paths, the
    rest dropped."""
    device = resolve_device(device)

    def conv(t):
        if not isinstance(t, dict):
            return _tensor(t, device)
        out = {}
        for k, v in t.items():
            c = None if v is None else conv(v)
            if c is not None and not (isinstance(c, dict) and not c):
                out[k] = c
        return out

    return conv(tree)
