"""Activation-sharding hooks for mesh-agnostic model code (port of
``repro.distributed.act_sharding``).

Model code tags tensors with a dims string ("bqhd", "bhq", ...) through
``constrain``; a launcher installs a policy that maps 'b' to the batch
mesh axes and 'h' to the model axis (when the dim divides). Without a
policy ``constrain`` returns its input unchanged, so single-device runs
keep their bits.

The reference's policy is a GSPMD sharding constraint. The port's
redistributes a DTensor to the placements the dims name: in particular a
row-parallel product, ``Partial`` over "model", is summed there
(``models/layers.py``: ``out_proj`` and ``mlp_block``). A plain tensor
passes unchanged: inside a kernel's ``local_map`` every tensor is local.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional

from repro_torch.distributed import sharding as SH

_POLICY: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar(
    "act_sharding_policy", default=None)


def constrain(x, dims: str):
    """dims: one char per axis of x: 'b' batch, 'h' heads, 'q'/'k'
    sequence, 'd' head_dim or feature, '.' unconstrained."""
    pol = _POLICY.get()
    return pol(x, dims) if pol is not None else x


@contextlib.contextmanager
def policy(fn: Callable):
    token = _POLICY.set(fn)
    try:
        yield
    finally:
        _POLICY.reset(token)


def make_mesh_policy(mesh, batch_axes=None) -> Callable:
    """'b' -> the batch axes when the dim divides; 'h' -> "model" when it
    divides and the batch mapping leaves "model" free; every other dim
    replicated. ``batch_axes`` overrides the batch mapping."""
    from torch.distributed.tensor import DTensor

    baxes = tuple(batch_axes) if batch_axes else SH.batch_axes(mesh)
    bsize = 1
    for a in baxes:
        bsize *= SH.mesh_axis_size(mesh, a)
    msize = SH.mesh_axis_size(mesh, SH.MODEL_AXIS)
    model_free = SH.MODEL_AXIS not in baxes

    def pol(x, dims: str):
        if not isinstance(x, DTensor):
            return x
        spec = []
        for i, c in enumerate(dims[: x.ndim]):
            if c == "b" and x.shape[i] % bsize == 0 and x.shape[i] >= bsize:
                spec.append(SH._batch_entry(baxes))
            elif (c == "h" and model_free and x.shape[i] % msize == 0
                  and x.shape[i] >= msize):
                spec.append(SH.MODEL_AXIS)
            else:
                spec.append(None)
        spec += [None] * (x.ndim - len(spec))
        return x.redistribute(mesh, SH.to_placements(spec, mesh))

    return pol
