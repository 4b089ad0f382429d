"""ZeRO-3-style gather-at-use hook for FSDP-sharded parameters (port of
``repro.distributed.fsdp``).

When FSDP shards a weight's contracting dim over the data axis, the
product becomes partial sums plus an all-reduce of the activation-sized
result. ZeRO-3 gathers the weights just in time instead. The model's
block loops give that a hook::

    bp = fsdp.gather_block(slice_block(params["blocks"], i))

which returns its input unchanged unless a policy is installed.
``make_tp_regather`` is the standard policy: each DTensor leaf of the
block goes back to its tensor-parallel placements (the rules of
``param_pspecs`` without the data axes).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Optional

from repro_torch import tree as T
from repro_torch.distributed import sharding as SH

_GATHER: contextvars.ContextVar[Optional[Callable]] = contextvars.ContextVar(
    "fsdp_gather", default=None)


def gather_block(block_params: Any) -> Any:
    """Applied by the model's block loops to each block's params."""
    fn = _GATHER.get()
    return fn(block_params) if fn is not None else block_params


@contextlib.contextmanager
def gather_policy(fn: Callable):
    token = _GATHER.set(fn)
    try:
        yield
    finally:
        _GATHER.reset(token)


def make_tp_regather(mesh) -> Callable:
    """Redistribute every DTensor leaf of a block to its tensor-parallel
    spec (plain leaves pass)."""
    from torch.distributed.tensor import DTensor

    def gather(bp):
        def g(path, leaf):
            if not isinstance(leaf, DTensor):
                return leaf
            spec = SH._leaf_spec(path, tuple(leaf.shape), mesh)
            return leaf.redistribute(mesh, SH.to_placements(spec, mesh))

        return T.map_with_path(g, bp)

    return gather
