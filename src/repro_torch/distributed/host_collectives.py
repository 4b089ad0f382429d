"""Collectives of CUDA tensors under gloo, through host memory.

DTensor runs its collectives as ``torch.ops._c10d_functional`` ops. On
one card the port runs its ranks under gloo (nccl takes one rank a GPU,
``chip_smoke.py``'s ``mesh`` phase), and gloo's own CUDA paths are not all
there: its ``all_gather_into_tensor`` of CUDA tensors crashed the process
on the H100 (ROADMAP.md C.12). :func:`install` registers, for CUDA
tensors only, a kernel of each op that copies the operand to the host,
runs the op's CPU path (gloo's CPU collectives: every dtype the port
uses, bf16 too) and copies the result back. The values are the CPU
path's; only the wire moves through host memory. ``launch.mesh``'s
``make_debug_mesh`` installs it for a CUDA mesh under gloo; under nccl
nothing changes.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# the functional collectives that DTensor's redistributions call
OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
       "broadcast")
_LIB: Optional[torch.library.Library] = None


def staged(op) -> Callable:
    """``op`` (a functional collective, out of place) on a host copy of its
    operand; the result back on the operand's device."""
    def impl(x, *args):
        out = torch.ops._c10d_functional.wait_tensor(op(x.detach().cpu(), *args))
        return out.to(x.device)

    return impl


def install() -> None:
    """Route CUDA tensors' functional collectives through the host (once
    per process)."""
    global _LIB
    if _LIB is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in OPS:
        lib.impl(name, staged(getattr(torch.ops._c10d_functional, name).default), "CUDA")
    _LIB = lib
