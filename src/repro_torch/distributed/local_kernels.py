"""The kernels on DTensors: each runs on its local shards (``local_map``).

No kernel is taken apart into plain torch ops on a DTensor. A wrapper
given DTensors maps them to their local tensors, calls itself on those
(the kernel on a CUDA tensor, its plain version on a CPU one) and labels
the result with the placements the sharding rule below gives; a layout
the rule does not cover raises ValueError.

``masked_matmul`` ``x (M, K) @ (w ⊙ m) (K, N)``, per mesh dimension:

    x           w, m        out         grad x      grad w
    Shard(0)    Replicate   Shard(0)    Shard(0)    Partial   (data-parallel rows)
    Replicate   Shard(1)    Shard(1)    Partial     Shard(1)  (column-parallel)
    Shard(1)    Shard(0)    Partial     Shard(1)    Shard(0)  (row-parallel)
    Replicate   Replicate   Replicate   Replicate   Replicate

The "grad" columns are ``local_map``'s ``in_grad_placements``: on a
data-sharded batch each rank's dW is its rows' share of the sum, so it is
labelled ``Partial``. Left at the input's ``Replicate``, each rank would
keep its own partial gradient as if it were the whole one. The caller
sums it (``core/ebft.py`` redistributes every gradient to its weight's
placements before the update). A row-parallel output is ``Partial`` over
"model", summed before the residual add (``act_sharding.constrain``).

Attention (``models.layers.attend``) is independent across batch rows
and heads: q, k and v (B, S, H, hd) run locally under q's placements,
each ``Shard(0)``, ``Shard(2)`` or ``Replicate`` per mesh dimension; kv
heads that replicate where q's heads shard (GQA with few kv heads) are
repeated to H and cut to q's heads first.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def any_dtensor(*ts) -> bool:
    if not torch.distributed.is_available():
        return False
    dt = _dtensor_type()
    return any(isinstance(t, dt) for t in ts)


def _mm_rule(xp, wp):
    from torch.distributed.tensor import Partial, Replicate, Shard

    R, S0, S1 = Replicate(), Shard(0), Shard(1)
    out, gx, gw = [], [], []
    for a, b in zip(xp, wp):
        if a == S0 and b == R:
            out.append(S0), gx.append(S0), gw.append(Partial())
        elif a == R and b == S1:
            out.append(S1), gx.append(Partial()), gw.append(S1)
        elif a == S1 and b == S0:
            out.append(Partial()), gx.append(S1), gw.append(S0)
        elif a == R and b == R:
            out.append(R), gx.append(R), gw.append(R)
        else:
            raise ValueError(f"masked_matmul: no sharding rule for x {tuple(xp)} "
                             f"against w {tuple(wp)}")
    return out, gx, gw


def _as_dtensor(t, mesh):
    """A plain operand beside DTensors is replicated on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def masked_matmul(fn: Callable, x, w, m, **tiles):
    """``fn(x, w, m)`` (the public wrapper) on the local shards of 2-D
    DTensor operands, under the rule of the module docstring."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t.device_mesh for t in (x, w, m) if any_dtensor(t))
    x, w, m = (_as_dtensor(t, mesh) for t in (x, w, m))
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError("masked_matmul: a DTensor route takes 2-D operands only "
                         f"(x {tuple(x.shape)}, w {tuple(w.shape)})")
    if tuple(m.placements) != tuple(w.placements):
        raise ValueError(f"masked_matmul: mask placements {tuple(m.placements)} differ "
                         f"from the weight's {tuple(w.placements)}")
    out, gx, gw = _mm_rule(x.placements, w.placements)
    local = local_map(lambda a, b, c: fn(a, b, c, **tiles), out_placements=out,
                      in_placements=(list(x.placements), list(w.placements),
                                     list(m.placements)),
                      in_grad_placements=(gx, gw, gw), device_mesh=mesh)
    return local(x, w, m)


def attend(fn: Callable, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (``layers.attend``) on local batch rows and
    heads."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    ok = (Replicate(), Shard(0), Shard(2))
    if any(p not in ok for p in q.placements):
        raise ValueError(f"attend: no sharding rule for q placements {tuple(q.placements)}")
    k, v = (_as_dtensor(t, mesh) for t in (k, v))
    if tuple(k.placements) != tuple(q.placements) or tuple(v.placements) != tuple(q.placements):
        groups = q.shape[2] // k.shape[2]
        k, v = (_repeat_heads(t, groups).redistribute(mesh, q.placements) for t in (k, v))
    pl = list(q.placements)
    local = local_map(lambda a, b, c: fn(*(_DenseGrad.apply(t) for t in (a, b, c)), **kw),
                      out_placements=pl,
                      in_placements=(pl, pl, pl), in_grad_placements=(pl, pl, pl),
                      device_mesh=mesh)
    return local(q, k, v)


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous. The local
    attention's input gradients can come back as permuted views (the
    kernel's head folding, the plain path's einsums); with one head a rank
    such a view passes as contiguous, and the DTensor ``reshape`` before
    the attention then fails its local ``view`` (a 1 × 4 mesh on
    tiny_dense, ``tests/test_torch_mesh_ebft.py``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _repeat_heads(t, groups: int):
    """(B, S, Hkv, hd) -> (B, S, Hkv*groups, hd), each kv head repeated for
    its group of q heads."""
    if groups == 1:
        return t
    b, s, hkv, hd = t.shape
    return t.unsqueeze(3).expand(b, s, hkv, groups, hd).reshape(b, s, hkv * groups, hd)
