"""SGD with momentum, Adam, AdamW and global-norm clipping, written out (port of
``repro.optim.optimizers``; no ``torch.optim``, whose foreach and fused
variants order the arithmetic differently from the reference's formula).

The interface is the reference's (init, update) pair on plain dicts:

    opt = adam(lr=2e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``lr`` may be a float or a schedule ``f(step) -> lr`` (``optim/schedules.py``).
The moments are f32 and the step an int32 tensor on the params' device, so
an update makes no host round-trip.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import torch

from repro_torch import tree as T

Schedule = Union[float, Callable[[torch.Tensor], Any]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    value = lr(step) if callable(lr) else lr
    return torch.as_tensor(value, dtype=torch.float32, device=step.device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


@torch.no_grad()
def apply_updates(params, updates):
    """``p + u`` in p's dtype, written into ``p`` in place (the reference
    returns new arrays; the port saves a copy of the weights per step).
    Returns ``params``."""
    T.tree_map(lambda p, u: p.copy_(p + u.to(p.dtype)), params, updates)
    return params


def sgd(lr: Schedule, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD; with ``momentum`` its f32 buffer ``mu`` (None without), and
    with ``nesterov`` the look-ahead update."""

    def init(params):
        leaf = next(p for _, p in T.leaves_with_path(params))
        mu = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params) if momentum else None
        return {"step": torch.zeros((), dtype=torch.int32, device=leaf.device), "mu": mu}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum:
            mu = T.tree_map(lambda m, g: momentum * m + g.to(torch.float32), state["mu"], grads)
            if nesterov:
                upd = T.tree_map(lambda m, g: -(lr_t * (momentum * m + g.to(torch.float32))),
                                 mu, grads)
            else:
                upd = T.tree_map(lambda m: -lr_t * m, mu)
            return upd, {"step": step, "mu": mu}
        upd = T.tree_map(lambda g: -lr_t * g.to(torch.float32), grads)
        return upd, {"step": step, "mu": None}

    return Optimizer(init, update)


def adam(lr: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam (weight_decay > 0 makes it AdamW: decoupled decay)."""

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        leaf = next(p for _, p in T.leaves_with_path(params))
        return {"step": torch.zeros((), dtype=torch.int32, device=leaf.device),
                "m": T.tree_map(zeros, params), "v": T.tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        c1 = 1.0 - b1 ** step.to(torch.float32)
        c2 = 1.0 - b2 ** step.to(torch.float32)
        m = T.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32), state["m"], grads)
        v = T.tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)),
                       state["v"], grads)

        def u(m_, v_, p=None):
            upd = -(lr_t * (m_ / c1) / (torch.sqrt(v_ / c2) + eps))
            if weight_decay and p is not None:
                upd = upd - lr_t * weight_decay * p.to(torch.float32)
            return upd

        if weight_decay and params is not None:
            updates = T.tree_map(u, m, v, params)
        else:
            updates = T.tree_map(u, m, v)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr: Schedule, weight_decay: float = 0.1, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


# ---------------------------------------------------------------------------
@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / ‖g‖)``, the norm taken
    over all leaves in f32. Returns (scaled grads, the norm), as the
    reference; the norm stays on the device."""
    leaves = [g for _, g in T.leaves_with_path(grads)]
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-12), max=1.0)
    return T.tree_map(lambda g: g * scale.to(g.dtype), grads), gn
