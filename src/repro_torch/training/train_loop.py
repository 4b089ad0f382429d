"""The train step and the host loop (port of
``repro.training.train_loop``, one device).

``make_train_step`` builds

    (params, opt_state, batch, err_state) -> (params, opt_state, metrics, err_state)

with optional microbatch gradient accumulation in f32 and optional top-k
gradient compression with error feedback (``optim/grad_compress.py``),
then global-norm clipping and the optimizer. Gradients come from
``torch.autograd.grad`` over aliases of the leaves that require grad only
inside the step; the update is written into ``params`` in place
(``optimizers.apply_updates``), so a caller that keeps the start weights
clones them first.

``Trainer`` is the host loop: the batch is a pure function of the step
(``data_fn``), so a run restarted from a checkpoint sees the same data;
checkpoints are written every ``ckpt_every`` steps without blocking the
loop; the loss is read on the host every ``log_every`` steps only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.checkpoint import ckpt as CK
from repro_torch.optim import grad_compress as GC
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm


def value_and_grad(loss_fn: Callable, params, batch) -> Tuple[torch.Tensor, Any]:
    """``loss_fn(params, batch)[0]`` and its gradient tree (each leaf in
    its param's dtype; zeros for a leaf the loss does not use). ``params``
    are not marked: the graph is built on aliases that require grad, so
    what leaves the step carries no autograd state."""
    live = T.tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = [p for _, p in T.leaves_with_path(live)]
    with torch.enable_grad():
        loss = loss_fn(live, batch)[0]
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), T.tree_map(lambda _: next(grads), live)


def make_train_step(loss_fn: Callable, opt: Optimizer, *, microbatches: int = 1,
                    grad_clip: float = 1.0, compress_ratio: float = 1.0,
                    on_stage: Optional[Callable[[str], None]] = None) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``. With ``microbatches``
    > 1 every batch leaf is split on dim 0, and the loss and the gradients
    are accumulated in f32 as ``acc + g / microbatches`` in microbatch
    order, as the reference's scan. The metrics ``loss`` and ``grad_norm``
    (before clipping) stay 0-d device tensors. ``on_stage``, when given, is
    called on the host with "start" as a step begins and with "grads",
    "compress" (when on), "clip" and "update" as each stage has been
    issued: a hook to time or count the step's stages (the device may still
    be running them). The reference's ``constrain_microbatch`` pins a
    sharding under GSPMD; it waits for the distributed port (ROADMAP.md
    A.8)."""
    mark = on_stage or (lambda _: None)

    def accumulate(params, batch):
        if microbatches <= 1:
            return value_and_grad(loss_fn, params, batch)
        mb = T.tree_map(lambda x: x.reshape(microbatches, x.shape[0] // microbatches,
                                            *x.shape[1:]), batch)
        loss_acc = 0.0
        g_acc = T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
        for i in range(microbatches):
            loss, g = value_and_grad(loss_fn, params, T.tree_map(lambda x: x[i], mb))
            g_acc = T.tree_map(lambda a, x: a + x.to(torch.float32) / microbatches, g_acc, g)
            loss_acc = loss_acc + loss / microbatches
        return loss_acc, g_acc

    def train_step(params, opt_state, batch, err_state=None):
        mark("start")
        loss, grads = accumulate(params, batch)
        mark("grads")
        if compress_ratio < 1.0 and err_state is not None:
            grads, err_state = GC.compress(grads, err_state, compress_ratio)
            mark("compress")
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        mark("clip")
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        mark("update")
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}, err_state

    return train_step


@dataclasses.dataclass
class Trainer:
    """The host loop with checkpoint and restart and a data order that is a
    pure function of the step."""

    step_fn: Callable
    data_fn: Callable[[int], Dict[str, Any]]  # step -> batch
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    log_every: int = 10

    def run(self, params, opt_state, start_step: int, num_steps: int, err_state=None):
        """Steps ``start_step .. start_step + num_steps - 1``. Returns
        (params, opt_state, [(step, loss)] at every ``log_every``-th step).
        With ``ckpt_dir`` the end state is on disk when it returns: the
        writers are drained, and the last step is saved unless a periodic
        save already holds it."""
        history: List[Tuple[int, float]] = []
        end = start_step + num_steps
        for step in range(start_step, end):
            batch = self.data_fn(step)
            params, opt_state, metrics, err_state = self.step_fn(
                params, opt_state, batch, err_state)
            if step % self.log_every == 0:
                history.append((step, float(metrics["loss"])))
            if self.ckpt_dir and (step + 1) % self.ckpt_every == 0:
                CK.save(self.ckpt_dir, {"params": params, "opt_state": opt_state},
                        step=step + 1, async_write=True)
        if self.ckpt_dir:
            # a periodic save of this same step may still be writing its .tmp
            CK.wait_all()
            if CK.latest_step(self.ckpt_dir) != end:
                CK.save(self.ckpt_dir, {"params": params, "opt_state": opt_state},
                        step=end, async_write=False)
        return params, opt_state, history
