"""EBFT: block-wise fine-tuning of sparse LLMs (port of
``repro.core.ebft``, dense family), Algorithm 1:

    for block l = 1..L:
        E ← block-wise reconstruction error (Eq. 4) over D_c
        repeat up to T epochs, early-stopping when E converges:
            W̄ₗ ← W̄ₗ − α · ∇_{W̄ₗ} E          (backprop through the block)
        advance the sparse stream with the tuned block

Masks are frozen: each masked linear is ``MaskedMatmulFn``, whose dW is
``(xᵀ dy) ⊙ m``, so pruned slots get exactly zero gradient and stay zero;
the tuned block is multiplied by its masks once more at the end, as the
reference.

The tuning loop is the reference's per-epoch loop (``_tune_block_legacy``):
mean loss before, E epochs of one Adam step per microbatch, a plateau check
on each epoch's mean (one host sync per epoch), mean loss after. It gives
the same history, ``epochs_run`` and ``early_stop`` as the reference's
fused path; capturing the epoch loop in a CUDA graph is later work. Only
one block's weights, masks and Adam moments are live at a time; the
teacher and student streams advance microbatch-wise
(``core/pruning/common.py``). The hybrid family's shared block waits for
that family (ROADMAP.md queue A.5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import reconstruction as R
from repro_torch.core.pruning import common as C
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.optim.schedules import plateau_early_stop
from repro_torch.sparsity.sparse_params import apply_masks

Params = Any


@dataclasses.dataclass
class EBFTConfig:
    """The reference's fields that the port reads, with its defaults. A
    ``mesh_plan`` is refused (distribution is ROADMAP.md queue A.8)."""

    lr: float = 2e-4
    epochs: int = 10          # paper: T = 10
    microbatch: int = 8
    patience: int = 2         # early stop when loss plateaus (paper: "converged")
    rel_tol: float = 1e-3
    mesh_plan: Optional[Any] = None


@dataclasses.dataclass
class BlockReport:
    """The reference's fields for one device. ``path`` is always "legacy"
    (the per-epoch loop). ``dispatches`` counts the loop's steps as the
    reference's legacy ledger does (a loss evaluation or a training step
    per microbatch, one reduction per pass, the final masking);
    ``host_syncs`` the scalars it reads back (two means and one per
    epoch)."""

    index: int
    kind: str
    epochs_run: int
    loss_before: float
    loss_after: float
    early_stop: str = "max_epochs"   # "plateau" | "max_epochs"
    history: List[float] = dataclasses.field(default_factory=list)
    live_bytes: int = 0              # weights + masks + f32 Adam moments
    path: str = "legacy"
    dispatches: int = 0
    host_syncs: int = 0

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in T.leaves_with_path(tree))


def tune_block(model, i: int, bp: Params, mask_bp: Params, data: List[Tuple],
               ecfg: EBFTConfig) -> Tuple[Params, BlockReport]:
    """Tune block ``i`` on ``data`` = [(h, target, positions), ...]
    microbatches. ``bp`` is not modified: the weights being tuned are fresh
    leaf tensors (clones of its views) that Adam updates in place under
    ``torch.no_grad()``. Returns the tuned, re-masked block and its report."""
    kind = R.block_kind(model, i)
    bw = T.tree_map(lambda t: t.detach().clone().requires_grad_(True), bp)
    leaves = [t for _, t in T.leaves_with_path(bw)]
    opt = adam(ecfg.lr)
    n_mb = len(data)
    dispatches = host_syncs = 0

    def loss_fn(h, target, pos):
        return R.block_loss(model, i, bw, mask_bp, h, target, pos)

    def eval_mean() -> float:
        nonlocal dispatches, host_syncs
        with torch.no_grad():
            losses = [loss_fn(*mb) for mb in data]
        dispatches += n_mb + 1
        host_syncs += 1
        return float(torch.stack(losses).mean())

    before = eval_mean()
    state = opt.init(bw)
    history: List[float] = [before]
    epochs_run = 0
    early_stop = "max_epochs"
    for _ in range(ecfg.epochs):
        losses = []
        for mb in data:
            with torch.enable_grad():
                loss = loss_fn(*mb)
                grads = torch.autograd.grad(loss, leaves)
            it = iter(grads)
            updates, state = opt.update(T.tree_map(lambda _: next(it), bw), state, bw)
            apply_updates(bw, updates)
            losses.append(loss.detach())
        dispatches += n_mb + 1
        host_syncs += 1
        epochs_run += 1
        history.append(float(torch.stack(losses).mean()))
        if plateau_early_stop(history, ecfg.patience, ecfg.rel_tol):
            early_stop = "plateau"
            break
    after = eval_mean()
    with torch.no_grad():
        tuned = apply_masks(T.tree_map(lambda t: t.detach(), bw), mask_bp)
    dispatches += 1
    live = _bytes(tuned) + _bytes(mask_bp) + 2 * 4 * sum(t.numel() for t in leaves)
    return tuned, BlockReport(
        i, kind, epochs_run, before, after, early_stop, history, live, "legacy",
        dispatches, host_syncs)


def finetune(model, dense_params: Params, pruned_params: Params, masks: Params,
             calib: np.ndarray, ecfg: Optional[EBFTConfig] = None,
             log: Optional[Callable[[str], None]] = None) -> Tuple[Params, List[BlockReport]]:
    """Algorithm 1 over the whole model. ``masks`` is a full mask tree (``core.masks``).
    Returns (fine-tuned sparse params, per-block reports); the student is a
    fresh tree, ``apply_masks(pruned_params, masks)``, so neither input
    tree is written."""
    ecfg = ecfg or EBFTConfig()
    if ecfg.mesh_plan is not None:
        raise NotImplementedError("EBFT over a device mesh is not ported yet "
                                  "(ROADMAP.md queue A.8)")
    student = apply_masks(pruned_params, masks)
    reports: List[BlockReport] = []

    def visit(i, bp, ctx):
        data = list(zip(ctx["h_mb"], ctx["target_mb"], ctx["pos_mb"]))
        tuned, rep = tune_block(model, i, bp, model.get_block(masks, i), data, ecfg)
        reports.append(rep)
        if log:
            log(f"block {i:3d} [{rep.kind}] epochs={rep.epochs_run} "
                f"E: {rep.loss_before:.3e} -> {rep.loss_after:.3e}")
        return tuned

    result = C.walk_blocks(model, dense_params, calib, visit, microbatch=ecfg.microbatch,
                           params_student=student, masks=masks, dual_stream=True)
    return result, reports
