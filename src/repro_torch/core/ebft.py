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

Observability, at the reference's call sites and names: ``finetune``
opens ``ebft/walk`` (``fused=False``, ``prefetch_depth=0``) and
``tune_block`` opens ``ebft/block``, books the ``ebft/live_block_bytes``
gauges, the per-block series (losses, epochs, dispatches, host syncs)
and the ``ebft/early_stop/<reason>`` counters, all host numbers the loop
has already read. The tuning step and the loss evaluation go through
``FirstCallTimer``s kept per block kind, so their first call lands in
``ebft/walk/tune_compile_s``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import reconstruction as R
from repro_torch.core.pruning import common as C
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import DispatchLedger, FirstCallTimer, ebft_live_block_bytes
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
    """The reference's fields, on one device. ``path`` is always "legacy"
    (the per-epoch loop). ``dispatches`` counts the loop's steps as the
    reference's legacy ledger does (a loss evaluation or a training step
    per microbatch, one reduction per pass, the final masking);
    ``host_syncs`` the scalars it reads back (two means and one per
    epoch). On one device ``device_dispatches`` equals ``dispatches``,
    ``live_bytes_per_shard`` equals ``live_bytes`` and
    ``collective_bytes`` is 0."""

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
    device_dispatches: int = 0       # dispatches x participating devices
    live_bytes_per_shard: int = 0    # live_bytes per device
    collective_bytes: int = 0        # gradient all-reduce wire bytes

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _loss_and_grads(model, i: int, bw, leaves, mask_bp, h, target, pos):
    with torch.enable_grad():
        loss = R.block_loss(model, i, bw, mask_bp, h, target, pos)
        return loss, torch.autograd.grad(loss, leaves)


def tune_block(model, i: int, bp: Params, mask_bp: Params, data: List[Tuple],
               ecfg: EBFTConfig, step_cache: Dict) -> Tuple[Params, BlockReport]:
    """Tune block ``i`` on ``data`` = [(h, target, positions), ...]
    microbatches. ``bp`` is not modified: the weights being tuned are fresh
    leaf tensors (clones of its views) that Adam updates in place under
    ``torch.no_grad()``. ``step_cache`` (one dict per walk) keeps the
    block kind's first-call timers across blocks. Returns the tuned,
    re-masked block and its report."""
    kind = R.block_kind(model, i)
    if kind not in step_cache:
        step_cache[kind] = (FirstCallTimer(R.block_loss), FirstCallTimer(_loss_and_grads))
    eval_loss, step = step_cache[kind]
    bw = T.tree_map(lambda t: t.detach().clone().requires_grad_(True), bp)
    leaves = [t for _, t in T.leaves_with_path(bw)]
    opt = adam(ecfg.lr)
    n_mb = len(data)
    ledger = DispatchLedger("ebft/tune")

    with OT.span("ebft/block", index=i, kind=kind) as sp:
        def eval_mean() -> float:
            with torch.no_grad():
                losses = [eval_loss(model, i, bw, mask_bp, *mb) for mb in data]
            ledger.dispatch(n_mb + 1)
            ledger.host_sync()
            return float(torch.stack(losses).mean())

        before = eval_mean()
        state = opt.init(bw)
        history: List[float] = [before]
        epochs_run = 0
        early_stop = "max_epochs"
        for _ in range(ecfg.epochs):
            losses = []
            for mb in data:
                loss, grads = step(model, i, bw, leaves, mask_bp, *mb)
                it = iter(grads)
                updates, state = opt.update(T.tree_map(lambda _: next(it), bw), state, bw)
                apply_updates(bw, updates)
                losses.append(loss.detach())
            ledger.dispatch(n_mb + 1)
            ledger.host_sync()
            epochs_run += 1
            history.append(float(torch.stack(losses).mean()))
            if plateau_early_stop(history, ecfg.patience, ecfg.rel_tol):
                early_stop = "plateau"
                break
        after = eval_mean()
        with torch.no_grad():
            tuned = apply_masks(T.tree_map(lambda t: t.detach(), bw), mask_bp)
        ledger.dispatch()
        # the streaming claim, measured: only this block's weights, masks
        # and Adam moments are optimizer-live now
        live = ebft_live_block_bytes(tuned, mask_bp)
        report = BlockReport(
            i, kind, epochs_run, before, after, early_stop, history, live, "legacy",
            ledger.dispatches, ledger.host_syncs, ledger.device_dispatches, live, 0)
        if OT.enabled():
            OM.gauge("ebft/live_block_bytes").set(live)  # summary max = peak
            OM.gauge("ebft/live_block_bytes_per_shard").set(live)
            OM.series("ebft/loss_before").append(before, step=i)
            OM.series("ebft/loss_after").append(after, step=i)
            OM.series("ebft/epochs_run").append(epochs_run, step=i)
            OM.series("ebft/dispatches_per_block").append(report.dispatches, step=i)
            OM.series("ebft/host_syncs_per_block").append(report.host_syncs, step=i)
            OM.counter(f"ebft/early_stop/{early_stop}").inc()
            sp.set(epochs=epochs_run, loss_before=before, loss_after=after,
                   early_stop=early_stop, live_bytes=live, path=report.path,
                   dispatches=report.dispatches, host_syncs=report.host_syncs,
                   devices=ledger.devices)
    return tuned, report


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
    with OT.span("ebft/walk", epochs=ecfg.epochs, lr=ecfg.lr, microbatch=ecfg.microbatch,
                 fused=False, prefetch_depth=0, mesh_devices=1):
        student = apply_masks(pruned_params, masks)
        reports: List[BlockReport] = []
        step_cache: Dict = {}

        def visit(i, bp, ctx):
            data = list(zip(ctx["h_mb"], ctx["target_mb"], ctx["pos_mb"]))
            tuned, rep = tune_block(model, i, bp, model.get_block(masks, i), data, ecfg,
                                    step_cache)
            reports.append(rep)
            if log:
                log(f"block {i:3d} [{rep.kind}] epochs={rep.epochs_run} "
                    f"E: {rep.loss_before:.3e} -> {rep.loss_after:.3e}")
            return tuned

        result = C.walk_blocks(model, dense_params, calib, visit, microbatch=ecfg.microbatch,
                               params_student=student, masks=masks, dual_stream=True)
    return result, reports
