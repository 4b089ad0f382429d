"""EBFT: block-wise fine-tuning of sparse LLMs (port of
``repro.core.ebft``, every family),
Algorithm 1:

    for block l = 1..L:
        E ← block-wise reconstruction error (Eq. 4) over D_c
        repeat up to T epochs, early-stopping when E converges:
            W̄ₗ ← W̄ₗ − α · ∇_{W̄ₗ} E          (backprop through the block)
        advance the sparse stream with the tuned block

Masks are frozen: each masked linear is ``MaskedMatmulFn``, whose dW is
``(xᵀ dy) ⊙ m``, so pruned slots get exactly zero gradient and stay zero;
the tuned block is multiplied by its masks once more at the end, as the
reference.

The tuning loop is the reference's fused loop by default
(``EBFTConfig.fused_epochs``; ``_tune_block_fused``, the reference's
``fused_run`` run eagerly): the walk hands each visit its microbatches
stacked (``h_st``, ``target_st``, ``pos_st``, ``aux_st``); the mean loss
before, E epochs of one Adam step per microbatch and the mean loss after
are all enqueued, the epoch means go into a loss history on the device,
and the plateau is decided there (``plateau_early_stop_device``), so the
host reads the block once, after its last epoch. Every epoch is
computed; once the plateau fires the weights keep their bits (each
update is ``where(plateaued, p, p + u)``), so the tuned block, the
history, ``epochs_run`` and ``early_stop`` are the per-epoch loop's bit
for bit. The reference's ``lax.cond`` skips those epochs; here they cost
the card their time. Ragged microbatches and ``fused_epochs=False`` run
the reference's per-epoch loop (``_tune_block_legacy``): a plateau check on the host after each epoch
(one host sync per epoch). Only one block's weights, masks and Adam
moments are live at a time. The teacher stream runs
``EBFTConfig.prefetch_depth`` visits ahead of the tuning, on a side
stream of the card (``core/pruning/common.py``, ``TeacherPrefetcher``),
so its forward overlaps the student's tuning. The hybrid family's shared
block is tuned once, on the union of its sites (the reference's rule): at
each site the visit keeps that site's (h, target, positions) microbatches
and returns None, so the student stream at later sites runs the untuned
sparse shared block; after the walk ``tune_block`` stacks every site's
microbatches and tunes on them together, its report comes last and its
weights are set back.

On a mesh (``EBFTConfig.mesh_plan`` an active
:class:`~repro_torch.distributed.meshplan.MeshPlan`, ranks started under
``torchrun``) the same loop runs SPMD over DTensors: each microbatch of
the teacher and student streams is sharded on its batch dim over the
data axes (``walk_blocks``; the prefetched teacher stays on the walk's
stream, since gloo's collectives cross the host), the live block's
weights and masks over "model" by ``plan.block_pspecs`` (Adam's moments follow their weights),
and every kernel runs on its rank's local shards
(``distributed.local_kernels``). The reference shards its fused scan,
whose gradient all-reduce GSPMD inserts; here each step's gradients are
summed over the data axes explicitly, redistributed to their weights'
placements before the update. The losses are global means, so every
rank takes the same early-stop decision. The tuned block is gathered
whole on every rank, so everything after EBFT is unchanged. The report
books the reference's accounting: ``device_dispatches`` = dispatches ×
devices, ``collective_bytes`` = epochs × microbatches ×
``plan.allreduce_bytes(live_bytes(block))`` and ``live_bytes_per_shard``
from ``plan.sharded_bytes``. Every family runs on a mesh: an MoE layer's
experts split over "model" and its routing over the data ranks, a Mamba
mixer's heads over "model" (``local_kernels``); the hybrid's shared
block is tuned once on every site's sharded microbatches. The VLM's
stream starts from [patches ; text], built whole on every rank and then
sharded with its batch. The encoder-decoder's encoder blocks are dense
blocks with bidirectional attention on local heads; its decoder
segment's memory (B, F, d), encoded whole on every rank, is sharded on
its batch dim over the data axes with its microbatch (``walk_blocks``),
so cross-attention's keys and values, projected column-parallel over
"model", share the query's rows and heads. An inactive plan
(``make_ebft_plan(1, 1)``) is the single-device path bit for bit.

Observability, at the reference's call sites and names: ``finetune``
opens ``ebft/walk`` (``fused`` and ``prefetch_depth`` the config's) and
``tune_block`` opens ``ebft/block``, books the ``ebft/live_block_bytes``
gauges, the per-block series (losses, epochs, dispatches, host syncs)
and the ``ebft/early_stop/<reason>`` counters, all host numbers the loop
has already read. The tuning step and the loss evaluation go through
``FirstCallTimer``s kept per block kind, so their first call lands in
``ebft/walk/tune_compile_s``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import reconstruction as R
from repro_torch.core.pruning import common as C
from repro_torch.distributed import local_kernels as LK
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.meshplan import MeshPlan
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import (DispatchLedger, FirstCallTimer, ebft_live_block_bytes,
                                     live_bytes)
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.optim.schedules import plateau_early_stop, plateau_early_stop_device
from repro_torch.sparsity.sparse_params import apply_masks

Params = Any

@dataclasses.dataclass
class EBFTConfig:
    """The reference's fields that the port reads, with its defaults.
    ``mesh_plan`` is a ``MeshPlan`` or None (one device)."""

    lr: float = 2e-4
    epochs: int = 10          # paper: T = 10
    microbatch: int = 8
    patience: int = 2         # early stop when loss plateaus (paper: "converged")
    rel_tol: float = 1e-3
    fused_epochs: bool = True  # the whole block's loop enqueued, one host read
    prefetch_depth: int = 1    # the teacher runs this many visits ahead
    mesh_plan: Optional[Any] = None


@dataclasses.dataclass
class BlockReport:
    """The reference's fields. ``path`` is "fused" or "legacy", the loop
    that ran. A fused block books 1 dispatch and 1 host sync, as the
    reference's fused call; a legacy block's ``dispatches`` count its steps
    as the reference's legacy ledger does (a loss evaluation or a training
    step per microbatch, one reduction per pass, the final masking) and
    ``host_syncs`` the scalars it reads back (two means and one per
    epoch). On one device ``device_dispatches`` equals ``dispatches``,
    ``live_bytes_per_shard`` equals ``live_bytes`` and
    ``collective_bytes`` is 0; on a mesh they follow the plan (the module
    docstring)."""

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


def _global_loss(loss: torch.Tensor) -> torch.Tensor:
    """A loss as one plain scalar on every rank (a DTensor's mean over the
    data-sharded rows is summed across them; a plain loss passes)."""
    return loss.full_tensor() if LK.any_dtensor(loss) else loss


def _loss_and_grads(model, i: int, bw, leaves, mask_bp, h, target, pos, aux=None):
    with torch.enable_grad():
        loss = R.block_loss(model, i, bw, mask_bp, h, target, pos, aux)
        return loss, torch.autograd.grad(loss, leaves)


def _stack_microbatches(data: List[Tuple]):
    """[(h, target, pos, aux), ...] as one stacked nest with a leading
    microbatch axis, or None when the shapes are ragged or there is no
    microbatch (the fused loop needs a uniform leading axis)."""
    if not C._uniform_microbatches(data):
        return None
    return C._stack_map(lambda j: data[j], len(data))


def tune_block(model, i: int, bp: Params, mask_bp: Params, data: List[Tuple],
               ecfg: EBFTConfig, step_cache: Dict,
               stacked: Optional[Tuple] = None) -> Tuple[Params, BlockReport]:
    """Tune block ``i`` on ``data`` = [(h, target, positions[, aux]), ...]
    microbatches (``aux``: the segment's keyword arguments, the
    encoder-decoder's memory); ``stacked`` is the same data stacked (the
    walk's ``h_st``, ``target_st``, ``pos_st``, ``aux_st``), made here
    when ``fused_epochs`` asks for it and None is given. With
    ``fused_epochs`` and uniform microbatches the fused loop runs
    (``_tune_block_fused``), else the per-epoch loop
    (``_tune_block_legacy``). ``bp`` is not modified: the weights being
    tuned are fresh leaf tensors (clones of its views) that Adam updates
    in place under ``torch.no_grad()``. ``step_cache`` (one dict per walk)
    keeps the block kind's first-call timers across blocks. Returns the
    tuned, re-masked block and its report."""
    kind = R.block_kind(model, i)
    if kind not in step_cache:
        step_cache[kind] = (FirstCallTimer(R.block_loss), FirstCallTimer(_loss_and_grads))
    eval_loss, step = step_cache[kind]
    plan = ecfg.mesh_plan
    sharded = plan is not None and plan.active
    if sharded:  # the block's weights and masks over "model"
        bw = T.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        plan.put_block(T.tree_map(lambda t: t.detach(), bp)))
        mask_bp = plan.put_block(mask_bp)
    else:
        bw = T.tree_map(lambda t: t.detach().clone().requires_grad_(True), bp)
    ledger = DispatchLedger("ebft/tune", devices=plan.device_count if sharded else 1)

    with OT.span("ebft/block", index=i, kind=kind) as sp:
        if ecfg.fused_epochs and stacked is None:
            stacked = _stack_microbatches(data)
        tuning = _Tuning(model, i, kind, bw, mask_bp, ecfg, eval_loss, step, sharded, ledger)
        if ecfg.fused_epochs and stacked is not None:
            n_mb = C.stacked_len(stacked)
            report = _tune_block_fused(tuning, C.Unstacked(stacked, n_mb))
        else:
            n_mb = len(data)
            report = _tune_block_legacy(tuning, data)
        with torch.no_grad():
            tuned = apply_masks(T.tree_map(lambda t: t.detach(), bw), mask_bp)
        # the streaming claim, measured: only this block's weights, masks
        # and Adam moments are optimizer-live now
        live = ebft_live_block_bytes(tuned, mask_bp)
        live_shard, collective = live, 0
        if sharded:
            moments = T.tree_map(lambda t: SH.ShapeLeaf(t.shape, torch.float32), tuned)
            live_shard = (plan.sharded_bytes(tuned) + plan.sharded_bytes(mask_bp)
                          + 2 * plan.sharded_bytes(moments))
            # one all-reduce of the block's gradients per optimizer step (ring)
            collective = report.epochs_run * n_mb * plan.allreduce_bytes(live_bytes(tuned))
            tuned = plan.gather(tuned)
        report.live_bytes, report.live_bytes_per_shard = live, live_shard
        report.collective_bytes = collective
        report.device_dispatches = ledger.device_dispatches
        if OT.enabled():
            OM.gauge("ebft/live_block_bytes").set(live)  # summary max = peak
            OM.gauge("ebft/live_block_bytes_per_shard").set(live_shard)
            if collective:
                OM.counter("ebft/collective_bytes").inc(collective)
                OM.gauge("ebft/collective_bytes_per_block").set(collective)
            OM.series("ebft/loss_before").append(report.loss_before, step=i)
            OM.series("ebft/loss_after").append(report.loss_after, step=i)
            OM.series("ebft/epochs_run").append(report.epochs_run, step=i)
            OM.series("ebft/dispatches_per_block").append(report.dispatches, step=i)
            OM.series("ebft/host_syncs_per_block").append(report.host_syncs, step=i)
            OM.counter(f"ebft/early_stop/{report.early_stop}").inc()
            sp.set(epochs=report.epochs_run, loss_before=report.loss_before,
                   loss_after=report.loss_after, early_stop=report.early_stop, live_bytes=live,
                   path=report.path, dispatches=report.dispatches,
                   host_syncs=report.host_syncs, devices=ledger.devices)
    return tuned, report


class _Tuning:
    """What both tuning loops of one block share: the weights ``bw`` (leaf
    tensors, updated in place), masks, Adam, the step and the ledger."""

    def __init__(self, model, i: int, kind: str, bw, mask_bp, ecfg: EBFTConfig,
                 eval_loss: Callable, step: Callable, sharded: bool, ledger: DispatchLedger):
        self.model, self.i, self.kind, self.bw, self.mask_bp = model, i, kind, bw, mask_bp
        self.ecfg, self.eval_loss, self.step = ecfg, eval_loss, step
        self.sharded, self.ledger = sharded, ledger
        self.leaves = [t for _, t in T.leaves_with_path(bw)]
        self.opt = adam(ecfg.lr)

    def mean_loss(self, data) -> torch.Tensor:
        """The mean loss over the microbatches, on the device."""
        with torch.no_grad():
            return torch.stack([_global_loss(self.eval_loss(self.model, self.i, self.bw,
                                                            self.mask_bp, *mb))
                                for mb in data]).mean()

    def epoch(self, data, state, keep=None):
        """One Adam step per microbatch; returns the epoch's mean loss (on
        the device) and the optimizer state. Where ``keep`` (a 0-d bool
        tensor) is true the weights keep their values."""
        losses = []
        for mb in data:
            loss, grads = self.step(self.model, self.i, self.bw, self.leaves, self.mask_bp, *mb)
            if self.sharded:
                grads = LK.reduce_grads(grads, self.leaves)
            it = iter(grads)
            updates, state = self.opt.update(T.tree_map(lambda _: next(it), self.bw), state,
                                             self.bw)
            if keep is None:
                apply_updates(self.bw, updates)
            else:
                _apply_updates_unless(keep, self.bw, updates)
            losses.append(_global_loss(loss.detach()))
        return torch.stack(losses).mean(), state

    def report(self, epochs_run, before, after, early_stop, history, path) -> BlockReport:
        """The loop's report; ``tune_block`` adds the sizes."""
        return BlockReport(self.i, self.kind, epochs_run, before, after, early_stop, history, 0,
                           path, self.ledger.dispatches, self.ledger.host_syncs)


def _tune_block_legacy(tn: _Tuning, data: List[Tuple]) -> BlockReport:
    """The reference's per-epoch loop: the plateau check on the host, one
    read of the epoch mean per epoch."""
    n_mb, ledger, ecfg = len(data), tn.ledger, tn.ecfg

    def eval_mean() -> float:
        mean = tn.mean_loss(data)
        ledger.dispatch(n_mb + 1)
        ledger.host_sync()
        return float(mean)

    before = eval_mean()
    state = tn.opt.init(tn.bw)
    history: List[float] = [before]
    epochs_run = 0
    early_stop = "max_epochs"
    for _ in range(ecfg.epochs):
        mean, state = tn.epoch(data, state)
        ledger.dispatch(n_mb + 1)
        ledger.host_sync()
        epochs_run += 1
        # obs: sync-ok (host-side plateau check needs the epoch mean)
        history.append(float(mean))
        if plateau_early_stop(history, ecfg.patience, ecfg.rel_tol):
            early_stop = "plateau"
            break
    after = eval_mean()
    ledger.dispatch()  # the final masking
    return tn.report(epochs_run, before, after, early_stop, history, "legacy")


def _tune_block_fused(tn: _Tuning, data: "C.Unstacked") -> BlockReport:
    """The reference's ``fused_run``, run eagerly: every epoch is enqueued
    and the plateau is decided on the device (``plateau_early_stop_device``),
    so the host reads the block once, after the last. An epoch after the
    stop is computed and its updates discarded (the weights keep their
    bits; the reference's ``lax.cond`` skips it); Adam's moments need no
    guard, since nothing reads them once ``plateaued`` is set, and it never
    clears."""
    E, ecfg = tn.ecfg.epochs, tn.ecfg
    before = tn.mean_loss(data)
    state = tn.opt.init(tn.bw)
    dev = before.device
    hist = torch.full((E + 1,), math.inf, dtype=torch.float32, device=dev)
    hist[0] = before
    n_run = torch.zeros((), dtype=torch.int32, device=dev)
    plateaued = torch.zeros((), dtype=torch.bool, device=dev)
    for e in range(E):
        mean, state = tn.epoch(data, state, keep=plateaued)
        live = ~plateaued
        hist[e + 1] = torch.where(live, mean, hist[e + 1])
        n_run = n_run + live.to(torch.int32)
        plateaued = plateaued | plateau_early_stop_device(hist, n_run + 1, ecfg.patience,
                                                          ecfg.rel_tol)
    after = tn.mean_loss(data)
    # the block's one host read: its scalars and loss history
    got = torch.cat([torch.stack([before, after, n_run.to(torch.float32),
                                  plateaued.to(torch.float32)]), hist]).tolist()
    tn.ledger.dispatch()
    tn.ledger.host_sync()
    epochs_run = int(got[2])
    return tn.report(epochs_run, got[0], got[1], "plateau" if got[3] else "max_epochs",
                     got[4:5 + epochs_run], "fused")


@torch.no_grad()
def _apply_updates_unless(keep: torch.Tensor, params, updates) -> None:
    """``apply_updates`` where ``keep`` (a 0-d bool tensor) is false; the
    weights keep their bits where it is true. No host read."""
    T.tree_map(lambda p, u: p.copy_(torch.where(keep, p, p + u.to(p.dtype))), params, updates)


def finetune(model, dense_params: Params, pruned_params: Params, masks: Params,
             calib: np.ndarray, ecfg: Optional[EBFTConfig] = None,
             extra_batch: Optional[Dict[str, Any]] = None,
             log: Optional[Callable[[str], None]] = None) -> Tuple[Params, List[BlockReport]]:
    """Algorithm 1 over the whole model. ``masks`` is a full mask tree (``core.masks``);
    ``extra_batch`` the calibration batch's other arrays (a VLM's
    ``patches``, an encoder-decoder's ``frames``). The encoder-decoder's
    blocks are tuned encoder first (kind ``"enc"``), then decoder (``"dec"``),
    whose teacher reads the dense encoder's memory and student the memory
    of its tuned encoder.
    Returns (fine-tuned sparse params, per-block reports); the student is a
    fresh tree, ``apply_masks(pruned_params, masks)``, so neither input
    tree is written."""
    ecfg = ecfg or EBFTConfig()
    plan = ecfg.mesh_plan
    if plan is not None and not isinstance(plan, MeshPlan):
        raise TypeError(f"EBFTConfig.mesh_plan must be a MeshPlan or None, got "
                        f"{type(plan).__name__}")
    sharded = plan is not None and plan.active
    with OT.span("ebft/walk", epochs=ecfg.epochs, lr=ecfg.lr, microbatch=ecfg.microbatch,
                 fused=ecfg.fused_epochs, prefetch_depth=ecfg.prefetch_depth,
                 mesh_devices=plan.device_count if sharded else 1):
        student = apply_masks(pruned_params, masks)
        reports: List[BlockReport] = []
        step_cache: Dict = {}
        shared_idx = model.num_blocks - 1 if model.cfg.family == "hybrid" else None
        shared_sites: List[Tuple] = []

        def visit(i, bp, ctx):
            data = list(zip(ctx["h_mb"], ctx["target_mb"], ctx["pos_mb"], ctx["aux_mb"]))
            if i == shared_idx:
                shared_sites.extend(data)  # tuned once on the union of the sites
                return None
            stacked = None
            if "h_st" in ctx:
                stacked = (ctx["h_st"], ctx["target_st"], ctx["pos_st"], ctx["aux_st"])
            tuned, rep = tune_block(model, i, bp, model.get_block(masks, i), data, ecfg,
                                    step_cache, stacked)
            reports.append(rep)
            if log:
                log(f"block {i:3d} [{rep.kind}] epochs={rep.epochs_run} "
                    f"E: {rep.loss_before:.3e} -> {rep.loss_after:.3e}")
            return tuned

        result = C.walk_blocks(model, dense_params, calib, visit, microbatch=ecfg.microbatch,
                               extra_batch=extra_batch, params_student=student, masks=masks,
                               dual_stream=True, prefetch_depth=ecfg.prefetch_depth,
                               mesh_plan=plan)
        if shared_sites:
            # tune_block trains clones of the live leaves get_block returns
            # and stacks the sites' microbatches for the fused loop; on a
            # mesh they are the walk's sharded ones
            with C.mesh_scope(plan):
                tuned, rep = tune_block(model, shared_idx, model.get_block(result, shared_idx),
                                        model.get_block(masks, shared_idx), shared_sites,
                                        ecfg, step_cache)
            reports.append(rep)
            if log:
                log(f"shared block [{rep.kind}] ({len(shared_sites)} site-batches) "
                    f"E: {rep.loss_before:.3e} -> {rep.loss_after:.3e}")
            result = model.set_block(result, shared_idx, tuned)
    return result, reports
