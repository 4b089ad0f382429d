"""Shared machinery for the calibration-based pruning methods and EBFT
(port of ``repro.core.pruning.common``: statistics, the single-stream walk
of the pruning methods and the dual-stream walk of EBFT).

The hidden stream is propagated block by block over the calibration set
in microbatches; the per-linear input activations are tapped
(``sparsity/taps.py``) and per-leaf statistics accumulated in f32:

    n        total tokens seen
    sum      sum_t X[t]         (R,)   -- DSnoT's expected input (the mean)
    sumsq    sum_t X[t]^2       (R,)   -- Wanda's ||X_j||_2^2, FLAP's fluctuation
    hessian  sum_t X[t] X[t]^T  (R, R) -- SparseGPT's Gram (opt-in), in f64

Expert-batched leaves (the (E, C, R) taps of an MoE block's routed
experts) get a leading E axis on every stat, and ``n`` counts the C slots
of each expert's slab, filled or not, as the reference's.

The sums are taken in another order than XLA's, so a score that sits on
its comparison group's threshold can land on the other side of it. The
Gram is summed in f64 and rounded to f32 where SparseGPT takes it; the
reference sums it in f32. From there SparseGPT works in f32, as the
reference. On the card, a pretrained Llama-width block's f32 sum (the
GEMM's f32 accumulation over 16384 rows a microbatch) left a Gram further
from positive semi-definite than SparseGPT's 1% damping reaches, and its
Cholesky failed; the readings are in PERF.md (``chip_smoke.py``, path A).
"""
from __future__ import annotations

import contextlib

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.core import reconstruction as R
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import DispatchLedger, FirstCallTimer, compile_clock
from repro_torch.sparsity import sparse_params as SP
from repro_torch.sparsity.taps import taps_for_block


def tap_key(path_names: Tuple[str, ...]) -> str:
    """Map a block-param leaf path to its taps-dict key."""
    return "/".join(path_names[-2:])


def lookup_tap(taps: Dict[str, torch.Tensor], names: Tuple[str, ...]):
    k2 = tap_key(names)
    if k2 in taps:
        return taps[k2]
    return taps.get(names[-1])


def iter_prunable(block_params) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path_names, leaf) for every prunable leaf of a block."""
    return [(names, leaf) for names, leaf in T.leaves_with_path(block_params)
            if SP.is_prunable(names, leaf)]


@dataclasses.dataclass
class LeafStats:
    n: float
    sum: torch.Tensor    # (R,) or (E, R)
    sumsq: torch.Tensor  # (R,) or (E, R)
    hessian: Optional[torch.Tensor] = None  # (R, R) or (E, R, R)

    @property
    def mean(self):
        return self.sum / max(self.n, 1.0)

    @property
    def col_norm(self):
        return torch.sqrt(self.sumsq.clamp_min(0.0))

    @property
    def fluctuation(self):
        """sum_t (X[t] - mean)^2 per column (FLAP's variance mass)."""
        return (self.sumsq - self.n * torch.square(self.mean)).clamp_min(0.0)


def full_f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32 as the reference takes it: refuses to run where the
    card's f32 matmul is set to round its inputs to TF32."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("an f32 matmul of the pruning methods ran with TF32 allowed; "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    return a @ b


def _acc_stats(x: torch.Tensor, want_hessian: bool = False) -> LeafStats:
    """x: (T, R) activation matrix, or (E, C, R) expert-batched, for one
    microbatch."""
    x32 = x.float()
    h = None
    if want_hessian:
        x64 = x.double()
        h = x64.transpose(-2, -1) @ x64
    return LeafStats(float(x.shape[-2]), x32.sum(dim=-2), x32.square().sum(dim=-2), h)


def _merge(a: Optional[LeafStats], b: LeafStats) -> LeafStats:
    if a is None:
        return b
    h = None
    if b.hessian is not None:
        h = b.hessian if a.hessian is None else a.hessian + b.hessian
    return LeafStats(a.n + b.n, a.sum + b.sum, a.sumsq + b.sumsq, h)


def collect_block_stats(model, bp, block_index: int, h_mb: List[torch.Tensor],
                        pos_mb: List[torch.Tensor], aux_mb: Optional[List[Dict]] = None,
                        want_hessian: bool = False) -> Dict[str, LeafStats]:
    """Run block ``block_index``'s taps over each microbatch of the stream
    (``aux_mb``: each microbatch's segment aux, the encoder memory);
    accumulate stats (with ``want_hessian``, each leaf's f64 Gram too, but
    ``conv_w``'s: no method reads it). Keys whose taps are one tensor (the
    projections that read one input: wq, wk and wv; an expert's w_gate and
    w_up; a Mamba block's five in-projections) share one stats object, so
    each Gram is summed and held once."""
    tapfn = taps_for_block(model.cfg, block_index, model.num_blocks)
    stats: Dict[str, LeafStats] = {}
    alias: Dict[str, str] = {}
    for h, pos, aux in zip(h_mb, pos_mb, aux_mb or [{}] * len(h_mb)):
        first: Dict[int, str] = {}
        for key, x in tapfn(bp, model.cfg, h, pos, **aux).items():
            alias[key] = first.setdefault(id(x), key)
            if alias[key] == key:
                stats[key] = _merge(stats.get(key),
                                    _acc_stats(x, want_hessian and key != "conv_w"))
    return {key: stats[src] for key, src in alias.items()}


def stats_for_leaf(stats: Dict[str, LeafStats], names: Tuple[str, ...]) -> Optional[LeafStats]:
    return lookup_tap(stats, names)


def batch_slice(tokens, extra_batch: Optional[Dict], s: int, e: int,
                device) -> Dict[str, torch.Tensor]:
    """Rows ``s:e`` of ``tokens`` and of every ``extra_batch`` array (a VLM's
    ``patches``), as one batch on ``device``."""
    b = {"tokens": torch.as_tensor(tokens[s:e], device=device)}
    for k, v in (extra_batch or {}).items():
        b[k] = torch.as_tensor(v[s:e], device=device)
    return b


def _make_batches(calib: np.ndarray, microbatch: int, device,
                  extra_batch: Optional[Dict] = None) -> List[Dict[str, torch.Tensor]]:
    return [batch_slice(calib, extra_batch, s, s + microbatch, device)
            for s in range(0, calib.shape[0], microbatch)]


def _aux_kw(aux: Dict) -> Dict:
    """``R.advance_with``'s ``aux`` argument, left out where a segment has
    none."""
    return {"aux": aux} if aux else {}


def walk_blocks(model, params, calib: np.ndarray, visit_fn: Callable, microbatch: int = 8,
                extra_batch: Optional[Dict] = None, params_student=None, masks=None,
                dual_stream: bool = False, mesh_plan=None):
    """Block-by-block calibration walk over per-microbatch lists.

    Single-stream mode (the pruning methods, Wanda/SparseGPT convention):
    one stream advances through the already-updated blocks. The reference
    also hands each such visit ``target_mb``, the dense block's output on
    the same input; no ported pruning visitor reads it, so this mode does
    not compute it.

    Dual-stream mode (EBFT, Eq. 3/4): the teacher stream propagates through
    the dense ``params`` and the student stream through
    ``params_student``; each visit sees the student's inputs (``h_mb``) and
    the teacher's outputs (``target_mb``), computed just before the visit
    (the reference's prefetch depth 0). Enqueuing the teacher ahead on the
    same stream overlaps nothing on the card; a side-stream teacher is
    later work (ROADMAP.md).

    ``extra_batch`` holds the batch's other arrays beside the tokens (the
    VLM's ``patches`` (N, P, d), the encoder-decoder's ``frames`` (N, F,
    d)), sliced per microbatch as the tokens are and moved to the walk's
    device.

    A segment's ``aux`` (the encoder-decoder's memory) is computed once per
    microbatch when the segment starts, as the reference's: in single-stream
    mode from the dense ``params`` (the reference's list walk takes the
    stream's start and aux from ``params``, so every decoder visit sees the
    dense encoder's memory, never the pruned one); in dual-stream mode the
    teacher's from ``params`` and the student's from its own tree under
    ``masks``, after every encoder block has been tuned (its stored
    weights are masked, so the masks change no value; they route the
    encoder's linears through the masked matmul kernel).

    ``visit_fn(i, bp, ctx)`` returns the block's new params or None; ctx
    holds ``h_mb``, ``pos_mb``, ``aux_mb`` (the student stream's aux per
    microbatch), ``site`` (and ``target_mb`` in dual-stream mode). With
    ``masks`` (a full mask tree, which a pruning visitor fills in), each
    student advance runs the block's masked linears through the masked
    matmul kernel; the teacher runs dense. Returns the updated
    params (``params_student``, updated in place; never ``params`` in
    dual-stream mode).

    Observability (dual-stream mode, as the reference's stacked walk): each
    visit is wrapped in the spans ``walk/teacher``, ``walk/tune`` and
    ``walk/student`` (``block=i``), each fencing its result, so a live run
    adds three synchronises a block. Their seconds, less the first calls'
    host time (``FirstCallTimer`` on the advances, drained from the
    compile clock per phase), go to the histograms
    ``ebft/walk/{teacher,tune,student}_s`` and the first calls' to
    ``…_compile_s``. A ``DispatchLedger("ebft/walk")`` counts one dispatch
    per microbatch advance: each stream's ``h0`` per segment, then the
    teacher's and the student's advance per block. The reference counts
    one per scanned advance of the stacked microbatches; the port's loop
    advances microbatch by microbatch, and that is its unit; a segment's
    aux counts one more per microbatch and stream. The
    reference's ``ebft/walk/prefetch_inflight`` gauge has no counterpart
    (no prefetcher).

    With an active ``mesh_plan`` (EBFT on a mesh, ``core/ebft.py``) each
    microbatch of both streams is sharded on its batch dim over the data
    axes when its segment starts (``plan.put_stacked``); the advances run
    SPMD on those shards, with the blocks' weights whole on every rank,
    under the plan's activation policy (``act_sharding``) and DTensor's
    implicit replication of plain tensors. ``visit_fn`` returns whole
    tensors.
    """
    put = mesh_plan.put_stacked if mesh_plan is not None else (lambda x: x)
    with mesh_scope(mesh_plan):
        return _walk(model, params, calib, visit_fn, microbatch, extra_batch, params_student,
                     masks, dual_stream, put)


def mesh_scope(mesh_plan):
    """The context a walk's work runs in on an active plan: the plan's
    activation policy (``act_sharding``) and DTensor's implicit
    replication of the plain tensors a block makes (positions, RoPE
    tables). A no-op otherwise."""
    stack = contextlib.ExitStack()
    if mesh_plan is not None and mesh_plan.active:
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.distributed import act_sharding as AS

        stack.enter_context(implicit_replication())
        stack.enter_context(AS.policy(AS.make_mesh_policy(mesh_plan.mesh)))
    return stack


def _walk(model, params, calib, visit_fn, microbatch, extra_batch, params_student, masks,
          dual_stream, put_stream):
    out_params = params_student if params_student is not None else params
    if dual_stream and out_params is params:
        raise ValueError("walk_blocks: the dual-stream walk needs a student tree of its own "
                         "(set_block writes in place; the teacher must stay dense)")
    device = params["embed"]["tok"].device
    batch_all = _make_batches(calib, microbatch, device, extra_batch)
    span = OT.span if dual_stream else (lambda name, **attrs: OT.NULL_SPAN)
    ledger = DispatchLedger("ebft/walk")
    clock = compile_clock()
    clock.take()  # drop first-call time booked before this walk started
    adv = FirstCallTimer(R.advance_with)
    for seg in R.execution_plan(model):
        hs_mb, ht_mb, pos_mb = [], [], []
        aux_s = aux_t = [{}] * len(batch_all)
        with torch.no_grad():
            for b in batch_all:
                h, pos = seg.h0(out_params, b)
                hs_mb.append(h)
                pos_mb.append(pos)
                if dual_stream:
                    ht_mb.append(seg.h0(params, b)[0])
            if seg.aux is not None:
                aux_t = [seg.aux(params, b) for b in batch_all]
                aux_s = [seg.aux(out_params, b, masks) for b in batch_all] if dual_stream \
                    else aux_t
            hs_mb = [put_stream(h) for h in hs_mb]
            ht_mb = [put_stream(h) for h in ht_mb]
        if dual_stream:
            ledger.dispatch((2 if seg.aux is None else 4) * len(batch_all))
        clock.take()  # segment setup is not a phase
        for (i, site) in seg.visits:
            ctx = dict(h_mb=hs_mb, pos_mb=pos_mb, aux_mb=aux_s, site=site)
            if dual_stream:
                dense_bp = model.get_block(params, i)
                with span("walk/teacher", block=i) as sp_t, torch.no_grad():
                    ht_mb = sp_t.fence([adv(model, params, i, dense_bp, h, p, **_aux_kw(a))
                                        for h, p, a in zip(ht_mb, pos_mb, aux_t)])
                    ledger.dispatch(len(ht_mb))
                ctx["target_mb"] = ht_mb
            c_teacher = clock.take()
            bp = model.get_block(out_params, i)
            with span("walk/tune", block=i) as sp_v:
                new_bp = sp_v.fence(visit_fn(i, bp, ctx))
            c_tune = clock.take()
            if new_bp is not None:
                out_params = model.set_block(out_params, i, new_bp)
                bp = model.get_block(out_params, i)
            mb = model.get_block(masks, i) if masks is not None else None
            with span("walk/student", block=i) as sp_s, torch.no_grad():
                hs_mb = sp_s.fence([adv(model, out_params, i, bp, h, p, mb, **_aux_kw(a))
                                    for h, p, a in zip(hs_mb, pos_mb, aux_s)])
                if dual_stream:
                    ledger.dispatch(len(hs_mb))
            c_student = clock.take()
            if dual_stream and OT.enabled():
                for phase, sp, c in (("teacher", sp_t, c_teacher), ("tune", sp_v, c_tune),
                                     ("student", sp_s, c_student)):
                    OM.histogram(f"ebft/walk/{phase}_s").observe(max(sp.duration - c, 0.0))
                    OM.histogram(f"ebft/walk/{phase}_compile_s").observe(c)
    return out_params
