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
from repro_torch.distributed import local_kernels as LK
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
                dual_stream: bool = False, prefetch_depth: int = 0, mesh_plan=None):
    """Block-by-block calibration walk.

    Single-stream mode (the pruning methods, Wanda/SparseGPT convention):
    one stream advances, as per-microbatch lists, through the
    already-updated blocks. The reference also hands each such visit
    ``target_mb``, the dense block's output on the same input; no ported
    pruning visitor reads it, so this mode does not compute it.

    Dual-stream mode (EBFT and mask tuning, Eq. 3/4): the teacher stream
    propagates through the dense ``params`` and the student stream
    through ``params_student``; each visit sees the student's inputs
    (``h_mb``) and the teacher's outputs (``target_mb``). When every
    microbatch has the same shapes (``_uniform_microbatches``) the streams
    are kept stacked (``_walk_blocks_stacked``): each is one tensor with a
    leading microbatch axis, the teacher runs ``prefetch_depth`` visits
    ahead of the visitor (:class:`TeacherPrefetcher`), and the visit also
    receives ``h_st``, ``target_st``, ``pos_st`` and ``aux_st``, so a fused
    tuner never re-stacks; its ``*_mb`` are then :class:`Unstacked` views.
    Ragged shapes fall back to the per-microbatch list walk, with the
    teacher computed just before each visit.

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
    ``walk/student`` (``block=i``). The tune and student spans fence their
    result on the walk's stream (``trace.fence``, which leaves a prefetched
    teacher on its side stream running); the teacher span holds the
    prefetcher's wait for the visit's targets. Their seconds, less the
    first calls' host time (``FirstCallTimer`` on the advances, drained
    from the compile clock per phase), go to the histograms
    ``ebft/walk/{teacher,tune,student}_s`` and the first calls' to
    ``…_compile_s``; the stacked walk also sets the gauge
    ``ebft/walk/prefetch_inflight`` after each visit. A
    ``DispatchLedger("ebft/walk")`` counts the reference's units: in the
    stacked walk 4 per segment setup (each stream's start and aux) and one
    per stacked advance of a stream, and one host sync per teacher wait;
    in the list walk one per microbatch advance (each stream's ``h0`` per
    segment, a segment's aux one more per microbatch and stream, then the
    teacher's and the student's advance per block).

    With an active ``mesh_plan`` (EBFT on a mesh, ``core/ebft.py``) each
    microbatch of both streams, and of both streams' segment aux (the
    memory (B, F, d)), is sharded on its batch dim over the data axes when
    its segment starts (``plan.put_stacked``, the microbatch's own
    ``microbatch_spec``; a stacked stream holds each rank's pieces under
    the same placements one dim further); the advances run
    SPMD on those shards, with the blocks' weights whole on every rank,
    under the plan's activation policy (``act_sharding``) and DTensor's
    implicit replication of plain tensors. The teacher is then prefetched
    on the walk's own stream. ``visit_fn`` returns whole tensors.
    """
    out_params = params_student if params_student is not None else params
    if dual_stream and out_params is params:
        raise ValueError("walk_blocks: the dual-stream walk needs a student tree of its own "
                         "(set_block writes in place; the teacher must stay dense)")
    put = mesh_plan.put_stacked if mesh_plan is not None else (lambda x: x)
    batch_all = _make_batches(calib, microbatch, params["embed"]["tok"].device, extra_batch)
    with mesh_scope(mesh_plan):
        if dual_stream and _uniform_microbatches(batch_all):
            return _walk_blocks_stacked(model, params, out_params, batch_all, visit_fn, masks,
                                        prefetch_depth, mesh_plan, put)
        return _walk(model, params, out_params, batch_all, visit_fn, masks, dual_stream, put)


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


def _walk(model, params, out_params, batch_all, visit_fn, masks, dual_stream, put_stream):
    """The per-microbatch list walk (the pruning methods; ragged EBFT)."""
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
            # the memory with its microbatch: the same rows on the same ranks
            hs_mb, ht_mb, aux_s, aux_t = ([put_stream(x) for x in xs]
                                          for xs in (hs_mb, ht_mb, aux_s, aux_t))
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


# ---------------------------------------------------------------------------
# The stacked dual-stream walk (uniform microbatches)
# ---------------------------------------------------------------------------
def _nest_map(fn: Callable, nest, *rest):
    """``fn`` over the tensors of a nest of dicts, tuples and lists (and
    the matching leaves of ``rest``); other leaves pass."""
    if isinstance(nest, dict):
        return {k: _nest_map(fn, v, *(r[k] for r in rest)) for k, v in nest.items()}
    if isinstance(nest, (tuple, list)):
        return type(nest)(_nest_map(fn, v, *(r[j] for r in rest)) for j, v in enumerate(nest))
    return fn(nest, *rest) if isinstance(nest, torch.Tensor) else nest


def _signature(nest):
    """A nest's structure with each tensor's shape and dtype."""
    if isinstance(nest, dict):
        return ("d",) + tuple((k, _signature(v)) for k, v in nest.items())
    if isinstance(nest, (tuple, list)):
        return (type(nest).__name__,) + tuple(_signature(v) for v in nest)
    if isinstance(nest, torch.Tensor):
        return tuple(nest.shape), nest.dtype
    return ("v", type(nest).__name__)


def _uniform_microbatches(batch_all: List) -> bool:
    """True when every microbatch has the same structure and leaf shapes
    (the stacked walk and the fused tuner need a uniform leading axis)."""
    return bool(batch_all) and all(_signature(b) == _signature(batch_all[0])
                                   for b in batch_all[1:])


def _shifted(placements, by: int):
    """A microbatch's placements on its stack (``by`` 1) or back (-1): a
    sharded dim moves past the microbatch axis."""
    from torch.distributed.tensor import Shard

    return [Shard(p.dim + by) if isinstance(p, Shard) else p for p in placements]


def _from_local(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _stacked_buffer(x: torch.Tensor, n: int) -> torch.Tensor:
    """An (n, *x.shape) tensor like ``x`` for ``n`` microbatches, not yet
    written. A DTensor's is each rank's pieces stacked, under ``x``'s
    placements one dim further."""
    if LK.any_dtensor(x):
        local = x.to_local()
        return _from_local(torch.empty((n, *local.shape), dtype=local.dtype, device=local.device),
                           x.device_mesh, _shifted(x.placements, 1), (n, *x.shape))
    return torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)


def _microbatch(st: torch.Tensor, j: int) -> torch.Tensor:
    """Microbatch ``j`` of a stacked tensor: a view, no copy."""
    if LK.any_dtensor(st):
        return _from_local(st.to_local()[j], st.device_mesh, _shifted(st.placements, -1),
                           st.shape[1:])
    return st[j]


def _write_microbatch(st: torch.Tensor, j: int, x: torch.Tensor) -> None:
    if LK.any_dtensor(st):
        if list(_shifted(st.placements, -1)) != list(x.placements):
            raise ValueError(f"stacked walk: microbatch {j} is laid out {x.placements}, "
                             f"the stream {_shifted(st.placements, -1)}")
        st.to_local()[j].copy_(x.to_local())
    else:
        st[j].copy_(x)


def _stack_map(fn: Callable, n: int):
    """``fn(j)`` for each microbatch ``j < n`` (a nest of tensors), written
    into one stacked nest as it comes, so that one microbatch's
    intermediates are live at a time (the reference's ``lax.map``)."""
    out = None
    with torch.no_grad():
        for j in range(n):
            y = fn(j)
            if out is None:
                out = _nest_map(lambda t: _stacked_buffer(t, n), y)
            _nest_map(lambda o, t: _write_microbatch(o, j, t), out, y)
    return out


def stacked_len(stacked) -> int:
    """The microbatches of a stacked nest (its tensors' leading dim)."""
    return next(iter(T.tensors(stacked))).shape[0]


class Unstacked:
    """Lazy per-microbatch views of a stacked nest.

    The stacked walk keeps each stream as one tensor with a leading
    microbatch axis; visitors that read lists (mask tuning, the legacy
    tuning loop) read ``ctx["h_mb"][j]``, which is a view of microbatch
    ``j`` (no copy), so a visitor that reads only the stacked form (the
    fused tuner) costs nothing here."""

    __slots__ = ("tree", "n")

    def __init__(self, tree, n: int):
        self.tree = tree
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, j):
        if not -self.n <= j < self.n:
            raise IndexError(j)
        return _nest_map(lambda a: _microbatch(a, j), self.tree)

    def __iter__(self):
        return (self[j] for j in range(self.n))


def _advance_stacked(model, params, i: int, bp, h_st, pos_st, aux_st, masks_b=None):
    """Block ``i`` over every microbatch of a stacked stream, into one
    stacked output (one stacked advance: the reference's ``adv_scan``)."""
    def one(j):
        aux = _nest_map(lambda a: _microbatch(a, j), aux_st)
        return R.advance_with(model, params, i, bp, _microbatch(h_st, j), _microbatch(pos_st, j),
                              masks_b, **_aux_kw(aux))

    return _stack_map(one, stacked_len(h_st))


class TeacherPrefetcher:
    """The teacher stream enqueued ahead of the visitor (the reference's
    dispatch-ahead prefetcher, DESIGN.md §3).

    The teacher depends only on the dense ``params``, never on the
    student's updates, so visit k+1 … k+depth's targets can be enqueued
    while visit k tunes. On the card they run on ``stream``, a side
    stream of the walk's device: at segment setup it waits on an event
    recorded after the teacher's start, positions and aux, and each
    visit's targets get an event of their own. ``get(k)`` synchronises
    visit k's event (one host sync, where the reference calls
    ``block_until_ready``), makes the walk's stream wait on it and hands
    each target tensor over to that stream (``record_stream``), so the
    caching allocator cannot give its memory away under a read still
    queued there. At most ``depth + 1`` visits' targets are alive.

    ``stream`` None (the CPU, depth 0, an active mesh plan, whose gloo
    collectives cross the host) enqueues on the walk's own stream: only
    the order of the calls changes, and ``get`` fences the targets.
    ``depth`` 0 is the strictly serial order: visit k's targets are
    computed just before visit k.
    """

    def __init__(self, model, params, visits, adv: Callable, ht_st, pos_st, aux_t_st,
                 depth: int, ledger=None, stream=None):
        self.model = model
        self.params = params
        self.visits = visits
        self.adv = adv
        self.pos_st = pos_st
        self.aux_t_st = aux_t_st
        self.depth = max(int(depth), 0)
        self.ledger = ledger
        self.stream = stream
        self._ht = ht_st                    # the teacher stream before visit _next
        self._targets: Dict[int, Tuple] = {}  # visit -> (stacked targets, its event)
        self._next = 0
        if stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(stream.device))
            stream.wait_event(ready)
            for t in T.tensors((ht_st, pos_st, aux_t_st)):
                t.record_stream(stream)  # made on the walk's stream, read on this one

    def _dispatch_until(self, k: int) -> None:
        last = min(k, len(self.visits) - 1)
        while self._next <= last:
            i, _site = self.visits[self._next]
            dense_bp = self.model.get_block(self.params, i)
            with (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext()):
                t = self.adv(self.model, self.params, i, dense_bp, self._ht, self.pos_st,
                             self.aux_t_st)
                done = None
                if self.stream is not None:
                    done = torch.cuda.Event()
                    done.record(self.stream)
            if self.ledger is not None:
                self.ledger.dispatch()
            self._targets[self._next] = (t, done)
            self._ht = t                    # Eq. 3: the teacher feeds the teacher
            self._next += 1

    def in_flight(self) -> int:
        return len(self._targets)

    def get(self, k: int):
        """Visit ``k``'s stacked targets, waited for where they are consumed."""
        self._dispatch_until(k + self.depth)
        t, done = self._targets.pop(k)
        if done is None:
            OT.fence(t)
        else:
            done.synchronize()
            walk = torch.cuda.current_stream(self.stream.device)
            walk.wait_event(done)
            for x in T.tensors(t):
                x.record_stream(walk)
        if self.ledger is not None:
            self.ledger.host_sync()
        return t


_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device):
    """The teacher's side stream on ``device``, one for the process. cuBLAS
    keeps a workspace for every stream it has run on until the process
    ends, and ``empty_cache`` does not return it, so a new stream for each
    walk would leave a workspace behind each time, and with it the cached
    segment it sits in."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _walk_blocks_stacked(model, params, out_params, batch_all, visit_fn, masks,
                         prefetch_depth: int, mesh_plan, put_stream):
    """The stacked dual-stream walk: one stacked advance per stream and
    block, the teacher ``prefetch_depth`` visits ahead. On an active plan
    every microbatch of both streams is put on the data axes when its
    segment starts, so every advance and every prefetched target stays
    sharded."""
    sharded = mesh_plan is not None and mesh_plan.active
    ledger = DispatchLedger("ebft/walk", devices=mesh_plan.device_count if sharded else 1)
    clock = compile_clock()
    clock.take()  # drop first-call time booked before this walk started
    n = len(batch_all)
    device = params["embed"]["tok"].device
    side = (_side_stream(device) if device.type == "cuda" and prefetch_depth > 0
            and not sharded else None)
    adv = FirstCallTimer(_advance_stacked)
    for seg in R.execution_plan(model):
        def h0(tree):
            def one(j):
                h, pos = seg.h0(tree, batch_all[j])
                return put_stream(h), pos
            return _stack_map(one, n)

        # stream setup: each stream's start and aux, the reference's 4 dispatches
        ht_st, pos_st = h0(params)
        hs_st, _ = h0(out_params)
        aux_t_st = aux_s_st = {}
        if seg.aux is not None:
            # the memory with its microbatch: the same rows on the same ranks
            aux_t_st = _stack_map(lambda j: put_stream(seg.aux(params, batch_all[j])), n)
            aux_s_st = _stack_map(lambda j: put_stream(seg.aux(out_params, batch_all[j], masks)),
                                  n)
        ledger.dispatch(4)
        pf = TeacherPrefetcher(model, params, seg.visits, adv, ht_st, pos_st, aux_t_st,
                               prefetch_depth, ledger=ledger, stream=side)
        del ht_st  # the prefetcher holds the teacher stream from here
        clock.take()  # segment setup is not a phase
        for k, (i, site) in enumerate(seg.visits):
            with OT.span("walk/teacher", block=i) as sp_t, torch.no_grad():
                target_st = pf.get(k)
            c_teacher = clock.take()
            bp = model.get_block(out_params, i)
            ctx = dict(h_st=hs_st, target_st=target_st, pos_st=pos_st, aux_st=aux_s_st,
                       site=site, h_mb=Unstacked(hs_st, n), target_mb=Unstacked(target_st, n),
                       pos_mb=Unstacked(pos_st, n), aux_mb=Unstacked(aux_s_st, n))
            with OT.span("walk/tune", block=i) as sp_v:
                new_bp = sp_v.fence(visit_fn(i, bp, ctx))
            c_tune = clock.take()
            del ctx, target_st  # gone before the next teacher advance is enqueued
            if new_bp is not None:
                out_params = model.set_block(out_params, i, new_bp)
                bp = model.get_block(out_params, i)
            mb = model.get_block(masks, i) if masks is not None else None
            with OT.span("walk/student", block=i) as sp_s, torch.no_grad():
                hs_st = sp_s.fence(adv(model, out_params, i, bp, hs_st, pos_st, aux_s_st, mb))
                ledger.dispatch()
            c_student = clock.take()
            if OT.enabled():
                for phase, sp, c in (("teacher", sp_t, c_teacher), ("tune", sp_v, c_tune),
                                     ("student", sp_s, c_student)):
                    OM.histogram(f"ebft/walk/{phase}_s").observe(max(sp.duration - c, 0.0))
                    OM.histogram(f"ebft/walk/{phase}_compile_s").observe(c)
                OM.gauge("ebft/walk/prefetch_inflight").set(pf.in_flight())
    return out_params
