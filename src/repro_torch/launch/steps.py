"""Sharded step cells shared by the launchers and the dry run (port of
``repro.launch.steps``).

For each (config × shape cell × mesh) this module builds the step
function, the in- and out-specs of its arguments and results, and its
abstract arguments (``ShapeLeaf``s under ``FakeTensorMode``: nothing is
allocated, so every cell builds on an ``AbstractMesh`` at any width).
The kinds, as the reference's:

  * train   — loss and gradients (f32 accumulation over microbatches),
    global-norm clipping and AdamW;
  * prefill — one whole-prompt forward filling the KV cache;
  * decode  — one new token against a cache of depth ``seq_len``;
  * ebft    — one Adam step of block-wise reconstruction (the paper's
    Alg. 1 inner loop) on a mid-stack block.

The production numerics are the reference's (``adapt_config``): bf16
weights and activations, f32 moments ZeRO-1-sharded over "data", block
remat for training, and chunked attention, the reference's own portable
analogue of its flash-attention kernel, run on each rank's local heads
and rows (``local_kernels.attend``).

The port compiles no HLO, so ``lower_cell`` has no counterpart (ROADMAP.md
A.7): :func:`run_cell` places the arguments by their specs on a
``DeviceMesh`` and calls the cell's function on DTensors, the port's
``jax.jit(fn, in_shardings=…, out_shardings=…)``. On a one-device mesh
(an ``AbstractMesh`` of size 1, or no process group) it runs on plain
tensors. A cell over more than one rank holds every family; the VLM's
``patches`` and the encoder-decoder's ``frames`` are batch arrays of the
cell (``model.input_specs``), placed over the batch axes by
``batch_pspecs`` as the tokens are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import act_sharding as AS
from repro_torch.distributed import fsdp as FSDP
from repro_torch.distributed import local_kernels as LK
from repro_torch.distributed import sharding as SH

# Archs whose tensor-parallel bf16 params, f32 grads and ZeRO-1 moments
# exceed one device: shard the params over (pod, data) too (FSDP). The
# reference's calibration: 32B fits at TP 16, so FSDP pays only above ~60B.
_FSDP_PARAM_THRESHOLD = 60e9  # params


def padded_heads(cfg: ModelConfig, model_axis: int) -> Tuple[int, int]:
    """The smallest (H', KV') >= (H, KV) that restores head-parallel
    attention on a ``model_axis``-wide mesh, by zero-padded heads
    (``distributed.head_padding``: the same function). For GQA the pad
    goes inside each kv group; for MHA, H and KV pad together. A pad that
    would grow the heads by more than 1.7× is not taken."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if h % model_axis == 0 or h == 0:
        return h, kv
    if h == kv:  # MHA: pad both together
        h2 = -(-h // model_axis) * model_axis
        if h2 / h <= 1.7:
            return h2, h2
        return h, kv
    group = h // kv
    g2 = group
    while (kv * g2) % model_axis and g2 < 4 * group:
        g2 += 1
    if (kv * g2) % model_axis == 0 and (g2 / group) <= 1.7:
        return kv * g2, kv
    return h, kv


def adapt_config(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> ModelConfig:
    """The production numerics and attention policy for a shape cell: bf16,
    block remat and 1024-chunked attention for training, 2048-chunked
    otherwise; padded heads on a mesh (not for the SSM family, and not for
    decode, where padding only grows the cache); on an MoE mesh, one
    dispatch group per batch shard."""
    kw: Dict[str, Any] = dict(dtype="bfloat16", param_dtype="bfloat16")
    if shape.kind == "train":
        kw["remat"] = "block"
        kw["attn_impl"] = "chunked"
        kw["attn_chunk"] = 1024
        kw["attn_q_chunk"] = 1024
    else:
        kw["attn_impl"] = "chunked"
        kw["attn_chunk"] = 2048
        kw["attn_q_chunk"] = 2048 if shape.seq_len > 8192 else 0
    if mesh is not None and cfg.family not in ("ssm",) and shape.kind != "decode":
        h2, kv2 = padded_heads(cfg, SH.mesh_axis_size(mesh, SH.MODEL_AXIS))
        if (h2, kv2) != (cfg.num_heads, cfg.num_kv_heads):
            kw["num_heads"] = h2
            kw["num_kv_heads"] = kv2
            kw["head_dim"] = cfg.resolved_head_dim  # keep hd fixed under the pad
    if mesh is not None and cfg.moe_num_experts:
        gshards = 1
        for a in SH.batch_axes(mesh):
            gshards *= SH.mesh_axis_size(mesh, a)
        kw["moe_dispatch_groups"] = gshards
    return cfg.replace(**kw)


def microbatches_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Gradient-accumulation depth: one sample per data shard per
    microbatch for the train cells, 1 otherwise."""
    if shape.kind != "train":
        return 1
    dp = 1
    for a in SH.batch_axes(mesh):
        dp *= SH.mesh_axis_size(mesh, a)
    return max(1, shape.global_batch // max(dp, 1))


def wants_fsdp(cfg: ModelConfig) -> bool:
    return cfg.param_count() > _FSDP_PARAM_THRESHOLD


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SteppedCell:
    """One cell: its function, the specs of its arguments and results (the
    port's spec tuples; ``None`` for a result left whole on every rank),
    its abstract arguments and the reference's ``donate_argnums`` (the
    port updates the donated state in place)."""

    kind: str  # train | prefill | decode | ebft
    fn: Callable
    in_specs: Tuple
    out_specs: Any
    abstract_args: Tuple
    donate_argnums: Tuple[int, ...]
    model: Any
    cfg: ModelConfig


def _is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


def is_active_mesh(mesh) -> bool:
    """A real mesh of more than one rank: the cells run on DTensors."""
    if not _is_device_mesh(mesh):
        return False
    n = 1
    for s in SH.axis_sizes(mesh).values():
        n *= s
    return n > 1


def _shapes(tree):
    """A tree's (or a tuple of trees') tensors as ``ShapeLeaf``s; other
    leaves (the cache's host ``len``) pass."""
    if isinstance(tree, tuple):
        return tuple(_shapes(t) for t in tree)
    return T.tree_map(lambda t: SH.ShapeLeaf(t.shape, t.dtype)
                      if isinstance(t, torch.Tensor) else t, tree)


def _abstract(fn: Callable):
    """``fn()``'s tree as ``ShapeLeaf``s, run under ``FakeTensorMode``
    (the port's ``jax.eval_shape``: nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return _shapes(fn())


def mesh_scope(mesh, act_pol, gather=None):
    """The context a cell's function runs in: the activation policy, the
    FSDP gather-at-use policy when given, and, on a real mesh, DTensor's
    implicit replication of the plain tensors a model makes (positions,
    RoPE tables, causal masks)."""
    stack = contextlib.ExitStack()
    if _is_device_mesh(mesh):
        from torch.distributed.tensor.experimental import implicit_replication

        stack.enter_context(implicit_replication())
    stack.enter_context(AS.policy(act_pol))
    if gather is not None:
        stack.enter_context(FSDP.gather_policy(gather))
    return stack


def _redistribute(x, spec, mesh):
    """A DTensor moved to ``spec``'s placements; a plain tensor passes."""
    if not LK.any_dtensor(x):
        return x
    return x.redistribute(mesh, SH.to_placements(spec, mesh))


def microbatch_constraint(bspecs, mesh) -> Callable:
    """The reference's ``constrain_microbatch``: each (microbatches, B /
    microbatches, ...) leaf's rows over the batch axes on dim 1, so that a
    rank computes only its rows of every microbatch."""
    def constrain(mb_tree):
        return T.tree_map(lambda x, spec: _redistribute(x, (None, *spec), mesh), mb_tree, bspecs)

    return constrain


# ---------------------------------------------------------------------------
def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *, lr: float = 1e-4,
                     fsdp: Optional[bool] = None,
                     microbatches: Optional[int] = None) -> SteppedCell:
    """Loss, gradients (``microbatches`` deep), clipping and AdamW on the
    mesh: params by ``param_pspecs`` (FSDP over the batch axes too when
    ``fsdp``, default ``wants_fsdp``), moments ZeRO-1, the batch over the
    batch axes, each microbatch's rows kept on dim 1 after the split
    (``constrain_microbatch``)."""
    from repro_torch.models.model import build
    from repro_torch.optim.optimizers import adamw
    from repro_torch.training.train_loop import make_train_step

    cfg = adapt_config(cfg, shape, mesh)
    model = build(cfg)
    fsdp = wants_fsdp(cfg) if fsdp is None else fsdp
    mb = microbatches_for(cfg, shape, mesh) if microbatches is None else microbatches

    opt = adamw(lr)

    def state():
        params = model.init(torch.Generator())
        return params, opt.init(params)

    params_shapes, opt_shapes = _abstract(state)
    pspecs = SH.param_pspecs(params_shapes, mesh, fsdp=fsdp)
    ospecs = SH.opt_pspecs(opt_shapes, pspecs, mesh)
    batch_shapes = model.input_specs(shape)
    bspecs = SH.batch_pspecs(batch_shapes, mesh)

    inner = make_train_step(model.loss, opt, microbatches=mb,
                            constrain_microbatch=microbatch_constraint(bspecs, mesh)
                            if mb > 1 else None)
    act_pol = AS.make_mesh_policy(mesh)
    # ZeRO-3 gather-at-use: each block's params back to tensor-parallel
    gather = FSDP.make_tp_regather(mesh) if fsdp else None

    def train_step(params, opt_state, batch):
        with mesh_scope(mesh, act_pol, gather):
            p, o, metrics, _ = inner(params, opt_state, batch, None)
        return p, o, metrics

    return SteppedCell("train", train_step, (pspecs, ospecs, bspecs), (pspecs, ospecs, None),
                       (params_shapes, opt_shapes, batch_shapes), (0, 1), model, cfg)


# ---------------------------------------------------------------------------
def _serve_fully_sharded(cfg: ModelConfig, mesh) -> bool:
    """Inference params sharded over the batch axes too, gathered per block,
    where a tensor-parallel shard alone would pass 10 GB of bf16 (Kimi-K2:
    126 GiB a device at TP 16)."""
    msize = SH.mesh_axis_size(mesh, SH.MODEL_AXIS)
    return cfg.param_count() * 2 / msize > 10e9  # bf16 bytes per TP shard


def _serve_cell(kind: str, cfg: ModelConfig, shape: ShapeConfig, mesh, state_len: int,
                method: str, first_shape: Callable) -> SteppedCell:
    """A cell of ``model.<method>(params, x, state)``: ``x`` (the batch or
    the new token, ``first_shape(model)``) over the batch axes, a serve
    state of depth ``state_len``."""
    from repro_torch.models.model import build

    cfg = adapt_config(cfg, shape, mesh)
    model = build(cfg)
    params_shapes = SH.abstract_params(model)
    serve_fsdp = _serve_fully_sharded(cfg, mesh)
    pspecs = SH.param_pspecs(params_shapes, mesh, fsdp=serve_fsdp)
    first = first_shape(model)
    state_shapes = _abstract(lambda: model.init_serve_state(shape.global_batch, state_len,
                                                            torch.device("cpu")))
    sspecs = SH.port_cache_pspecs(state_shapes, mesh)
    act_pol = AS.make_mesh_policy(mesh)
    gather = FSDP.make_tp_regather(mesh) if serve_fsdp else None
    call = getattr(model, method)

    def step(params, x, state):
        with mesh_scope(mesh, act_pol, gather), torch.no_grad():
            return call(params, x, state)

    return SteppedCell(kind, step, (pspecs, SH.batch_pspecs(first, mesh), sspecs),
                       (None, sspecs), (params_shapes, first, state_shapes), (2,), model, cfg)


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> SteppedCell:
    """One whole-prompt forward filling a cache of depth ``seq_len``; the
    cache's KV heads over "model" (``port_cache_pspecs``)."""
    return _serve_cell("prefill", cfg, shape, mesh, shape.seq_len, "prefill",
                       lambda model: model.input_specs(shape))


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> SteppedCell:
    """One new token (B, 1) against a cache of depth ``seq_len`` (allocated
    at ``seq_len + 1`` so that the write fits)."""
    from repro_torch.models.model import TensorSpec

    return _serve_cell("decode", cfg, shape, mesh, shape.seq_len + 1, "decode_step",
                       lambda model: TensorSpec((shape.global_batch, 1), torch.int32))


# ---------------------------------------------------------------------------
# the paper's own workload: one Adam step of block-wise reconstruction
# fine-tuning on the production mesh, one full calibration batch (256 ×
# 1024-token segments) a step, over the batch axes; the block's weights,
# masks and moments laid out as the training cells'
EBFT_SHAPE = ShapeConfig("ebft_block", 1024, 256, "ebft")
_DP_ONLY_MAX_PARAMS = 500e6  # a block (+ f32 moments) that fits one device


def build_ebft_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                    block_index: Optional[int] = None, lr: float = 2e-4,
                    dp_only: bool = False) -> SteppedCell:
    """``dp_only``: the block's weights replicated and the batch over every
    mesh axis, trading the per-layer row-parallel activation all-reduces
    for one block-sized gradient reduction (the reference's beyond-paper
    layout; a block above 500 M parameters stays tensor-parallel). The
    gradients go straight into the moments' layout (ZeRO-2: a reduce-scatter
    over "data"), Adam runs on the shards, and the bf16 update is gathered
    back to the weights' layout."""
    from repro_torch.core import reconstruction as R
    from repro_torch.models.model import build
    from repro_torch.models.transformer import torch_dtype
    from repro_torch.optim.optimizers import adam, apply_updates

    cfg = adapt_config(cfg, shape, mesh).replace(remat="none")
    model = build(cfg)
    if block_index is None:
        # mid-stack; an encoder block for the encoder-decoder (a decoder
        # block would also need the memory stream)
        i = cfg.enc_layers // 2 if cfg.family == "encdec" else model.num_blocks // 2
    else:
        i = block_index
    opt = adam(lr)

    def state():
        block = model.get_block(model.init(torch.Generator()), i)
        return block, opt.init(block)

    bw_shapes, opt_shapes = _abstract(state)
    block_params = sum(math.prod(x.shape) for _, x in T.leaves_with_path(bw_shapes))
    if dp_only and block_params > _DP_ONLY_MAX_PARAMS:
        dp_only = False
    if dp_only:
        bspecs = T.tree_map(lambda x: (None,) * len(x.shape), bw_shapes)
    else:
        bspecs = SH.param_pspecs(bw_shapes, mesh)
    mask_shapes = T.tree_map(lambda x: SH.ShapeLeaf(x.shape, torch_dtype(cfg.param_dtype)),
                             bw_shapes)
    ospecs = SH.opt_pspecs(opt_shapes, bspecs, mesh)
    gspecs = SH.opt_pspecs(bw_shapes, bspecs, mesh)

    B, S = shape.global_batch, shape.seq_len
    h_shape = SH.ShapeLeaf((B, S, cfg.d_model), torch_dtype(cfg.dtype))
    pos_shape = SH.ShapeLeaf((1, S), torch.int32)
    if dp_only:  # the batch over every mesh axis (the weights replicate)
        all_axes = SH.batch_axes(mesh) + (SH.MODEL_AXIS,)
        hspec = (all_axes, None, None)
        act_pol = AS.make_mesh_policy(mesh, batch_axes=all_axes)
    else:
        hspec = SH.batch_pspecs(h_shape, mesh)
        act_pol = AS.make_mesh_policy(mesh)

    def ebft_step(bw, opt_state, mask_bp, h, target, pos):
        with mesh_scope(mesh, act_pol):
            live = T.tree_map(lambda t: t.detach().requires_grad_(True), bw)
            leaves = [t for _, t in T.leaves_with_path(live)]
            with torch.enable_grad():
                loss = R.block_loss(model, i, live, mask_bp, h, target, pos, {})
                grads = iter(torch.autograd.grad(loss, leaves))
            # ZeRO-2: the partial gradients summed straight into the
            # moments' layout (a reduce-scatter, not a replicated all-reduce)
            g = T.map_with_path(
                lambda path, _: _redistribute(next(grads), T.get_path(gspecs, path), mesh), live)
            upd, opt_state2 = opt.update(g, opt_state, bw)
            upd = T.tree_map(lambda u: u.to(torch.bfloat16), upd)
            return apply_updates(bw, upd), opt_state2, loss.detach()

    in_specs = (bspecs, ospecs, bspecs, hspec, hspec, (None, None))
    return SteppedCell("ebft", ebft_step, in_specs, (bspecs, ospecs, None),
                       (bw_shapes, opt_shapes, mask_shapes, h_shape, h_shape, pos_shape),
                       (0, 1), model, cfg)


# ---------------------------------------------------------------------------
def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw) -> SteppedCell:
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh)
    if shape.kind == "ebft":
        return build_ebft_cell(cfg, shape, mesh)
    return build_decode_cell(cfg, shape, mesh)


def place(tree, specs, mesh):
    """Each tensor of ``tree`` at its spec's placements. Every rank holds
    the whole tensor and keeps its own piece (``src_data_rank=None``:
    nothing crosses the wire), as ``MeshPlan.put_*`` does; a DTensor is
    redistributed; other leaves pass."""
    from torch.distributed.tensor import distribute_tensor

    def put(t, spec):
        if LK.any_dtensor(t):
            return _redistribute(t, spec, mesh)
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, mesh, SH.to_placements(spec, mesh), src_data_rank=None)

    return T.tree_map(put, tree, specs)


def run_cell(cell: SteppedCell, mesh, *args):
    """``cell.fn(*args)`` as the reference jits it with its shardings: on an
    active ``DeviceMesh`` each argument is placed by its in-specs, the
    function runs on DTensors, and each result is left in its out-spec's
    placements, or whole on every rank (a plain tensor) where the spec is
    ``None``. On one device the function runs on the plain arguments."""
    if not is_active_mesh(mesh):
        return cell.fn(*args)
    from repro_torch.distributed.meshplan import MeshPlan

    out = cell.fn(*(place(a, s, mesh) for a, s in zip(args, cell.in_specs)))
    return tuple(MeshPlan.gather(o) if s is None else place(o, s, mesh)
                 for o, s in zip(out, cell.out_specs))
