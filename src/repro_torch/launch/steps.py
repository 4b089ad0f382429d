"""Production adaptation of a config to a shape cell on a mesh (port of
the pure-logic part of ``repro.launch.steps``).

``padded_heads``, ``adapt_config``, ``microbatches_for`` and
``wants_fsdp`` are the reference's policy, on the port's configs and
meshes (a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh``). The
reference's sharded step functions (the train, prefill, decode and ebft
cells) are not ported yet: they are ROADMAP.md A.8c.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
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
