"""Zero-padded attention-head expansion (port of
``repro.distributed.head_padding``).

A 40-head model cannot head-shard on a 16-wide model axis. Padding the q
heads to the next multiple restores head parallelism and is exactly the
same function: a padded q head has zero ``wq`` rows, so q = 0 and its
softmax is uniform over its kv group, but its ``wo`` rows are zero, so its
context adds nothing.

For GQA the pad goes inside each kv group (the q -> kv mapping of the real
heads must not shift): the weights are seen as (d, KV, G, hd) and G is
padded. For MHA, q and kv pad together (padded kv heads serve only padded
q heads). ``head_pad_mask`` marks the padded slots so that training can
freeze them: their gradient is not zero (the uniform-softmax context
flows into ``wo``'s padded rows), so the mask is applied at every update.

``launch/steps.py::padded_heads`` computes the padded counts.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig

Params = Any

_Q_LEAVES = {"wq": -2, "bq": -2, "wo": -3}   # head-axis index from the end
_KV_LEAVES = {"wk": -2, "bk": -2, "wv": -2, "bv": -2}


def _pad_axis(leaf: torch.Tensor, axis: int, new: int) -> torch.Tensor:
    axis = axis % leaf.dim()
    shape = list(leaf.shape)
    shape[axis] = new
    out = leaf.new_zeros(shape)
    out.narrow(axis, 0, leaf.shape[axis]).copy_(leaf)
    return out


def _pad_grouped(leaf: torch.Tensor, axis: int, kv: int, g_old: int, g_new: int) -> torch.Tensor:
    """(... H=kv*g_old ...) -> (... kv*g_new ...), padding inside each group."""
    axis = axis % leaf.dim()
    shape = leaf.shape
    grouped = leaf.reshape(*shape[:axis], kv, g_old, *shape[axis + 1:])
    grouped = _pad_axis(grouped, axis + 1, g_new)
    return grouped.reshape(*shape[:axis], kv * g_new, *shape[axis + 1:])


def pad_attention_params(params: Params, cfg_old: ModelConfig, cfg_new: ModelConfig) -> Params:
    """Expand every attention leaf from (H, KV) to the padded (H', KV')."""
    h0, kv0 = cfg_old.num_heads, cfg_old.num_kv_heads
    h1, kv1 = cfg_new.num_heads, cfg_new.num_kv_heads
    if (h0, kv0) == (h1, kv1):
        return params
    mha = kv0 == h0

    def g(path, leaf):
        name = path[-1]
        if name in _Q_LEAVES and leaf.shape[_Q_LEAVES[name] % leaf.dim()] == h0:
            ax = _Q_LEAVES[name]
            if mha:
                return _pad_axis(leaf, ax, h1)
            return _pad_grouped(leaf, ax, kv0, h0 // kv0, h1 // kv1)
        if mha and name in _KV_LEAVES and leaf.shape[_KV_LEAVES[name] % leaf.dim()] == kv0:
            return _pad_axis(leaf, _KV_LEAVES[name], kv1)
        return leaf

    return T.map_with_path(g, params)


def head_pad_mask(params_padded: Params, cfg_old: ModelConfig, cfg_new: ModelConfig) -> Params:
    """f32 1.0 on real slots and 0.0 on padded head slots (a scalar 1.0 for
    every other leaf): multiply it into the gradients or updates at each
    step to keep the pads at zero."""
    h0, kv0 = cfg_old.num_heads, cfg_old.num_kv_heads
    h1, kv1 = cfg_new.num_heads, cfg_new.num_kv_heads
    mha = kv0 == h0

    def mask_for(leaf, ax):
        ax = ax % leaf.dim()
        m = torch.ones(leaf.shape, dtype=torch.float32, device=leaf.device)
        if mha:
            m.narrow(ax, h0, leaf.shape[ax] - h0).zero_()
            return m
        shape = leaf.shape
        group_old, group_new = h0 // kv0, h1 // kv1
        gm = m.reshape(*shape[:ax], kv0, group_new, *shape[ax + 1:])
        gm.narrow(ax + 1, group_old, group_new - group_old).zero_()
        return gm.reshape(shape)

    def g(path, leaf):
        name = path[-1]
        if name in _Q_LEAVES and leaf.shape[_Q_LEAVES[name] % leaf.dim()] == h1:
            return mask_for(leaf, _Q_LEAVES[name])
        if mha and name in _KV_LEAVES and leaf.shape[_KV_LEAVES[name] % leaf.dim()] == kv1:
            return mask_for(leaf, _KV_LEAVES[name])
        return torch.ones((), dtype=torch.float32, device=leaf.device)

    return T.map_with_path(g, params_padded)
