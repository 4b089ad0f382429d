"""Per-linear activation taps (port of ``repro.sparsity.taps``, dense
family).

``dense_taps(bp, cfg, h, positions)`` replays one block with the model's
own layer code and returns, for every prunable leaf name, the (T, R)
activation matrix whose reduction-axis statistics Wanda consumes.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, S, R) -> (B*S, R)"""
    return x.reshape(-1, x.shape[-1])


def dense_taps(bp, cfg: ModelConfig, h: torch.Tensor, positions) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    attn_in = L.apply_norm(bp["ln1"], h, cfg.norm)
    out["wq"] = out["wk"] = out["wv"] = _flat(attn_in)
    q, k, v = L.qkv_proj(bp["attn"], attn_in)
    hd = bp["attn"]["wq"].shape[-1]
    cos, sin = L.rope_table(positions, hd, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    o = L.attend(q, k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    out["wo"] = o.reshape(-1, o.shape[-2] * o.shape[-1])  # (T, H*hd)
    h = h + L.out_proj(bp["attn"], o)

    x = L.apply_norm(bp["ln2"], h, cfg.norm)
    p = bp["mlp"]
    out["w_up"] = _flat(x)
    if "w_gate" in p:
        out["w_gate"] = _flat(x)
    up = x @ p["w_up"]
    gate = x @ p["w_gate"] if cfg.mlp_act == "swiglu" else None
    out["w_down"] = _flat(L.activation(up, gate, cfg.mlp_act))
    return out
