"""Decoder-only dense transformer (port of ``repro.models.transformer``,
forward path without a KV cache).

Params layout (leading L axis on every "blocks" leaf), as the reference:
    embed/tok            (V, d)
    blocks/ln1/w         (L, d)         blocks/ln2/w (L, d)
    blocks/attn/wq       (L, d, H, hd)  ... wk, wv (L, d, Hkv, hd), wo (L,H,hd,d)
    blocks/mlp/w_up      (L, d, ff)     w_gate (swiglu), w_down (L, ff, d)
    final_norm/w         (d,)
    head/w               (d, V)         (absent if tie_embeddings)

``init`` draws from a ``torch.Generator`` with the reference's shapes and
scales; it does not reproduce ``jax.random``'s numbers (tests that need
the reference's weights bring them over with ``repro_torch.interop``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(g: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=g, device=g.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def init_block(g: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> Params:
    """One block's params; ``lead`` prepends stack axes (the L axis)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    dev = g.device

    def norm():
        p = {"w": torch.ones((*lead, d), dtype=dtype, device=dev)}
        if cfg.norm == "layernorm":
            p["b"] = torch.zeros((*lead, d), dtype=dtype, device=dev)
        return p

    s = 1.0 / math.sqrt(d)
    attn = {
        "wq": _normal(g, (*lead, d, h, hd), s, dtype),
        "wk": _normal(g, (*lead, d, hkv, hd), s, dtype),
        "wv": _normal(g, (*lead, d, hkv, hd), s, dtype),
        "wo": _normal(g, (*lead, h, hd, d), 1.0 / math.sqrt(h * hd), dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", hkv), ("bv", hkv)):
            attn[name] = torch.zeros((*lead, heads, hd), dtype=dtype, device=dev)
    mlp = {
        "w_up": _normal(g, (*lead, d, ff), s, dtype),
        "w_down": _normal(g, (*lead, ff, d), 1.0 / math.sqrt(ff), dtype),
    }
    if cfg.mlp_act == "swiglu":
        mlp["w_gate"] = _normal(g, (*lead, d, ff), s, dtype)
    return {"ln1": norm(), "ln2": norm(), "attn": attn, "mlp": mlp}


def init(g: torch.Generator, cfg: ModelConfig) -> Params:
    """Params on ``g.device``."""
    dtype = torch_dtype(cfg.param_dtype)
    d, V = cfg.d_model, cfg.padded_vocab
    params: Params = {
        "embed": {"tok": _normal(g, (V, d), 0.02, dtype)},
        "blocks": init_block(g, cfg, dtype, lead=(cfg.num_layers,)),
        "final_norm": {"w": torch.ones((d,), dtype=dtype, device=g.device)},
    }
    if cfg.norm == "layernorm":
        params["final_norm"]["b"] = torch.zeros((d,), dtype=dtype, device=g.device)
    if not cfg.tie_embeddings:
        params["head"] = {"w": _normal(g, (d, V), 0.02, dtype)}
    return params


def block_apply(bp: Params, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
                masks: Optional[Params] = None) -> torch.Tensor:
    """One transformer block; ``masks`` is the block's mask dict or None."""
    mk = masks or {}
    attn_in = L.apply_norm(bp["ln1"], h, cfg.norm)
    h = h + L.attention_block(
        bp["attn"], attn_in, positions=positions, rope_theta=cfg.rope_theta,
        causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
        q_chunk=cfg.attn_q_chunk, masks=mk.get("attn"),
    )
    mlp_in = L.apply_norm(bp["ln2"], h, cfg.norm)
    return h + L.mlp_block(bp["mlp"], mlp_in, cfg.mlp_act, mk.get("mlp"))


def slice_block(tree: Params, i: int) -> Params:
    """Block ``i`` of a stacked tree: views into its leaves."""
    return {k: slice_block(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   masks: Optional[Params] = None) -> torch.Tensor:
    """tokens (B, S) -> final hidden states (B, S, d)."""
    h = L.embed(params["embed"]["tok"], tokens, torch_dtype(cfg.dtype))
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    for i in range(cfg.num_layers):
        bm = slice_block(masks["blocks"], i) if masks is not None else None
        h = block_apply(slice_block(params["blocks"], i), cfg, h, positions, bm)
    return L.apply_norm(params["final_norm"], h, cfg.norm)


def logits_from_hidden(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    w = params["head"]["w"] if "head" in params else params["embed"]["tok"].T
    return L.lm_logits(w, h)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            masks: Optional[Params] = None) -> torch.Tensor:
    return logits_from_hidden(params, cfg, forward_hidden(params, cfg, tokens, masks=masks))
