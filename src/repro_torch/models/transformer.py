"""Decoder-only dense transformer (port of ``repro.models.transformer``):
the forward, and serving against a KV cache (``init_cache``, ``prefill``,
``decode_step``).

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
from repro_torch.distributed import fsdp
from repro_torch.models import layers as L

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _normal(g: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=g, device=g.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def init_block(g: torch.Generator, cfg: ModelConfig, dtype, lead=(), mlp: bool = True) -> Params:
    """One block's params; ``lead`` prepends stack axes (the L axis).
    ``mlp=False`` leaves out the MLP (an MoE block brings its own)."""
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
    block = {"ln1": norm(), "ln2": norm(), "attn": attn}
    if mlp:
        block["mlp"] = {
            "w_up": _normal(g, (*lead, d, ff), s, dtype),
            "w_down": _normal(g, (*lead, ff, d), 1.0 / math.sqrt(ff), dtype),
        }
        if cfg.mlp_act == "swiglu":
            block["mlp"]["w_gate"] = _normal(g, (*lead, d, ff), s, dtype)
    return block


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
                masks: Optional[Params] = None, cache: Optional[Params] = None,
                causal: bool = True) -> torch.Tensor:
    """One transformer block; ``masks`` is the block's mask dict or None,
    ``cache`` the block's KV cache (written in place) or None. ``causal=False``
    is the encoder-decoder family's encoder block (bidirectional, RoPE
    all the same)."""
    mk = masks or {}
    attn_in = L.apply_norm(bp["ln1"], h, cfg.norm)
    h = h + L.attention_block(
        bp["attn"], attn_in, positions=positions, rope_theta=cfg.rope_theta,
        causal=causal, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
        q_chunk=cfg.attn_q_chunk, masks=mk.get("attn"), cache=cache,
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
    return L.apply_norm(params["final_norm"], run_blocks(params, cfg, h, positions, masks),
                        cfg.norm)


def run_blocks(params: Params, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
               masks: Optional[Params] = None) -> torch.Tensor:
    """The embedded stream h (B, S, d) through every block, no final norm."""
    for i in range(cfg.num_layers):
        bm = slice_block(masks["blocks"], i) if masks is not None else None
        bp = fsdp.gather_block(slice_block(params["blocks"], i))  # no-op w/o policy
        h = block_apply(bp, cfg, h, positions, bm)
    return h


def logits_from_hidden(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    w = params["head"]["w"] if "head" in params else params["embed"]["tok"].T
    return L.lm_logits(w, h)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            masks: Optional[Params] = None) -> torch.Tensor:
    return logits_from_hidden(params, cfg, forward_hidden(params, cfg, tokens, masks=masks))


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None) -> Params:
    """The reference's cache in the layout (L, B, Hkv, max_len, hd), so that
    a layer's slab is the (B·Hkv, max_len, hd) operand of the attention
    kernel (the reference's is (L, B, max_len, Hkv, hd)). ``len``, the
    number of positions written, is a host int shared by every sequence."""
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache: Params):
    """Run tokens (B, S) through the model at positions ``len .. len+S-1``,
    writing their keys and values into the cache. Returns (the last
    position's f32 logits (B, 1, V), the cache with ``len`` advanced by S).
    The cache's tensors are written in place: the state passed in is
    consumed."""
    return prefill_hidden(params, cfg, L.embed(params["embed"]["tok"], tokens,
                                               torch_dtype(cfg.dtype)), cache)


def prefill_hidden(params: Params, cfg: ModelConfig, h: torch.Tensor, cache: Params):
    """``prefill`` from the embedded stream h (B, S, d): the blocks at
    positions ``len .. len+S-1``, their keys and values written into the
    cache, then the last position's f32 logits. The VLM's multimodal
    prefill enters here with [patches ; text]."""
    start, S = cache["len"], h.shape[1]
    positions = torch.arange(start, start + S, device=h.device)[None, :]
    for i in range(cfg.num_layers):
        layer = {"k": cache["k"][i], "v": cache["v"][i], "len": start}
        bp = fsdp.gather_block(slice_block(params["blocks"], i))  # serve-path hook
        h = block_apply(bp, cfg, h, positions, cache=layer)
    h = L.apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
    return logits_from_hidden(params, cfg, h), {"k": cache["k"], "v": cache["v"],
                                                "len": start + S}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor, cache: Params):
    """token (B, 1) -> (logits (B, 1, V), the cache one position on)."""
    return prefill(params, cfg, token, cache)
