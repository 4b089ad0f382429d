"""Zamba2-style hybrid (port of ``repro.models.hybrid``): a Mamba2 backbone
and one *shared* attention block applied after every
``hybrid_attn_every`` Mamba blocks.

The shared block has one set of weights and a KV cache of its own at each
invocation site (weights shared, activations not). As in the reference,
Zamba2's per-site LoRA is left out: the block is applied verbatim at each
site. For num_layers 38, every 6 the schedule is

    mamba x6, shared, mamba x6, shared, ... (6 sites), mamba x2

held as G groups of K Mamba blocks (leaves with leading (G, K) axes),
each followed by the shared block, then R trailing Mamba blocks (leading
R). Params: ``embed``, ``groups``, ``shared`` (a dense block,
``models/transformer.py``), ``trailing`` (when R > 0), ``final_norm``,
``head``; a mask tree mirrors them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as TR

Params = Dict[str, Any]


def schedule(cfg: ModelConfig) -> Tuple[int, int, int]:
    """-> (groups G, Mamba blocks per group K, trailing Mamba blocks R)."""
    K = cfg.hybrid_attn_every
    G = cfg.num_layers // K
    return G, K, cfg.num_layers - G * K


def init(g: torch.Generator, cfg: ModelConfig) -> Params:
    """Params on ``g.device``."""
    dtype = TR.torch_dtype(cfg.param_dtype)
    d, V = cfg.d_model, cfg.padded_vocab
    G, K, R = schedule(cfg)
    params: Params = {
        "embed": {"tok": TR._normal(g, (V, d), 0.02, dtype)},
        "groups": S.init_mamba_block(g, cfg, dtype, lead=(G, K)),
        "shared": TR.init_block(g, cfg, dtype),
        "final_norm": {"w": torch.ones((d,), dtype=dtype, device=g.device)},
        "head": {"w": TR._normal(g, (d, V), 0.02, dtype)},
    }
    if R:
        params["trailing"] = S.init_mamba_block(g, cfg, dtype, lead=(R,))
    if cfg.norm == "layernorm":
        params["final_norm"]["b"] = torch.zeros((d,), dtype=dtype, device=g.device)
    return params


def mamba_block(tree: Params, i: int, cfg: ModelConfig) -> Params:
    """Mamba block ``i`` (0 .. num_layers-1, in execution order) of a param
    or mask tree: views into ``groups`` or ``trailing``."""
    G, K, _ = schedule(cfg)
    if i < G * K:
        return TR.slice_block(TR.slice_block(tree["groups"], i // K), i % K)
    return TR.slice_block(tree["trailing"], i - G * K)


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   masks: Optional[Params] = None) -> torch.Tensor:
    """The shared block runs at every site with positions 0..S-1."""
    G, K, _ = schedule(cfg)
    h = L.embed(params["embed"]["tok"], tokens, TR.torch_dtype(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    for g in range(G):
        h = TR.remat_block(cfg, _group_body, params, cfg, masks, g, h, positions)
    for i in range(G * K, cfg.num_layers):  # the trailing blocks: no remat, as the reference
        h = _mamba(params, cfg, masks, i, h)
    return L.apply_norm(params["final_norm"], h, cfg.norm)


def _mamba(params: Params, cfg: ModelConfig, masks: Optional[Params], i: int,
           h: torch.Tensor) -> torch.Tensor:
    bm = mamba_block(masks, i, cfg) if masks is not None else None
    return S.mamba_block_apply(mamba_block(params, i, cfg), cfg, h, masks=bm)[0]


def _group_body(params: Params, cfg: ModelConfig, masks: Optional[Params], g: int,
                h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Group ``g``: its K Mamba blocks, then the shared block (the
    reference's remat body)."""
    _, K, _ = schedule(cfg)
    for i in range(g * K, (g + 1) * K):
        h = _mamba(params, cfg, masks, i, h)
    return TR.block_apply(params["shared"], cfg, h, positions,
                          masks["shared"] if masks is not None else None)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            masks: Optional[Params] = None) -> torch.Tensor:
    return L.lm_logits(params["head"]["w"], forward_hidden(params, cfg, tokens, masks))


# ---------------------------------------------------------------------------
# serving: Mamba states per block, a KV cache per shared-block site
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None) -> Params:
    """The reference's cache groups; the shared block's is laid out as the
    dense family's, (G, B, Hkv, max_len, hd), so that a site's slab reaches
    the attention kernel as a view (the reference's is (G, B, max_len,
    Hkv, hd)). ``len`` is a host int shared by every sequence."""
    dtype = dtype or TR.torch_dtype(cfg.dtype)
    G, K, R = schedule(cfg)
    kv = (G, batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
    cache: Params = {
        "groups": S.init_states(cfg, (G, K), batch, device, dtype),
        "shared_kv": {"k": torch.zeros(kv, dtype=dtype, device=device),
                      "v": torch.zeros(kv, dtype=dtype, device=device)},
        "len": 0,
    }
    if R:
        cache["trailing"] = S.init_states(cfg, (R,), batch, device, dtype)
    return cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache: Params):
    """Run tokens (B, S) at positions ``len .. len+S-1`` from the cached
    states, writing the new states, keys and values in place. Returns (the
    last position's f32 logits (B, 1, V), the cache with ``len`` advanced
    by S)."""
    G, K, R = schedule(cfg)
    start, n = cache["len"], tokens.shape[1]
    h = L.embed(params["embed"]["tok"], tokens, TR.torch_dtype(cfg.dtype))
    positions = torch.arange(start, start + n, device=tokens.device)[None, :]
    for i in range(cfg.num_layers):
        st = mamba_block(cache, i, cfg)
        h = S.run_cached(mamba_block(params, i, cfg), cfg, h, st["conv"], st["ssm"])
        if i < G * K and i % K == K - 1:
            g = i // K
            site = {"k": cache["shared_kv"]["k"][g], "v": cache["shared_kv"]["v"][g],
                    "len": start}
            h = TR.block_apply(params["shared"], cfg, h, positions, cache=site)
    h = L.apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
    new_cache = {k: v for k, v in cache.items() if k != "len"}
    new_cache["len"] = start + n
    return L.lm_logits(params["head"]["w"], h), new_cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor, cache: Params):
    """token (B, 1) -> (logits (B, 1, V), the cache one position on)."""
    return prefill(params, cfg, token, cache)
