"""Encoder-decoder backbone, Seamless-M4T-medium's text stack (port of
``repro.models.encdec``).

The audio frontend is a stub, as in the reference: the batch brings
precomputed frame embeddings ``frames`` (B, F, d), which the encoder's
blocks take directly (cast to the model's dtype, at positions
``0 .. F - 1``). An encoder block is the dense block with bidirectional
self-attention (RoPE applied, as the reference's ``attention_block``
does); a decoder block is causal self-attention with RoPE, then
cross-attention over the encoder memory with no RoPE, then the MLP.

Params layout, as the reference's:
    embed/tok              (V, d)
    enc_blocks/*           the dense block's leaves, leading axis enc_layers
    dec_blocks/*           the same plus ln_x and xattn/{wq, wk, wv, wo},
                           leading axis num_layers
    enc_norm, final_norm   LayerNorm (or RMSNorm) of width d
    head/w                 (d, V)

Every function takes ``masks=`` as ``transformer.block_apply`` does. The
reference projects the memory by an einsum over ``xattn/wk`` and
``xattn/wv`` that ``apply_masks`` has already masked; the port passes
the masks beside the weights, so these two projections go through the
masked matmul with their masks like every other masked linear. Serving
keeps the decoder's KV cache in the port's layout (L, B, Hkv, max_len,
hd); the memory's keys and values are projected again at every decode
step, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import act_sharding as AS
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]

init_cache = T.init_cache  # the decoder's cache: (num_layers, B, Hkv, max_len, hd)


def _norm(cfg: ModelConfig, dtype, device, lead=()) -> Params:
    p = {"w": torch.ones((*lead, cfg.d_model), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros((*lead, cfg.d_model), dtype=dtype, device=device)
    return p


def init_dec_block(g: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> Params:
    """A decoder block: the dense block's leaves plus ``ln_x`` and the
    cross-attention ``xattn``; ``lead`` prepends stack axes."""
    bp = T.init_block(g, cfg, dtype, lead)
    bp["ln_x"] = _norm(cfg, dtype, g.device, lead)
    bp["xattn"] = T.init_block(g, cfg, dtype, lead, mlp=False)["attn"]
    return bp


def init(g: torch.Generator, cfg: ModelConfig) -> Params:
    """Params on ``g.device``, in the reference's shapes and scales (not its
    ``jax.random`` numbers)."""
    dtype = T.torch_dtype(cfg.param_dtype)
    d, V = cfg.d_model, cfg.padded_vocab
    return {
        "embed": {"tok": T._normal(g, (V, d), 0.02, dtype)},
        "enc_blocks": T.init_block(g, cfg, dtype, lead=(cfg.enc_layers,)),
        "dec_blocks": init_dec_block(g, cfg, dtype, lead=(cfg.num_layers,)),
        "enc_norm": _norm(cfg, dtype, g.device),
        "final_norm": _norm(cfg, dtype, g.device),
        "head": {"w": T._normal(g, (d, V), 0.02, dtype)},
    }


# ---------------------------------------------------------------------------
def enc_block_apply(bp: Params, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
                    masks: Optional[Params] = None) -> torch.Tensor:
    """One encoder block: bidirectional self-attention (with RoPE) + MLP."""
    return T.block_apply(bp, cfg, h, positions, masks, causal=False)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           masks: Optional[Params] = None) -> torch.Tensor:
    """frames (B, F, d) from the stub frontend -> the memory (B, F, d),
    after ``enc_norm``. With ``masks`` (a full mask tree) every masked
    linear of the encoder runs through the masked matmul kernel."""
    h = frames.to(T.torch_dtype(cfg.dtype))
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for i in range(cfg.enc_layers):
        bm = T.slice_block(masks["enc_blocks"], i) if masks is not None else None
        h = enc_block_apply(T.slice_block(params["enc_blocks"], i), cfg, h, positions, bm)
    return L.apply_norm(params["enc_norm"], h, cfg.norm)


def memory_kv(p: Params, memory: torch.Tensor,
              masks: Optional[Params] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The memory's keys and values (B, F, Hkv, hd) under ``xattn``'s
    ``wk``/``wv`` (and their masks), biases added."""
    mk = masks or {}
    k = L._linear(memory, p["wk"], 1, mk.get("wk"))
    v = L._linear(memory, p["wv"], 1, mk.get("wv"))
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    return k, v


def cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, memory: torch.Tensor,
                    masks: Optional[Params] = None) -> torch.Tensor:
    """The decoder stream x (B, S, d) attends over the memory (B, F, d):
    non-causal, no RoPE. Returns ``xattn``'s output projection (B, S, d)."""
    q = L._linear(x, p["wq"], 1, (masks or {}).get("wq"))
    if "bq" in p:
        q = q + p["bq"]
    k, v = memory_kv(p, memory, masks)
    o = L.attend(q, k, v, causal=False, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                 q_chunk=cfg.attn_q_chunk)
    return L.out_proj(p, o, masks)


def dec_block_apply(bp: Params, cfg: ModelConfig, h: torch.Tensor, memory: torch.Tensor,
                    positions: torch.Tensor, masks: Optional[Params] = None,
                    cache: Optional[Params] = None) -> torch.Tensor:
    """One decoder block; ``cache`` the block's KV cache (written in place)
    or None. The memory's keys and values are projected on every call."""
    mk = masks or {}
    attn_in = L.apply_norm(bp["ln1"], h, cfg.norm)
    h = h + L.attention_block(
        bp["attn"], attn_in, positions=positions, rope_theta=cfg.rope_theta,
        causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
        q_chunk=cfg.attn_q_chunk, masks=mk.get("attn"), cache=cache,
    )
    x_in = L.apply_norm(bp["ln_x"], h, cfg.norm)
    h = h + cross_attention(bp["xattn"], cfg, x_in, memory, mk.get("xattn"))
    mlp_in = L.apply_norm(bp["ln2"], h, cfg.norm)
    return h + L.mlp_block(bp["mlp"], mlp_in, cfg.mlp_act, mk.get("mlp"))


def decode_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  memory: torch.Tensor, cache: Optional[Params] = None,
                  masks: Optional[Params] = None):
    """tokens (B, S) over the memory -> (final hidden (B, S, d), the cache
    with ``len`` advanced by S, or None). Positions start at the cache's
    ``len`` (0 without a cache); the cache is written in place."""
    h = L.embed(params["embed"]["tok"], tokens, T.torch_dtype(cfg.dtype))
    # on a mesh the memory joins the batch layout (a no-op without a
    # policy): a serve state keeps it as the reference's cache_pspecs lay
    # it out, F over "data" and d over "model"
    memory = AS.constrain(memory, "bkd")
    start, S = (cache["len"] if cache is not None else 0), tokens.shape[1]
    positions = torch.arange(start, start + S, device=h.device)[None, :]
    for i in range(cfg.num_layers):
        bm = T.slice_block(masks["dec_blocks"], i) if masks is not None else None
        layer = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i],
                                            "len": start}
        h = dec_block_apply(T.slice_block(params["dec_blocks"], i), cfg, h, memory, positions,
                            bm, layer)
    h = L.apply_norm(params["final_norm"], h, cfg.norm)
    if cache is None:
        return h, None
    return h, {"k": cache["k"], "v": cache["v"], "len": start + S}


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, frames: torch.Tensor,
            masks: Optional[Params] = None) -> torch.Tensor:
    """Seq2seq training forward: tokens (B, S) + frames (B, F, d) -> logits
    (B, S, V)."""
    memory = encode(params, cfg, frames, masks)
    h, _ = decode_hidden(params, cfg, tokens, memory, masks=masks)
    return L.lm_logits(params["head"]["w"], h)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache: Params,
            memory: torch.Tensor):
    """tokens (B, S) into the decoder's cache over ``memory``; returns (the
    last position's f32 logits (B, 1, V), the cache with ``len`` advanced
    by S). The cache is written in place: the state passed in is
    consumed."""
    h, cache = decode_hidden(params, cfg, tokens, memory, cache)
    return L.lm_logits(params["head"]["w"], h[:, -1:]), cache



def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor, cache: Params,
                memory: torch.Tensor):
    """token (B, 1) -> (logits (B, 1, V), the cache one position on)."""
    return prefill(params, cfg, token, cache, memory)
