"""Core neural-net layers, plain functions on tensors (port of
``repro.models.layers``).

Params are plain dicts of tensors in the reference's layouts. The linear
projections take an optional block-mask dict: a masked leaf goes through
the ``masked_matmul`` kernel, an unmasked one is a plain ``torch.matmul``
(the reference leaves the dense contraction to XLA). Under autograd the
masked linears and the card's flash attention are ``torch.autograd``
Functions whose backward is a kernel too (``MaskedMatmulFn``,
``FlashAttentionFn``), the gradient the reference takes of
``apply_masks`` + einsum and of its attention. ``attention_block`` with a
``cache`` is the reference's serving branch (prefill and decode against a
KV cache).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import act_sharding as AS
from repro_torch.distributed import local_kernels as LK
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.kernels.masked_matmul.ops import masked_matmul

Params = Dict[str, Any]
_NEG = -1e30


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def apply_norm(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


# ---------------------------------------------------------------------------
# RoPE (split-half, as the reference)
# ---------------------------------------------------------------------------
def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., head_dim/2), f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*groups, hd)."""
    if groups == 1:
        return k
    b, s, hkv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, hkv, groups, hd).reshape(b, s, hkv * groups, hd)


def _softmax_attend(q, k, v, mask, scale):
    """q: (B,Sq,H,hd) k/v: (B,Sk,H,hd) mask: (Sq,Sk) or (B,Sq,Sk) or None.
    Scores are formed in the input dtype, then upcast (as the reference)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if mask is not None:
        mask = mask[None, None] if mask.dim() == 2 else mask[:, None]
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _chunked_attend(q, k, v, causal: bool, q_offset: int, chunk: int, scale):
    """Online softmax over KV chunks; memory O(B*H*Sq*chunk)."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)
    # the reference constrains the carry inits here (GSPMD would infer a
    # replicated carry from the constants); the port's attention runs on
    # local shards, so these hooks pass plain tensors through
    m = AS.constrain(torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=dev), "bhq")
    l = AS.constrain(torch.zeros((b, h, sq), dtype=torch.float32, device=dev), "bhq")
    acc = AS.constrain(torch.zeros((b, sq, h, hd), dtype=torch.float32, device=dev), "bqhd")
    for c0 in range(0, max(sk, 1), chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        n = kb.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) * scale
        if causal:
            k_pos = c0 + torch.arange(n, device=dev)
            msk = q_pos[:, None] >= k_pos[None, :]
            scores = torch.where(msk[None, None], scores, torch.full_like(scores, _NEG))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(q.dtype).float(), vb.float())
        m = m_new
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attend(q, k, v, *, causal: bool, impl: str = "dot", chunk: int = 1024,
           q_chunk: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention core. q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd).

    ``"flash"`` on a CUDA tensor launches the flash attention kernel;
    ``"flash"`` or ``"chunked"`` elsewhere take the chunked plain path;
    ``"dot"`` materialises the scores. DTensor operands (a mesh walk) run
    each rank's batch rows and heads locally (``distributed.local_kernels``).
    """
    if LK.any_dtensor(q, k, v):
        return LK.attend(attend, q, k, v, causal=causal, impl=impl, chunk=chunk,
                         q_chunk=q_chunk, q_offset=q_offset)
    h, hkv = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    if impl == "flash" and q.device.type == "cuda":
        return flash_attention_bshd(q, k, v, causal=causal, q_offset=q_offset)
    if impl in ("chunked", "flash"):
        sq = q.shape[1]
        if q_chunk and sq > q_chunk:
            if sq % q_chunk:
                raise ValueError(f"Sq={sq} not divisible by q_chunk={q_chunk}")
            return torch.cat([
                _chunked_attend(q[:, s:s + q_chunk], k, v, causal, q_offset + s,
                                chunk, scale)
                for s in range(0, sq, q_chunk)
            ], dim=1)
        return _chunked_attend(q, k, v, causal, q_offset, chunk, scale)
    if impl != "dot":
        raise ValueError(f"unknown attention impl {impl!r}")
    sq, sk = q.shape[1], k.shape[1]
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(sk, device=q.device)[None, :]
    return _softmax_attend(q, k, v, mask, scale)


# ---------------------------------------------------------------------------
# Linear projections: masked leaves go through the kernel
# ---------------------------------------------------------------------------
def _linear(x: torch.Tensor, w: torch.Tensor, n_red: int, mask=None) -> torch.Tensor:
    """Contract the last axis of x (B, S, R) with the first ``n_red`` axes
    of ``w``, seen as the (R, O) matrix; returns (B, S, *w.shape[n_red:])."""
    R = math.prod(w.shape[:n_red])
    out_shape = w.shape[n_red:]
    x2 = x.reshape(-1, R)
    w2 = w.reshape(R, -1)
    if mask is None:
        y = torch.matmul(x2, w2)
    else:
        y = masked_matmul(x2, w2, mask.reshape(R, -1))
    return y.reshape(*x.shape[:-1], *out_shape)


def qkv_proj(p: Params, x: torch.Tensor, masks: Optional[Params] = None):
    mk = masks or {}
    q = _linear(x, p["wq"], 1, mk.get("wq"))
    k = _linear(x, p["wk"], 1, mk.get("wk"))
    v = _linear(x, p["wv"], 1, mk.get("wv"))
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def out_proj(p: Params, o: torch.Tensor, masks: Optional[Params] = None) -> torch.Tensor:
    """o (B, S, H, hd) x wo (H, hd, d) -> (B, S, d)."""
    b, s, h, hd = o.shape
    mk = (masks or {}).get("wo")
    # row-parallel on a mesh: the product is a partial sum over "model",
    # summed here, before the residual add (a no-op without a policy)
    return AS.constrain(_linear(o.reshape(b, s, h * hd), p["wo"], 2, mk), "bqd")


def attention_block(p: Params, x: torch.Tensor, *, positions: torch.Tensor,
                    rope_theta: float, causal: bool = True, impl: str = "dot",
                    chunk: int = 1024, q_chunk: int = 0,
                    masks: Optional[Params] = None,
                    cache: Optional[Params] = None) -> torch.Tensor:
    """Full attention sub-block (no norm/residual). With ``cache`` (one
    layer's ``{"k", "v": (B, Hkv, max_len, hd), "len": int}``) the new keys
    and values are written into it in place and the queries attend over the
    whole cache (``attend_cached``)."""
    hd = p["wq"].shape[-1]
    q, k, v = qkv_proj(p, x, masks)
    cos, sin = rope_table(positions, hd, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is None:
        o = attend(q, k, v, causal=causal, impl=impl, chunk=chunk, q_chunk=q_chunk)
    else:
        o = attend_cached(q, k, v, cache, impl=impl, chunk=chunk, q_chunk=q_chunk)
    return out_proj(p, o, masks)


def attend_cached(q, k, v, cache: Params, *, impl: str, chunk: int = 1024,
                  q_chunk: int = 0) -> torch.Tensor:
    """The reference's cache branch (``repro.models.layers.attention_block``
    with a cache): k, v (B, S, Hkv, hd) are written at ``start =
    cache["len"]``, cast to the cache's dtype, and q (B, S, H, hd) attends
    over all ``max_len`` keys of the cache, causal from ``q_offset =
    start``. Like ``lax.dynamic_update_slice`` the write is clamped into
    range (at most ``max_len - S``) while ``q_offset`` stays ``start``.

    ``"dot"`` materialises the scores; ``"chunked"``, and ``"flash"`` on a
    CPU tensor, take the chunked online softmax, as the reference does
    off the TPU. ``"flash"`` on a CUDA tensor launches the flash attention
    kernel with the host int ``q_offset`` (the reference maps every
    non-``"dot"`` impl to its chunked path here: the same function). The
    cache's (B, Hkv, max_len, hd) layout makes a layer's slab the kernel's
    (B·H, max_len, hd) operand as a view when Hkv == H and the cache is in
    q's dtype: no copy of the cache."""
    kc, vc, start = cache["k"], cache["v"], cache["len"]
    S, max_len = q.shape[1], kc.shape[2]
    w = min(max(start, 0), max_len - S)
    kc[:, :, w:w + S] = k.transpose(1, 2)
    vc[:, :, w:w + S] = v.transpose(1, 2)
    kf = kc.transpose(1, 2).to(q.dtype)
    vf = vc.transpose(1, 2).to(q.dtype)
    return attend(q, kf, vf, causal=True, impl=impl, chunk=chunk, q_chunk=q_chunk,
                  q_offset=start)


def activation(up: torch.Tensor, gate: Optional[torch.Tensor], act: str) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "sq_relu":
        return F.relu(up).square()
    return F.gelu(up, approximate="tanh")  # jax.nn.gelu's default


def mlp_block(p: Params, x: torch.Tensor, act: str, masks: Optional[Params] = None):
    mk = masks or {}
    up = _linear(x, p["w_up"], 1, mk.get("w_up"))
    gate = _linear(x, p["w_gate"], 1, mk.get("w_gate")) if act == "swiglu" else None
    return AS.constrain(_linear(activation(up, gate, act), p["w_down"], 1, mk.get("w_down")),
                        "bqd")


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed(tok_emb: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The rows of ``tok_emb`` at ``tokens``. ``F.embedding``'s backward sums
    a repeated token's rows in a fixed order (indexing's accumulates them in
    parallel on the CPU), so a training step repeats bit for bit. On a mesh
    a vocab-sharded table gives each rank its own rows' share
    (``local_kernels.embed``), summed here."""
    if LK.any_dtensor(tok_emb, tokens):
        return AS.constrain(LK.embed(tokens, tok_emb).to(dtype), "bqd")
    return F.embedding(tokens, tok_emb).to(dtype)


def lm_logits(head_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 logits; on a mesh a vocab-sharded head's are gathered whole
    along the vocab (a no-op without a policy)."""
    return AS.constrain(torch.matmul(x, head_w).float(), "bqd")
