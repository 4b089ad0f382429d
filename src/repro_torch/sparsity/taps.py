"""Per-linear activation taps (port of ``repro.sparsity.taps``, every
family).

``taps_for_block(cfg, i, num_blocks)`` picks the tap function of block
``i``; each ``taps(bp, cfg, h, positions, **aux)`` replays one block with the
model's own layer code and returns, for every prunable leaf name, the
activation whose reduction-axis statistics the pruning methods consume:
(T, R) for a dense linear, and for the routed experts the dispatched
per-expert activations (E, C, R), so expert-wise statistics are exact.
The shared experts' leaves take the ``shared/…`` keys. A Mamba block's
``conv_w`` gets the conv's (T, ch) input: its statistics are per channel,
the leaf's output axis. An encoder-decoder decoder block's ``xattn/wk``
and ``xattn/wv`` tap the encoder memory, (B·F, d) rows, not the decoder
stream; its encoder block's taps apply no RoPE before the attention that
feeds the ``wo`` tap, although the encoder's forward does: both as the
reference's (ROADMAP.md C.4).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, S, R) -> (B*S, R)"""
    return x.reshape(-1, x.shape[-1])


def _attn_taps(bp, cfg: ModelConfig, h: torch.Tensor, positions,
               out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Taps of one attention sub-block; returns the post-attention stream."""
    attn_in = L.apply_norm(bp["ln1"], h, cfg.norm)
    out["wq"] = out["wk"] = out["wv"] = _flat(attn_in)
    q, k, v = L.qkv_proj(bp["attn"], attn_in)
    hd = bp["attn"]["wq"].shape[-1]
    cos, sin = L.rope_table(positions, hd, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    o = L.attend(q, k, v, causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    out["wo"] = o.reshape(-1, o.shape[-2] * o.shape[-1])  # (T, H*hd)
    return h + L.out_proj(bp["attn"], o)


def _mlp_taps(bp, cfg: ModelConfig, h: torch.Tensor, out: Dict[str, torch.Tensor]) -> None:
    """Taps of the MLP sub-block on the stream h (before ``ln2``)."""
    x = L.apply_norm(bp["ln2"], h, cfg.norm)
    p = bp["mlp"]
    out["w_up"] = _flat(x)
    if "w_gate" in p:
        out["w_gate"] = _flat(x)
    up = x @ p["w_up"]
    gate = x @ p["w_gate"] if cfg.mlp_act == "swiglu" else None
    out["w_down"] = _flat(L.activation(up, gate, cfg.mlp_act))


def dense_taps(bp, cfg: ModelConfig, h: torch.Tensor, positions) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _mlp_taps(bp, cfg, _attn_taps(bp, cfg, h, positions, out), out)
    return out


def encdec_enc_taps(bp, cfg: ModelConfig, h: torch.Tensor, positions) -> Dict[str, torch.Tensor]:
    """An encoder block's taps. The attention before the ``wo`` tap is
    bidirectional and, as the reference's, takes q and k without RoPE."""
    out: Dict[str, torch.Tensor] = {}
    attn_in = L.apply_norm(bp["ln1"], h, cfg.norm)
    out["wq"] = out["wk"] = out["wv"] = _flat(attn_in)
    q, k, v = L.qkv_proj(bp["attn"], attn_in)
    o = L.attend(q, k, v, causal=False, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    out["wo"] = o.reshape(-1, o.shape[-2] * o.shape[-1])
    _mlp_taps(bp, cfg, h + L.out_proj(bp["attn"], o), out)
    return out


def encdec_dec_taps(bp, cfg: ModelConfig, h: torch.Tensor, positions,
                    memory: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A decoder block's taps: the causal self-attention's as a dense
    block's, then cross-attention's, whose ``wk``/``wv`` tap the memory."""
    out: Dict[str, torch.Tensor] = {}
    h = _attn_taps(bp, cfg, h, positions, out)
    x_in = L.apply_norm(bp["ln_x"], h, cfg.norm)
    p = bp["xattn"]
    out["xattn/wq"] = _flat(x_in)
    out["xattn/wk"] = out["xattn/wv"] = _flat(memory)
    q, _, _ = L.qkv_proj(p, x_in)
    k, v = ED.memory_kv(p, memory)
    o = L.attend(q, k, v, causal=False, impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    out["xattn/wo"] = o.reshape(-1, o.shape[-2] * o.shape[-1])
    _mlp_taps(bp, cfg, h + L.out_proj(p, o), out)
    return out


def moe_taps(bp, cfg: ModelConfig, h: torch.Tensor, positions) -> Dict[str, torch.Tensor]:
    """An MoE block's taps; a leading dense block of the stack gets
    ``dense_taps``. The routing is replayed over all B·S tokens of the
    microbatch as one group (the reference's taps ignore
    ``moe_dispatch_groups``)."""
    if "moe" not in bp:
        return dense_taps(bp, cfg, h, positions)
    out: Dict[str, torch.Tensor] = {}
    h = _attn_taps(bp, cfg, h, positions, out)
    xf = _flat(L.apply_norm(bp["ln2"], h, cfg.norm))
    p = bp["moe"]
    disp = MOE.dispatch(p["router"]["w"], xf, cfg)[0]
    out["w_up"] = out["w_gate"] = disp  # (E, C, d) expert-batched
    ew = p["experts"]
    out["w_down"] = F.silu(torch.bmm(disp, ew["w_gate"])) * torch.bmm(disp, ew["w_up"])
    if "shared" in p:
        out["shared/w_up"] = out["shared/w_gate"] = xf
        sh = p["shared"]
        out["shared/w_down"] = F.silu(xf @ sh["w_gate"]) * (xf @ sh["w_up"])
    return out


def ssm_taps(bp, cfg: ModelConfig, h: torch.Tensor, positions=None) -> Dict[str, torch.Tensor]:
    """A Mamba block's taps: the normed input for the five in-projections,
    the conv's input for ``conv_w``, the gated norm's output for ``out``."""
    u, z, xbc, dt_raw = SSM.in_proj(bp, cfg, h)
    flat_u = _flat(u)
    out = {k: flat_u for k in ("in_z", "in_x", "in_B", "in_C", "in_dt")}
    out["conv_w"] = _flat(xbc)
    out["out"] = _flat(SSM.mixer(bp, cfg, z, xbc, dt_raw)[0])
    return out


def taps_for_block(cfg: ModelConfig, block_index: int, num_blocks: int) -> Callable:
    """Which tap function applies to block ``block_index``; in the hybrid
    family the last index is the shared attention block; the VLM's blocks
    are dense blocks; the encoder-decoder's first ``enc_layers`` blocks are
    the encoder's."""
    if cfg.family in ("dense", "vlm"):
        return dense_taps
    if cfg.family == "moe":
        return moe_taps
    if cfg.family == "ssm":
        return ssm_taps
    if cfg.family == "hybrid":
        return dense_taps if block_index == num_blocks - 1 else ssm_taps
    if cfg.family == "encdec":
        return encdec_enc_taps if block_index < cfg.enc_layers else encdec_dec_taps
    raise ValueError(f"unknown family {cfg.family!r}")
