"""Mamba2 blocks (SSD, state-space duality) and the attention-free LM (port
of ``repro.models.ssm``).

Recurrence per head h (state size N, head dim P):

    h_t = exp(dt_t · A) · h_{t-1} + dt_t · B_t ⊗ x_t
    y_t = C_t · h_t + D · x_t

with B_t, C_t shared across heads (one group, the Mamba2 default).
``ssd_chunked`` is the chunked SSD algorithm: within a chunk of Q steps a
(Q × Q) masked-decay product, across chunks a recurrence over the f32
(B, H, N, P) state (the reference's ``lax.scan``; here a Python loop over
the chunks). ``ssd_step`` is the one-token update of decoding.

Params layout, as the reference's (leading L axis on every "blocks" leaf):
    blocks/ln/w       (L, d)           blocks/gnorm/w (L, H·P)
    blocks/in_z, in_x (L, d, H, P)     blocks/in_B, in_C (L, d, N)
    blocks/in_dt      (L, d, H)        blocks/out (L, H, P, d)
    blocks/conv_w     (L, K, ch)       blocks/conv_b (L, ch), ch = H·P + 2N
    blocks/A_log, D, dt_bias (L, H)    f32

Dtypes are the reference's: ``dt`` is a softplus in f32, the products
C·B, the chunk states and the carried state are f32, and the intra-chunk
weights ``M`` are cast to x's dtype before their contraction with x.

One deliberate difference: the intra-chunk decay masks ``L_t − L_s``
above the diagonal to −inf before the exponential. The reference takes
``where(tri, exp(diff), 0)``: the same forward, bit for bit, but above
the diagonal ``diff`` is positive and grows with Q · H · dt, so at the
published widths (Mamba2-130M: H 24, Q 256) ``exp`` overflows to inf there
and its backward gives 0 · inf = NaN in the gradients of ``dt`` (hence of
``in_dt``, ``dt_bias`` and ``A_log``). Masking first gives the
reference's gradient wherever that is finite, and a finite one there.

With a block's masks, the six projections (``in_z``, ``in_x``, ``in_B``,
``in_C``, ``in_dt``, ``out``) go through the ``masked_matmul`` kernel
(``layers._linear``); ``conv_w`` is a depthwise convolution, not a
product, and takes ``w * m`` in plain torch, as the reference's
``apply_masks``.

``init`` draws from a ``torch.Generator`` with the reference's shapes and
scales; it does not reproduce ``jax.random``'s numbers (tests bring the
reference's weights over with ``repro_torch.interop``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import fsdp
from repro_torch.models import layers as L
from repro_torch.models import transformer as TR

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_mamba_block(g: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> Params:
    """One Mamba block's params; ``lead`` prepends stack axes."""
    d, N, K = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    H, P = cfg.ssm_num_heads, cfg.ssm_head_dim
    ch = H * P + 2 * N
    dev = g.device
    s = 1.0 / math.sqrt(d)

    def full(shape, value, dt):
        return torch.full((*lead, *shape), value, dtype=dt, device=dev)

    ln = {"w": full((d,), 1.0, dtype)}
    if cfg.norm == "layernorm":
        ln["b"] = full((d,), 0.0, dtype)
    return {
        "ln": ln,
        "in_z": TR._normal(g, (*lead, d, H, P), s, dtype),
        "in_x": TR._normal(g, (*lead, d, H, P), s, dtype),
        "in_B": TR._normal(g, (*lead, d, N), s, dtype),
        "in_C": TR._normal(g, (*lead, d, N), s, dtype),
        "in_dt": TR._normal(g, (*lead, d, H), s, dtype),
        "conv_w": TR._normal(g, (*lead, K, ch), 1.0 / math.sqrt(K), dtype),
        "conv_b": full((ch,), 0.0, dtype),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev)
                           ).expand(*lead, H).clone(),
        "D": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), -2.0, torch.float32),  # softplus(-2) ~ 0.13
        "gnorm": {"w": full((H * P,), 1.0, dtype)},
        "out": TR._normal(g, (*lead, H, P, d), 1.0 / math.sqrt(H * P), dtype),
    }


def init(g: torch.Generator, cfg: ModelConfig) -> Params:
    """Params on ``g.device``."""
    dtype = TR.torch_dtype(cfg.param_dtype)
    d, V = cfg.d_model, cfg.padded_vocab
    params: Params = {
        "embed": {"tok": TR._normal(g, (V, d), 0.02, dtype)},
        "blocks": init_mamba_block(g, cfg, dtype, lead=(cfg.num_layers,)),
        "final_norm": {"w": torch.ones((d,), dtype=dtype, device=g.device)},
        "head": {"w": TR._normal(g, (d, V), 0.02, dtype)},
    }
    if cfg.norm == "layernorm":
        params["final_norm"]["b"] = torch.zeros((d,), dtype=dtype, device=g.device)
    return params


# ---------------------------------------------------------------------------
# causal depthwise conv (width K) with an optional carried state
# ---------------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, ch); w (K, ch); state (B, K-1, ch) from earlier steps.
    Returns (silu(conv + b) (B, S, ch), the new state (B, K-1, ch))."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K-1, ch)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, xp.shape[1] - (K - 1):] if K > 1 else state
    return F.silu(y + b), new_state


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dt (B, S, H) f32, already softplus'd; A (H,) f32,
    negative; Bm, Cm (B, S, N); init_state (B, H, N, P). Returns
    (y (B, S, H, P) in x's dtype, the final f32 state (B, H, N, P))."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H).float()
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    Lc = torch.cumsum(dtc * A, dim=2)  # inclusive cumulative log-decay, (B, nc, Q, H)

    # intra-chunk: the decay exp(L_t - L_s) for s <= t, masked before the exp
    CB = torch.einsum("bcqn,bckn->bcqk", Cc.float(), Bc.float())
    diff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]  # (B, nc, Q, Q, H) = L_t - L_s
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(diff.masked_fill(~tri, -math.inf))
    M = CB[..., None] * decay * dtc[:, :, None, :, :]  # (B, nc, Q, Q, H); s is axis 3
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M.to(x.dtype), xc)

    # each chunk's summary state and its total decay
    w_end = torch.exp(Lc[:, :, -1:, :] - Lc) * dtc  # (B, nc, Q, H)
    S_chunk = torch.einsum("bckn,bckh,bckhp->bchnp", Bc.float(), w_end, xc.float())
    chunk_decay = torch.exp(Lc[:, :, -1, :])  # (B, nc, H)

    # inter-chunk recurrence over the carried f32 state; each chunk's output
    # reads the state entering it, all chunks in one product after the loop
    state = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cc.float(), torch.stack(entering, dim=1)) * \
        torch.exp(Lc)[..., None]
    y = y_intra.reshape(Bsz, nc * Q, H, P).float() + y_inter.reshape(Bsz, nc * Q, H, P)
    return y[:, :S].to(x.dtype), state


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-token recurrent update (decode): x (B, 1, H, P), dt (B, 1, H),
    Bm, Cm (B, 1, N), state (B, H, N, P) f32 -> (y (B, 1, H, P), new state)."""
    dt = dt[:, 0].float()  # (B, H)
    a = torch.exp(dt * A)
    dBx = torch.einsum("bn,bh,bhp->bhnp", Bm[:, 0].float(), dt, x[:, 0].float())
    new_state = state * a[:, :, None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), new_state)
    return y[:, None].to(x.dtype), new_state


# ---------------------------------------------------------------------------
# the Mamba block: norm -> projections -> conv -> SSD -> gated norm -> out
# ---------------------------------------------------------------------------
def in_proj(bp: Params, cfg: ModelConfig, h: torch.Tensor, masks: Optional[Params] = None):
    """-> (u, the normed input; z (B, S, H, P); xbc (B, S, ch), the conv's
    input; dt_raw (B, S, H))."""
    mk = masks or {}
    Bsz, S, _ = h.shape
    H, P = cfg.ssm_num_heads, cfg.ssm_head_dim
    u = L.apply_norm(bp["ln"], h, cfg.norm)
    z = L._linear(u, bp["in_z"], 1, mk.get("in_z"))
    x = L._linear(u, bp["in_x"], 1, mk.get("in_x"))
    Bm = L._linear(u, bp["in_B"], 1, mk.get("in_B"))
    Cm = L._linear(u, bp["in_C"], 1, mk.get("in_C"))
    dt_raw = L._linear(u, bp["in_dt"], 1, mk.get("in_dt"))
    xbc = torch.cat([x.reshape(Bsz, S, H * P), Bm, Cm], dim=-1)
    return u, z, xbc, dt_raw


def mixer(bp: Params, cfg: ModelConfig, z: torch.Tensor, xbc: torch.Tensor,
          dt_raw: torch.Tensor, state: Optional[Params] = None,
          masks: Optional[Params] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """conv -> SSD -> gated RMS norm: the input of the ``out`` projection,
    (B, S, H·P), and the new state (with ``state``: a token (S == 1) takes
    ``ssd_step``, a prompt ``ssd_chunked`` from the state)."""
    Bsz, S, _ = xbc.shape
    H, P, N = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_w = bp["conv_w"]
    if masks is not None and "conv_w" in masks:
        conv_w = conv_w * masks["conv_w"].to(conv_w.dtype)
    xbc, new_conv = causal_conv(xbc, conv_w, bp["conv_b"],
                                state["conv"] if state is not None else None)
    x = xbc[..., :H * P].reshape(Bsz, S, H, P)
    Bm = xbc[..., H * P:H * P + N]
    Cm = xbc[..., H * P + N:]
    v = dt_raw.float() + bp["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))  # softplus, as jax.nn.softplus
    A = -torch.exp(bp["A_log"])
    if state is not None and S == 1:
        y, new_ssm = ssd_step(x, dt, A, Bm, Cm, state["ssm"])
    else:
        y, new_ssm = ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk,
                                 state["ssm"] if state is not None else None)
    y = y + bp["D"].to(y.dtype)[None, None, :, None] * x
    yf = y.reshape(Bsz, S, H * P) * F.silu(z.reshape(Bsz, S, H * P))
    yf = L.rms_norm(yf, bp["gnorm"]["w"])
    new_state = {"conv": new_conv, "ssm": new_ssm} if state is not None else None
    return yf, new_state


def mamba_block_apply(bp: Params, cfg: ModelConfig, h: torch.Tensor,
                      state: Optional[Params] = None, masks: Optional[Params] = None
                      ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One Mamba block -> (h', the new state or None). ``state`` is
    ``{"conv": (B, K-1, ch), "ssm": (B, H, N, P)}`` or None, ``masks`` the
    block's mask dict or None."""
    _, z, xbc, dt_raw = in_proj(bp, cfg, h, masks)
    yf, new_state = mixer(bp, cfg, z, xbc, dt_raw, state, masks)
    return h + L._linear(yf, bp["out"], 2, (masks or {}).get("out")), new_state


# ---------------------------------------------------------------------------
# LM forward / serving
# ---------------------------------------------------------------------------
def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   masks: Optional[Params] = None) -> torch.Tensor:
    h = L.embed(params["embed"]["tok"], tokens, TR.torch_dtype(cfg.dtype))
    for i in range(cfg.num_layers):
        bm = TR.slice_block(masks["blocks"], i) if masks is not None else None
        h = TR.remat_block(cfg, _mamba_body, TR.slice_block(params["blocks"], i), cfg, h, bm)
    return L.apply_norm(params["final_norm"], h, cfg.norm)


def _mamba_body(bp: Params, cfg: ModelConfig, h: torch.Tensor,
                masks: Optional[Params]) -> torch.Tensor:
    """One Mamba block of the training forward (the reference's remat body)."""
    return mamba_block_apply(fsdp.gather_block(bp), cfg, h, masks=masks)[0]


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            masks: Optional[Params] = None) -> torch.Tensor:
    return L.lm_logits(params["head"]["w"], forward_hidden(params, cfg, tokens, masks))


def init_states(cfg: ModelConfig, lead, batch: int, device, dtype) -> Params:
    """Zero Mamba states for stacked blocks (leading ``lead`` axes): conv
    (*lead, B, K-1, ch) in ``dtype``, ssm (*lead, B, H, N, P) f32."""
    H, P, N, K = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros((*lead, batch, K - 1, H * P + 2 * N), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((*lead, batch, H, N, P), dtype=torch.float32, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None) -> Params:
    """The reference's cache, O(1) in the sequence: conv (L, B, K-1, ch) in
    the model's dtype, ssm (L, B, H, N, P) f32; ``len`` a host int."""
    dtype = dtype or TR.torch_dtype(cfg.dtype)
    return {**init_states(cfg, (cfg.num_layers,), batch, device, dtype), "len": 0}


def run_cached(bp: Params, cfg: ModelConfig, h: torch.Tensor, conv: torch.Tensor,
               ssm: torch.Tensor) -> torch.Tensor:
    """One block against its cache slabs ``conv`` and ``ssm``, written in place."""
    h, ns = mamba_block_apply(bp, cfg, h, state={"conv": conv, "ssm": ssm})
    conv.copy_(ns["conv"])
    ssm.copy_(ns["ssm"])
    return h


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache: Params):
    """Run tokens (B, S) from the cached states, writing the new ones in
    place. Returns (the last position's f32 logits (B, 1, V), the cache
    with ``len`` advanced by S)."""
    h = L.embed(params["embed"]["tok"], tokens, TR.torch_dtype(cfg.dtype))
    for i in range(cfg.num_layers):
        h = run_cached(TR.slice_block(params["blocks"], i), cfg, h, cache["conv"][i],
                       cache["ssm"][i])
    h = L.apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
    return L.lm_logits(params["head"]["w"], h), {"conv": cache["conv"], "ssm": cache["ssm"],
                                                 "len": cache["len"] + tokens.shape[1]}


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor, cache: Params):
    """token (B, 1) -> (logits (B, 1, V), the cache one position on)."""
    return prefill(params, cfg, token, cache)
