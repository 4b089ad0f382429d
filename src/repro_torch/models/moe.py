"""Mixture-of-Experts transformer (port of ``repro.models.moe``: the
DeepSeek-MoE-16B and Kimi-K2 families).

Fine-grained MoE: ``moe_num_experts`` routed experts with top-k softmax
gating (renormalised over the selected k), plus ``moe_num_shared`` shared
experts that process every token. The first ``moe_first_dense`` layers are
ordinary dense blocks (``models/transformer.py``).

Params layout, as the reference's (leading L axis on every stacked leaf):
    dense_blocks/...                 the dense family's block leaves
    moe_blocks/ln1, ln2, attn/...    as a dense block
    moe_blocks/moe/router/w          (L, d, E)        f32, never pruned
    moe_blocks/moe/experts/w_gate    (L, E, d, ff)    w_up alike
    moe_blocks/moe/experts/w_down    (L, E, ff, d)
    moe_blocks/moe/shared/w_up       (L, d, ff·shared) w_gate alike, w_down (L, ff·shared, d)

Dispatch is the reference's capacity-based scatter/gather: each group's
T·k assignments are placed, in token-major order, at position ``pos`` of
their expert's (C, d) slab, C = max(1, int(cf·T·k/E)); an assignment past
C is dropped (its token falls through to the residual), which is the
reference's semantics at every capacity, decode included (a decode step of
8 slots has C = 1). Routing is f32 (``xf.float() @ router_w``); the top k
are taken by a stable descending sort, so ties go to the lower expert as
``lax.top_k``'s do. The routed experts' three products are
``masked_matmul_batched`` (one launch per leaf, the card's expert-batched
masked GEMM) when the block's masks are given, and ``torch.bmm`` on the
weights as they are otherwise (pretraining, serving the pruned tree), as
the reference's einsums. Dropped assignments add exact zeros into slot
(e, 0) (``index_put_`` accumulating, as the reference's ``.at[].add``) and
read it back as zeros, so the dispatch and its backward repeat bit for
bit.

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
from repro_torch.kernels.masked_matmul.ops import masked_matmul_batched
from repro_torch.models import layers as L
from repro_torch.models import transformer as TR

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_moe_mlp(g: torch.Generator, cfg: ModelConfig, dtype, lead=()) -> Params:
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.moe_num_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p: Params = {
        "router": {"w": TR._normal(g, (*lead, d, E), s_in, torch.float32)},
        "experts": {
            "w_gate": TR._normal(g, (*lead, E, d, ff), s_in, dtype),
            "w_up": TR._normal(g, (*lead, E, d, ff), s_in, dtype),
            "w_down": TR._normal(g, (*lead, E, ff, d), s_out, dtype),
        },
    }
    if cfg.moe_num_shared:
        fs = ff * cfg.moe_num_shared
        p["shared"] = {
            "w_up": TR._normal(g, (*lead, d, fs), s_in, dtype),
            "w_down": TR._normal(g, (*lead, fs, d), 1.0 / math.sqrt(fs), dtype),
            "w_gate": TR._normal(g, (*lead, d, fs), s_in, dtype),
        }
    return p


def init(g: torch.Generator, cfg: ModelConfig) -> Params:
    """Params on ``g.device``."""
    dtype = TR.torch_dtype(cfg.param_dtype)
    d, V = cfg.d_model, cfg.padded_vocab
    n_dense, n_moe = cfg.moe_first_dense, cfg.num_layers - cfg.moe_first_dense
    moe_blocks = TR.init_block(g, cfg, dtype, lead=(n_moe,), mlp=False)
    moe_blocks["moe"] = init_moe_mlp(g, cfg, dtype, lead=(n_moe,))
    params: Params = {
        "embed": {"tok": TR._normal(g, (V, d), 0.02, dtype)},
        "moe_blocks": moe_blocks,
        "final_norm": {"w": torch.ones((d,), dtype=dtype, device=g.device)},
    }
    if n_dense:
        params["dense_blocks"] = TR.init_block(g, cfg, dtype, lead=(n_dense,))
    if cfg.norm == "layernorm":
        params["final_norm"]["b"] = torch.zeros((d,), dtype=dtype, device=g.device)
    if not cfg.tie_embeddings:
        params["head"] = {"w": TR._normal(g, (d, V), 0.02, dtype)}
    return params


# ---------------------------------------------------------------------------
# routed expert dispatch
# ---------------------------------------------------------------------------
def route(router_w: torch.Tensor, xf: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf (T, d) -> (gates (T, k) f32, expert idx (T, k) int64, probs (T, E) f32)."""
    logits = xf.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[:, :k], top.indices[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a group of ``tokens`` (host floats, as the reference)."""
    return max(1, int(cfg.moe_capacity_factor * tokens * cfg.moe_top_k / cfg.moe_num_experts))


def dispatch(router_w: torch.Tensor, xf: torch.Tensor, cfg: ModelConfig):
    """Route one group and scatter it into the experts' slabs. Returns
    (disp (E, C, d), flat_idx, pos, keep (T·k,), gates (T, k), probs,
    idx (T, k)): assignment a of token a // k sits at (flat_idx[a],
    pos[a]) when keep[a]; a dropped one points at slot 0."""
    T_, d = xf.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    gates, idx, probs = route(router_w, xf, k)
    C = capacity(cfg, T_)
    flat_idx = idx.reshape(-1)
    # the one-hot as a comparison, as the reference's: F.one_hot reads the
    # indices' bounds to the host on the CPU
    onehot = flat_idx[:, None] == torch.arange(E, device=flat_idx.device)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1  # within expert
    pos = torch.gather(pos, 1, flat_idx[:, None])[:, 0].long()
    keep = pos < C
    pos = torch.where(keep, pos, torch.zeros_like(pos))
    x_rep = torch.repeat_interleave(xf, k, dim=0)
    vals = torch.where(keep[:, None], x_rep, torch.zeros_like(x_rep))
    disp = torch.zeros((E, C, d), dtype=xf.dtype, device=xf.device)
    disp = disp.index_put((flat_idx, pos), vals, accumulate=True)
    return disp, flat_idx, pos, keep, gates, probs, idx


def expert_ffn(ew: Params, disp: torch.Tensor, masks: Optional[Params] = None) -> torch.Tensor:
    """The routed experts' SwiGLU on their slabs: (E, C, d) -> (E, C, d).
    With ``masks`` (the experts' mask dict) each product is the
    expert-batched masked GEMM."""
    if masks is None:
        gate_h = torch.bmm(disp, ew["w_gate"])
        up_h = torch.bmm(disp, ew["w_up"])
        return torch.bmm(F.silu(gate_h) * up_h, ew["w_down"])
    gate_h = masked_matmul_batched(disp, ew["w_gate"], masks["w_gate"])
    up_h = masked_matmul_batched(disp, ew["w_up"], masks["w_up"])
    return masked_matmul_batched(F.silu(gate_h) * up_h, ew["w_down"], masks["w_down"])


def expert_counts(idx: torch.Tensor, E: int) -> torch.Tensor:
    """The number of assignments of each of the E experts, in f32, as the
    reference's scatter-add of ones (exact integers). ``torch.bincount``
    would give the same numbers, but its output size depends on the data,
    so on the card it reads the largest index to the host."""
    flat = idx.reshape(-1)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
    return torch.zeros(E, dtype=torch.float32, device=flat.device).index_add_(0, flat, ones)


def _dispatch_group(p: Params, xf: torch.Tensor, cfg: ModelConfig,
                    masks: Optional[Params] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route, dispatch and combine one token group. xf (T, d) -> (out, aux)."""
    T_, d = xf.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    disp, flat_idx, pos, keep, gates, probs, idx = dispatch(p["router"]["w"], xf, cfg)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = expert_counts(idx, E) / (T_ * k)
    aux = E * torch.sum(me * ce)

    eout = expert_ffn(p["experts"], disp, (masks or {}).get("experts"))
    slots = eout[flat_idx, pos]
    slots = torch.where(keep[:, None], slots, torch.zeros_like(slots))
    out = (slots.reshape(T_, k, d) * gates[..., None].to(xf.dtype)).sum(dim=1)
    return out, aux


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
            masks: Optional[Params] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux load-balance loss, the mean over
    the ``moe_dispatch_groups`` G independent groups)."""
    B, S, d = x.shape
    G = max(1, cfg.moe_dispatch_groups)
    T_ = B * S
    if T_ % G:
        raise ValueError(f"moe_mlp: {T_} tokens do not split into {G} dispatch groups")
    xg = x.reshape(G, T_ // G, d)
    outs, auxes = zip(*(_dispatch_group(p, xg[i], cfg, masks) for i in range(G)))
    out = torch.stack(outs).reshape(B, S, d)
    if "shared" in p:
        sm = (masks or {}).get("shared")
        out = out + L.mlp_block(p["shared"], x.reshape(T_, d), "swiglu", sm).reshape(B, S, d)
    return out, torch.stack(auxes).mean()


def moe_block_apply(bp: Params, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
                    masks: Optional[Params] = None, cache: Optional[Params] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE block -> (h', aux). ``masks`` is the block's mask dict or
    None, ``cache`` the block's KV cache (written in place) or None."""
    mk = masks or {}
    attn_in = L.apply_norm(bp["ln1"], h, cfg.norm)
    h = h + L.attention_block(
        bp["attn"], attn_in, positions=positions, rope_theta=cfg.rope_theta,
        causal=True, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
        q_chunk=cfg.attn_q_chunk, masks=mk.get("attn"), cache=cache,
    )
    mlp_in = L.apply_norm(bp["ln2"], h, cfg.norm)
    mlp_out, aux = moe_mlp(bp["moe"], mlp_in, cfg, mk.get("moe"))
    return h + mlp_out, aux


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------
def _n_dense(params: Params) -> int:
    return params["dense_blocks"]["ln1"]["w"].shape[0] if "dense_blocks" in params else 0


def forward_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   masks: Optional[Params] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (final hidden states (B, S, d), the blocks' aux sum)."""
    h = L.embed(params["embed"]["tok"], tokens, TR.torch_dtype(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    for i in range(_n_dense(params)):
        bm = TR.slice_block(masks["dense_blocks"], i) if masks is not None else None
        h = TR.block_apply(TR.slice_block(params["dense_blocks"], i), cfg, h, positions, bm)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_layers - cfg.moe_first_dense):
        bm = TR.slice_block(masks["moe_blocks"], i) if masks is not None else None
        h, a = TR.remat_block(cfg, _moe_body, TR.slice_block(params["moe_blocks"], i), cfg, h,
                              positions, bm)
        aux_total = aux_total + a
    return L.apply_norm(params["final_norm"], h, cfg.norm), aux_total


def _moe_body(bp: Params, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
              masks: Optional[Params]):
    """One MoE block of the training forward (the reference's remat body)."""
    return moe_block_apply(fsdp.gather_block(bp), cfg, h, positions, masks)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            masks: Optional[Params] = None) -> torch.Tensor:
    h, _ = forward_hidden(params, cfg, tokens, masks)
    return TR.logits_from_hidden(params, cfg, h)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None) -> Params:
    """One group each for the dense and the MoE blocks, in the port's
    (L, B, Hkv, max_len, hd) layout (``transformer.init_cache``); ``len``
    is a host int shared by every sequence."""
    dtype = dtype or TR.torch_dtype(cfg.dtype)
    n_dense, n_moe = cfg.moe_first_dense, cfg.num_layers - cfg.moe_first_dense

    def group(n):
        shape = (n, batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    cache: Params = {"moe": group(n_moe), "len": 0}
    if n_dense:
        cache["dense"] = group(n_dense)
    return cache


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache: Params):
    """Run tokens (B, S) at positions ``len .. len+S-1``, writing their keys
    and values into the cache in place. Returns (the last position's f32
    logits (B, 1, V), the cache with ``len`` advanced by S). Each block's
    routing sees only these B·S tokens, so its capacity is theirs."""
    start, S = cache["len"], tokens.shape[1]
    h = L.embed(params["embed"]["tok"], tokens, TR.torch_dtype(cfg.dtype))
    positions = torch.arange(start, start + S, device=tokens.device)[None, :]
    for i in range(_n_dense(params)):
        layer = {"k": cache["dense"]["k"][i], "v": cache["dense"]["v"][i], "len": start}
        h = TR.block_apply(TR.slice_block(params["dense_blocks"], i), cfg, h, positions,
                           cache=layer)
    for i in range(cfg.num_layers - cfg.moe_first_dense):
        layer = {"k": cache["moe"]["k"][i], "v": cache["moe"]["v"][i], "len": start}
        h, _ = moe_block_apply(TR.slice_block(params["moe_blocks"], i), cfg, h, positions,
                               cache=layer)
    h = L.apply_norm(params["final_norm"], h[:, -1:], cfg.norm)
    new_cache = {k: v for k, v in cache.items() if k != "len"}
    new_cache["len"] = start + S
    return TR.logits_from_hidden(params, cfg, h), new_cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor, cache: Params):
    """token (B, 1) -> (logits (B, 1, V), the cache one position on)."""
    return prefill(params, cfg, token, cache)
