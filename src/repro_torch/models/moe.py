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
the reference's einsums. Dropped assignments add exact zeros into slot 0
of a slab (``index_put_`` accumulating, as the reference's ``.at[].add``)
and read it back as zeros, so the dispatch and its backward repeat bit
for bit.

``init`` draws from a ``torch.Generator`` with the reference's shapes and
scales; it does not reproduce ``jax.random``'s numbers (tests bring the
reference's weights over with ``repro_torch.interop``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import act_sharding as AS
from repro_torch.distributed import fsdp
from repro_torch.distributed import local_kernels as LK
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
    pos, keep = scan_positions(flat_idx, E, C)
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


def scan_positions(flat_idx: torch.Tensor, E: int, C: int,
                   offset: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, keep) of each assignment (token-major): its slot in its
    expert's slab, ``offset[e]`` (the group's assignments of expert e
    before these; none by default) plus its rank among these, kept when
    below the capacity C. Only keep/drop reaches the output: the expert
    FFN is row-independent. The one-hot is a comparison, as the
    reference's: ``F.one_hot`` reads the indices' bounds to the host on the
    CPU."""
    onehot = flat_idx[:, None] == torch.arange(E, device=flat_idx.device)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = torch.gather(pos, 1, flat_idx[:, None])[:, 0].long()
    if offset is not None:
        pos = pos + offset.long()[flat_idx]
    return pos, pos < C


def routed_local(x: torch.Tensor, router_w: torch.Tensor, ew: Params,
                 em: Optional[Params], cfg: ModelConfig, *, chunk: int = 0, n_chunks: int = 1,
                 gather=None, e0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts on the tokens and experts at hand: by default the
    whole batch and every expert (one device); on a mesh, one rank's shards
    (``local_kernels.moe_routed``). x (B, S, d) is piece ``chunk`` of
    ``n_chunks`` of the batch's tokens in order; ``ew`` (and ``em``, the
    masks) hold the experts e0 .. e0 + E_loc - 1, or every expert's ff
    slice. Each local dispatch group is routed over all E experts; only
    the kept assignments of the local experts are dispatched, run and
    combined, so the output is this rank's share of one process's. A group that spans pieces (G dividing ``n_chunks``)
    takes its slot offsets from the pieces before this one in the group
    (``gather``: every piece's per-expert counts, (n_chunks, E)), and its
    capacity from the whole group's T·k/E. Returns (out (B, S, d), this
    rank's share of the load-balance loss, the mean over the G groups)."""
    B, S, d = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    G = max(1, cfg.moe_dispatch_groups)
    if G % n_chunks == 0:
        groups, span = G // n_chunks, 1
    elif n_chunks % G == 0:
        groups, span = 1, n_chunks // G
    else:
        raise ValueError(f"moe: {G} dispatch groups over {n_chunks} token pieces")
    if (B * S) % groups:
        raise ValueError(f"moe_mlp: {B * S} tokens do not split into {groups} dispatch groups")
    Tg = B * S * n_chunks // G  # a group's tokens
    C = capacity(cfg, Tg)
    E_loc = ew["w_gate"].shape[0]
    outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
    for xf in x.reshape(groups, -1, d):
        gates, idx, probs = route(router_w, xf, k)
        flat_idx = idx.reshape(-1)
        counts = expert_counts(idx, E)
        offset = None
        if span > 1:  # the group's earlier pieces: an exclusive scan of their counts
            every = gather(counts)
            first = chunk - chunk % span
            offset, counts = every[first:chunk].sum(0), every[first:first + span].sum(0)
        pos, keep = scan_positions(flat_idx, E, C, offset)
        aux = aux + E * torch.sum(probs.sum(0) / Tg * (counts / (Tg * k)))
        le = flat_idx - e0
        mine = keep & (le >= 0) & (le < E_loc)
        li = torch.where(mine, le, torch.zeros_like(le))
        lp = torch.where(mine, pos, torch.zeros_like(pos))
        x_rep = torch.repeat_interleave(xf, k, dim=0)
        vals = torch.where(mine[:, None], x_rep, torch.zeros_like(x_rep))
        disp = torch.zeros((E_loc, C, d), dtype=xf.dtype, device=xf.device)
        disp = disp.index_put((li, lp), vals, accumulate=True)
        slots = expert_ffn(ew, disp, em)[li, lp]
        slots = torch.where(mine[:, None], slots, torch.zeros_like(slots))
        outs.append((slots.reshape(-1, k, d) * gates[..., None].to(xf.dtype)).sum(dim=1))
    return torch.cat(outs).reshape(B, S, d), aux / G


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
            masks: Optional[Params] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux load-balance loss, the mean over
    the ``moe_dispatch_groups`` G independent groups), through
    ``routed_local``. DTensor operands (a mesh) run it on each rank's
    tokens and experts (``local_kernels.moe_routed``), their partial sums
    over the experts summed before the shared experts are added."""
    B, S, d = x.shape
    T_ = B * S
    em = (masks or {}).get("experts")
    if LK.any_dtensor(x, p["router"]["w"], *p["experts"].values()):
        out, aux = LK.moe_routed(functools.partial(routed_local, cfg=cfg), x,
                                 p["router"]["w"], p["experts"], em)
        out = AS.constrain(out, "bqd")
    else:
        out, aux = routed_local(x, p["router"]["w"], p["experts"], em, cfg)
    if "shared" in p:
        sm = (masks or {}).get("shared")
        out = out + L.mlp_block(p["shared"], x.reshape(T_, d), "swiglu", sm).reshape(B, S, d)
    return out, aux


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
