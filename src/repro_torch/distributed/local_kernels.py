"""The kernels on DTensors: each runs on its local shards (``local_map``).

No kernel is taken apart into plain torch ops on a DTensor. A wrapper
given DTensors maps them to their local tensors, calls itself on those
(the kernel on a CUDA tensor, its plain version on a CPU one) and labels
the result with the placements the sharding rule below gives; a layout
the rule does not cover raises ValueError.

``masked_matmul`` ``x (M, K) @ (w ⊙ m) (K, N)``, per mesh dimension:

    x           w, m        out         grad x      grad w
    Shard(0)    Replicate   Shard(0)    Shard(0)    Partial   (data-parallel rows)
    Replicate   Shard(1)    Shard(1)    Partial     Shard(1)  (column-parallel)
    Shard(1)    Shard(0)    Partial     Shard(1)    Shard(0)  (row-parallel)
    Replicate   Replicate   Replicate   Replicate   Replicate

The "grad" columns are ``local_map``'s ``in_grad_placements``: on a
data-sharded batch each rank's dW is its rows' share of the sum, so it is
labelled ``Partial``. Left at the input's ``Replicate``, each rank would
keep its own partial gradient as if it were the whole one. The caller
sums it (``reduce_grads`` redistributes every gradient to its weight's
placements before the update). A row-parallel output is ``Partial`` over
"model", summed before the residual add (``act_sharding.constrain``).

E slabs (x (E, C, K), w and m (E, K, N): the routed experts) take the
same rule on their last two dims, plus expert parallelism:

    x           w, m        out         grad x      grad w
    Shard(0)    Shard(0)    Shard(0)    Shard(0)    Shard(0)  (expert-parallel slabs)

A bf16 weight whose local width the kernel cannot take (a column shard
of fewer than 8 or an odd number of columns: Mamba2-130M's ``in_dt``,
(768, 24), is (768, 12) a rank on a 1 × 2 mesh) is laid out for it: the
local weight and mask padded with zero columns to a multiple of 8, the
product cut back (``_laid_out``). It never falls back to a plain version.

Attention (``models.layers.attend``) is independent across batch rows
and heads: q, k and v (B, S, H, hd) run locally under q's placements,
each ``Shard(0)``, ``Shard(2)`` or ``Replicate`` per mesh dimension; kv
heads that replicate where q's heads shard (GQA with few kv heads) are
repeated to H and cut to q's heads first.

The MoE layer's routed experts (``moe_routed``) and the Mamba mixer
(``mamba_mixer``) are one ``local_map`` each, whose local function is the
model's own (``models.moe.routed_local``, ``models.ssm.mixer_local``):

* MoE, per mesh dimension: tokens split (x ``Shard(0)``, the experts
  replicated), experts split (x replicated, ``w_gate``/``w_up``/``w_down``
  ``Shard(0)`` over E), or their ff split (``Shard(2)``, ``Shard(2)``,
  ``Shard(1)``: E does not divide). The router is replicated: each rank
  routes every token it holds and dispatches only the assignments of its
  own experts, so the output is ``Partial`` over an expert or ff split
  (summed by ``act_sharding.constrain``). A dispatch group that spans
  token ranks takes each expert's slot positions from an exclusive scan
  of the per-expert counts of the ranks before it (an all-gather of E
  counts), so the kept assignments are one process's. The load-balance
  loss is ``Partial`` over the token ranks (each rank's share of the
  probabilities' mean against the global counts) and counted once over
  an expert split; ``moe_routed`` returns it replicated.
* Mamba, per mesh dimension: batch split (every activation ``Shard(0)``),
  heads split (z, x, dt ``Shard`` on H, B and C replicated, ``gnorm/w``
  ``Shard(0)``; the conv, ``A_log``, ``D`` and ``dt_bias`` replicated and
  sliced to the local heads' channels), or replicated. The gated norm's
  sum of squares runs over all H·P channels (an all-reduce over the heads
  split). The serve state: the SSM state (B, H, N, P) splits as the heads,
  the conv state (B, K-1, ch) only over the batch (its x channels are
  gathered after each step).

The gradients (``in_grad_placements``): a replicated operand read by
split work (the router, B and C, the conv, the SSM's per-head vectors,
the layer's input under an expert or ff split) gets a ``Partial``
gradient; ``reduce_grads`` sums it.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def any_dtensor(*ts) -> bool:
    if not torch.distributed.is_available():
        return False
    dt = _dtensor_type()
    return any(isinstance(t, dt) for t in ts)


def reduce_grads(grads, leaves):
    """Each DTensor gradient in its weight's placements (plain ones pass).
    A weight replicated over the data axes gets a partial sum from each
    rank's rows (``Partial``), which this all-reduces: the gradient the
    reference's GSPMD sums. The EBFT walk's tuning step and the train step
    (``training/train_loop.value_and_grad``) share it."""
    return [g.redistribute(w.device_mesh, w.placements) if any_dtensor(g) else g
            for g, w in zip(grads, leaves)]


def _mm_rule(xp, wp, batched: bool = False):
    """(out, grad x, grad w) placements of a masked matmul per mesh
    dimension; on E slabs the matrix rule runs on the last two dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    o = 1 if batched else 0
    R, Sm, Sk, Sn = Replicate(), Shard(o), Shard(o + 1), Shard(o + 1)
    out, gx, gw = [], [], []
    for a, b in zip(xp, wp):
        if batched and a == Shard(0) and b == Shard(0):
            out.append(Shard(0)), gx.append(Shard(0)), gw.append(Shard(0))
        elif a == Sm and b == R:
            out.append(Sm), gx.append(Sm), gw.append(Partial())
        elif a == R and b == Shard(o + 1):
            out.append(Sn), gx.append(Partial()), gw.append(Shard(o + 1))
        elif a == Sk and b == Shard(o):
            out.append(Partial()), gx.append(Sk), gw.append(Shard(o))
        elif a == R and b == R:
            out.append(R), gx.append(R), gw.append(R)
        else:
            raise ValueError(f"masked_matmul: no sharding rule for x {tuple(xp)} "
                             f"against w {tuple(wp)}")
    return out, gx, gw


def _as_dtensor(t, mesh):
    """A plain operand beside DTensors is replicated on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def masked_matmul(fn: Callable, x, w, m, **tiles):
    """``fn(x, w, m)`` (the public wrapper) on the local shards of DTensor
    operands, matrices or E slabs, under the rule of the module
    docstring."""
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t.device_mesh for t in (x, w, m) if any_dtensor(t))
    x, w, m = (_as_dtensor(t, mesh) for t in (x, w, m))
    if x.dim() not in (2, 3) or w.dim() != x.dim():
        raise ValueError("masked_matmul: a DTensor route takes matrices or E slabs "
                         f"(x {tuple(x.shape)}, w {tuple(w.shape)})")
    if tuple(m.placements) != tuple(w.placements):
        raise ValueError(f"masked_matmul: mask placements {tuple(m.placements)} differ "
                         f"from the weight's {tuple(w.placements)}")
    out, gx, gw = _mm_rule(x.placements, w.placements, batched=x.dim() == 3)
    local = local_map(lambda a, b, c: _laid_out(fn, a, b, c, tiles), out_placements=out,
                      in_placements=(list(x.placements), list(w.placements),
                                     list(m.placements)),
                      in_grad_placements=(gx, gw, gw), device_mesh=mesh)
    return local(x, w, m)


def _laid_out(fn: Callable, a, b, c, tiles):
    """``fn(a, b, c)`` on a local shard; a bf16 weight on the card whose
    width N is not a multiple of 8 (the kernel's unit) goes in padded with
    zero columns, weight and mask, and the product is cut back to N."""
    N = b.shape[-1]
    if a.device.type != "cuda" or a.dtype != torch.bfloat16 or N % 8 == 0:
        return fn(a, b, c, **tiles)
    b, c = pad_columns(b, c, 8)
    return fn(a, b, c, **tiles)[..., :N]


def pad_columns(w, m, unit: int):
    """w and m (..., K, N) with zero columns up to a multiple of ``unit``:
    the padded columns are masked out, so the product's first N columns
    are the unpadded product's. The mask keeps the kernel's row layout
    (``masked_matmul.ops.aligned_mask``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.masked_matmul.ops import aligned_mask

    pad = -w.shape[-1] % unit
    buf = m.new_zeros((*m.shape[:-1], m.shape[-1] + pad))
    buf[..., :m.shape[-1]] = m
    return F.pad(w, (0, pad)), (buf if m.is_floating_point() else aligned_mask(buf))


def attend(fn: Callable, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` (``layers.attend``) on local batch rows and
    heads."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    ok = (Replicate(), Shard(0), Shard(2))
    if any(p not in ok for p in q.placements):
        raise ValueError(f"attend: no sharding rule for q placements {tuple(q.placements)}")
    k, v = (_as_dtensor(t, mesh) for t in (k, v))
    if tuple(k.placements) != tuple(q.placements) or tuple(v.placements) != tuple(q.placements):
        groups = q.shape[2] // k.shape[2]
        k, v = (_repeat_heads(t, groups).redistribute(mesh, q.placements) for t in (k, v))
    pl = list(q.placements)
    local = local_map(lambda a, b, c: fn(*(_DenseGrad.apply(t) for t in (a, b, c)), **kw),
                      out_placements=pl,
                      in_placements=(pl, pl, pl), in_grad_placements=(pl, pl, pl),
                      device_mesh=mesh)
    return local(q, k, v)


def embed(tokens, table):
    """``F.embedding(tokens, table)`` for a DTensor table (or tokens): each
    rank looks up its own vocab rows. Per mesh dimension, a vocab-sharded
    table (``Shard(0)``, tokens replicated there) gives each rank the rows
    its shard holds and zeros elsewhere, labelled ``Partial`` (the caller
    sums it: ``act_sharding.constrain``); a replicated table follows the
    tokens' placement. A table sharded along its width (FSDP) is gathered
    first. DTensor's own rule labels the output with a masked partial whose
    backward it cannot redistribute."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t.device_mesh for t in (tokens, table) if any_dtensor(t))
    tokens, table = (_as_dtensor(t, mesh) for t in (tokens, table))
    table = table.redistribute(mesh, [p if p == Shard(0) else Replicate()
                                      for p in table.placements])
    out, gw, offset = [], [], 0
    rows = table.to_local().shape[0]
    for dim, (a, b) in enumerate(zip(tokens.placements, table.placements)):
        if b == Shard(0):
            if a != Replicate():
                raise ValueError(f"embed: tokens {a} against a vocab-sharded table on mesh "
                                 f"dimension {dim}")
            out.append(Partial()), gw.append(Shard(0))
            offset = offset * mesh.size(dim) + mesh.get_local_rank(dim)
        elif a == Shard(0):
            out.append(Shard(0)), gw.append(Partial())
        elif a == Replicate():
            out.append(Replicate()), gw.append(Replicate())
        else:
            raise ValueError(f"embed: no sharding rule for tokens {a} on mesh dimension {dim}")
    lo = offset * rows

    def local(t, w):
        hit = (t >= lo) & (t < lo + rows)
        rows_ = F.embedding(torch.where(hit, t - lo, torch.zeros_like(t)), w)
        return rows_ * hit[..., None].to(rows_.dtype)

    return local_map(local, out_placements=out,
                     in_placements=(list(tokens.placements), list(table.placements)),
                     in_grad_placements=(list(tokens.placements), gw),
                     device_mesh=mesh)(tokens, table)


def pieces(mesh, dims) -> Tuple[int, int]:
    """(this rank's index, the count) of the pieces a tensor is cut into
    over the mesh dimensions ``dims``, in DTensor's order (the first
    dimension outermost)."""
    idx, n = 0, 1
    for d in dims:
        idx, n = idx * mesh.size(d) + mesh.get_local_rank(d), n * mesh.size(d)
    return idx, n


def gather_pieces(t, mesh, dims):
    """Every rank's ``t`` over the mesh dimensions ``dims``, stacked in
    ``pieces``' order: (n, *t.shape). No gradient."""
    from torch.distributed import _functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    out = t.detach()[None]
    for d in reversed(dims):  # the innermost dimension first
        out = funcol.wait_tensor(gather(out.contiguous(), 0, (mesh, d)))
    return out


class _SumOver(torch.autograd.Function):
    """A sum over the ranks of the mesh dimensions ``dims`` (an all-reduce)
    whose gradient is the same all-reduce of the output's gradients."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return _all_reduce(t, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.dims), None, None


def _all_reduce(t, mesh, dims):
    from torch.distributed import _functional_collectives as funcol

    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t.contiguous(), "sum", (mesh, d)))
    return t


def moe_routed(fn: Callable, x, router_w, experts, masks=None):
    """The routed experts of an MoE layer on local shards: ``fn(x, router_w,
    experts, masks, chunk=, n_chunks=, gather=, e0=)``
    (``models.moe.routed_local``) on each rank's tokens and experts, under
    the rule of the module docstring. x (B, S, d); ``experts`` and
    ``masks`` (or None) the dicts of ``w_gate``, ``w_up`` (E, d, ff) and
    ``w_down`` (E, ff, d). Returns (out (B, S, d), ``Partial`` over an
    expert or ff split; the load-balance loss, replicated)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = ("w_gate", "w_up", "w_down")
    ws = [experts[k] for k in names]
    ms = [masks[k] for k in names] if masks is not None else []
    mesh = next(t.device_mesh for t in (x, router_w, *ws, *ms) if any_dtensor(t))
    x, router_w, *ws = (_as_dtensor(t, mesh) for t in (x, router_w, *ws))
    ms = [_as_dtensor(t, mesh) for t in ms]
    if any(tuple(m.placements) != tuple(w.placements) for m, w in zip(ms, ws)):
        raise ValueError("moe_routed: the expert masks' placements differ from the weights'")
    R, S0 = Replicate(), Shard(0)
    kinds = []
    rules = {(S0, R, R): "tokens", (R, S0, S0): "experts", (R, Shard(2), Shard(1)): "ff",
             (R, R, R): "none"}
    for a, r, g, u, dn in zip(x.placements, router_w.placements,
                              *(w.placements for w in ws)):
        kind = rules.get((a, g, dn)) if r == R and g == u else None
        if kind is None:
            raise ValueError(f"moe_routed: no sharding rule for x {tuple(x.placements)}, "
                             f"the router {tuple(router_w.placements)} and the experts "
                             f"{[tuple(w.placements) for w in ws]}")
        kinds.append(kind)
    dims = {k: [d for d, kd in enumerate(kinds) if kd == k] for k in ("tokens", "experts")}
    chunk, n_chunks = pieces(mesh, dims["tokens"])
    e_piece = pieces(mesh, dims["experts"])[0]
    # the loss is every expert rank's: counted on the first alone
    lead = all(mesh.get_local_rank(d) == 0 for d, k in enumerate(kinds) if k in ("experts", "ff"))
    out_pl = [S0 if k == "tokens" else R if k == "none" else Partial() for k in kinds]
    aux_pl = [R if k == "none" else Partial() for k in kinds]
    shared = [Partial() if k != "none" else R for k in kinds]
    gws = [[Partial() if k == "tokens" else p for k, p in zip(kinds, w.placements)] for w in ws]

    def local(xl, rl, *wl):
        el = dict(zip(names, wl[:3]))
        ml = dict(zip(names, wl[3:])) if wl[3:] else None
        out, aux = fn(xl, rl, el, ml, chunk=chunk, n_chunks=n_chunks,
                      gather=lambda t: gather_pieces(t, mesh, dims["tokens"]),
                      e0=e_piece * el["w_gate"].shape[0])
        return out, aux if lead else aux * 0.0

    run = local_map(local, out_placements=(out_pl, aux_pl),
                    in_placements=(list(x.placements), list(router_w.placements),
                                   *(list(t.placements) for t in (*ws, *ms))),
                    in_grad_placements=(out_pl, shared, *gws, *gws[:len(ms)]),
                    device_mesh=mesh)
    out, aux = run(x, router_w, *ws, *ms)
    return out, aux.redistribute(mesh, [R] * mesh.ndim)


def mamba_mixer(fn: Callable, cfg, z, x, Bm, Cm, dt_raw, conv_w, conv_b, A_log, D, dt_bias,
                gnorm_w, state=None):
    """The Mamba mixer on local heads and batch rows: ``fn(cfg, z, x, Bm,
    Cm, dt_raw, conv_w, conv_b, A_log, D, dt_bias, gnorm_w, state, h0=,
    sum_sq=, gather_x=)`` (``models.ssm.mixer_local``) under the rule of
    the module docstring. z, x (B, S, H, P), Bm, Cm (B, S, N), dt_raw (B,
    S, H); ``state`` None or ``{"conv": (B, K-1, ch), "ssm": (B, H, N,
    P)}``. Returns (the ``out`` projection's input (B, S, H·P), the new
    state or None)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    acts = (z, x, Bm, Cm, dt_raw)
    par = (conv_w, conv_b, A_log, D, dt_bias, gnorm_w)
    sts = (state["conv"], state["ssm"]) if state is not None else ()
    mesh = next(t.device_mesh for t in (*acts, *par, *sts) if any_dtensor(t))
    z, x, Bm, Cm, dt_raw, *par = (_as_dtensor(t, mesh) for t in (*acts, *par))
    sts = tuple(_as_dtensor(t, mesh) for t in sts)
    R, S0, P_ = Replicate(), Shard(0), Partial()
    # per kind: the activations', the B/C inputs', the gnorm's, the conv
    # and ssm states' placements
    want = {"batch": ((S0, S0, S0), (S0, S0), R, (S0, S0)),
            "heads": ((Shard(2), Shard(2), Shard(2)), (R, R), S0, (R, Shard(1))),
            "none": ((R, R, R), (R, R), R, (R, R))}
    kinds = []
    for d in range(mesh.ndim):
        kind = {S0: "batch", Shard(2): "heads", R: "none"}.get(z.placements[d])
        ok = kind is not None
        if ok:
            (_, px, pdt), (pb, pc), pg, (pcs, pss) = want[kind]
            ok = ((x.placements[d], dt_raw.placements[d], Bm.placements[d], Cm.placements[d],
                   par[5].placements[d]) == (px, pdt, pb, pc, pg)
                  and all(t.placements[d] == R for t in par[:5])
                  and (not sts or (sts[0].placements[d], sts[1].placements[d]) == (pcs, pss)))
        if not ok:
            raise ValueError(f"mamba_mixer: no sharding rule on mesh dimension {d} for z "
                             f"{tuple(z.placements)}, x {tuple(x.placements)}, B "
                             f"{tuple(Bm.placements)}, gnorm {tuple(par[5].placements)}"
                             + (f", state {[tuple(t.placements) for t in sts]}" if sts else ""))
        kinds.append(kind)
    heads = [d for d, k in enumerate(kinds) if k == "heads"]
    piece = pieces(mesh, heads)[0]
    y_pl = [want[k][0][0] for k in kinds]
    st_pl = [[want[k][3][i] for k in kinds] for i in (0, 1)]
    g_bc = [S0 if k == "batch" else P_ if k == "heads" else R for k in kinds]
    g_par = [R if k == "none" else P_ for k in kinds]
    g_gn = [S0 if k == "heads" else P_ if k == "batch" else R for k in kinds]

    def sum_sq(t):
        return _SumOver.apply(t, mesh, heads)

    def gather_x(t):  # (B, K-1, Hl·P) a rank -> (B, K-1, H·P)
        g = gather_pieces(t, mesh, heads)
        return g.permute(1, 2, 0, 3).reshape(*t.shape[:-1], -1)

    def local(zl, xl, bl, cl, dl, *rest):
        pl, sl = rest[:6], rest[6:]
        st = {"conv": sl[0], "ssm": sl[1]} if sl else None
        yf, ns = fn(cfg, zl, xl, bl, cl, dl, *pl, st, h0=piece * xl.shape[2],
                    sum_sq=sum_sq if heads else None, gather_x=gather_x if heads else None)
        return (yf, ns["conv"], ns["ssm"]) if ns is not None else yf

    placed = (z, x, Bm, Cm, dt_raw, *par, *sts)
    grads = (list(z.placements), list(x.placements), g_bc, g_bc, list(dt_raw.placements),
             *[g_par] * 5, g_gn, *[list(t.placements) for t in sts])
    run = local_map(local, out_placements=(y_pl, *st_pl) if sts else y_pl,
                    in_placements=tuple(list(t.placements) for t in placed),
                    in_grad_placements=grads, device_mesh=mesh)
    res = run(*placed)
    if not sts:
        return res, None
    return res[0], {"conv": res[1], "ssm": res[2]}


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous. The local
    attention's input gradients can come back as permuted views (the
    kernel's head folding, the plain path's einsums); with one head a rank
    such a view passes as contiguous, and the DTensor ``reshape`` before
    the attention then fails its local ``view`` (a 1 × 4 mesh on
    tiny_dense, ``tests/test_torch_mesh_ebft.py``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _repeat_heads(t, groups: int):
    """(B, S, Hkv, hd) -> (B, S, Hkv*groups, hd), each kv head repeated for
    its group of q heads."""
    if groups == 1:
        return t
    b, s, hkv, hd = t.shape
    return t.unsqueeze(3).expand(b, s, hkv, groups, hd).reshape(b, s, hkv * groups, hd)
