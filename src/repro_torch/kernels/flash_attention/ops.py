"""Public wrappers of the flash attention kernel and its backward.

``flash_attention_bshd`` adapts the model-layer layout (B, S, H, hd), with
GQA heads already repeated, as ``models/layers.attend`` uses it for
``impl="flash"`` on the card. On a CPU tensor the wrappers run the plain
PyTorch versions; on a CUDA tensor they launch ``csrc/flash_attention.cu``
on the current stream or raise. When grad is enabled and q, k or v
requires it, :func:`flash_attention` goes through
:class:`FlashAttentionFn`: its forward also writes the f32 row
log-sum-exp, and its backward is the backward kernel (the plain formula on
the CPU), so a kernel's output always carries its autograd edge.
``launches`` and ``bwd_launches`` count kernel launches.

While an obs run is live, each launch (the plain version's call on the
CPU) is booked by ``obs.profile.record_kernel`` as
``kernels/flash_attention`` in the reference's accounting, 4·BH·Sq·Sk·d
FLOPs (half of it causal) and the bytes of q, k, v and the output, and as
``kernels/flash_attention_bwd`` with 2.5 × the forward's FLOPs (10·d
against 4·d per pair) and the bytes of q, k, v, o, do, lse, dq, dk, dv.

Every launch goes through its plan (``kernels.validation``): the bf16
forward on explicit tiles (bq, bk) or on those ``kernels.tuning``
resolves (128 / 128 by default; 64-row and 64-key tiles at head widths 64
and 128; a causal launch at a q_offset above 0 resolves nothing and runs
the default); the backward and the f32 forward keep their one tile. Nothing is
resolved or counted on a CPU tensor.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.distributed import local_kernels as LK
from repro_torch.kernels import _build, tuning
from repro_torch.kernels import validation as V
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_plain,
)
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import is_abstract, record_kernel

launches = 0
bwd_launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_DTYPE = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    **tiles) -> torch.Tensor:
    """q (BH, Sq, d); k, v (BH, Sk, d). ``q_offset`` is the position of
    q[:, 0] in the key timeline (shifts the causal diagonal). ``tiles``
    (bq, bk) fix the forward's launch plan on the card; without them it
    resolves through ``kernels.tuning``. A DTensor raises: attention on a
    mesh runs through ``models.layers.attend``, which maps its shards."""
    if LK.any_dtensor(q, k, v):
        raise TypeError("flash_attention: DTensor operands go through models.layers.attend "
                        "(distributed.local_kernels.attend)")
    BH, Sq, d = q.shape
    if k.dim() != 3 or k.shape[0] != BH or v.shape != k.shape or k.shape[2] != d:
        raise ValueError(
            f"flash_attention: inconsistent operand shapes q={tuple(q.shape)} "
            f"k={tuple(k.shape)} v={tuple(v.shape)}"
        )
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be an int >= 0, got {q_offset}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: operands on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, int(q_offset), tiles)
    return _forward(q, k, v, causal, int(q_offset), tiles=tiles)


def call(*operands, **params) -> torch.Tensor:
    """The uniform entry point (``kernels.dispatch``): operands ``(q, k,
    v)``, params ``causal``, ``q_offset``, ``layout`` (``"bshd"`` for the
    model's (B, S, H, hd)) and the tile overrides."""
    if params.pop("layout", "bhsd") == "bshd":
        return flash_attention_bshd(*operands, **params)
    return flash_attention(*operands, **params)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True, q_offset: int = 0):
    """dq, dk, dv from the forward's operands, its output ``o``, the
    upstream gradient ``do`` (q's shape) and the f32 row log-sum-exp
    ``lse`` (BH, Sq) that the forward wrote."""
    if do.shape != q.shape or o.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError(f"flash_attention_bwd: inconsistent shapes q={tuple(q.shape)} "
                         f"o={tuple(o.shape)} do={tuple(do.shape)} lse={tuple(lse.shape)}")
    if q.device.type == "cpu":
        fn = flash_attention_bwd_plain
    else:
        fn, do = _launch_bwd, do.contiguous()
    if not OT.enabled() or not (q.shape[0] and q.shape[1] and k.shape[1]) or \
            is_abstract(q, k, v, o, do, lse):
        return fn(q, k, v, o, do, lse, causal=causal, q_offset=int(q_offset))
    nbytes = 2 * _bytes(q, k, v) + _bytes(o, do, lse)  # dq, dk, dv as q, k, v
    return record_kernel("kernels/flash_attention_bwd", 2.5 * _fwd_flops(q, k, causal), nbytes,
                         fn, q, k, v, o, do, lse, causal=causal, q_offset=int(q_offset),
                         device=q.device)


def _bytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _fwd_flops(q, k, causal: bool) -> float:
    """The reference's count: 4·d per (query, key) pair, half the pairs causal."""
    BH, Sq, d = q.shape
    return 4.0 * BH * Sq * k.shape[1] * d * (0.5 if causal else 1.0)


def _forward(q, k, v, causal: bool, q_offset: int, with_lse: bool = False, tiles=None):
    """The forward kernel (the plain version on the CPU, where explicit
    tiles are checked against the plan and nothing is resolved); under a
    live obs run booked with ``record_kernel``, with the plan when the
    tuner resolved it. With ``with_lse`` also returns the f32 row
    log-sum-exp."""
    plan = None
    if q.device.type == "cpu":
        if tiles:
            _plan(q, k, v, causal, q_offset, "flash_attention", tiles)
        fn = flash_attention_plain
        kw = dict(causal=causal, q_offset=q_offset, return_lse=with_lse)
    else:
        tiles, source = _resolve(q, k, causal, q_offset, tiles)
        fn = functools.partial(_launch, **tiles) if tiles else _launch
        kw = dict(causal=causal, q_offset=q_offset, with_lse=with_lse)
        if source in ("cache", "search"):
            plan = dict(plan=source, **tiles)
    if not OT.enabled() or not (q.shape[0] and q.shape[1]) or is_abstract(q, k, v):
        return fn(q, k, v, **kw)
    return record_kernel("kernels/flash_attention", _fwd_flops(q, k, causal),
                         _bytes(q, k, v) + _bytes(q), fn, q, k, v, device=q.device, plan=plan,
                         **kw)


def _resolve(q, k, causal: bool, q_offset: int, tiles):
    """(tiles, source) of a forward launch: explicit tiles win; else
    ``tuning.resolve`` keyed by (BH, Sq, Sk, d), the dtype and ``causal``.
    A causal launch at ``q_offset`` > 0 (a decode step, a prefill into a
    filled cache) runs the default: its work depends on the offset, which
    the key leaves out (the search times offset 0)."""
    if tiles or q.dtype not in _DTYPE or (causal and q_offset) or tuning.mode() == "off":
        return dict(tiles or {}), None
    BH, Sq, d = q.shape
    return tuning.resolve("flash_attention", {"BH": BH, "Sq": Sq, "Sk": k.shape[1], "d": d},
                          {"q": _DTYPE[q.dtype]}, {"causal": bool(causal)}, device=q.device)


class FlashAttentionFn(torch.autograd.Function):
    """Attention whose forward saves the row log-sum-exp and whose backward
    is the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, tiles=None):
        o, lse = _forward(q, k, v, causal, q_offset, with_lse=True, tiles=tiles)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def _plan(q, k, v, causal: bool, q_offset: int, route: str, tiles, **more):
    """The launch plan of ``route`` (``kernels.validation``) on these
    operands (``more``: the backward's o and do); raises TypeError on
    dtypes the kernels do not take, ValueError where the plan refuses."""
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: kernel takes f32 or bf16 q == k == v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    BH, Sq, d = q.shape
    ops = {"q": q, "k": k, "v": v, **more}
    return V.plan_flash_attention(BH, Sq, k.shape[1], d, dtype=_DTYPE[q.dtype], causal=causal,
                                  q_offset=q_offset, route=route, **tiles,
                                  operands={n: (t.stride(), t.data_ptr()) for n, t in ops.items()})


def launch_uncounted(q, k, v, causal: bool, q_offset: int, tiles):
    """The forward on the plan of ``tiles``, not counted: the tuner's
    measurements (``kernels.tuning.search``)."""
    return _launch(q, k, v, causal, q_offset, count=False, **tiles)


def _launch(q, k, v, causal: bool, q_offset: int, with_lse: bool = False, *,
            count: bool = True, **tiles):
    """The forward kernel on the plan of ``tiles`` (the default's when none
    are given; the wrapper resolves them first), counted; with ``with_lse``
    also returns the f32 row log-sum-exp (BH, Sq)."""
    global launches
    plan = _plan(q, k, v, causal, q_offset, "flash_attention", tiles)
    BH, Sq, d = q.shape
    Sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if BH and Sq:
        lib = _build.load("flash_attention")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tile = [plan.tiles["bq"], plan.tiles["bk"]] if q.dtype == torch.bfloat16 else []
        code = getattr(lib, f"flash_attention_{_SUFFIX[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, BH, Sq, Sk, d,
            int(causal), q_offset, 1.0 / math.sqrt(d), *tile, stream,
        )
        _build.check(code, "flash_attention")
        if count:
            launches += 1
    return (out, lse) if with_lse else out


def _launch_bwd(q, k, v, o, do, lse, causal: bool, q_offset: int):
    global bwd_launches
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: kernel takes f32 or bf16 q == k == v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (o.dtype == do.dtype == q.dtype and o.is_contiguous() and do.is_contiguous()):
        raise ValueError("flash_attention_bwd: o and do must be contiguous, in q's dtype")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be a contiguous f32 (BH, Sq) tensor")
    _plan(q, k, v, causal, q_offset, "flash_attention_bwd", {}, o=o, do=do)
    BH, Sq, d = q.shape
    Sk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if BH and Sq and Sk:
        D = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)  # rowsum(do * o)
        lib = _build.load("flash_attention")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, f"flash_attention_bwd_{_SUFFIX[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            BH, Sq, Sk, d, int(causal), q_offset, 1.0 / math.sqrt(d), stream,
        )
        _build.check(code, "flash_attention_bwd")
        bwd_launches += 1
    else:
        for t in (dq, dk, dv):
            t.zero_()
    return dq, dk, dv


def flash_attention_bshd(q, k, v, *, causal: bool = True, q_offset: int = 0, **tiles):
    """q (B, Sq, H, hd); k, v (B, Sk, H, hd), already GQA-repeated."""
    if LK.any_dtensor(q, k, v):
        raise TypeError("flash_attention_bshd: DTensor operands go through "
                        "models.layers.attend (distributed.local_kernels.attend)")
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]

    def fold(x, S):
        return x.transpose(1, 2).reshape(B * H, S, hd).contiguous()

    o = flash_attention(fold(q, Sq), fold(k, Sk), fold(v, Sk),
                        causal=causal, q_offset=q_offset, **tiles)
    return o.reshape(B, H, Sq, hd).transpose(1, 2)
