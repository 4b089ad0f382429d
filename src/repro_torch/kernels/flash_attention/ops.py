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
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_plain,
)
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import is_abstract, record_kernel

launches = 0
bwd_launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (16, 32, 64, 128)  # the kernels' compiled head widths
_MAX_GRID_Y = 65535


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (BH, Sq, d); k, v (BH, Sk, d). ``q_offset`` is the position of
    q[:, 0] in the key timeline (shifts the causal diagonal)."""
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
        return FlashAttentionFn.apply(q, k, v, causal, int(q_offset))
    return _forward(q, k, v, causal, int(q_offset))


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


def _forward(q, k, v, causal: bool, q_offset: int, with_lse: bool = False):
    """The forward kernel (the plain version on the CPU); under a live obs
    run booked with ``record_kernel``. With ``with_lse`` also returns the
    f32 row log-sum-exp."""
    if q.device.type == "cpu":
        fn = flash_attention_plain
        kw = dict(causal=causal, q_offset=q_offset, return_lse=with_lse)
    else:
        fn, kw = _launch, dict(causal=causal, q_offset=q_offset, with_lse=with_lse)
    if not OT.enabled() or not (q.shape[0] and q.shape[1]) or is_abstract(q, k, v):
        return fn(q, k, v, **kw)
    return record_kernel("kernels/flash_attention", _fwd_flops(q, k, causal),
                         _bytes(q, k, v) + _bytes(q), fn, q, k, v, device=q.device, **kw)


class FlashAttentionFn(torch.autograd.Function):
    """Attention whose forward saves the row log-sum-exp and whose backward
    is the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        o, lse = _forward(q, k, v, causal, q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=ctx.causal,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None


def _check(q, k, v) -> None:
    """What every kernel of the library takes."""
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: kernel takes f32 or bf16 q == k == v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    BH, Sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if BH > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: BH={BH} exceeds the grid's {_MAX_GRID_Y}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: kernel takes contiguous (BH, S, d) operands")


def _launch(q, k, v, causal: bool, q_offset: int, with_lse: bool = False):
    """The forward kernel; with ``with_lse`` also returns the f32 row
    log-sum-exp (BH, Sq)."""
    global launches
    _check(q, k, v)
    BH, Sq, d = q.shape
    Sk = k.shape[1]
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel takes 16-byte-aligned operands")
    if q_offset + Sq + Sk > 2**31 - 1:
        raise ValueError("flash_attention: sequence positions exceed int32")
    out = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    if BH and Sq:
        lib = _build.load("flash_attention")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, f"flash_attention_{_SUFFIX[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, BH, Sq, Sk, d,
            int(causal), q_offset, 1.0 / math.sqrt(d), stream,
        )
        _build.check(code, "flash_attention")
        launches += 1
    return (out, lse) if with_lse else out


def _launch_bwd(q, k, v, o, do, lse, causal: bool, q_offset: int):
    global bwd_launches
    _check(q, k, v)
    if not (o.dtype == do.dtype == q.dtype and o.is_contiguous() and do.is_contiguous()):
        raise ValueError("flash_attention_bwd: o and do must be contiguous, in q's dtype")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be a contiguous f32 (BH, Sq) tensor")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: the bf16 kernel takes 16-byte-aligned operands")
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


def flash_attention_bshd(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B, Sq, H, hd); k, v (B, Sk, H, hd), already GQA-repeated."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]

    def fold(x, S):
        return x.transpose(1, 2).reshape(B * H, S, hd).contiguous()

    o = flash_attention(fold(q, Sq), fold(k, Sk), fold(v, Sk),
                        causal=causal, q_offset=q_offset)
    return o.reshape(B, H, Sq, hd).transpose(1, 2)
