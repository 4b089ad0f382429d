"""Plain PyTorch versions of the flash attention kernel and its backward."""
from __future__ import annotations

import math

import torch

_NEG = -1e30


def _acc(t: torch.Tensor) -> torch.Tensor:
    """Upcast to the f32 accumulator type (f64 stays f64, for gradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q, k, causal: bool, q_offset: int) -> torch.Tensor:
    """Scaled scores from upcast q and k, masked with -1e30 above the
    diagonal shifted by ``q_offset``."""
    s = torch.matmul(_acc(q), _acc(k).transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        qp = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qp >= kp, s, torch.full_like(s, _NEG))
    return s


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    q_offset: int = 0, return_lse: bool = False,
):
    """The kernel's online softmax taken as one tile. q (BH, Sq, d); k, v
    (BH, Sk, d). Scores in f32 from upcast q and k, masked with -1e30; p is
    rounded to v's dtype before PV while the normaliser sums the f32 p,
    clamped at 1e-30. With ``return_lse`` also the row log-sum-exp of the
    scores (BH, Sq), which the backward reads."""
    s = _scores(q, k, causal, q_offset)
    mx = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - mx)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (torch.matmul(_acc(p.to(v.dtype)), _acc(v)) / l).to(q.dtype)
    if return_lse:
        return o, (mx + torch.log(l)).squeeze(-1)
    return o


def flash_attention_lse_plain(q, k, *, causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """The row log-sum-exp (BH, Sq) of the scaled, masked scores, in f32:
    m + log(max(l, 1e-30)) with m the row max and l = sum exp(s - m), as the
    forward kernel writes it for the backward."""
    s = _scores(q, k, causal, q_offset)
    mx = s.amax(dim=-1, keepdim=True)
    l = torch.exp(s - mx).sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (mx + torch.log(l)).squeeze(-1)


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True, q_offset: int = 0):
    """dq, dk, dv of :func:`flash_attention_plain` from its output ``o``,
    the upstream gradient ``do`` and the row log-sum-exp ``lse``, all in
    f32: P = exp(s - lse), D = rowsum(do ⊙ o), dv = Pᵀ do,
    dS = P ⊙ (do vᵀ - D), dq = scale dS k, dk = scale dSᵀ q. The forward's
    cast of p to v's dtype passes its gradient straight through.

    It is the f32 oracle of both backward kernels: the f32 kernel computes
    the same in IEEE f32; the bf16 kernel rounds P and dS to bf16 before
    the products that give dv, dk and dq, and is held to this version
    within 2e-2 × max(1, max |oracle|) (``chip_smoke.py``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal, q_offset) - _acc(lse)[..., None])
    do32 = _acc(do)
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, _acc(v).transpose(-1, -2))
    d = (do32 * _acc(o)).sum(dim=-1, keepdim=True)
    ds = p * (dp - d)
    dq = torch.matmul(ds, _acc(k)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), _acc(q)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
