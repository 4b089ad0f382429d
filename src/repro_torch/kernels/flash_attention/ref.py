"""Plain PyTorch version of the flash attention kernel."""
from __future__ import annotations

import math

import torch

_NEG = -1e30


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """The kernel's online softmax taken as one tile. q (BH, Sq, d); k, v
    (BH, Sk, d). Scores in f32 from upcast q and k, masked with -1e30; p is
    rounded to v's dtype before PV while the normaliser sums the f32 p,
    clamped at 1e-30."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qp = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qp >= kp, s, torch.full_like(s, _NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l.clamp_min(1e-30)
    return o.to(q.dtype)
