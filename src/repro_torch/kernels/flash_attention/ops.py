"""Public wrapper of the flash attention kernel.

``flash_attention_bshd`` adapts the model-layer layout (B, S, H, hd), with
GQA heads already repeated, as ``models/layers.attend`` uses it for
``impl="flash"`` on the card. On a CPU tensor the wrapper runs the plain
PyTorch version; on a CUDA tensor it launches ``csrc/flash_attention.cu``
on the current stream or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

launches = 0

_FN = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's compiled head widths
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
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, causal, int(q_offset))


def _launch(q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
    global launches
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: kernel takes f32 or bf16 q == k == v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    BH, Sq, d = q.shape
    Sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if BH > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: BH={BH} exceeds the grid's {_MAX_GRID_Y}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: kernel takes contiguous (BH, S, d) operands")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel takes 16-byte-aligned operands")
    if q_offset + Sq + Sk > 2**31 - 1:
        raise ValueError("flash_attention: sequence positions exceed int32")
    out = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return out
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = getattr(lib, _FN[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq, Sk, d,
        int(causal), q_offset, 1.0 / math.sqrt(d), stream,
    )
    _build.check(code, "flash_attention")
    launches += 1
    return out


def flash_attention_bshd(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B, Sq, H, hd); k, v (B, Sk, H, hd), already GQA-repeated."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]

    def fold(x, S):
        return x.transpose(1, 2).reshape(B * H, S, hd).contiguous()

    o = flash_attention(fold(q, Sq), fold(k, Sk), fold(v, Sk),
                        causal=causal, q_offset=q_offset)
    return o.reshape(B, H, Sq, hd).transpose(1, 2)
