"""Public wrapper of the masked matmul kernel: ``out = x @ (w ⊙ m)``.

On a CPU tensor it runs the plain PyTorch version. On a CUDA tensor it
launches ``csrc/masked_matmul.cu`` on the current stream, or raises on an
operand the kernel does not take; it never falls back. ``launches``
counts kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masked_matmul.ref import masked_matmul_plain

launches = 0

_FN = {torch.float32: "masked_matmul_f32", torch.bfloat16: "masked_matmul_bf16"}
_INT_MAX = 2**31 - 1


def masked_matmul(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (M, K); w and m (K, N). The mask may be bool, uint8 or int8 on the
    card (any dtype on the CPU); the output takes x's dtype."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or m.shape != w.shape:
        raise ValueError(
            f"masked_matmul: inconsistent operand shapes x={tuple(x.shape)} "
            f"w={tuple(w.shape)} m={tuple(m.shape)} (want x=(M,K), w=m=(K,N))"
        )
    if not (x.device == w.device == m.device):
        raise ValueError(f"masked_matmul: operands on {x.device}, {w.device}, {m.device}")
    if x.device.type == "cpu":
        return masked_matmul_plain(x, w, m)
    if x.device.type != "cuda":
        raise ValueError(f"masked_matmul: no kernel for device {x.device}")
    return _launch(x, w, m)


def _launch(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    global launches
    if x.dtype not in _FN or w.dtype != x.dtype:
        raise TypeError(f"masked_matmul: kernel takes f32 or bf16 x == w, got "
                        f"{x.dtype} and {w.dtype}")
    if m.dtype == torch.bool or m.dtype == torch.int8:
        m = m.view(torch.uint8)
    if m.dtype != torch.uint8:
        raise TypeError(f"masked_matmul: kernel takes a bool/uint8/int8 mask, got {m.dtype}")
    for name, t in (("x", x), ("w", w), ("m", m)):
        if t.stride(1) != 1:
            raise ValueError(f"masked_matmul: {name} needs unit column stride, "
                             f"got strides {t.stride()}")
    M, K = x.shape
    N = w.shape[1]
    if x.dtype == torch.bfloat16 and not (
            K % 8 == 0 and N % 8 == 0
            and x.stride(0) % 8 == 0 and w.stride(0) % 8 == 0 and m.stride(0) % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 and m.data_ptr() % 8 == 0):
        raise ValueError("masked_matmul: the bf16 kernel takes K, N and row strides that "
                         "are multiples of 8, on 16-byte-aligned x and w and an "
                         "8-byte-aligned mask")
    if max(M, K, N) > _INT_MAX:
        raise ValueError(f"masked_matmul: dims {(M, K, N)} exceed int32")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _build.load("masked_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(lib, _FN[x.dtype])(
        x.data_ptr(), w.data_ptr(), m.data_ptr(), out.data_ptr(), M, K, N,
        x.stride(0), w.stride(0), m.stride(0), out.stride(0), stream,
    )
    _build.check(code, "masked_matmul")
    launches += 1
    return out
