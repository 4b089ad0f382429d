"""Public wrapper of the N:M sparse matmul kernel:
``out = x @ decompress(vals, idx)``, with vals and idx in the layout of
``sparsity.sparse_params.nm_compress``.

On a CPU tensor it runs the plain PyTorch version. On a CUDA tensor it
launches ``csrc/nm_spmm.cu`` on the current stream, or raises on an
operand the kernel does not take; it never falls back. Forward only, as
the reference. ``launches`` counts kernel launches. While an obs run is
live, each launch (the plain version's call on the CPU) is booked as
``kernels/nm_spmm`` by ``obs.profile.record_kernel`` in the reference's
accounting: 2·M·K·N dense-equivalent FLOPs, and the bytes of x, vals,
idx and the output.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nm_spmm.ref import nm_spmm_plain
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import is_abstract, record_kernel

launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT_MAX = 2**31 - 1


def nm_spmm(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor, *, n: int,
            m: int) -> torch.Tensor:
    """x (M, K); vals and idx (K//m*n, N) -> (M, N) in x's dtype."""
    if x.dim() != 2 or vals.dim() != 2 or idx.shape != vals.shape or \
            vals.shape[0] * m != x.shape[1] * n:
        raise ValueError(
            f"nm_spmm: inconsistent operand shapes x={tuple(x.shape)} "
            f"vals={tuple(vals.shape)} idx={tuple(idx.shape)} under {n}:{m} "
            f"(want vals=idx=(K//m*n, N))")
    if not (x.device == vals.device == idx.device):
        raise ValueError(f"nm_spmm: operands on {x.device}, {vals.device}, {idx.device}")
    if x.device.type == "cpu":
        fn = nm_spmm_plain
    elif x.device.type == "cuda":
        fn = _launch
    else:
        raise ValueError(f"nm_spmm: no kernel for device {x.device}")
    (M, K), N = x.shape, vals.shape[1]
    if not OT.enabled() or min(M, K, N) == 0 or is_abstract(x, vals, idx):
        return fn(x, vals, idx, n=n, m=m)
    nbytes = sum(t.numel() * t.element_size() for t in (x, vals, idx)) + M * N * x.element_size()
    return record_kernel("kernels/nm_spmm", 2.0 * M * K * N, nbytes, fn, x, vals, idx,
                         n=n, m=m, device=x.device)


def _launch(x, vals, idx, n: int, m: int) -> torch.Tensor:
    global launches
    if x.dtype not in _SUFFIX or vals.dtype != x.dtype:
        raise TypeError(f"nm_spmm: kernel takes f32 or bf16 x == vals, got {x.dtype} "
                        f"and {vals.dtype}")
    if idx.dtype != torch.int8:
        raise TypeError(f"nm_spmm: kernel takes int8 offsets, got {idx.dtype}")
    if m not in (1, 2, 4, 8) or not 1 <= n <= m:
        raise ValueError(f"nm_spmm: kernel takes m in (1, 2, 4, 8) and 1 <= n <= m, "
                         f"got {n}:{m}")
    for name, t in (("x", x), ("vals", vals), ("idx", idx)):
        if t.stride(1) != 1:
            raise ValueError(f"nm_spmm: {name} needs unit column stride, got {t.stride()}")
    M, K = x.shape
    N = vals.shape[1]
    if K % m:
        raise ValueError(f"nm_spmm: K={K} is not a multiple of m={m}")
    if x.dtype == torch.bfloat16 and not (
            K % 8 == 0 and N % 8 == 0 and x.stride(0) % 8 == 0 and vals.stride(0) % 8 == 0
            and idx.stride(0) % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, vals, idx))):
        # every operand goes by TMA: 16-byte-aligned bases, row strides of 16 bytes
        raise ValueError("nm_spmm: the bf16 kernel takes K, N and the row strides of x and vals "
                         "multiples of 8, idx's row stride a multiple of 16, and 16-byte-aligned "
                         "operands")
    if max(M, K, N) > _INT_MAX:
        raise ValueError(f"nm_spmm: dims {(M, K, N)} exceed int32")
    if min(M, K, N) == 0:
        return torch.zeros((M, N), dtype=x.dtype, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.load("nm_spmm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = getattr(lib, f"nm_spmm_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(), M, K, N, n, m,
        x.stride(0), vals.stride(0), idx.stride(0), out.stride(0), stream,
    )
    _build.check(code, "nm_spmm")
    launches += 1
    return out
