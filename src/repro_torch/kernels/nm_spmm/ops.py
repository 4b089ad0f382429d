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
idx and the output. Every launch goes through its plan
(``kernels.validation.plan_nm_spmm``), on explicit tiles or on those
``kernels.tuning`` resolves (the GEMM's compiled set; 256 x 128 by
default); nothing is resolved or counted on a CPU tensor.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, tuning
from repro_torch.kernels import validation as V
from repro_torch.kernels.nm_spmm.ref import nm_spmm_plain
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import is_abstract, record_kernel

launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_DTYPE = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def nm_spmm(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor, *, n: int,
            m: int, **tiles) -> torch.Tensor:
    """x (M, K); vals and idx (K//m*n, N) -> (M, N) in x's dtype. ``tiles``
    (bm, bn, bk) fix the launch plan on the card; without them it resolves
    through ``kernels.tuning``."""
    if x.dim() != 2 or vals.dim() != 2 or idx.shape != vals.shape or \
            vals.shape[0] * m != x.shape[1] * n:
        raise ValueError(
            f"nm_spmm: inconsistent operand shapes x={tuple(x.shape)} "
            f"vals={tuple(vals.shape)} idx={tuple(idx.shape)} under {n}:{m} "
            f"(want vals=idx=(K//m*n, N))")
    if not (x.device == vals.device == idx.device):
        raise ValueError(f"nm_spmm: operands on {x.device}, {vals.device}, {idx.device}")
    (M, K), N = x.shape, vals.shape[1]
    plan = None
    if x.device.type == "cpu":
        if tiles:
            _plan(x, vals, idx, n, m, tiles)
        fn = nm_spmm_plain
    elif x.device.type == "cuda":
        tiles, source = _resolve(x, M, K, N, n, m, tiles)
        fn = functools.partial(_launch, **tiles) if tiles else _launch
        if source in ("cache", "search"):
            plan = dict(plan=source, **tiles)
    else:
        raise ValueError(f"nm_spmm: no kernel for device {x.device}")
    if not OT.enabled() or min(M, K, N) == 0 or is_abstract(x, vals, idx):
        return fn(x, vals, idx, n=n, m=m)
    nbytes = sum(t.numel() * t.element_size() for t in (x, vals, idx)) + M * N * x.element_size()
    return record_kernel("kernels/nm_spmm", 2.0 * M * K * N, nbytes, fn, x, vals, idx,
                         n=n, m=m, device=x.device, plan=plan)


def call(*operands, **params) -> torch.Tensor:
    """The uniform entry point (``kernels.dispatch``): operands ``(x, vals,
    idx)``, params ``n``, ``m`` and the tile overrides."""
    return nm_spmm(*operands, **params)


def _resolve(x, M: int, K: int, N: int, n: int, m: int, tiles):
    """(tiles, source): explicit tiles win; else ``tuning.resolve``."""
    if tiles or x.dtype not in _DTYPE or tuning.mode() == "off":
        return dict(tiles or {}), None
    dt = _DTYPE[x.dtype]
    return tuning.resolve("nm_spmm", {"M": M, "K": K, "N": N}, {"x": dt, "v": dt},
                          {"n": n, "m": m}, device=x.device)


def _plan(x, vals, idx, n: int, m: int, tiles):
    if x.dtype not in _SUFFIX or vals.dtype != x.dtype:
        raise TypeError(f"nm_spmm: kernel takes f32 or bf16 x == vals, got {x.dtype} "
                        f"and {vals.dtype}")
    if idx.dtype != torch.int8:
        raise TypeError(f"nm_spmm: kernel takes int8 offsets, got {idx.dtype}")
    (M, K), N = x.shape, vals.shape[1]
    return V.plan_nm_spmm(M, K, N, n=n, m=m, dtype=_DTYPE[x.dtype], **tiles,
                          operands=[(t.stride(), t.data_ptr()) for t in (x, vals, idx)])


def launch_uncounted(x, vals, idx, n: int, m: int, tiles) -> torch.Tensor:
    """The kernel on the plan of ``tiles``, not counted: the tuner's
    measurements (``kernels.tuning.search``)."""
    return _launch(x, vals, idx, n, m, count=False, **tiles)


def _launch(x, vals, idx, n: int, m: int, *, count: bool = True, **tiles) -> torch.Tensor:
    """The kernel on the plan of ``tiles`` (the default's when none are
    given; :func:`nm_spmm` resolves them first), counted."""
    global launches
    plan = _plan(x, vals, idx, n, m, tiles)
    M, K = x.shape
    N = vals.shape[1]
    if min(M, K, N) == 0:
        return torch.zeros((M, N), dtype=x.dtype, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.load("nm_spmm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tile = [plan.tiles["bm"], plan.tiles["bn"]] if x.dtype == torch.bfloat16 else []
    code = getattr(lib, f"nm_spmm_{_SUFFIX[x.dtype]}")(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(), M, K, N, n, m,
        x.stride(0), vals.stride(0), idx.stride(0), out.stride(0), *tile, stream,
    )
    _build.check(code, "nm_spmm")
    if count:
        launches += 1
    return out
