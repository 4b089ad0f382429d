"""Public wrappers of the masked matmul kernels: ``out = x @ (w ⊙ m)`` and
its gradients ``dx = dy @ (w ⊙ m)ᵀ``, ``dw = (xᵀ @ dy) ⊙ m`` and, for a
mask that is tuned, ``dm = (xᵀ @ dy) ⊙ w``.

On a CPU tensor each runs its plain PyTorch version. On a CUDA tensor it
launches ``csrc/masked_matmul.cu`` on the current stream, or raises on an
operand the kernel does not take; it never falls back. When grad is
enabled and x, w or m requires it, :func:`masked_matmul` goes through
:class:`MaskedMatmulFn`, whose backward is the dX, dW and dM kernels
(their plain versions on the CPU), so a kernel's output always carries
its autograd edge. ``launches``, ``dx_launches``, ``dw_launches`` and
``dm_launches`` count kernel launches, so a run can show that its path
went through each.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.masked_matmul.ref import (
    masked_matmul_dm_plain, masked_matmul_dw_plain, masked_matmul_dx_plain, masked_matmul_plain,
)

launches = 0
dx_launches = 0
dw_launches = 0
dm_launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT_MAX = 2**31 - 1


def masked_matmul(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (M, K); w and m (K, N). The mask may be bool, uint8 or int8 on the
    card (any dtype on the CPU), or, under grad, a 0/1 float tensor that
    requires grad (a tuned mask: its gradient is dM); the output takes x's
    dtype."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or m.shape != w.shape:
        raise ValueError(
            f"masked_matmul: inconsistent operand shapes x={tuple(x.shape)} "
            f"w={tuple(w.shape)} m={tuple(m.shape)} (want x=(M,K), w=m=(K,N))"
        )
    _on_cpu("masked_matmul", x, w, m)  # checks the devices
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or m.requires_grad):
        return MaskedMatmulFn.apply(x, w, m)
    return _forward(x, w, m)


def masked_matmul_dx(dy: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """dy (M, N); w and m (K, N) -> dx (M, K) in dy's dtype."""
    if dy.dim() != 2 or w.dim() != 2 or dy.shape[1] != w.shape[1] or m.shape != w.shape:
        raise ValueError(f"masked_matmul_dx: inconsistent operand shapes dy={tuple(dy.shape)} "
                         f"w={tuple(w.shape)} m={tuple(m.shape)}")
    if _on_cpu("masked_matmul_dx", dy, w, m):
        return masked_matmul_dx_plain(dy, w, m)
    return _launch_dx(dy, w, m)


def masked_matmul_dw(x: torch.Tensor, dy: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (M, K); dy (M, N); m (K, N) -> dw (K, N) in x's dtype, exactly 0
    wherever m is 0."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0] or \
            m.shape != (x.shape[1], dy.shape[1]):
        raise ValueError(f"masked_matmul_dw: inconsistent operand shapes x={tuple(x.shape)} "
                         f"dy={tuple(dy.shape)} m={tuple(m.shape)}")
    if _on_cpu("masked_matmul_dw", x, dy, m):
        return masked_matmul_dw_plain(x, dy, m)
    return _launch_dw(x, dy, m)


def masked_matmul_dm(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K); dy (M, N); w (K, N) -> dm (K, N) in x's dtype, the gradient
    of ``x @ (w ⊙ m)`` with respect to m (pruned slots are not zeroed)."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0] or \
            w.shape != (x.shape[1], dy.shape[1]):
        raise ValueError(f"masked_matmul_dm: inconsistent operand shapes x={tuple(x.shape)} "
                         f"dy={tuple(dy.shape)} w={tuple(w.shape)}")
    if _on_cpu("masked_matmul_dm", x, dy, w):
        return masked_matmul_dm_plain(x, dy, w)
    return _launch_dm(x, dy, w)


class MaskedMatmulFn(torch.autograd.Function):
    """``x @ (w ⊙ m)`` with the dX, dW and dM kernels as its backward;
    pruned slots of dw are exactly 0. A float mask (0/1, in w's dtype) that
    requires grad gets dm. The kernels read such a mask as ``m != 0``; the
    plain versions on the CPU multiply by its values, so there the product
    is differentiable in m as written."""

    @staticmethod
    def forward(ctx, x, w, m):
        if m.is_floating_point() and m.device.type == "cuda":
            m = m != 0
        ctx.save_for_backward(x, w, m)
        return _forward(x, w, m)

    @staticmethod
    def backward(ctx, dy):
        x, w, m = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        dx = masked_matmul_dx(dy, w, m) if ctx.needs_input_grad[0] else None
        dw = masked_matmul_dw(x, dy, m) if ctx.needs_input_grad[1] else None
        dm = masked_matmul_dm(x, dy, w) if ctx.needs_input_grad[2] else None
        return dx, dw, dm


def _on_cpu(what: str, *ts: torch.Tensor) -> bool:
    """True for CPU operands (the plain version), False for CUDA ones (the
    kernel); raises for mixed devices or a device with no kernel."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what}: operands on {', '.join(str(t.device) for t in ts)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    return dev.type == "cpu"


def _forward(x, w, m):
    return masked_matmul_plain(x, w, m) if x.device.type == "cpu" else _launch(x, w, m)


def _launch(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    global launches
    M, K = x.shape
    N = w.shape[1]
    out = _run("masked_matmul", x, w, m, (M, N), M, K, N)
    launches += out is not None
    return _or_empty(out, (M, N), x)


def _launch_dx(dy: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    global dx_launches
    M, N = dy.shape
    K = w.shape[0]
    out = _run("masked_matmul_dx", dy, w, m, (M, K), M, K, N)
    dx_launches += out is not None
    return _or_empty(out, (M, K), dy)


def _launch_dw(x: torch.Tensor, dy: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    global dw_launches
    M, K = x.shape
    N = dy.shape[1]
    out = _run("masked_matmul_dw", x, dy, m, (K, N), M, K, N)
    dw_launches += out is not None
    return _or_empty(out, (K, N), x)


def _launch_dm(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global dm_launches
    M, K = x.shape
    N = dy.shape[1]
    out = _run("masked_matmul_dm", x, dy, w, (K, N), M, K, N)
    dm_launches += out is not None
    return _or_empty(out, (K, N), x)


def _or_empty(out, shape, like: torch.Tensor) -> torch.Tensor:
    """A product with an empty dimension launches nothing: zeros (an empty
    reduction) or an empty tensor."""
    return out if out is not None else torch.zeros(shape, dtype=like.dtype, device=like.device)


def _run(fn: str, a: torch.Tensor, b: torch.Tensor, m: torch.Tensor, out_shape,
         M: int, K: int, N: int):
    """Launch ``<fn>_<dtype>`` on two matrices ``a``, ``b`` of one dtype and
    a (K, N) mask (for dM the weight w, in their dtype) after the checks
    every entry point of the library needs; None when a dimension is empty
    and nothing was launched."""
    if a.dtype not in _SUFFIX or b.dtype != a.dtype:
        raise TypeError(f"{fn}: kernel takes f32 or bf16 operands of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    scale = fn == "masked_matmul_dm"
    if scale:
        if m.dtype != a.dtype:
            raise TypeError(f"{fn}: kernel takes w in the operands' dtype {a.dtype}, "
                            f"got {m.dtype}")
    else:
        if m.dtype == torch.bool or m.dtype == torch.int8:
            m = m.view(torch.uint8)
        if m.dtype != torch.uint8:
            raise TypeError(f"{fn}: kernel takes a bool/uint8/int8 mask, got {m.dtype}")
    third = "weight" if scale else "mask"
    for name, t in (("first operand", a), ("second operand", b), (third, m)):
        if t.stride(1) != 1:
            raise ValueError(f"{fn}: {name} needs unit column stride, got strides {t.stride()}")
    # the bf16 kernel reads every operand by TMA: 16-byte-aligned bases and
    # row strides of 16 bytes (8 values, 16 mask bytes); dM's w, read in
    # the epilogue, keeps the same rule
    if a.dtype == torch.bfloat16 and not (
            K % 8 == 0 and N % 8 == 0
            and a.stride(0) % 8 == 0 and b.stride(0) % 8 == 0
            and m.stride(0) % (8 if scale else 16) == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 and m.data_ptr() % 16 == 0):
        raise ValueError(f"{fn}: the bf16 kernel takes K, N and row strides that are "
                         "multiples of 8, a mask row stride that is a multiple of 16, on "
                         f"16-byte-aligned matrices and {third}")
    if max(M, K, N) > _INT_MAX:
        raise ValueError(f"{fn}: dims {(M, K, N)} exceed int32")
    if min(M, K, N) == 0:
        return None
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    lib = _build.load("masked_matmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = getattr(lib, f"{fn}_{_SUFFIX[a.dtype]}")(
        a.data_ptr(), b.data_ptr(), m.data_ptr(), out.data_ptr(), M, K, N,
        a.stride(0), b.stride(0), m.stride(0), out.stride(0), stream,
    )
    _build.check(code, fn)
    return out
