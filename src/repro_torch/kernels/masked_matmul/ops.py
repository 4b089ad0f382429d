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

All four also take E slabs, x (E, C, K) against w and m (E, K, N), as an
MoE layer's routed experts hold them, in one launch of the kernels'
batched entries (the grid running over the slabs; each slab's output is
the 2-D launch's on that slab); ``masked_matmul_batched`` and its dX, dW
and dM take slabs only. ``batched_launches``, ``batched_dx_launches``,
``batched_dw_launches`` and ``batched_dm_launches`` count those launches.
A tuned mask on expert slabs (mask tuning on MoE) gets its gradient from
the batched dM.

While an obs run is live, each launch (or plain-version call on the CPU)
goes through ``obs.profile.record_kernel`` as ``kernels/masked_matmul``,
``kernels/masked_matmul_dx``, ``_dw`` and ``_dm`` (the batched ones as
``kernels/masked_matmul_batched``, ``_batched_dx``, ``_batched_dw`` and
``_batched_dm``), in the reference's accounting: 2·M·K·N FLOPs (2·E·C·K·N batched;
dense-equivalent, whatever the mask keeps) and the bytes of the operands
and the output. With obs off that costs one
check.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import is_abstract, record_kernel
from repro_torch.kernels.masked_matmul.ref import (
    masked_matmul_batched_dm_plain, masked_matmul_batched_dw_plain,
    masked_matmul_batched_dx_plain, masked_matmul_batched_plain, masked_matmul_dm_plain,
    masked_matmul_dw_plain, masked_matmul_dx_plain, masked_matmul_plain,
)

launches = 0
dx_launches = 0
dw_launches = 0
dm_launches = 0
batched_launches = 0
batched_dx_launches = 0
batched_dw_launches = 0
batched_dm_launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_INT_MAX = 2**31 - 1


def masked_matmul(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (M, K); w and m (K, N) -> (M, N) in x's dtype. Or E slabs, as an
    MoE layer's routed experts hold them: x (E, C, K), w and m (E, K, N) ->
    (E, C, N), expert e's ``x[e] @ (w[e] ⊙ m[e])``, in one launch. The mask
    may be bool, uint8 or int8 on the card (any dtype on the CPU), or, under
    grad, a 0/1 float tensor that requires grad (a tuned mask: its gradient
    is dM)."""
    _dims("masked_matmul", x, w, m)
    _on_cpu("masked_matmul", x, w, m)  # checks the devices
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or m.requires_grad):
        return MaskedMatmulFn.apply(x, w, m)
    return _call("masked_matmul", x, w, m)


def masked_matmul_dx(dy: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """dy (M, N); w and m (K, N) -> dx (M, K) in dy's dtype; or E slabs of
    each."""
    return _call("masked_matmul_dx", dy, w, m)


def masked_matmul_dw(x: torch.Tensor, dy: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (M, K); dy (M, N); m (K, N) -> dw (K, N) in x's dtype, exactly 0
    wherever m is 0; or E slabs of each."""
    return _call("masked_matmul_dw", x, dy, m)


def masked_matmul_dm(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K); dy (M, N); w (K, N) -> dm (K, N) in x's dtype, the gradient
    of ``x @ (w ⊙ m)`` with respect to m (pruned slots are not zeroed); or
    E slabs of each."""
    return _call("masked_matmul_dm", x, dy, w)


def masked_matmul_batched(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """:func:`masked_matmul` on E slabs only: x (E, C, K), w and m (E, K, N)."""
    _slabs("masked_matmul_batched", x)
    return masked_matmul(x, w, m)


def masked_matmul_batched_dx(dy: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """:func:`masked_matmul_dx` on E slabs only."""
    _slabs("masked_matmul_batched_dx", dy)
    return masked_matmul_dx(dy, w, m)


def masked_matmul_batched_dw(x: torch.Tensor, dy: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """:func:`masked_matmul_dw` on E slabs only."""
    _slabs("masked_matmul_batched_dw", x)
    return masked_matmul_dw(x, dy, m)


def masked_matmul_batched_dm(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`masked_matmul_dm` on E slabs only."""
    _slabs("masked_matmul_batched_dm", x)
    return masked_matmul_dm(x, dy, w)


class MaskedMatmulFn(torch.autograd.Function):
    """``x @ (w ⊙ m)`` with the dX, dW and dM kernels as its backward (the
    batched ones on E slabs); pruned slots of dw are exactly 0. A float
    mask (0/1, in w's dtype) that requires grad gets dm. The kernels read
    such a mask as ``m != 0``, laid out as :func:`aligned_mask` lays it
    (Mamba2-130M's tuned ``in_dt`` mask, (768, 24), reaches the bf16 kernel
    so); the plain versions on the CPU multiply by its values, so there the
    product is differentiable in m as written."""

    @staticmethod
    def forward(ctx, x, w, m):
        if m.is_floating_point() and m.device.type == "cuda":
            m = aligned_mask(m != 0)
        ctx.save_for_backward(x, w, m)
        return _call("masked_matmul", x, w, m)

    @staticmethod
    def backward(ctx, dy):
        x, w, m = ctx.saved_tensors
        if not dy.is_contiguous():
            dy = dy.contiguous()
        dx = masked_matmul_dx(dy, w, m) if ctx.needs_input_grad[0] else None
        dw = masked_matmul_dw(x, dy, m) if ctx.needs_input_grad[1] else None
        dm = masked_matmul_dm(x, dy, w) if ctx.needs_input_grad[2] else None
        return dx, dw, dm


# each kernel's launch counter, by the name it is launched and booked under
# (``fn`` on matrices, its batched entry on E slabs)
_COUNTER = {"masked_matmul": "launches", "masked_matmul_dx": "dx_launches",
            "masked_matmul_dw": "dw_launches", "masked_matmul_dm": "dm_launches",
            "masked_matmul_batched": "batched_launches",
            "masked_matmul_batched_dx": "batched_dx_launches",
            "masked_matmul_batched_dw": "batched_dw_launches",
            "masked_matmul_batched_dm": "batched_dm_launches"}
# each entry point's operands, as (name, its dims of (M, K, N)), and its output's dims
_OPERANDS = {"masked_matmul": (("x", "MK"), ("w", "KN"), ("m", "KN"), "MN"),
             "masked_matmul_dx": (("dy", "MN"), ("w", "KN"), ("m", "KN"), "MK"),
             "masked_matmul_dw": (("x", "MK"), ("dy", "MN"), ("m", "KN"), "KN"),
             "masked_matmul_dm": (("x", "MK"), ("dy", "MN"), ("w", "KN"), "KN")}


def _slabs(what: str, a: torch.Tensor) -> None:
    if a.dim() != 3:
        raise ValueError(f"{what}: takes E slabs, operands of rank 3, got {tuple(a.shape)}")


def _entry(fn: str, a: torch.Tensor) -> str:
    """The kernel ``fn`` runs as: itself on matrices, its batched entry on
    E slabs."""
    return fn if a.dim() == 2 else fn.replace("masked_matmul", "masked_matmul_batched")


def _mkn(fn: str, a: torch.Tensor, b: torch.Tensor):
    """(M, K, N) of ``fn``'s operands a, b (matrices or E slabs of them)."""
    if fn == "masked_matmul_dx":
        return a.shape[-2], b.shape[-2], a.shape[-1]
    return a.shape[-2], a.shape[-1], b.shape[-1]


def _shape(dims: str, lead, M: int, K: int, N: int):
    return (*lead, *(dict(M=M, K=K, N=N)[d] for d in dims))


def _dims(fn: str, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """(M, K, N) of ``fn``'s operands; raises on shapes that do not fit:
    three matrices, or three stacks of E slabs."""
    *ops, _ = _OPERANDS[fn]
    ok = a.dim() in (2, 3) and b.dim() == c.dim() == a.dim()
    if ok:
        M, K, N = _mkn(fn, a, b)
        ok = all(tuple(t.shape) == _shape(d, a.shape[:-2], M, K, N)
                 for (_, d), t in zip(ops, (a, b, c)))
    if not ok:
        raise ValueError(
            f"{fn}: inconsistent operand shapes "
            + " ".join(f"{n}={tuple(t.shape)}" for (n, _), t in zip(ops, (a, b, c)))
            + " (want " + ", ".join(f"{n}=(E,{d[0]},{d[1]})" for n, d in ops) + ")")
    return M, K, N


def _call(fn: str, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fn`` on its operands: the plain version on the CPU, the kernel on
    the card; booked under a live obs run."""
    M, K, N = _dims(fn, a, b, c)
    name = _entry(fn, a)
    # ``<name>_plain`` or ``_launch<suffix>``, looked up at call time (a
    # test may wrap either)
    run = globals()[f"{name}_plain" if _on_cpu(name, a, b, c)
                    else "_launch" + fn.removeprefix("masked_matmul")]
    E = a.shape[0] if a.dim() == 3 else 1
    return _recorded("kernels/" + name, run, a, b, c, M, K, N,
                     _shape(_OPERANDS[fn][3], a.shape[:-2], M, K, N), E)


def _on_cpu(what: str, *ts: torch.Tensor) -> bool:
    """True for CPU operands (the plain version), False for CUDA ones (the
    kernel); raises for mixed devices or a device with no kernel."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what}: operands on {', '.join(str(t.device) for t in ts)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    return dev.type == "cpu"


def _recorded(name: str, fn, a, b, c, M: int, K: int, N: int, out_shape, E: int = 1):
    """``fn(a, b, c)``; under a live obs run booked with ``record_kernel``
    (2·E·M·K·N FLOPs over E slabs; the three operands read once, the
    output, in a's dtype, written once). A product with an empty dimension
    launches nothing and is not booked."""
    if not OT.enabled() or min(E, M, K, N) == 0 or is_abstract(a, b, c):
        return fn(a, b, c)
    nbytes = sum(t.numel() * t.element_size() for t in (a, b, c)) + \
        math.prod(out_shape) * a.element_size()
    return record_kernel(name, 2.0 * E * M * K * N, nbytes, fn, a, b, c, device=a.device)


def _launch(x: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return _kernel("masked_matmul", x, w, m)


def _launch_dx(dy: torch.Tensor, w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return _kernel("masked_matmul_dx", dy, w, m)


def _launch_dw(x: torch.Tensor, dy: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return _kernel("masked_matmul_dw", x, dy, m)


def _launch_dm(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _kernel("masked_matmul_dm", x, dy, w)


def aligned_mask(m: torch.Tensor) -> torch.Tensor:
    """``m`` (..., K, N), one byte a slot, with rows a multiple of 16 bytes
    apart, as the bf16 kernel reads a mask (by TMA): ``m`` itself when N is
    a multiple of 16, else a view of the first N columns of a copy padded
    to the next multiple of 16 (Mamba2-130M's ``in_dt`` mask, (768, 24),
    is kept in a (768, 32) buffer: 8 bytes a row more)."""
    N = m.shape[-1]
    if m.element_size() != 1 or N % 16 == 0:
        return m
    buf = torch.zeros((*m.shape[:-1], -(-N // 16) * 16), dtype=m.dtype, device=m.device)
    buf[..., :N] = m
    return buf[..., :N]


def check_operands(fn: str, a: torch.Tensor, b: torch.Tensor, m: torch.Tensor):
    """The checks every entry point of the library needs, on operands of
    any device: raises TypeError or ValueError on operands the kernel does
    not take. Returns the third operand as the kernel reads it (a mask as
    uint8)."""
    name = _entry(fn, a)
    if a.dtype not in _SUFFIX or b.dtype != a.dtype:
        raise TypeError(f"{name}: kernel takes f32 or bf16 operands of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    scale = fn == "masked_matmul_dm"
    if scale:
        if m.dtype != a.dtype:
            raise TypeError(f"{name}: kernel takes w in the operands' dtype {a.dtype}, "
                            f"got {m.dtype}")
    else:
        if m.dtype == torch.bool or m.dtype == torch.int8:
            m = m.view(torch.uint8)
        if m.dtype != torch.uint8:
            raise TypeError(f"{name}: kernel takes a bool/uint8/int8 mask, got {m.dtype}")
    third = "weight" if scale else "mask"
    batched = a.dim() == 3
    E = a.shape[0] if batched else 1
    M, K, N = _mkn(fn, a, b)
    for what, t in (("first operand", a), ("second operand", b), (third, m)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} needs unit column stride, got strides {t.stride()}")
    # the bf16 kernel reads every operand by TMA: 16-byte-aligned bases and
    # row (and slab) strides of 16 bytes (8 values, 16 mask bytes); dM's w,
    # read in the epilogue, keeps the same rule
    strides = [t.stride(-2) for t in (a, b, m)] + ([t.stride(0) for t in (a, b, m)]
                                                   if batched else [])
    if a.dtype == torch.bfloat16 and not (
            K % 8 == 0 and N % 8 == 0
            and all(st % 8 == 0 for st in strides)
            and all(st % (8 if scale else 16) == 0 for st in strides[2::3])
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0 and m.data_ptr() % 16 == 0):
        raise ValueError(f"{name}: the bf16 kernel takes K, N and row strides that are "
                         "multiples of 8, a mask row stride that is a multiple of 16, on "
                         f"16-byte-aligned matrices and {third}")
    if max(E, M, K, N) > _INT_MAX:
        raise ValueError(f"{name}: dims {(E, M, K, N)} exceed int32")
    return m


def _kernel(fn: str, a: torch.Tensor, b: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Launch ``<fn>_<dtype>`` (``fn``'s batched entry on E slabs, each
    passed with its row and slab strides) on ``a``, ``b`` of one dtype and
    a (K, N) mask (for dM the weight w, in their dtype) after
    ``check_operands``, and count the launch. A product with an empty
    dimension launches nothing: zeros (an empty reduction) or an empty
    tensor."""
    m = check_operands(fn, a, b, m)
    name = _entry(fn, a)
    batched = a.dim() == 3
    E = a.shape[0] if batched else 1
    M, K, N = _mkn(fn, a, b)
    out_shape = _shape(_OPERANDS[fn][3], a.shape[:-2], M, K, N)
    if min(E, M, K, N) == 0:
        return torch.zeros(out_shape, dtype=a.dtype, device=a.device)
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    lib = _build.load("masked_matmul")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rows = [t.stride(-2) for t in (a, b, m, out)]
    slabs = [t.stride(0) for t in (a, b, m, out)] if batched else []
    code = getattr(lib, f"{name}_{_SUFFIX[a.dtype]}")(
        a.data_ptr(), b.data_ptr(), m.data_ptr(), out.data_ptr(), *([E] if batched else []),
        M, K, N, *rows, *slabs, stream,
    )
    _build.check(code, name)
    globals()[_COUNTER[name]] += 1
    return out
