#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/kernels/``, holds each against its plain PyTorch version at
the Llama-7B shapes of the slice (the masked matmul and its dX, dW and dM,
the flash attention forward and backward, the N:M sparse matmul), drives
the pipeline (``repro_torch.launch.ebft_run.run``) on Llama-7B at full
width with 4 of its 32 layers in bf16: Wanda 0.7 -> EBFT (the main path);
2:4, whose tuned weights are re-packed and run through ``nm_spmm``;
SparseGPT 0.7 -> EBFT with the DSnoT and mask-tuning baselines (path A);
FLAP at 26% structured sparsity -> EBFT with 200 LoRA steps (path B). It
cross-checks tiny_dense (the Wanda, SparseGPT, DSnoT and FLAP prunes,
EBFT, mask tuning, LoRA) on the card against the CPU. Every phase prints one JSON line; any
failed check raises, so the script exits non-zero. The last three lines
are the card's name and power limit, the per-kernel summary, and
``{"ok": true, "device": ...}``. Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet peaks (dense): bytes/s of HBM3, FLOP/s per dtype
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
M_ROWS = 8 * 2048  # B * S of the slice's microbatch
# the main path's pretraining: the reference driver's default step count,
# on batches of M_ROWS tokens
PRETRAIN_STEPS = 200
PRETRAIN_BATCH = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def check_close(name, out, ref, dtype: str) -> float:
    import torch

    tol = TOL[dtype]
    err = float((out.float() - ref.float()).abs().max())
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, tol {tol})")
    return err


def _refuses(name, fn) -> None:
    """The wrapper must raise on operands its kernel does not take."""
    try:
        fn()
    except ValueError:
        return
    raise AssertionError(f"{name}: the wrapper launched on operands it must refuse")


def check_repeat(name, fn, first) -> bool:
    """A second launch on the same inputs must give the same bits (every
    sum is taken in a fixed order, no atomics)."""
    import torch

    again = fn()
    torch.cuda.synchronize()
    firsts = first if isinstance(first, (tuple, list)) else (first,)
    agains = again if isinstance(again, (tuple, list)) else (again,)
    if not all(torch.equal(a, b) for a, b in zip(firsts, agains)):
        raise AssertionError(f"{name}: a repeated launch gave other bits")
    return True


def check_scaled(name, out, ref, dtype: str) -> float:
    """Max abs error within tol x max(1, max |ref|): for sums of thousands
    of products (gradients), whose large entries carry the rounding of
    their magnitude."""
    tol = TOL[dtype]
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, tol {tol} x {scale})")
    return err


def check_bounded(name, out, ref, bound, tol: float):
    """Element by element: |out - ref| <= tol x bound, with ``bound`` the
    sum of the magnitudes of the products the element sums (|x| @ |w|), so
    every output carries the rounding of its own terms. Returns the max abs
    error and the largest ratio |out - ref| / bound."""
    import torch

    diff = (out.float() - ref.float()).abs()
    bad = diff > tol * bound
    if bool(bad.any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version at "
                             f"{int(bad.sum())} elements (max abs err {float(diff.max())}, "
                             f"limit {tol} x |x| @ |w| per element)")
    ratio = torch.where(bound > 0, diff / bound.clamp_min(1e-30), torch.zeros_like(diff))
    return float(diff.max()), float(ratio.max())


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# (name, leaf shape, reduction axes): the leaf is viewed as (R, O)
LEAVES = [("wq", (4096, 32, 128), 1), ("wo", (32, 128, 4096), 2),
          ("w_up", (4096, 11008), 1), ("w_down", (11008, 4096), 1)]


def phase_masked_matmul(g):
    """Kernel vs plain at the four Llama-7B linear shapes, f32 and bf16,
    plus an all-zero mask, a ragged shape and a strided x."""
    import torch

    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_plain

    summary = None
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, shape, n_red in LEAVES:
            R = math.prod(shape[:n_red])
            w = (torch.randn(shape, device="cuda", generator=g) / math.sqrt(R)).to(dt)
            m = torch.rand(shape, device="cuda", generator=g) < 0.3  # Wanda at 0.7 keeps 30%
            x = torch.randn(M_ROWS, R, device="cuda", generator=g).to(dt)
            w2, m2 = w.reshape(R, -1), m.reshape(R, -1)
            out = masked_matmul(x, w2, m2)
            ref = masked_matmul_plain(x, w2, m2)
            torch.cuda.synchronize()
            err = check_close(f"masked_matmul {name} {dtype}", out, ref, dtype)
            ms = timed_ms(lambda: masked_matmul(x, w2, m2))
            plain_ms = timed_ms(lambda: masked_matmul_plain(x, w2, m2))
            wm = w2 * m2.to(dt)
            library_ms = timed_ms(lambda: torch.matmul(x, wm))
            K, N = w2.shape
            nbytes = (x.numel() + w2.numel() + M_ROWS * N) * x.element_size() + m2.numel()
            flops = 2.0 * M_ROWS * float(m2.sum())  # the products the mask keeps
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            row = dict(phase="masked_matmul", leaf=name, dtype=dtype, M=M_ROWS, K=K, N=N,
                       max_abs_err=err, tol=TOL[dtype], ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
            if dtype == "bfloat16" and name == "w_up":
                row["deterministic"] = check_repeat(
                    f"masked_matmul {name} {dtype}", lambda: masked_matmul(x, w2, m2), out)
                summary = row  # the slice's heaviest launch
            emit(row)
            del w, m, x, out, ref, wm
    # an all-zero mask gives exactly zero
    x = torch.randn(256, 4096, device="cuda", generator=g)
    w = torch.randn(4096, 11008, device="cuda", generator=g)
    zero = masked_matmul(x, w, torch.zeros_like(w, dtype=torch.bool))
    torch.cuda.synchronize()
    if float(zero.abs().max()) != 0.0:
        raise AssertionError("masked_matmul: all-zero mask gave a non-zero output")
    # ragged edges on every axis, x a strided column slice: any shape in
    # f32; in bf16 dims and offsets that keep 16-byte alignment, and the
    # wrapper refuses others
    for dtype, case, K, N, off in (("float32", "ragged+strided", 1001, 333, 101),
                                    ("float32", "ragged+aligned", 1000, 336, 104),
                                    ("bfloat16", "ragged+aligned", 1000, 336, 104)):
        dt = getattr(torch, dtype)
        big = torch.randn(777, 1200, device="cuda", generator=g).to(dt)
        x = big[:, off:off + K]  # row stride 1200
        w = (torch.randn(K, N, device="cuda", generator=g) / 32).to(dt)
        m = torch.rand(K, N, device="cuda", generator=g) < 0.5
        err = check_close(f"masked_matmul {case} {dtype}", masked_matmul(x, w, m),
                          masked_matmul_plain(x, w, m), dtype)
        emit(dict(phase="masked_matmul", case=case, dtype=dtype, M=777, K=K, N=N,
                  max_abs_err=err, tol=TOL[dtype]))
    x = torch.randn(777, 1200, device="cuda", generator=g).to(torch.bfloat16)[:, 101:1102]
    w = torch.randn(1001, 336, device="cuda", generator=g).to(torch.bfloat16)
    _refuses("masked_matmul unaligned bf16",
             lambda: masked_matmul(x, w, torch.ones_like(w, dtype=torch.bool)))
    # the bf16 kernel reads the mask by TMA: its row stride must be a
    # multiple of 16 bytes
    x = torch.randn(777, 1000, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(1000, 336, device="cuda", generator=g).to(torch.bfloat16)
    m = torch.ones(1000, 344, device="cuda", dtype=torch.bool)[:, :336]
    _refuses("masked_matmul bf16 mask row stride 344", lambda: masked_matmul(x, w, m))
    emit(dict(phase="masked_matmul", case="all-zero mask", exact_zero=True))
    emit(dict(phase="masked_matmul", case="unaligned bf16", refused=True))
    emit(dict(phase="masked_matmul", case="bf16 mask row stride 344", refused=True))
    return summary


def _causal_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    if not causal:
        return sq * sk
    return sum(min(sk, q_offset + i + 1) for i in range(sq))


def phase_flash_attention(g):
    """Kernel vs plain: (256, 2048, 128) causal, a non-causal case and a
    q_offset > 0 case with Sq < Sk, in f32 and bf16; plus every compiled
    head width at a small shape. In every case the row log-sum-exp that the
    forward writes for the backward is held to the plain one."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_plain, flash_attention_plain,
    )

    cases = [(256, 2048, 2048, 128, True, 0), (64, 1024, 1024, 128, False, 0),
             (64, 512, 2048, 128, True, 1536), (8, 200, 333, 64, True, 133),
             (8, 128, 128, 32, False, 0), (16, 128, 128, 16, True, 0)]
    summary = None
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for BH, Sq, Sk, d, causal, off in cases:
            q = torch.randn(BH, Sq, d, device="cuda", generator=g).to(dt)
            k = torch.randn(BH, Sk, d, device="cuda", generator=g).to(dt)
            v = torch.randn(BH, Sk, d, device="cuda", generator=g).to(dt)
            kw = dict(causal=causal, q_offset=off)
            out = flash_attention(q, k, v, **kw)
            ref = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            tag = f"flash_attention {(BH, Sq, Sk, d, causal, off)} {dtype}"
            err = check_close(tag, out, ref, dtype)
            o_lse, lse = FA._launch(q, k, v, causal, off, with_lse=True)
            lse_err = check_close(f"{tag} lse", lse, flash_attention_lse_plain(q, k, **kw),
                                  dtype)
            if not torch.equal(o_lse, out):
                raise AssertionError(f"{tag}: writing the lse changed the output")
            row = dict(phase="flash_attention", dtype=dtype, BH=BH, Sq=Sq, Sk=Sk, d=d,
                       causal=causal, q_offset=off, max_abs_err=err, max_abs_err_lse=lse_err,
                       tol=TOL[dtype])
            del o_lse, lse
            if BH >= 64:
                row["ms"] = timed_ms(lambda: flash_attention(q, k, v, **kw))
                row["plain_ms"] = timed_ms(lambda: flash_attention_plain(q, k, v, **kw))
                if off == 0:
                    row["library_ms"] = timed_ms(lambda: F.scaled_dot_product_attention(
                        q[None], k[None], v[None], is_causal=causal))
                pairs = _causal_pairs(Sq, Sk, causal, off)
                nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
                b_ms, b_by = bound_ms(nbytes, 4.0 * BH * d * pairs, dtype)
                row.update(bound_ms=b_ms, bound_by=b_by)
                if dtype == "bfloat16" and (BH, Sq, causal) == (256, 2048, True):
                    row["deterministic"] = check_repeat(
                        tag, lambda: flash_attention(q, k, v, **kw), out)
                    summary = row
            emit(row)
            del q, k, v, out, ref
    buf = torch.randn(3, 8 * 200 * 64 + 1, device="cuda", generator=g).to(torch.bfloat16)
    q, k, v = (buf[i, 1:].view(8, 200, 64) for i in range(3))
    _refuses("flash_attention unaligned bf16", lambda: flash_attention(q, k, v))
    emit(dict(phase="flash_attention", case="unaligned bf16", refused=True))
    return summary


def phase_masked_matmul_bwd(g):
    """dX = dY (W*M)^T and dW = (X^T dY)*M, kernel vs plain formula at the
    four Llama-7B leaf shapes with M = 16384 rows, f32 and bf16, plus a
    ragged and a strided case; dW must be exactly 0 in every pruned slot.
    Both sum thousands of products: checked within tol x max |plain|."""
    import torch

    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.kernels.masked_matmul.ref import (
        masked_matmul_dw_plain, masked_matmul_dx_plain,
    )

    summary = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, shape, n_red in LEAVES:
            R = math.prod(shape[:n_red])
            w = (torch.randn(shape, device="cuda", generator=g) / math.sqrt(R)).to(dt)
            m = torch.rand(shape, device="cuda", generator=g) < 0.3
            x = torch.randn(M_ROWS, R, device="cuda", generator=g).to(dt)
            w2, m2 = w.reshape(R, -1), m.reshape(R, -1)
            K, N = w2.shape
            dy = torch.randn(M_ROWS, N, device="cuda", generator=g).to(dt)
            dx = MM.masked_matmul_dx(dy, w2, m2)
            dw = MM.masked_matmul_dw(x, dy, m2)
            torch.cuda.synchronize()
            if bool((dw[~m2] != 0).any()):
                raise AssertionError(f"masked_matmul_dw {name} {dtype}: a pruned slot is not 0")
            wm = w2 * m2.to(dt)
            nnz = float(m2.sum())
            for op, out, plain, lib, nbytes in (
                ("dx", dx, lambda: masked_matmul_dx_plain(dy, w2, m2),
                 lambda: torch.matmul(dy, wm.T),
                 (dy.numel() + w2.numel() + dx.numel()) * dy.element_size() + m2.numel()),
                ("dw", dw, lambda: masked_matmul_dw_plain(x, dy, m2),
                 lambda: torch.matmul(x.T, dy) * m2,
                 (x.numel() + dy.numel() + dw.numel()) * x.element_size() + m2.numel()),
            ):
                err = check_scaled(f"masked_matmul_{op} {name} {dtype}", out, plain(), dtype)
                kern = (lambda: MM.masked_matmul_dx(dy, w2, m2)) if op == "dx" else \
                    (lambda: MM.masked_matmul_dw(x, dy, m2))
                b_ms, b_by = bound_ms(nbytes, 2.0 * M_ROWS * nnz, dtype)
                row = dict(phase="masked_matmul_bwd", op=op, leaf=name, dtype=dtype, M=M_ROWS,
                           K=K, N=N, max_abs_err=err, tol=TOL[dtype], ms=timed_ms(kern),
                           plain_ms=timed_ms(plain), library_ms=timed_ms(lib), bound_ms=b_ms,
                           bound_by=b_by)
                if dtype == "bfloat16" and name == "w_up":
                    row["deterministic"] = check_repeat(f"masked_matmul_{op} {name} {dtype}",
                                                        kern, out)
                    summary[op] = row
                emit(row)
            del w, m, x, dy, dx, dw, wm
    # ragged edges (K and N not multiples of the tile), x and dy strided
    # column slices; bf16 with dims and offsets that keep 16-byte alignment
    for dtype, case, K, N, off in (("float32", "ragged+strided", 1001, 333, 101),
                                    ("bfloat16", "ragged+strided", 1000, 336, 104)):
        dt = getattr(torch, dtype)
        x = torch.randn(777, 1200, device="cuda", generator=g).to(dt)[:, off:off + K]
        dy = torch.randn(777, 1200, device="cuda", generator=g).to(dt)[:, off:off + N]
        w = (torch.randn(K, N, device="cuda", generator=g) / 32).to(dt)
        m = torch.rand(K, N, device="cuda", generator=g) < 0.5
        dw = MM.masked_matmul_dw(x, dy, m)
        err_dx = check_scaled(f"masked_matmul_dx {case} {dtype}", MM.masked_matmul_dx(dy, w, m),
                              masked_matmul_dx_plain(dy, w, m), dtype)
        err_dw = check_scaled(f"masked_matmul_dw {case} {dtype}", dw,
                              masked_matmul_dw_plain(x, dy, m), dtype)
        if bool((dw[~m] != 0).any()):
            raise AssertionError(f"masked_matmul_dw {case} {dtype}: a pruned slot is not 0")
        emit(dict(phase="masked_matmul_bwd", case=case, dtype=dtype, M=777, K=K, N=N,
                  max_abs_err_dx=err_dx, max_abs_err_dw=err_dw, tol=TOL[dtype]))
    return summary


def phase_masked_matmul_dm(g):
    """dM = (X^T dY) * W, the mask's gradient under mask tuning, kernel vs
    plain at the four Llama-7B leaf shapes with M = 16384 rows, f32 and
    bf16, plus a ragged and a strided case and the bf16 refusals. It sums
    M products: checked within tol x max |plain|; the bf16 w_up launch
    must repeat bit for bit."""
    import torch

    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_dm_plain

    summary = None
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, shape, n_red in LEAVES:
            R = math.prod(shape[:n_red])
            w = (torch.randn(shape, device="cuda", generator=g) / math.sqrt(R)).to(dt)
            w2 = w.reshape(R, -1)
            K, N = w2.shape
            x = torch.randn(M_ROWS, K, device="cuda", generator=g).to(dt)
            dy = torch.randn(M_ROWS, N, device="cuda", generator=g).to(dt)
            kern = lambda: MM.masked_matmul_dm(x, dy, w2)  # noqa: E731
            dm = kern()
            torch.cuda.synchronize()
            err = check_scaled(f"masked_matmul_dm {name} {dtype}", dm,
                               masked_matmul_dm_plain(x, dy, w2), dtype)
            # reads x, dy and w, writes dm; the product is dense (every
            # slot of the mask takes a gradient): 2*M*K*N operations
            nbytes = (x.numel() + dy.numel() + 2 * w2.numel()) * x.element_size()
            b_ms, b_by = bound_ms(nbytes, 2.0 * M_ROWS * K * N, dtype)
            row = dict(phase="masked_matmul_dm", leaf=name, dtype=dtype, M=M_ROWS, K=K, N=N,
                       max_abs_err=err, tol=TOL[dtype], ms=timed_ms(kern),
                       plain_ms=timed_ms(lambda: masked_matmul_dm_plain(x, dy, w2)),
                       library_ms=timed_ms(lambda: torch.matmul(x.T, dy) * w2),
                       bound_ms=b_ms, bound_by=b_by,
                       deterministic=check_repeat(f"masked_matmul_dm {name} {dtype}", kern, dm))
            if dtype == "bfloat16" and name == "w_up":
                summary = row
            emit(row)
            del w, w2, x, dy, dm
    # ragged edges (K and N not multiples of the tile), x and dy strided
    # column slices; bf16 with dims and offsets that keep 16-byte alignment
    for dtype, case, K, N, off in (("float32", "ragged+strided", 1001, 333, 101),
                                    ("bfloat16", "ragged+strided", 1000, 336, 104)):
        dt = getattr(torch, dtype)
        x = torch.randn(777, 1200, device="cuda", generator=g).to(dt)[:, off:off + K]
        dy = torch.randn(777, 1200, device="cuda", generator=g).to(dt)[:, off:off + N]
        w = (torch.randn(K, N, device="cuda", generator=g) / 32).to(dt)
        err = check_scaled(f"masked_matmul_dm {case} {dtype}", MM.masked_matmul_dm(x, dy, w),
                           masked_matmul_dm_plain(x, dy, w), dtype)
        emit(dict(phase="masked_matmul_dm", case=case, dtype=dtype, M=777, K=K, N=N,
                  max_abs_err=err, tol=TOL[dtype]))
    x = torch.randn(777, 1000, device="cuda", generator=g).to(torch.bfloat16)
    dy = torch.randn(777, 336, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(1000, 340, device="cuda", generator=g).to(torch.bfloat16)[:, :336]
    _refuses("masked_matmul_dm bf16 w row stride 340", lambda: MM.masked_matmul_dm(x, dy, w))
    emit(dict(phase="masked_matmul_dm", case="bf16 w row stride 340", refused=True))
    return summary


def phase_flash_attention_bwd(g):
    """The backward kernel (through ``FlashAttentionFn``) against the plain
    formula and against autograd of the plain attention in f32: (256, 2048, 128)
    causal, non-causal, q_offset with Sq < Sk, and every head width, in f32
    and bf16. Gradients checked within tol x max |plain|."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain,
    )

    cases = [(256, 2048, 2048, 128, True, 0), (64, 1024, 1024, 128, False, 0),
             (64, 512, 2048, 128, True, 1536), (8, 200, 333, 64, True, 133),
             (8, 128, 128, 32, False, 0), (16, 128, 128, 16, True, 0)]
    summary = None
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for BH, Sq, Sk, d, causal, off in cases:
            q = torch.randn(BH, Sq, d, device="cuda", generator=g).to(dt)
            k = torch.randn(BH, Sk, d, device="cuda", generator=g).to(dt)
            v = torch.randn(BH, Sk, d, device="cuda", generator=g).to(dt)
            do = torch.randn(BH, Sq, d, device="cuda", generator=g).to(dt)
            kw = dict(causal=causal, q_offset=off)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            got = torch.autograd.grad(FA.flash_attention(*leaves, **kw), leaves, do)
            o, lse = FA._launch(q, k, v, causal, off, with_lse=True)
            plain = flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
            # autograd of the plain attention on f32 copies of the inputs: in
            # bf16 autograd would round its own intermediate gradients
            leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
            auto = torch.autograd.grad(flash_attention_plain(*leaves, **kw), leaves, do.float())
            del leaves
            torch.cuda.synchronize()
            tag = f"flash_attention_bwd {(BH, Sq, Sk, d, causal, off)} {dtype}"
            err = max(check_scaled(f"{tag} d{n}", a, b, dtype)
                      for n, a, b in zip("qkv", got, plain))
            err_auto = max(check_scaled(f"{tag} d{n} vs autograd", a, b, dtype)
                           for n, a, b in zip("qkv", got, auto))
            row = dict(phase="flash_attention_bwd", dtype=dtype, BH=BH, Sq=Sq, Sk=Sk, d=d,
                       causal=causal, q_offset=off, max_abs_err=err,
                       max_abs_err_vs_autograd=err_auto, tol=TOL[dtype])
            del got, plain, auto
            if BH >= 64:
                row["ms"] = timed_ms(lambda: FA.flash_attention_bwd(q, k, v, o, do, lse, **kw))
                row["plain_ms"] = timed_ms(
                    lambda: flash_attention_bwd_plain(q, k, v, o, do, lse, **kw))
                if off == 0:
                    qkv = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
                    out = F.scaled_dot_product_attention(*qkv, is_causal=causal)
                    row["library_ms"] = timed_ms(lambda: torch.autograd.grad(
                        out, qkv, do[None], retain_graph=True))
                    del qkv, out
                pairs = _causal_pairs(Sq, Sk, causal, off)
                # reads q, k, v, o, do and the f32 lse; writes dq, dk, dv;
                # S = QK^T, dP = dO V^T, dV, dQ, dK: 5 products of 2*d per pair
                nbytes = (5 * q.numel() + 3 * k.numel()) * q.element_size() + 4 * lse.numel()
                b_ms, b_by = bound_ms(nbytes, 10.0 * BH * d * pairs, dtype)
                row.update(bound_ms=b_ms, bound_by=b_by)
                if dtype == "bfloat16" and (BH, Sq, causal) == (256, 2048, True):
                    row["deterministic"] = check_repeat(
                        f"flash_attention_bwd {(BH, Sq, Sk, d)} {dtype}",
                        lambda: FA.flash_attention_bwd(q, k, v, o, do, lse, **kw),
                        FA.flash_attention_bwd(q, k, v, o, do, lse, **kw))
                    summary = row
            emit(row)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    # the bf16 backward reads its operands by TMA: 16-byte-aligned only
    buf = torch.randn(8 * 200 * 64 + 8, device="cuda", generator=g).to(torch.bfloat16)
    ok, bad = buf[8:].view(8, 200, 64), buf[1:1 + 8 * 200 * 64].view(8, 200, 64)
    lse = torch.zeros(8, 200, device="cuda")
    _refuses("flash_attention_bwd unaligned bf16",
             lambda: FA.flash_attention_bwd(ok, ok, ok, ok, bad, lse))
    emit(dict(phase="flash_attention_bwd", case="unaligned bf16", refused=True))
    return summary


# ---------------------------------------------------------------------------
def _check_pruned(res, cfg, keep_frac, pattern):
    """Pruned slots are exactly 0; each output column keeps round(R*keep)
    inputs (or N of every M)."""
    import torch

    from repro_torch import tree as T
    from repro_torch.sparsity import sparse_params as SP

    for path, m in T.leaves_with_path(res.masks):
        if not SP.is_prunable(path, m):
            continue
        w = T.get_path(res.pruned, path)
        if bool((w[~m] != 0).any()):
            raise AssertionError(f"{path}: pruned slots are not exactly 0")
        mat, _ = SP.to_matrix_stacked(path[-1], m)  # (L, R, O)
        R = mat.shape[-2]
        if pattern is None:
            want = max(1, int(round(R * keep_frac)))
            kept = mat.sum(dim=-2)
        else:
            n, mm = pattern
            want = n
            kept = mat.reshape(*mat.shape[:-2], R // mm, mm, mat.shape[-1]).sum(dim=-2)
        if not bool((kept == want).all()):
            raise AssertionError(f"{path}: columns keep {torch.unique(kept).tolist()}, "
                                 f"want {want}")


def _counters():
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.kernels.nm_spmm import ops as NM

    return {"masked_matmul": (MM, "launches"), "masked_matmul_dx": (MM, "dx_launches"),
            "masked_matmul_dw": (MM, "dw_launches"), "masked_matmul_dm": (MM, "dm_launches"),
            "flash_attention": (FA, "launches"),
            "flash_attention_bwd": (FA, "bwd_launches"), "nm_spmm": (NM, "launches")}


def reset_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def llama_cfg(layers: int = 4, dtype: str = "bfloat16"):
    """Llama-7B at its published widths, cut to ``layers`` of its 32 layers,
    with the flash attention kernel."""
    from repro_torch.configs import get_config

    return get_config("llama_7b").replace(num_layers=layers, dtype=dtype, param_dtype=dtype,
                                          attn_impl="flash")


def run_path(tokens, params=None, **spec_kw):
    """``ebft_run.run`` on ``llama_cfg()`` with the run's own calibration
    segments, EBFT at the reference's EBFTConfig defaults (lr 2e-4, 10
    epochs, patience 2) and ``spec_kw``; every kernel count is set to 0
    just before it and read just after. Without ``params`` the run
    pretrains the seeded init for PRETRAIN_STEPS steps on batches of
    PRETRAIN_BATCH, and its pretraining is measured apart through the train
    step's stage hook (``on_stage``): the launches in it and its peak
    memory, read as its last step ends. With ``params`` (the pretrained
    weights) it runs from them and does not pretrain. Returns (cfg, spec,
    result, launches, wall seconds, the pretraining's record or None); the
    peak memory counter starts at the run."""
    import torch

    from repro_torch.launch import ebft_run

    calib, _ = tokens
    cfg = llama_cfg()
    steps = 0 if params is not None else PRETRAIN_STEPS
    spec = ebft_run.RunSpec(arch="llama_7b", seed=0, seq=calib.shape[1],
                            calib_samples=len(calib), pretrain_steps=steps,
                            batch=PRETRAIN_BATCH, lr=2e-4, epochs=10, bench_out="", **spec_kw)
    pre = {}
    ends = [0]

    def on_stage(stage):  # the driver's pretraining step calls it; it runs first in the run
        if stage != "update":
            return
        ends[0] += 1
        if ends[0] == steps:
            torch.cuda.synchronize()
            pre.update(launches=read_counts(),
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = ebft_run.run(cfg, spec, "cuda", params=params, on_stage=on_stage)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return cfg, spec, res, read_counts(), wall, (pre or None)


def phase_slice(method_cfg, tokens, params=None, microbatch=8, every_block_drops=True):
    """The slice on Llama-7B (4 of 32 layers, bf16, flash attention):
    pretraining (without ``params``; ``phase_pretrain`` reports it), then
    prune, EBFT with the reference's EBFTConfig defaults (lr 2e-4, 10
    epochs, patience 2), evaluate; then its masks held against a second
    prune (``phase_mask_flips``). ``tokens`` are the run's own calibration
    and eval segments. Every kernel count is set to 0 just before the run;
    returns the counts read just after it, the run, its config and the
    pretraining's record. On the main path (the run that pretrains) EBFT
    must end below the pruned perplexity, the reference's own ordering
    test; on the others the ordering is printed.

    The mean block loss must drop, and so must every block's that ran to
    its last epoch. With ``every_block_drops`` every block's loss must end
    below where it began. Without it a block that the plateau rule stopped
    must end at or below its best epoch mean: Adam's first step moves every
    weight by lr * sign(g), which on these random weights overshoots, so a
    block's first epochs can lie above its starting loss, and if two do the
    plateau rule (patience 2, the starting loss in the history, as the
    reference's) stops the block there, before it is back below its start.
    That is the algorithm's behaviour, not a fault; the 2:4 run holds it
    so."""
    import torch

    from repro_torch import tree as T
    from repro_torch.launch import ebft_run
    from repro_torch.sparsity import sparse_params as SP

    sparsity, pattern = method_cfg
    calib, ev = tokens
    cfg, spec, res, launches, wall, pre = run_path(tokens, params, method="wanda",
                                                   sparsity=sparsity, pattern=pattern)
    L = cfg.num_layers
    n_cal = math.ceil(len(calib) / microbatch)
    n_ev = math.ceil(ebft_run.EVAL_SAMPLES / microbatch)
    steps = sum(r.epochs_run for r in res.reports) * n_cal  # tuning steps, all blocks
    # masked forwards of a block (7 masked linears, one attention each): the
    # prune walk's advances, the pruned and the tuned eval, and in EBFT per
    # block the mean loss before and after, each step, the student advance.
    # Attention also runs in the dense eval, the prune walk's taps replay
    # and the teacher advances, and in each pretraining step's forward and
    # backward (whose linears are unmasked). Each EBFT step's backward runs
    # dX and dW of the 7 masked linears and one attention backward.
    masked_fwd = L * (n_cal + 2 * n_ev + 3 * n_cal) + steps
    expected = {"masked_matmul": 7 * masked_fwd, "masked_matmul_dx": 7 * steps,
                "masked_matmul_dw": 7 * steps, "masked_matmul_dm": 0,
                "flash_attention": masked_fwd + L * (n_ev + 2 * n_cal + spec.pretrain_steps),
                "flash_attention_bwd": steps + L * spec.pretrain_steps, "nm_spmm": 0}
    pat = tuple(int(x) for x in pattern.split(":")) if pattern else None
    blocks = [dict(block=r.index, loss_before=r.loss_before, loss_after=r.loss_after,
                   dropped=r.loss_after < r.loss_before, epochs_run=r.epochs_run,
                   early_stop=r.early_stop, history=r.history)
              for r in res.reports]
    row = dict(phase="ebft", arch="llama_7b", num_layers=L, reduced="num_layers 32->4",
               dtype="bfloat16", seq=spec.seq, method="wanda", sparsity=sparsity,
               pattern=pattern or None, calib_samples=len(calib),
               eval_samples=ebft_run.EVAL_SAMPLES,
               ebft=dict(lr=spec.lr, epochs=spec.epochs, patience=2,
                         every_block_drops=every_block_drops),
               pretrain_steps=spec.pretrain_steps, perplexity=res.perplexity,
               ebft_below_pruned=res.perplexity["EBFT"] < res.perplexity["wanda"],
               achieved_sparsity=res.sparsity, blocks=blocks, phases_s=res.phases, wall_s=wall,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               live_block_bytes=max(r.live_bytes for r in res.reports),
               launches=launches, expected_launches=expected)
    emit(row)
    for k, v in res.perplexity.items():
        if not math.isfinite(v):
            raise AssertionError(f"ebft: {k} perplexity is {v}")
    if launches != expected:
        raise AssertionError(f"ebft: launches {launches} != expected {expected}")
    for b in blocks:
        if every_block_drops or b["early_stop"] == "max_epochs":
            if not b["dropped"]:
                raise AssertionError(f"ebft: block {b['block']} loss {b['loss_before']} -> "
                                     f"{b['loss_after']} did not drop")
        elif b["loss_after"] > min(b["history"][1:]):
            raise AssertionError(f"ebft: block {b['block']} stopped at {b['loss_after']}, "
                                 f"above its best epoch mean {min(b['history'][1:])}")
    mean_before = sum(b["loss_before"] for b in blocks) / len(blocks)
    mean_after = sum(b["loss_after"] for b in blocks) / len(blocks)
    if not mean_after < mean_before:
        raise AssertionError(f"ebft: mean block loss {mean_before} -> {mean_after} did not drop")
    if params is None and not res.perplexity["EBFT"] < res.perplexity["wanda"]:
        raise AssertionError(f"ebft: EBFT perplexity {res.perplexity['EBFT']} is not below "
                             f"the pruned model's {res.perplexity['wanda']}")
    _check_pruned(res, cfg, 1.0 - sparsity, pat)
    for path, m in T.leaves_with_path(res.masks):
        if SP.is_prunable(path, m) and bool((T.get_path(res.tuned, path)[~m] != 0).any()):
            raise AssertionError(f"ebft: {path} tuned weights are not 0 in pruned slots")
    # the masks the run tuned with must equal a repeat of its prune
    phase_mask_flips(cfg, spec, pat, tokens, res.dense, run_masks=res.masks)
    return launches, res, cfg, pre


def phase_nm_pack(res, cfg, tokens, launches, microbatch=8):
    """The 2:4 run's tuned weights re-packed with ``nm_compress`` and run
    through ``nm_spmm`` on the run's own block inputs (the tuned student
    stream's first calibration microbatch, M = 16384 rows), held against
    ``masked_matmul`` on the same tuned weights, bit for bit (both run the
    same wgmma main loop on the same operands), and against the plain
    version element by element within tol x (|x| @ |w * m|) of that
    element. Adds the nm_spmm launches to ``launches`` (the path's counts,
    set to 0 before its run)."""
    import torch

    from repro_torch import tree as T
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.kernels.nm_spmm import ops as NM
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_plain
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP
    from repro_torch.sparsity.taps import dense_taps

    model = build(cfg)
    calib, _ = tokens
    n, m = 2, 4
    batch = {"tokens": torch.as_tensor(calib[:microbatch], device="cuda")}
    errs, scales, packed, dense_bytes, timing = [], [], 0, 0, None
    with torch.no_grad():
        h, pos = model.embed_tokens(res.tuned, batch)
        for i in range(model.num_blocks):
            bp, mb = model.get_block(res.tuned, i), model.get_block(res.masks, i)
            taps = dense_taps(bp, cfg, h, pos)
            for path, w in T.leaves_with_path(bp):
                if not SP.is_prunable(path, w):
                    continue
                w2, _ = SP.to_matrix(path[-1], w)
                m2, _ = SP.to_matrix(path[-1], T.get_path(mb, path))
                vals, idx = SP.nm_compress(w2, m2, n, m)
                if not torch.equal(SP.nm_decompress(vals, idx, n, m), w2 * m2):
                    raise AssertionError(f"nm_pack: block {i} {path} pack/unpack mismatch")
                x = taps[path[-1]]
                out = NM.nm_spmm(x, vals, idx, n=n, m=m)
                ref_mm = masked_matmul(x, w2, m2)
                plain = nm_spmm_plain(x, vals, idx, n=n, m=m)
                torch.cuda.synchronize()
                # the pretrained model's block inputs reach |x| ~ 1e5: each
                # output is held within tol of the magnitude of its own terms
                absprod = x.float().abs() @ (w2 * m2).float().abs()
                err, ratio = check_bounded(f"nm_spmm block {i} {path[-1]}", out, plain, absprod,
                                           TOL["bfloat16"])
                del absprod
                if not torch.equal(out, ref_mm):
                    raise AssertionError(f"nm_spmm block {i} {path[-1]}: not bit for bit equal "
                                         f"to masked_matmul (max abs diff "
                                         f"{float((out.float() - ref_mm.float()).abs().max())})")
                err_mm = 0.0
                errs.append((err, ratio))
                scales.append((float(x.float().abs().max()), float(plain.float().abs().max())))
                packed += vals.numel() * vals.element_size() + idx.numel()
                dense_bytes += w2.numel() * w2.element_size()
                if i == 0 and path[-1] == "w_up":  # timed below, outside the path
                    timing = (x, vals, idx, SP.nm_decompress(vals, idx, n, m), out, err, err_mm)
            h = model.apply_block(res.tuned, i, bp, h, pos, mb)
    torch.cuda.synchronize()
    launches["nm_spmm"] = NM.launches
    expected = 7 * model.num_blocks
    if launches["nm_spmm"] != expected:
        raise AssertionError(f"nm_pack: {launches['nm_spmm']} nm_spmm launches, want {expected}")
    x, vals, idx, wd, out, err, err_mm = timing
    M, (K, N) = x.shape[0], wd.shape
    nbytes = (x.numel() + M * N) * x.element_size() + vals.numel() * vals.element_size() + \
        idx.numel()  # the compressed weight's bytes
    b_ms, b_by = bound_ms(nbytes, 2.0 * M * (K // m * n) * N, "bfloat16")
    summary = dict(phase="nm_spmm", leaf="w_up", block=0, dtype="bfloat16", M=M, K=K, N=N,
                   n=n, m=m, max_abs_err=err, max_abs_err_vs_masked_matmul=err_mm,
                   limit=f"{TOL['bfloat16']} x |x| @ |w*m| per element; bitwise vs masked_matmul",
                   ms=timed_ms(lambda: NM.nm_spmm(x, vals, idx, n=n, m=m)),
                   plain_ms=timed_ms(lambda: nm_spmm_plain(x, vals, idx, n=n, m=m)),
                   library_ms=timed_ms(lambda: torch.matmul(x, wd)), bound_ms=b_ms,
                   bound_by=b_by, deterministic=check_repeat(
                       "nm_spmm w_up", lambda: NM.nm_spmm(x, vals, idx, n=n, m=m), out))
    # the f32 kernel, 1:4, ragged edges (K, N not multiples of the tile)
    # and a strided x; in bf16 an N whose rows of vals and idx the TMA
    # takes (16-byte strides); the bf16 wrapper refuses operands it cannot take
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype, (nn, mm), K, N in (("float32", (2, 4), 1000, 333), ("float32", (1, 4), 4096, 336),
                                  ("bfloat16", (2, 4), 1000, 336), ("bfloat16", (1, 4), 4096, 11008)):
        dt = getattr(torch, dtype)
        xs = torch.randn(777, K + 8, device="cuda", generator=g).to(dt)[:, :K]
        ws = (torch.randn(K, N, device="cuda", generator=g) / math.sqrt(K)).to(dt)
        vs, ix = SP.nm_compress(ws, SP.nm_mask(torch.rand(K, N, device="cuda", generator=g),
                                               nn, mm), nn, mm)
        err = check_close(f"nm_spmm {nn}:{mm} {(K, N)} {dtype}", NM.nm_spmm(xs, vs, ix, n=nn, m=mm),
                          nm_spmm_plain(xs, vs, ix, n=nn, m=mm), dtype)
        emit(dict(phase="nm_spmm", case=f"{nn}:{mm} ragged+strided", dtype=dtype, M=777, K=K,
                  N=N, max_abs_err=err, tol=TOL[dtype]))
    xs = torch.randn(777 * 1000 + 1, device="cuda", generator=g).to(torch.bfloat16)[1:]
    vs, ix = SP.nm_compress(torch.ones(1000, 336, device="cuda", dtype=torch.bfloat16),
                            SP.nm_mask(torch.rand(1000, 336, device="cuda", generator=g), 2, 4),
                            2, 4)
    _refuses("nm_spmm unaligned bf16",
             lambda: NM.nm_spmm(xs.view(777, 1000), vs, ix, n=2, m=4))
    vs, ix = SP.nm_compress(torch.ones(1000, 333, device="cuda", dtype=torch.bfloat16),
                            SP.nm_mask(torch.rand(1000, 333, device="cuda", generator=g), 2, 4),
                            2, 4)
    _refuses("nm_spmm bf16 N=333",
             lambda: NM.nm_spmm(torch.zeros(777, 1000, device="cuda", dtype=torch.bfloat16),
                                vs, ix, n=2, m=4))
    emit(dict(phase="nm_spmm", case="unaligned bf16", refused=True))
    emit(dict(phase="nm_spmm", case="bf16 N=333 (vals and idx row strides)", refused=True))
    emit(dict(phase="nm_pack", pattern="2:4", leaves=len(errs),
              max_abs_err=max(e for e, _ in errs), max_abs_err_vs_masked_matmul=0.0,
              max_abs_x=max(a for a, _ in scales), max_abs_out=max(b for _, b in scales),
              worst_err_over_abs_terms=max(r for _, r in errs),
              limit=f"{TOL['bfloat16']} x |x| @ |w*m| per element; bitwise vs masked_matmul",
              packed_mib=packed / 2**20, dense_mib=dense_bytes / 2**20,
              launches=launches["nm_spmm"], expected_launches=expected))
    emit(summary)
    return summary


# ---------------------------------------------------------------------------
# the paper's baselines on the card: paths A and B, each through
# ebft_run.run at the main path's size
def _check_finite_and_drop(tag, res):
    """Every perplexity is finite and EBFT's mean block loss drops."""
    for k, v in res.perplexity.items():
        if not math.isfinite(v):
            raise AssertionError(f"{tag}: {k} perplexity is {v}")
    before = sum(r.loss_before for r in res.reports) / len(res.reports)
    after = sum(r.loss_after for r in res.reports) / len(res.reports)
    if not after < before:
        raise AssertionError(f"{tag}: EBFT's mean block loss {before} -> {after} did not drop")
    return before, after


def _check_launches(tag, launches, expected):
    if launches != expected:
        raise AssertionError(f"{tag}: launches {launches} != expected {expected}")


def _column_counts(path, m):
    """Kept slots of each output column of an (L, ...) mask leaf: (L, O)."""
    from repro_torch.sparsity import sparse_params as SP

    return SP.to_matrix_stacked(path[-1], m)[0].sum(dim=-2)


def _sparsegpt_block0_errors(cfg, params, res, calib, microbatch):
    """Block 0's layer output error ||X W - X W'||^2 on the calibration
    set, for each leaf, with W' SparseGPT's updated weights and with the
    dense weights under the same mask. X is the leaf's input tapped from the
    dense block on the embedding, what SparseGPT's Gram was taken of."""
    import torch

    from repro_torch import tree as T
    from repro_torch.core.pruning import common as C
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP
    from repro_torch.sparsity.taps import dense_taps

    model = build(cfg)
    bp, mb, pb = (model.get_block(t, 0) for t in (params, res.masks, res.pruned))
    errs = {}
    with torch.no_grad():
        for s in range(0, len(calib), microbatch):
            h, pos = model.embed_tokens(
                params, {"tokens": torch.as_tensor(calib[s:s + microbatch], device="cuda")})
            taps = dense_taps(bp, cfg, h, pos)
            for names, w in C.iter_prunable(bp):
                x = C.lookup_tap(taps, names).float()
                w2 = SP.to_matrix(names[-1], w)[0].float()
                m2 = SP.to_matrix(names[-1], T.get_path(mb, names))[0]
                wn = SP.to_matrix(names[-1], T.get_path(pb, names))[0].float()
                ref = x @ w2
                e = errs.setdefault(names[-1], [0.0, 0.0])
                e[0] += float(torch.square(ref - x @ wn).sum())
                e[1] += float(torch.square(ref - x @ (w2 * m2)).sum())
                del x, ref
    for name, (e_upd, e_mask) in errs.items():
        if not e_upd < e_mask:
            raise AssertionError(f"sparsegpt: block 0 {name}: the updated weights' error {e_upd} "
                                 f"is not below the mask alone's {e_mask}")
    return {name: dict(updated=e[0], mask_only=e[1]) for name, e in errs.items()}


def _sparsegpt_gram_readings(cfg, params, calib, microbatch):
    """Block 0's SparseGPT Grams on the weights ``params``, for each distinct
    leaf input (wq's serves wk and wv, w_up's w_gate), summed over the
    calibration set two ways: in f32 by the card's GEMM (the reference's
    sum, and the port's before it summed in f64) and in f64 (the port's
    sum). For each: the smallest eigenvalue (taken in f64), the damping
    SparseGPT adds (1% of the diagonal mean), and whether SparseGPT's f32
    inverse and Cholesky (``sparsegpt._hinv_upper``, the reference's steps)
    complete on the sum rounded to f32."""
    import torch

    from repro_torch.core.pruning import common as C
    from repro_torch.core.pruning import sparsegpt as SG
    from repro_torch.models.model import build
    from repro_torch.sparsity.taps import dense_taps

    model = build(cfg)
    bp = model.get_block(params, 0)
    leaves = [n for n in C.iter_prunable(bp) if n[0][-1] in ("wq", "wo", "w_up", "w_down")]
    sums = {}
    with torch.no_grad():
        for s in range(0, len(calib), microbatch):
            h, pos = model.embed_tokens(
                params, {"tokens": torch.as_tensor(calib[s:s + microbatch], device="cuda")})
            taps = dense_taps(bp, cfg, h, pos)
            for names, _ in leaves:
                x = C.lookup_tap(taps, names)
                x32, x64 = x.float(), x.double()
                h32, h64 = C.full_f32_matmul(x32.T, x32), x64.T @ x64
                if names[-1] in sums:
                    h32, h64 = sums[names[-1]][0] + h32, sums[names[-1]][1] + h64
                sums[names[-1]] = (h32, h64)
            del taps, h
    out = {}
    for name, (h32, h64) in sums.items():
        row = dict(R=h32.shape[0])
        for tag, H in (("f32_sum", h32), ("f64_sum", h64)):
            try:
                chol = bool(torch.isfinite(SG._hinv_upper(H.float())).all())
            except torch.linalg.LinAlgError:
                chol = False
            row[tag] = dict(eig_min=float(torch.linalg.eigvalsh(H.double())[0]),
                            damp=0.01 * float(torch.diagonal(H).double().mean()),
                            diag_max=float(torch.diagonal(H).max()), f32_cholesky=chol)
        out[name] = row
    del sums
    torch.cuda.empty_cache()
    return out


def phase_path_a(tokens, dense, microbatch=8):
    """Path A: SparseGPT 0.7 -> EBFT -> the DSnoT and mask-tuning baselines,
    on Llama-7B (4 of 32 layers, bf16, flash attention) from the pretrained
    weights ``dense``, through ``ebft_run.run``. Raises unless every
    perplexity is finite; every
    128-row block of every output column of every pruned leaf keeps
    round(128 * 0.3); EBFT's mean block loss drops; on block 0 SparseGPT's
    updated weights give a smaller layer output error than the dense
    weights under the same mask, leaf by leaf; DSnoT keeps each column's
    kept count of its init masks and raises no column's |E|; mask tuning's
    weights are the dense ones under its masks, bit for bit, and every
    column keeps round(R * 0.3); and the launch counts are the loop's:
    7 dM per mask-tuning step, 7 dW per EBFT step only."""
    import torch

    from repro_torch import tree as T
    from repro_torch.launch import ebft_run
    from repro_torch.sparsity import sparse_params as SP

    sparsity = 0.7
    calib, _ = tokens
    grams = _sparsegpt_gram_readings(llama_cfg(), dense, calib, microbatch)
    emit(dict(phase="path_a", sparsegpt_block0_grams=grams))
    cfg, spec, res, launches, wall, _ = run_path(tokens, dense, method="sparsegpt",
                                                 sparsity=sparsity, baselines="dsnot,mask")
    peak = torch.cuda.max_memory_allocated() / 2**30
    L = cfg.num_layers
    n_cal = math.ceil(len(calib) / microbatch)
    n_ev = math.ceil(ebft_run.EVAL_SAMPLES / microbatch)
    steps = sum(r.epochs_run for r in res.reports) * n_cal
    ds, mt = res.baselines["dsnot"], res.baselines["mask"]
    mt_steps = sum(len(h) for h in mt["histories"]) * n_cal
    # block forwards through the masked linears: SparseGPT's walk, the
    # pruned and tuned evals, EBFT (before, after, each step, the student);
    # DSnoT's own SparseGPT walk, its walk and eval; mask tuning's steps,
    # student advance and eval. Attention also runs in the dense eval, each
    # calibration walk's taps (SparseGPT, DSnoT's two) and the teachers
    # (EBFT, mask tuning). A mask-tuning step's backward runs dM of the 7
    # masked linears and dX of the 4 whose input takes a gradient (wo, w_up,
    # w_gate, w_down), and no dW: the weights are frozen.
    fwd = L * (n_cal + 2 * n_ev + 3 * n_cal) + steps + L * (2 * n_cal + n_ev) + \
        mt_steps + L * (n_cal + n_ev)
    expected = {"masked_matmul": 7 * fwd, "masked_matmul_dx": 7 * steps + 4 * mt_steps,
                "masked_matmul_dw": 7 * steps, "masked_matmul_dm": 7 * mt_steps,
                "flash_attention": fwd + L * (n_ev + 5 * n_cal),
                "flash_attention_bwd": steps + mt_steps, "nm_spmm": 0}
    mean_before, mean_after = _check_finite_and_drop("path A", res)
    for path, m in T.leaves_with_path(res.masks):
        if not SP.is_prunable(path, m):
            continue
        mat = SP.to_matrix_stacked(path[-1], m)[0]
        bs = min(128, mat.shape[-2])  # SparseGPT's block: 128 rows, or all R below that
        keep = max(1, int(round(bs * (1 - sparsity))))
        blocks = mat.reshape(L, mat.shape[-2] // bs, bs, mat.shape[-1]).sum(dim=-2)
        if not bool((blocks == keep).all()):
            raise AssertionError(f"sparsegpt: {path} 128-row blocks keep "
                                 f"{torch.unique(blocks).tolist()}, want {keep}")
        if bool((T.get_path(res.pruned, path)[~m] != 0).any()):
            raise AssertionError(f"sparsegpt: {path} pruned slots are not exactly 0")
        if not torch.equal(_column_counts(path, T.get_path(ds["masks"], path)),
                           _column_counts(path, m)):
            raise AssertionError(f"dsnot: {path} changed a column's kept count")
    worst_e, e_before, e_after = 0.0, 0.0, 0.0
    for key, (before, after, scale) in ds["errors"].items():
        worst_e = max(worst_e, float(((after - before) / scale.clamp_min(1e-30)).max()))
        e_before += float(before.sum())
        e_after += float(after.sum())
    if worst_e > 1e-6:
        raise AssertionError(f"dsnot: a column's |E| grew by {worst_e:.2e} of its sum |c|")
    for path, w in T.leaves_with_path(mt["params"]):
        m = T.get_path(mt["masks"], path)
        if not torch.equal(w, T.get_path(dense, path) * m):
            raise AssertionError(f"mask tuning: {path} weights are not the dense ones under "
                                 "its masks")
        if SP.is_prunable(path, m):
            want = max(1, int(round(SP.to_matrix_stacked(path[-1], m)[0].shape[-2]
                                    * (1 - sparsity))))
            if not bool((_column_counts(path, m) == want).all()):
                raise AssertionError(f"mask tuning: {path} columns keep other than {want}")
    sgpt_errors = _sparsegpt_block0_errors(cfg, dense, res, calib, microbatch)
    row = dict(phase="path_a", arch="llama_7b", num_layers=L, reduced="num_layers 32->4",
               dtype="bfloat16", seq=spec.seq, method="sparsegpt", sparsity=sparsity,
               baselines=spec.baselines, calib_samples=len(calib),
               eval_samples=ebft_run.EVAL_SAMPLES, perplexity=res.perplexity,
               ebft_below_pruned=res.perplexity["EBFT"] < res.perplexity["sparsegpt"],
               achieved_sparsity=res.sparsity, phases_s=res.phases, wall_s=wall,
               peak_mem_gib=peak, ebft_mean_loss=[mean_before, mean_after],
               ebft_blocks=[dict(block=r.index, loss_before=r.loss_before,
                                 loss_after=r.loss_after, epochs_run=r.epochs_run,
                                 early_stop=r.early_stop) for r in res.reports],
               sparsegpt_block0_error=sgpt_errors,
               dsnot_sum_abs_e=[e_before, e_after], dsnot_worst_e_growth=worst_e,
               mask_tune_histories=mt["histories"], launches=launches,
               expected_launches=expected)
    emit(row)
    _check_launches("path A", launches, expected)
    return launches


def phase_path_b(tokens, dense, microbatch=8):
    """Path B: FLAP at 26% structured sparsity -> EBFT -> 200 LoRA steps
    (the paper's structured comparison of EBFT against LoRA), on Llama-7B
    (4 of 32 layers, bf16, flash attention) from the pretrained weights
    ``dense``, through ``ebft_run.run``.
    Raises unless every mask is constant along each unit (a head's wq and
    wo slices, and under MHA its wk and wv; a channel's w_up, w_gate and
    w_down slices); a repeat of the prune gives the run's masks, and from
    its raw scores, standardised here, every unit clearly above the global
    threshold (the round(units * 0.74)-th largest) stays and every unit
    clearly below it goes, keeping at least one head and one channel per
    block (FLAP keeps every unit tied at the threshold); EBFT's mean block
    loss drops; LoRA's merged
    weights are exactly 0 in pruned slots and its LM losses are finite; and
    the launch counts are the loop's."""
    import torch

    from repro_torch import tree as T
    from repro_torch.core.masks import prune
    from repro_torch.core.pruning.flap import remaining_param_fraction
    from repro_torch.launch import ebft_run
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP

    sparsity = 0.26
    calib, _ = tokens
    cfg, spec, res, launches, wall, _ = run_path(tokens, dense, method="flap",
                                                 sparsity=sparsity, baselines="lora")
    peak = torch.cuda.max_memory_allocated() / 2**30
    L, H = cfg.num_layers, cfg.num_heads
    n_cal = math.ceil(len(calib) / microbatch)
    n_ev = math.ceil(ebft_run.EVAL_SAMPLES / microbatch)
    steps = sum(r.epochs_run for r in res.reports) * n_cal
    lo = res.baselines["lora"]
    n_lora = len(lo["losses"])
    # block forwards through the masked linears: the pruned and tuned evals,
    # EBFT (before, after, each step, the student), each LoRA step's forward
    # (one microbatch of 8) and LoRA's eval; FLAP's scoring walk runs the
    # dense stream. Attention also runs in the dense eval, FLAP's taps and
    # advances, and EBFT's teacher. A LoRA step's backward runs dW of all 28
    # masked linears and dX of all but block 0's wq, wk and wv (their input,
    # the normed embedding, takes no gradient).
    fwd = L * (2 * n_ev + 3 * n_cal) + steps + L * n_lora + L * n_ev
    expected = {"masked_matmul": 7 * fwd, "masked_matmul_dx": 7 * steps + (7 * L - 3) * n_lora,
                "masked_matmul_dw": 7 * steps + 7 * L * n_lora, "masked_matmul_dm": 0,
                "flash_attention": fwd + L * (n_ev + 3 * n_cal),
                "flash_attention_bwd": steps + L * n_lora, "nm_spmm": 0}
    mean_before, mean_after = _check_finite_and_drop("path B", res)
    model = build(cfg)
    kept_units, units = 0, L * (H + cfg.d_ff)
    for i in range(L):
        mb = model.get_block(res.masks, i)
        heads, ch = mb["attn"]["wo"][:, 0, 0], mb["mlp"]["w_down"][:, 0]
        want = {"wq": heads[None, :, None], "wk": heads[None, :, None],
                "wv": heads[None, :, None], "wo": heads[:, None, None],
                "w_up": ch[None, :], "w_gate": ch[None, :], "w_down": ch[:, None]}
        if cfg.num_kv_heads != H:  # GQA keeps the shared kv heads
            want["wk"] = want["wv"] = torch.ones_like(heads[:1])[None, :, None]
        for path, m in T.leaves_with_path(mb):
            if SP.is_prunable(path, m) and not torch.equal(m, want[path[-1]].expand(m.shape)):
                raise AssertionError(f"flap: block {i} {path} is not constant along its units")
        if int(heads.sum()) < 1 or int(ch.sum()) < 1:
            raise AssertionError(f"flap: block {i} lost every head or every channel")
        kept_units += int(heads.sum()) + int(ch.sum())
    want_units = int(round(units * (1 - sparsity)))
    scores = {}
    rep_masks, _ = prune(model, dense, calib, method="flap", sparsity=sparsity,
                         scores_out=scores)
    for path, m in T.leaves_with_path(res.masks):
        if not torch.equal(m, T.get_path(rep_masks, path)):
            raise AssertionError(f"flap: a repeat of the prune gave other masks at {path}")
    # each block's raw scores standardised here in f64, apart from the
    # program's own code: z = (s - mean) / sqrt(mean((s - mean)^2)). A unit
    # clearly above the global threshold (the want_units-th largest z) must
    # stay, one clearly below must go unless it is its block's only head or
    # channel left. The program standardises in f32, so its z carries a few
    # ulps of (|s| + |mean|) / std: units within 1e-6 x max(1, |mean| / std)
    # of the threshold may fall either way (FLAP keeps the ones its f32
    # rounding ties to the threshold)
    z, spread = {}, 1.0
    for i in range(L):
        for k in ("heads", "channels"):
            v = scores[(i, k)].double()
            c = v - v.sum() / v.numel()
            sd = max(math.sqrt(float((c * c).sum()) / v.numel()), 1e-9)
            z[(i, k)] = c / sd
            spread = max(spread, abs(float(v.sum() / v.numel())) / sd)
    allz = torch.cat(list(z.values()))
    thr = float(torch.sort(allz).values[-want_units])
    eps = 1e-6 * spread
    near, wrong, gap_kept, gap_dropped = {}, [], 0.0, 0.0
    for i in range(L):
        mb = model.get_block(res.masks, i)
        unit = {"heads": mb["attn"]["wo"][:, 0, 0], "channels": mb["mlp"]["w_down"][:, 0]}
        for k, kept in unit.items():
            zi = z[(i, k)]
            above, below = zi > thr + eps, zi < thr - eps
            if bool((above & ~kept).any()):
                wrong.append(f"block {i} {k}: {int((above & ~kept).sum())} above dropped")
            extra = int((below & kept).sum())
            if extra and not (extra == 1 and int(kept.sum()) == 1):
                wrong.append(f"block {i} {k}: {extra} below kept")
            if bool(kept.any()):
                gap_kept = max(gap_kept, float((thr - zi[kept]).max()))
            if bool((~kept).any()):
                gap_dropped = max(gap_dropped, float((zi[~kept] - thr).max()))
            band = ~above & ~below
            if bool(band.any()):
                raw = scores[(i, k)].double()
                near[f"block {i} {k}"] = dict(
                    within=int(band.sum()), kept=int((band & kept).sum()), of=zi.numel(),
                    exactly_at=int((zi == thr).sum()),
                    z_minus_threshold=[float((zi[band] - thr).min()), float((zi[band] - thr).max())],
                    raw=[float(raw[band].min()), float(raw[band].max())],
                    raw_max=float(raw.max()), mean_over_std=float(raw.mean() / raw.std(correction=0)))
    if wrong or kept_units < want_units:
        raise AssertionError(f"flap: {kept_units} units stay ({want_units} wanted) and the "
                             f"masks disagree with the standardised scores: {wrong}")
    for path, w in T.leaves_with_path(lo["params"]):
        m = T.get_path(res.masks, path)
        if SP.is_prunable(path, m) and bool((w[~m] != 0).any()):
            raise AssertionError(f"lora: {path} merged weights are not 0 in pruned slots")
    losses = torch.stack(lo["losses"]).float().cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("lora: a LM loss is not finite")
    row = dict(phase="path_b", arch="llama_7b", num_layers=L, reduced="num_layers 32->4",
               dtype="bfloat16", seq=spec.seq, method="flap", sparsity=sparsity,
               baselines=spec.baselines, calib_samples=len(calib),
               eval_samples=ebft_run.EVAL_SAMPLES, perplexity=res.perplexity,
               ebft_below_pruned=res.perplexity["EBFT"] < res.perplexity["flap"],
               ebft_below_lora=res.perplexity["EBFT"] < res.perplexity["LoRA"],
               remaining_param_fraction=remaining_param_fraction(res.masks, res.pruned),
               kept_units=kept_units, units=units, want_units=want_units,
               unit_sparsity=1 - kept_units / units, threshold_z=thr, band_eps=eps,
               near_threshold=near, widest_gap_kept_below=gap_kept,
               widest_gap_dropped_above=gap_dropped, phases_s=res.phases, wall_s=wall,
               peak_mem_gib=peak, ebft_mean_loss=[mean_before, mean_after],
               lora_steps=n_lora, lora_loss_first=float(losses[0]),
               lora_loss_last=float(losses[-1]), lora_s=res.phases["baseline_lora"],
               launches=launches, expected_launches=expected)
    emit(row)
    _check_launches("path B", launches, expected)
    return launches


# ---------------------------------------------------------------------------
# pretraining, the train step and checkpoints
def _train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x (non-embedding + head
    parameters) x tokens for the linears, and for the causal attention 4 d
    (forward: QK^T, PV) and 10 d (backward: S again, dV, dP, dQ, dK) per
    (query, key) pair per layer, d = d_model."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    hd = cfg.resolved_head_dim
    attn = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = d * ff * (3 if cfg.mlp_act == "swiglu" else 2)
    linears = L * (attn + mlp) + d * cfg.padded_vocab
    pairs = batch * seq * (seq + 1) // 2
    return 6.0 * linears * batch * seq + L * pairs * 14.0 * d


def phase_pretrain(cfg, res, pre, launches, seq=2048):
    """The main path's pretraining (PRETRAIN_STEPS AdamW steps at lr 3e-3 on
    batches of PRETRAIN_BATCH x 2048 tokens): the loss and grad norm at the
    steps the driver records, seconds per step, peak memory and the model
    FLOP rate. Raises unless every loss and grad norm is finite, the mean of
    the last 10 recorded losses is below the step-0 loss, each attention
    kernel (forward and backward) ran steps x layers times in it and no
    masked-matmul kernel ran. Returns the pretraining's launches."""
    L, steps, batch = cfg.num_layers, PRETRAIN_STEPS, PRETRAIN_BATCH
    hist = res.pretrain_losses
    per_step = res.phases["pretrain"] / steps
    flops = _train_flops(cfg, batch, seq)
    want = {k: 0 for k in launches}
    want.update(flash_attention=steps * L, flash_attention_bwd=steps * L)
    row = dict(phase="pretrain", arch="llama_7b", num_layers=L, reduced="num_layers 32->4",
               dtype=cfg.dtype, steps=steps, batch=batch, seq=seq,
               lr=3e-3, optimizer="adamw (weight decay 0.1), clip 1.0",
               loss=[dict(step=i, loss=loss, grad_norm=gn) for i, loss, gn in hist],
               seconds=res.phases["pretrain"], s_per_step=per_step,
               tokens_per_s=batch * seq / per_step, flops_per_step=flops,
               tflops=flops / per_step / 1e12,
               mfu=flops / per_step / PEAK_FLOPS["bfloat16"],
               peak_mem_gib=pre["peak_mem_gib"], launches=pre["launches"],
               expected_launches=want)
    emit(row)
    if not all(math.isfinite(x) for _, loss, gn in hist for x in (loss, gn)):
        raise AssertionError(f"pretrain: a loss or grad norm is not finite: {hist}")
    last = [loss for _, loss, _ in hist[-10:]]
    if not sum(last) / len(last) < hist[0][1]:
        raise AssertionError(f"pretrain: the last losses {last} average no lower than the "
                             f"step-0 loss {hist[0][1]}")
    if pre["launches"] != want:
        raise AssertionError(f"pretrain: launches {pre['launches']} != expected {want}")
    return pre["launches"]


def phase_pretrain_split(cfg, dense, steps=4):
    """Where a pretraining step's time goes: the driver's own pretraining
    (``ebft_run.pretrain``, on a copy of the pretrained weights) for one
    warm-up step and ``steps`` timed ones, read through the train step's
    stage hook: CUDA events as the forward and backward, the global-norm
    clip and the AdamW update end, and the host's time between steps (the
    batch's sampling and copy to the card, and the loop)."""
    import torch

    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus
    from repro_torch.launch import ebft_run
    from repro_torch.models.model import build

    ev, sums, step, last_end = {}, dict(data=0.0, forward_backward=0.0, clip=0.0,
                                        optimizer=0.0, step=0.0), [0], [None]

    def on_stage(stage):
        if stage == "start":
            torch.cuda.synchronize()
            if step[0] > 0:  # the first step warms up
                sums["data"] += time.perf_counter() - last_end[0]
        ev[stage] = torch.cuda.Event(enable_timing=True)
        ev[stage].record()
        if stage == "update":
            torch.cuda.synchronize()
            last_end[0] = time.perf_counter()
            if step[0] > 0:
                for k, (a, b) in dict(forward_backward=("start", "grads"), clip=("grads", "clip"),
                                      optimizer=("clip", "update"),
                                      step=("start", "update")).items():
                    sums[k] += ev[a].elapsed_time(ev[b]) / 1e3
            step[0] += 1

    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    ebft_run.pretrain(build(cfg), dense, corpus, steps + 1, PRETRAIN_BATCH, 2048,
                      ebft_run.PRETRAIN_LR, on_stage=on_stage)
    split = {k: v / steps for k, v in sums.items()}
    flops = _train_flops(cfg, PRETRAIN_BATCH, 2048)
    emit(dict(phase="pretrain_split", steps=steps, s_per_step=split,
              forward_backward_tflops=flops / split["forward_backward"] / 1e12,
              bound_s=flops / PEAK_FLOPS["bfloat16"]))
    return split


def _rel_tree(a, b) -> float:
    """Largest relative L2 distance of a leaf of ``a`` from ``b``'s."""
    from repro_torch import tree as T

    return max(_rel_norm(x, T.get_path(b, p)) for p, x in T.leaves_with_path(a))


def phase_checkpoint(dense):
    """The pretrained bf16 weights at full width through ``ckpt.save``
    (async) and ``restore`` onto the card, bit for bit, with the bytes on
    disk and the seconds; the disk's free space is checked first and too
    little fails the phase. Then ``Trainer`` on tiny_dense (f32, flash
    attention on the card): six straight steps equal three steps, a
    restore from disk and three more, bit for bit, weights and AdamW state
    both."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus
    from repro_torch.models.model import build
    from repro_torch.optim.optimizers import adamw
    from repro_torch.training.train_loop import Trainer, make_train_step

    root = os.path.join(ROOT, "build", "ckpt_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        nbytes = sum(t.numel() * t.element_size() for _, t in T.leaves_with_path(dense))
        free = shutil.disk_usage(root).free
        if free < 2 * nbytes:
            raise AssertionError(f"checkpoint: {free} bytes free, the weights need {nbytes}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CK.save(os.path.join(root, "full"), {"params": dense}, step=PRETRAIN_STEPS,
                async_write=True)
        t_snap = time.perf_counter() - t0
        CK.wait_all()
        t_save = time.perf_counter() - t0
        d = os.path.join(root, "full", f"step_{PRETRAIN_STEPS:08d}")
        on_disk = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        t0 = time.perf_counter()
        back = CK.restore(os.path.join(root, "full"), {"params": dense})["params"]
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        for path, t in T.leaves_with_path(dense):
            r = T.get_path(back, path)
            if not (r.device == t.device and r.dtype == t.dtype and torch.equal(r, t)):
                raise AssertionError(f"checkpoint: {path} came back other than it was saved")
        del back
        row = dict(phase="checkpoint", leaves=len(list(T.leaves_with_path(dense))),
                   tensor_bytes=nbytes, bytes_on_disk=on_disk, free_bytes=free,
                   snapshot_s=t_snap, save_s=t_save, restore_s=t_restore, bit_exact=True)

        cfg = get_config("tiny_dense").replace(attn_impl="flash")
        model = build(cfg)
        params0 = model.init(torch.Generator(device="cuda").manual_seed(0))
        corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))

        def data_fn(step):
            r = np.random.default_rng(1000 + step)
            return {"tokens": torch.as_tensor(
                np.stack([corpus.sample(r, 128) for _ in range(8)]), device="cuda")}

        opt = adamw(1e-3)
        step = make_train_step(model.loss, opt)
        p = T.tree_map(lambda t: t.clone(), params0)  # the step writes in place
        s = opt.init(p)
        for i in range(6):
            p, s, _, _ = step(p, s, data_fn(i), None)
        straight = {"params": p, "opt_state": s}
        ck = os.path.join(root, "tiny")
        tr = Trainer(step_fn=step, data_fn=data_fn, ckpt_dir=ck, ckpt_every=3, log_every=1)
        p = T.tree_map(lambda t: t.clone(), params0)
        p, s, _ = tr.run(p, opt.init(p), 0, 3)
        tree = CK.restore(ck, {"params": model.init(torch.Generator(device="cuda")
                                                    .manual_seed(1)), "opt_state": s})
        p, s, _ = tr.run(tree["params"], tree["opt_state"], CK.latest_step(ck), 3)
        resumed = {"params": p, "opt_state": s}
        differ = [p_ for p_, t in T.leaves_with_path(straight)
                  if not torch.equal(t, T.get_path(resumed, p_))]
        row.update(tiny_resume_bit_exact=not differ, tiny_resume_differing_leaves=len(differ),
                   tiny_resume_rel=_rel_tree(resumed, straight))
        emit(row)
        if differ:
            raise AssertionError(f"checkpoint: resumed training differs from straight in {differ}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_tiny_pretrain(steps=20, loss_rtol=1e-5, param_rtol=1e-4):
    """``make_train_step`` (AdamW at lr 3e-3, clip 1.0) on tiny_dense in
    f32 for ``steps`` steps from the same weights and batches on the card
    (flash attention kernels, cuBLAS without TF32) and on the CPU: every
    loss within rel 1e-5 and each final weight leaf within rel 1e-4 (its
    relative L2 distance). Adam's sign-like first steps turn rounding in a
    near-zero gradient into a move of up to lr, so the weights part further
    than the losses; both runs repeat bit for bit, so the margin is fixed."""
    import torch

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, corpus_iterator
    from repro_torch.launch import ebft_run
    from repro_torch.models.model import build
    from repro_torch.optim.optimizers import adamw
    from repro_torch.training.train_loop import make_train_step

    cfg = get_config("tiny_dense").replace(attn_impl="flash")
    model = build(cfg)
    init = model.init(torch.Generator().manual_seed(0))
    it = corpus_iterator(SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0)),
                         batch=8, seq_len=128, seed=1)
    batches = [next(it) for _ in range(steps)]

    def train(dev):
        p = T.tree_map(lambda t: t.to(dev, copy=True), init)
        opt = adamw(ebft_run.PRETRAIN_LR)
        step, s, losses = make_train_step(model.loss, opt), opt.init(p), []
        for b in batches:
            p, s, m, _ = step(p, s, {"tokens": torch.as_tensor(b, device=dev)}, None)
            losses.append(m["loss"])
        return [float(x) for x in losses], T.tree_map(lambda t: t.cpu(), p)

    card, cpu = train("cuda"), train("cpu")
    loss_rel = max(abs(a / b - 1) for a, b in zip(card[0], cpu[0]))
    param_rel = _rel_tree(card[1], cpu[1])
    emit(dict(phase="tiny_pretrain", arch="tiny_dense", dtype="float32", steps=steps,
              losses_cuda=card[0], losses_cpu=cpu[0], worst_loss_rel=loss_rel,
              worst_param_rel=param_rel, loss_rtol=loss_rtol, param_rtol=param_rtol))
    if not all(math.isfinite(x) for x in card[0]) or loss_rel > loss_rtol:
        raise AssertionError(f"tiny pretrain: card vs CPU loss rel {loss_rel:.2e}")
    if param_rel > param_rtol:
        raise AssertionError(f"tiny pretrain: card vs CPU weights rel {param_rel:.2e}")


# largest relative gap to its threshold of a block-0 slot whose mask two
# attention paths may flip: block 0's statistics come from the dense block
# on the embedding, so the paths' scores there differ by rounding alone
FIRST_BLOCK_GAP = {"bfloat16": 1e-2, "float32": 1e-4}


def phase_mask_flips(cfg, spec, pattern, tokens, params, run_masks=None):
    """Prune the run's weights ``params`` twice more: as the run did (with
    ``run_masks``, the masks must equal them), and with the plain attention
    ("chunked") in place of the kernel, whose output differs in rounding
    and summation order, so its masks may differ in slots near their
    thresholds. Each such slot is kept under one set of scores and dropped
    under the other, so its distance from the first threshold cannot
    exceed how far the scores and thresholds moved,
    |sA - tA| <= |sA - sB| + |tA - tB|; a slot past that bound fails. A
    flip in block 0 must also lie within FIRST_BLOCK_GAP of its threshold.
    Later blocks see calibration inputs that passed through blocks pruned
    with masks that differ, so their flips need not be near-ties. The
    pruned perplexity under each set of masks, both through the kernels,
    shows what the flips alone do to it."""
    from repro_torch import tree as T
    from repro_torch.core.evaluate import perplexity
    from repro_torch.core.masks import prune
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP

    calib, ev = tokens
    model = build(cfg)
    masks, pruned, scores = {}, {}, {}
    for impl in ("flash", "chunked"):
        scores[impl] = {}
        masks[impl], pruned[impl] = prune(
            build(cfg.replace(attn_impl=impl)), params, calib, method="wanda",
            sparsity=spec.sparsity, pattern=pattern, scores_out=scores[impl])
    repeat_diff, flips, slots, worst_move = 0, 0, 0, 0.0
    per_block, gap_per_block = [0] * cfg.num_layers, [0.0] * cfg.num_layers
    for path, m_a in T.leaves_with_path(masks["flash"]):
        if not SP.is_prunable(path, m_a):
            continue
        if run_masks is not None:
            repeat_diff += int((m_a != T.get_path(run_masks, path)).sum())
        diff = m_a != T.get_path(masks["chunked"], path)
        for i in range(m_a.shape[0]):
            sa = scores["flash"][(i, *path[1:])].double()
            sb = scores["chunked"][(i, *path[1:])].double()
            ta = SP.thresholds(sa, spec.sparsity, pattern)
            tb = SP.thresholds(sb, spec.sparsity, pattern)
            move = (sa - sb).abs() + (ta - tb).abs()
            worst_move = max(worst_move, float((move / ta.abs()).max()))
            slots += sa.numel()
            d = diff[i].reshape(sa.shape)
            n = int(d.sum())
            if n == 0:
                continue
            flips += n
            per_block[i] += n
            lhs = (sa - ta).abs()[d]
            if bool((lhs > move[d] * (1 + 1e-9)).any()):
                raise AssertionError(f"mask flips: a slot of {path} block {i} flipped "
                                     f"farther from its threshold than the scores moved")
            gap_per_block[i] = max(gap_per_block[i], float((lhs / ta.abs()[d]).max()))
    del scores
    ppl = {impl: perplexity(model, pruned[impl], ev, masks=masks[impl]) for impl in masks}
    emit(dict(phase="mask_flips", dtype=cfg.dtype, method="wanda", sparsity=spec.sparsity,
              pattern=spec.pattern or None,
              repeat_differing_slots=repeat_diff if run_masks is not None else None,
              chunked_vs_kernel_flips=flips, prunable_slots=slots,
              flip_rate=flips / slots, flips_per_block=per_block,
              worst_flip_gap_rel_per_block=gap_per_block,
              first_block_gap_limit=FIRST_BLOCK_GAP[cfg.dtype],
              worst_score_move_rel=worst_move, ppl_kernel_masks=ppl["flash"],
              ppl_chunked_masks=ppl["chunked"],
              ppl_rel_change=ppl["chunked"] / ppl["flash"] - 1.0))
    if repeat_diff:
        raise AssertionError(f"mask flips: a repeat of the run's prune differs from it "
                             f"in {repeat_diff} slots")
    if gap_per_block[0] > FIRST_BLOCK_GAP[cfg.dtype]:
        raise AssertionError(f"mask flips: a block-0 slot {gap_per_block[0]:.2e} from its "
                             f"threshold flipped (limit {FIRST_BLOCK_GAP[cfg.dtype]:.0e})")
    if not all(math.isfinite(v) for v in ppl.values()):
        raise AssertionError(f"mask flips: pruned perplexity {ppl}")


def phase_tiny_crosscheck():
    """tiny_dense with the same weights on the card (kernels) and on the
    CPU (plain versions): perplexities within rel 1e-4 (f32, sums taken in
    another order), and masks that differ only in slots whose Wanda score
    lies within 1e-6 (relative) of its column's threshold."""
    import torch

    from repro_torch import interop
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core.evaluate import perplexity
    from repro_torch.core.masks import prune
    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set, eval_set
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP

    cfg = get_config("tiny_dense").replace(attn_impl="flash")
    model = build(cfg)
    weights = interop.params_to_numpy(model.init(torch.Generator().manual_seed(0)))
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib, ev = calibration_set(corpus, 16, 128), eval_set(corpus, 16, 128)
    out = {}
    for dev in ("cuda", "cpu"):
        params = interop.params_to_torch(weights, dev)
        scores = {}
        masks, pruned = prune(model, params, calib, method="wanda", sparsity=0.5,
                              scores_out=scores)
        out[dev] = dict(dense=perplexity(model, params, ev),
                        wanda=perplexity(model, pruned, ev, masks=masks),
                        masks=masks, scores=scores)
    flips, worst = 0, 0.0
    for path, m in T.leaves_with_path(out["cpu"]["masks"]):
        if not SP.is_prunable(path, m):
            continue
        diff = m != T.get_path(out["cuda"]["masks"], path).cpu()
        for i in range(m.shape[0]):
            s = out["cpu"]["scores"][(i, *path[1:])]
            d = diff[i].reshape(s.shape)
            if d.any():
                gap = float(SP.threshold_gaps(s, 0.5)[d].max())
                worst = max(worst, gap)
                flips += int(d.sum())
    row = dict(phase="tiny_crosscheck", arch="tiny_dense", attn_impl="flash",
               ppl_cuda={k: out["cuda"][k] for k in ("dense", "wanda")},
               ppl_cpu={k: out["cpu"][k] for k in ("dense", "wanda")},
               ppl_rtol=1e-4, mask_flips=flips, worst_flip_gap=worst, gap_rtol=1e-6)
    emit(row)
    for k in ("dense", "wanda"):
        a, b = out["cuda"][k], out["cpu"][k]
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"tiny cross-check: {k} ppl cuda {a} vs cpu {b}")
    if worst > 1e-6:
        raise AssertionError(f"tiny cross-check: a mask flipped {worst:.2e} from its threshold")
    phase_tiny_ebft(model, weights, out["cpu"]["masks"], calib, ev)
    phase_tiny_baselines(model, weights, calib, ev, corpus)


def phase_tiny_ebft(model, weights, masks_cpu, calib, ev, rel=1e-4):
    """EBFT on tiny_dense in f32 from the same weights and the same (CPU)
    masks on the card (kernels, their backward) and on the CPU (plain
    versions): equal epochs_run and early stops per block, loss histories
    and the EBFT perplexity within rel 1e-4 (f32, sums taken in another
    order)."""
    from repro_torch import interop
    from repro_torch import tree as T
    from repro_torch.core import ebft
    from repro_torch.core.evaluate import perplexity
    from repro_torch.sparsity import sparse_params as SP

    ecfg = ebft.EBFTConfig(lr=1e-2, epochs=8, microbatch=8, patience=3)
    out = {}
    for dev in ("cuda", "cpu"):
        params = interop.params_to_torch(weights, dev)
        masks = T.tree_map(lambda m: m.to(dev), masks_cpu)
        tuned, reports = ebft.finetune(model, params, SP.apply_masks(params, masks), masks,
                                       calib, ecfg)
        out[dev] = dict(reports=reports, ppl=perplexity(model, tuned, ev, masks=masks))
    worst = 0.0
    for a, b in zip(out["cuda"]["reports"], out["cpu"]["reports"]):
        if (a.epochs_run, a.early_stop) != (b.epochs_run, b.early_stop):
            raise AssertionError(f"tiny EBFT: block {a.index} ran {a.epochs_run} "
                                 f"({a.early_stop}) on the card, {b.epochs_run} "
                                 f"({b.early_stop}) on the CPU")
        for x, y in zip(a.history + [a.loss_after], b.history + [b.loss_after]):
            worst = max(worst, abs(x - y) / abs(y))
    ppl_rel = abs(out["cuda"]["ppl"] / out["cpu"]["ppl"] - 1.0)
    emit(dict(phase="tiny_ebft", arch="tiny_dense", dtype="float32", lr=ecfg.lr,
              epochs=ecfg.epochs, patience=ecfg.patience,
              epochs_run=[r.epochs_run for r in out["cuda"]["reports"]],
              early_stop=[r.early_stop for r in out["cuda"]["reports"]],
              worst_loss_rel=worst, ppl_cuda=out["cuda"]["ppl"], ppl_cpu=out["cpu"]["ppl"],
              ppl_rel=ppl_rel, rtol=rel))
    if worst > rel or ppl_rel > rel:
        raise AssertionError(f"tiny EBFT: card vs CPU loss rel {worst:.2e}, ppl rel "
                             f"{ppl_rel:.2e} (limit {rel:.0e})")


def _rel_norm(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _mask_flips(masks_a, masks_b, gap_fn, tie):
    """Slots where two full mask trees differ, per (block, path): each must
    lie within ``tie`` (relative) of its comparison group's threshold, as
    ``gap_fn(block, path, diff)`` measures it; returns {path: [flips per
    block]}."""
    from repro_torch import tree as T
    from repro_torch.sparsity import sparse_params as SP

    out = {}
    for path, m in T.leaves_with_path(masks_b):
        if not SP.is_prunable(path, m):
            continue
        diff = T.get_path(masks_a, path).cpu() != m.cpu()
        out["/".join(path[1:])] = [int(diff[i].sum()) for i in range(m.shape[0])]
        for i in range(m.shape[0]):
            if diff[i].any():
                gap = gap_fn(i, path, SP.to_matrix(path[-1], diff[i])[0])
                if gap > tie:
                    raise AssertionError(f"tiny baselines: {path} block {i} flipped a slot "
                                         f"{gap:.2e} from its threshold (limit {tie:.0e})")
    return out


def phase_tiny_baselines(model, weights, calib, ev, corpus, rel=1e-4):
    """SparseGPT, DSnoT and FLAP prunes, mask tuning and 20 LoRA steps on
    tiny_dense in f32, from the same weights on the card (kernels) and on
    the CPU (plain versions); mask tuning and LoRA start from the CPU's
    SparseGPT masks and LoRA from one CPU-drawn adapter init. The prunes'
    masks agree but for slots near their threshold: SparseGPT's within 1e-4
    of its block scores' threshold (its scores pass through an inverse and
    a Cholesky factor of a Gram damped by 1% of its diagonal mean), FLAP's
    units within 1e-5 of the global threshold; DSnoT's masks (from Wanda's,
    which agree here) equal; and where they agree, weights and perplexities
    within rel 1e-4. Mask tuning's masks may differ only where the two
    runs' final scores moved (|sA - tA| <= |sA - sB| + |tA - tB|): Adam's
    sign-like steps turn rounding in a near-zero gradient into a move of
    up to lr a step, as the reference's own run moves under a 1e-6 change of
    its start. Its epoch histories agree within rel 1e-4 up to the first
    block whose masks differ (the streams are the same until then), and its
    perplexity too when no block's do. LoRA's 20 steps: LM losses, merged
    weights and perplexity within rel 1e-4."""
    import torch

    from repro_torch import interop
    from repro_torch import tree as T
    from repro_torch.core import lora as LORA
    from repro_torch.core import mask_tuning as MT
    from repro_torch.core.evaluate import perplexity
    from repro_torch.core.masks import prune
    from repro_torch.core.pruning import flap as FLAP
    from repro_torch.data.tokens import corpus_iterator
    from repro_torch.sparsity import sparse_params as SP

    runs = {"sparsegpt": 0.5, "dsnot": 0.5, "flap": 0.3}
    out = {dev: {} for dev in ("cuda", "cpu")}
    for dev in ("cuda", "cpu"):
        params = interop.params_to_torch(weights, dev)
        for method, sp in runs.items():
            scores = {}
            masks, pruned = prune(model, params, calib, method=method, sparsity=sp,
                                  scores_out=scores)
            out[dev][method] = dict(masks=masks, pruned=pruned, scores=scores,
                                    ppl=perplexity(model, pruned, ev, masks=masks))
    row = dict(phase="tiny_baselines", arch="tiny_dense", dtype="float32", rtol=rel)
    cpu, card = out["cpu"], out["cuda"]
    # SparseGPT: every tiny leaf has R <= 128, one block per column
    row["sparsegpt_flips"] = _mask_flips(card["sparsegpt"]["masks"], cpu["sparsegpt"]["masks"],
                                         lambda i, p, d: float(SP.threshold_gaps(
                                             cpu["sparsegpt"]["scores"][(i, *p[1:])], 0.5)[d]
                                             .max()), 1e-4)
    row["dsnot_flips"] = _mask_flips(card["dsnot"]["masks"], cpu["dsnot"]["masks"],
                                     lambda i, p, d: math.inf, 0.0)

    # FLAP: each unit (a head, a channel) whose mask differs must lie near
    # the global threshold of the CPU's standardised scores
    std = [{k: FLAP._standardize(cpu["flap"]["scores"][(i, k)]) for k in ("heads", "channels")}
           for i in range(model.num_blocks)]
    allv = torch.cat([v for b in std for v in b.values()])
    thr = torch.sort(allv).values[-max(1, int(round(allv.numel() * (1 - runs["flap"]))))]
    row["flap_flips"] = 0
    for i in range(model.num_blocks):
        units = [{"heads": mb["attn"]["wo"][:, 0, 0].cpu(), "channels": mb["mlp"]["w_down"][:, 0]
                  .cpu()} for mb in (model.get_block(out[d]["flap"]["masks"], i) for d in out)]
        for kind, d in ((k, units[0][k] != units[1][k]) for k in units[0]):
            if d.any():
                gap = float(((std[i][kind] - thr).abs() / thr.abs())[d].max())
                if gap > 1e-5:
                    raise AssertionError(f"tiny baselines: flap block {i} flipped a unit {gap:.2e} "
                                         "from the threshold (limit 1e-5)")
                row["flap_flips"] += int(d.sum())
    flipped = {m for m in ("sparsegpt", "dsnot")
               if any(any(v) for v in row[f"{m}_flips"].values())}
    if row["flap_flips"]:
        flipped.add("flap")
    for method in runs:
        if method in flipped:
            continue
        for path, w in T.leaves_with_path(cpu[method]["pruned"]):
            if _rel_norm(T.get_path(card[method]["pruned"], path), w) > rel:
                raise AssertionError(f"tiny baselines: {method} {path} weights differ")
        if abs(card[method]["ppl"] / cpu[method]["ppl"] - 1) > rel:
            raise AssertionError(f"tiny baselines: {method} ppl {card[method]['ppl']} vs "
                                 f"{cpu[method]['ppl']}")
    row["ppl"] = {m: [card[m]["ppl"], cpu[m]["ppl"]] for m in runs}

    masks0 = cpu["sparsegpt"]["masks"]
    pruned0 = cpu["sparsegpt"]["pruned"]
    lcfg = LORA.LoRAConfig(steps=20, lr=1e-3)
    init = LORA.init_lora(pruned0, lcfg, torch.Generator().manual_seed(0))
    res = {}
    for dev in ("cuda", "cpu"):
        params = interop.params_to_torch(weights, dev)
        masks = T.tree_map(lambda m: m.to(dev), masks0)
        hist, scores, losses = [], {}, []
        mt, mt_masks = MT.finetune_masks(model, params, masks, 0.5, calib, histories=hist,
                                         scores_out=scores)
        lp = LORA.finetune_lora(model, T.tree_map(lambda t: t.to(dev), pruned0), masks,
                                corpus_iterator(corpus, batch=8, seq_len=calib.shape[1],
                                                seed=9),
                                lcfg, lora=T.tree_map(lambda t: t.to(dev), init), losses=losses)
        res[dev] = dict(hist=hist, scores=scores, masks=mt_masks,
                        mt_ppl=perplexity(model, mt, ev, masks=mt_masks), lora=lp,
                        losses=[float(v) for v in losses],
                        lora_ppl=perplexity(model, lp, ev, masks=masks))
    # mask tuning: each slot whose tuned mask differs must be explained by
    # how far the two runs' final scores and thresholds moved, |sA - tA| <=
    # |sA - sB| + |tA - tB| (the hard threshold is the same rule on each
    # side); how far they moved is reported per block
    nb = model.num_blocks
    mt = dict(flips=[0] * nb, worst_score_move_rel=[0.0] * nb, worst_flip_gap_rel=[0.0] * nb)
    for (i, *path), sa in res["cuda"]["scores"].items():
        sa, sb = sa.double().cpu(), res["cpu"]["scores"][(i, *path)].double()
        ta, tb = SP.thresholds(sa, 0.5), SP.thresholds(sb, 0.5)
        move = (sa - sb).abs() + (ta - tb).abs()
        d = SP.to_matrix(path[-1], T.get_path(res["cuda"]["masks"]["blocks"], path)[i].cpu()
                         != T.get_path(res["cpu"]["masks"]["blocks"], path)[i])[0]
        mt["worst_score_move_rel"][i] = max(mt["worst_score_move_rel"][i],
                                            float((move / ta.abs()).max()))
        if d.any():
            lhs = (sa - ta).abs()[d]
            if bool((lhs > move[d] * (1 + 1e-9)).any()):
                raise AssertionError(f"tiny baselines: mask tuning {path} block {i} flipped a "
                                     "slot farther from its threshold than the scores moved")
            mt["flips"][i] += int(d.sum())
            mt["worst_flip_gap_rel"][i] = max(mt["worst_flip_gap_rel"][i],
                                              float((lhs / ta.abs()[d]).max()))
    mt.update(histories_cuda=res["cuda"]["hist"], histories_cpu=res["cpu"]["hist"],
              ppl=[res["cuda"]["mt_ppl"], res["cpu"]["mt_ppl"]])
    row["mask_tune"] = mt
    # up to the first block whose masks flipped, the two runs see the same
    # streams: their epoch histories, and with no flip the perplexity, agree
    first = next((i for i, n in enumerate(mt["flips"]) if n), nb)
    for b in range(first):
        for x, y in zip(res["cuda"]["hist"][b], res["cpu"]["hist"][b]):
            if abs(x / y - 1) > rel:
                emit(row)
                raise AssertionError(f"tiny baselines: mask tuning block {b} history differs")
    if first == nb and abs(res["cuda"]["mt_ppl"] / res["cpu"]["mt_ppl"] - 1) > rel:
        emit(row)
        raise AssertionError("tiny baselines: mask tuning ppl differs")
    worst = max(abs(x / y - 1) for x, y in zip(res["cuda"]["losses"], res["cpu"]["losses"]))
    for path, w in T.leaves_with_path(res["cpu"]["lora"]):
        worst = max(worst, _rel_norm(T.get_path(res["cuda"]["lora"], path), w))
    lora_rel = abs(res["cuda"]["lora_ppl"] / res["cpu"]["lora_ppl"] - 1)
    row["lora"] = dict(steps=lcfg.steps, worst_loss_or_weight_rel=worst,
                       ppl=[res["cuda"]["lora_ppl"], res["cpu"]["lora_ppl"]], ppl_rel=lora_rel)
    emit(row)
    if worst > rel or lora_rel > rel:
        raise AssertionError(f"tiny baselines: LoRA card vs CPU rel {worst:.2e} / {lora_rel:.2e}")


# ---------------------------------------------------------------------------
def main() -> int:
    # cuBLAS picks its workspace per stream; a fixed configuration makes a
    # product repeat bit for bit, which the resumed training run relies on.
    # It must be set before the first product.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = smi()
    print(card, flush=True)
    emit(dict(phase="device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
              kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count()))
    t0 = time.perf_counter()
    _build.build(["masked_matmul", "flash_attention", "nm_spmm"])
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              ptxas={n: [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
                     for n, log in _build.build_log.items()}))

    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {"masked_matmul": phase_masked_matmul(g)}
    rows.update({f"masked_matmul_{op}": r for op, r in phase_masked_matmul_bwd(g).items()})
    rows["masked_matmul_dm"] = phase_masked_matmul_dm(g)
    rows["flash_attention"] = phase_flash_attention(g)
    rows["flash_attention_bwd"] = phase_flash_attention_bwd(g)
    torch.cuda.empty_cache()
    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set, eval_set
    from repro_torch.configs import get_config
    from repro_torch import tree as T
    from repro_torch.launch.ebft_run import EVAL_SAMPLES, RunSpec

    # the run's segments, sampled as ebft_run.run samples them (seed 0)
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=32000, seed=0))
    tokens = calibration_set(corpus, 16, 2048), eval_set(corpus, EVAL_SAMPLES, 2048)
    # the main path: pretraining, Wanda 0.7, EBFT; its launches are the ones
    # reported, but for nm_spmm (the N:M path) and dM (path A, mask tuning)
    walls = {}
    t0 = time.perf_counter()
    launches, res, cfg, pre = phase_slice((0.7, ""), tokens)
    pre_launches = phase_pretrain(cfg, res, pre, launches)
    walls["wanda"] = time.perf_counter() - t0
    dense = res.dense  # every later path starts from the pretrained weights
    del res
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_pretrain_split(cfg, dense)
    phase_checkpoint(dense)
    walls["pretrain_split+checkpoint"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # the N:M path: 2:4 prune, EBFT, re-pack, nm_spmm
    t0 = time.perf_counter()
    nm_launches, res, cfg, _ = phase_slice((0.5, "2:4"), tokens, dense, every_block_drops=False)
    rows["nm_spmm"] = phase_nm_pack(res, cfg, tokens, nm_launches)
    walls["2:4"] = time.perf_counter() - t0
    launches["nm_spmm"] = nm_launches["nm_spmm"]
    del res
    torch.cuda.empty_cache()
    # path A: SparseGPT, EBFT, DSnoT and mask tuning; path B: FLAP, EBFT, LoRA
    t0 = time.perf_counter()
    by_path = {"A": phase_path_a(tokens, dense)}
    walls["A"] = time.perf_counter() - t0
    launches["masked_matmul_dm"] = by_path["A"]["masked_matmul_dm"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    by_path["B"] = phase_path_b(tokens, dense)
    walls["B"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # the Wanda prune at f32, where the two attention paths differ only in
    # the order of their sums
    cfg32 = get_config("llama_7b").replace(num_layers=4, attn_impl="flash")
    spec32 = RunSpec(arch="llama_7b", seed=0, seq=2048, sparsity=0.7, calib_samples=16,
                     pretrain_steps=0, epochs=0, bench_out="")
    phase_mask_flips(cfg32, spec32, None, tokens, T.tree_map(lambda t: t.float(), dense))
    del dense
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tiny_crosscheck()
    phase_tiny_pretrain()
    walls["tiny"] = time.perf_counter() - t0
    emit(dict(phase="walls", seconds=walls, total_s=time.perf_counter() - t_start))

    root = "src/repro_torch/kernels/csrc/"
    pallas = {"masked_matmul": "src/repro/kernels/masked_matmul/masked_matmul.py:49",
              "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:85",
              "nm_spmm": "src/repro/kernels/nm_spmm/nm_spmm.py:62"}
    kernels = []
    for name, row in rows.items():
        base = name.replace("_dx", "").replace("_dw", "").replace("_dm", "").replace("_bwd", "")
        kernels.append(dict(name=name, route="cuda", source=root + base + ".cu",
                            replaces=pallas[base], launches=launches[name],
                            launches_pretrain=pre_launches[name],
                            launches_path_a=by_path["A"][name], launches_path_b=by_path["B"][name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row.get("library_ms"),
                            vs_library=(row["ms"] / row["library_ms"]
                                        if row.get("library_ms") else None)))
    print(smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
