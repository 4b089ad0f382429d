#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``src/repro_torch``) on one card.

    python3 chip_smoke.py                # the smoke
    python3 chip_smoke.py --plant-fault  # the MoE mesh cells' check, against a planted fault

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
into ``build/kernels/``, holds each against its plain PyTorch version at
the Llama-7B shapes of the slice (the masked matmul and its dX, dW and dM,
the flash attention forward and backward, the N:M sparse matmul), drives
the pipeline (``repro_torch.launch.ebft_run.run``) on Llama-7B at full
width with 4 of its 32 layers in bf16: Wanda 0.7 -> EBFT (the main path);
2:4, whose tuned weights are re-packed and run through ``nm_spmm``;
SparseGPT 0.7 -> EBFT with the DSnoT and mask-tuning baselines (path A);
FLAP at 26% structured sparsity -> EBFT with 10 LoRA steps (path B). It
serves the main path's pretrained and EBFT-tuned weights from a KV cache
(``serve``: cached decode held to the no-cache forward, continuous
batching through ``repro_torch.serving``, ``launch/serve`` on the card).
It cross-checks tiny_dense (the Wanda, SparseGPT, DSnoT and FLAP prunes,
EBFT, mask tuning, LoRA) on the card against the CPU. The ``moe`` phase
runs the MoE family at DeepSeek-MoE-16B's widths (5 of its 28 layers):
pretraining, Wanda 0.7, EBFT and serving, with the routed experts'
products through the expert-batched masked GEMM, which the
``masked_matmul_batched`` phase holds against its plain version and
against the 2-D kernel on each expert's slab; and tiny_moe on the card
against the CPU. The ``ssm`` and ``hybrid`` phases run the SSM family on
Mamba2-130M (4 of its 24 layers) and the hybrid on Zamba2-1.2B (6 of its 38
layers) at their published widths: pretraining, Wanda 0.7, EBFT,
perplexity and serving, every Mamba projection through the masked GEMM
(Mamba2-130M's in_dt mask, (768, 24), a view into a row-padded buffer)
and Zamba2's shared block through the attention kernel at head width 64,
which the masked and attention phases hold at those shapes; then
tiny_ssm and tiny_hybrid on the card against the CPU. The ``vlm`` phase
runs the VLM family on LLaVA-NeXT-Mistral-7B at its published widths (3
of its 32 layers; 32 query heads over 8 KV heads; seq 2048 = 1024 seeded
patch positions + 1024 tokens): pretraining through ``launch/train``,
Wanda 0.7, EBFT and perplexity with the patches passed as ``extra_batch``,
then greedy serving through the cache's GQA branch and the
teacher-forced check of the multimodal prefill and decode; then tiny_vlm
(with the baselines) and the SMOKE sizes of Qwen1.5-4B, Nemotron-4-15B,
Qwen2.5-32B and Qwen1.5-110B on the card against the CPU, whose leaf
shapes, with LLaVA's, the ``masked_matmul_vlm`` phase holds. The
``encdec`` phase runs the encoder-decoder family on Seamless-M4T-medium
at its published widths, not reduced (12 encoder + 12 decoder layers,
vocab 256206; seq 2048 decoder tokens over 256 seeded frames):
pretraining through ``launch/train`` in 2 microbatches, Wanda 0.7, EBFT
and perplexity with the frames passed as ``extra_batch`` (the decoder's
cross-attention over the encoder memory: non-causal, Sq != Sk, its
memory projections through the masked GEMM at M = 2048), then the
teacher-forced check and greedy serving at the model level; then
tiny_encdec (with the baselines) on the card against the CPU. The
``masked_matmul_encdec`` phase and the attention phases hold its shapes.
The ``mesh`` phase runs the EBFT walk on a mesh of ranks (``MeshPlan``,
``core/ebft.py``) at Llama-7B's widths (1 layer, f32): one process, a
one-rank nccl check of the inactive plans, then a 2 × 1 and a 1 × 2 mesh
of gloo ranks on the one card, each held to the one process's per-block
losses with its kernels launched on every rank's local shards. The same
ranks then run the sharded cells of ``launch/steps.py`` (train, ebft in
two layouts, prefill and greedy decode) and ``launch/train.run`` with a
checkpoint saved on 2 × 1 and resumed on 1 × 2, each held to one process;
the ebft cells' masked matmuls and the launcher's flash attention are
launched on local shards and counted. The ``mesh_families`` phase then
runs the MoE, SSM, hybrid, VLM and encoder-decoder families on the same
two meshes at their published widths (DeepSeek-MoE-16B at 2 layers,
Mamba2-130M at 2, Zamba2-1.2B at 6, LLaVA-NeXT-Mistral-7B at 1 over 1024
seeded patches and 1024 tokens, Seamless-M4T-medium at 1 + 1 over 256
seeded frames): the EBFT walk in f32, the train and ebft cells of the
SSM and the VLM, the MoE's train and ebft cells on 1 × 2 only and the
encoder-decoder's train cell on 2 × 1 only (bf16, the MoE's train cell
f32), and every family's prefill and decode steps, each held to one
process, with the experts split over "model" (the expert-batched masked
GEMM on each rank's slabs), the Mamba mixers over heads, and the VLM's
and the encoder-decoder's masked
products on each rank's rows or columns; on 1 × 2 a rank's expert slabs
against the whole launch bit for bit and Mamba2-130M's in_dt shard
through the bf16 kernel. The ``dryrun`` phase runs ``python -m
repro_torch.launch.dryrun`` (a fake process group, no device) in the
background from the start over one config of each family at
``ebft_block`` and Llama-7B's ``train_4k`` on the 16 × 16 mesh, and at
the end holds every record to no error and its ``argument_bytes`` to a
count of the cell's in-specs on the abstract mesh made here.
Every path above runs with the tile autotuner off (``kernel_tune="off"``),
on the default tiles. The ``tuning`` phase (last) holds every compiled
instantiation's launch plan (``kernels/validation.py``) to the compiled
kernel, every compiled candidate tile of every bf16 route to its plain
version (repeated bit for bit, its bits compared with the default's),
pre-tunes Llama-7B's and Seamless-M4T-medium's EBFT launches in ``search``
mode (default and best ms of each), runs the static checks (``python -m
repro_torch.analysis``, phase ``analysis``) over every config with that
searched cache, and runs ``ebft_run.run`` on a 1-layer
Llama-7B with ``--kernel-tune search``, then ``cache`` (warm: no miss),
then ``off``. The kernels line gives each row's default ``tiles``. Every
phase
prints one JSON line, also appended to ``chiprun_out/chip_smoke_phases.jsonl``
beside the script; any failed check raises, so the script exits non-zero. The last three lines
are the card's name and power limit, the per-kernel summary, and
``{"ok": true, "device": ...}``. Without a card it exits non-zero and
prints no result.

Every path runs inside an obs run (``repro_torch.obs``): each writes its
artifact in the reference's schema to ``chiprun_out/`` (the main path's
is ``chiprun_out/BENCH_ebft.json``) and must pass ``validate_payload``.
Every EBFT runs the reference's default path: the fused loop (every
epoch enqueued, the plateau decided on the card, one host read a block)
with the teacher prefetched one visit ahead on a side stream; each
``ebft_run`` artifact must also pass the reference's CI gate,
``max_dispatches_per_block = epochs + 2``, and the launch counts take all
10 epochs of a fused block. The ``obs`` phase prints the main path's
``walk_phases``, its span tree's top two levels (each phase with the
event time of its kernel launches, ``kernel_s``) and each kernel's in-run
CUDA-event times, and reruns its EBFT with obs off and on: the tuned
weights must equal the main run's bit for bit. The ``fused`` phase then
reruns the main path's EBFT three ways at a rel_tol at which blocks stop
early (fused with prefetch 1, fused with prefetch 0, the per-epoch loop),
holds them equal bit for bit and prints
each one's wall, walk phases, dispatches, host syncs, peak memory and the
epochs it computed after a plateau. The summary line carries each kernel's in-run times beside its
isolated ones.
"""
from __future__ import annotations

import atexit
import contextlib
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
# the sections of the pipeline's artifact (BENCH_ebft.json), all required
# the expert-batched entries of the masked matmul kernel (the MoE path's)
BATCHED = ("masked_matmul_batched", "masked_matmul_batched_dx", "masked_matmul_batched_dw",
           "masked_matmul_batched_dm")
OBS_REQUIRE = ["blocks", "phases", "perplexity", "ebft", "dispatch", "walk_phases", "mesh",
               "kernel_tuning"]


# every phase's line also goes to this file (the call's output keeps only
# its end): ``main`` starts it
PHASES_LOG = os.path.join(ROOT, "chiprun_out", "chip_smoke_phases.jsonl")
_log = {"on": False}


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _log["on"]:
        with open(PHASES_LOG, "a") as f:
            f.write(line + "\n")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 3, hold_ms: float = 20.0) -> float:
    """The card's mean time for ``fn``'s work, by a CUDA event pair around
    ``reps`` calls. The stream is first held for about ``hold_ms`` (a spin
    kernel, at the H100's 1.98 GHz boost clock) so that the host queues
    every call before the card reaches the first: a short kernel is timed
    without the host's launch overhead between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_ms * 1.98e6))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def fenced_ms(fn, reps: int) -> float:
    """The host's mean time for ``fn`` followed by a device synchronise:
    the latency of a step that the host waits for, launch overhead
    included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def check_close(name, out, ref, dtype: str) -> float:
    import torch

    tol = TOL[dtype]
    err = float((out.float() - ref.float()).abs().max())
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err}, tol {tol})")
    return err


def _refuses(name, fn) -> None:
    """``fn`` must raise ValueError: a wrapper on operands its kernel does
    not take, or a pruning method on a family it does not prune."""
    try:
        fn()
    except ValueError:
        return
    raise AssertionError(f"{name}: ran on what it must refuse")


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
# the moe path's 2-D masked leaves at DeepSeek-MoE-16B's widths, bf16, at
# the same M: the attention projections, the dense layer's MLP (N 10944 =
# 85.5 tiles of 128) and the two shared experts side by side (2 x 1408)
MOE_LEAVES = [("attn", (2048, 2048), 1), ("dense_w_up", (2048, 10944), 1),
              ("dense_w_down", (10944, 2048), 1), ("shared_w_up", (2048, 2816), 1),
              ("shared_w_down", (2816, 2048), 1)]
MMM_CASES = [(dt, "llama_7b", *leaf) for dt in ("float32", "bfloat16") for leaf in LEAVES] + \
    [("bfloat16", "deepseek_moe_16b", *leaf) for leaf in MOE_LEAVES]
MMM_KEYS = ("K", "N", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def phase_masked_matmul(g):
    """Kernel vs plain at the four Llama-7B linear shapes, f32 and bf16,
    and the moe path's five 2-D shapes in bf16 (``MOE_LEAVES``), plus an
    all-zero mask, a ragged shape and a strided x. Returns the Llama w_up
    bf16 row and the moe rows."""
    import torch

    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_plain

    summary, moe = None, {}
    for dtype, model, name, shape, n_red in MMM_CASES:
        dt = getattr(torch, dtype)
        R = math.prod(shape[:n_red])
        w = (torch.randn(shape, device="cuda", generator=g) / math.sqrt(R)).to(dt)
        m = torch.rand(shape, device="cuda", generator=g) < 0.3  # Wanda at 0.7 keeps 30%
        x = torch.randn(M_ROWS, R, device="cuda", generator=g).to(dt)
        w2, m2 = w.reshape(R, -1), m.reshape(R, -1)
        out = masked_matmul(x, w2, m2)
        ref = masked_matmul_plain(x, w2, m2)
        torch.cuda.synchronize()
        err = check_close(f"masked_matmul {model} {name} {dtype}", out, ref, dtype)
        ms = timed_ms(lambda: masked_matmul(x, w2, m2))
        plain_ms = timed_ms(lambda: masked_matmul_plain(x, w2, m2))
        wm = w2 * m2.to(dt)
        library_ms = timed_ms(lambda: torch.matmul(x, wm))
        K, N = w2.shape
        nbytes = (x.numel() + w2.numel() + M_ROWS * N) * x.element_size() + m2.numel()
        flops = 2.0 * M_ROWS * float(m2.sum())  # the products the mask keeps
        b_ms, b_by = bound_ms(nbytes, flops, dtype)
        row = dict(phase="masked_matmul", model=model, leaf=name, dtype=dtype, M=M_ROWS, K=K,
                   N=N, max_abs_err=err, tol=TOL[dtype], ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
        if dtype == "bfloat16" and name in ("w_up", "dense_w_up"):
            row["deterministic"] = check_repeat(
                f"masked_matmul {model} {name} {dtype}", lambda: masked_matmul(x, w2, m2), out)
        if dtype == "bfloat16" and name == "w_up":
            summary = row  # the slice's heaviest launch
        if model == "deepseek_moe_16b":
            moe[name] = row
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
    return summary, moe


def _causal_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    if not causal:
        return sq * sk
    return sum(min(sk, q_offset + i + 1) for i in range(sq))


# the serve phase's attention: a decode step of 8 slots x 32 heads against
# a 1024-position cache at len 700, and a 512-token prompt prefilled alone
# into its slot (32 heads, keys the whole cache, len 0)
SERVE_ATTN = {"decode": (256, 1, 1024, 128, True, 700), "prefill": (32, 512, 1024, 128, True, 0)}
# the moe path's attention (16 heads x 128): EBFT's microbatch of 8 x 2048,
# and its serve phase's decode step (8 slots against a 1024-position cache,
# at len 527) and 512-token prefill
MOE_ATTN = {"ebft": (128, 2048, 2048, 128, True, 0),
            "serve_decode": (128, 1, 1024, 128, True, 527),
            "serve_prefill": (16, 512, 1024, 128, True, 0)}
# the hybrid path's shared block (Zamba2-1.2B: 32 heads x 64): EBFT's and
# pretraining's microbatch of 8 x 2048, its serve phase's decode step (8
# slots against a 1024-position cache at len 527) and 512-token prefill
HYB_ATTN = {"ebft": (256, 2048, 2048, 64, True, 0),
            "serve_decode": (256, 1, 1024, 64, True, 527),
            "serve_prefill": (32, 512, 1024, 64, True, 0)}
# the vlm path's attention after the GQA repeat (8 x 32 heads x 128; Mistral's
# 8 KV heads each serve 4): EBFT's and pretraining's microbatch of 8 x 2048
# [1024 patches ; 1024 tokens] (the main path's shape), its greedy run's
# prefill of 8 x [1024 patches ; 512 tokens] into a 2048-position cache, and
# a decode step there at len 1550
VLM_ATTN = {"ebft": (256, 2048, 2048, 128, True, 0),
            "serve_prefill": (256, 1536, 2048, 128, True, 0),
            "serve_decode": (256, 1, 2048, 128, True, 1550)}
# the encdec path's attention (Seamless-M4T-medium: 16 heads x 64, EBFT's
# microbatch of 8): the encoder's bidirectional self-attention over F = 256
# frames, the decoder's cross-attention (2048 queries over the 256-frame
# memory, non-causal) and causal self-attention; serving's decode step over
# the memory and the cached self step (8 slots against a 1024-position
# cache at len 527)
ENCDEC_ATTN = {"enc": (128, 256, 256, 64, False, 0), "cross": (128, 2048, 256, 64, False, 0),
               "self": (128, 2048, 2048, 64, True, 0),
               "decode_cross": (128, 1, 256, 64, False, 0),
               "decode_self": (128, 1, 1024, 64, True, 527)}
# tiny_encdec's cross-attention on the card: 8 x 4 heads x 16, 64 queries
# over F = 8 frames, fewer keys than one key tile
TINY_CROSS = (32, 64, 8, 16, False, 0)
ATTN_KEYS = ("BH", "Sq", "Sk", "q_offset", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")


def phase_flash_attention(g):
    """Kernel vs plain: (256, 2048, 128) causal, a non-causal case and a
    q_offset > 0 case with Sq < Sk, the serve phase's decode and prefill
    shapes (``SERVE_ATTN``), the moe path's three (``MOE_ATTN``), the
    hybrid path's three at head width 64 (``HYB_ATTN``), the vlm path's
    prefill and decode (``VLM_ATTN``), the encdec path's five, non-causal
    with Sq != Sk among them (``ENCDEC_ATTN``; tiny_encdec's cross-attention
    over fewer keys than a tile, ``TINY_CROSS``), in f32 and bf16;
    plus every compiled head width at a small shape. In every case the row
    log-sum-exp that the forward writes for the backward is held to the
    plain one. Returns the (256, 2048, 128) causal bf16 row, the bf16
    serving rows and the bf16 moe, hybrid, vlm and encdec rows. The bound
    counts the keys a causal row can see (min(Sk, q_offset + Sq)); the
    library call is SDPA on the same inputs (at a decode shape over the
    len + 1 visible keys, non-causal: the same function)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_plain, flash_attention_plain,
    )

    cases = list(dict.fromkeys([
        (256, 2048, 2048, 128, True, 0), (64, 1024, 1024, 128, False, 0),
        (64, 512, 2048, 128, True, 1536), *SERVE_ATTN.values(), *MOE_ATTN.values(),
        *HYB_ATTN.values(), *VLM_ATTN.values(), *ENCDEC_ATTN.values(), TINY_CROSS,
        (8, 200, 333, 64, True, 133), (8, 128, 128, 32, False, 0), (16, 128, 128, 16, True, 0)]))
    summary, serve_rows, moe_rows, hyb_rows, vlm_rows, enc_rows = None, {}, {}, {}, {}, {}
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
            serving = next((n for n, c in SERVE_ATTN.items()
                            if c == (BH, Sq, Sk, d, causal, off)), None)
            moe = next((n for n, c in MOE_ATTN.items() if c == (BH, Sq, Sk, d, causal, off)),
                       None)
            hyb = next((n for n, c in HYB_ATTN.items() if c == (BH, Sq, Sk, d, causal, off)),
                       None)
            vlm = next((n for n, c in VLM_ATTN.items() if c == (BH, Sq, Sk, d, causal, off)),
                       None)
            encdec = next((n for n, c in ENCDEC_ATTN.items()
                           if c == (BH, Sq, Sk, d, causal, off)), None)
            if BH >= 64 or serving or moe or hyb or vlm or encdec:
                row["ms"] = timed_ms(lambda: flash_attention(q, k, v, **kw))
                row["plain_ms"] = timed_ms(lambda: flash_attention_plain(q, k, v, **kw))
                keys = min(Sk, off + Sq) if causal else Sk
                if off == 0:
                    row["library_ms"] = timed_ms(lambda: F.scaled_dot_product_attention(
                        q[None], k[None], v[None], is_causal=causal))
                elif Sq == 1:
                    row["library_ms"] = timed_ms(lambda: F.scaled_dot_product_attention(
                        q[None], k[None, :, :keys], v[None, :, :keys]))
                pairs = _causal_pairs(Sq, Sk, causal, off)
                nbytes = 2 * (q.numel() + BH * keys * d) * q.element_size()
                b_ms, b_by = bound_ms(nbytes, 4.0 * BH * d * pairs, dtype)
                row.update(bound_ms=b_ms, bound_by=b_by)
                if dtype == "bfloat16" and (BH, Sq, d, causal) == (256, 2048, 128, True):
                    row["deterministic"] = check_repeat(
                        tag, lambda: flash_attention(q, k, v, **kw), out)
                    summary = row
                if dtype == "bfloat16" and serving:
                    row["serving"] = serving
                    serve_rows[serving] = row
                if dtype == "bfloat16" and moe:
                    row["moe"] = moe
                    moe_rows[moe] = row
                if dtype == "bfloat16" and hyb:
                    row["hybrid"] = hyb
                    hyb_rows[hyb] = row
                if dtype == "bfloat16" and vlm:
                    row["vlm"] = vlm
                    vlm_rows[vlm] = row
                if dtype == "bfloat16" and encdec:
                    row["encdec"] = encdec
                    enc_rows[encdec] = row
            emit(row)
            del q, k, v, out, ref
    buf = torch.randn(3, 8 * 200 * 64 + 1, device="cuda", generator=g).to(torch.bfloat16)
    q, k, v = (buf[i, 1:].view(8, 200, 64) for i in range(3))
    _refuses("flash_attention unaligned bf16", lambda: flash_attention(q, k, v))
    emit(dict(phase="flash_attention", case="unaligned bf16", refused=True))
    return summary, serve_rows, moe_rows, hyb_rows, vlm_rows, enc_rows


def phase_masked_matmul_bwd(g):
    """dX = dY (W*M)^T and dW = (X^T dY)*M, kernel vs plain formula at the
    four Llama-7B leaf shapes with M = 16384 rows, f32 and bf16, and the
    moe path's five 2-D shapes in bf16, plus a ragged and a strided case;
    dW must be exactly 0 in every pruned slot. Both sum thousands of
    products: checked within tol x max |plain|. Returns the Llama w_up
    bf16 rows and the moe rows, by op."""
    import torch

    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.kernels.masked_matmul.ref import (
        masked_matmul_dw_plain, masked_matmul_dx_plain,
    )

    summary, moe = {}, {"dx": {}, "dw": {}}
    for dtype, model, name, shape, n_red in MMM_CASES:
        dt = getattr(torch, dtype)
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
        tag = f"{model} {name} {dtype}"
        if bool((dw[~m2] != 0).any()):
            raise AssertionError(f"masked_matmul_dw {tag}: a pruned slot is not 0")
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
            err = check_scaled(f"masked_matmul_{op} {tag}", out, plain(), dtype)
            kern = (lambda: MM.masked_matmul_dx(dy, w2, m2)) if op == "dx" else \
                (lambda: MM.masked_matmul_dw(x, dy, m2))
            b_ms, b_by = bound_ms(nbytes, 2.0 * M_ROWS * nnz, dtype)
            row = dict(phase="masked_matmul_bwd", op=op, model=model, leaf=name, dtype=dtype,
                       M=M_ROWS, K=K, N=N, max_abs_err=err, tol=TOL[dtype], ms=timed_ms(kern),
                       plain_ms=timed_ms(plain), library_ms=timed_ms(lib), bound_ms=b_ms,
                       bound_by=b_by)
            if dtype == "bfloat16" and name in ("w_up", "dense_w_up"):
                row["deterministic"] = check_repeat(f"masked_matmul_{op} {tag}", kern, out)
            if dtype == "bfloat16" and name == "w_up":
                summary[op] = row
            if model == "deepseek_moe_16b":
                moe[op][name] = row
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
    return summary, moe


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
    causal, non-causal, q_offset with Sq < Sk, the moe path's EBFT shape
    (128, 2048, 128) causal, the hybrid path's (256, 2048, 64) causal, the
    encdec path's three (its encoder's and cross-attention's non-causal,
    cross-attention's at Sq != Sk, and tiny_encdec's over fewer keys than
    a tile), and every head width, in f32 and bf16. Gradients checked within
    tol x max |plain|. Returns the (256, 2048, 128) bf16 row and the moe,
    hybrid and encdec ones."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain,
    )

    cases = [(256, 2048, 2048, 128, True, 0), (64, 1024, 1024, 128, False, 0),
             (64, 512, 2048, 128, True, 1536), MOE_ATTN["ebft"], HYB_ATTN["ebft"],
             ENCDEC_ATTN["enc"], ENCDEC_ATTN["cross"], ENCDEC_ATTN["self"], TINY_CROSS,
             (8, 200, 333, 64, True, 133), (8, 128, 128, 32, False, 0),
             (16, 128, 128, 16, True, 0)]
    summary, moe_rows, hyb_rows, enc_rows = None, {}, {}, {}
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
                if dtype == "bfloat16" and (BH, Sq, d, causal) == (256, 2048, 128, True):
                    row["deterministic"] = check_repeat(
                        f"flash_attention_bwd {(BH, Sq, Sk, d)} {dtype}",
                        lambda: FA.flash_attention_bwd(q, k, v, o, do, lse, **kw),
                        FA.flash_attention_bwd(q, k, v, o, do, lse, **kw))
                    summary = row
                if dtype == "bfloat16" and (BH, Sq, Sk, d, causal, off) == MOE_ATTN["ebft"]:
                    row["moe"] = "ebft"
                    moe_rows["ebft"] = row
                if dtype == "bfloat16" and (BH, Sq, Sk, d, causal, off) == HYB_ATTN["ebft"]:
                    row["hybrid"] = "ebft"
                    hyb_rows["ebft"] = row
                encdec = next((n for n, c in ENCDEC_ATTN.items()
                               if c == (BH, Sq, Sk, d, causal, off)), None)
                if dtype == "bfloat16" and encdec:
                    row["encdec"] = encdec
                    enc_rows[encdec] = row
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
    return summary, moe_rows, hyb_rows, enc_rows


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
            "flash_attention_bwd": (FA, "bwd_launches"), "nm_spmm": (NM, "launches"),
            "masked_matmul_batched": (MM, "batched_launches"),
            "masked_matmul_batched_dx": (MM, "batched_dx_launches"),
            "masked_matmul_batched_dw": (MM, "batched_dw_launches"),
            "masked_matmul_batched_dm": (MM, "batched_dm_launches")}


def reset_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def _epochs_computed(r, epochs: int) -> int:
    """The epochs of Adam steps block report ``r``'s EBFT ran on the card:
    on the fused path all ``epochs`` (those after a plateau are computed
    and their updates discarded), on the per-epoch path ``epochs_run``."""
    return epochs if r.path == "fused" else r.epochs_run


def llama_cfg(layers: int = 4, dtype: str = "bfloat16"):
    """Llama-7B at its published widths, cut to ``layers`` of its 32 layers,
    with the flash attention kernel."""
    from repro_torch.configs import get_config

    return get_config("llama_7b").replace(num_layers=layers, dtype=dtype, param_dtype=dtype,
                                          attn_impl="flash")


def run_path(tokens, params=None, tag="main", lora_cfg=None, **spec_kw):
    """``ebft_run.run`` on ``llama_cfg()`` with the run's own calibration
    segments, EBFT at the reference's EBFTConfig defaults (lr 2e-4, 10
    epochs, patience 2), ``spec_kw`` and the LoRA baseline's ``lora_cfg``
    (None: the driver's); every kernel count is set to 0
    just before it and read just after. Without ``params`` the run
    pretrains the seeded init for PRETRAIN_STEPS steps on batches of
    PRETRAIN_BATCH, and its pretraining is measured apart through the train
    step's stage hook (``on_stage``): the launches in it and its peak
    memory, read as its last step ends. With ``params`` (the pretrained
    weights) it runs from them and does not pretrain.

    The run is observed (``repro_torch.obs``): its artifact, in the
    reference's schema, is written to ``chiprun_out/BENCH_ebft.json`` (the
    main path) or ``chiprun_out/BENCH_ebft_<tag>.json`` and must pass
    ``validate_payload`` with every section ``ebft_run`` writes. Returns
    (cfg, spec, result, launches, wall seconds, the pretraining's record or
    None, the artifact); the peak memory counter starts at the run."""
    import torch

    from repro_torch.launch import ebft_run
    from repro_torch.launch.api import start_obs_run

    calib, _ = tokens
    cfg = llama_cfg()
    steps = 0 if params is not None else PRETRAIN_STEPS
    spec = ebft_run.RunSpec(arch="llama_7b", seed=0, seq=calib.shape[1],
                            calib_samples=len(calib), pretrain_steps=steps,
                            batch=PRETRAIN_BATCH, lr=2e-4, epochs=10, bench_out="",
                            kernel_tune="off", **spec_kw)
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
    obs_run = start_obs_run(spec, "ebft", "cuda", name=f"chip_smoke/{tag}", console=False)
    t0 = time.perf_counter()
    res = ebft_run.run(cfg, spec, "cuda", params=params, on_stage=on_stage, lora_cfg=lora_cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    summ = obs_run.payload()["metrics"]
    # the reference's CI gate: the tune loop's dispatches and the walk's two
    # stream advances within epochs + 2 a block
    artifact = finish_obs(obs_run, ebft_run.bench_record(spec, res, summ),
                          "BENCH_ebft.json" if tag == "main" else f"BENCH_ebft_{tag}.json",
                          max_dispatches_per_block=spec.epochs + 2)
    return cfg, spec, res, launches, wall, (pre or None), artifact


def finish_obs(obs_run, extra, name=None, max_dispatches_per_block=None):
    """Finish an obs run with ``extra`` (and write it to ``chiprun_out/name``);
    the artifact must pass ``validate_payload``, with every section the
    pipeline writes when ``extra`` is the pipeline's, and within
    ``max_dispatches_per_block`` where it is given."""
    from repro_torch.obs.run import validate_payload

    path = None
    if name:
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        path = os.path.join(ROOT, "chiprun_out", name)
    payload = obs_run.finish(extra=extra, summary_path=path)
    problems = validate_payload(payload, require=OBS_REQUIRE if "phases" in extra else list(extra),
                                max_dispatches_per_block=max_dispatches_per_block)
    if problems:
        raise AssertionError(f"obs artifact {name}: {problems}")
    return payload


def phase_slice(method_cfg, tokens, params=None, microbatch=8, every_block_drops=True):
    """The slice on Llama-7B (4 of 32 layers, bf16, flash attention):
    pretraining (without ``params``; ``phase_pretrain`` reports it), then
    prune, EBFT with the reference's EBFTConfig defaults (lr 2e-4, 10
    epochs, patience 2), evaluate; then its masks held against a second
    prune (``phase_mask_flips``). ``tokens`` are the run's own calibration
    and eval segments. Every kernel count is set to 0 just before the run;
    returns the counts read just after it, the run, its config, the
    pretraining's record and the run's obs artifact. On the main path (the run that pretrains) EBFT
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
    cfg, spec, res, launches, wall, pre, artifact = run_path(
        tokens, params, tag="main" if params is None else pattern.replace(":", "_"),
        method="wanda", sparsity=sparsity, pattern=pattern)
    L = cfg.num_layers
    n_cal = math.ceil(len(calib) / microbatch)
    n_ev = math.ceil(ebft_run.EVAL_SAMPLES / microbatch)
    # tuning steps, all blocks
    steps = sum(_epochs_computed(r, spec.epochs) for r in res.reports) * n_cal
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
                "flash_attention_bwd": steps + L * spec.pretrain_steps, "nm_spmm": 0,
                **{k: 0 for k in BATCHED}}
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
    return launches, res, cfg, pre, artifact


def kernel_stats(metrics) -> dict:
    """Per kernel row, from an obs artifact's metrics: the launches booked
    (``calls``), the mean and median of their CUDA-event times in ms, their
    sum in s, the dense-equivalent FLOPs and bytes booked (the reference's
    accounting: 2·M·K·N for every masked GEMM, which PERF.md's ``Bound``
    column does not use), and the roofline ideal of the last launch."""
    out = {}
    for key, h in metrics.items():
        if not (key.startswith("kernels/") and key.endswith("/exec_s")):
            continue
        name = key[len("kernels/"):-len("/exec_s")]
        base = f"kernels/{name}"
        out[name] = dict(calls=int(metrics[f"{base}/calls"]["value"]), mean_ms=h["mean"] * 1e3,
                         p50_ms=h["p50"] * 1e3, total_s=h["sum"],
                         flops=metrics[f"{base}/flops"]["value"],
                         bytes=metrics[f"{base}/bytes"]["value"],
                         last_launch_roofline_ideal_ms=(
                             metrics[f"{base}/roofline_ideal_s"]["last"] * 1e3))
    return out


def top_spans(artifact, depth: int = 2):
    """The span forest's top ``depth`` levels: name, seconds and attrs."""
    def node(n, d):
        out = dict(name=n["name"], s=n["duration_s"], **n.get("attrs", {}))
        if d > 1 and n.get("children"):
            out["children"] = [node(c, d - 1) for c in n["children"]]
        return out
    return [node(n, depth) for n in artifact["trace"]]


def _phase_span(artifact, name, **attrs):
    return next(n for n in artifact["trace"] if n["name"] == name and
                all(n.get("attrs", {}).get(k) == v for k, v in attrs.items()))


def phase_obs(cfg, res, artifact, launches, tokens):
    """What the main path's obs artifact shows, and what obs costs. Prints
    the walk's phase seconds (``walk_phases``), the span tree's top two
    levels, and per kernel its in-run CUDA-event times, which must count
    exactly the launches the wrappers counted. Then reruns the main path's
    EBFT (``ebft.finetune`` on the same dense and pruned weights, masks and
    calibration segments) with obs off and with obs on, each from an empty
    peak-memory counter, and requires the tuned weights of both to equal
    the main run's (obs on) bit for bit. The obs-on rerun splits EBFT's
    time into its kernels' event time and the rest."""
    import torch

    from repro_torch import tree as T
    from repro_torch.core import ebft
    from repro_torch.models.model import build
    from repro_torch.obs.run import start_run

    stats = kernel_stats(artifact["metrics"])
    for name, n in launches.items():
        if stats.get(name, {}).get("calls", 0) != n:
            raise AssertionError(f"obs: {name} booked {stats.get(name, {}).get('calls')} "
                                 f"launches, the wrapper counted {n}")
    calib, _ = tokens
    model = build(cfg)
    ecfg = ebft.EBFTConfig(lr=2e-4, epochs=10)
    reruns = {}
    for mode in ("off", "on"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start_mem = torch.cuda.memory_allocated()
        obs_run = start_run("chip_smoke/ebft_rerun", config="llama_7b", device="cuda",
                            console=False) if mode == "on" else None
        t0 = time.perf_counter()
        tuned, reports = ebft.finetune(model, res.dense, res.pruned, res.masks, calib, ecfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        row = dict(seconds=secs, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   peak_over_start_gib=(torch.cuda.max_memory_allocated() - start_mem) / 2**30)
        if obs_run is not None:
            rerun = finish_obs(obs_run, {"blocks": [r.asdict() for r in reports]})
            k = kernel_stats(rerun["metrics"])
            row.update(kernel_s=sum(v["total_s"] for v in k.values()),
                       kernels={n: dict(calls=v["calls"], total_s=v["total_s"])
                                for n, v in k.items()})
            row["rest_s"] = secs - row["kernel_s"]
        bitwise = all(torch.equal(a, T.get_path(res.tuned, p))
                      for p, a in T.leaves_with_path(tuned))
        row["tuned_bitwise_equal_to_main_run"] = bitwise
        reruns[mode] = row
        del tuned, reports
        if not bitwise:
            raise AssertionError(f"obs: the EBFT rerun with obs {mode} tuned other bits "
                                 "than the main run")
    ebft_span = _phase_span(artifact, "phase/ebft")
    emit(dict(phase="obs", walk_phases=artifact["walk_phases"],
              spans=top_spans(artifact), kernels_in_run=stats,
              ebft_split=dict(phase_s=res.phases["ebft"], kernel_s=ebft_span["attrs"]["kernel_s"],
                              kernel_launches=ebft_span["attrs"]["kernel_launches"],
                              rest_s=res.phases["ebft"] - ebft_span["attrs"]["kernel_s"],
                              walk_phases=artifact["walk_phases"]),
              dispatch=artifact["dispatch"], ebft_reruns=reruns,
              artifact="chiprun_out/BENCH_ebft.json"))
    return stats


FUSED_RUNS = (("fused_prefetch1", dict()), ("fused_prefetch0", dict(prefetch_depth=0)),
              ("legacy", dict(fused_epochs=False)))
# at the paper's 1e-3 no block of the main path plateaus (its blocks gain
# 1.4-13% an epoch on the H100, PERF.md); at 5e-2 blocks 1-3 stop after 2
# epochs and block 0 runs all 10, each at least 1.5 points off the threshold
FUSED_REL_TOL = 5e-2


def phase_fused(cfg, res, tokens):
    """The reference's default EBFT path against its fallbacks, on the main
    path's pretrained weights, Wanda 0.7 masks and calibration segments
    (Llama-7B widths, 4 layers, 16 segments of 2048, bf16; lr 2e-4, 10
    epochs, patience 2, rel_tol ``FUSED_REL_TOL``, so that blocks stop
    early and the fused loop's discarded epochs show): the fused loop with
    the teacher prefetched one visit ahead on a side stream (the default),
    the fused loop with the teacher on the walk's stream just before each
    visit, and the per-epoch loop. Each runs in an obs run of its own. The
    three must give the same epochs, stops and histories and the same
    tuned weights bit for bit (the largest absolute difference is
    printed). Per run: the EBFT wall, the
    walk's teacher, tune and student seconds, dispatches and host syncs
    per block, peak GiB (and over what was allocated at its start: the
    earlier runs' tuned weights are kept), the epochs computed after a plateau (the fused
    loop computes all 10 and discards their updates) and the prefetcher's
    in-flight targets."""
    import torch

    from repro_torch import tree as T
    from repro_torch.core import ebft
    from repro_torch.models.model import build
    from repro_torch.obs.run import start_run

    calib, _ = tokens
    model = build(cfg)
    out, rows = {}, {}
    for name, kw in FUSED_RUNS:
        ecfg = ebft.EBFTConfig(lr=2e-4, epochs=10, patience=2, rel_tol=FUSED_REL_TOL, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start_mem = torch.cuda.memory_allocated()
        obs_run = start_run(f"chip_smoke/fused/{name}", config="llama_7b", device="cuda",
                            console=False)
        t0 = time.perf_counter()
        tuned, reports = ebft.finetune(model, res.dense, res.pruned, res.masks, calib, ecfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        art = finish_obs(obs_run, {"blocks": [r.asdict() for r in reports]})
        m = art["metrics"]
        out[name] = (tuned, reports)
        rows[name] = dict(
            ebft_s=wall, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            peak_over_start_gib=(torch.cuda.max_memory_allocated() - start_mem) / 2**30,
            walk_phases={p: m[f"ebft/walk/{p}_s"]["sum"] for p in ("teacher", "tune", "student")},
            walk_compile={p: m[f"ebft/walk/{p}_compile_s"]["sum"]
                          for p in ("teacher", "tune", "student")},
            paths=[r.path for r in reports], dispatches=[r.dispatches for r in reports],
            host_syncs=[r.host_syncs for r in reports],
            walk_dispatches=m["ebft/walk/dispatches"]["value"],
            walk_host_syncs=m["ebft/walk/host_syncs"]["value"],
            epochs_run=[r.epochs_run for r in reports],
            early_stop=[r.early_stop for r in reports],
            epochs_after_stop=sum(_epochs_computed(r, ecfg.epochs) - r.epochs_run
                                  for r in reports),
            prefetch_inflight_max=m.get("ebft/walk/prefetch_inflight", {}).get("max"))
    base_tuned, base_reports = out["fused_prefetch1"]
    worst, equal = 0.0, True
    for name, (tuned, reports) in out.items():
        if [(r.epochs_run, r.early_stop, r.history) for r in reports] != \
                [(r.epochs_run, r.early_stop, r.history) for r in base_reports]:
            equal = False
        for path, t in T.leaves_with_path(tuned):
            b = T.get_path(base_tuned, path)
            equal = equal and torch.equal(t, b)
            worst = max(worst, float((t.float() - b.float()).abs().max()))
    emit(dict(phase="fused", arch="llama_7b", num_layers=cfg.num_layers, dtype="bfloat16",
              calib_samples=len(calib), seq=calib.shape[1], lr=2e-4, epochs=10, patience=2,
              rel_tol=FUSED_REL_TOL, runs=rows, bit_equal=equal, max_abs_diff=worst))
    if not equal:
        raise AssertionError(f"fused: the three EBFT paths differ (max abs {worst})")
    want = dict(fused_prefetch1=("fused", 1, 1), fused_prefetch0=("fused", 1, 1))
    for name, (path, disp, syncs) in want.items():
        r = rows[name]
        if set(r["paths"]) != {path} or set(r["dispatches"]) != {disp} \
                or set(r["host_syncs"]) != {syncs}:
            raise AssertionError(f"fused: {name} ran {r['paths']} with dispatches "
                                 f"{r['dispatches']}, host syncs {r['host_syncs']}")
    if set(rows["legacy"]["paths"]) != {"legacy"}:
        raise AssertionError(f"fused: the legacy run took {rows['legacy']['paths']}")
    if rows["fused_prefetch1"]["prefetch_inflight_max"] > 2:
        raise AssertionError(f"fused: {rows['fused_prefetch1']['prefetch_inflight_max']} "
                             "visits' targets in flight at depth 1")


# the serve phase: Server.serve at Llama-7B width over 8 slots of a
# 1024-position cache, 32 requests of 512 tokens from the synthetic corpus,
# 64 new tokens each; the teacher-forced check decodes 32 steps
SERVE = dict(slots=8, prompt_len=512, max_new=64, max_len=1024, requests=32, forced_steps=32)
SERVE_NAMES = ["serve/prefill/exec_s", "serve/decode/exec_s", "serve/queue_depth",
               "serve/batch_occupancy", "serve/tokens", "serve/requests", "serve/tokens_per_s"]


def _serve_forced(model, params, prompts, tag, conf=SERVE, extra=None):
    """Prefill ``prompts`` (with ``extra``, the batch's other arrays: a
    VLM's patches, in front of the prompt) into a cache of conf["max_len"]
    positions, then
    conf["forced_steps"] greedy decode steps. Each step's logits (the
    prefill's too) must equal the last-position logits of a no-cache
    ``forward`` over the same tokens within the bf16 tolerance; where the
    two greedy tokens differ, the no-cache logits' top-2 margin must be
    below that tolerance at the top logit (atol + rtol x |top|). At the
    last step both are also held beside the f32 no-cache forward (the same
    weights cast to f32): the largest ratio of each one's distance from it
    to that tolerance, to show how far two bf16 paths round apart."""
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.models.model import build

    tol = TOL["bfloat16"]
    extra = extra or {}
    seq = torch.as_tensor(np.stack(prompts), device="cuda").long()
    state = model.init_serve_state(len(prompts), conf["max_len"], "cuda")
    logits, state = model.prefill(params, {"tokens": seq, **extra}, state)
    errs, flips = [], []
    for step in range(conf["forced_steps"] + 1):
        ref = model.forward(params, {"tokens": seq, **extra})[:, -1]
        got = logits[:, 0]
        errs.append(check_close(f"serve {tag}: step {step}'s logits against the no-cache "
                                "forward", got, ref, "bfloat16"))
        tok = got.argmax(-1)
        top = ref.topk(2, dim=-1).values
        margin = top[:, 0] - top[:, 1]
        differ = tok != ref.argmax(-1)
        if bool((differ & (margin >= tol + tol * top[:, 0].abs())).any()):
            raise AssertionError(f"serve {tag}: step {step}'s greedy token differs from the "
                                 f"no-cache forward's at a top-2 margin {margin.tolist()}")
        flips += [(step, float(m)) for m in margin[differ].tolist()]
        if step == conf["forced_steps"]:
            model32 = build(model.cfg.replace(dtype="float32", param_dtype="float32"))
            ref32 = model32.forward(T.tree_map(lambda t: t.float(), params),
                                    {"tokens": seq, **extra})[:, -1]
            vs_f32 = {name: float(((x.float() - ref32).abs() / (tol + tol * ref32.abs())).max())
                      for name, x in (("cached", got), ("no_cache", ref))}
            break
        seq = torch.cat([seq, tok[:, None]], dim=1)
        logits, state = model.decode_step(params, tok[:, None], state)
    del logits, state, ref, ref32
    return dict(max_abs_err=max(errs), tol=tol, greedy_flips=flips,
                last_step_ratio_to_tol_vs_f32=vs_f32)


def _serve_forced_f32(model, params, prompts, tag, conf, rel=1e-4):
    """``_serve_forced`` in f32 (``model`` and ``params`` cast to f32): after
    the prefill and each of conf["forced_steps"] greedy decode steps the
    cached logits must equal the last-position logits of a no-cache
    ``forward`` within ``rel`` x max(1, max |logit|), and where the two
    greedy tokens differ the no-cache top-2 margin must be below that. A
    Mamba block decodes by the one-step recurrence and runs a prompt by the
    chunked scan, so in bf16 the two round apart over the layers; in f32
    they differ only in the order of their sums."""
    import numpy as np
    import torch

    seq = torch.as_tensor(np.stack(prompts), device="cuda").long()
    state = model.init_serve_state(len(prompts), conf["max_len"], "cuda")
    logits, state = model.prefill(params, {"tokens": seq}, state)
    errs, flips = [], []
    for step in range(conf["forced_steps"] + 1):
        ref = model.forward(params, {"tokens": seq})[:, -1]
        got = logits[:, 0]
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max()) / scale
        if not err <= rel:
            raise AssertionError(f"serve {tag}: step {step}'s cached logits differ from the "
                                 f"no-cache forward by {err:.2e} x max |logit| (limit {rel})")
        errs.append(err)
        tok = got.argmax(-1)
        top = ref.topk(2, dim=-1).values
        margin = top[:, 0] - top[:, 1]
        differ = tok != ref.argmax(-1)
        if bool((differ & (margin >= rel * scale)).any()):
            raise AssertionError(f"serve {tag}: step {step}'s greedy token differs from the "
                                 f"no-cache forward's at a top-2 margin {margin.tolist()}")
        flips += [(step, float(m)) for m in margin[differ].tolist()]
        if step == conf["forced_steps"]:
            break
        seq = torch.cat([seq, tok[:, None]], dim=1)
        logits, state = model.decode_step(params, tok[:, None], state)
    del logits, state, ref
    return dict(dtype="float32", max_rel_err=max(errs), rel=rel, greedy_flips=flips)


def _profile_step(step) -> dict:
    """One ``step`` under ``torch.profiler``: the operations it puts on the
    card (kernels, copies, fills), their summed card time, that time by
    kind (the attention kernel, GEMMs, the rest) and the costliest
    names. ``device_ops`` is None where the profiler saw no device event."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ops = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    if not ops:
        return dict(device_ops=None)

    def kind(name):
        n = name.lower()
        if "flash_fwd" in n:
            return "attention"
        return "gemm" if any(t in n for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")) \
            else "other"

    by_kind, by_name = collections.Counter(), collections.defaultdict(lambda: [0, 0.0])
    for name, ms in ops:
        by_kind[kind(name)] += ms
        by_name[name][0] += 1
        by_name[name][1] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(device_ops=len(ops), busy_ms=sum(ms for _, ms in ops),
                busy_ms_by_kind=dict(by_kind),
                top=[dict(name=n[:80], count=c, ms=ms) for n, (c, ms) in top])


def _serve_split(model, params, prompts):
    """A decode step (8 slots, len 700 of 1024) and a one-prompt prefill
    (512 tokens into an empty slot): the step's latency with a synchronise
    after each (``fenced_ms``, as the serve loop waits for each step), the
    card's time for it with the host queued ahead (``timed_ms`` of one step
    a window, the median of 5: a window of several steps would hold more
    launches than CUDA's queue of pending launches, and the card would
    then wait on the host), and the card's time for its parts, each timed
    alone on the same operands: the attention kernel on the cache slabs,
    the block's plain linears (q, k, v, o and the SwiGLU MLP) and the LM
    head, x the layers where it runs per layer. ``rest_device_ms``
    (embedding, norms, RoPE, the cache writes) is the card's time less the
    parts; ``host_ms`` is the latency less the card's time. ``profile``
    counts the step's device operations under ``torch.profiler``
    (``_profile_step``)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import layers as LY
    from repro_torch.models import transformer as TR

    cfg = model.cfg
    L, H, hd, d = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim, cfg.d_model
    ml, dt = SERVE["max_len"], TR.torch_dtype(cfg.dtype)
    bp = TR.slice_block(params["blocks"], 0)
    head = params["head"]["w"]
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for kind, (BH, Sq, Sk, _, _, off) in SERVE_ATTN.items():
        nb = BH // H
        toks = torch.as_tensor(np.stack(prompts[:nb])[:, :Sq], device="cuda").long()
        state = model.init_serve_state(nb, ml, "cuda")
        if kind == "decode":  # fill the cache to len ``off``: two prefills
            fill = torch.as_tensor(np.concatenate([np.stack(prompts[:nb]),
                                                   np.stack(prompts[nb:2 * nb])], axis=1),
                                   device="cuda").long()
            for a, b in ((0, SERVE["prompt_len"]), (SERVE["prompt_len"], off)):
                _, state = model.prefill(params, {"tokens": fill[:, a:b]}, state)
            step = lambda: model.decode_step(params, toks, state)  # noqa: E731
        else:
            step = lambda: model.prefill(params, {"tokens": toks}, state)  # noqa: E731
        assert state["len"] == off
        x = torch.randn(nb, Sq, d, device="cuda", generator=g).to(dt)
        o = torch.randn(nb, Sq, H, hd, device="cuda", generator=g).to(dt)
        q = torch.randn(BH, Sq, hd, device="cuda", generator=g).to(dt)
        kc, vc = state["k"][0].view(BH, ml, hd), state["v"][0].view(BH, ml, hd)
        row = dict(step_ms=fenced_ms(step, reps=10),
                   step_device_ms=statistics.median(
                       timed_ms(step, reps=1, hold_ms=50.0) for _ in range(5)),
                   attention_ms=L * timed_ms(lambda: flash_attention(
                       q, kc, vc, causal=True, q_offset=off), reps=10),
                   linears_ms=L * timed_ms(lambda: (
                       LY.qkv_proj(bp["attn"], x), LY.out_proj(bp["attn"], o),
                       LY.mlp_block(bp["mlp"], x, cfg.mlp_act)), reps=10),
                   head_ms=timed_ms(lambda: LY.lm_logits(head, x[:, -1:]), reps=10))
        row["rest_device_ms"] = (row["step_device_ms"] - row["attention_ms"]
                                 - row["linears_ms"] - row["head_ms"])
        row["host_ms"] = row["step_ms"] - row["step_device_ms"]
        row["profile"] = _profile_step(step)
        out[kind] = row
        del state, kc, vc
    return out


def _serve_run(model, params, prompts, tag, conf=SERVE, arch="llama_7b", attn_layers=None):
    """``Server.serve`` of conf["requests"] requests over conf["slots"]
    slots in an obs run opened as ``launch/serve`` opens it; every kernel
    count is set to 0 just before it and read just after. Raises unless
    every request gets conf["max_new"] tokens, the highest ``len`` stays
    within the cache, the flash attention forward ran A x (prefills +
    decode steps) times (A = ``attn_layers``, by default every layer; the
    hybrid's shared-block sites, none in the SSM family) and no other
    kernel ran, obs booked every launch,
    and the artifact (``chiprun_out/BENCH_serve_<tag>.json``) passes
    ``validate_payload`` with the ``served`` section and the ``serve/*``
    names."""
    import dataclasses

    import torch

    from repro_torch.launch.api import start_obs_run
    from repro_torch.launch.serve import ServeSpec
    from repro_torch.serving.decode import Request, Server

    lens = []

    def decode_step(p, tok, state):
        logits, state = model.decode_step(p, tok, state)
        lens.append(state["len"])
        return logits, state

    server = Server(dataclasses.replace(model, decode_step=decode_step), params,
                    batch_size=conf["slots"], max_len=conf["max_len"])
    reqs = [Request(uid=i, prompt=p, max_new=conf["max_new"]) for i, p in enumerate(prompts)]
    spec = ServeSpec(arch=arch, requests=len(reqs), slots=conf["slots"],
                     prompt_len=conf["prompt_len"], max_new=conf["max_new"],
                     max_len=conf["max_len"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start_mem = torch.cuda.memory_allocated()
    reset_counts()
    obs_run = start_obs_run(spec, "serve", "cuda", name=f"chip_smoke/serve_{tag}", console=False)
    t0 = time.perf_counter()
    res = server.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    toks = sum(len(v) for v in res.values())
    art = finish_obs(obs_run, {"served": {"requests": len(res), "tokens": toks,
                                          "tokens_per_s": toks / wall}},
                     f"BENCH_serve_{tag}.json")
    m = art["metrics"]
    L = model.cfg.num_layers if attn_layers is None else attn_layers
    expected = {k: 0 for k in launches}
    expected["flash_attention"] = L * (len(reqs) + len(lens))
    booked = kernel_stats(m).get("flash_attention", {}).get("calls", 0)
    row = dict(requests=len(res), tokens=toks, wall_s=wall,
               tokens_per_s=m["serve/tokens_per_s"]["last"],
               prefill_ms=m["serve/prefill/exec_s"]["mean"] * 1e3,
               prefill_first_ms=m["serve/prefill/compile_s"]["last"] * 1e3,
               decode_ms=m["serve/decode/exec_s"]["mean"] * 1e3,
               decode_p50_ms=m["serve/decode/exec_s"]["p50"] * 1e3,
               decode_steps=len(lens), top_len=max(lens), max_len=conf["max_len"],
               occupancy=m["serve/batch_occupancy"]["mean"], peak_mem_gib=peak / 2**30,
               peak_over_start_gib=(peak - start_mem) / 2**30,
               launches=launches, flash_booked=booked,
               flash_in_run_ms=kernel_stats(m).get("flash_attention", {}).get("mean_ms"),
               artifact=f"chiprun_out/BENCH_serve_{tag}.json")
    if sorted(res) != list(range(len(reqs))) or \
            any(len(v) != conf["max_new"] for v in res.values()):
        raise AssertionError(f"serve {tag}: {len(res)} requests served, token counts "
                             f"{sorted({len(v) for v in res.values()})}")
    if max(lens) > conf["max_len"]:
        raise AssertionError(f"serve {tag}: len reached {max(lens)} past the cache's "
                             f"{conf['max_len']}")
    if launches != expected or booked != launches["flash_attention"]:
        raise AssertionError(f"serve {tag}: launches {launches} (obs booked {booked} "
                             f"attention launches), expected {expected}")
    missing = [n for n in SERVE_NAMES if n not in m]
    if missing or [n["name"] for n in art["trace"]] != ["serve/batch"]:
        raise AssertionError(f"serve {tag}: the artifact lacks {missing} or its serve/batch span")
    return row


def phase_serve(cfg, weights):
    """Serving at Llama-7B width (4 layers, bf16, the flash attention
    kernel at prefill and decode shapes) with each of ``weights`` (tag ->
    params): the teacher-forced check (``_serve_forced``, on the first
    SERVE["slots"] prompts), then continuous batching (``_serve_run``);
    with the first weights also the split of a decode step and a prefill
    (``_serve_split``). Then ``launch/serve.main`` in process on the card
    at tiny_dense with Wanda 0.5 (its artifact must pass
    ``validate_payload``). Returns the flash attention launches of the
    first weights' ``Server.serve`` run, by kernel."""
    import numpy as np
    import torch

    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus
    from repro_torch.launch import serve
    from repro_torch.models.model import build
    from repro_torch.obs.run import validate_payload

    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    rng = np.random.default_rng(0)
    prompts = [corpus.sample(rng, SERVE["prompt_len"]) for _ in range(SERVE["requests"])]
    model = build(cfg)
    launches = None
    for i, (tag, params) in enumerate(weights.items()):
        t0 = time.perf_counter()
        row = dict(phase="serve", weights=tag, arch="llama_7b", num_layers=cfg.num_layers,
                   reduced="num_layers 32->4", dtype=cfg.dtype, attn_impl=cfg.attn_impl,
                   **SERVE)
        row["forced"] = _serve_forced(model, params, prompts[:SERVE["slots"]], tag)
        if i == 0:
            row["split"] = _serve_split(model, params, prompts)
        row["serve"] = _serve_run(model, params, prompts, tag)
        row["phase_s"] = time.perf_counter() - t0
        emit(row)
        if launches is None:
            launches = row["serve"]["launches"]
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    bench = os.path.join(ROOT, "chiprun_out", "BENCH_serve_tiny.json")
    t0 = time.perf_counter()
    res = serve.main(["--arch", "tiny_dense", "--requests", "5", "--slots", "2",
                      "--sparse", "0.5", "--bench-out", bench])
    with open(bench) as f:
        art = json.load(f)
    problems = validate_payload(art, require=["served"])
    if problems or sorted(res) != list(range(5)) or any(len(v) != 16 for v in res.values()) \
            or art["manifest"]["jax_backend"] != "cuda":
        raise AssertionError(f"serve main: {problems}, {res}")
    emit(dict(phase="serve_main", argv="--arch tiny_dense --requests 5 --slots 2 --sparse 0.5",
              seconds=time.perf_counter() - t0, served=art["served"],
              device=art["manifest"]["device_name"],
              artifact="chiprun_out/BENCH_serve_tiny.json"))
    return launches


def phase_nm_pack(res, cfg, tokens, launches, microbatch=8):
    """The 2:4 run's tuned weights re-packed with ``nm_compress`` and run
    through ``nm_spmm`` on the run's own block inputs (the tuned student
    stream's first calibration microbatch, M = 16384 rows), held against
    ``masked_matmul`` on the same tuned weights, bit for bit (both run the
    same wgmma main loop on the same operands), and against the plain
    version element by element within tol x (|x| @ |w * m|) of that
    element. Adds the nm_spmm launches to ``launches`` (the path's counts,
    set to 0 before its run). The 28 launches run inside an obs run, so
    they carry in-run event times; returns the kernel row and that run's
    artifact."""
    import torch

    from repro_torch.obs.run import start_run

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
    obs_run = start_run("chip_smoke/nm_pack", config="llama_7b", pattern="2:4", device="cuda",
                        console=False)
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
    artifact = finish_obs(obs_run, {"nm_pack": {"leaves": len(errs)}}, "BENCH_nm_pack.json")
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
    return summary, artifact


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
    cfg, spec, res, launches, wall, _, artifact = run_path(
        tokens, dense, tag="A", method="sparsegpt", sparsity=sparsity, baselines="dsnot,mask")
    peak = torch.cuda.max_memory_allocated() / 2**30
    L = cfg.num_layers
    n_cal = math.ceil(len(calib) / microbatch)
    n_ev = math.ceil(ebft_run.EVAL_SAMPLES / microbatch)
    steps = sum(_epochs_computed(r, spec.epochs) for r in res.reports) * n_cal
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
                "flash_attention_bwd": steps + mt_steps, "nm_spmm": 0,
                **{k: 0 for k in BATCHED}}
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
    return launches, artifact


# path B's LoRA steps: ebft_run's default 200 cut to keep the script
# inside its limit (at 200, with every family at its earlier depth, the
# script took 1216.7 s; 100 until the families' mesh phase joined: PERF.md §4)
B_LORA_STEPS = 10


def phase_path_b(tokens, dense, microbatch=8):
    """Path B: FLAP at 26% structured sparsity -> EBFT -> B_LORA_STEPS LoRA
    steps (the paper's structured comparison of EBFT against LoRA), on Llama-7B
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
    import dataclasses

    import torch

    from repro_torch import tree as T
    from repro_torch.core.masks import prune
    from repro_torch.core.pruning.flap import remaining_param_fraction
    from repro_torch.launch import ebft_run
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP

    sparsity = 0.26
    calib, _ = tokens
    cfg, spec, res, launches, wall, _, artifact = run_path(
        tokens, dense, tag="B", lora_cfg=dataclasses.replace(ebft_run.LORA, steps=B_LORA_STEPS),
        method="flap", sparsity=sparsity, baselines="lora")
    peak = torch.cuda.max_memory_allocated() / 2**30
    L, H = cfg.num_layers, cfg.num_heads
    n_cal = math.ceil(len(calib) / microbatch)
    n_ev = math.ceil(ebft_run.EVAL_SAMPLES / microbatch)
    steps = sum(_epochs_computed(r, spec.epochs) for r in res.reports) * n_cal
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
                "flash_attention_bwd": steps + L * n_lora, "nm_spmm": 0,
                **{k: 0 for k in BATCHED}}
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
    return launches, artifact


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


def phase_train_obs(cfg, steps=10):
    """``launch/train``'s ``run`` at the main path's width and depth (AdamW
    at lr 3e-3 on batches of PRETRAIN_BATCH x 2048 tokens, from the seeded
    init) with obs off, on, on, off: seconds per step over the whole of
    ``Trainer.run``, peak memory, and with obs on the profiled step's
    fenced steady-state time (``train/step/exec_s``) and the attention
    launches booked. With obs on the step is fenced (``ProfiledFn``), so
    the host's next batch no longer overlaps the card's step; this phase
    measures what that costs. Raises unless the four runs record the same
    losses bit for bit, every loss is finite, the obs runs book every
    attention launch and leave no event pair pending, and the first obs
    run's artifact, with its ``trained`` section, passes
    ``validate_payload``."""
    import torch

    from repro_torch.launch import train
    from repro_torch.launch.api import start_obs_run
    from repro_torch.obs import profile as OP

    rows = []
    for i, mode in enumerate(("off", "on", "on", "off")):
        spec = train.TrainSpec(arch="llama_7b", steps=steps, batch=PRETRAIN_BATCH, seq=2048,
                               lr=3e-3, no_obs=mode == "off")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        obs_run = start_obs_run(spec, "train", "cuda", name="chip_smoke/train", console=False)
        res = train.run(cfg, spec, "cuda", say=lambda line: None)
        launches = read_counts()
        row = dict(obs=mode, seconds=res.seconds, s_per_step=res.seconds / steps,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                   history=res.history, pending_pairs=len(OP._PENDING))
        if obs_run is not None:
            art = finish_obs(obs_run, {"trained": train.trained_record(spec, res)},
                             "BENCH_train.json" if i == 1 else None)
            m = art["metrics"]
            row.update(step_exec_s_mean=m["train/step/exec_s"]["mean"],
                       step_exec_s_p50=m["train/step/exec_s"]["p50"],
                       step_first_s=m["train/step/compile_s"]["last"],
                       booked={k: int(m[f"kernels/{k}/calls"]["value"])
                               for k in ("flash_attention", "flash_attention_bwd")})
            if row["booked"] != {k: launches[k] for k in row["booked"]}:
                raise AssertionError(f"train_obs: booked {row['booked']}, launched {launches}")
        rows.append(row)
        del res
    emit(dict(phase="train_obs", arch="llama_7b", num_layers=cfg.num_layers, steps=steps,
              batch=PRETRAIN_BATCH, seq=2048, runs=rows,
              s_per_step_off=[r["s_per_step"] for r in rows if r["obs"] == "off"],
              s_per_step_on=[r["s_per_step"] for r in rows if r["obs"] == "on"],
              artifact="chiprun_out/BENCH_train.json"))
    if any(r["history"] != rows[0]["history"] for r in rows):
        raise AssertionError("train_obs: obs on and off recorded different losses: "
                             f"{[r['history'] for r in rows]}")
    if not all(math.isfinite(loss) for _, loss in rows[0]["history"]):
        raise AssertionError(f"train_obs: a loss is not finite: {rows[0]['history']}")
    if any(r["pending_pairs"] for r in rows):
        raise AssertionError("train_obs: event pairs left pending after a training run")


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


def phase_tiny_ebft(model, weights, masks_cpu, calib, ev, rel=1e-4, arch="tiny_dense",
                    ecfg=None, calib_x=None, ev_x=None):
    """EBFT on tiny_dense in f32 from the same weights and the same (CPU)
    masks on the card (kernels, their backward; the fused loop with the
    teacher on a side stream) and on the CPU (plain versions, the fused
    loop): every block on the fused path on both, equal epochs_run and
    early stops per block, loss histories and the EBFT perplexity within
    rel 1e-4 (f32, sums taken in another order). ``ecfg`` defaults to the tests' EBFT settings (lr 1e-2, 8
    epochs, patience 3); ``calib_x`` and ``ev_x`` are the segments' other
    batch arrays (a VLM's patches)."""
    from repro_torch import interop
    from repro_torch import tree as T
    from repro_torch.core import ebft
    from repro_torch.core.evaluate import perplexity
    from repro_torch.sparsity import sparse_params as SP

    ecfg = ecfg or ebft.EBFTConfig(lr=1e-2, epochs=8, microbatch=8, patience=3)
    out = {}
    for dev in ("cuda", "cpu"):
        params = interop.params_to_torch(weights, dev)
        masks = T.tree_map(lambda m: m.to(dev), masks_cpu)
        tuned, reports = ebft.finetune(model, params, SP.apply_masks(params, masks), masks,
                                       calib, ecfg, extra_batch=calib_x)
        out[dev] = dict(reports=reports, ppl=perplexity(model, tuned, ev, extra_batch=ev_x,
                                                        masks=masks))
    worst = 0.0
    paths = {r.path for dev in out for r in out[dev]["reports"]}
    if ecfg.fused_epochs and paths != {"fused"}:
        raise AssertionError(f"tiny EBFT: blocks ran {paths}, not the fused loop")
    for a, b in zip(out["cuda"]["reports"], out["cpu"]["reports"]):
        if (a.epochs_run, a.early_stop) != (b.epochs_run, b.early_stop):
            raise AssertionError(f"tiny EBFT: block {a.index} ran {a.epochs_run} "
                                 f"({a.early_stop}) on the card, {b.epochs_run} "
                                 f"({b.early_stop}) on the CPU")
        for x, y in zip(a.history + [a.loss_after], b.history + [b.loss_after]):
            worst = max(worst, abs(x - y) / abs(y))
    ppl_rel = abs(out["cuda"]["ppl"] / out["cpu"]["ppl"] - 1.0)
    emit(dict(phase="tiny_ebft", arch=arch, dtype="float32", lr=ecfg.lr,
              epochs=ecfg.epochs, patience=ecfg.patience, paths=sorted(paths),
              epochs_run=[r.epochs_run for r in out["cuda"]["reports"]],
              early_stop=[r.early_stop for r in out["cuda"]["reports"]],
              worst_loss_rel=worst, ppl_cuda=out["cuda"]["ppl"], ppl_cpu=out["cpu"]["ppl"],
              ppl_rel=ppl_rel, rtol=rel))
    if worst > rel or ppl_rel > rel:
        raise AssertionError(f"tiny EBFT: card vs CPU loss rel {worst:.2e}, ppl rel "
                             f"{ppl_rel:.2e} (limit {rel:.0e})")
    return out["cpu"]


def _ebft_spread(model, weights, masks_cpu, calib, ev, ecfg, base, eps=1e-6, calib_x=None,
                 ev_x=None):
    """EBFT on the CPU from ``weights`` moved by ``eps`` (relative, seeded
    normal noise on every leaf) against ``base`` (the unmoved CPU run):
    the largest relative move of a block loss and of the perplexity, the
    spread that rounding alone can cause."""
    import numpy as np

    from repro_torch import interop
    from repro_torch import tree as T
    from repro_torch.core import ebft
    from repro_torch.core.evaluate import perplexity
    from repro_torch.sparsity import sparse_params as SP

    rng = np.random.default_rng(1)
    moved = T.tree_map(lambda a: a * (1 + eps * rng.standard_normal(a.shape)).astype(a.dtype),
                       weights)
    params = interop.params_to_torch(moved, "cpu")
    tuned, reports = ebft.finetune(model, params, SP.apply_masks(params, masks_cpu), masks_cpu,
                                   calib, ecfg, extra_batch=calib_x)
    worst = max(abs(x - y) / abs(y) for a, b in zip(reports, base["reports"])
                for x, y in zip(a.history + [a.loss_after], b.history + [b.loss_after]))
    ppl = perplexity(model, tuned, ev, extra_batch=ev_x, masks=masks_cpu)
    return dict(eps=eps, loss_rel=worst, ppl_rel=abs(ppl / base["ppl"] - 1.0))


def _rel_norm(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _block_slices(cfg, path, t):
    """[(block index, slice)] of a prunable leaf of a full tree: a stacked
    leaf's slices by the model's block index (a stack's first block:
    ``moe_blocks`` after the dense ones, the hybrid's ``groups`` (G, K)
    from 0 and its ``trailing`` blocks after them, ``dec_blocks`` after the
    encoder's); the hybrid's unstacked ``shared`` block is block
    ``num_layers``."""
    from repro_torch.sparsity import sparse_params as SP

    name = path[-1]
    stack = t.dim() - SP._LOGICAL_NDIM[name] - SP.is_expert_batched(name, t[0])
    if stack == 0:
        return [(cfg.num_layers, t)]
    K = cfg.hybrid_attn_every
    first = {"moe_blocks": cfg.moe_first_dense, "trailing": K and cfg.num_layers // K * K,
             "dec_blocks": cfg.enc_layers}.get(path[0], 0)
    flat = t.reshape(-1, *t.shape[stack:])
    return [(first + j, flat[j]) for j in range(flat.shape[0])]


def _sgpt_gaps(scores, sparsity):
    """Each slot's distance from its SparseGPT comparison group's
    threshold, relative to it: the column's top (1 - sparsity) share of
    each 128-row block of the (..., R, O) scores."""
    import torch

    from repro_torch.sparsity import sparse_params as SP

    R = scores.shape[-2]
    return torch.cat([SP.threshold_gaps(scores[..., v:v + 128, :], sparsity)
                      for v in range(0, R, 128)], dim=-2)


def _mask_flips(masks_a, masks_b, gap_fn, tie, cfg):
    """Slots where two full mask trees differ, per (block, path): each must
    lie within ``tie`` (relative) of its comparison group's threshold, as
    ``gap_fn(block, path, diff)`` measures it; returns {path: [flips per
    block]}, the blocks of a stacked leaf as ``_block_slices`` gives them."""
    from repro_torch import tree as T
    from repro_torch.sparsity import sparse_params as SP

    out = {}
    for path, m in T.leaves_with_path(masks_b):
        if not SP.is_prunable(path, m):
            continue
        diffs = _block_slices(cfg, path, T.get_path(masks_a, path).cpu() != m.cpu())
        out["/".join(path[1:] if path[0] == "blocks" else path)] = \
            [int(d.sum()) for _, d in diffs]
        for i, d in diffs:
            if d.any():
                gap = gap_fn(i, path, SP.to_matrix(path[-1], d)[0])
                if gap > tie:
                    raise AssertionError(f"tiny baselines: {path} block {i} flipped a slot "
                                         f"{gap:.2e} from its threshold (limit {tie:.0e})")
    return out


def phase_tiny_baselines(model, weights, calib, ev, corpus, rel=1e-4, arch="tiny_dense",
                         calib_x=None, ev_x=None, lora_x=None):
    """SparseGPT, DSnoT and FLAP prunes, mask tuning and 20 LoRA steps on
    tiny_dense (or ``arch``: tiny_vlm or tiny_encdec, with its patches or
    frames ``calib_x``, ``ev_x`` and each LoRA step's ``lora_x(step)``;
    tiny_moe, tiny_ssm, tiny_hybrid; FLAP refuses all but the dense family
    and the VLM on both devices) in f32, from the same
    weights on the card (kernels) and on
    the CPU (plain versions); mask tuning and LoRA start from the CPU's
    SparseGPT masks and LoRA from one CPU-drawn adapter init. The prunes'
    masks agree but for slots near their threshold: SparseGPT's within 1e-4
    of its 128-row block scores' threshold (its scores pass through an inverse and
    a Cholesky factor of a Gram damped by 1% of its diagonal mean), FLAP's
    units within 1e-5 of the global threshold; DSnoT's masks (from Wanda's,
    which agree here) equal; and where they agree, weights and perplexities
    within rel 1e-4. Mask tuning's masks may differ only where the two
    runs' final scores moved (|sA - tA| <= |sA - sB| + |tA - tB|): Adam's
    sign-like steps turn rounding in a near-zero gradient into a move of
    up to lr a step, as the reference's own run moves under a 1e-6 change of
    its start. Its epoch histories agree within rel 1e-4 up to the first
    visit (in the walk's order: the hybrid's shared block at its first
    site) of a block whose masks differ (the streams are the same until then), and its
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

    from repro_torch.core import reconstruction as R

    cfg = model.cfg
    flap = cfg.family in ("dense", "vlm")
    runs = {"sparsegpt": 0.5, "dsnot": 0.5, **({"flap": 0.3} if flap else {})}
    out = {dev: {} for dev in ("cuda", "cpu")}
    for dev in ("cuda", "cpu"):
        params = interop.params_to_torch(weights, dev)
        if not flap:
            _refuses(f"tiny baselines: flap on {arch} ({dev})",
                     lambda: prune(model, params, calib, method="flap", sparsity=0.3,
                                   extra_batch=calib_x))
        for method, sp in runs.items():
            scores = {}
            masks, pruned = prune(model, params, calib, method=method, sparsity=sp,
                                  extra_batch=calib_x, scores_out=scores)
            out[dev][method] = dict(masks=masks, pruned=pruned, scores=scores,
                                    ppl=perplexity(model, pruned, ev, extra_batch=ev_x,
                                                   masks=masks))
    row = dict(phase="tiny_baselines", arch=arch, dtype="float32", rtol=rel)
    cpu, card = out["cpu"], out["cuda"]
    # SparseGPT ranks each column within each 128-row block
    row["sparsegpt_flips"] = _mask_flips(card["sparsegpt"]["masks"], cpu["sparsegpt"]["masks"],
                                         lambda i, p, d: float(_sgpt_gaps(
                                             cpu["sparsegpt"]["scores"][(i, *p[1:])], 0.5)[d]
                                             .max()), 1e-4, cfg)
    row["dsnot_flips"] = _mask_flips(card["dsnot"]["masks"], cpu["dsnot"]["masks"],
                                     lambda i, p, d: math.inf, 0.0, cfg)

    # FLAP: each unit (a head, a channel) whose mask differs must lie near
    # the global threshold of the CPU's standardised scores
    row["flap_flips"] = 0
    if "flap" in runs:
        std = [{k: FLAP._standardize(cpu["flap"]["scores"][(i, k)])
                for k in ("heads", "channels")} for i in range(model.num_blocks)]
        allv = torch.cat([v for b in std for v in b.values()])
        thr = torch.sort(allv).values[-max(1, int(round(allv.numel() * (1 - runs["flap"]))))]
        for i in range(model.num_blocks):
            units = [{"heads": mb["attn"]["wo"][:, 0, 0].cpu(),
                      "channels": mb["mlp"]["w_down"][:, 0].cpu()}
                     for mb in (model.get_block(out[d]["flap"]["masks"], i) for d in out)]
            for kind, d in ((k, units[0][k] != units[1][k]) for k in units[0]):
                if d.any():
                    gap = float(((std[i][kind] - thr).abs() / thr.abs())[d].max())
                    if gap > 1e-5:
                        raise AssertionError(f"tiny baselines: flap block {i} flipped a unit "
                                             f"{gap:.2e} from the threshold (limit 1e-5)")
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
        mt, mt_masks = MT.finetune_masks(model, params, masks, 0.5, calib, extra_batch=calib_x,
                                         histories=hist, scores_out=scores)
        lp = LORA.finetune_lora(model, T.tree_map(lambda t: t.to(dev), pruned0), masks,
                                corpus_iterator(corpus, batch=8, seq_len=calib.shape[1],
                                                seed=9),
                                lcfg, extra_batch_fn=lora_x,
                                lora=T.tree_map(lambda t: t.to(dev), init), losses=losses)
        res[dev] = dict(hist=hist, scores=scores, masks=mt_masks,
                        mt_ppl=perplexity(model, mt, ev, extra_batch=ev_x, masks=mt_masks),
                        lora=lp, losses=[float(v) for v in losses],
                        lora_ppl=perplexity(model, lp, ev, extra_batch=ev_x, masks=masks))
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
        d = SP.to_matrix(path[-1],
                         T.get_path(model.get_block(res["cuda"]["masks"], i), path).cpu()
                         != T.get_path(model.get_block(res["cpu"]["masks"], i), path))[0]
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
    # up to the first visit of a block whose masks flipped, the two runs see
    # the same streams: their epoch histories, and with no flip the
    # perplexity, agree
    order = [i for seg in R.execution_plan(model) for i, _ in seg.visits]
    first = next((v for v, i in enumerate(order) if mt["flips"][i]), len(order))
    for v in range(first):
        for x, y in zip(res["cuda"]["hist"][v], res["cpu"]["hist"][v]):
            if abs(x / y - 1) > rel:
                emit(row)
                raise AssertionError(f"tiny baselines: mask tuning block {order[v]} (visit "
                                     f"{v}) history differs")
    if first == len(order) and abs(res["cuda"]["mt_ppl"] / res["cpu"]["mt_ppl"] - 1) > rel:
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
# the MoE family: DeepSeek-MoE-16B at its published widths, 5 of its 28 layers
# ---------------------------------------------------------------------------
# the EBFT microbatch's expert slabs: E 64, C = int(1.25 x 16384 x 6 / 64) = 1920,
# d_model 2048 against the experts' width 1408 (w_up, w_gate; w_down transposed)
MOE_SLABS = [("w_up", 64, 1920, 2048, 1408), ("w_down", 64, 1920, 1408, 2048)]
# the f32 batched route at a shape no tile divides (C 300, K 256 against
# 96 columns), every operand a view into padded slabs
BATCHED_RAGGED = ("ragged+strided", "float32", 8, 300, 256, 96)
MOE = dict(layers=5, pretrain_steps=50, batch=8, microbatches=4, calib=16, eval=16, seq=2048)
MOE_SERVE = dict(slots=8, prompt_len=512, max_new=32, max_len=1024, requests=16, forced_steps=32)


def moe_cfg(dtype: str = "bfloat16"):
    """DeepSeek-MoE-16B at its published widths, cut to MOE["layers"] of its
    28 layers (the dense layer and 4 MoE layers), with the flash attention
    kernel."""
    from repro_torch.configs import get_config

    return get_config("deepseek_moe_16b").replace(num_layers=MOE["layers"], dtype=dtype,
                                                  param_dtype=dtype, attn_impl="flash")


def phase_masked_matmul_batched(g):
    """The expert-batched masked GEMM (forward, dX, dW, and mask tuning's
    dM) in bf16 at the EBFT microbatch's expert slabs, and in f32 at a
    ragged shape whose every operand is a strided view
    (``BATCHED_RAGGED``), each held (a) against its plain version within
    the 2-D rows' tolerances, (b) against the 2-D kernel launched on each
    expert's slab alone, bit for bit, and (c) against a repeat of itself.
    The bf16 ones are timed (``timed_ms``) beside their plain version,
    ``torch.bmm`` (on the masked weights; dM's scaled by w) and their bound
    (the bytes of the operands and the output; the operations 2 x C x the
    mask's nonzeros, dM's 2 x E x C x K x N: it needs every slot). Returns
    the w_up rows."""
    import torch

    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.kernels.masked_matmul.ref import (
        masked_matmul_batched_dm_plain, masked_matmul_batched_dw_plain,
        masked_matmul_batched_dx_plain, masked_matmul_batched_plain,
    )

    summary = {}
    for leaf, dtype, E, C, K, N in [(leaf, "bfloat16", *dims) for leaf, *dims in MOE_SLABS] + \
            [BATCHED_RAGGED]:
        dt = getattr(torch, dtype)
        timed = dtype == "bfloat16"
        pad = 0 if timed else 3  # the ragged case's operands are views into padded slabs

        def view(rows, cols, make):
            return make(E, rows + 2 * pad, cols + 2 * pad)[:, pad:pad + rows, pad:pad + cols]

        x = view(C, K, lambda *s: torch.randn(*s, device="cuda", generator=g).to(dt))
        w = view(K, N, lambda *s: (torch.randn(*s, device="cuda", generator=g)
                                   / math.sqrt(K)).to(dt))
        m = view(K, N, lambda *s: torch.rand(*s, device="cuda", generator=g) < 0.3)
        dy = view(C, N, lambda *s: torch.randn(*s, device="cuda", generator=g).to(dt))
        es = x.element_size()
        masked_ops = 2.0 * C * float(m.sum())
        cases = (
            ("masked_matmul_batched", lambda: MM.masked_matmul_batched(x, w, m),
             lambda: masked_matmul_batched_plain(x, w, m), "torch.bmm(x, w * m)",
             lambda: torch.bmm(x, wm),
             lambda e: MM._launch(x[e], w[e], m[e]), check_close,
             (x.numel() + w.numel() + E * C * N) * es + m.numel(), masked_ops),
            ("masked_matmul_batched_dx", lambda: MM.masked_matmul_batched_dx(dy, w, m),
             lambda: masked_matmul_batched_dx_plain(dy, w, m), "torch.bmm(dy, (w * m)^T)",
             lambda: torch.bmm(dy, wm.transpose(1, 2)),
             lambda e: MM._launch_dx(dy[e], w[e], m[e]), check_scaled,
             (dy.numel() + w.numel() + E * C * K) * es + m.numel(), masked_ops),
            ("masked_matmul_batched_dw", lambda: MM.masked_matmul_batched_dw(x, dy, m),
             lambda: masked_matmul_batched_dw_plain(x, dy, m), "torch.bmm(x^T, dy) * m",
             lambda: torch.bmm(x.transpose(1, 2), dy) * m,
             lambda e: MM._launch_dw(x[e], dy[e], m[e]), check_scaled,
             (x.numel() + dy.numel() + E * K * N) * es + m.numel(), masked_ops),
            ("masked_matmul_batched_dm", lambda: MM.masked_matmul_batched_dm(x, dy, w),
             lambda: masked_matmul_batched_dm_plain(x, dy, w), "torch.bmm(x^T, dy) * w",
             lambda: torch.bmm(x.transpose(1, 2), dy) * w,
             lambda e: MM._launch_dm(x[e], dy[e], w[e]), check_scaled,
             (x.numel() + dy.numel() + w.numel() + E * K * N) * es, 2.0 * E * C * K * N),
        )
        for name, kern, plain, lib_name, lib, per_expert, check, nbytes, ops in cases:
            out = kern()
            torch.cuda.synchronize()
            err = check(f"{name} {leaf}", out, plain(), dtype)
            if not torch.equal(out, torch.stack([per_expert(e) for e in range(E)])):
                raise AssertionError(f"{name} {leaf}: an expert's slab differs from the 2-D "
                                     "kernel's launch on that slab")
            if name.endswith("_dw") and bool((out[~m] != 0).any()):
                raise AssertionError(f"{name} {leaf}: a pruned slot is not 0")
            row = dict(phase="masked_matmul_batched", kernel=name, leaf=leaf, dtype=dtype,
                       E=E, C=C, K=K, N=N, max_abs_err=err, tol=TOL[dtype],
                       equals_2d_per_expert=True,
                       deterministic=check_repeat(f"{name} {leaf}", kern, out))
            if timed:
                wm = w * m.to(dt)
                b_ms, b_by = bound_ms(nbytes, ops, dtype)
                row.update(ms=timed_ms(kern), plain_ms=timed_ms(plain), library_ms=timed_ms(lib),
                           library=lib_name, bound_ms=b_ms, bound_by=b_by,
                           bound_ms_dense_ops=2.0 * E * C * K * N / PEAK_FLOPS[dtype] * 1e3,
                           bytes=nbytes)
                del wm
            else:
                row["strides"] = {k: list(t.stride()) for k, t in (("x", x), ("w", w), ("m", m))}
            emit(row)
            if leaf == "w_up":
                summary[name] = row
            del out
        del x, w, m, dy
        torch.cuda.empty_cache()
    # the wrapper refuses what the kernel does not take: a mask whose rows
    # (the TMA's box rows) are 40 bytes apart, not a multiple of 16
    x = torch.randn(2, 8, 64, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(2, 64, 40, device="cuda", generator=g).to(torch.bfloat16)
    m = torch.ones(2, 64, 40, device="cuda", dtype=torch.bool)
    _refuses("masked_matmul_batched bf16 mask row stride 40",
             lambda: MM.masked_matmul_batched(x, w, m))
    emit(dict(phase="masked_matmul_batched", case="bf16 mask row stride 40", refused=True))
    return summary


# per block kind: (2-D masked linears, expert-batched ones, attentions, and
# under mask tuning the 2-D and the batched linears whose input takes a
# gradient: dX runs on those only, the block's input and its norm being
# frozen). A dense (or the hybrid's shared) block: wq, wk, wv, wo, w_gate,
# w_up, w_down, dX on wo and the MLP's three; an MoE block the same with
# its shared experts as the MLP, and the routed experts' three batched; a
# Mamba block in_z, in_x, in_B, in_C, in_dt and out, dX on out
BLOCK_KINDS = {"dense": (7, 0, 1, 4, 0), "moe": (7, 3, 1, 4, 3), "shared": (7, 0, 1, 4, 0),
               "mamba": (6, 0, 0, 1, 0)}
# LoRA on the SSM and hybrid paths: steps at batch 4 x 2048 (the driver's
# 200 steps at batch 8 would double the script's time, and Zamba2 at batch
# 8 in one microbatch does not fit the card), lr 1e-3 as the driver's
FAM_LORA = dict(steps=10, batch=4, lr=1e-3)  # 10 steps: the mesh phase's time (PERF.md §4)


def _visit_kinds(model):
    """The walk's visits in order, each by its ``BLOCK_KINDS`` key."""
    from repro_torch.core import reconstruction as R

    def kind(i):
        k = R.block_kind(model, i)
        return {"block": "mamba" if model.cfg.family == "ssm" else "dense"}.get(k, k)

    return [kind(i) for seg in R.execution_plan(model) for i, _ in seg.visits]


def _baselines_expected(model, res, calib, evals, lora_steps=0):
    """The baselines' launches beside the main run's: SparseGPT's walk
    (taps, student) and its eval; DSnoT's Wanda walk, its own walk and its
    eval; mask tuning's steps (a masked forward, dX where the input takes a
    gradient, dM of every masked linear, the attention's backward), its
    teacher and student advances and its eval; and ``lora_steps`` LoRA
    steps (one microbatch each: a masked forward, dW of every masked
    linear, dX of all but the first block's input projections, whose input
    is the frozen embedding), then its eval. Counted per visit of the walk
    (the hybrid's shared block at each site) as ``BLOCK_KINDS`` gives each
    visit's linears; the attention also runs unmasked in every walk's taps
    and in mask tuning's teacher."""
    n_cal, n_ev = math.ceil(calib / 8), math.ceil(evals / 8)
    kinds = _visit_kinds(model)
    mt = [len(h) * n_cal for h in res.baselines["mask"]["histories"]]
    if len(mt) != len(kinds):
        raise AssertionError(f"mask tuning visited {len(mt)} blocks, the walk has {len(kinds)}")
    out = {k: 0 for k in _counters()}
    for v, kind in enumerate(kinds):
        n2, nb, att, dx, bdx = BLOCK_KINDS[kind]
        masked = (n_cal + n_ev) + (2 * n_cal + n_ev) + (mt[v] + n_cal + n_ev) + \
            ((lora_steps + n_ev) if lora_steps else 0)
        for key, n in (("masked_matmul", n2 * masked), ("masked_matmul_batched", nb * masked),
                       ("flash_attention", att * (masked + 4 * n_cal)),
                       ("masked_matmul_dx", dx * mt[v] + n2 * lora_steps),
                       ("masked_matmul_batched_dx", bdx * mt[v] + nb * lora_steps),
                       ("masked_matmul_dm", n2 * mt[v]), ("masked_matmul_batched_dm", nb * mt[v]),
                       ("masked_matmul_dw", n2 * lora_steps),
                       ("masked_matmul_batched_dw", nb * lora_steps),
                       ("flash_attention_bwd", att * (mt[v] + lora_steps))):
            out[key] += n
    first = {"mamba": 5, "dense": 3}[kinds[0]]  # its input projections: no dX under LoRA
    out["masked_matmul_dx"] -= first * lora_steps
    return out


def _sum_counts(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _check_baselines(tag, cfg, dense, res, sg_masks, sg, sparsity=0.7):
    """The baselines of a family's path against their own rules: every
    perplexity finite and SparseGPT's at most Wanda's x 1.1; SparseGPT's
    masks keep round(b x 0.3) of each column's rows in each block of b <=
    128 rows (the last block of a leaf may be shorter; ``conv_w`` takes
    Wanda's mask, which keeps the same) and its weights are 0 in pruned
    slots; DSnoT keeps each column's kept count of its init (Wanda) masks
    and raises no column's |E| (its expected error, beyond 1e-6 of the sum
    of |W mu|); mask tuning's weights are the dense ones under its masks,
    bit for bit, each column keeping round(R x 0.3). Returns the phase
    line's readings."""
    import torch

    from repro_torch import tree as T
    from repro_torch.sparsity import sparse_params as SP

    ppl = res.perplexity
    for k, v in ppl.items():
        if not math.isfinite(v):
            raise AssertionError(f"{tag}: {k} perplexity is {v}")
    if not ppl["sparsegpt"] <= 1.1 * ppl["wanda"]:
        raise AssertionError(f"{tag}: SparseGPT's perplexity {ppl['sparsegpt']} is above "
                             f"Wanda's {ppl['wanda']} x 1.1")
    ds, mt = res.baselines["dsnot"], res.baselines["mask"]
    for path, m in T.leaves_with_path(sg_masks):
        if not SP.is_prunable(path, m):
            continue
        mat = SP.to_matrix_stacked(path[-1], m)[0]
        R = mat.shape[-2]
        for v in range(0, R, 128):
            b = min(128, R - v)
            keep = max(1, int(round(b * (1 - sparsity))))
            if not bool((mat[..., v:v + b, :].sum(dim=-2) == keep).all()):
                raise AssertionError(f"{tag} sparsegpt: {path} rows {v}:{v + b} do not keep "
                                     f"{keep} a column")
        w = T.get_path(sg, path)
        if bool((w[~m] != 0).any()) or not bool(torch.isfinite(w).all()):
            raise AssertionError(f"{tag} sparsegpt: {path} weights not 0 in pruned slots or "
                                 "not finite")
        if not torch.equal(_column_counts(path, T.get_path(ds["masks"], path)),
                           _column_counts(path, T.get_path(res.masks, path))):
            raise AssertionError(f"{tag} dsnot: {path} changed a column's kept count")
    worst_e, e_before, e_after = 0.0, 0.0, 0.0
    for before, after, scale in ds["errors"].values():
        worst_e = max(worst_e, float(((after - before) / scale.clamp_min(1e-30)).max()))
        e_before += float(before.sum())
        e_after += float(after.sum())
    if worst_e > 1e-6:
        raise AssertionError(f"{tag} dsnot: a column's |E| grew by {worst_e:.2e} of its sum |c|")
    for path, w in T.leaves_with_path(mt["params"]):
        m = T.get_path(mt["masks"], path)
        if not torch.equal(w, T.get_path(dense, path) * m):
            raise AssertionError(f"{tag} mask tuning: {path} weights are not the dense ones "
                                 "under its masks")
        if SP.is_prunable(path, m):
            want = max(1, int(round(SP.to_matrix_stacked(path[-1], m)[0].shape[-2]
                                    * (1 - sparsity))))
            if not bool((_column_counts(path, m) == want).all()):
                raise AssertionError(f"{tag} mask tuning: {path} columns keep other than {want}")
    flipped = sum(int((T.get_path(mt["masks"], p) != T.get_path(res.masks, p)).sum())
                  for p, m in T.leaves_with_path(res.masks) if SP.is_prunable(p, m))
    return dict(sparsegpt_over_wanda=ppl["sparsegpt"] / ppl["wanda"],
                dsnot_sum_abs_e=[e_before, e_after], dsnot_worst_e_growth=worst_e,
                mask_tune_histories=mt["histories"], mask_tune_flipped_slots=flipped)


def _moe_expert_readings(model, params, calib, block=1, microbatch=8):
    """Block ``block``'s routed experts on the calibration set, the dense
    stream in front of it: the slots each expert filled (its capacity C a
    microbatch; an empty slot is a row of zeros) and the smallest eigenvalue
    of each expert's damped f64 Gram (SparseGPT's H + (1% of its diagonal
    mean + 1e-8) I; an expert with few tokens has a Gram of low rank, the
    damping keeps it positive definite), the least over experts."""
    import torch

    from repro_torch.core import reconstruction as R
    from repro_torch.sparsity.taps import taps_for_block

    cfg = model.cfg
    tapfn = taps_for_block(cfg, block, model.num_blocks)
    bp = model.get_block(params, block)
    filled = H = None
    slots = 0
    with torch.no_grad():
        for s in range(0, len(calib), microbatch):
            h, pos = model.embed_tokens(
                params, {"tokens": torch.as_tensor(calib[s:s + microbatch], device="cuda")})
            for i in range(block):
                h = R.advance(model, params, i, h, pos)
            x = tapfn(bp, cfg, h, pos)["w_up"]  # (E, C, d)
            f = (x != 0).any(dim=-1).sum(dim=-1)
            x64 = x.double()
            g = x64.mT @ x64
            filled, H = (f, g) if H is None else (filled + f, H + g)
            slots += x.shape[1]
            del x, x64, g
        damp = 0.01 * torch.diagonal(H, dim1=-2, dim2=-1).mean(dim=-1) + 1e-8
        H += damp[:, None, None] * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        eig = torch.linalg.eigvalsh(H)
    lo = eig[:, 0]
    out = dict(block=block, slots_per_expert=slots, filled=filled.tolist(),
               min_filled=int(filled.min()), max_filled=int(filled.max()),
               min_eig_damped=float(lo.min()), min_eig_expert=int(lo.argmin()),
               max_eig_damped=float(eig[:, -1].max()))
    del H, eig
    torch.cuda.empty_cache()
    return out


def _moe_expected(cfg, res, epochs, microbatch=8):
    """The MoE path's launches, by the same count as the Llama path's
    (``phase_slice``): every masked forward of a block runs its 7 2-D
    masked linears (attention, and the dense MLP or the shared experts)
    and, in an MoE block, 3 batched ones (the routed experts); each EBFT
    step's backward runs dX and dW of each."""
    L, n_dense = cfg.num_layers, cfg.moe_first_dense
    n_cal = math.ceil(MOE["calib"] / microbatch)
    n_ev = math.ceil(MOE["eval"] / microbatch)
    steps = sum(_epochs_computed(r, epochs) for r in res.reports) * n_cal
    steps_moe = sum(_epochs_computed(r, epochs) for r in res.reports if r.index >= n_dense) * n_cal
    per_block = n_cal + 2 * n_ev + 3 * n_cal  # prune walk, two evals, EBFT's evals + advance
    masked_fwd = L * per_block + steps
    pre = MOE["pretrain_steps"] * MOE["microbatches"]
    return {"masked_matmul": 7 * masked_fwd, "masked_matmul_dx": 7 * steps,
            "masked_matmul_dw": 7 * steps, "masked_matmul_dm": 0,
            "flash_attention": masked_fwd + L * (n_ev + 2 * n_cal + pre),
            "flash_attention_bwd": steps + L * pre, "nm_spmm": 0,
            "masked_matmul_batched": 3 * ((L - n_dense) * per_block + steps_moe),
            "masked_matmul_batched_dx": 3 * steps_moe, "masked_matmul_batched_dw": 3 * steps_moe}


def _moe_repeat_block(model, dense, res, calib, block):
    """EBFT of one MoE block run twice on the same stream (the pruned
    student's inputs, the dense teacher's targets): the tuned weights and
    the reports must be equal bit for bit (the dispatch's scatter and
    gather accumulate into repeated slots in their backward)."""
    import torch

    from repro_torch import tree as T
    from repro_torch.core import ebft
    from repro_torch.core.pruning import common as C
    from repro_torch.sparsity import sparse_params as SP

    seen = {}

    def visit(i, bp, ctx):
        if i != block:
            return None
        data = list(zip(ctx["h_mb"], ctx["target_mb"], ctx["pos_mb"]))
        cfg = ebft.EBFTConfig(lr=2e-4, epochs=3, patience=2)
        runs = [ebft.tune_block(model, i, bp, model.get_block(res.masks, i), data, cfg, {})
                for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, T.get_path(runs[1][0], p))
                   for p, a in T.leaves_with_path(runs[0][0]))
        seen.update(same=same and runs[0][1].history == runs[1][1].history,
                    history=runs[0][1].history)
        return None

    student = SP.apply_masks(res.pruned, res.masks)
    C.walk_blocks(model, dense, calib, visit, microbatch=8, params_student=student,
                  masks=res.masks, dual_stream=True)
    if not seen.get("same"):
        raise AssertionError(f"moe: EBFT of block {block} run twice gave other bits")
    return seen


def phase_moe(walls):
    """The MoE family's path on DeepSeek-MoE-16B at its published widths
    (d_model 2048, 16 heads x 128, dense d_ff 10944, vocab 102400, 64
    routed experts of width 1408, top-6, 2 shared), 5 of its 28 layers, bf16,
    the flash attention: the seeded init pretrained MOE["pretrain_steps"]
    steps (AdamW lr 3e-3, batch 8 x 2048 in 4 microbatches of 2), Wanda 0.7,
    EBFT (lr 2e-4, 10 epochs, patience 2), the evaluations and the
    baselines DSnoT (from Wanda's masks) and mask tuning (from them too:
    the routed experts' masks through the batched dM) through
    ``ebft_run.run``, then SparseGPT 0.7 and its perplexity, all in one obs
    run (``chiprun_out/BENCH_ebft_moe.json``); LoRA is left out here: its
    routed-expert adapters alone, with their gradients and AdamW's moments,
    would take about 71 GB of the card (ROADMAP.md A.5d). Every kernel count
    is set to 0 just before it and read just after, and must equal
    ``_moe_expected`` and ``_baselines_expected``; the baselines are held to
    ``_check_baselines``, and block 1's routed experts' filled slots and
    damped Grams are read (``_moe_expert_readings``). Then one MoE block's EBFT twice, the
    teacher-forced check of the pretrained weights at cf = E/k + 1 (no
    drops), ``Server.serve`` of the tuned weights (16 requests of 512
    tokens, 32 greedy tokens each, 8 slots, max_len 1024) and the tiny_moe
    cross-check of the card against the CPU. Returns the path's launches."""
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.evaluate import perplexity
    from repro_torch.core.masks import prune
    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set, eval_set
    from repro_torch.launch import ebft_run
    from repro_torch.launch.api import start_obs_run
    from repro_torch.launch.rooflines import model_flops_per_chip
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP

    t0 = time.perf_counter()
    cfg = moe_cfg()
    model = build(cfg)
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib = calibration_set(corpus, MOE["calib"], MOE["seq"])
    ev = eval_set(corpus, ebft_run.EVAL_SAMPLES, MOE["seq"])
    data_s = time.perf_counter() - t0
    spec = ebft_run.RunSpec(arch="deepseek_moe_16b", seed=0, seq=MOE["seq"],
                            calib_samples=MOE["calib"], pretrain_steps=MOE["pretrain_steps"],
                            batch=MOE["batch"], microbatches=MOE["microbatches"], lr=2e-4,
                            epochs=10, baselines="dsnot,mask", bench_out="", kernel_tune="off")
    pre = {}
    ends = [0]

    def on_stage(stage):
        if stage != "update":
            return
        ends[0] += 1
        if ends[0] == spec.pretrain_steps:
            torch.cuda.synchronize()
            pre.update(launches=read_counts(),
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    obs_run = start_obs_run(spec, "ebft", "cuda", name="chip_smoke/moe", console=False)
    t1 = time.perf_counter()
    res = ebft_run.run(cfg, spec, "cuda", on_stage=on_stage)
    with ebft_run._phase(torch.device("cuda"), "phase/baseline", which="sparsegpt") as sp:
        sg_masks, sg = prune(model, res.dense, calib, method="sparsegpt", sparsity=0.7)
        res.perplexity["sparsegpt"] = perplexity(model, sg, ev, masks=sg_masks)
    res.phases["baseline_sparsegpt"] = sp.duration
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    summ = obs_run.payload()["metrics"]
    art = finish_obs(obs_run, ebft_run.bench_record(spec, res, summ), "BENCH_ebft_moe.json")
    expected = _sum_counts(_moe_expected(cfg, res, spec.epochs),
                           _baselines_expected(model, res, MOE["calib"], MOE["eval"]))
    stats = kernel_stats(art["metrics"])
    phases = {}
    for n in art["trace"]:
        if n["name"].startswith("phase/"):
            key = n["name"][len("phase/"):] + "".join(
                f"_{n['attrs'][a]}" for a in ("what", "which") if a in n.get("attrs", {}))
            phases[key] = dict(s=n["duration_s"], kernel_s=n["attrs"].get("kernel_s"),
                               kernel_launches=n["attrs"].get("kernel_launches"))
    hist = res.pretrain_losses
    per_step = res.phases["pretrain"] / spec.pretrain_steps
    flops = model_flops_per_chip(cfg, ShapeConfig("pretrain", MOE["seq"], MOE["batch"],
                                                  "train"), 1)
    blocks = [dict(block=r.index, kind=r.kind, loss_before=r.loss_before,
                   loss_after=r.loss_after, epochs_run=r.epochs_run, early_stop=r.early_stop)
              for r in res.reports]
    experts = _moe_expert_readings(model, res.dense, calib)
    row = dict(phase="moe", arch="deepseek_moe_16b", num_layers=cfg.num_layers,
               reduced=f"num_layers 28->{cfg.num_layers}", dtype=cfg.dtype,
               attn_impl=cfg.attn_impl,
               seq=spec.seq, params=sum(t.numel() for _, t in T.leaves_with_path(res.dense)),
               pretrain=dict(steps=spec.pretrain_steps, batch=spec.batch,
                             microbatches=spec.microbatches, lr=3e-3,
                             loss=[dict(step=i, loss=l, grad_norm=gn) for i, l, gn in hist],
                             s_per_step=per_step, model_flops_per_step=flops,
                             tflops_6nd_active=flops / per_step / 1e12,
                             peak_mem_gib=pre.get("peak_mem_gib"),
                             launches=pre.get("launches")),
               method="wanda", sparsity=0.7, achieved_sparsity=res.sparsity,
               perplexity=res.perplexity,
               ebft_below_pruned=res.perplexity["EBFT"] < res.perplexity["wanda"],
               baselines="dsnot,mask + sparsegpt 0.7; no LoRA (its adapters would not fit)",
               expert_readings=experts,
               blocks=blocks, phases_s=res.phases, phase_spans=phases, wall_s=wall,
               data_s=data_s, peak_mem_gib=peak,
               live_block_bytes=max(r.live_bytes for r in res.reports),
               launches=launches, expected_launches=expected,
               obs_booked={k: stats.get(k, {}).get("calls", 0) for k in launches},
               in_run_ms={k: stats[k]["mean_ms"] for k in BATCHED if k in stats},
               artifact="chiprun_out/BENCH_ebft_moe.json")
    emit(row)
    for k, v in res.perplexity.items():
        if not math.isfinite(v):
            raise AssertionError(f"moe: {k} perplexity is {v}")
    if not all(math.isfinite(x) for _, l, gn in hist for x in (l, gn)):
        raise AssertionError(f"moe: a pretraining loss or grad norm is not finite: {hist}")
    if not hist[-1][1] < hist[0][1]:
        raise AssertionError(f"moe: pretraining loss {hist[0][1]} -> {hist[-1][1]} did not drop")
    if launches != expected:
        raise AssertionError(f"moe: launches {launches} != expected {expected}")
    idle = [k for k, v in launches.items() if v == 0 and k != "nm_spmm"]
    if idle:
        raise AssertionError(f"moe: kernels of the path launched no time: {idle}")
    if any(row["obs_booked"][k] != launches[k] for k in launches):
        raise AssertionError(f"moe: obs booked {row['obs_booked']}, the wrappers {launches}")
    if not res.perplexity["EBFT"] < res.perplexity["wanda"]:
        raise AssertionError(f"moe: EBFT perplexity {res.perplexity['EBFT']} is not below "
                             f"the pruned model's {res.perplexity['wanda']}")
    _check_pruned(res, cfg, 1.0 - 0.7, None)
    router = res.masks["moe_blocks"]["moe"]["router"]["w"]
    if not bool(router.all()):
        raise AssertionError("moe: the router is masked")
    for path, m in T.leaves_with_path(res.masks):
        if SP.is_prunable(path, m) and bool((T.get_path(res.tuned, path)[~m] != 0).any()):
            raise AssertionError(f"moe: {path} tuned weights are not 0 in pruned slots")
    emit(dict(phase="moe_baselines", **_check_baselines("moe", cfg, res.dense, res, sg_masks,
                                                        sg)))
    del sg, sg_masks
    res.baselines.clear()
    torch.cuda.empty_cache()
    walls["moe_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rep = _moe_repeat_block(model, res.dense, res, calib, cfg.moe_first_dense)
    emit(dict(phase="moe_repeat", block=cfg.moe_first_dense, epochs=3, bit_equal=True,
              history=rep["history"], seconds=time.perf_counter() - t0))
    walls["moe_repeat"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [corpus.sample(rng, MOE_SERVE["prompt_len"]) for _ in range(MOE_SERVE["requests"])]
    cf = cfg.moe_num_experts / cfg.moe_top_k + 1.0
    forced = _serve_forced(build(cfg.replace(moe_capacity_factor=cf)), res.dense,
                           prompts[:MOE_SERVE["slots"]], "moe pretrained", MOE_SERVE)
    dense = res.dense
    tuned = res.tuned
    del res
    torch.cuda.empty_cache()
    served = _serve_run(model, tuned, prompts, "moe_ebft", MOE_SERVE, "deepseek_moe_16b")
    emit(dict(phase="moe_serve", weights={"forced": "pretrained", "serve": "ebft"},
              forced_capacity_factor=cf, forced=forced, serve=served, **MOE_SERVE,
              phase_s=time.perf_counter() - t0))
    walls["moe_serve"] = time.perf_counter() - t0
    del dense, tuned
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tiny_family("tiny_moe")
    walls["moe_tiny"] = time.perf_counter() - t0
    return launches


# ---------------------------------------------------------------------------
# the SSM family (Mamba2-130M, 4 of its 24 layers) and the hybrid
# (Zamba2-1.2B, 6 of its 38 layers: one shared-block site) at their
# published widths; the depths keep the script inside its limit (PERF.md §4)
# ---------------------------------------------------------------------------
# every Mamba leaf's (R, O) matrix at both models' widths, bf16, at the EBFT
# microbatch's M rows: in_z and in_x (d | H·P), in_B and in_C (d | N), in_dt
# (d | H: Mamba2-130M's 24 columns, a mask row of 24 bytes), out (H·P | d)
MAMBA_LEAVES = {"ssm": [("in_zx", 768, 1536), ("in_BC", 768, 128), ("in_dt", 768, 24),
                        ("out", 1536, 768)],
                "hybrid": [("in_zx", 2048, 4096), ("in_BC_dt", 2048, 64), ("out", 4096, 2048)]}
# pretraining's AdamW lr: ebft_run's PRETRAIN_LR, 3e-3, for Mamba2-130M; 3e-4 for Zamba2,
# whose shared block (d_ff 8192) grows under 50 steps at 3e-3 until its output
# swamps the Mamba stream: the untuned sparse shared block's error at its
# first site then held every later block's EBFT loss near 1.2e8, and EBFT's
# perplexity above Wanda's (PERF.md §6). Microbatches: the most each
# pretraining step fits (Mamba2-130M's peak 67 GiB in one at 24 layers); the
# depths are cut for the script's time (PERF.md §4: ssm 24 -> 16 -> 4,
# hybrid 38 -> 13 -> 7 -> 6: one shared-block site, no trailing block)
FAMILY = {"ssm": dict(arch="mamba2_130m", layers=4, reduced="num_layers 24->4", microbatches=1,
                      pretrain_lr=3e-3),
          "hybrid": dict(arch="zamba2_1_2b", layers=6, reduced="num_layers 38->6",
                         microbatches=2, pretrain_lr=3e-4)}
FAM = dict(pretrain_steps=50, batch=8, calib=16, eval=16, seq=2048)
FAM_SERVE = dict(slots=8, prompt_len=512, max_new=32, max_len=1024, requests=16, forced_steps=32)
MASKED = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw")


def family_cfg(family: str, dtype: str = "bfloat16"):
    """The family's published config in ``dtype`` with the flash attention
    kernel, cut to FAMILY[family]["layers"] where that is set."""
    from repro_torch.configs import get_config

    f = FAMILY[family]
    cfg = get_config(f["arch"]).replace(dtype=dtype, param_dtype=dtype, attn_impl="flash")
    return cfg.replace(num_layers=f["layers"]) if f["layers"] else cfg


def phase_masked_matmul_mamba(g):
    """The masked matmul forward, dX and dW at every Mamba leaf shape of
    both families (``MAMBA_LEAVES``, ``_masked_leaves``). The mask is laid
    out as ``prune`` keeps it (``aligned_mask``): Mamba2-130M's in_dt mask,
    (768, 24), is a view into a (768, 32) buffer, and the wrapper refuses
    the contiguous one. Then mask tuning's product on in_dt: a tuned (float,
    requiring grad) mask, which the wrapper lays out as ``aligned_mask``
    itself, through the bf16 forward, dX and dM kernels, held against their
    plain versions. Returns {family: {kernel: {leaf: row}}}."""
    import torch

    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.kernels.masked_matmul.ref import (
        masked_matmul_dm_plain, masked_matmul_dx_plain, masked_matmul_plain,
    )

    out = _masked_leaves(g, MAMBA_LEAVES, "masked_matmul_mamba")
    dt, (K, N) = torch.bfloat16, (768, 24)
    x = torch.randn(M_ROWS, K, device="cuda", generator=g).to(dt).requires_grad_(True)
    w = (torch.randn(K, N, device="cuda", generator=g) / math.sqrt(K)).to(dt)
    m = (torch.rand(K, N, device="cuda", generator=g) < 0.3).to(dt).requires_grad_(True)
    dy = torch.randn(M_ROWS, N, device="cuda", generator=g).to(dt)
    before = read_counts()
    y = MM.masked_matmul(x, w, m)
    gx, gm = torch.autograd.grad(y, (x, m), dy)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
    if ran != {"masked_matmul": 1, "masked_matmul_dx": 1, "masked_matmul_dm": 1}:
        raise AssertionError(f"tuned in_dt mask: launches {ran}")
    with torch.no_grad():
        errs = [check_close("tuned in_dt forward", y, masked_matmul_plain(x, w, m), "bfloat16"),
                check_scaled("tuned in_dt dX", gx, masked_matmul_dx_plain(dy, w, m != 0),
                             "bfloat16"),
                check_scaled("tuned in_dt dM", gm, masked_matmul_dm_plain(x, dy, w), "bfloat16")]
    emit(dict(phase="masked_matmul_mamba", family="ssm", leaf="in_dt", case="tuned float mask",
              dtype="bfloat16", M=M_ROWS, K=K, N=N, launches=ran,
              max_abs_err=dict(zip(("forward", "dx", "dm"), errs)), tol=TOL["bfloat16"]))
    return out


def _masked_leaves(g, groups, phase, m_rows=M_ROWS):
    """The masked matmul forward, dX and dW at each (leaf, K, N) of
    ``groups`` ({group: [...]}), bf16, M = ``m_rows``, each held against its
    plain version (the forward within tol, dX and dW within tol x max
    |plain|; dW exactly 0 in every pruned slot), timed beside it, the
    PyTorch product on the masked weights and the bound. A mask whose rows
    are not 16 bytes apart is an ``aligned_mask`` view, and the wrapper
    must refuse the contiguous one. Returns {group: {kernel: {leaf: row}}}."""
    import torch

    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.kernels.masked_matmul.ref import (
        masked_matmul_dw_plain, masked_matmul_dx_plain, masked_matmul_plain,
    )

    dt = torch.bfloat16
    M = m_rows
    out = {fam: {k: {} for k in MASKED} for fam in groups}
    for fam, leaves in groups.items():
        for leaf, K, N in leaves:
            w = (torch.randn(K, N, device="cuda", generator=g) / math.sqrt(K)).to(dt)
            m = MM.aligned_mask(torch.rand(K, N, device="cuda", generator=g) < 0.3)
            x = torch.randn(M, K, device="cuda", generator=g).to(dt)
            dy = torch.randn(M, N, device="cuda", generator=g).to(dt)
            wm = w * m.to(dt)
            nnz = float(m.sum())
            es = x.element_size()
            cases = (
                ("masked_matmul", lambda: MM.masked_matmul(x, w, m),
                 lambda: masked_matmul_plain(x, w, m), lambda: torch.matmul(x, wm), check_close,
                 (x.numel() + w.numel() + M * N) * es + K * N),
                ("masked_matmul_dx", lambda: MM.masked_matmul_dx(dy, w, m),
                 lambda: masked_matmul_dx_plain(dy, w, m), lambda: torch.matmul(dy, wm.T),
                 check_scaled, (dy.numel() + w.numel() + M * K) * es + K * N),
                ("masked_matmul_dw", lambda: MM.masked_matmul_dw(x, dy, m),
                 lambda: masked_matmul_dw_plain(x, dy, m), lambda: torch.matmul(x.T, dy) * m,
                 check_scaled, (x.numel() + dy.numel() + K * N) * es + K * N),
            )
            for name, kern, plain, lib, check, nbytes in cases:
                got = kern()
                torch.cuda.synchronize()
                err = check(f"{name} {fam} {leaf}", got, plain(), "bfloat16")
                if name == "masked_matmul_dw" and bool((got[~m] != 0).any()):
                    raise AssertionError(f"{name} {fam} {leaf}: a pruned slot is not 0")
                b_ms, b_by = bound_ms(nbytes, 2.0 * M * nnz, "bfloat16")
                row = dict(phase=phase, family=fam, kernel=name, leaf=leaf,
                           dtype="bfloat16", M=M, K=K, N=N, mask_strides=list(m.stride()),
                           max_abs_err=err, tol=TOL["bfloat16"], ms=timed_ms(kern),
                           plain_ms=timed_ms(plain), library_ms=timed_ms(lib), bound_ms=b_ms,
                           bound_by=b_by,
                           deterministic=check_repeat(f"{name} {fam} {leaf}", kern, got))
                out[fam][name][leaf] = row
                emit(row)
                del got
            if N % 16:
                dense_m = m.contiguous()
                for name, fn in (("masked_matmul", lambda: MM.masked_matmul(x, w, dense_m)),
                                 ("masked_matmul_dx",
                                  lambda: MM.masked_matmul_dx(dy, w, dense_m)),
                                 ("masked_matmul_dw",
                                  lambda: MM.masked_matmul_dw(x, dy, dense_m))):
                    _refuses(f"{name} {fam} {leaf} contiguous mask", fn)
                emit(dict(phase=phase, family=fam, leaf=leaf,
                          case=f"contiguous ({K}, {N}) bf16 mask", refused=True))
            del w, m, x, dy, wm
    return out


def _family_expected(cfg, res, microbatches, epochs):
    """The path's launches, counted as the Llama and moe paths' are: a
    masked forward of a Mamba block runs its 6 masked projections (in_z,
    in_x, in_B, in_C, in_dt, out), one of the hybrid's shared block its 7
    masked linears and the attention; per block (per site of the shared
    block) the prune walk's student advance, the two evaluations with
    masks and EBFT's loss before and after and student advance, plus one
    per EBFT step, whose backward runs dX and dW of each and the
    attention's backward. The attention also runs unmasked at each site:
    in the dense evaluation, the prune walk's taps, EBFT's teacher and
    every pretraining microbatch (forward and backward)."""
    n_cal = math.ceil(FAM["calib"] / 8)
    n_ev = math.ceil(FAM["eval"] / 8)
    per_block = n_cal + 2 * n_ev + 3 * n_cal
    shared = cfg.num_layers if cfg.family == "hybrid" else None
    sites = cfg.num_layers // cfg.hybrid_attn_every if shared is not None else 0
    steps_m = sum(_epochs_computed(r, epochs) for r in res.reports if r.index != shared) * n_cal
    steps_s = sum(_epochs_computed(r, epochs) for r in res.reports
                  if r.index == shared) * n_cal * sites
    fwd_m = cfg.num_layers * per_block + steps_m
    fwd_s = sites * per_block + steps_s
    pre = FAM["pretrain_steps"] * microbatches
    out = {k: 0 for k in _counters()}
    out.update(masked_matmul=6 * fwd_m + 7 * fwd_s, masked_matmul_dx=6 * steps_m + 7 * steps_s,
               masked_matmul_dw=6 * steps_m + 7 * steps_s,
               flash_attention=fwd_s + sites * (n_ev + 2 * n_cal + pre),
               flash_attention_bwd=steps_s + sites * pre)
    return out


def phase_family(family: str, walls):
    """One family's path at its published widths, bf16, the flash attention
    kernel: the seeded init pretrained FAM["pretrain_steps"] steps by the
    ``ebft_run.pretrain`` (AdamW at FAMILY[family]["pretrain_lr"], batch 8 x
    2048 in FAMILY[family]["microbatches"] microbatches), then from those
    weights Wanda 0.7, EBFT (lr 2e-4, 10 epochs, patience 2), the
    evaluations and the baselines DSnoT (from Wanda's masks) and mask
    tuning (from them too) through ``ebft_run.run``, then SparseGPT 0.7 and
    ``FAM_LORA`` LoRA steps from the Wanda prune, each with its perplexity,
    all in one obs run (``chiprun_out/BENCH_ebft_<family>.json``);
    every kernel count is set to 0 just before it and read just after, and
    must equal ``_family_expected`` and ``_baselines_expected``. Every EBFT
    block loss must drop, EBFT's perplexity must be below Wanda's, nothing
    may be NaN, the baselines hold ``_check_baselines``, and LoRA's merged
    weights are 0 in pruned slots with finite losses. Then the
    teacher-forced check of the pretrained weights in f32
    (``_serve_forced_f32``), ``Server.serve`` of the
    tuned weights (16 requests of 512 tokens, 32 greedy tokens each, 8
    slots, max_len 1024) and the tiny variant's cross-check of the card
    against the CPU. Returns the path's launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import lora
    from repro_torch.core.evaluate import perplexity
    from repro_torch.core.masks import prune
    from repro_torch.data.tokens import (
        CorpusConfig, SyntheticCorpus, calibration_set, corpus_iterator, eval_set,
    )
    from repro_torch.launch import ebft_run
    from repro_torch.launch.api import start_obs_run
    from repro_torch.launch.rooflines import model_flops_per_chip
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP

    t0 = time.perf_counter()
    f = FAMILY[family]
    cfg = family_cfg(family)
    spec = ebft_run.RunSpec(arch=f["arch"], seed=0, seq=FAM["seq"], calib_samples=FAM["calib"],
                            pretrain_steps=FAM["pretrain_steps"], batch=FAM["batch"],
                            microbatches=f["microbatches"], lr=2e-4, epochs=10,
                            baselines="dsnot,mask", bench_out="", kernel_tune="off")
    pre = {}
    ends = [0]

    def on_stage(stage):
        if stage != "update":
            return
        ends[0] += 1
        if ends[0] == spec.pretrain_steps:
            torch.cuda.synchronize()
            pre.update(launches=read_counts(),
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    obs_run = start_obs_run(spec, "ebft", "cuda", name=f"chip_smoke/{family}", console=False)
    t1 = time.perf_counter()
    model = build(cfg)
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=spec.seed))
    params = model.init(torch.Generator(device="cuda").manual_seed(spec.seed))
    with ebft_run._phase(torch.device("cuda"), "phase/pretrain", steps=spec.pretrain_steps) as sp:
        dense, hist = ebft_run.pretrain(model, params, corpus, spec.pretrain_steps, spec.batch,
                                        spec.seq, f["pretrain_lr"], on_stage, spec.microbatches)
    del params
    res = ebft_run.run(cfg, dataclasses.replace(spec, pretrain_steps=0), "cuda", params=dense)
    res.phases = {"pretrain": sp.duration, **res.phases}
    res.pretrain_losses = hist
    dev = torch.device("cuda")
    calib = calibration_set(corpus, spec.calib_samples, spec.seq)
    ev = eval_set(corpus, ebft_run.EVAL_SAMPLES, spec.seq)
    with ebft_run._phase(dev, "phase/baseline", which="sparsegpt") as sp:
        sg_masks, sg = prune(model, res.dense, calib, method="sparsegpt", sparsity=0.7)
        res.perplexity["sparsegpt"] = perplexity(model, sg, ev, masks=sg_masks)
    res.phases["baseline_sparsegpt"] = sp.duration
    lora_losses = []
    with ebft_run._phase(dev, "phase/baseline", which="lora") as sp:
        lp = lora.finetune_lora(
            model, res.pruned, res.masks,
            corpus_iterator(corpus, batch=FAM_LORA["batch"], seq_len=spec.seq, seed=9),
            lora.LoRAConfig(steps=FAM_LORA["steps"], lr=FAM_LORA["lr"]), losses=lora_losses)
        res.perplexity["LoRA"] = perplexity(model, lp, ev, masks=res.masks)
    res.phases["baseline_lora"] = sp.duration
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    summ = obs_run.payload()["metrics"]
    art = finish_obs(obs_run, ebft_run.bench_record(spec, res, summ),
                     f"BENCH_ebft_{family}.json")
    expected = _sum_counts(_family_expected(cfg, res, f["microbatches"], spec.epochs),
                           _baselines_expected(model, res, FAM["calib"], FAM["eval"],
                                               FAM_LORA["steps"]))
    stats = kernel_stats(art["metrics"])
    phases = {}
    for n in art["trace"]:
        if n["name"].startswith("phase/"):
            key = n["name"][len("phase/"):] + "".join(
                f"_{n['attrs'][a]}" for a in ("what", "which") if a in n.get("attrs", {}))
            phases[key] = dict(s=n["duration_s"], kernel_s=n["attrs"].get("kernel_s"),
                               kernel_launches=n["attrs"].get("kernel_launches"))
    hist = res.pretrain_losses
    per_step = res.phases["pretrain"] / spec.pretrain_steps
    flops = model_flops_per_chip(cfg, ShapeConfig("pretrain", FAM["seq"], FAM["batch"],
                                                  "train"), 1)
    blocks = [dict(block=r.index, kind=r.kind, loss_before=r.loss_before,
                   loss_after=r.loss_after, epochs_run=r.epochs_run, early_stop=r.early_stop)
              for r in res.reports]
    row = dict(phase=family, arch=f["arch"], num_layers=cfg.num_layers, reduced=f["reduced"],
               dtype=cfg.dtype, attn_impl=cfg.attn_impl, seq=spec.seq,
               params=sum(t.numel() for _, t in T.leaves_with_path(res.dense)),
               pretrain=dict(steps=spec.pretrain_steps, batch=spec.batch,
                             microbatches=spec.microbatches, lr=f["pretrain_lr"],
                             loss=[dict(step=i, loss=l, grad_norm=gn) for i, l, gn in hist],
                             s_per_step=per_step, model_flops_per_step=flops,
                             tflops_6nd=flops / per_step / 1e12,
                             peak_mem_gib=pre.get("peak_mem_gib"),
                             launches=pre.get("launches")),
               method="wanda", sparsity=0.7, achieved_sparsity=res.sparsity,
               perplexity=res.perplexity,
               ebft_below_pruned=res.perplexity["EBFT"] < res.perplexity["wanda"],
               baselines="dsnot,mask + sparsegpt 0.7 + LoRA",
               lora=dict(FAM_LORA, losses=[float(v) for v in lora_losses]),
               blocks=blocks, phases_s=res.phases, phase_spans=phases, wall_s=wall,
               peak_mem_gib=peak, live_block_bytes=max(r.live_bytes for r in res.reports),
               launches=launches, expected_launches=expected,
               obs_booked={k: stats.get(k, {}).get("calls", 0) for k in launches},
               in_run_ms={k: v["mean_ms"] for k, v in stats.items()},
               kernel_s={k: v["total_s"] for k, v in stats.items()},
               artifact=f"chiprun_out/BENCH_ebft_{family}.json")
    emit(row)
    for k, v in res.perplexity.items():
        if not math.isfinite(v):
            raise AssertionError(f"{family}: {k} perplexity is {v}")
    if not all(math.isfinite(x) for _, l, gn in hist for x in (l, gn)):
        raise AssertionError(f"{family}: a pretraining loss or grad norm is not finite: {hist}")
    if not hist[-1][1] < hist[0][1]:
        raise AssertionError(f"{family}: pretraining loss {hist[0][1]} -> {hist[-1][1]} "
                             "did not drop")
    bad = [b for b in blocks if not (math.isfinite(b["loss_after"])
                                     and b["loss_after"] < b["loss_before"])]
    if bad:
        raise AssertionError(f"{family}: EBFT block losses that did not drop: {bad}")
    if launches != expected:
        raise AssertionError(f"{family}: launches {launches} != expected {expected}")
    path_kernels = MASKED + ("masked_matmul_dm",) + (("flash_attention", "flash_attention_bwd")
                             if family == "hybrid" else ())
    idle = [k for k in path_kernels if launches[k] == 0]
    if idle:
        raise AssertionError(f"{family}: kernels of the path launched no time: {idle}")
    if any(row["obs_booked"][k] != launches[k] for k in launches):
        raise AssertionError(f"{family}: obs booked {row['obs_booked']}, the wrappers "
                             f"{launches}")
    if not res.perplexity["EBFT"] < res.perplexity["wanda"]:
        raise AssertionError(f"{family}: EBFT perplexity {res.perplexity['EBFT']} is not below "
                             f"the pruned model's {res.perplexity['wanda']}")
    _check_pruned(res, cfg, 1.0 - 0.7, None)
    for path, m in T.leaves_with_path(res.masks):
        if SP.is_prunable(path, m):
            t = T.get_path(res.tuned, path)
            if bool((t[~m] != 0).any()) or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{family}: {path} tuned weights are not 0 in pruned "
                                     "slots or not finite")
            t = T.get_path(lp, path)
            if bool((t[~m] != 0).any()) or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{family}: {path} LoRA's merged weights are not 0 in "
                                     "pruned slots or not finite")
    if not all(math.isfinite(float(v)) for v in lora_losses):
        raise AssertionError(f"{family}: a LoRA loss is not finite")
    emit(dict(phase=f"{family}_baselines", **_check_baselines(family, cfg, res.dense, res,
                                                              sg_masks, sg)))
    del sg, sg_masks, lp
    res.baselines.clear()
    torch.cuda.empty_cache()
    walls[f"{family}_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    prompts = [corpus.sample(rng, FAM_SERVE["prompt_len"]) for _ in range(FAM_SERVE["requests"])]
    forced = _serve_forced_f32(build(cfg.replace(dtype="float32", param_dtype="float32")),
                               T.tree_map(lambda t: t.float(), res.dense),
                               prompts[:FAM_SERVE["slots"]], f"{family} pretrained", FAM_SERVE)
    tuned = res.tuned
    del res, dense
    torch.cuda.empty_cache()
    sites = cfg.num_layers // cfg.hybrid_attn_every if family == "hybrid" else 0
    served = _serve_run(model, tuned, prompts, f"{family}_ebft", FAM_SERVE, f["arch"],
                        attn_layers=sites)
    emit(dict(phase=f"{family}_serve", weights={"forced": "pretrained", "serve": "ebft"},
              forced=forced, serve=served, **FAM_SERVE, phase_s=time.perf_counter() - t0))
    walls[f"{family}_serve"] = time.perf_counter() - t0
    del tuned
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tiny_family(f"tiny_{family}")
    walls[f"{family}_tiny"] = time.perf_counter() - t0
    return launches


def phase_tiny_family(arch: str, rel=1e-4, smoke=False):
    """tiny_moe, tiny_ssm, tiny_hybrid, tiny_vlm or (``smoke``) a dense
    config's SMOKE in f32 with the same weights on the
    card (the kernels: the batched one on the expert leaves, the attention
    in the hybrid's shared block) and on the CPU (plain versions): the loss
    and its metrics (MoE: nll and aux), the dense and Wanda perplexities
    within rel 1e-4; masks that differ only in slots within 1e-6 (relative)
    of their threshold; then EBFT from the CPU's masks on both at the
    paper's settings (lr 2e-4, 10 epochs, patience 2; ``phase_tiny_ebft``'s
    check: epochs and stops equal, losses and perplexity within rel 1e-4).
    The limit must stand at least 5 times above the CPU's own spread under
    a 1e-6 move of the weights at those settings (``_ebft_spread``): a
    router top-k on a near-tie can flip with the order of a sum, and at a
    larger lr Adam carries such a flip far. tiny_vlm takes seeded patches
    in front of every batch (``extra_batch``), tiny_encdec seeded frames
    beside it (at seq 64, F = 8: cross-attention over fewer keys than one
    key tile, forward and backward). Every family but the dense configs'
    SMOKEs goes on through ``phase_tiny_baselines`` (SparseGPT, DSnoT, FLAP,
    mask tuning, LoRA; FLAP refuses all but the VLM on both devices)."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.core import ebft
    from repro_torch.core.evaluate import perplexity
    from repro_torch.core.masks import prune
    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set, eval_set
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP

    cfg = get_config(arch, smoke).replace(attn_impl="flash")
    tag = f"{arch}_smoke" if smoke else arch
    model = build(cfg)
    weights = interop.params_to_numpy(model.init(torch.Generator().manual_seed(0)))
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    seq = 64 if cfg.family == "encdec" else 128
    calib, ev = calibration_set(corpus, 16, seq), eval_set(corpus, 16, seq)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, seq))

    def extra(n, seed):
        if cfg.family == "vlm":
            return _patches(cfg, n, cfg.frontend_len, seed)
        if cfg.family == "encdec":
            return _frames(cfg, n, max(cfg.frontend_len, seq // 8), seed)
        return None

    calib_x, ev_x = extra(16, 1), extra(16, 2)
    out = {}
    for dev in ("cuda", "cpu"):
        params = interop.params_to_torch(weights, dev)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in {"tokens": toks, **(extra(4, 3) or {})}.items()}
        loss, m = model.loss(params, batch)
        scores = {}
        masks, pruned = prune(model, params, calib, method="wanda", sparsity=0.5,
                              extra_batch=calib_x, scores_out=scores)
        out[dev] = dict(loss=float(loss), **{k: float(v) for k, v in m.items()},
                        dense=perplexity(model, params, ev, extra_batch=ev_x),
                        wanda=perplexity(model, pruned, ev, extra_batch=ev_x, masks=masks),
                        masks=masks, scores=scores)
    flips, worst = 0, 0.0
    for path, m in T.leaves_with_path(out["cpu"]["masks"]):
        if not SP.is_prunable(path, m):
            continue
        for i, d in _block_slices(cfg, path, m != T.get_path(out["cuda"]["masks"], path).cpu()):
            if d.any():
                s = out["cpu"]["scores"][(i, *path[1:])]
                gap = float(SP.threshold_gaps(s, 0.5)[d.reshape(s.shape)].max())
                worst = max(worst, gap)
                flips += int(d.sum())
    keys = [k for k in out["cpu"] if k not in ("masks", "scores")]
    emit(dict(phase=tag, arch=arch, dtype="float32", attn_impl="flash",
              cuda={k: out["cuda"][k] for k in keys}, cpu={k: out["cpu"][k] for k in keys},
              rtol=rel, mask_flips=flips, worst_flip_gap=worst, gap_rtol=1e-6))
    for k in keys:
        a, b = out["cuda"][k], out["cpu"][k]
        if not abs(a - b) <= rel * abs(b):
            raise AssertionError(f"{tag}: {k} cuda {a} vs cpu {b}")
    if worst > 1e-6:
        raise AssertionError(f"{tag}: a mask flipped {worst:.2e} from its threshold")
    masks = out["cpu"]["masks"]
    paper = ebft.EBFTConfig(lr=2e-4, epochs=10, microbatch=8, patience=2)
    base = phase_tiny_ebft(model, weights, masks, calib, ev, rel, arch=tag, ecfg=paper,
                           calib_x=calib_x, ev_x=ev_x)
    spread = _ebft_spread(model, weights, masks, calib, ev, paper, base, calib_x=calib_x,
                          ev_x=ev_x)
    emit(dict(phase=f"{tag}_spread", arch=arch, device="cpu", lr=paper.lr, rtol=rel,
              **spread))
    if max(spread["loss_rel"], spread["ppl_rel"]) > rel / 5:
        raise AssertionError(f"{tag}: the CPU's own EBFT spread {spread} is not 5 times "
                             f"below the card-vs-CPU limit {rel:.0e}")
    if cfg.family != "dense":
        phase_tiny_baselines(model, weights, calib, ev, corpus, rel, arch=tag, calib_x=calib_x,
                             ev_x=ev_x,
                             lora_x=(lambda step: extra(8, 100 + step)) if calib_x else None)

# ---------------------------------------------------------------------------
# the VLM family: LLaVA-NeXT-Mistral-7B at its published widths, 3 of its 32
# layers; and the dense family's other four configs
# ---------------------------------------------------------------------------
# the masked GEMM's leaves that no other phase holds, bf16, at the EBFT
# microbatch's M rows: LLaVA's (Mistral-7B's) wk and wv (d | 8 KV heads x
# 128), w_gate and w_up (d | 14336) and w_down (its wq and wo are Llama's
# 4096 x 4096); and the MLP's up projection of each of the dense family's
# other configs (d | d_ff)
VLM_LEAVES = {"vlm": [("wk_wv", 4096, 1024), ("w_gate_up", 4096, 14336),
                      ("w_down", 14336, 4096)],
              "dense_configs": [("qwen1_5_4b_w_up", 2560, 6912),
                                ("nemotron_4_15b_w_up", 6144, 24576),
                                ("qwen2_5_32b_w_up", 5120, 27648),
                                ("qwen1_5_110b_w_up", 8192, 49152)]}
# seq 2048 = P 1024 patch positions (min(frontend_len 2880, seq // 2)) + 1024
# text tokens; pretraining through launch/train.run (AdamW on its warmup-cosine
# schedule, one piece), EBFT at the paper's settings
VLM = dict(layers=3, pretrain_steps=50, batch=8, seq=2048, pretrain_lr=3e-3, calib=16, eval=16)
# 8 prompts of [1024 patches ; 512 tokens], 32 greedy tokens each, a
# 2048-position cache; the teacher-forced check over 32 steps
VLM_SERVE = dict(slots=8, prompt_len=512, max_new=32, max_len=2048, forced_steps=32)
DENSE_SMOKES = ("qwen1_5_4b", "nemotron_4_15b", "qwen2_5_32b", "qwen1_5_110b")


def _patches(cfg, n, P, seed):
    """Seeded stand-ins for the stub vision tower's patch embeddings, as
    the reference's ``launch/train`` draws them: {"patches": (n, P, d) f32}."""
    import numpy as np

    return {"patches": np.random.default_rng(seed).normal(
        size=(n, P, cfg.d_model)).astype(np.float32)}


def _frames(cfg, n, F, seed):
    """Seeded stand-ins for the stub audio frontend's frame embeddings, as
    the reference's ``launch/train`` draws them: {"frames": (n, F, d) f32}."""
    import numpy as np

    return {"frames": np.random.default_rng(seed).normal(
        size=(n, F, cfg.d_model)).astype(np.float32)}


def vlm_cfg(dtype: str = "bfloat16"):
    """LLaVA-NeXT-Mistral-7B at its published widths, cut to VLM["layers"]
    of its 32 layers, with the flash attention kernel."""
    from repro_torch.configs import get_config

    return get_config("llava_next_mistral_7b").replace(num_layers=VLM["layers"], dtype=dtype,
                                                       param_dtype=dtype, attn_impl="flash")


def phase_masked_matmul_vlm(g):
    """The masked matmul forward, dX and dW at ``VLM_LEAVES`` (``_masked_leaves``).
    Returns {"vlm" | "dense_configs": {kernel: {leaf: row}}}."""
    return _masked_leaves(g, VLM_LEAVES, "masked_matmul_vlm")


def _vlm_expected(cfg, res, epochs):
    """The tuning run's launches, counted as ``_family_expected`` counts a
    dense block's: 7 masked linears and the attention per block forward;
    per block the prune walk's student advance, the two evaluations with
    masks and EBFT's loss before and after and student advance, plus one
    per EBFT step, whose backward runs dX and dW of each and the
    attention's backward; the attention also runs unmasked in the dense
    evaluation, the prune walk's taps and EBFT's teacher."""
    n_cal = math.ceil(VLM["calib"] / 8)
    n_ev = math.ceil(VLM["eval"] / 8)
    L = cfg.num_layers
    steps = sum(_epochs_computed(r, epochs) for r in res.reports) * n_cal
    fwd = L * (n_cal + 2 * n_ev + 3 * n_cal) + steps
    out = {k: 0 for k in _counters()}
    out.update(masked_matmul=7 * fwd, masked_matmul_dx=7 * steps, masked_matmul_dw=7 * steps,
               flash_attention=fwd + L * (n_ev + 2 * n_cal), flash_attention_bwd=steps)
    return out


def _greedy(model, params, prompts, extra, conf, tag="vlm", attn=None):
    """Greedy serving of a prompt with its ``extra`` arrays (a VLM's
    patches in front of it, an encoder-decoder's frames beside it) from one
    cache: the prefill (its first token), then conf["max_new"] - 1 decode
    steps, each fenced; every kernel count is set to 0 just before and read
    just after, and only the attention may run: ``attn`` launches (by
    default once a layer per call). Then the card's time for the prefill
    and for one decode step with the host queued ahead (``timed_ms`` of one
    call a window, the median of 5), beside the fenced times."""
    import statistics

    import numpy as np
    import torch

    def length(state):
        return state["len"] if "len" in state else state["cache"]["len"]

    seq = torch.as_tensor(np.stack(prompts), device="cuda").long()
    state = model.init_serve_state(len(prompts), conf["max_len"], "cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, state = model.prefill(params, {"tokens": seq, **extra}, state)
    tok = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks, step_ms, lens = [tok], [], [length(state)]
    for _ in range(conf["max_new"] - 1):
        t1 = time.perf_counter()
        logits, state = model.decode_step(params, tok[:, None], state)
        tok = logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        toks.append(tok)
        lens.append(length(state))
    wall = time.perf_counter() - t0
    launches = read_counts()
    expected = {k: 0 for k in launches}
    expected["flash_attention"] = model.cfg.num_layers * conf["max_new"] if attn is None \
        else attn
    if launches != expected:
        raise AssertionError(f"{tag} greedy: launches {launches}, expected {expected}")
    out = torch.stack(toks, dim=1)
    if out.shape != (len(prompts), conf["max_new"]) or max(lens) > conf["max_len"]:
        raise AssertionError(f"{tag} greedy: tokens {tuple(out.shape)}, len {max(lens)}")
    step_ms.sort()
    batch = {"tokens": seq, **extra}
    fresh = model.init_serve_state(len(prompts), conf["max_len"], "cuda")
    device_ms = {name: statistics.median(timed_ms(fn, reps=1, hold_ms=50.0) for _ in range(5))
                 for name, fn in (("prefill", lambda: model.prefill(params, batch, fresh)),
                                  ("decode", lambda: model.decode_step(params, tok[:, None],
                                                                       state)))}
    del fresh
    return dict(prompts=len(prompts), new_tokens=conf["max_new"], prefill_ms=prefill_ms,
                decode_ms=sum(step_ms) / len(step_ms), decode_p50_ms=step_ms[len(step_ms) // 2],
                prefill_device_ms=device_ms["prefill"], decode_device_ms=device_ms["decode"],
                tokens_per_s=out.numel() / wall, first_len=lens[0], top_len=max(lens),
                launches=launches)


def _kv_repeat_ms(cfg, conf, g):
    """What the GQA repeat costs one decode step: the card's time to repeat
    one layer's cached keys (8 KV heads -> 32 heads) and fold them into the
    kernel's (B·H, max_len, hd) operand, as ``attend_cached`` and
    ``flash_attention_bshd`` do, times two (keys, values) times the layers."""
    import torch

    from repro_torch.models import layers as LY

    B, H, Hkv = conf["slots"], cfg.num_heads, cfg.num_kv_heads
    ml, hd = conf["max_len"], cfg.resolved_head_dim
    kc = torch.randn(B, Hkv, ml, hd, device="cuda", generator=g).to(torch.bfloat16)

    def repeat_fold():
        k = LY._repeat_kv(kc.transpose(1, 2), H // Hkv)
        return k.transpose(1, 2).reshape(B * H, ml, hd).contiguous()

    one = timed_ms(repeat_fold)
    return dict(per_layer_k_ms=one, per_step_ms=2 * cfg.num_layers * one)


def phase_vlm(walls):
    """The VLM family's path on LLaVA-NeXT-Mistral-7B at its published widths
    (d_model 4096, 32 heads x 128 over 8 KV heads, d_ff 14336, vocab 32000,
    rope_theta 1e6), 3 of its 32 layers, bf16, the flash attention kernel,
    seq 2048 = 1024 patch positions + 1024 text tokens: the seeded init
    pretrained VLM["pretrain_steps"] steps through ``launch/train.run``
    (batch 8, its seeded patches, AdamW lr 3e-3), then from those weights,
    each walk and evaluation with the same seeded patches (``extra_batch``):
    the dense perplexity, Wanda 0.7, its perplexity, EBFT (lr 2e-4, 10
    epochs, patience 2) and its perplexity, all in one obs run
    (``chiprun_out/BENCH_ebft_vlm.json``). Every kernel count is set to 0
    just before pretraining and before the tuning run, read just after
    each, and must equal what the blocks give (``_vlm_expected``). Every
    EBFT block loss must drop, EBFT's perplexity must be below Wanda's and
    nothing may be NaN. Then, on the EBFT weights, greedy serving of 8
    multimodal prompts (``_greedy``; the cache's GQA branch, whose
    repeat ``_kv_repeat_ms`` times) and the teacher-forced check of the
    cached decode against the no-cache forward (``_serve_forced``); then
    tiny_vlm and the four dense SMOKE configs on the card against the CPU
    (``phase_tiny_family``). Returns the tuning run's launches and the
    pretraining's."""
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import ebft
    from repro_torch.core.evaluate import perplexity
    from repro_torch.core.masks import prune
    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set, eval_set
    from repro_torch.launch import ebft_run, train
    from repro_torch.launch.api import start_obs_run
    from repro_torch.launch.rooflines import model_flops_per_chip
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP

    t0 = time.perf_counter()
    cfg = vlm_cfg()
    model = build(cfg)
    shape = ShapeConfig("vlm", VLM["seq"], VLM["batch"], "train")
    P = model.input_specs(shape)["patches"].shape[1]
    S = VLM["seq"] - P
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib, ev = calibration_set(corpus, VLM["calib"], S), eval_set(corpus, VLM["eval"], S)
    calib_x, ev_x = _patches(cfg, VLM["calib"], P, 1), _patches(cfg, VLM["eval"], P, 2)
    spec = ebft_run.RunSpec(arch="llava_next_mistral_7b", seed=0, seq=VLM["seq"],
                            calib_samples=VLM["calib"], pretrain_steps=VLM["pretrain_steps"],
                            batch=VLM["batch"], lr=2e-4, epochs=10, bench_out="",
                            kernel_tune="off")
    tspec = train.TrainSpec(arch="llava_next_mistral_7b", steps=VLM["pretrain_steps"],
                            batch=VLM["batch"], seq=VLM["seq"], lr=VLM["pretrain_lr"], seed=0)
    dev = torch.device("cuda")
    # the host's share of a pretraining step: the reference's data_fn draws
    # the step's patches as f64 normals on the host
    t1 = time.perf_counter()
    np.random.default_rng(0).normal(size=(VLM["batch"], P, cfg.d_model)).astype(np.float32)
    draw_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    obs_run = start_obs_run(spec, "ebft", "cuda", name="chip_smoke/vlm", console=False)
    reset_counts()
    with ebft_run._phase(dev, "phase/pretrain", steps=tspec.steps) as sp:
        tr = train.run(cfg, tspec, "cuda", say=lambda *a: None)
    pre = dict(launches=read_counts(), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    dense, hist = tr.params, tr.history
    del tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.perf_counter()
    phases, ppl = {"pretrain": sp.duration}, {}
    with ebft_run._phase(dev, "phase/eval", what="dense") as sp:
        ppl["dense"] = perplexity(model, dense, ev, extra_batch=ev_x)
    phases["eval_dense"] = sp.duration
    with ebft_run._phase(dev, "phase/prune", method="wanda", sparsity=0.7) as sp:
        masks, pruned = prune(model, dense, calib, method="wanda", sparsity=0.7,
                              extra_batch=calib_x)
    phases["prune"] = sp.duration
    ppl["wanda"] = perplexity(model, pruned, ev, extra_batch=ev_x, masks=masks)
    ecfg = ebft.EBFTConfig(lr=spec.lr, epochs=spec.epochs, patience=2)
    with ebft_run._phase(dev, "phase/ebft", lr=spec.lr, epochs=spec.epochs) as sp:
        tuned, reports = ebft.finetune(model, dense, pruned, masks, calib, ecfg,
                                       extra_batch=calib_x)
    phases["ebft"] = sp.duration
    with ebft_run._phase(dev, "phase/eval", what="ebft") as sp:
        ppl["EBFT"] = perplexity(model, tuned, ev, extra_batch=ev_x, masks=masks)
    phases["eval_ebft"] = sp.duration
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    res = ebft_run.RunResult(ppl, phases, SP.sparsity_of(masks, dense), dense, masks, pruned,
                             tuned=tuned, reports=reports)
    summ = obs_run.payload()["metrics"]
    art = finish_obs(obs_run, ebft_run.bench_record(spec, res, summ), "BENCH_ebft_vlm.json")
    expected = _vlm_expected(cfg, res, spec.epochs)
    pre_expected = {k: 0 for k in launches}
    pre_expected.update(flash_attention=cfg.num_layers * tspec.steps,
                        flash_attention_bwd=cfg.num_layers * tspec.steps)
    stats = kernel_stats(art["metrics"])
    per_step = phases["pretrain"] / tspec.steps
    flops = model_flops_per_chip(cfg, shape, 1)
    blocks = [dict(block=r.index, kind=r.kind, loss_before=r.loss_before,
                   loss_after=r.loss_after, epochs_run=r.epochs_run, early_stop=r.early_stop)
              for r in reports]
    row = dict(phase="vlm", arch="llava_next_mistral_7b", num_layers=cfg.num_layers,
               reduced=f"num_layers 32->{cfg.num_layers}", dtype=cfg.dtype,
               attn_impl=cfg.attn_impl,
               seq=VLM["seq"], patches=P, text=S, num_heads=cfg.num_heads,
               num_kv_heads=cfg.num_kv_heads,
               params=sum(t.numel() for _, t in T.leaves_with_path(dense)),
               pretrain=dict(steps=tspec.steps, batch=tspec.batch, lr=tspec.lr,
                             loss=[dict(step=i, loss=l) for i, l in hist],
                             s_per_step=per_step, host_patch_draw_s=draw_s,
                             model_flops_per_step=flops,
                             tflops_6nd=flops / per_step / 1e12,
                             peak_mem_gib=pre["peak_mem_gib"], launches=pre["launches"],
                             expected_launches=pre_expected),
               method="wanda", sparsity=0.7, achieved_sparsity=res.sparsity, perplexity=ppl,
               ebft_below_pruned=ppl["EBFT"] < ppl["wanda"], blocks=blocks, phases_s=phases,
               wall_s=wall, peak_mem_gib=peak,
               live_block_bytes=max(r.live_bytes for r in reports), launches=launches,
               expected_launches=expected,
               obs_booked={k: stats.get(k, {}).get("calls", 0) for k in launches},
               in_run_ms={k: v["mean_ms"] for k, v in stats.items()},
               kernel_s={k: v["total_s"] for k, v in stats.items()},
               artifact="chiprun_out/BENCH_ebft_vlm.json")
    emit(row)
    for k, v in ppl.items():
        if not math.isfinite(v):
            raise AssertionError(f"vlm: {k} perplexity is {v}")
    if not all(math.isfinite(l) for _, l in hist) or not hist[-1][1] < hist[0][1]:
        raise AssertionError(f"vlm: pretraining losses {hist} are not finite or did not drop")
    bad = [b for b in blocks if not (math.isfinite(b["loss_after"])
                                     and b["loss_after"] < b["loss_before"])]
    if bad:
        raise AssertionError(f"vlm: EBFT block losses that did not drop: {bad}")
    if pre["launches"] != pre_expected:
        raise AssertionError(f"vlm: pretraining launches {pre['launches']} != {pre_expected}")
    if launches != expected:
        raise AssertionError(f"vlm: launches {launches} != expected {expected}")
    if any(row["obs_booked"][k] != launches[k] + pre["launches"][k] for k in launches):
        raise AssertionError(f"vlm: obs booked {row['obs_booked']}, the wrappers {launches} "
                             f"after pretraining's {pre['launches']}")
    if not ppl["EBFT"] < ppl["wanda"]:
        raise AssertionError(f"vlm: EBFT perplexity {ppl['EBFT']} is not below the pruned "
                             f"model's {ppl['wanda']}")
    _check_pruned(res, cfg, 1.0 - 0.7, None)
    for path, m in T.leaves_with_path(masks):
        if SP.is_prunable(path, m):
            t = T.get_path(tuned, path)
            if bool((t[~m] != 0).any()) or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"vlm: {path} tuned weights are not 0 in pruned slots or "
                                     "not finite")
    walls["vlm_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    del res, dense, pruned
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    prompts = [corpus.sample(rng, VLM_SERVE["prompt_len"]) for _ in range(VLM_SERVE["slots"])]
    x = {k: torch.as_tensor(v, device="cuda")
         for k, v in _patches(cfg, VLM_SERVE["slots"], P, 3).items()}
    greedy = _greedy(model, tuned, prompts, x, VLM_SERVE)
    forced = _serve_forced(model, tuned, prompts, "vlm ebft", VLM_SERVE, extra=x)
    kv = _kv_repeat_ms(cfg, VLM_SERVE, torch.Generator(device="cuda").manual_seed(0))
    emit(dict(phase="vlm_serve", weights="ebft", patches=P, **VLM_SERVE, greedy=greedy,
              forced=forced, gqa_kv_repeat=dict(kv, share_of_decode_step=kv["per_step_ms"]
                                                / greedy["decode_ms"]),
              phase_s=time.perf_counter() - t0))
    walls["vlm_serve"] = time.perf_counter() - t0
    del tuned, masks, x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tiny_family("tiny_vlm")
    walls["vlm_tiny"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch in DENSE_SMOKES:
        phase_tiny_family(arch, smoke=True)
    walls["dense_smokes"] = time.perf_counter() - t0
    return launches, pre["launches"]


# ---------------------------------------------------------------------------
# the encoder-decoder family: Seamless-M4T-medium at its published widths
# ---------------------------------------------------------------------------
# the masked GEMM at Seamless's leaves (d 1024, 16 heads x 64, d_ff 4096),
# bf16: the attention projections (self- and cross-attention's wq, wk, wv,
# wo) 1024 x 1024, w_up 1024 x 4096, w_down 4096 x 1024, each at the
# decoder's M = 8 x 2048 = 16384 rows and at the encoder's (and the memory
# projections') M = 8 x 256 = 2048
ENCDEC_LEAVES = [("attn", 1024, 1024), ("w_up", 1024, 4096), ("w_down", 4096, 1024)]
ENCDEC_M = {"M2048": 8 * 256, "M16384": M_ROWS}
# seq 2048 decoder tokens and F = max(frontend_len 0, 2048 // 8) = 256
# frames; pretraining through launch/train.run in 2 microbatches (the
# 256256-entry vocabulary's f32 logits and their gradient set the peak),
# EBFT at the paper's settings
ENCDEC = dict(pretrain_steps=50, batch=8, seq=2048, microbatches=2, pretrain_lr=3e-3, calib=16,
              eval=16)
# 8 prompts of 512 tokens over 256 frames each, 32 greedy tokens, a
# 1024-position cache; the teacher-forced check over 32 steps
ENCDEC_SERVE = dict(slots=8, prompt_len=512, max_new=32, max_len=1024, forced_steps=32)


def encdec_cfg(dtype: str = "bfloat16"):
    """Seamless-M4T-medium at its published widths (12 + 12 layers, not
    reduced), with the flash attention kernel."""
    from repro_torch.configs import get_config

    return get_config("seamless_m4t_medium").replace(dtype=dtype, param_dtype=dtype,
                                                     attn_impl="flash")


def phase_masked_matmul_encdec(g):
    """The masked matmul forward, dX and dW at ``ENCDEC_LEAVES``, each at
    both of ``ENCDEC_M``'s row counts (``_masked_leaves``). Returns
    {kernel: {"<leaf> M<rows>": row}}."""
    out = {k: {} for k in MASKED}
    for label, rows in ENCDEC_M.items():
        by_kernel = _masked_leaves(g, {label: ENCDEC_LEAVES}, "masked_matmul_encdec", rows)
        for k in MASKED:
            out[k].update({f"{leaf} {label}": r for leaf, r in by_kernel[label][k].items()})
    return out


def _encdec_expected(cfg, res, epochs):
    """The tuning run's launches, from the block structure: a forward of an
    encoder block runs 6 masked linears and 1 bidirectional attention, of a
    decoder block 10 masked linears (2 of them cross-attention's memory
    projections) and 2 attentions (causal self, cross). Per block the prune
    walk's student advance, the two evaluations with masks, EBFT's loss
    before and after and its student advance, plus one per EBFT step, whose
    backward runs dW of every masked linear and dX of all but the memory
    projections (the memory takes no gradient), and each attention's
    backward. The attention also runs unmasked in the dense evaluation,
    the prune walk's taps and EBFT's teacher. The memory is encoded once per
    microbatch when the decoder segment starts: by the dense encoder in the
    prune walk (unmasked), by the teacher's and the student's (masked) in
    EBFT's."""
    n_cal = math.ceil(ENCDEC["calib"] / 8)
    n_ev = math.ceil(ENCDEC["eval"] / 8)
    E, D = cfg.enc_layers, cfg.num_layers
    steps_e = sum(_epochs_computed(r, epochs) for r in res.reports if r.kind == "enc") * n_cal
    steps_d = sum(_epochs_computed(r, epochs) for r in res.reports if r.kind == "dec") * n_cal
    per_block = n_cal + 2 * n_ev + 3 * n_cal  # masked forwards a block, bar the steps
    out = {k: 0 for k in _counters()}
    out.update(masked_matmul=6 * (E * per_block + steps_e + E * n_cal)
               + 10 * (D * per_block + steps_d),
               masked_matmul_dx=6 * steps_e + 8 * steps_d,
               masked_matmul_dw=6 * steps_e + 10 * steps_d,
               flash_attention=(E + 2 * D) * (3 * n_ev + 6 * n_cal) + 3 * n_cal * E
               + steps_e + 2 * steps_d,
               flash_attention_bwd=steps_e + 2 * steps_d)
    return out


def phase_encdec(walls):
    """The encoder-decoder family's path on Seamless-M4T-medium at its
    published widths (12 encoder + 12 decoder layers, d_model 1024, 16 heads
    x 64, d_ff 4096, GELU, LayerNorm, vocab 256206 padded to 256256; about
    0.88 B parameters), not reduced, bf16, the flash attention kernel, seq
    2048 decoder tokens over F = 256 seeded frames: the seeded init
    pretrained ENCDEC["pretrain_steps"] steps through ``launch/train.run``
    (batch 8 in 2 microbatches, its seeded frames, AdamW lr 3e-3), then from
    those weights, each walk and evaluation with the same seeded frames
    (``extra_batch``): the dense perplexity, Wanda 0.7, its perplexity,
    EBFT (lr 2e-4, 10 epochs, patience 2) and its perplexity, all in one obs
    run (``chiprun_out/BENCH_ebft_encdec.json``). Every kernel count is set
    to 0 just before pretraining and before the tuning run, read just after
    each, and must equal what the blocks give (``_encdec_expected``). Every
    EBFT block loss must drop, encoder's and decoder's, EBFT's perplexity
    must be below Wanda's and nothing may be NaN. Then, at the model level
    on the EBFT weights (the reference's ``Server`` does not serve the
    family), the teacher-forced check of the cached decode against the
    no-cache forward (``_serve_forced``) and greedy serving of 8 prompts
    over their frames (``_greedy``: the prefill encodes the frames, each
    decode step runs the cached self-attention and cross-attention over the
    memory); then tiny_encdec on the card against the CPU
    (``phase_tiny_family``). Returns the tuning run's launches and the
    pretraining's."""
    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import ebft
    from repro_torch.core.evaluate import perplexity
    from repro_torch.core.masks import prune
    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set, eval_set
    from repro_torch.launch import ebft_run, train
    from repro_torch.launch.api import start_obs_run
    from repro_torch.launch.rooflines import model_flops_per_chip
    from repro_torch.models.model import build
    from repro_torch.sparsity import sparse_params as SP

    t0 = time.perf_counter()
    cfg = encdec_cfg()
    model = build(cfg)
    shape = ShapeConfig("encdec", ENCDEC["seq"], ENCDEC["batch"], "train")
    F = model.input_specs(shape)["frames"].shape[1]
    S = ENCDEC["seq"]
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib, ev = calibration_set(corpus, ENCDEC["calib"], S), eval_set(corpus, ENCDEC["eval"], S)
    calib_x, ev_x = _frames(cfg, ENCDEC["calib"], F, 1), _frames(cfg, ENCDEC["eval"], F, 2)
    spec = ebft_run.RunSpec(arch="seamless_m4t_medium", seed=0, seq=S,
                            calib_samples=ENCDEC["calib"],
                            pretrain_steps=ENCDEC["pretrain_steps"], batch=ENCDEC["batch"],
                            lr=2e-4, epochs=10, bench_out="", kernel_tune="off")
    tspec = train.TrainSpec(arch="seamless_m4t_medium", steps=ENCDEC["pretrain_steps"],
                            batch=ENCDEC["batch"], seq=S, lr=ENCDEC["pretrain_lr"], seed=0,
                            microbatches=ENCDEC["microbatches"])
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    obs_run = start_obs_run(spec, "ebft", "cuda", name="chip_smoke/encdec", console=False)
    reset_counts()
    with ebft_run._phase(dev, "phase/pretrain", steps=tspec.steps) as sp:
        tr = train.run(cfg, tspec, "cuda", say=lambda *a: None)
    pre = dict(launches=read_counts(), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    dense, hist = tr.params, tr.history
    del tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.perf_counter()
    phases, ppl = {"pretrain": sp.duration}, {}
    with ebft_run._phase(dev, "phase/eval", what="dense") as sp:
        ppl["dense"] = perplexity(model, dense, ev, extra_batch=ev_x)
    phases["eval_dense"] = sp.duration
    with ebft_run._phase(dev, "phase/prune", method="wanda", sparsity=0.7) as sp:
        masks, pruned = prune(model, dense, calib, method="wanda", sparsity=0.7,
                              extra_batch=calib_x)
    phases["prune"] = sp.duration
    ppl["wanda"] = perplexity(model, pruned, ev, extra_batch=ev_x, masks=masks)
    ecfg = ebft.EBFTConfig(lr=spec.lr, epochs=spec.epochs, patience=2)
    with ebft_run._phase(dev, "phase/ebft", lr=spec.lr, epochs=spec.epochs) as sp:
        tuned, reports = ebft.finetune(model, dense, pruned, masks, calib, ecfg,
                                       extra_batch=calib_x)
    phases["ebft"] = sp.duration
    with ebft_run._phase(dev, "phase/eval", what="ebft") as sp:
        ppl["EBFT"] = perplexity(model, tuned, ev, extra_batch=ev_x, masks=masks)
    phases["eval_ebft"] = sp.duration
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    res = ebft_run.RunResult(ppl, phases, SP.sparsity_of(masks, dense), dense, masks, pruned,
                             tuned=tuned, reports=reports)
    summ = obs_run.payload()["metrics"]
    art = finish_obs(obs_run, ebft_run.bench_record(spec, res, summ), "BENCH_ebft_encdec.json")
    expected = _encdec_expected(cfg, res, spec.epochs)
    attn_pre = (cfg.enc_layers + 2 * cfg.num_layers) * tspec.steps * tspec.microbatches
    pre_expected = {k: 0 for k in launches}
    pre_expected.update(flash_attention=attn_pre, flash_attention_bwd=attn_pre)
    stats = kernel_stats(art["metrics"])
    per_step = phases["pretrain"] / tspec.steps
    flops = model_flops_per_chip(cfg, shape, 1)
    blocks = [dict(block=r.index, kind=r.kind, loss_before=r.loss_before,
                   loss_after=r.loss_after, epochs_run=r.epochs_run, early_stop=r.early_stop)
              for r in reports]
    row = dict(phase="encdec", arch="seamless_m4t_medium", enc_layers=cfg.enc_layers,
               num_layers=cfg.num_layers, reduced=None, dtype=cfg.dtype,
               attn_impl=cfg.attn_impl, seq=S, frames=F, num_heads=cfg.num_heads,
               head_dim=cfg.resolved_head_dim, vocab=cfg.padded_vocab,
               params=sum(t.numel() for _, t in T.leaves_with_path(dense)),
               pretrain=dict(steps=tspec.steps, batch=tspec.batch,
                             microbatches=tspec.microbatches, lr=tspec.lr,
                             loss=[dict(step=i, loss=l) for i, l in hist],
                             s_per_step=per_step, model_flops_per_step=flops,
                             tflops_6nd=flops / per_step / 1e12,
                             peak_mem_gib=pre["peak_mem_gib"], launches=pre["launches"],
                             expected_launches=pre_expected),
               method="wanda", sparsity=0.7, achieved_sparsity=res.sparsity, perplexity=ppl,
               ebft_below_pruned=ppl["EBFT"] < ppl["wanda"], blocks=blocks, phases_s=phases,
               wall_s=wall, peak_mem_gib=peak,
               live_block_bytes=max(r.live_bytes for r in reports), launches=launches,
               expected_launches=expected,
               obs_booked={k: stats.get(k, {}).get("calls", 0) for k in launches},
               in_run_ms={k: v["mean_ms"] for k, v in stats.items()},
               kernel_s={k: v["total_s"] for k, v in stats.items()},
               artifact="chiprun_out/BENCH_ebft_encdec.json")
    emit(row)
    for k, v in ppl.items():
        if not math.isfinite(v):
            raise AssertionError(f"encdec: {k} perplexity is {v}")
    if not all(math.isfinite(l) for _, l in hist) or not hist[-1][1] < hist[0][1]:
        raise AssertionError(f"encdec: pretraining losses {hist} are not finite or did not drop")
    bad = [b for b in blocks if not (math.isfinite(b["loss_after"])
                                     and b["loss_after"] < b["loss_before"])]
    if bad:
        raise AssertionError(f"encdec: EBFT block losses that did not drop: {bad}")
    if [b["kind"] for b in blocks] != ["enc"] * cfg.enc_layers + ["dec"] * cfg.num_layers:
        raise AssertionError(f"encdec: EBFT tuned the blocks {[b['kind'] for b in blocks]}")
    if pre["launches"] != pre_expected:
        raise AssertionError(f"encdec: pretraining launches {pre['launches']} != {pre_expected}")
    if launches != expected:
        raise AssertionError(f"encdec: launches {launches} != expected {expected}")
    if any(row["obs_booked"][k] != launches[k] + pre["launches"][k] for k in launches):
        raise AssertionError(f"encdec: obs booked {row['obs_booked']}, the wrappers {launches} "
                             f"after pretraining's {pre['launches']}")
    if not ppl["EBFT"] < ppl["wanda"]:
        raise AssertionError(f"encdec: EBFT perplexity {ppl['EBFT']} is not below the pruned "
                             f"model's {ppl['wanda']}")
    _check_pruned(res, cfg, 1.0 - 0.7, None)
    for path, m in T.leaves_with_path(masks):
        if SP.is_prunable(path, m):
            t = T.get_path(tuned, path)
            if bool((t[~m] != 0).any()) or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"encdec: {path} tuned weights are not 0 in pruned slots "
                                     "or not finite")
    walls["encdec_path"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    del res, dense, pruned
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    conf = ENCDEC_SERVE
    prompts = [corpus.sample(rng, conf["prompt_len"]) for _ in range(conf["slots"])]
    x = {k: torch.as_tensor(v, device="cuda")
         for k, v in _frames(cfg, conf["slots"], F, 3).items()}
    forced = _serve_forced(model, tuned, prompts, "encdec ebft", conf, extra=x)
    # the prefill encodes the frames (one attention an encoder layer), each
    # call then runs the decoder's self- and cross-attention a layer
    greedy = _greedy(model, tuned, prompts, x, conf, tag="encdec",
                     attn=cfg.enc_layers + 2 * cfg.num_layers * conf["max_new"])
    emit(dict(phase="encdec_serve", weights="ebft", frames=F, **conf, greedy=greedy,
              forced=forced, phase_s=time.perf_counter() - t0))
    walls["encdec_serve"] = time.perf_counter() - t0
    del tuned, masks, x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tiny_family("tiny_encdec")
    walls["encdec_tiny"] = time.perf_counter() - t0
    return launches, pre["launches"]


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# launch plans and the tile autotuner (kernels/validation.py, kernels/tuning.py)
# ---------------------------------------------------------------------------
# the 2-D GEMM shapes every compiled tile is held at: Llama-7B's w_up at the
# slice's M, Seamless's 1024 x 1024 at the encoder's M 2048 (64 output
# tiles of 256 x 128 on 132 SMs), Mamba2-130M's narrow in_B at M 16384
TUNE_GEMMS = [("llama_w_up", M_ROWS, 4096, 11008), ("seamless_1024_M2048", 8 * 256, 1024, 1024),
              ("mamba_in_B", M_ROWS, 768, 128)]
# the attention shapes every compiled (bq, bk) is held at: serving's decode
# step, and every forward the pre-tune searches (Llama-7B's walk at head
# width 128; Seamless-M4T-medium's decoder self-attention, encoder
# self-attention and cross-attention at width 64, 8 rows of 16 heads):
# (BH, Sq, Sk, d, causal, q_offset)
TUNE_ATTN = {"decode": SERVE_ATTN["decode"], "ebft": (256, 2048, 2048, 128, True, 0),
             "seamless_dec_self": (128, 2048, 2048, 64, True, 0),
             "seamless_enc_self": (128, 256, 256, 64, False, 0),
             "seamless_cross": (128, 2048, 256, 64, False, 0)}
# ebft_run at Llama-7B width, searched, then on the warm cache, then off,
# then on a cache whose every entry names a tile other than the default
TUNE_RUN = dict(layers=1, epochs=2, calib=8, seq=2048)
# the tuned run's perplexities against the default tiles': the GEMMs keep
# their summation order on every tile, the attention's key tile moves the
# online softmax's rescale points (bits within the kernel's tolerance)
TUNE_PPL_REL = 1e-2


def _held_candidates(name, tag, cands, launch, check, ref, dtype="bfloat16"):
    """Each candidate's tiles launched (uncounted, as the tuner launches
    them), held to the plain version ``ref`` by ``check``, repeated bit for
    bit, compared bit for bit with the default's (candidate 0) and timed."""
    import torch

    rows, default = [], None
    for tiles in cands:
        out = launch(tiles)
        torch.cuda.synchronize()
        label = f"{name} {tag} {tiles}"
        err = check(label, out, ref, dtype) if not callable(ref) else ref(label, out)
        check_repeat(label, lambda: launch(tiles), out)
        default = out if default is None else default
        rows.append(dict(tiles=tiles, max_abs_err=err,
                         same_bits_as_default=bool(torch.equal(out, default)),
                         ms=timed_ms(lambda: launch(tiles))))
        del out
    return rows


def phase_tuning(g, walls):
    """The launch plans and the tuner on the card.

    (1) every compiled instantiation's plan (``kernels.validation``) held
    to the library's own query and ``cudaFuncGetAttributes`` (shared
    memory, threads, stages; registers and spilled bytes printed); (2)
    every compiled candidate of every bf16 route (masked forward, dX, dW,
    dM, 2-D at ``TUNE_GEMMS`` and batched at DeepSeek's w_up slabs,
    ``nm_spmm`` 2:4 at Llama's w_up, the attention forward at
    ``TUNE_ATTN``) held to its plain version within the route's tolerance,
    repeated bit for bit, with whether its bits equal the default's and its
    time; (3) ``tuning.pretune`` in ``search`` mode, into a cache under a
    temporary directory, over ``ebft_workloads`` of Llama-7B and
    Seamless-M4T-medium: each workload's default and best ms, then the
    static checks over that cache (``phase_analysis``); (4)
    ``ebft_run.run`` at Llama-7B width (``TUNE_RUN``) with
    ``kernel_tune="search"``, then ``"cache"`` on that cache, then
    ``"off"``, then ``"cache"`` on a copy of the cache whose every entry
    names its last candidate (128 x 64 GEMMs, 64 / 64 attention): the
    cache runs' artifacts pass the warm-cache validation, the first's
    perplexities equal the search run's bit for bit, both lie within
    ``TUNE_PPL_REL`` of the off run's, every run launches what the off
    run launches, the kernel spans show the plan each tuned launch ran,
    and the forced run's show the other tiles on every route it tuned.
    The earlier phases run with the tuner off."""
    import tempfile

    import torch

    from repro_torch.kernels import _build, tuning
    from repro_torch.kernels import validation as V
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.kernels.masked_matmul import ref as MR
    from repro_torch.kernels.nm_spmm import ops as NM
    from repro_torch.kernels.nm_spmm.ref import nm_spmm_plain
    from repro_torch.launch import ebft_run
    from repro_torch.launch.api import start_obs_run
    from repro_torch.obs.run import validate_payload
    from repro_torch.sparsity import sparse_params as SP

    t0 = time.perf_counter()
    # (1) the plans against the compiled kernels
    inst = {}
    for r, route in enumerate(("masked_matmul", "masked_matmul_dx", "masked_matmul_dw",
                               "masked_matmul_dm")):
        for bm, bn in V.GEMM_TILES:
            inst[f"{route} {bm}x{bn}"] = (V.plan_masked_matmul(route, 4096, 4096, 4096, bm=bm,
                                                               bn=bn),
                                          _build.query("masked_matmul", r, bm, bn))
    for m in V.NM_GROUPS:
        for n in range(1, m + 1):
            for bm, bn in V.GEMM_TILES:
                inst[f"nm_spmm {n}:{m} {bm}x{bn}"] = (
                    V.plan_nm_spmm(4096, 4096, 4096, n=n, m=m, bm=bm, bn=bn),
                    _build.query("nm_spmm", n, m, bm, bn))
    for d, tiles in V.ATTN_TILES.items():
        for bq, bk in tiles:
            inst[f"flash_attention d{d} {bq}/{bk}"] = (
                V.plan_flash_attention(256, 2048, 2048, d, bq=bq, bk=bk),
                _build.query("flash_attention", d, bq, bk))
    for label, (plan, q) in inst.items():
        if (q["smem"], q["threads"], q["stages"], q["max_dynamic_smem"], q["static_smem"]) != \
                (plan.smem, plan.threads, plan.stages, plan.smem, 0) or \
                q["max_threads"] < plan.threads:
            raise AssertionError(f"tuning: {label}: plan {plan.smem} B, {plan.threads} threads, "
                                 f"{plan.stages} stages; the compiled kernel {q}")
    emit(dict(phase="tuning_plans", instantiations=len(inst),
              plans_equal_the_compiled_kernels=True,
              kernels={label: {k: q[k] for k in ("smem", "threads", "stages", "regs",
                                                  "local_bytes")}
                       for label, (_, q) in inst.items()},
              spills={label: q["local_bytes"] for label, (_, q) in inst.items()
                      if q["local_bytes"]}))

    # (2) every candidate of every bf16 route against its plain version
    bf = torch.bfloat16
    mm_dt = {"x": "bfloat16", "w": "bfloat16"}
    same_bits = {}

    def held(route, tag, dims, args, plain, check):
        cands = tuning.candidate_tiles(route, dims, mm_dt)
        base = route.replace("_batched", "")
        rows = _held_candidates(route, tag, cands,
                                lambda t: MM.launch_uncounted(base, *args, t), check,
                                plain(*args))
        same_bits[f"{route} {tag}"] = all(r["same_bits_as_default"] for r in rows)
        emit(dict(phase="tuning_candidates", route=route, shape=tag, **dims, candidates=rows))

    for tag, M, K, N in TUNE_GEMMS:
        x = torch.randn(M, K, device="cuda", generator=g).to(bf)
        w = (torch.randn(K, N, device="cuda", generator=g) / math.sqrt(K)).to(bf)
        m = torch.rand(K, N, device="cuda", generator=g) < 0.3
        dy = torch.randn(M, N, device="cuda", generator=g).to(bf)
        dims = {"M": M, "K": K, "N": N}
        held("masked_matmul", tag, dims, (x, w, m), MR.masked_matmul_plain, check_close)
        held("masked_matmul_dx", tag, dims, (dy, w, m), MR.masked_matmul_dx_plain, check_scaled)
        held("masked_matmul_dw", tag, dims, (x, dy, m), MR.masked_matmul_dw_plain, check_scaled)
        held("masked_matmul_dm", tag, dims, (x, dy, w), MR.masked_matmul_dm_plain, check_scaled)
        if tag == "llama_w_up":  # nm_spmm 2:4 on the same x, its plain and masked_matmul's bits
            mn = SP.nm_mask(torch.rand(K, N, device="cuda", generator=g), 2, 4)
            vals, idx = SP.nm_compress(w, mn, 2, 4)
            absprod = x.float().abs() @ (w * mn.to(bf)).float().abs()
            plain = nm_spmm_plain(x, vals, idx, n=2, m=4)
            mm_bits = MM.launch_uncounted("masked_matmul", x, w, mn, {})
            cands = tuning.candidate_tiles("nm_spmm", dims, {"x": "bfloat16", "v": "bfloat16"},
                                           {"n": 2, "m": 4})

            def nm_check(label, out):
                if not torch.equal(out, mm_bits):
                    raise AssertionError(f"{label}: not masked_matmul's bits")
                return check_bounded(label, out, plain, absprod, TOL["bfloat16"])[0]

            rows = _held_candidates("nm_spmm", tag, cands,
                                    lambda t: NM.launch_uncounted(x, vals, idx, 2, 4, t),
                                    None, nm_check)
            same_bits[f"nm_spmm {tag}"] = all(r["same_bits_as_default"] for r in rows)
            emit(dict(phase="tuning_candidates", route="nm_spmm", shape=tag, n=2, m=4, **dims,
                      limit=f"{TOL['bfloat16']} x |x| @ |w*m| per element; bitwise vs "
                            "masked_matmul", candidates=rows))
            del mn, vals, idx, absprod, plain, mm_bits
        del x, w, m, dy
        torch.cuda.empty_cache()
    _, E, C, K, N = MOE_SLABS[0]
    x = torch.randn(E, C, K, device="cuda", generator=g).to(bf)
    w = (torch.randn(E, K, N, device="cuda", generator=g) / math.sqrt(K)).to(bf)
    m = torch.rand(E, K, N, device="cuda", generator=g) < 0.3
    dy = torch.randn(E, C, N, device="cuda", generator=g).to(bf)
    dims = {"E": E, "M": C, "K": K, "N": N}
    held("masked_matmul_batched", "moe_w_up", dims, (x, w, m), MR.masked_matmul_batched_plain,
         check_close)
    held("masked_matmul_batched_dx", "moe_w_up", dims, (dy, w, m),
         MR.masked_matmul_batched_dx_plain, check_scaled)
    held("masked_matmul_batched_dw", "moe_w_up", dims, (x, dy, m),
         MR.masked_matmul_batched_dw_plain, check_scaled)
    held("masked_matmul_batched_dm", "moe_w_up", dims, (x, dy, w),
         MR.masked_matmul_batched_dm_plain, check_scaled)
    del x, w, m, dy
    torch.cuda.empty_cache()
    for tag, (BH, Sq, Sk, d, causal, off) in TUNE_ATTN.items():
        q, k, v = (torch.randn(BH, S, d, device="cuda", generator=g).to(bf) for S in (Sq, Sk, Sk))
        cands = tuning.candidate_tiles("flash_attention", {"BH": BH, "Sq": Sq, "Sk": Sk, "d": d},
                                       {"q": "bfloat16"}, {"causal": causal})
        rows = _held_candidates("flash_attention", tag, cands,
                                lambda t: FA.launch_uncounted(q, k, v, causal, off, t),
                                check_close,
                                flash_attention_plain(q, k, v, causal=causal, q_offset=off))
        same_bits[f"flash_attention {tag}"] = all(r["same_bits_as_default"] for r in rows)
        emit(dict(phase="tuning_candidates", route="flash_attention", shape=tag, BH=BH, Sq=Sq,
                  Sk=Sk, d=d, causal=causal, q_offset=off, candidates=rows))
        del q, k, v
    emit(dict(phase="tuning_same_bits", every_candidate_equals_the_default=same_bits))

    with tempfile.TemporaryDirectory() as tmp:
        # (3) pretune in search mode over two configs' EBFT walks
        tuning.configure(mode="search", path=os.path.join(tmp, "kernels.json"))
        tuning.reset_stats()
        t1 = time.perf_counter()
        work = [("llama_7b", w) for w in tuning.ebft_workloads(llama_cfg(), M_ROWS, 2048)] + \
            [("seamless_m4t_medium", w) for w in tuning.ebft_workloads(encdec_cfg(), M_ROWS,
                                                                         2048)]
        held_attn = {v[:5] for v in TUNE_ATTN.values()}
        unheld = [(d, p) for _, (k, d, _, p) in work if k == "flash_attention" and
                  (d["BH"], d["Sq"], d["Sk"], d["d"], p["causal"]) not in held_attn]
        if unheld:
            raise AssertionError(f"tuning: attention workloads whose candidates were not held "
                                 f"to the plain version: {unheld}")
        tuning.pretune([w for _, w in work], device="cuda")
        pretune_s = time.perf_counter() - t1
        entries = json.load(open(os.path.join(tmp, "kernels.json")))["entries"]
        kind, rev = torch.cuda.get_device_name(0), tuning.code_rev()
        table = []
        for arch, (kernel, dims, dtypes, params) in work:
            e = entries[tuning.cache_key(kernel, dims, dtypes, params, "cuda", kind, rev)]
            ms = e["measured_s"]
            table.append(dict(arch=arch, kernel=kernel, dims=dims, params=params,
                              tiles=e["tiles"], candidates=e["candidates"],
                              default_ms=ms["default"] * 1e3, best_ms=ms["best"] * 1e3,
                              all_ms={json.dumps(t): s * 1e3 for t, s in ms["all"]}))
            if ms["best"] > ms["default"]:
                raise AssertionError(f"tuning: {kernel} {dims}: best above the default")
        emit(dict(phase="tuning_pretune", workloads=len(work), seconds=pretune_s,
                  stats=tuning.stats(), table=table))
        phase_analysis(os.path.join(tmp, "kernels.json"))

        # (4) ebft_run searched, then on the warm cache, then off
        cfg = llama_cfg(TUNE_RUN["layers"])
        cache = os.path.join(tmp, "ebft_run.json")
        forced = os.path.join(tmp, "ebft_run_forced.json")
        ppl, arts, counts, secs = {}, {}, {}, {}
        for mode in ("search", "cache", "off", "forced"):
            if mode == "forced":  # every entry the search wrote, on its last candidate
                with open(cache) as f:
                    payload = json.load(f)
                for e in payload["entries"].values():
                    e["tiles"] = tuning.candidate_tiles(e["kernel"], e["dims"], e["dtypes"],
                                                        e["params"])[-1]
                with open(forced, "w") as f:
                    json.dump(payload, f)
            spec = ebft_run.RunSpec(arch="llama_7b", seed=0, seq=TUNE_RUN["seq"],
                                    calib_samples=TUNE_RUN["calib"], pretrain_steps=0, lr=2e-4,
                                    epochs=TUNE_RUN["epochs"], bench_out="",
                                    kernel_tune="cache" if mode == "forced" else mode,
                                    kernel_cache=forced if mode == "forced" else cache)
            torch.cuda.synchronize()
            reset_counts()
            obs_run = start_obs_run(spec, "ebft", "cuda", name=f"chip_smoke/tune_{mode}",
                                    console=False)
            t1 = time.perf_counter()
            res = ebft_run.run(cfg, spec, "cuda")
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t1
            counts[mode] = read_counts()
            summ = obs_run.payload()["metrics"]
            arts[mode] = finish_obs(obs_run, ebft_run.bench_record(spec, res, summ),
                                    f"BENCH_ebft_tune_{mode}.json")
            ppl[mode] = res.perplexity
            del res
            torch.cuda.empty_cache()
        tuning.configure(mode="off")
    for mode in ("cache", "forced"):
        problems = validate_payload(arts[mode], require=OBS_REQUIRE, require_cache_hits=True)
        kt = arts[mode]["kernel_tuning"]
        if problems or kt["misses"] or kt["searches"]:
            raise AssertionError(f"tuning: the {mode} run's artifact is not warm: {problems} "
                                 f"{kt}")
    if ppl["cache"] != ppl["search"]:
        raise AssertionError(f"tuning: cache run {ppl['cache']} != search run {ppl['search']}")
    rel = {mode: {k: abs(ppl[mode][k] / ppl["off"][k] - 1) for k in ppl["off"]}
           for mode in ("cache", "forced")}
    if max(max(r.values()) for r in rel.values()) > TUNE_PPL_REL:
        raise AssertionError(f"tuning: tuned perplexities {ppl} against off's, rel {rel}")
    if any(counts[m] != counts["off"] for m in counts) or counts["off"]["masked_matmul"] == 0:
        raise AssertionError(f"tuning: launches differ across modes: {counts}")

    def kernel_spans(nodes, out):
        for sp in nodes:
            if sp["name"].startswith("kernels/") and "plan" in sp.get("attrs", {}):
                a = sp["attrs"]
                key = f"{sp['name']} {a['plan']} " + json.dumps(
                    {k: v for k, v in a.items() if k != "plan"}, sort_keys=True)
                out[key] = out.get(key, 0) + 1
            kernel_spans(sp.get("children", []), out)
        return out

    plans = kernel_spans(arts["cache"]["trace"], {})
    if sum(plans.values()) == 0:
        raise AssertionError("tuning: no launch of the cache run booked its tuned plan")
    # the forced run: each tuned route's launches all on a tile other than its default
    forced_plans = kernel_spans(arts["forced"]["trace"], {})
    routes = {}
    for key, n in forced_plans.items():
        name, _, tiles = key.split(" ", 2)
        default = _default_tiles(name.removeprefix("kernels/"))
        routes.setdefault(name, set()).add(json.loads(tiles) != default)
    if not routes or any(v != {True} for v in routes.values()) or \
            "kernels/flash_attention" not in routes:
        raise AssertionError(f"tuning: the forced run booked {forced_plans}")
    walls["tuning"] = time.perf_counter() - t0
    emit(dict(phase="tuning_ebft_run", layers=TUNE_RUN["layers"], epochs=TUNE_RUN["epochs"],
              perplexity=ppl, rel_tuned_vs_off=rel, tol=TUNE_PPL_REL, seconds=secs,
              kernel_tuning={m: arts[m]["kernel_tuning"] for m in arts},
              launches=counts["cache"], tuned_launches_by_plan=plans,
              forced_launches_by_plan=forced_plans, warm_cache_valid=True,
              seconds_phase=walls["tuning"]))


def _query_key(plan):
    """The ``_build.query`` key of a bf16 plan's compiled instantiation, or
    None where the library exports no query (the attention backward)."""
    from repro_torch.analysis.kernel_check import NM

    t = plan.tiles
    if plan.kernel == "masked_matmul":
        base = plan.route.replace("masked_matmul_batched", "masked_matmul")
        routes = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "masked_matmul_dm")
        return ("masked_matmul", routes.index(base), t["bm"], t["bn"])
    if plan.kernel == "nm_spmm":
        return ("nm_spmm", *NM, t["bm"], t["bn"])
    if plan.route == "flash_attention":
        return ("flash_attention", plan.maps[0].dims[0], t["bq"], t["bk"])
    return None


def phase_analysis(cache_path):
    """The static checks (``python -m repro_torch.analysis``) on this
    machine, in a subprocess with the card hidden, over every config and
    pass with ``--tuning-cache`` the tuning phase's searched cache: exit 0,
    no error and no TUN finding. Beside it, the seeded fixtures
    (``tests/_torch_analysis_fixtures.py``) must exit 1 with KER001 and
    CFG002. Every bf16 plan the kernel pass builds for Llama-7B and
    Seamless-M4T-medium is held to the compiled kernel's own query
    (shared memory, threads, stages), as the tuning phase holds its plans;
    the attention backward exports no query."""
    from collections import Counter

    from repro_torch.analysis.kernel_check import planned
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    cmd = [sys.executable, "-m", "repro_torch.analysis", "--json"]
    t0 = time.perf_counter()
    procs = {"all": subprocess.Popen(cmd + ["--tuning-cache", cache_path], env=env, cwd=ROOT,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
             "fixtures": subprocess.Popen(cmd + ["--configs", "tiny_dense", "--passes", "kernels",
                                                 "sharding", "--extra-config-module",
                                                 "_torch_analysis_fixtures"],
                                          env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True)}
    held, no_query, seen = 0, Counter(), {}
    for arch in ("llama_7b", "seamless_m4t_medium"):
        plans, _ = planned(arch, get_config(arch))
        for loc, plan in plans:
            if plan.dtype != "bfloat16":
                continue
            key = _query_key(plan)
            if key is None:
                no_query[plan.route] += 1
                continue
            if key not in seen:
                seen[key] = _build.query(*key)
            q = seen[key]
            if (q["smem"], q["threads"], q["stages"], q["max_dynamic_smem"], q["static_smem"]) != \
                    (plan.smem, plan.threads, plan.stages, plan.smem, 0) or \
                    q["max_threads"] < plan.threads:
                raise AssertionError(f"analysis: {arch} {loc}: plan {plan.smem} B, "
                                     f"{plan.threads} threads, {plan.stages} stages; the "
                                     f"compiled kernel {q}")
            held += 1
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[name] = (p.returncode, stdout, stderr, time.perf_counter() - t0)
    rc, stdout, stderr, secs = out["all"]
    if rc != 0:
        raise AssertionError(f"analysis: exit {rc}\n{stdout[-4000:]}\n{stderr[-4000:]}")
    findings = json.loads(stdout)["findings"]
    bad = [f for f in findings if f["severity"] == "error" or f["code"].startswith("TUN")]
    if bad:
        raise AssertionError(f"analysis: {bad}")
    entries = len(json.load(open(cache_path))["entries"])
    frc, fout, ferr, _ = out["fixtures"]
    fcodes = {f["code"] for f in json.loads(fout)["findings"]} if fout.strip() else set()
    if frc != 1 or not {"KER001", "CFG002"} <= fcodes:
        raise AssertionError(f"analysis: the fixtures exit {frc} with {fcodes}\n{ferr[-4000:]}")
    emit(dict(phase="analysis", seconds=secs, exit_code=rc, cache_entries=entries,
              counts=dict(Counter(f["code"] for f in findings)),
              findings=[f"{f['code']} {f['config']} {f['location']}" for f in findings],
              fixtures_exit_code=frc, fixtures_codes=sorted(fcodes),
              plans_held_to_query=held, instantiations_queried=len(seen),
              plans_without_query=dict(no_query),
              seconds_phase=time.perf_counter() - t0))


def _default_tiles(name: str) -> dict:
    """The tiles of a kernel row's default launch plan (bf16)."""
    from repro_torch.kernels import validation as V

    if name == "flash_attention":
        return V.plan_flash_attention(1, 128, 128, 128).tiles
    if name == "flash_attention_bwd":
        return V.plan_flash_attention(1, 128, 128, 128, route="flash_attention_bwd").tiles
    if name == "nm_spmm":
        return V.plan_nm_spmm(256, 256, 256, n=2, m=4).tiles
    return V.plan_masked_matmul(name, 256, 256, 256, E=2 if "batched" in name else 1).tiles


# ---------------------------------------------------------------------------
# the EBFT walk on a mesh of ranks (core/ebft.py with an active MeshPlan)
# ---------------------------------------------------------------------------
# Llama-7B's widths at 1 layer in f32 (the kernels' f32 routes), 8
# segments of 2048 in one microbatch, 2 EBFT epochs; magnitude 0.5 (2
# layers and 16 segments before the sharded cells joined the phase: the
# cut pays for them)
MESH = dict(arch="llama_7b", layers=1, seq=2048, calib=8, microbatch=8, epochs=2, lr=2e-4,
            sparsity=0.5)
# the sharded cells of launch/steps.py and launch/train on the same ranks,
# at the walk's widths, depth and seq: the train cell (bf16, chunked
# attention, block remat) 2 steps on 4 samples (one a data shard a
# microbatch); the ebft cell (one Adam step on 4 samples) in the TP and
# the dp_only layouts, one mesh's at a time (four ranks' chunked attention
# at once outgrew the card's 80 GB); the prefill cell on 8 prompts of 512 tokens, then 8
# greedy decode cells; launch/train.run (f32, the flash kernel) 2 steps
# checkpointed at step 2 on the first mesh, resumed on the second for a
# third, against one process's 3
MESH_CELLS = dict(train_batch=4, train_steps=2, train_lr=1e-4, ebft_batch=4, prompts=8,
                  prompt_len=512, decode_steps=8, launch_batch=2, launch_steps=3, ckpt_step=2)
# stated tolerances: the bf16 cells' losses rtol 5e-3, grad norms 2e-2;
# logits within 3e-2 of the step's largest, greedy tokens equal where one
# process's top two are more than twice that apart; the f32 launcher's
# losses (every step) rtol 2e-3, atol 1e-5. The updated state, each leaf
# against one process's in relative L2 (``_state_errors``): the weights'
# difference over one process's update (new - init), the moments'
# difference over one process's moments (Adam's m carries the gradient).
# Read (H100, PR 27): the bf16 cells' weights at most 0.070, moments
# 0.012; the f32 launcher 2.6e-5 and 2.5e-6. Planted on the CPU rehearsal:
# unsummed gradients 0.7-1.04, no update 1.0, swapped shards 139-326
# (weights) and 0.8-1.4 (moments). Each limit sits between the two
CELL_LOSS_RTOL, CELL_NORM_RTOL, CELL_LOGIT_REL = 5e-3, 2e-2, 3e-2
CELL_UPDATE_REL, CELL_MOMENT_REL = 0.3, 0.1  # bf16
LAUNCH_UPDATE_REL, LAUNCH_MOMENT_REL = 5e-3, 5e-3  # f32
SAMPLE = 1 << 18  # the elements of a leaf the state checks read
MESH_SHAPES = ((2, 1), (1, 2))  # (data, model): 2 ranks each, all on the one card
MESH_KERNELS = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "flash_attention",
                "flash_attention_bwd")
MESH_RTOL, MESH_ATOL = 2e-3, 1e-5  # the reference's own (tests/test_mesh_ebft.py)


def _mesh_setup(device, layers, conf=MESH):
    """The mesh phase's model, weights (seeded on ``device``), magnitude
    masks, calibration segments and their frontend arrays (a VLM's seeded
    patches in front of ``seq - P`` tokens, an encoder-decoder's seeded
    frames beside ``seq``: ``Model.input_specs``; None for the other
    families); every rank builds the same bits."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.masks import prune
    from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set
    from repro_torch.models.model import build

    cfg = _cells_cfg(dict(conf, layers=layers)).replace(dtype="float32", param_dtype="float32",
                                                        attn_impl="flash")
    model = build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    specs = model.input_specs(ShapeConfig("mesh", conf["seq"], conf["calib"], "train"))
    calib = calibration_set(SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0)),
                            conf["calib"], specs["tokens"].shape[1])
    extra = None
    if "patches" in specs:
        extra = _patches(cfg, conf["calib"], specs["patches"].shape[1], 11)
    elif "frames" in specs:
        extra = _frames(cfg, conf["calib"], specs["frames"].shape[1], 11)
    masks, pruned = prune(model, params, np.asarray(calib), method="magnitude",
                          sparsity=conf["sparsity"], extra_batch=extra)
    return model, params, pruned, masks, calib, extra


@contextlib.contextmanager
def _forward_shapes():
    """The (M, K, N) of every masked-matmul forward launched inside, as a
    set (on a mesh, each rank's local shapes)."""
    from repro_torch.kernels.masked_matmul import ops as MM

    shapes, call = set(), MM._call

    def spy(fn, a, b, c, tiles=None, **kw):
        if fn == "masked_matmul" and a.dim() == 2:
            shapes.add((a.shape[0], a.shape[1], b.shape[1]))
        return call(fn, a, b, c, tiles, **kw)

    MM._call = spy
    try:
        yield shapes
    finally:
        MM._call = call


def _frontend_arrays(model, shape, g, device) -> dict:
    """A cell batch's arrays beside its tokens (``Model.input_specs``: a
    VLM's patches, an encoder-decoder's frames), seeded normals on
    ``device`` in the specs' dtype; {} for the token-only families."""
    import torch

    return {k: torch.randn(sp.shape, generator=g, device=device).to(sp.dtype)
            for k, sp in model.input_specs(shape).items() if k != "tokens"}


def _mesh_ecfg(plan=None, conf=MESH):
    from repro_torch.core import ebft

    return ebft.EBFTConfig(lr=conf["lr"], epochs=conf["epochs"], microbatch=conf["microbatch"],
                           mesh_plan=plan)


def _cells_cfg(conf):
    """``conf``'s config at its depth (an encoder-decoder's ``enc_layers``
    too, when given)."""
    from repro_torch.configs import get_config

    return get_config(conf["arch"]).replace(
        num_layers=conf["layers"], **{k: conf[k] for k in ("enc_layers",) if k in conf})


def _leaf_samples(tree) -> dict:
    """{leaf: f64 host tensor} of each floating leaf at ``SAMPLE`` seeded
    positions, the same in every process (the whole leaf when smaller); a
    DTensor's are read from the ranks' pieces (``_dtensor_at``), never
    gathered whole. The relative L2 of a difference over 2^18 uniform
    positions is the whole leaf's within a few per cent."""
    import torch

    from repro_torch import tree as T
    from repro_torch.distributed.local_kernels import any_dtensor

    out = {}
    for p, t in T.leaves_with_path(tree):
        if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
            continue
        n = t.numel()
        idx = torch.randint(n, (SAMPLE,), generator=torch.Generator().manual_seed(n)) \
            if n > SAMPLE else torch.arange(n)
        if any_dtensor(t):
            out["/".join(p)] = _dtensor_at(t, idx)
        else:
            out["/".join(p)] = t.detach().reshape(-1)[idx.to(t.device)].double().cpu()
    return out


def _dtensor_at(t, idx):
    """A DTensor's elements at the flat positions ``idx`` of its global
    shape, on every rank (a collective): each rank reads the positions
    that its piece holds (one rank of each replica), and one host
    all-reduce of ``len(idx)`` values over the default group (the mesh's
    ranks) sums the pieces."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, placements = t.device_mesh, t.placements
    if any(p.is_partial() for p in placements):
        raise ValueError("mesh: a Partial leaf has no elements to sample")
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, placements)
    coords = torch.stack(torch.unravel_index(idx, tuple(t.shape)))  # (ndim, k)
    lo = torch.tensor(offset)[:, None]
    inside = ((coords >= lo) & (coords < lo + torch.tensor(shape)[:, None])).all(0)
    if any(not p.is_shard() and mesh.get_local_rank(d) != 0 for d, p in enumerate(placements)):
        inside[:] = False  # a replica's copy: its coordinate-0 rank reads it
    sel = inside.nonzero().squeeze(1)
    vals = torch.zeros(len(idx), dtype=torch.float64)
    if len(sel):
        local = t.to_local().detach()
        pos = torch.tensor(0)
        for d in range(len(shape)):  # the positions in the piece, row-major
            pos = pos * shape[d] + (coords[d, sel] - offset[d])
        vals[sel] = local.reshape(-1)[pos.to(local.device)].double().cpu()
    dist.all_reduce(vals)  # the phase's meshes span their whole group
    return vals


def _moments(opt_state) -> dict:
    return {"m": opt_state["m"], "v": opt_state["v"]}


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def mesh_cells(device, mesh, conf, cells, logits_path, ebft_after=None, ebft_done=None,
               parts=("train", "ebft", "serve"), layouts=(False, True), dtypes=None):
    """The train, ebft, prefill and decode cells of ``launch/steps.py`` on
    ``mesh`` (the ranks' ``DeviceMesh``, or an ``AbstractMesh``: one
    process, plain tensors, the config that mesh's cells take) at
    ``conf``'s widths and seq, seeded on ``device``. Returns their record;
    the serving steps' logits go to ``logits_path``. The masked-matmul
    launches of the ebft cells are counted from 0, with their local shapes.
    The ebft cells wait for the file ``ebft_after`` when given, and rank 0
    then writes ``ebft_done``. ``parts`` picks the cells, ``layouts`` the
    ebft cell's ``dp_only`` values, ``dtypes`` ({"train" or "serve":
    dtype}) the train or serving cells' weights and activations in place
    of the cells' own bf16."""
    import torch

    cfg, seq, rec = _cells_cfg(conf), conf["seq"], {}
    g, dtypes = torch.Generator(device=device).manual_seed(0), dtypes or {}
    if "train" in parts:
        with _cell_dtype(dtypes.get("train")):
            rec["train"] = _train_cell(device, mesh, cfg, seq, cells, g)
    if "ebft" in parts:
        rec.update(_ebft_cells(device, mesh, cfg, seq, cells, layouts, ebft_after, ebft_done))
    if "serve" in parts:
        with _cell_dtype(dtypes.get("serve")):
            rec["serve"] = _serve_cells(device, mesh, cfg, cells, logits_path)
    return rec


@contextlib.contextmanager
def _cell_dtype(dtype):
    """The cells built inside take ``dtype`` (None: their own bf16) for
    their weights and activations."""
    from repro_torch.launch import steps as ST

    adapt = ST.adapt_config
    if dtype is not None:
        ST.adapt_config = lambda *a, **k: adapt(*a, **k).replace(dtype=dtype, param_dtype=dtype)
    try:
        yield
    finally:
        ST.adapt_config = adapt


def _train_cell(device, mesh, cfg, seq, cells, g) -> dict:
    """The train cell: ``train_steps`` steps from the seeded init."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as ST
    from repro_torch.optim.optimizers import adamw

    shape = ShapeConfig("mesh_train", seq, cells["train_batch"], "train")
    cell = ST.build_train_cell(cfg, shape, mesh, lr=cells["train_lr"], fsdp=False)
    params = cell.model.init(g)
    opt_state = adamw(cells["train_lr"]).init(params)
    text = cell.model.input_specs(shape)["tokens"].shape[1]
    toks = torch.randint(0, cfg.vocab_size, (cells["train_batch"], text), generator=g,
                         device=device, dtype=torch.int32)
    batch = {"tokens": toks, **_frontend_arrays(cell.model, shape, g, device)}
    losses, norms, step_s = [], [], []
    init = _leaf_samples(params)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for _ in range(cells["train_steps"]):
        _sync(device)
        t0 = time.perf_counter()
        params, opt_state, m = ST.run_cell(cell, mesh, params, opt_state, batch)
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    return dict(losses=losses, grad_norms=norms, step_s=step_s, peak_gib=peak,
                samples=dict(init=init, params=_leaf_samples(params),
                             moments=_leaf_samples(_moments(opt_state))),
                microbatches=ST.microbatches_for(cell.cfg, ShapeConfig(
                    "t", seq, cells["train_batch"], "train"), mesh))


def _ebft_cells(device, mesh, cfg, seq, cells, layouts, ebft_after, ebft_done) -> dict:
    """The ebft cell on the mid-stack block in each of ``layouts``
    (``dp_only`` False: tensor-parallel; True: the block replicated)."""
    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.launch import steps as ST
    from repro_torch.optim.optimizers import adam

    rec, shapes = {}, set()
    call = MM._call

    def spy(fn, a, b, c, tiles=None, **kw):
        shapes.add((fn, tuple(a.shape), tuple(b.shape)))
        return call(fn, a, b, c, tiles, **kw)

    MM._call = spy
    deadline = time.perf_counter() + 600
    while ebft_after and not os.path.exists(ebft_after):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"mesh: {ebft_after} never appeared")
        time.sleep(0.2)
    try:
        for dp_only in layouts:
            cell = ST.build_ebft_cell(cfg, ShapeConfig("mesh_ebft", seq, cells["ebft_batch"],
                                                       "ebft"), mesh, dp_only=dp_only)
            ge = torch.Generator(device=device).manual_seed(1)
            # the cell's block: mid-stack, an encoder block for the encoder-decoder
            i = cfg.enc_layers // 2 if cfg.family == "encdec" else cell.model.num_blocks // 2
            bw = T.tree_map(torch.clone, cell.model.get_block(cell.model.init(ge), i))
            masks = T.tree_map(lambda t: ((torch.rand(t.shape, generator=ge, device=device) < 0.5)
                                          | (t.dim() < 2)).to(torch.bfloat16), bw)
            h, tgt = (torch.randn(cells["ebft_batch"], seq, cfg.d_model, generator=ge,
                                  device=device).to(torch.bfloat16) for _ in range(2))
            pos = torch.arange(seq, dtype=torch.int32, device=device)[None]
            init = _leaf_samples(bw)
            shapes.clear()
            reset_counts()
            _sync(device)
            t0 = time.perf_counter()
            nbw, opt_state, loss = ST.run_cell(cell, mesh, bw, adam(2e-4).init(bw), masks, h, tgt,
                                               pos)
            _sync(device)
            counts = read_counts()
            batched = cfg.family == "moe"  # the routed experts' launches too
            rec["ebft_dp_only" if dp_only else "ebft_tp"] = dict(
                loss=float(loss), seconds=time.perf_counter() - t0, block=i,
                samples=dict(init=init, params=_leaf_samples(nbw),
                             moments=_leaf_samples(_moments(opt_state))),
                launches={k: counts[k] for k in ("masked_matmul", "masked_matmul_dx",
                                                 "masked_matmul_dw")
                          + (BATCHED[:3] if batched else ())},
                masked_shapes=sorted(shapes))
            del bw, nbw, opt_state, masks, h, tgt, cell
    finally:
        MM._call = call
    if ebft_done and int(os.environ.get("RANK", "0")) == 0:
        open(ebft_done, "w").close()
    return rec


def _serve_cells(device, mesh, cfg, cells, logits_path) -> dict:
    """The prefill cell, then greedy decode cells on its cache (or state)."""
    import torch

    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as ST

    P, N, B = cells["prompt_len"], cells["decode_steps"], cells["prompts"]
    shape = ShapeConfig("mesh_prefill", P, B, "prefill")
    pc = ST.build_prefill_cell(cfg, shape, mesh)
    dc = ST.build_decode_cell(cfg, ShapeConfig("mesh_decode", P + N - 1, B, "decode"), mesh)
    gs = torch.Generator(device=device).manual_seed(2)
    sparams = pc.model.init(gs)
    # a VLM's prompt is [patches ; text] of P positions in all
    prompts = torch.randint(0, cfg.vocab_size, pc.model.input_specs(shape)["tokens"].shape,
                            generator=gs, device=device, dtype=torch.int32)
    batch = {"tokens": prompts, **_frontend_arrays(pc.model, shape, gs, device)}
    state = pc.model.init_serve_state(B, P + N, device)
    _sync(device)
    t0 = time.perf_counter()
    logits, state = ST.run_cell(pc, mesh, sparams, batch, state)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    steps = [logits[:, -1].float()]
    t0 = time.perf_counter()
    for _ in range(N):
        tok = steps[-1].argmax(-1)[:, None].to(torch.int32)
        logits, state = ST.run_cell(dc, mesh, sparams, tok, state)
        steps.append(logits[:, -1].float())
    _sync(device)
    torch.save(torch.stack(steps).cpu(), logits_path)
    # each state leaf's (local, global) shape; the dense cache's k as before
    leaves = {"/".join(p): [list(t.to_local().shape if hasattr(t, "to_local") else t.shape),
                            list(t.shape)]
              for p, t in T.leaves_with_path(state) if isinstance(t, torch.Tensor)}
    out = dict(prefill_s=prefill_s, decode_s=(time.perf_counter() - t0) / N,
               len=state["cache"]["len"] if "cache" in state else state["len"])
    if "k" in leaves:
        out.update(local_cache=leaves["k"][0], cache=leaves["k"][1])
    else:  # the encoder-decoder's {cache, memory}, the Mamba families' states
        out["states"] = leaves
    return out


def train_peak_without_remat(device, conf, cells):
    """The one-process train step's peak memory (GiB) over one step with
    ``remat="none"`` in place of the cell's block remat (``mesh_cells``
    reads it with remat): the cell's own config and microbatches, the
    step ``make_train_step`` builds for it on one process; None on the
    CPU."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as ST
    from repro_torch.models.model import build
    from repro_torch.optim.optimizers import adamw
    from repro_torch.training.train_loop import make_train_step

    if device != "cuda":
        return None
    shape = ShapeConfig("mesh_train", conf["seq"], cells["train_batch"], "train")
    cfg = ST.adapt_config(_cells_cfg(conf), shape, ONE_MESH()).replace(remat="none")
    model = build(cfg)
    opt = adamw(cells["train_lr"])
    step = make_train_step(model.loss, opt,
                           microbatches=ST.microbatches_for(cfg, shape, ONE_MESH()))
    g = torch.Generator(device=device).manual_seed(0)
    params = model.init(g)
    opt_state = opt.init(params)
    toks = torch.randint(0, cfg.vocab_size, (cells["train_batch"], conf["seq"]),
                         generator=g, device=device, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    step(params, opt_state, {"tokens": toks}, None)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def mesh_launch(device, mesh, conf, cells, steps, ckpt_dir=None):
    """``launch/train.run`` on ``mesh`` (None: one process) at ``conf``'s
    widths in f32 with the flash kernel, ``cells["launch_batch"]`` samples
    of ``conf["seq"]``, checkpointed every ``ckpt_step`` steps into
    ``ckpt_dir`` (resuming from it), the loss read every step. The flash
    launches are counted from 0; the checkpoint's seconds are the run's
    own spans (``train/checkpoint``: the periodic saves' synchronous part,
    the gather; ``train/checkpoint_drain``: the writers' wait and the
    closing save; ``train/restore``)."""
    import torch

    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.launch import train
    from repro_torch.models.model import build
    from repro_torch.obs import trace as OT

    cfg = _cells_cfg(conf).replace(dtype="float32", param_dtype="float32", attn_impl="flash")
    spec = train.TrainSpec(arch=conf["arch"], steps=steps, batch=cells["launch_batch"],
                           seq=conf["seq"], ckpt_dir=ckpt_dir or "",
                           ckpt_every=cells["ckpt_step"])
    # the launcher's own init (spec.seed), sampled before it trains in place
    params = build(cfg).init(torch.Generator(device=device).manual_seed(spec.seed))
    init = _leaf_samples(params)
    tracer = OT.Tracer()
    OT.set_tracer(tracer)
    reset_counts()
    try:
        res = train.run(cfg, spec, device, params=params, say=lambda *_: None, mesh=mesh,
                        log_every=1)
    finally:
        OT.set_tracer(None)
    counts = read_counts()
    timed = dict.fromkeys(("train/checkpoint", "train/checkpoint_drain", "train/restore"), 0.0)
    todo = list(tracer.roots)
    while todo:
        sp = todo.pop()
        if sp.name in timed:
            timed[sp.name] += sp.duration
        todo.extend(sp.children)
    last = CK.latest_step(ckpt_dir) if ckpt_dir else None
    return dict(start=res.start, history=res.history, seconds=res.seconds,
                save_s=timed["train/checkpoint"], drain_s=timed["train/checkpoint_drain"],
                restore_s=timed["train/restore"],
                samples=dict(init=init, params=_leaf_samples(res.params),
                             moments=_leaf_samples(_moments(res.opt_state))),
                ckpt_bytes=_dir_bytes(os.path.join(ckpt_dir, f"step_{last:08d}"))
                if last is not None else 0,
                launches={k: counts[k] for k in ("flash_attention", "flash_attention_bwd")})


def mesh_rank():
    """One rank of the ``mesh`` phase (``RANK``, ``WORLD_SIZE``,
    ``MESH_STORE``, ``MESH_SHAPE`` "data,model", ``MESH_GO``,
    ``MESH_OUT``, ``MESH_DEVICE``, ``MESH_LAUNCH`` in the environment): a
    gloo group over a file store, every rank on the one card; once the
    file ``MESH_GO`` exists, EBFT on that mesh, its kernels' launches and
    masked-matmul shapes counted on this rank, then the sharded cells
    (``mesh_cells``) and ``launch/train`` to step ``MESH_LAUNCH``
    (``mesh_launch``; past the checkpoint step it waits for the other
    mesh's checkpoint and resumes it). Writes ``<data>x<model>_rank<r>.json`` into
    ``MESH_OUT``."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.core import ebft
    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.launch.mesh import make_ebft_plan

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = os.environ.get("MESH_DEVICE", "cuda")
    conf = json.loads(os.environ.get("MESH_CONF", json.dumps(MESH)))
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + os.environ["MESH_STORE"],
                            rank=rank, world_size=world)
    # started ahead of their turn: the card is theirs once the parent says so
    deadline = time.perf_counter() + 900
    while not os.path.exists(os.environ["MESH_GO"]):
        if time.perf_counter() > deadline:
            raise TimeoutError("mesh: the parent never let the ranks start")
        time.sleep(0.1)
    t0 = time.perf_counter()
    model, params, pruned, masks, calib, _ = _mesh_setup(device, conf["layers"], conf)
    out = {"setup_s": time.perf_counter() - t0}
    shapes = set()
    call = MM._call

    def spy(fn, a, b, c, tiles=None, **kw):
        shapes.add((fn, tuple(a.shape), tuple(b.shape)))
        return call(fn, a, b, c, tiles, **kw)

    MM._call = spy
    data, model_axis = (int(x) for x in os.environ["MESH_SHAPE"].split(","))
    plan = make_ebft_plan(data, model_axis, device_type=device)
    reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    tuned, reports = ebft.finetune(model, params, pruned, masks, calib, _mesh_ecfg(plan, conf))
    _sync(device)
    out.update(
        seconds=time.perf_counter() - t0, devices=plan.device_count, describe=plan.describe(),
        launches=read_counts(), reports=[r.asdict() for r in reports],
        whole=all(type(t) is torch.Tensor for t in T.tensors(tuned)),
        tuned={"/".join(p): t.double().sum().item() for p, t in T.leaves_with_path(tuned)},
        masked_shapes=sorted(shapes))
    MM._call = call
    if device == "cuda":
        out["walk_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, params, pruned, masks, tuned
    if device == "cuda":
        torch.cuda.empty_cache()
    # the sharded cells and launch/train on the same ranks
    cells = json.loads(os.environ.get("MESH_CELLS", json.dumps(MESH_CELLS)))
    key = f"{data}x{model_axis}"
    t0 = time.perf_counter()
    out["cells"] = mesh_cells(device, plan.mesh, conf, cells,
                              os.path.join(os.environ["MESH_OUT"], f"{key}_rank{rank}_logits.pt"),
                              os.environ.get("MESH_EBFT_AFTER"),
                              os.path.join(os.environ["MESH_OUT"], f"{key}.ebft_done"))
    out["cells_s"] = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.empty_cache()
    ckpt_dir = os.path.join(os.environ["MESH_OUT"], "launch_ckpt")
    steps = int(os.environ["MESH_LAUNCH"])
    if steps > cells["ckpt_step"]:  # the resuming mesh waits for the other's checkpoint
        from repro_torch.checkpoint import ckpt as CK

        deadline = time.perf_counter() + 600
        while CK.latest_step(ckpt_dir) != cells["ckpt_step"]:
            if time.perf_counter() > deadline:
                raise TimeoutError("mesh: the first mesh's checkpoint never appeared")
            time.sleep(0.2)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out["launch"] = mesh_launch(device, plan.mesh, conf, cells, steps, ckpt_dir)
    out["launch_s"] = time.perf_counter() - t0
    if device == "cuda":
        out["launch_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    samples = _pop_samples(out["cells"], out["launch"])
    torch.save(samples, os.path.join(os.environ["MESH_OUT"], f"{key}_rank{rank}_samples.pt"))
    with open(os.path.join(os.environ["MESH_OUT"], f"{key}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _nccl_one_rank(device, conf=MESH):
    """A one-rank group (nccl on the card): ``make_ebft_plan(1, 1)`` and a
    ``MeshPlan`` on a 1 × 1 ``DeviceMesh`` must give the bits of
    ``mesh_plan=None`` on one layer (one segment)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.core import ebft
    from repro_torch.distributed.meshplan import MeshPlan
    from repro_torch.launch.mesh import make_debug_mesh, make_ebft_plan

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="mesh_nccl_")
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        model, params, pruned, masks, calib, _ = _mesh_setup(device, 1, conf)
        calib = calib[:1]
        plans = {"none": None, "make_ebft_plan(1, 1)": make_ebft_plan(1, 1, device_type=device),
                 "DeviceMesh 1x1": MeshPlan.from_mesh(make_debug_mesh(1, 1, device))}
        runs = {k: ebft.finetune(model, params, pruned, masks, calib, _mesh_ecfg(p, conf))
                for k, p in plans.items()}
    finally:
        dist.destroy_process_group()
    base_w, base_r = runs["none"]
    for name, (w, r) in runs.items():
        if plans[name] is not None and plans[name].active:
            raise AssertionError(f"mesh: {name} is an active plan on one rank")
        if [x.asdict() for x in r] != [x.asdict() for x in base_r] or not all(
                torch.equal(t, T.get_path(base_w, p)) for p, t in T.leaves_with_path(w)):
            raise AssertionError(f"mesh: {name} on a one-rank {backend} group is not the bits "
                                 "of mesh_plan=None")
    return dict(backend=backend, plans=list(plans), bits_equal=True,
                seconds=time.perf_counter() - t0)


def _pop_samples(cells, launch) -> dict:
    """The state samples taken out of a process's cells and launcher
    records (they stay off the printed JSON): {kind: samples}."""
    out = {k: v.pop("samples") for k, v in cells.items() if "samples" in v}
    out["launch"] = launch.pop("samples")
    return out


def _state_errors(got, one, update_rel, moment_rel, what):
    """One updated state against one process's, leaf by leaf, in relative
    L2 over the sampled positions: the weights' difference over one
    process's update (``params - init``), each moment's over one process's
    moment. Returns (the worst reading of each with its leaf, the
    failures: leaves past ``update_rel`` or ``moment_rel``)."""
    worst, failed = {}, []
    for part, limit in (("params", update_rel), ("moments", moment_rel)):
        rows = {}
        for leaf, ref in one[part].items():
            base = ref - one["init"][leaf] if part == "params" else ref
            rows[leaf] = float((got[part][leaf] - ref).norm() / max(float(base.norm()), 1e-300))
        leaf = max(rows, key=rows.get)
        worst[part] = [leaf, rows[leaf]]
        failed += [f"mesh {what}: {part} {k} reads {v} against {limit}"
                   for k, v in rows.items() if v > limit]
    return worst, failed


def _greedy_close(one, got, rel, what) -> dict:
    """Greedy decoding on a mesh against one process: ``one`` and ``got``
    (steps, B, V) logits. Row by row, each step's logits within ``rel`` of
    the one process's largest |logit| in that row, and the same greedy
    token unless one process's top two are within twice that (a near tie;
    the row is then compared no further: its next input differs)."""
    import torch

    steps, rows, _ = one.shape
    worst, equal, ties = 0.0, 0, 0
    for b in range(rows):
        for t in range(steps):
            tol = rel * float(one[t, b].abs().max())
            err = float((got[t, b] - one[t, b]).abs().max())
            worst = max(worst, err / max(tol / rel, 1e-30))
            if err > tol:
                raise AssertionError(f"mesh {what}: row {b} step {t} logits off by {err} "
                                     f"(tolerance {tol})")
            # bf16 logits tie exactly at times: the token is argmax's (the
            # one fed on), the gap topk's
            top2 = torch.topk(one[t, b], 2).values
            if int(got[t, b].argmax()) == int(one[t, b].argmax()):
                equal += 1
                continue
            if float(top2[0] - top2[1]) > 2 * tol:
                raise AssertionError(f"mesh {what}: row {b} step {t} greedy token differs "
                                     "beyond a near tie")
            ties += 1
            break
    return dict(max_rel_err=worst, tokens_equal=equal, near_ties=ties, tokens=steps * rows)


def phase_mesh(walls, device="cuda", conf=MESH, cells=MESH_CELLS):
    """EBFT on a mesh of ranks at Llama-7B's widths (``MESH``): one process
    (the reference run, then the one-rank nccl check ``_nccl_one_rank``,
    the cells and ``launch/train`` on one process), then a 2 × 1 (data)
    and a 1 × 2 (model: 16 heads and 5504 ff columns a rank) mesh at once,
    each two gloo ranks of its own group, all on the one card (nccl takes
    one rank a GPU). Each mesh's wall is so taken under the other's load. Each mesh's
    per-block loss histories must equal one process's within rtol 2e-3,
    atol 1e-5 (the reference
    test's); every rank returns the same whole tensors; each rank launches
    the masked matmul (forward, dX, dW) and the attention (forward,
    backward) on its local shards, counted from 0 for each mesh; the
    accounting holds (device dispatches, collective bytes on the data
    axis, per-shard live bytes below the whole on the model axis). Then
    the same ranks run the sharded cells and ``launch/train``, each held
    to one process (``_check_cells``): the 2 × 1 mesh trains to the
    checkpoint, the 1 × 2 mesh resumes it."""
    import tempfile

    import torch

    from repro_torch.core import ebft

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mesh_ranks_")
    world = 2
    env = dict(os.environ, WORLD_SIZE=str(world), PYTHONFAULTHANDLER="1", MESH_OUT=tmp,
               MESH_DEVICE=device, MESH_CONF=json.dumps(conf), MESH_CELLS=json.dumps(cells),
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "src")]))
    # each mesh is a group of its own, all started now (imports, the card,
    # the group); both meshes run once this process's own pass is done (the
    # four ranks beside this process's ebft cell outgrew the card's 80 GB),
    # on the go file
    keys = [f"{d}x{m}" for d, m in MESH_SHAPES]
    jobs = [(key, r) for key in keys for r in range(world)]
    go = os.path.join(tmp, "go")
    logs = [open(os.path.join(tmp, f"{key}_rank{r}.log"), "w") for key, r in jobs]
    # launch/train: the first mesh trains to the checkpoint, the second resumes
    launch_steps = {keys[0]: cells["ckpt_step"], keys[1]: cells["launch_steps"]}
    procs = [subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.mesh_rank()"],
                              env=dict(env, RANK=str(r), MESH_SHAPE=key.replace("x", ","),
                                       MESH_STORE=os.path.join(tmp, f"{key}.store"),
                                       MESH_GO=go, MESH_LAUNCH=str(launch_steps[key]),
                                       MESH_EBFT_AFTER="" if key == keys[0] else
                                       os.path.join(tmp, f"{keys[0]}.ebft_done")),
                              cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
             for (key, r), log in zip(jobs, logs)]
    ranks_s = {}
    try:
        model, params, pruned, masks, calib, _ = _mesh_setup(device, conf["layers"], conf)
        reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        _, single = ebft.finetune(model, params, pruned, masks, calib, _mesh_ecfg(None, conf))
        _sync(device)
        single_s = time.perf_counter() - t0
        single_launches = read_counts()
        del model, params, pruned, masks
        if device == "cuda":
            torch.cuda.empty_cache()
        one_rank = _nccl_one_rank(device, conf)
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cells_one = mesh_cells(device, ONE_MESH(), conf, cells, os.path.join(tmp, "one_logits.pt"))
        cells_one_s = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.empty_cache()
        cells_one["train"]["peak_gib_no_remat"] = train_peak_without_remat(device, conf, cells)
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()  # one process's uninterrupted run
        launch_one = mesh_launch(device, None, conf, cells, cells["launch_steps"])
        launch_one_s = time.perf_counter() - t0
        one_samples = _pop_samples(cells_one, launch_one)
        if device == "cuda":
            torch.cuda.empty_cache()
        t_mesh = time.perf_counter()
        open(go, "w").close()
        for (key, _), p in zip(jobs, procs):
            p.wait(timeout=600)
            ranks_s[key] = time.perf_counter() - t_mesh  # from the start to its last rank's end
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(p.returncode != 0 for p in procs):
        tails = [open(os.path.join(tmp, f"{key}_rank{r}.log")).read()[-3000:] for key, r in jobs]
        raise AssertionError(f"mesh: ranks exit {[p.returncode for p in procs]}\n" +
                             "\n".join(tails))
    by_mesh = {}
    for key, r in jobs:
        by_mesh.setdefault(key, []).append(
            json.load(open(os.path.join(tmp, f"{key}_rank{r}.json"))))

    hist = [r.history for r in single]
    meshes, failed = {}, []
    for data, model_axis in MESH_SHAPES:
        key = f"{data}x{model_axis}"
        ranks = by_mesh[key]
        rec = ranks[0]
        reps = rec["reports"]
        if len(reps) != len(single):
            raise AssertionError(f"mesh {key}: {len(reps)} reports, one process {len(single)}")
        rel = 0.0
        for rs, rm in zip(single, reps):
            if (rm["epochs_run"], rm["early_stop"]) != (rs.epochs_run, rs.early_stop):
                raise AssertionError(f"mesh {key}: block {rm['index']} stopped otherwise")
            a, b = torch.tensor(rm["history"], dtype=torch.float64), \
                torch.tensor(rs.history, dtype=torch.float64)
            if not torch.allclose(a, b, rtol=MESH_RTOL, atol=MESH_ATOL):
                raise AssertionError(f"mesh {key}: block {rm['index']} history {rm['history']} "
                                     f"against one process's {rs.history}")
            rel = max(rel, float(((a - b).abs() / b.abs()).max()))
            if rm["device_dispatches"] != rm["dispatches"] * rec["devices"]:
                raise AssertionError(f"mesh {key}: device dispatches {rm['device_dispatches']}")
        for r in ranks:
            if not r["whole"] or r["tuned"] != rec["tuned"] or r["reports"] != reps:
                raise AssertionError(f"mesh {key}: the ranks' results differ")
            missing = [k for k in MESH_KERNELS if r["launches"][k] == 0]
            if missing and device == "cuda":  # a CPU rehearsal runs the plain versions
                raise AssertionError(f"mesh {key}: a rank launched no {missing}")
        coll = sum(r["collective_bytes"] for r in reps)
        live = max(r["live_bytes"] for r in reps)
        shard = max(r["live_bytes_per_shard"] for r in reps)
        if data > 1 and coll <= 0:
            raise AssertionError(f"mesh {key}: no collective bytes on a data axis of {data}")
        if (model_axis > 1) != (shard < live):
            raise AssertionError(f"mesh {key}: live bytes a shard {shard} of {live}")
        rows = {a[0] for _, a, _ in rec["masked_shapes"]}
        dw = sorted({(tuple(a), tuple(b)) for fn, a, b in rec["masked_shapes"]
                     if fn == "masked_matmul_dw"})
        meshes[key] = dict(seconds=[r["seconds"] for r in ranks],
                           setup_s=[r["setup_s"] for r in ranks], max_rel=rel,
                           peak_gib={k: [r.get(k) for r in ranks]
                                     for k in ("walk_peak_gib", "launch_peak_gib")},
                           cells_s=[r["cells_s"] for r in ranks],
                           launch_s=[r["launch_s"] for r in ranks],
                           collective_bytes=coll, live_bytes=live,
                           live_bytes_per_shard=shard,
                           launches=[{k: r["launches"][k] for k in MESH_KERNELS}
                                     for r in ranks],
                           masked_rows=sorted(rows), tune_dw_shapes=dw,
                           histories=[r["history"] for r in reps])
        try:  # every mesh's record is printed before a failure is raised
            meshes[key]["cells"] = _check_cells(key, ranks, cells_one, launch_one, one_samples,
                                                cells, device, tmp, resumed=key == keys[1])
        except AssertionError as e:
            failed.append(str(e))
            meshes[key]["cells"] = dict(error=str(e), raw={k: [_brief(r[k]) for r in ranks]
                                                           for k in ("launch",)},
                                        raw_cells=[{c: _brief(v) for c, v in r["cells"].items()}
                                                   for r in ranks])
    walls["mesh"] = time.perf_counter() - t_phase
    emit(dict(phase="mesh", conf=conf, cells_conf=cells, single_s=single_s,
              single_histories=hist,
              single_launches={k: single_launches[k] for k in MESH_KERNELS},
              one_rank=one_rank, ranks_s=ranks_s, meshes=meshes,
              one_process=dict(cells_s=cells_one_s, launch_s=launch_one_s,
                               train=cells_one["train"],
                               ebft_tp=_brief(cells_one["ebft_tp"]),
                               ebft_dp_only=_brief(cells_one["ebft_dp_only"]),
                               serve=cells_one["serve"], launch=launch_one),
              seconds_phase=walls["mesh"]))
    if failed:
        raise AssertionError("mesh: " + "; ".join(failed))


def ONE_MESH():
    from repro_torch.launch.mesh import make_abstract_mesh

    return make_abstract_mesh((1, 1), ("data", "model"))


def _brief(rec) -> dict:
    return {k: v for k, v in rec.items() if k != "masked_shapes"}


def _check_cells(key, ranks, one, launch_one, one_samples, cells, device, tmp,
                 resumed) -> dict:
    """One mesh's cells and launcher run, every rank against one process
    (the tolerances at ``CELL_*`` and ``LAUNCH_*``); returns what the phase
    prints, the state readings included, and raises after it has them."""
    import torch

    rec = ranks[0]["cells"]
    samples = [torch.load(os.path.join(tmp, f"{key}_rank{i}_samples.pt"))
               for i in range(len(ranks))]
    failed = []
    for r, smp in zip(ranks, samples):
        if r["cells"]["train"]["losses"] != rec["train"]["losses"] or \
                r["cells"]["ebft_tp"]["loss"] != rec["ebft_tp"]["loss"]:
            raise AssertionError(f"mesh {key}: the ranks' cells differ")
        for kind, s in smp.items():  # every rank gathers the same whole state
            if any(not torch.equal(t, samples[0][kind][part][leaf])
                   for part in ("params", "moments") for leaf, t in s[part].items()):
                failed.append(f"mesh {key}: the ranks' {kind} states differ")
    tr, tr1 = rec["train"], one["train"]
    if not (torch.allclose(torch.tensor(tr["losses"]), torch.tensor(tr1["losses"]),
                           rtol=CELL_LOSS_RTOL, atol=0)
            and torch.allclose(torch.tensor(tr["grad_norms"]), torch.tensor(tr1["grad_norms"]),
                               rtol=CELL_NORM_RTOL, atol=0)):
        failed.append(f"mesh {key}: train cell losses {tr['losses']} norms "
                      f"{tr['grad_norms']} against {tr1['losses']} {tr1['grad_norms']}")
    worst, bad = _state_errors(samples[0]["train"], one_samples["train"], CELL_UPDATE_REL,
                               CELL_MOMENT_REL, f"{key} train cell")
    failed += bad
    out = dict(train=dict(tr, step_s=[r["cells"]["train"]["step_s"] for r in ranks],
                          peak_gib=[r["cells"]["train"]["peak_gib"] for r in ranks],
                          state_rel=worst))
    for kind in ("ebft_tp", "ebft_dp_only"):
        e, e1 = rec[kind], one[kind]
        if abs(e["loss"] - e1["loss"]) > CELL_LOSS_RTOL * abs(e1["loss"]):
            failed.append(f"mesh {key}: {kind} loss {e['loss']} against {e1['loss']}")
        for r in ranks:
            missing = [k for k, n in r["cells"][kind]["launches"].items() if n == 0]
            if missing and device == "cuda":
                failed.append(f"mesh {key}: {kind} launched no {missing} on a rank")
        worst, bad = _state_errors(samples[0][kind], one_samples[kind], CELL_UPDATE_REL,
                                   CELL_MOMENT_REL, f"{key} {kind}")
        failed += bad
        out[kind] = dict(loss=e["loss"], loss_one=e1["loss"],
                         seconds=[r["cells"][kind]["seconds"] for r in ranks],
                         launches=[r["cells"][kind]["launches"] for r in ranks],
                         masked_shapes=sorted({(x[0], tuple(x[1]), tuple(x[2]))
                                               for x in e["masked_shapes"]}),
                         state_rel=worst)
    one_logits = torch.load(os.path.join(tmp, "one_logits.pt"))
    serve = [dict(r["cells"]["serve"], **_greedy_close(
        one_logits, torch.load(os.path.join(tmp, f"{key}_rank{i}_logits.pt")), CELL_LOGIT_REL,
        f"{key} rank {i} decode")) for i, r in enumerate(ranks)]
    out["serve"] = serve
    la, la1 = [r["launch"] for r in ranks], launch_one
    for r in la:
        if device == "cuda" and not all(r["launches"].values()):
            failed.append(f"mesh {key}: launch/train launched no flash kernel {r}")
        if r["history"] != la[0]["history"]:
            failed.append(f"mesh {key}: the ranks' launcher losses differ")
    # every step's loss against one process's same step: the first mesh's
    # steps from the seeded init, the resumed mesh's from the checkpoint
    ref = dict(la1["history"])
    want = list(range(la[0]["start"], cells["ckpt_step"] if not resumed
                      else cells["launch_steps"]))
    if [s for s, _ in la[0]["history"]] != want or (resumed and la[0]["start"] !=
                                                    cells["ckpt_step"]):
        failed.append(f"mesh {key}: launch/train ran steps {la[0]['history']} from "
                      f"{la[0]['start']}")
    for step, loss in la[0]["history"]:
        if abs(loss - ref[step]) > MESH_RTOL * abs(ref[step]) + MESH_ATOL:
            failed.append(f"mesh {key}: launch/train step {step} loss {loss} against "
                          f"{ref[step]}")
    worst = None
    if resumed:  # the resumed state against one process's 3 uninterrupted steps
        worst, bad = _state_errors(samples[0]["launch"], one_samples["launch"],
                                   LAUNCH_UPDATE_REL, LAUNCH_MOMENT_REL, f"{key} resumed run")
        failed += bad
    out["launch"] = dict(start=la[0]["start"], history=la[0]["history"],
                         history_one=la1["history"], state_rel=worst,
                         **{k: [r[k] for r in la] for k in ("seconds", "save_s", "drain_s",
                                                            "restore_s", "ckpt_bytes",
                                                            "launches")})
    if failed:
        raise AssertionError("; ".join(failed) + f"\nreadings: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# the MoE, SSM and hybrid families on a mesh of ranks (the ``mesh`` phase
# continued: ``phase_mesh_families``)
# ---------------------------------------------------------------------------
# the walks at the published widths in f32 (the kernels' f32 routes), 4
# segments of 2048 in one microbatch, 2 EBFT epochs (the MoE's 1, to pay
# for the VLM and the encoder-decoder), magnitude 0.5:
# DeepSeek-MoE-16B's dense first layer and one MoE layer (E 64, top-6, 2
# shared experts), Mamba2-130M at 2 layers, Zamba2-1.2B at 6 (its fewest
# with one shared-block site), LLaVA-NeXT-Mistral-7B at 1 layer over
# [1024 seeded patches ; 1024 tokens], Seamless-M4T-medium at 1 + 1
# layers, 2048 decoder tokens over 256 seeded frames
FAMILY_MESH = {
    "moe": dict(arch="deepseek_moe_16b", layers=2, seq=2048, calib=4, microbatch=4, epochs=1,
                lr=2e-4, sparsity=0.5),
    "ssm": dict(arch="mamba2_130m", layers=2, seq=2048, calib=4, microbatch=4, epochs=2,
                lr=2e-4, sparsity=0.5),
    "hybrid": dict(arch="zamba2_1_2b", layers=6, seq=2048, calib=4, microbatch=4, epochs=2,
                   lr=2e-4, sparsity=0.5),
    "vlm": dict(arch="llava_next_mistral_7b", layers=1, seq=2048, calib=4, microbatch=4,
                epochs=2, lr=2e-4, sparsity=0.5),
    "encdec": dict(arch="seamless_m4t_medium", layers=1, enc_layers=1, seq=2048, calib=4,
                   microbatch=4, epochs=2, lr=2e-4, sparsity=0.5),
}
# the cells at the walks' widths and depth: the train cell 1 step on 2 ×
# 2048 (one microbatch a data shard) and the bf16 ebft cell
# (tensor-parallel) on 4 × 2048, then prefill 8 × 256 and 2 greedy decode
# steps; the hybrid serves only
FAMILY_CELLS = dict(train_batch=2, train_steps=1, train_lr=1e-4, ebft_batch=4, prompts=8,
                    prompt_len=256, decode_steps=2)
# the cells each family runs on each mesh: the MoE's train and ebft cells
# on 1 × 2 alone, where its experts split (its routing over the data
# ranks is the walks' on 2 × 1; the cells' own take one dispatch group a
# data shard, routed on the rank alone); the encoder-decoder's train cell
# on 2 × 1 alone (each rank holds the whole f32 logits of its rows over
# Seamless's 256206-token vocab and their gradient, the largest cell of
# the phase but the MoE's), which the 2 × 1 ranks run while the 1 × 2
# ranks, held up by their MoE's turn, are still on the families before it
FAMILY_PARTS = {"moe": {"2x1": ("serve",), "1x2": ("train", "ebft", "serve")},
                "ssm": dict.fromkeys(("2x1", "1x2"), ("train", "ebft", "serve")),
                "hybrid": dict.fromkeys(("2x1", "1x2"), ("serve",)),
                "vlm": dict.fromkeys(("2x1", "1x2"), ("train", "ebft", "serve")),
                "encdec": {"2x1": ("train", "ebft", "serve"), "1x2": ("ebft", "serve")}}
# the cells that run in f32 in place of bf16: in bf16 a rounding of the
# router's input flips near-tie experts. At a decode step's capacity of 1
# a flip reorders which tokens drop (the CPU rehearsal: logits off by 18%
# of a row's largest); the MoE's bf16 train cell on 1 × 2 moved the
# router's update by 0.33-0.37 of one process's (H100), above the dense
# limits. In f32 the cells hold the layout, not bf16's luck, to the dense
# CELL_UPDATE_REL and CELL_MOMENT_REL (on the H100 a router gradient
# left unsummed, ``--plant-fault``, reads 0.98 and 0.73)
FAMILY_DTYPES = {"moe": dict(train="float32", serve="float32"),
                 "ssm": dict(serve="float32"), "hybrid": dict(serve="float32"),
                 "vlm": dict(serve="float32"), "encdec": dict(serve="float32")}
FAMILY_KERNELS = {
    "moe": ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw") + BATCHED[:3]
    + ("flash_attention", "flash_attention_bwd"),
    "ssm": ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw"),
    "hybrid": ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "flash_attention",
               "flash_attention_bwd")}
FAMILY_KERNELS["vlm"] = FAMILY_KERNELS["encdec"] = FAMILY_KERNELS["hybrid"]
SLAB_CHECK = dict(E=64, C=1920, K=2048, N=1408)  # DeepSeek's w_gate slabs at EBFT's microbatch
IN_DT = dict(M=16384, K=768, N=24)  # Mamba2-130M's in_dt: (768, 12) a rank on 1 × 2


def _family_meshes(fam, shapes=MESH_SHAPES) -> dict:
    """{mesh key: the abstract mesh whose one-process cells it is held
    to}: the MoE cells take one dispatch group per data shard, so a mesh
    with a data axis its own config; otherwise one device's."""
    from repro_torch.launch.mesh import make_abstract_mesh

    return {f"{d}x{m}": make_abstract_mesh((d, m), ("data", "model"))
            if fam == "moe" and d > 1 else ONE_MESH() for d, m in shapes}


def mesh_families_rank():
    """One rank of ``phase_mesh_families`` (``RANK``, ``WORLD_SIZE``,
    ``MESH_STORE``, ``MESH_SHAPE``, ``MESH_GO``, ``MESH_OUT``,
    ``MESH_DEVICE``, ``MESH_CONFS``, ``MESH_CELLS``, ``MESH_MOE_AFTER``,
    ``MESH_REST_AFTER``, ``MESH_FAULT`` in the environment): for each family
    the walk on this mesh (its kernels' launches counted on this rank) and
    the family's cells; the MoE's after the file ``MESH_MOE_AFTER`` appears
    (the two meshes' MoE in turn), then rank 0 writes ``<key>.moe_done``,
    and the families after it once ``MESH_REST_AFTER`` appears (the other
    mesh's MoE done). On 1 × 2 also the expert-slab and
    in_dt launches (``_family_kernel_checks``). Writes
    ``<key>_rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.core import ebft
    from repro_torch.launch.mesh import make_ebft_plan

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = os.environ.get("MESH_DEVICE", "cuda")
    confs = json.loads(os.environ["MESH_CONFS"])
    cells = json.loads(os.environ["MESH_CELLS"])
    out_dir, after = os.environ["MESH_OUT"], os.environ.get("MESH_MOE_AFTER")
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + os.environ["MESH_STORE"],
                            rank=rank, world_size=world)
    _wait_for(os.environ["MESH_GO"], 900, "the parent never let the ranks start")
    if os.environ.get("MESH_FAULT"):
        _unsum_router()
    data, model_axis = (int(x) for x in os.environ["MESH_SHAPE"].split(","))
    key = f"{data}x{model_axis}"
    plan = make_ebft_plan(data, model_axis, device_type=device)
    out, samples = {}, {}
    for fam, conf in confs.items():
        if fam == "moe" and after:
            _wait_for(after, 600, "the other mesh's MoE never ended")
        mem = [_card_gib()] if device == "cuda" else []
        print(f"{fam} start {mem}", flush=True)
        t0 = time.perf_counter()
        model, params, pruned, masks, calib, extra = _mesh_setup(device, conf["layers"], conf)
        rec = {"setup_s": time.perf_counter() - t0, "mem": mem}
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        with _forward_shapes() as shapes:
            tuned, reports = ebft.finetune(model, params, pruned, masks, calib,
                                           _mesh_ecfg(plan, conf), extra_batch=extra)
        _sync(device)
        rec.update(seconds=time.perf_counter() - t0, launches=read_counts(),
                   forward_shapes=sorted(shapes),
                   reports=[r.asdict() for r in reports],
                   whole=all(type(t) is torch.Tensor for t in T.tensors(tuned)),
                   tuned={"/".join(p): t.double().sum().item()
                          for p, t in T.leaves_with_path(tuned)})
        if device == "cuda":
            rec["walk_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            mem.append(_card_gib())
            print(f"{fam} walked {mem[-1]}", flush=True)
        del model, params, pruned, masks, tuned
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec["cells"] = mesh_cells(device, plan.mesh, conf, cells,
                                  os.path.join(out_dir, f"{fam}_{key}_rank{rank}_logits.pt"),
                                  parts=FAMILY_PARTS[fam][key], layouts=(False,),
                                  dtypes=FAMILY_DTYPES[fam])
        rec["cells_s"] = time.perf_counter() - t0
        if device == "cuda":
            mem.append(_card_gib())
            print(f"{fam} cells {mem[-1]}", flush=True)
        samples[fam] = {k: v.pop("samples") for k, v in rec["cells"].items() if "samples" in v}
        if device == "cuda":
            torch.cuda.empty_cache()
        if fam == "moe" and rank == 0:
            open(os.path.join(out_dir, f"{key}.moe_done"), "w").close()
        if fam == "moe" and os.environ.get("MESH_REST_AFTER"):
            # the rest once the other mesh's MoE is done: beside its MoE cells
            # (24 GiB a rank) this mesh's VLM and encoder-decoder outgrew the card
            _wait_for(os.environ["MESH_REST_AFTER"], 600, "the other mesh's MoE never ended")
        out[fam] = rec
    if model_axis > 1:
        try:  # a failure is the parent's to raise, after the readings are out
            out["kernel_checks"] = _family_kernel_checks(device, plan.mesh,
                                                         **json.loads(os.environ["MESH_CHECKS"]))
        except (AssertionError, ValueError, RuntimeError) as e:
            out["kernel_checks"] = {"error": f"{type(e).__name__}: {e}"}
    torch.save(samples, os.path.join(out_dir, f"{key}_rank{rank}_samples.pt"))
    with open(os.path.join(out_dir, f"{key}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _unsum_router():
    """The planted fault of ``--plant-fault``: the MoE layer's router
    gradient, ``Partial`` over the expert split, taken as this rank's own
    (``local_kernels.moe_routed``'s ``in_grad_placements``)."""
    import torch.distributed.tensor.experimental as E
    from torch.distributed.tensor import Replicate

    local_map = E.local_map

    def unsummed(fn, *a, **kw):
        if "moe_routed" in fn.__qualname__:
            grads = list(kw["in_grad_placements"])
            grads[1] = [Replicate()] * len(grads[1])
            kw["in_grad_placements"] = tuple(grads)
        return local_map(fn, *a, **kw)

    E.local_map = unsummed


def _card_gib() -> dict:
    """This process's allocated and reserved GiB and the card's free GiB
    (every process's use counts against it)."""
    import torch

    free, _ = torch.cuda.mem_get_info()
    return dict(t=time.perf_counter(), allocated=torch.cuda.memory_allocated() / 2**30,
                reserved=torch.cuda.memory_reserved() / 2**30, card_free=free / 2**30)


def _wait_for(path, seconds, what):
    deadline = time.perf_counter() + seconds
    while not os.path.exists(path):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"mesh: {what}")
        time.sleep(0.2)


def _family_kernel_checks(device, mesh, slabs=SLAB_CHECK, in_dt=IN_DT) -> dict:
    """On a model axis of 2 (each rank, its own half):
    - the expert-batched masked matmul on DeepSeek's w_gate slabs (E 64, C
      1920, K 2048, N 1408, bf16) split over E: this rank's forward, dX and
      dW (through the DTensor route, its 32 experts a launch) must equal
      the same experts' slabs of the whole launch bit for bit;
    - Mamba2-130M's in_dt (768, 24, bf16) split over its 24 heads: the
      rank's (768, 12) shard through the DTensor route (the weight and mask
      padded to 16 columns, the kernel's unit), held to its plain version.
    Each route's launches are counted on this rank (the kernels, not their
    plain versions)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.masked_matmul import ops as MM

    dt, rec = torch.bfloat16, {}
    g = torch.Generator(device=device).manual_seed(7)
    E, C, K, N = (slabs[k] for k in "ECKN")
    x = torch.randn(E, C, K, generator=g, device=device).to(dt)
    w = (torch.randn(E, K, N, generator=g, device=device) / K ** 0.5).to(dt)
    m = torch.rand(E, K, N, generator=g, device=device) < 0.5
    dy = torch.randn(E, C, N, generator=g, device=device).to(dt)
    whole = (MM.masked_matmul_batched(x, w, m), MM.masked_matmul_batched_dx(dy, w, m),
             MM.masked_matmul_batched_dw(x, dy, m))
    pl = [Replicate()] * (mesh.ndim - 1) + [Shard(0)]
    xd, wd, md, dyd = (distribute_tensor(t, mesh, pl, src_data_rank=None) for t in (x, w, m, dy))
    xd.requires_grad_(True)
    wd.requires_grad_(True)
    reset_counts()
    y = MM.masked_matmul_batched(xd, wd, md)
    gx, gw = torch.autograd.grad(y, (xd, wd), dyd)
    _sync(device)
    counts = read_counts()
    lo = mesh.get_local_rank(mesh.ndim - 1) * (E // mesh.size(mesh.ndim - 1))
    local = [t.to_local() for t in (y, gx, gw)]
    hi = lo + local[0].shape[0]
    rec["expert_slabs"] = dict(
        experts=[lo, hi], local_shape=list(local[0].shape),
        bits_equal={n: bool(torch.equal(a, b[lo:hi]))
                    for n, a, b in zip(("fwd", "dx", "dw"), local, whole)},
        launches={k: counts[k] for k in BATCHED[:3]})
    if not all(rec["expert_slabs"]["bits_equal"].values()) or \
            (device == "cuda" and not all(rec["expert_slabs"]["launches"].values())):
        raise AssertionError(f"mesh: the local expert slabs {rec['expert_slabs']}")
    del x, w, m, dy, whole, xd, wd, md, dyd, y, gx, gw, local
    M, K, N = (in_dt[k] for k in "MKN")
    x = torch.randn(M, K, generator=g, device=device).to(dt)
    w = (torch.randn(K, N, generator=g, device=device) / K ** 0.5).to(dt)
    m = torch.rand(K, N, generator=g, device=device) < 0.5
    pl = [Replicate()] * (mesh.ndim - 1) + [Shard(1)]
    wd, md = (distribute_tensor(t, mesh, pl, src_data_rank=None) for t in (w, m))
    xd = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    reset_counts()
    y = MM.masked_matmul(xd, wd, md).to_local()
    _sync(device)
    counts = read_counts()
    c0 = mesh.get_local_rank(mesh.ndim - 1) * y.shape[1]
    ref = MM.masked_matmul_plain(x, w, m)[:, c0:c0 + y.shape[1]]
    rec["in_dt"] = dict(local_weight=list(wd.to_local().shape), out=list(y.shape),
                        launches=counts["masked_matmul"],
                        max_abs_err=check_close("in_dt shard", y, ref, "bfloat16"),
                        whole_launch_bits_equal=bool(torch.equal(y, MM.masked_matmul(
                            x, w, MM.aligned_mask(m))[:, c0:c0 + y.shape[1]])))
    if device == "cuda" and counts["masked_matmul"] != 1:
        raise AssertionError(f"mesh: the in_dt shard launched {counts['masked_matmul']} kernels")
    return rec


def _family_one(device, fam, conf, cells, tmp, shapes=MESH_SHAPES) -> dict:
    """One process's walk of ``fam`` at ``conf`` and its cells for each
    mesh's config (``_family_meshes``), the serving logits to ``tmp``."""
    import torch

    from repro_torch.core import ebft

    model, params, pruned, masks, calib, extra = _mesh_setup(device, conf["layers"], conf)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    with _forward_shapes() as fwd:
        _, reps = ebft.finetune(model, params, pruned, masks, calib, _mesh_ecfg(None, conf),
                                extra_batch=extra)
    _sync(device)
    rec = dict(seconds=time.perf_counter() - t0, reports=reps, launches=read_counts(), cells={},
               forward_shapes=sorted(fwd),
               samples={}, peak_gib=torch.cuda.max_memory_allocated() / 2**30
               if device == "cuda" else None)
    del model, params, pruned, masks
    if device == "cuda":
        torch.cuda.empty_cache()
    done = {}
    for key, mesh in _family_meshes(fam, shapes).items():
        tag, parts = "one" if mesh.size == 1 else key, FAMILY_PARTS[fam][key]
        if (tag, parts) not in done:
            t0 = time.perf_counter()
            cr = mesh_cells(device, mesh, conf, cells,
                            os.path.join(tmp, f"{fam}_{tag}_one_logits.pt"),
                            parts=parts, layouts=(False,), dtypes=FAMILY_DTYPES[fam])
            done[tag, parts] = (dict(cr, seconds=time.perf_counter() - t0),
                                {k: v.pop("samples") for k, v in cr.items() if "samples" in v})
            if device == "cuda":
                torch.cuda.empty_cache()
        rec["cells"][key] = dict(done[tag, parts][0], logits=f"{fam}_{tag}_one_logits.pt")
        rec["samples"][key] = done[tag, parts][1]
    return rec


def phase_mesh_families(walls, device="cuda", confs=FAMILY_MESH, cells=FAMILY_CELLS,
                        checks=None, shapes=MESH_SHAPES, fault=False):
    """The MoE, SSM and hybrid families on a mesh (``mesh`` continued): one
    process runs each family's walk at the published widths (``FAMILY_MESH``)
    and its cells for each mesh's config, then a 2 × 1 and a 1 × 2 mesh of
    two gloo ranks each on the one card run the same, at once but the MoE
    (the four ranks' MoE walks would outgrow the card's 80 GB: the meshes
    take it in turn). Each walk must hold one process's per-block
    histories within rtol 2e-3, atol 1e-5 with the same ``epochs_run``
    and ``early_stop``, every rank the same whole tensors and each family
    kernel launched on every rank; the train and ebft cells of the MoE (on
    1 × 2, its train cell in f32) and the SSM, one process's loss within
    ``CELL_LOSS_RTOL`` and each leaf's update and moments within
    ``CELL_UPDATE_REL`` and ``CELL_MOMENT_REL`` (``_state_errors``); every
    family's decode steps one process's logits and greedy tokens
    (``_greedy_close``); and the
    1 × 2 ranks' local expert slabs and in_dt shard
    (``_family_kernel_checks``). ``fault`` plants ``_unsum_router`` in
    the ranks."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mesh_families_")
    world, keys = 2, [f"{d}x{m}" for d, m in shapes]
    env = dict(os.environ, WORLD_SIZE=str(world), PYTHONFAULTHANDLER="1", MESH_OUT=tmp,
               MESH_DEVICE=device, MESH_CONFS=json.dumps(confs), MESH_CELLS=json.dumps(cells),
               MESH_CHECKS=json.dumps(checks or dict(slabs=SLAB_CHECK, in_dt=IN_DT)),
               MESH_FAULT="1" if fault else "",
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "src")]))
    jobs = [(key, r) for key in keys for r in range(world)]
    go = os.path.join(tmp, "go")
    logs = [open(os.path.join(tmp, f"{key}_rank{r}.log"), "w") for key, r in jobs]
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.mesh_families_rank()"],
        env=dict(env, RANK=str(r), MESH_SHAPE=key.replace("x", ","),
                 MESH_STORE=os.path.join(tmp, f"{key}.store"), MESH_GO=go,
                 MESH_MOE_AFTER="" if key == keys[0] else os.path.join(tmp, f"{keys[0]}.moe_done"),
                 MESH_REST_AFTER=os.path.join(tmp, f"{keys[-1]}.moe_done")
                 if key == keys[0] and len(keys) > 1 and "moe" in confs else ""),
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT) for (key, r), log in zip(jobs, logs)]
    one, ranks_s = {}, {}
    try:
        for fam, conf in confs.items():  # one process, before the ranks start
            one[fam] = _family_one(device, fam, conf, cells, tmp, shapes)
        t_mesh = time.perf_counter()
        if device == "cuda":  # what this process holds while the ranks run
            emit(dict(phase="mesh_families_memory", parent=_card_gib()))
        open(go, "w").close()
        for (key, _), p in zip(jobs, procs):
            p.wait(timeout=900)
            ranks_s[key] = time.perf_counter() - t_mesh
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if any(p.returncode != 0 for p in procs):
        tails = [open(os.path.join(tmp, f"{key}_rank{r}.log")).read()[-3000:] for key, r in jobs]
        emit(dict(phase="mesh_families_ranks_failed", exits=[p.returncode for p in procs],
                  logs={f"{key}_rank{r}": open(os.path.join(tmp, f"{key}_rank{r}.log"))
                        .read()[-20000:] for key, r in jobs}))
        raise AssertionError(f"mesh_families: ranks exit {[p.returncode for p in procs]}\n" +
                             "\n".join(tails))
    by_mesh = {key: [json.load(open(os.path.join(tmp, f"{key}_rank{r}.json")))
                     for r in range(world)] for key in keys}
    smp = {key: [torch.load(os.path.join(tmp, f"{key}_rank{r}_samples.pt"))
                 for r in range(world)] for key in keys}
    record, failed = {}, []
    for fam in confs:
        single = one[fam]["reports"]
        fam_rec = dict(one=dict(seconds=one[fam]["seconds"], peak_gib=one[fam]["peak_gib"],
                                histories=[r.history for r in single],
                                launches={k: one[fam]["launches"][k]
                                          for k in FAMILY_KERNELS[fam]},
                                cells={k: {c: _brief(v) for c, v in cr.items()
                                           if isinstance(v, dict)}
                                       for k, cr in one[fam]["cells"].items()}))
        for key in keys:
            ranks = [r[fam] for r in by_mesh[key]]
            rec, reps = ranks[0], ranks[0]["reports"]
            if [(r["epochs_run"], r["early_stop"]) for r in reps] != \
                    [(r.epochs_run, r.early_stop) for r in single]:
                failed.append(f"mesh {fam} {key}: the blocks stopped otherwise than one "
                              "process's")
            rel = 0.0
            for rs, rm in zip(single, reps):
                a = torch.tensor(rm["history"], dtype=torch.float64)
                b = torch.tensor(rs.history, dtype=torch.float64)
                if a.shape != b.shape or not torch.allclose(a, b, rtol=MESH_RTOL,
                                                            atol=MESH_ATOL):
                    failed.append(f"mesh {fam} {key}: block {rm['index']} history "
                                  f"{rm['history']} against one process's {rs.history}")
                else:
                    rel = max(rel, float(((a - b).abs() / b.abs()).max()))
            for r in ranks:
                if not r["whole"] or r["tuned"] != rec["tuned"] or r["reports"] != reps:
                    failed.append(f"mesh {fam} {key}: the ranks' walks differ")
                missing = [k for k in FAMILY_KERNELS[fam] if r["launches"][k] == 0]
                if missing and device == "cuda":
                    failed.append(f"mesh {fam} {key}: a rank launched no {missing}")
                if fam in ("vlm", "encdec") and not _on_local_shards(
                        r["forward_shapes"], one[fam]["forward_shapes"], key):
                    failed.append(f"mesh {fam} {key}: no masked-matmul forward ran on this "
                                  f"rank's shards: {r['forward_shapes']}")
            cells_rec = {}
            one_cells = one[fam]["cells"][key]
            for kind in ("train", "ebft_tp"):
                if kind not in rec["cells"]:
                    continue
                got, want = rec["cells"][kind], one_cells[kind]
                loss = got["losses"] if kind == "train" else [got["loss"]]
                loss1 = want["losses"] if kind == "train" else [want["loss"]]
                if not torch.allclose(torch.tensor(loss), torch.tensor(loss1),
                                      rtol=CELL_LOSS_RTOL, atol=0):
                    failed.append(f"mesh {fam} {key}: {kind} loss {loss} against {loss1}")
                worst, bad = _state_errors(smp[key][0][fam][kind],
                                           one[fam]["samples"][key][kind], CELL_UPDATE_REL,
                                           CELL_MOMENT_REL, f"{fam} {key} {kind}")
                failed += bad
                cells_rec[kind] = dict(loss=loss, loss_one=loss1, state_rel=worst,
                                       seconds=[r["cells"][kind].get("seconds", r["cells"][kind]
                                                                     .get("step_s"))
                                                for r in ranks],
                                       peak_gib=[r["cells"][kind].get("peak_gib")
                                                 for r in ranks],
                                       launches=[r["cells"][kind].get("launches")
                                                 for r in ranks])
            one_logits = torch.load(os.path.join(tmp, one_cells["logits"]))
            try:
                cells_rec["serve"] = [dict(r["cells"]["serve"], **_greedy_close(
                    one_logits, torch.load(os.path.join(
                        tmp, f"{fam}_{key}_rank{i}_logits.pt")), CELL_LOGIT_REL,
                    f"{fam} {key} rank {i} decode")) for i, r in enumerate(ranks)]
            except AssertionError as e:
                failed.append(str(e))
            fam_rec[key] = dict(seconds=[r["seconds"] for r in ranks],
                                setup_s=[r["setup_s"] for r in ranks],
                                cells_s=[r["cells_s"] for r in ranks], max_rel=rel,
                                walk_peak_gib=[r.get("walk_peak_gib") for r in ranks],
                                collective_bytes=sum(r["collective_bytes"] for r in reps),
                                live_bytes=max(r["live_bytes"] for r in reps),
                                live_bytes_per_shard=max(r["live_bytes_per_shard"]
                                                         for r in reps),
                                launches=[{k: r["launches"][k] for k in FAMILY_KERNELS[fam]}
                                          for r in ranks],
                                forward_shapes=ranks[0]["forward_shapes"],
                                histories=[r["history"] for r in reps], cells=cells_rec)
        record[fam] = fam_rec
    checks = [r.get("kernel_checks") for key in keys for r in by_mesh[key]]
    failed += [f"mesh_families: kernel checks {c['error']}" for c in checks if c and "error" in c]
    walls["mesh_families"] = time.perf_counter() - t_phase
    emit(dict(phase="mesh_families", confs=confs, cells_conf=cells, ranks_s=ranks_s,
              families=record, kernel_checks=[c for c in checks if c],
              seconds_phase=walls["mesh_families"]))
    if failed:
        raise AssertionError("mesh_families: " + "; ".join(failed))


def _on_local_shards(mine, whole, key) -> bool:
    """Whether a rank's masked-matmul forwards (``_forward_shapes``) ran on
    its shards of one process's: on a data axis of d some product is one
    process's with its rows cut d ways (the streams' and the memory's rows
    split with the batch); on a model axis of m, with its columns cut m
    ways (the tuned block's column-parallel projections)."""
    d, m = (int(v) for v in key.split("x"))
    whole = {tuple(x) for x in whole}
    return any((a * d, b, c * m) in whole for a, b, c in mine)


# the dry run (launch/dryrun.py) on the 16 x 16 mesh: one config of each
# family at ebft_block, and Llama-7B's train shape
DRYRUN = (("llama_7b,deepseek_moe_16b,mamba2_130m,zamba2_1_2b,llava_next_mistral_7b,"
           "seamless_m4t_medium", "ebft_block"), ("llama_7b", "train_4k"))


def start_dryrun():
    """``python -m repro_torch.launch.dryrun`` over ``DRYRUN``'s cells, one
    process a group, in the background with the card hidden (it runs on
    fake tensors over a fake process group, on no device). Returns
    (the processes, their output directory)."""
    import tempfile

    out = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    logs = [open(os.path.join(out, f"log{i}.txt"), "w") for i in range(len(DRYRUN))]
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", archs,
                               "--shape", shape, "--mesh", "single", "--out", out],
                              cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
             for (archs, shape), log in zip(DRYRUN, logs)]

    def stop():  # a phase that fails before the dry run's end leaves none running
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    atexit.register(stop)
    return procs, out


def phase_dryrun(started, walls):
    """The dry run's end: every process exits 0, every cell's record has no
    ``error``, the reference's keys but the HLO ones, and rank 0's
    ``argument_bytes`` equal to the bytes of each argument's shard as the
    cell's in-specs cut it on the abstract 16 × 16 mesh, counted here
    (``sharding.shards_of``). It books the cells' own seconds, run beside
    the phases before, and the seconds the script waited for them."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import abstract_production_mesh

    procs, out = started
    t_wait = time.perf_counter()
    for p in procs:
        p.wait(timeout=600)
    waited = time.perf_counter() - t_wait  # what the dry run adds to the script's wall
    logs = [open(os.path.join(out, f"log{i}.txt")).read() for i in range(len(procs))]
    failed = [f"exit {p.returncode}: {log[-2000:]}" for p, log in zip(procs, logs)
              if p.returncode != 0]
    mesh, recs = abstract_production_mesh(), {}
    keys = {"arch", "shape", "mesh", "chips", "kind", "fsdp", "memory_analysis", "timing", "hlo"}
    for archs, shape_name in DRYRUN:
        for arch in archs.split(","):
            path = os.path.join(out, "baseline", f"{arch}__{shape_name}__single.json")
            if not os.path.exists(path):
                failed.append(f"{arch} {shape_name}: no record")
                continue
            rec = json.load(open(path))
            cfg = get_config(arch)
            cell = ST.build_cell(cfg, DR.shape_of(cfg, shape_name), mesh)
            count = 0
            for tree, specs in zip(cell.abstract_args, cell.in_specs):
                for (_, x), (_, spec) in zip(T.leaves_with_path(tree),
                                             T.leaves_with_path(specs)):
                    if hasattr(x, "dtype") and hasattr(x, "shape"):
                        count += (math.prod(x.shape) // SH.shards_of(spec, mesh)
                                  * x.dtype.itemsize)
            got = rec.get("memory_analysis", {}).get("argument_bytes")
            if "error" in rec or set(rec) != keys or got != count:
                failed.append(f"{arch} {shape_name}: {rec.get('error')} keys {sorted(rec)} "
                              f"argument_bytes {got} against {count}")
            recs[f"{arch}__{shape_name}"] = dict(rec["memory_analysis"], **rec["timing"],
                                                 counted_argument_bytes=count) \
                if "memory_analysis" in rec else rec.get("error")
    walls["dryrun (waited)"] = waited
    cells_s = sum(r["build_s"] + r["run_s"] for r in recs.values() if isinstance(r, dict))
    emit(dict(phase="dryrun", waited_s=waited, cells_s=cells_s, cells=recs,
              logs=[log.strip().splitlines()[-1] if log.strip() else "" for log in logs]))
    if failed:
        raise AssertionError("dryrun: " + "; ".join(failed))


def plant_fault(device="cuda") -> int:
    """``--plant-fault``: the ``mesh_families`` phase's MoE on 1 × 2 alone,
    its ranks' router gradient left unsummed over the expert split
    (``_unsum_router``). 0 when the cells' state check (``_state_errors``)
    flags the router in both the train and the ebft cell."""
    try:
        phase_mesh_families({}, device, confs={"moe": FAMILY_MESH["moe"]}, shapes=((1, 2),),
                            fault=True)
        failed = []
    except AssertionError as e:
        failed = str(e).split("; ")
    caught = {kind: [f for f in failed if f"moe 1x2 {kind}: " in f and "router/w" in f]
              for kind in ("train", "ebft_tp")}
    emit(dict(phase="plant_fault", fault="router gradient unsummed over the expert split",
              caught=caught))
    return 0 if all(caught.values()) else 1


def main(argv=()) -> int:
    # cuBLAS picks its workspace per stream; a fixed configuration makes a
    # product repeat bit for bit, which the resumed training run relies on.
    # It must be set before the first product.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    os.makedirs(os.path.dirname(PHASES_LOG), exist_ok=True)
    open(PHASES_LOG, "w").close()
    _log["on"] = True
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
    emit(dict(phase="build", seconds=time.perf_counter() - t0, per_library=_build.build_seconds,
              ptxas={n: [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
                     for n, log in _build.build_log.items()}))
    if "--plant-fault" in argv:
        return plant_fault()
    dryrun = start_dryrun()  # on the host, beside the card's phases

    g = torch.Generator(device="cuda").manual_seed(0)
    # the moe path's 2-D shapes, by kernel: {label: row}
    rows, moe_shapes = {}, {}
    rows["masked_matmul"], moe_shapes["masked_matmul"] = phase_masked_matmul(g)
    bwd, moe_bwd = phase_masked_matmul_bwd(g)
    for op in ("dx", "dw"):
        rows[f"masked_matmul_{op}"], moe_shapes[f"masked_matmul_{op}"] = bwd[op], moe_bwd[op]
    rows["masked_matmul_dm"] = phase_masked_matmul_dm(g)
    hyb_shapes, enc_shapes = {}, {}
    vlm_shapes = {"vlm": {}, "dense_configs": {}}
    rows["flash_attention"], serve_rows, moe_shapes["flash_attention"], \
        hyb_shapes["flash_attention"], vlm_shapes["vlm"]["flash_attention"], \
        enc_shapes["flash_attention"] = phase_flash_attention(g)
    rows["flash_attention_bwd"], moe_shapes["flash_attention_bwd"], \
        hyb_shapes["flash_attention_bwd"], enc_shapes["flash_attention_bwd"] = \
        phase_flash_attention_bwd(g)
    torch.cuda.empty_cache()
    rows.update(phase_masked_matmul_batched(g))
    torch.cuda.empty_cache()
    # the Mamba leaves of both families: {family: {kernel: {leaf: row}}}
    mamba_shapes = phase_masked_matmul_mamba(g)
    torch.cuda.empty_cache()
    # LLaVA's leaves and the dense configs' (flash_attention's vlm rows above)
    for group, by_kernel in phase_masked_matmul_vlm(g).items():
        vlm_shapes[group].update(by_kernel)
    vlm_shapes["vlm"]["flash_attention_bwd"] = {"ebft": rows["flash_attention_bwd"]}
    torch.cuda.empty_cache()
    # Seamless's leaves at the decoder's and the encoder's rows
    enc_shapes.update(phase_masked_matmul_encdec(g))
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
    launches, res, cfg, pre, art_main = phase_slice((0.7, ""), tokens)
    pre_launches = phase_pretrain(cfg, res, pre, launches)
    walls["wanda"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    in_run = phase_obs(cfg, res, art_main, launches, tokens)
    walls["obs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_fused(cfg, res, tokens)
    walls["fused"] = time.perf_counter() - t0
    # serving: the pretrained weights, then the main path's Wanda-0.7 EBFT ones
    t0 = time.perf_counter()
    serve_launches = phase_serve(cfg, {"pretrained": res.dense, "ebft": res.tuned})
    walls["serve"] = time.perf_counter() - t0
    dense = res.dense  # every later path starts from the pretrained weights
    del res
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_pretrain_split(cfg, dense)
    phase_checkpoint(dense)
    walls["pretrain_split+checkpoint"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_train_obs(cfg)
    walls["train_obs"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # the N:M path: 2:4 prune, EBFT, re-pack, nm_spmm
    t0 = time.perf_counter()
    nm_launches, res, cfg, _, art_24 = phase_slice((0.5, "2:4"), tokens, dense,
                                                   every_block_drops=False)
    rows["nm_spmm"], art_nm = phase_nm_pack(res, cfg, tokens, nm_launches)
    walls["2:4"] = time.perf_counter() - t0
    launches["nm_spmm"] = nm_launches["nm_spmm"]
    del res
    torch.cuda.empty_cache()
    # path A: SparseGPT, EBFT, DSnoT and mask tuning; path B: FLAP, EBFT, LoRA
    t0 = time.perf_counter()
    by_path, arts = {}, {"main": art_main, "2:4": art_24, "nm_pack": art_nm}
    by_path["A"], arts["A"] = phase_path_a(tokens, dense)
    walls["A"] = time.perf_counter() - t0
    launches["masked_matmul_dm"] = by_path["A"]["masked_matmul_dm"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    by_path["B"], arts["B"] = phase_path_b(tokens, dense)
    walls["B"] = time.perf_counter() - t0
    # the kernels the main path does not launch carry the in-run times of
    # the run that does: dM from path A (mask tuning), nm_spmm from the re-pack
    in_run["masked_matmul_dm"] = kernel_stats(arts["A"]["metrics"])["masked_matmul_dm"]
    in_run["nm_spmm"] = kernel_stats(art_nm["metrics"])["nm_spmm"]
    for name, n in (("masked_matmul_dm", launches["masked_matmul_dm"]),
                    ("nm_spmm", launches["nm_spmm"])):
        if in_run[name]["calls"] != n:
            raise AssertionError(f"obs: {name} booked {in_run[name]['calls']} launches, "
                                 f"the wrapper counted {n}")
    emit(dict(phase="obs_paths", spans={tag: top_spans(a, depth=1) for tag, a in arts.items()}))
    # the seven rows' in-run event times: a mean over every shape the run
    # gave the kernel, so not comparable with one shape's ``bound_ms``
    emit(dict(phase="obs_kernels", kernels_in_run=in_run))
    torch.cuda.empty_cache()
    # the Wanda prune at f32, where the two attention paths differ only in
    # the order of their sums
    cfg32 = get_config("llama_7b").replace(num_layers=4, attn_impl="flash")
    spec32 = RunSpec(arch="llama_7b", seed=0, seq=2048, sparsity=0.7, calib_samples=16,
                     pretrain_steps=0, epochs=0, bench_out="", kernel_tune="off")
    phase_mask_flips(cfg32, spec32, None, tokens, T.tree_map(lambda t: t.float(), dense))
    del dense
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_tiny_crosscheck()
    phase_tiny_pretrain()
    walls["tiny"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # the MoE family's path: its launches are the batched kernels' count
    moe_launches = phase_moe(walls)
    launches.update({k: moe_launches[k] for k in BATCHED})
    torch.cuda.empty_cache()
    # the SSM and hybrid families' paths
    fam_launches = {fam: phase_family(fam, walls) for fam in ("ssm", "hybrid")}
    torch.cuda.empty_cache()
    # the VLM family's path, tiny_vlm and the dense configs' SMOKEs
    vlm_launches, vlm_pre_launches = phase_vlm(walls)
    torch.cuda.empty_cache()
    # the encoder-decoder family's path and tiny_encdec
    enc_launches, enc_pre_launches = phase_encdec(walls)
    torch.cuda.empty_cache()
    # the EBFT walk on a mesh of ranks: two gloo ranks on the one card;
    # then the MoE, SSM and hybrid families on the same meshes
    phase_mesh(walls)
    torch.cuda.empty_cache()
    phase_mesh_families(walls)
    torch.cuda.empty_cache()
    # the launch plans and the tile autotuner (every path above ran with it off)
    phase_tuning(g, walls)
    phase_dryrun(dryrun, walls)
    emit(dict(phase="walls", seconds=walls, total_s=time.perf_counter() - t_start))

    root = "src/repro_torch/kernels/csrc/"
    pallas = {"masked_matmul": "src/repro/kernels/masked_matmul/masked_matmul.py:49",
              "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:85",
              "nm_spmm": "src/repro/kernels/nm_spmm/nm_spmm.py:62"}
    kernels = []
    for name, row in rows.items():
        base = name.replace("_dx", "").replace("_dw", "").replace("_dm", "").replace("_bwd", "")
        base = base.replace("_batched", "")  # the batched entry of masked_matmul.cu
        kernels.append(dict(name=name, route="cuda", source=root + base + ".cu",
                            replaces=pallas[base], launches=launches[name],
                            launches_moe=moe_launches[name],
                            launches_ssm=fam_launches["ssm"][name],
                            launches_hybrid=fam_launches["hybrid"][name],
                            launches_vlm=vlm_launches[name],
                            launches_vlm_pretrain=vlm_pre_launches[name],
                            launches_encdec=enc_launches[name],
                            launches_encdec_pretrain=enc_pre_launches[name],
                            launches_pretrain=pre_launches[name],
                            launches_path_a=by_path["A"][name], launches_path_b=by_path["B"][name],
                            launches_serve=serve_launches[name],
                            tiles=_default_tiles(name),
                            max_abs_err=row["max_abs_err"], ms=row["ms"],
                            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row.get("library_ms"),
                            vs_library=(row["ms"] / row["library_ms"]
                                        if row.get("library_ms") else None)))
    # the attention forward at the serve phase's two shapes
    kernels[[k["name"] for k in kernels].index("flash_attention")].update({
        f"serve_{kind}": {key: r[key] for key in ("BH", "Sq", "Sk", "q_offset", "max_abs_err",
                                                  "ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms")}
        for kind, r in serve_rows.items()})
    # the moe path's shapes of the 2-D kernels
    for k in kernels:
        if k["name"] in moe_shapes:
            keys = ATTN_KEYS if k["name"].startswith("flash") else MMM_KEYS
            k["moe"] = {label: {key: r.get(key) for key in keys}
                        for label, r in moe_shapes[k["name"]].items()}
    # the ssm and hybrid paths' shapes: the Mamba leaves, the shared block's attention
    for k in kernels:
        for fam in ("ssm", "hybrid"):
            shapes = dict(mamba_shapes[fam].get(k["name"], {}))
            if fam == "hybrid":
                shapes.update(hyb_shapes.get(k["name"], {}))
            if shapes:
                keys = ATTN_KEYS if k["name"].startswith("flash") else MMM_KEYS
                k[fam] = {label: {key: r.get(key) for key in keys}
                          for label, r in shapes.items()}
    # the vlm path's shapes (LLaVA's leaves, its attention) and the dense configs' leaves
    for k in kernels:
        for group in ("vlm", "dense_configs"):
            shapes = vlm_shapes[group].get(k["name"], {})
            if shapes:
                keys = ATTN_KEYS if k["name"].startswith("flash") else MMM_KEYS
                k[group] = {label: {key: r.get(key) for key in keys}
                            for label, r in shapes.items()}
    # the encdec path's shapes: Seamless's leaves at M 2048 and 16384, its attention
    for k in kernels:
        shapes = enc_shapes.get(k["name"], {})
        if shapes:
            keys = ATTN_KEYS if k["name"].startswith("flash") else MMM_KEYS + ("M",)
            k["encdec"] = {label: {key: r.get(key) for key in keys}
                           for label, r in shapes.items()}
    print(smi(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
