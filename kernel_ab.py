#!/usr/bin/env python3
"""Time the bf16 kernels of this checkout against another checkout's, in
turns, on one card.

    python3 kernel_ab.py --old DIR

DIR is a whole checkout of another revision, e.g. ``mkdir -p build/old &&
git archive REV | tar -x -C build/old`` (``build/`` is ignored by git).
Each checkout builds its kernels into its own ``build/kernels/`` (both
builds run together, before any timing) and is timed in a process of its
own that imports that checkout's ``repro_torch``, in the order old, new,
new, old. Every process makes the same inputs from seed 0 and times, with
``chip_smoke.timed_ms``, the masked matmul forward, dX, dW and dM at the
Llama-7B leaf shapes of ``chip_smoke.LEAVES`` (M = ``chip_smoke.M_ROWS``
rows, a 30% mask), the flash attention forward and backward at (256,
2048, 2048, 128) causal, and nm_spmm at 2:4 on w_up (x of M rows against
a (4096, 11008) weight), each beside the PyTorch call that computes the
same function (``torch.matmul``, ``scaled_dot_product_attention``).
It prints one JSON line per run and kernel, with the sha256 of the
checkout's ``csrc/*.cu`` and ``*.cuh`` files, the sha256 of the kernel's
output (``out``: two checkouts whose kernels give the same bits on these
inputs print the same digest) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import math
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
KERNELS = ["masked_matmul", "flash_attention", "nm_spmm"]
ATTN = (256, 2048, 128)  # (B * H, S, head width)
NM_SHAPE = (4096, 11008)  # w_up, (K, N)


def sources_sha(tree: Path) -> str:
    """The first 16 hex digits of the sha256 of ``tree``'s kernel sources."""
    h = hashlib.sha256()
    csrc = tree / "src" / "repro_torch" / "kernels" / "csrc"
    for p in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes (or a
    tuple's)."""
    import torch

    h = hashlib.sha256()
    for x in t if isinstance(t, tuple) else (t,):
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _row(base, kernel, fn, library, **kw) -> None:
    """Time ``fn`` and ``library`` and print the row with ``fn``'s digest."""
    cs.emit(dict(base, kernel=kernel, **kw, ms=cs.timed_ms(fn), library_ms=cs.timed_ms(library),
                 out=digest(fn())))


def _build_of(tree: Path):
    """``tree``'s ``repro_torch.kernels._build`` (a process imports one
    checkout's package)."""
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build

    if not Path(_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"kernel_ab: imported {_build.__file__}, not the checkout {tree}")
    return _build


def build_tree(tree: str) -> None:
    _build_of(Path(tree)).build(KERNELS)


def time_tree(tag: str, tree: str) -> None:
    import torch
    import torch.nn.functional as F

    tree = Path(tree)
    _build_of(tree)
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.masked_matmul import ops as MM
    from repro_torch.kernels.nm_spmm import ops as NM
    from repro_torch.sparsity import sparse_params as SP

    base = dict(version=tag, sources=sources_sha(tree), card=cs.smi())
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, n_red in cs.LEAVES:
        K, N = math.prod(shape[:n_red]), math.prod(shape[n_red:])
        x = torch.randn(cs.M_ROWS, K, device="cuda", generator=g).to(bf)
        w = (torch.randn(K, N, device="cuda", generator=g) / math.sqrt(K)).to(bf)
        m = torch.rand(K, N, device="cuda", generator=g) < 0.3
        dy = torch.randn(cs.M_ROWS, N, device="cuda", generator=g).to(bf)
        wm = w * m.to(bf)
        ops = [("forward", lambda: MM.masked_matmul(x, w, m), lambda: x @ wm),
               ("dx", lambda: MM.masked_matmul_dx(dy, w, m), lambda: dy @ wm.T),
               ("dw", lambda: MM.masked_matmul_dw(x, dy, m), lambda: (x.T @ dy) * m)]
        if hasattr(MM, "masked_matmul_dm"):  # an older tree may have no dM kernel
            ops.append(("dm", lambda: MM.masked_matmul_dm(x, dy, w), lambda: (x.T @ dy) * w))
        for op, kern, lib in ops:
            _row(base, f"masked_matmul_{op}", kern, lib, leaf=name)
        del x, w, m, dy, wm
    q, k, v, do = (torch.randn(*ATTN, device="cuda", generator=g).to(bf) for _ in range(4))
    _row(base, "flash_attention", lambda: FA.flash_attention(q, k, v, causal=True),
         lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], is_causal=True),
         shape=list(ATTN), causal=True)
    o, lse = FA._launch(q, k, v, True, 0, with_lse=True)
    leaves = [t[None].clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    _row(base, "flash_attention_bwd",
         lambda: FA.flash_attention_bwd(q, k, v, o, do, lse, causal=True),
         lambda: torch.autograd.grad(out, leaves, do[None], retain_graph=True),
         shape=list(ATTN), causal=True)
    del q, k, v, do, o, lse, leaves, out
    K, N = NM_SHAPE
    x = torch.randn(cs.M_ROWS, K, device="cuda", generator=g).to(bf)
    w = (torch.randn(K, N, device="cuda", generator=g) / math.sqrt(K)).to(bf)
    vals, idx = SP.nm_compress(w, SP.nm_mask(torch.rand(K, N, device="cuda", generator=g), 2, 4),
                               2, 4)
    wd = SP.nm_decompress(vals, idx, 2, 4)
    _row(base, "nm_spmm", lambda: NM.nm_spmm(x, vals, idx, n=2, m=4), lambda: x @ wd,
         leaf="w_up", pattern="2:4")


def _child(call: str) -> list:
    """A fresh interpreter that runs ``call`` of this module."""
    return [sys.executable, "-c",
            f"import sys; sys.path.insert(0, {str(ROOT)!r}); import kernel_ab; kernel_ab.{call}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="a checkout of the revision to time against")
    old = ap.parse_args(argv).old.resolve()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device; this script times kernels on a GPU")
    trees = {"old": old, "new": ROOT}
    builds = [subprocess.Popen(_child(f"build_tree({str(t)!r})"), cwd=ROOT)
              for t in trees.values()]
    if [p.wait(timeout=600) for p in builds] != [0, 0]:
        raise SystemExit("kernel_ab: a checkout's kernels did not build")
    for tag in ("old", "new", "new", "old"):
        subprocess.run(_child(f"time_tree({tag!r}, {str(trees[tag])!r})"), cwd=ROOT,
                       check=True, timeout=600)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
