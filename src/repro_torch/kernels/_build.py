"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers, so
``nvcc`` turns it into ``build/kernels/lib<name>.so`` (at the repository
root) in seconds. The build happens on first use, never at import: the
CPU tests import every module on machines that have no ``nvcc``.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C signatures, by library: every pointer and the stream is c_void_p (a
# bare Python int would be cut to 32 bits)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "masked_matmul": {
        **{f"masked_matmul{op}_{dt}": [P, P, P, P, I, I, I, LL, LL, LL, LL, P]
           for op in ("", "_dx", "_dw", "_dm") for dt in ("f32", "bf16")},
        # E slabs: the row strides, then the slab strides
        **{f"masked_matmul_batched{op}_{dt}": [P, P, P, P, I, I, I, I, *[LL] * 8, P]
           for op in ("", "_dx", "_dw", "_dm") for dt in ("f32", "bf16")},
    },
    "flash_attention": {
        **{fn: [P, P, P, P, P, I, I, I, I, I, I, F, P]
           for fn in ("flash_attention_f32", "flash_attention_bf16")},
        **{fn: [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, P]
           for fn in ("flash_attention_bwd_f32", "flash_attention_bwd_bf16")},
    },
    "nm_spmm": {
        fn: [P, P, P, P, I, I, I, I, I, LL, LL, LL, LL, P]
        for fn in ("nm_spmm_f32", "nm_spmm_bf16")
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
build_log: Dict[str, str] = {}  # name -> nvcc's output (registers, spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("repro_torch kernels: nvcc not found (CUDA toolkit "
                       "needed to build csrc/*.cu)")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build(names: Iterable[str]) -> None:
    """Compile the stale libraries among ``names``: one ``nvcc`` process
    per source, all started together."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        build_log[n] = out
        if p.returncode != 0:
            failed.append(f"{n}:\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise when a C launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
