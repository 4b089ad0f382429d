"""The hand-written CUDA sources against their ctypes bindings, on the CPU.

No CUDA compiler runs here, so a C entry point that is renamed, or that
gains, loses or changes an argument, would only fail at its first launch
on a card. This parses every ``extern "C" int <name>(...)`` in
``src/repro_torch/kernels/csrc/*.cu`` and holds the names and argument
types to ``_build.SIGNATURES``, which ``_build.load`` uses to call them.
"""
from __future__ import annotations

import ctypes
import re

import pytest

from repro_torch.kernels import _build

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _ctype(arg: str):
    """The ctypes type a C parameter declaration is bound with."""
    decl = " ".join(arg.split())
    if "*" in decl:
        return ctypes.c_void_p
    base = decl.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}[base]


def _entry_points(name: str) -> dict:
    src = (_build.CSRC / f"{name}.cu").read_text()
    return {fn: [_ctype(a) for a in args.split(",")] for fn, args in _ENTRY.findall(src)}


def test_every_source_has_a_binding():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_entry_points_match_the_bindings(name):
    found = _entry_points(name)
    want = _build.SIGNATURES[name]
    assert sorted(found) == sorted(want)
    for fn, argtypes in want.items():
        assert found[fn] == argtypes, fn


def test_the_parser_sees_a_changed_signature(tmp_path, monkeypatch):
    """A re-typed argument fails here rather than on the card."""
    src = (_build.CSRC / "nm_spmm.cu").read_text()
    bad = src.replace("extern \"C\" int nm_spmm_bf16(const void* x,",
                      "extern \"C\" int nm_spmm_bf16(int x,", 1)
    assert bad != src
    (tmp_path / "nm_spmm.cu").write_text(bad)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _entry_points("nm_spmm")["nm_spmm_bf16"] != _build.SIGNATURES["nm_spmm"]["nm_spmm_bf16"]


def _includes(path) -> set:
    return set(re.findall(r'#include\s+"([^"]+)"', path.read_text()))


def test_the_bf16_gemms_share_one_main_loop():
    """masked_matmul and nm_spmm run the wgmma/TMA main loop of one header;
    the WMMA tile loop they once shared is gone."""
    sources = {p.name: _includes(p) for p in _build.CSRC.glob("*.c*")}
    assert not (_build.CSRC / "wmma_tile.cuh").exists()
    assert not any("wmma_tile.cuh" in inc for inc in sources.values())
    assert "gemm.cuh" in sources["masked_matmul.cu"]
    assert "gemm.cuh" in sources["nm_spmm.cu"]
    assert "hopper.cuh" in sources["gemm.cuh"]
