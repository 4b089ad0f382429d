"""The sharded step cells' specs (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``), in one process, with no devices.

Every config's train, prefill, decode and ebft cells on the production
16 × 16 mesh (and three configs on 2 × 16 × 16), both as Auto-axis
abstract meshes: the adapted config, the in- and out-specs, the abstract
arguments' shapes and dtypes and ``donate_argnums``; nothing is
allocated. The port's KV cache is (L, B, Hkv, max_len, hd) where the
reference's is (L, B, max_len, Hkv, hd): its leaves are held with dims 2
and 3 swapped, and its host-int ``len`` has no spec. The Mamba states
take the head-parallel mixer's layout (``_mamba_spec``; ROADMAP.md C.12),
their shapes and dtypes the reference's. The numbers of the
cells are ``tests/test_torch_steps.py``'s (the two files split the time).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import pytest
from jax.sharding import AbstractMesh, AxisType, NamedSharding

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import steps as RST
from repro_torch import tree as T
from repro_torch.configs import CONFIG_IDS, get_config
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_abstract_mesh

POD_ARCHS = ("llama_7b", "deepseek_moe_16b", "mamba2_130m")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_mesh(key):
    shape, names = MESHES[key]
    return AbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(names))


def _shapes(cfg):
    return list(cfg.shapes()) + [ST.EBFT_SHAPE]


@functools.lru_cache(maxsize=None)
def _ref_cells(arch: str, key: str):
    cfg, mesh = ref_get_config(arch), _ref_mesh(key)
    return {s.name: RST.build_cell(cfg, RefShape(s.name, s.seq_len, s.global_batch, s.kind), mesh)
            for s in _shapes(get_config(arch))}


def _names(path):
    return tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


def _ref_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {_names(p): x for p, x in leaves}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _kv(path, shape) -> bool:
    return bool(path) and path[-1] in ("k", "v") and len(shape) == 5


def _swap(t):
    return tuple(t[:2]) + (t[3], t[2]) + tuple(t[4:])


def _mamba_spec(path, shape, mesh):
    """The port's own layout of a Mamba state leaf (ROADMAP.md C.12): an
    ``ssm`` (..., B, H, N, P) its batch over "data" and its heads over
    "model", a ``conv`` (..., B, K-1, ch) its batch only, each where it
    divides; None for other leaves."""
    name = path[-1] if path else None
    if name not in ("ssm", "conv"):
        return None
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    spec = [None] * len(shape)
    b = len(shape) - (4 if name == "ssm" else 3)
    if shape[b] % sizes["data"] == 0 and shape[b] >= sizes["data"]:
        spec[b] = "data"
    h = b + 1
    if name == "ssm" and shape[h] % sizes["model"] == 0 and shape[h] >= sizes["model"]:
        spec[h] = "model"
    return tuple(spec)


def _check_arg(port_specs, port_abs, ref_sh, ref_abs, where, mesh=None):
    rs, ra = _ref_flat(ref_sh), _ref_flat(ref_abs)
    ps, pa = dict(T.leaves_with_path(port_specs)), dict(T.leaves_with_path(port_abs))
    assert set(ps) == set(pa) == set(rs) == set(ra), where
    for path, a in ra.items():
        b, spec = pa[path], tuple(rs[path].spec)
        if path and path[-1] == "len":  # the port's host int
            assert isinstance(b, int) and ps[path] is None, (where, path)
            continue
        shape = tuple(a.shape)
        if _kv(path, shape):  # the port's cache layout
            shape, spec = _swap(shape), _swap(spec + (None,) * (5 - len(spec)))
        assert tuple(b.shape) == shape, (where, path, b.shape, shape)
        assert _dtype_name(b.dtype) == str(a.dtype), (where, path, b.dtype, a.dtype)
        full = spec + (None,) * (len(shape) - len(spec))
        own = _mamba_spec(path, shape, mesh) if mesh is not None else None
        if own is not None:  # the head-parallel mixer's state layout
            full = own
        assert tuple(ps[path]) == full, (where, path, ps[path], full)


def _check_cells(arch: str, key: str):
    ref = _ref_cells(arch, key)
    mesh = make_abstract_mesh(*MESHES[key])
    cfg = get_config(arch)
    for s in _shapes(cfg):
        cell, rc = ST.build_cell(cfg, s, mesh), ref[s.name]
        where = (arch, key, s.name)
        assert cell.kind == rc.kind and cell.donate_argnums == rc.donate_argnums, where
        assert dataclasses.asdict(cell.cfg) == dataclasses.asdict(rc.cfg), where
        assert len(cell.in_specs) == len(rc.in_shardings) == len(cell.abstract_args)
        for j, (ps, pa, rsh, ra) in enumerate(zip(cell.in_specs, cell.abstract_args,
                                                  rc.in_shardings, rc.abstract_args)):
            _check_arg(ps, pa, rsh, ra, where + (j,),
                       mesh if cell.kind in ("prefill", "decode") and j == 2 else None)
        # results: whole where the reference leaves them to jit, else the state's specs
        assert [o is None for o in cell.out_specs] == [o is None for o in rc.out_shardings]
        for o, i in zip(cell.out_specs, cell.in_specs[-len(cell.out_specs):]
                        if cell.kind in ("prefill", "decode") else cell.in_specs):
            assert o is None or o is i, where
        # nothing is allocated
        assert not list(T.tensors(cell.abstract_args)), where


@pytest.mark.parametrize("arch", CONFIG_IDS)
def test_cells_match_reference_16x16(arch):
    _check_cells(arch, "16x16")


@pytest.mark.parametrize("arch", POD_ARCHS)
def test_cells_match_reference_2x16x16(arch):
    _check_cells(arch, "2x16x16")


def test_ebft_dp_only_cell_matches_reference():
    """The ``dp_only`` layout: the block replicated, the batch over every
    mesh axis; a block above 500 M parameters keeps tensor parallelism."""
    for arch in ("llama_7b", "kimi_k2_1t_a32b"):
        rc = RST.build_ebft_cell(ref_get_config(arch), RST.EBFT_SHAPE, _ref_mesh("16x16"),
                                 dp_only=True)
        cell = ST.build_ebft_cell(get_config(arch), ST.EBFT_SHAPE,
                                  make_abstract_mesh(*MESHES["16x16"]), dp_only=True)
        for j in range(len(cell.in_specs)):
            _check_arg(cell.in_specs[j], cell.abstract_args[j], rc.in_shardings[j],
                       rc.abstract_args[j], (arch, j))
