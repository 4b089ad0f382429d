"""The port's sharding rules (``repro_torch.distributed.sharding``) and the
launch policy (``repro_torch.launch.steps``) against the reference's, on
the production 16 × 16 and 2 × 16 × 16 meshes, with no devices.

The reference's shapes come from ``jax.eval_shape``, the port's from its
own init under ``FakeTensorMode`` (``sharding.abstract_params``); the specs
must be equal leaf by leaf (a spec is ``tuple(PartitionSpec)``), and the
trees' paths and shapes too. The reference test's own properties
(``tests/test_sharding.py``) are held on the port's specs beside.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.base import ALL_SHAPES as REF_SHAPES
from repro.distributed import sharding as RSH
from repro.launch import steps as RSTEPS
from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh
from repro.models.model import build as ref_build
from repro.optim.optimizers import adamw as ref_adamw
from repro_torch import tree as T
from repro_torch.configs import CONFIG_IDS, get_config
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import abstract_production_mesh, make_abstract_mesh
from repro_torch.models.model import build
from repro_torch.optim.optimizers import adamw

MESH1 = make_abstract_mesh((16, 16), ("data", "model"))
MESH2 = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
REF_MESH = {"single": ref_abstract_mesh((16, 16), ("data", "model")),
            "multi": ref_abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
PORT_MESH = {"single": MESH1, "multi": MESH2}


def _names(path):
    return tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


def _ref_tree(tree, is_leaf=None):
    """A jax pytree as the port's nested dict, keyed by path names."""
    out: dict = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
        T.set_path(out, _names(path), leaf)
    return out


def _as_shapes(tree):
    return T.tree_map(lambda x: SH.ShapeLeaf(x.shape), _ref_tree(tree))


def _ref_specs(specs):
    from jax.sharding import PartitionSpec as P

    return T.tree_map(tuple, _ref_tree(specs, is_leaf=lambda x: isinstance(x, P)))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    model = ref_build(ref_get_config(arch))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    return SH.abstract_params(build(get_config(arch)))


def _leaves(tree):
    return dict(T.leaves_with_path(tree))


def _assert_divisible(tree, specs, mesh):
    for path, spec in T.leaves_with_path(specs):
        leaf = T.get_path(tree, path)
        for d, ax in enumerate(spec):
            assert leaf.shape[d] % SH.shards_of((ax,), mesh) == 0, (path, d, leaf.shape)


def test_production_meshes_match_reference():
    from repro.launch.mesh import abstract_production_mesh as ref_production

    for multi in (False, True):
        ref, port = ref_production(multi_pod=multi), abstract_production_mesh(multi_pod=multi)
        assert port.axis_names == tuple(ref.axis_names)
        assert port.shape == dict(ref.shape) and port.size == ref.size


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", CONFIG_IDS)
def test_param_pspecs_match_reference(arch, mesh, fsdp):
    """Every leaf's spec equals the reference's, on the same shapes, and
    divides its dim (the reference's dry-run contract)."""
    ref_shapes = _ref_shapes(arch)
    ports = _port_shapes(arch)
    assert {p: l.shape for p, l in _leaves(ports).items()} == \
        {p: tuple(l.shape) for p, l in _leaves(_ref_tree(ref_shapes)).items()}
    ref = _ref_specs(RSH.param_pspecs(ref_shapes, REF_MESH[mesh], fsdp=fsdp))
    port = SH.param_pspecs(ports, PORT_MESH[mesh], fsdp=fsdp)
    assert _leaves(port) == _leaves(ref)
    _assert_divisible(ports, port, PORT_MESH[mesh])


@pytest.mark.parametrize("arch", ["qwen1_5_110b", "kimi_k2_1t_a32b"])
def test_param_pspecs_fsdp_shards_more(arch):
    shapes = _port_shapes(arch)

    def n_sharded(specs):
        return sum(any(a is not None for a in s) for _, s in T.leaves_with_path(specs))

    assert n_sharded(SH.param_pspecs(shapes, MESH1, fsdp=True)) > \
        n_sharded(SH.param_pspecs(shapes, MESH1, fsdp=False))


def test_attention_never_shards_head_dim():
    for arch in CONFIG_IDS:
        for path, spec in T.leaves_with_path(SH.param_pspecs(_port_shapes(arch), MESH1)):
            if path[-1] in ("wq", "wk", "wv"):
                assert spec[-1] is None, (arch, path, spec)


def test_moe_experts_shard_over_model_axis_and_router_replicates():
    shapes = _port_shapes("deepseek_moe_16b")
    found = [spec[T.get_path(shapes, path).shape.__len__() - 3] == "model"
             for path, spec in T.leaves_with_path(SH.param_pspecs(shapes, MESH1))
             if "experts" in path and path[-1] in ("w_up", "w_gate", "w_down")]
    assert found and all(found)
    for path, spec in T.leaves_with_path(SH.param_pspecs(_port_shapes("kimi_k2_1t_a32b"),
                                                         MESH1)):
        if "router" in path:
            assert all(a is None for a in spec), (path, spec)


def test_vocab_sharded_embed_and_head():
    specs = SH.param_pspecs(_port_shapes("qwen1_5_4b"), MESH1)
    assert specs["embed"]["tok"][0] == "model" and specs["head"]["w"][1] == "model"


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_batch_pspecs_match_reference(mesh):
    for b in (256, 1, 16):
        ref_batch = {"tokens": jax.ShapeDtypeStruct((b, 128), jnp.int32)}
        ref = _ref_specs(RSH.batch_pspecs(ref_batch, REF_MESH[mesh]))
        assert SH.batch_pspecs(_as_shapes(ref_batch), PORT_MESH[mesh]) == ref
    assert SH.batch_pspecs({"t": SH.ShapeLeaf((256, 128))}, MESH1)["t"][0] == "data"
    assert SH.batch_pspecs({"t": SH.ShapeLeaf((256, 128))}, MESH2)["t"][0] == ("pod", "data")
    assert SH.batch_pspecs({"t": SH.ShapeLeaf((1, 128))}, MESH1)["t"] == (None, None)


def test_opt_pspecs_match_reference():
    """ZeRO-1 on qwen1.5-110b's AdamW state: the reference's specs, and a
    moment leaf takes the data axis."""
    ref_shapes = _ref_shapes("qwen1_5_110b")
    ref_opt = jax.eval_shape(ref_adamw(1e-4).init, ref_shapes)
    ref = _ref_specs(RSH.opt_pspecs(ref_opt, None, REF_MESH["single"]))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = build(get_config("qwen1_5_110b")).init(torch.Generator())
        opt = T.tree_map(lambda t: SH.ShapeLeaf(t.shape), adamw(1e-4).init(params))
    port = SH.opt_pspecs(opt, None, MESH1)
    assert _leaves(port) == _leaves(ref)
    _assert_divisible(opt, port, MESH1)
    assert any("data" in spec for _, spec in T.leaves_with_path(port))


@pytest.mark.parametrize("arch", ["qwen1_5_110b", "zamba2_1_2b", "mamba2_130m"])
def test_cache_pspecs_match_reference(arch):
    model = ref_build(ref_get_config(arch))
    state = jax.eval_shape(lambda: model.init_serve_state(128, 1024))
    ref = _ref_specs(RSH.cache_pspecs(state, REF_MESH["single"]))
    shapes = _as_shapes(state)
    port = SH.cache_pspecs(shapes, MESH1)
    assert _leaves(port) == _leaves(ref)
    _assert_divisible(shapes, port, MESH1)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert SH.to_placements((None, "model", None), MESH1) == (Replicate(), Shard(1))
    assert SH.to_placements(("data", None), MESH1) == (Shard(0), Replicate())
    assert SH.to_placements((("pod", "data"), "model"), MESH2) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="twice"):
        SH.to_placements(("model", "model"), MESH1)


@pytest.mark.parametrize("arch", CONFIG_IDS)
def test_padded_heads_and_adapt_config_match_reference(arch):
    """The padded (H, KV) on every model-axis width the meshes take, and the
    adapted config for every shape on no mesh and both production meshes."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for width in (1, 2, 4, 8, 16):
        assert STEPS.padded_heads(cfg, width) == RSTEPS.padded_heads(ref_cfg, width)
    for shape, ref_shape in zip(ALL_SHAPES, REF_SHAPES):
        assert dataclasses.asdict(shape) == dataclasses.asdict(ref_shape)
        for mesh in (None, "single", "multi"):
            port = STEPS.adapt_config(cfg, shape, PORT_MESH.get(mesh))
            ref = RSTEPS.adapt_config(ref_cfg, ref_shape, REF_MESH.get(mesh))
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), (shape.name, mesh)
            if mesh is not None:
                assert STEPS.microbatches_for(cfg, shape, PORT_MESH[mesh]) == \
                    RSTEPS.microbatches_for(ref_cfg, ref_shape, REF_MESH[mesh])
    assert STEPS.wants_fsdp(cfg) == RSTEPS.wants_fsdp(ref_cfg)


def test_padded_heads_policy():
    """The reference test's table for the assigned archs on 16."""
    assert STEPS.padded_heads(get_config("qwen1_5_4b"), 16) == (32, 32)
    assert STEPS.padded_heads(get_config("qwen2_5_32b"), 16) == (48, 8)
    assert STEPS.padded_heads(get_config("qwen1_5_110b"), 16) == (64, 8)
    assert STEPS.padded_heads(get_config("nemotron_4_15b"), 16) == (48, 8)
    assert STEPS.padded_heads(get_config("llava_next_mistral_7b"), 16) == (32, 8)
