"""The port's layers, block and model against the JAX reference, on the
CPU (plain PyTorch path), at tiny_dense sizes in f32.

Inputs come from a seeded numpy generator and go to both sides. Stated
tolerance: rtol = atol = 1e-5 (f32; the two sides sum in another order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models.model import build as ref_build
from repro.sparsity import sparse_params as RSP
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import reconstruction as R
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import build

from _torch_threads import one_thread_module  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), _np(ref), **(tol or TOL))


@pytest.fixture(scope="module")
def ref_tiny():
    cfg = ref_get_config("tiny_dense")
    model = ref_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


@pytest.fixture(scope="module")
def port_params(ref_tiny):
    _, _, params = ref_tiny
    return interop.params_to_torch(jax.tree.map(np.asarray, params), "cpu")


def test_config_copy_matches_reference():
    for name in ("tiny_dense", "llama_7b"):
        assert get_config(name) == get_config(name).replace()
        assert vars(get_config(name)) == vars(ref_get_config(name))


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 128)])
def test_norms_match(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32) * 3
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    _close(L.rms_norm(torch.tensor(x), torch.tensor(w)), RL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(L.layer_norm(torch.tensor(x), torch.tensor(w), torch.tensor(b)),
           RL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("hd,theta", [(16, 10000.0), (64, 500000.0)])
def test_rope_matches(hd, theta):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
    pos = np.arange(9)[None, :]
    cos, sin = L.rope_table(torch.tensor(pos), hd, theta)
    rcos, rsin = RL.rope_table(jnp.asarray(pos), hd, theta)
    _close(cos, rcos)
    _close(sin, rsin)
    _close(L.apply_rope(torch.tensor(x), cos, sin), RL.apply_rope(jnp.asarray(x), rcos, rsin))


@pytest.mark.parametrize("impl", ["dot", "chunked", "flash"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_attend_matches(impl, causal, hkv):
    """``flash`` on a CPU tensor takes the chunked plain path, as the
    reference's does off the TPU; chunk 16 leaves a ragged last chunk."""
    rng = np.random.default_rng(3)
    B, S, H, hd = 2, 40, 4, 16
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, hkv, hd)).astype(np.float32)
    out = L.attend(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
                   impl=impl, chunk=16)
    ref = RL.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                    impl=impl, chunk=16)
    _close(out, ref)


def test_attend_q_chunk_matches():
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(1, 32, 2, 16)).astype(np.float32) for _ in range(3))
    out = L.attend(*(torch.tensor(a) for a in (q, k, v)), causal=True, impl="chunked",
                   chunk=8, q_chunk=8)
    ref = RL.attend(*(jnp.asarray(a) for a in (q, k, v)), causal=True, impl="chunked",
                    chunk=8, q_chunk=8)
    _close(out, ref)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "sq_relu"])
def test_mlp_block_matches(act):
    rng = np.random.default_rng(5)
    p = {"w_up": rng.normal(size=(16, 32)), "w_down": rng.normal(size=(32, 16)),
         "w_gate": rng.normal(size=(16, 32))}
    p = {k: v.astype(np.float32) / 4 for k, v in p.items()}
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    out = L.mlp_block({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x), act)
    ref = RL.mlp_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    _close(out, ref)


def _block_inputs(cfg, seed=6):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24)[None, :]
    return h, pos


@pytest.mark.parametrize("masked", [False, True])
def test_block_apply_matches(ref_tiny, port_params, masked):
    cfg, model, params = ref_tiny
    h, pos = _block_inputs(cfg)
    bp = jax.tree.map(lambda a: a[1], params["blocks"])
    port_bp = T.slice_block(port_params["blocks"], 1)
    port_masks = None
    if masked:
        rng = np.random.default_rng(7)

        def mk(path, leaf):
            if RSP.is_prunable(path, leaf):
                return jnp.asarray(rng.random(leaf.shape) > 0.5, jnp.float32)
            return jnp.ones((), jnp.float32)

        ref_masks = jax.tree_util.tree_map_with_path(mk, bp)
        bp = RSP.apply_masks(bp, ref_masks)
        port_masks = interop.masks_to_torch(jax.tree.map(np.asarray, ref_masks), "cpu")
    ref, _ = RT.block_apply(bp, cfg, jnp.asarray(h), jnp.asarray(pos))
    out = T.block_apply(port_bp, get_config("tiny_dense"), torch.tensor(h),
                        torch.tensor(pos), port_masks)
    _close(out, ref)


@pytest.mark.parametrize("attn_impl", ["dot", "flash"])
def test_logits_and_loss_match(ref_tiny, port_params, attn_impl):
    cfg, _, params = ref_tiny
    cfg = cfg.replace(attn_impl=attn_impl)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    ref_model = ref_build(cfg)
    model = build(get_config("tiny_dense").replace(attn_impl=attn_impl))
    batch = {"tokens": torch.tensor(tokens)}
    ref_batch = {"tokens": jnp.asarray(tokens)}
    _close(model.forward(port_params, batch), ref_model.forward(params, ref_batch))
    loss, metrics = model.loss(port_params, batch)
    ref_loss, _ = ref_model.loss(params, ref_batch)
    _close(loss, ref_loss)
    assert set(metrics) == {"nll"}


def test_block_api_roundtrip(port_params):
    cfg = get_config("tiny_dense")
    model = build(cfg)
    tokens = torch.tensor(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 16)))
    h, pos = model.embed_tokens(port_params, {"tokens": tokens})
    for i in range(model.num_blocks):
        h = model.apply_block(port_params, i, model.get_block(port_params, i), h, pos)
    logits = model.finalize(port_params, h)
    torch.testing.assert_close(logits, model.forward(port_params, {"tokens": tokens}),
                               rtol=0, atol=0)


def test_advance_applies_the_stored_block(port_params):
    cfg = get_config("tiny_dense")
    model = build(cfg)
    h, pos = _block_inputs(cfg)
    h, pos = torch.tensor(h), torch.tensor(pos)
    bp = model.get_block(port_params, 1)
    torch.testing.assert_close(R.advance(model, port_params, 1, h, pos),
                               R.advance_with(model, port_params, 1, bp, h, pos), rtol=0, atol=0)
    torch.testing.assert_close(R.advance(model, port_params, 1, h, pos),
                               T.block_apply(bp, cfg, h, pos), rtol=0, atol=0)


def test_set_block_writes_in_place():
    cfg = get_config("tiny_dense")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    bp = model.get_block(params, 0)
    zeroed = {k: {kk: torch.zeros_like(vv) for kk, vv in v.items()} for k, v in bp.items()}
    out = model.set_block(params, 1, zeroed)
    assert out is params
    assert float(params["blocks"]["mlp"]["w_up"][1].abs().sum()) == 0.0
    assert float(params["blocks"]["mlp"]["w_up"][0].abs().sum()) > 0.0


def test_init_shapes_and_scales_match_reference(ref_tiny):
    _, _, ref_params = ref_tiny
    params = build(get_config("tiny_dense")).init(torch.Generator().manual_seed(0))
    ref_leaves = dict(jax.tree_util.tree_flatten_with_path(ref_params)[0])
    flat = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v

    walk(params)
    ref_flat = {tuple(p.key for p in path): v for path, v in ref_leaves.items()}
    assert flat.keys() == ref_flat.keys()
    for k, v in flat.items():
        r = np.asarray(ref_flat[k])
        assert tuple(v.shape) == r.shape, k
        # same init scale (std within 20%) for the random leaves
        if r.std() > 0:
            assert 0.8 < float(v.float().std()) / float(r.std()) < 1.25, k


def test_bf16_forward_is_finite_and_close(ref_tiny, port_params):
    """bf16 model on both sides: they round at other places, so the bound
    is the bf16 one of the kernel tests (2e-2 on logits)."""
    cfg, _, params = ref_tiny
    cfg16 = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    tokens = np.random.default_rng(10).integers(0, cfg.vocab_size, (1, 16)).astype(np.int32)
    ref = ref_build(cfg16).forward(p16, {"tokens": jnp.asarray(tokens)})
    port = build(get_config("tiny_dense").replace(dtype="bfloat16", param_dtype="bfloat16"))
    out = port.forward(interop.params_to_torch(jax.tree.map(np.asarray, p16), "cpu"),
                       {"tokens": torch.tensor(tokens)})
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    _close(out, ref, rtol=2e-2, atol=2e-2)
