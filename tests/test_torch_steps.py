"""The sharded step cells (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``) on one device, in one process; their
specs on the production meshes are ``tests/test_torch_steps_specs.py``'s.

* Numbers: the port's cells on one device against the reference's on a
  1 × 1 Auto jax mesh, tiny_dense at 2 layers, seq 64, batch 8 (the train
  cell at 2 microbatches), the same numpy inputs and weights (bf16).
  Measured on an x86 CPU (torch 2.13): train loss within 1e-5 relative and the
  grad norm within 4.4e-4, every updated weight within one bf16 ulp
  (2^-12 at these magnitudes) of the reference's in 0.3% of its
  elements; prefill and decode logits within 0.011 of logits up to 0.63
  in magnitude (three bf16 ulps), the same greedy tokens; the ebft loss
  within 7e-6 relative, the updated block within 2^-11. One Adam step
  moves a weight by about the learning rate whatever the gradient, so
  the weights alone would pass a wrong gradient: Adam's moments, which
  carry it, are held too, each leaf in relative L2 (train within
  1.8e-2, ebft 9.6e-3, both at v). Stated tolerances: loss rtol 1e-4,
  grad norm rtol 2e-3, weights atol 2^-10, logits atol 3e-2, ebft loss
  rtol 1e-4, moments 5e-2 (train) and 3e-2 (ebft).
* Block remat leaves the loss and every gradient bit for bit on the five
  tiny families, and its recompute runs.
* The port's cache placement: the reference's ``cache_pspecs`` puts
  "model" on the port's ``max_len``; ``port_cache_pspecs`` puts it on the
  KV heads.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as ref_get_config
from repro.configs.base import ShapeConfig as RefShape
from repro.launch import steps as RST
from repro.optim.optimizers import adam as ref_adam
from repro.optim.optimizers import adamw as ref_adamw
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import build
from repro_torch.optim.optimizers import adam, adamw
from repro_torch.training.train_loop import value_and_grad


def _swap(t):
    return tuple(t[:2]) + (t[3], t[2]) + tuple(t[4:])


# ---------------------------------------------------------------------------
# the cells' numbers on one device against the reference's on a 1 x 1 mesh
# ---------------------------------------------------------------------------
B, S, LAYERS = 8, 64, 2


def _cfgs():
    return (ref_get_config("tiny_dense").replace(num_layers=LAYERS),
            get_config("tiny_dense").replace(num_layers=LAYERS))


def _t(a):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return torch.from_numpy(a.copy())


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's four cells jitted with their shardings on a 1 x 1
    Auto mesh, and the inputs they ran on."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    rcfg, _ = _cfgs()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, rcfg.vocab_size, size=(B, S)).astype(np.int32)
    out = {"toks": toks}
    with mesh:
        def jit(cell):
            return jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           out_shardings=cell.out_shardings)

        tc = RST.build_train_cell(rcfg, RefShape("t", S, B, "train"), mesh, microbatches=2,
                                  fsdp=False)
        params = tc.model.init(jax.random.PRNGKey(0))
        out["train_params"] = params
        out["train"] = jit(tc)(params, ref_adamw(1e-4).init(params), {"tokens": jnp.asarray(toks)})

        pc = RST.build_prefill_cell(rcfg, RefShape("p", S, B, "prefill"), mesh)
        dc = RST.build_decode_cell(rcfg, RefShape("d", S, B, "decode"), mesh)
        sparams = pc.model.init(jax.random.PRNGKey(1))
        out["serve_params"] = sparams
        logits, _ = jit(pc)(sparams, {"tokens": jnp.asarray(toks)}, pc.model.init_serve_state(B, S))
        state = dc.model.init_serve_state(B, S + 1)
        _, state = dc.model.prefill(sparams, {"tokens": jnp.asarray(toks)}, state)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out["prefill"], out["tok"] = logits, tok
        out["decode"] = jit(dc)(sparams, tok, state)[0]

        ec = RST.build_ebft_cell(rcfg, RefShape("e", S, B, "ebft"), mesh)
        bw = ec.model.get_block(sparams, LAYERS // 2)
        mask = jax.tree.map(lambda x: jnp.asarray((rng.random(x.shape) < 0.5) | (x.ndim < 2),
                                                  jnp.bfloat16), bw)
        h = jnp.asarray(rng.normal(size=(B, S, rcfg.d_model)), jnp.bfloat16)
        tgt = jnp.asarray(rng.normal(size=(B, S, rcfg.d_model)), jnp.bfloat16)
        pos = jnp.arange(S, dtype=jnp.int32)[None]
        out["ebft_in"] = (bw, mask, h, tgt, pos)
        out["ebft"] = jit(ec)(bw, ref_adam(2e-4).init(bw), mask, h, tgt, pos)
    return out


ONE = make_abstract_mesh((1, 1), ("data", "model"))


def _weights_close(port, ref, atol=2.0 ** -10):
    ref = interop.params_to_torch(ref, "cpu")
    for path, t in T.leaves_with_path(port):
        r = T.get_path(ref, path)
        assert t.dtype == r.dtype, path
        np.testing.assert_allclose(t.float().numpy(), r.float().numpy(), rtol=0, atol=atol,
                                   err_msg="/".join(path))


def _moments_close(port, ref, rtol):
    """Adam's moments (m = 0.1 g after a step: the gradient itself; v its
    square), each leaf within ``rtol`` of the reference's in relative L2.
    A skipped update reads 1, a gradient from part of the batch 0.85–0.95
    on the mesh tests' planted fault."""
    ref = interop.params_to_torch(ref, "cpu")
    for k in ("m", "v"):
        for path, t in T.leaves_with_path(port[k]):
            r = T.get_path(ref[k], path).double()
            rel = ((t.double() - r).norm() / r.norm()).item()
            assert rel <= rtol, (k, "/".join(path), rel)


def test_train_cell_matches_reference_on_one_device(ref_runs):
    _, cfg = _cfgs()
    cell = ST.build_train_cell(cfg, ShapeConfig("t", S, B, "train"), ONE, microbatches=2,
                               fsdp=False)
    assert cell.cfg.remat == "block" and cell.cfg.dtype == "bfloat16"
    params = interop.params_to_torch(ref_runs["train_params"], "cpu")
    p2, o2, metrics = ST.run_cell(cell, ONE, params, adamw(1e-4).init(params),
                                  {"tokens": torch.from_numpy(ref_runs["toks"])})
    rp, ro, rm = ref_runs["train"]
    np.testing.assert_allclose(float(metrics["loss"]), float(rm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(rm["grad_norm"]), rtol=2e-3)
    _weights_close(p2, rp)
    _moments_close(o2, ro, 5e-2)


def test_prefill_and_decode_cells_match_reference_on_one_device(ref_runs):
    _, cfg = _cfgs()
    params = interop.params_to_torch(ref_runs["serve_params"], "cpu")
    toks = torch.from_numpy(ref_runs["toks"])
    pc = ST.build_prefill_cell(cfg, ShapeConfig("p", S, B, "prefill"), ONE)
    dc = ST.build_decode_cell(cfg, ShapeConfig("d", S, B, "decode"), ONE)
    logits, state = ST.run_cell(pc, ONE, params, {"tokens": toks},
                                pc.model.init_serve_state(B, S, "cpu"))
    assert state["len"] == S and tuple(state["k"].shape) == (LAYERS, B, cfg.num_kv_heads, S,
                                                             cfg.resolved_head_dim)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_runs["prefill"]), rtol=0, atol=3e-2)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    assert torch.equal(tok, _t(ref_runs["tok"]))
    state = dc.model.init_serve_state(B, S + 1, "cpu")
    _, state = dc.model.prefill(params, {"tokens": toks}, state)
    logits2, state = ST.run_cell(dc, ONE, params, tok, state)
    assert state["len"] == S + 1
    np.testing.assert_allclose(logits2.numpy(), np.asarray(ref_runs["decode"]), rtol=0, atol=3e-2)


def test_ebft_cell_matches_reference_on_one_device(ref_runs):
    _, cfg = _cfgs()
    cell = ST.build_ebft_cell(cfg, ShapeConfig("e", S, B, "ebft"), ONE)
    assert cell.cfg.remat == "none"
    bw, mask, h, tgt, pos = ref_runs["ebft_in"]
    pbw = T.tree_map(torch.clone, interop.params_to_torch(bw, "cpu"))
    bf = [_t(x).to(torch.bfloat16) for x in (h, tgt)]
    nbw, o, loss = ST.run_cell(cell, ONE, pbw, adam(2e-4).init(pbw),
                               interop.params_to_torch(mask, "cpu"), *bf, _t(pos))
    rbw, ro, rloss = ref_runs["ebft"]
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-4)
    _weights_close(nbw, rbw)
    _moments_close(o, ro, 3e-2)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tiny_dense", "tiny_moe", "tiny_ssm", "tiny_hybrid",
                                  "tiny_vlm"])
def test_block_remat_keeps_the_bits(arch, monkeypatch):
    """``remat="block"``: the loss and every gradient equal the plain
    forward's bit for bit, and the blocks run again in the backward (more
    norm calls than without remat)."""
    calls = {"n": 0}
    norm = L.apply_norm

    def counted(*a, **k):
        calls["n"] += 1
        return norm(*a, **k)

    monkeypatch.setattr(L, "apply_norm", counted)
    cfg = get_config(arch)
    out = {}
    for remat in ("none", "block"):
        model = build(cfg.replace(remat=remat))
        params = model.init(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=g, dtype=torch.int32)
                 if k == "tokens" else torch.randn(v.shape, generator=g)
                 for k, v in model.input_specs(ShapeConfig("t", 32, 4, "train")).items()}
        calls["n"] = 0
        out[remat] = value_and_grad(model.loss, params, batch) + (calls["n"],)
    (l0, g0, n0), (l1, g1, n1) = out["none"], out["block"]
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(T.leaves_with_path(g0), T.leaves_with_path(g1)):
        assert torch.equal(a, b), "/".join(path)
    assert n1 > n0


def test_port_cache_placement_shards_kv_heads_not_max_len():
    """The reference's ``cache_pspecs`` on the port's (L, B, Hkv, max_len,
    hd) cache puts "model" on max_len (the fault); ``port_cache_pspecs``
    puts it on the KV heads, as the reference's own layout does."""
    model = build(get_config("tiny_dense"))
    cache = ST._abstract(lambda: model.init_serve_state(8, 64, torch.device("cpu")))
    assert tuple(cache["k"].shape) == (2, 8, 4, 64, 16)
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    old = SH.cache_pspecs(cache, mesh)
    assert old["k"] == (None, "data", None, "model", None)  # model on max_len
    new = SH.port_cache_pspecs(cache, mesh)
    assert new["k"] == new["v"] == (None, "data", "model", None, None)
    assert new["len"] is None
    from repro.distributed import sharding as RSH
    from repro.launch.mesh import make_abstract_mesh as ref_abstract_mesh

    ref = RSH.cache_pspecs({"k": jax.ShapeDtypeStruct((2, 8, 64, 4, 16), jnp.bfloat16)},
                           ref_abstract_mesh((2, 2), ("data", "model")))
    assert _swap(tuple(ref["k"])) == new["k"]
