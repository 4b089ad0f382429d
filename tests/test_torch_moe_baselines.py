"""The baselines on the port's MoE family against the JAX reference, on the
CPU: tiny_moe (DeepSeek-MoE-16B's SMOKE: 3 layers, the first dense, 8
routed experts top-2, 2 shared) at S = 32, 16 calibration and 16
evaluation segments. SparseGPT and DSnoT prune each routed expert on its
own (the reference ``vmap``s them over E), mask tuning moves the experts'
masks through the batched dM, LoRA's routed-expert view is the whole
(L, E·d·f) leaf. Tolerances as ``_torch_baselines`` states them; the
batched dM's plain version against ``torch.bmm`` within rel 1e-6, and
the batched row loops against a loop over experts within rel 1e-6 (the
same f32 operations, another GEMM).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_baselines import (
    REL, SPARSITY, adapter_shapes, check_driver, check_lora, check_mask_tuning, check_prune,
    make_pair, ref_lora, ref_mask_tuning, ref_prunes,
)
from repro.core.pruning import common as RC
from repro.core.pruning import dsnot as RDSNOT
from repro.core.pruning import sparsegpt as RSGPT
from repro_torch import tree as T
from repro_torch.core import mask_tuning as MT
from repro_torch.core.pruning import common as C
from repro_torch.core.pruning import dsnot as DSNOT
from repro_torch.core.pruning import sparsegpt as SGPT
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.kernels.masked_matmul.ref import masked_matmul_batched_dm_plain
from repro_torch.sparsity import sparse_params as SP

from _torch_threads import one_thread_module  # noqa: F401



@pytest.fixture(scope="module")
def pair():
    return make_pair("tiny_moe")


@pytest.fixture(scope="module")
def refs(pair):
    return ref_prunes(pair)


@pytest.fixture(scope="module")
def ref_mt(pair, refs):
    return ref_mask_tuning(pair, refs)


@pytest.fixture(scope="module")
def ref_lr(pair, refs):
    return ref_lora(pair, refs)


# ---------------------------------------------------------------------------
# the batched dM's plain version, SparseGPT's and DSnoT's expert batching
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strided", [False, True])
def test_batched_dm_plain_equals_bmm(strided):
    """x (E, C, K), dy (E, C, N), w (E, K, N) -> (xᵀ dy) ⊙ w per slab, in
    f32, also on views into padded slabs (every operand strided)."""
    g = torch.Generator().manual_seed(0)
    E, Cs, K, N, pad = 3, 7, 12, 5, (2 if strided else 0)

    def make(r, c):
        t = torch.randn(E, r + 2 * pad, c + 2 * pad, generator=g)
        return t[:, pad:pad + r, pad:pad + c]

    x, dy, w = make(Cs, K), make(Cs, N), make(K, N)
    assert x.is_contiguous() != strided
    got = masked_matmul_batched_dm_plain(x, dy, w)
    want = torch.bmm(x.mT, dy) * w
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(MM.masked_matmul_batched_dm(x, dy, w), got)
    with pytest.raises(ValueError):  # slabs only
        MM.masked_matmul_batched_dm(x[0], dy[0], w[0])


def test_tuned_expert_mask_gets_the_batched_dm():
    """A float mask on E slabs that requires grad: its gradient is the
    batched dM, the input's the batched dX; the wrapper no longer refuses
    it. Booked under obs as ``kernels/masked_matmul_batched_dm``."""
    from repro_torch.obs.run import start_run

    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 16, generator=g, requires_grad=True)
    w = torch.randn(3, 16, 8, generator=g)
    m = (torch.rand(3, 16, 8, generator=g) < 0.5).float().requires_grad_(True)
    dy = torch.randn(3, 5, 8, generator=g)
    run = start_run("moe", device="cpu", console=False)
    gx, gm = torch.autograd.grad(MM.masked_matmul_batched(x, w, m), (x, m), dy)
    summ = run.finish()["metrics"]
    torch.testing.assert_close(gm, torch.bmm(x.detach().mT, dy) * w, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gx, torch.bmm(dy, (w * m.detach()).mT), rtol=1e-6, atol=1e-6)
    assert summ["kernels/masked_matmul_batched_dm/calls"]["value"] == 1
    assert summ["kernels/masked_matmul_batched_dm/flops"]["value"] == 2.0 * 3 * 5 * 16 * 8


def _expert_leaf(seed=0, E=4, Cs=40, R_=24, O=12):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(E, R_, O)).astype(np.float32)
    x = rng.normal(size=(E, Cs, R_)).astype(np.float32)
    x[1, Cs // 4:] = 0.0  # an expert with few filled slots: a Gram of low rank
    return w, x


def _ref_stats(x):
    xj = jnp.asarray(x)
    return RC.LeafStats(float(x.shape[1]), xj.sum(axis=1), jnp.square(xj).sum(axis=1),
                        jnp.einsum("ecr,ecs->ers", xj, xj))


@pytest.mark.parametrize("pattern", [None, (2, 4)])
def test_sparsegpt_prunes_each_expert_against_its_own_gram(pattern):
    """The batched row loop over an (E, R, O) expert leaf equals the 2-D
    loop on each expert (masks equal, weights within rel 1e-6) and the
    reference's ``vmap`` (masks equal, weights within rel 1e-4)."""
    w, x = _expert_leaf()
    st = C._acc_stats(torch.tensor(x), want_hessian=True)
    got_w, got_m = SGPT.leaf_prune("w_up", torch.tensor(w), st, 0.5, pattern)
    for e in range(w.shape[0]):
        we, me = SGPT.prune_matrix(torch.tensor(w[e]), st.hessian[e], 0.5, pattern)
        assert torch.equal(got_m[e], me), e
        torch.testing.assert_close(got_w[e], we, rtol=1e-6, atol=1e-6)
    rw, rm = RSGPT.leaf_prune("w_up", jnp.asarray(w), _ref_stats(x), 0.5, pattern)
    assert np.array_equal(got_m.numpy(), np.asarray(rm) != 0)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(rw), rtol=0,
                               atol=REL * float(np.abs(np.asarray(rw)).max()))


@pytest.mark.parametrize("pattern", [None, (2, 4)])
def test_dsnot_reselects_each_expert_on_its_own(pattern):
    """The batched reselection of an (E, R, O) expert leaf equals the 2-D
    one on each expert, and the reference's ``vmap``."""
    w, x = _expert_leaf(1)
    st = C._acc_stats(torch.tensor(x))
    rng = np.random.default_rng(2)
    init = SP.nm_mask(torch.tensor(rng.random(w.shape)), *pattern) if pattern else \
        SP.topk_mask_rows(torch.tensor(rng.random(w.shape)), 0.5)
    got = DSNOT.leaf_reselect("w_up", torch.tensor(w), init, st, 30, pattern)
    for e in range(w.shape[0]):
        assert torch.equal(got[e], DSNOT.reselect(torch.tensor(w[e]), init[e], st.mean[e],
                                                  st.col_norm[e], 30, pattern)), e
    assert not torch.equal(got, init)
    assert torch.equal(got.sum(-2), init.sum(-2))  # each column keeps its count
    want = RDSNOT.leaf_reselect("w_up", jnp.asarray(w), jnp.asarray(init.numpy(), jnp.float32),
                                _ref_stats(x), 30, pattern)
    assert np.array_equal(got.numpy(), np.asarray(want) != 0)


# ---------------------------------------------------------------------------
# the pipeline's baselines against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["sparsegpt", "dsnot"])
def test_prune_matches_reference(pair, refs, method):
    flips = check_prune(pair, refs, method)
    print(f"tiny_moe {method}: {flips} near-tie flips")


def test_lora_adapter_shapes_are_the_references(pair):
    """The routed experts' 4-D leaves are one (L, E·d·f) matrix each; the
    shared experts and the dense MLP are per layer (their 3-D leaves)."""
    shapes = adapter_shapes(pair)
    cfg = pair["cfg"]
    L, E, d = cfg.num_layers - cfg.moe_first_dense, cfg.moe_num_experts, cfg.d_model
    f = pair["params"]["moe_blocks"]["moe"]["experts"]["w_up"].shape[-1]
    assert shapes["moe_blocks/moe/experts/w_up"] == ((L, 8), (8, E * d * f))
    assert shapes["moe_blocks/moe/shared/w_up"][0] == (L, d, 8)
    assert shapes["dense_blocks/mlp/w_up"][0] == (cfg.moe_first_dense, d, 8)


def test_finetune_masks_matches_reference(pair, refs, ref_mt):
    masks = check_mask_tuning(pair, refs, ref_mt)
    experts = masks["moe_blocks"]["moe"]["experts"]["w_up"]
    assert not torch.equal(experts, refs["wanda"]["masks"]["moe_blocks"]["moe"]["experts"]["w_up"])
    assert bool(masks["moe_blocks"]["moe"]["router"]["w"].all())


def test_mask_scores_start_from_one_maximum_per_leaf(pair, refs):
    """With no epoch the scores are their start: |W| over the leaf's largest
    |W|, over all its experts, plus the bonus on the init mask's slots."""
    scores = {}
    MT.finetune_masks(pair["model"], pair["params"], refs["wanda"]["masks"], SPARSITY,
                      pair["calib"][:8], MT.EBFTConfig(lr=2e-2, epochs=0), scores_out=scores)
    i = pair["cfg"].moe_first_dense
    w = pair["params"]["moe_blocks"]["moe"]["experts"]["w_gate"][0].abs()
    m = refs["wanda"]["masks"]["moe_blocks"]["moe"]["experts"]["w_gate"][0]
    torch.testing.assert_close(scores[(i, "moe", "experts", "w_gate")],
                               w / w.max() + 0.1 * m.float(), rtol=0, atol=0)


def test_finetune_lora_matches_reference(pair, refs, ref_lr):
    check_lora(pair, refs, ref_lr)


def test_ebft_run_baselines_match_reference(pair, refs, ref_mt, ref_lr, monkeypatch):
    res = check_driver(pair, refs, ref_mt, ref_lr, monkeypatch)
    assert [r.kind for r in res.reports] == ["dense", "moe", "moe"]
    for path, m in T.leaves_with_path(res.baselines["dsnot"]["masks"]):
        if path[-1] == "w" and "router" in path:
            assert bool(m.all())
