"""The port's SparseGPT, DSnoT and FLAP against the JAX reference, on the
CPU, on the same seeded numpy inputs.

Stated tolerances: masks equal the reference's; a slot may flip only where
its score lies within 1e-6 (relative) of its comparison group's threshold
(the statistics and the lazy-batch SparseGPT take their f32 sums in
another order); SparseGPT's updated weights within rel 1e-4 of the
reference's (in norm, per leaf); DSnoT's reselection bit for bit on the
same inputs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import masks as RMASKS
from repro.core.pruning import common as RC
from repro.core.pruning import dsnot as RDSNOT
from repro.core.pruning import flap as RFLAP
from repro.core.pruning import sparsegpt as RSGPT
from repro.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set
from repro.models.model import build as ref_build
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import masks as MASKS
from repro_torch.core.pruning import common as C
from repro_torch.core.pruning import dsnot as DSNOT
from repro_torch.core.pruning import flap as FLAP
from repro_torch.core.pruning import sparsegpt as SGPT
from repro_torch.models.model import build
from repro_torch.sparsity import sparse_params as SP

from _torch_threads import one_thread_module  # noqa: F401

TIE_RTOL = 1e-6
W_RTOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gram(rng, T_, R):
    x = rng.normal(size=(T_, R)).astype(np.float32) * rng.uniform(0.2, 3.0, size=R)
    return x, (x.T @ x).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# SparseGPT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sparsity,pattern", [(0.5, None), (0.7, None), (0.5, (2, 4))])
def test_prune_matrix_matches_reference(sparsity, pattern):
    """R = 256: two 128-row blocks, so the lazy-batch update of the rows
    past a block runs. Masks equal, weights within rel 1e-4."""
    rng = np.random.default_rng(7)
    R, O = 256, 48
    _, H = _gram(rng, 512, R)
    W = rng.normal(size=(R, O)).astype(np.float32)
    rw, rm = RSGPT.prune_matrix(jnp.asarray(W), jnp.asarray(H), sparsity, pattern)
    scores = torch.empty(R, O)
    pw, pm = SGPT.prune_matrix(torch.tensor(W), torch.tensor(H), sparsity, pattern,
                               scores_out=scores)
    assert pm.dtype == torch.bool and pw.dtype == torch.float32
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm) != 0)
    assert _rel(pw.numpy(), rw) <= W_RTOL
    assert bool((pw[~pm] == 0).all())
    # each block of each column keeps its share (or N of every M)
    if pattern is None:
        kept = pm.reshape(2, 128, O).sum(dim=1)
        assert bool((kept == max(1, round(128 * (1 - sparsity)))).all())
    else:
        assert bool((pm.reshape(R // 4, 4, O).sum(dim=1) == 2).all())


def test_hinv_upper_matches_reference():
    rng = np.random.default_rng(3)
    _, H = _gram(rng, 200, 64)
    U = SGPT._hinv_upper(torch.tensor(H))
    np.testing.assert_allclose(U.numpy(), np.asarray(RSGPT._hinv_upper(jnp.asarray(H))),
                               rtol=1e-4, atol=1e-6 * float(np.abs(U.numpy()).max()))
    assert bool((torch.tril(U, -1) == 0).all())


def test_hinv_upper_raises_where_the_reference_gets_nan():
    """A matrix that is not positive definite after damping: the reference's
    Cholesky returns NaN, the port's raises; no retry hides it."""
    H = -np.eye(8, dtype=np.float32)
    assert bool(jnp.isnan(RSGPT._hinv_upper(jnp.asarray(H))).any())
    with pytest.raises(torch.linalg.LinAlgError):
        SGPT._hinv_upper(torch.tensor(H))


def _outlier_stats(seed, R=256, T_=512, microbatches=4, n_out=3, mag=1e3):
    """Both packages' statistics of the same microbatches of activations
    with a few outlier channels (about ``mag`` times the rest, with a 5%
    spread), as a pretrained model's block inputs have them."""
    rng = np.random.default_rng(seed)
    ch = rng.choice(R, n_out, replace=False)
    ref_st = port_st = None
    for _ in range(microbatches):
        x = rng.normal(size=(T_, R)).astype(np.float32)
        x[:, ch] = (mag * (1 + 0.05 * rng.normal(size=(T_, n_out)))).astype(np.float32)
        ref_st = RC._merge(ref_st, RC._acc_stats(jnp.asarray(x), True))
        port_st = C._merge(port_st, C._acc_stats(torch.tensor(x), True))
    return rng, ref_st, port_st


def test_sparsegpt_on_outlier_channels_matches_reference():
    """The port sums the Gram in f64, the reference in f32. On activations
    with outlier channels the two Grams agree within rel 1e-6, the
    reference stays finite, and SparseGPT from each Gram gives the same
    masks and weights within rel 1e-4."""
    rng, ref_st, port_st = _outlier_stats(11)
    Hr, Hp = np.asarray(ref_st.hessian), port_st.hessian
    assert Hp.dtype == torch.float64
    assert _rel(Hp.numpy(), Hr) <= 1e-6
    W = rng.normal(size=(256, 48)).astype(np.float32)
    rw, rm = RSGPT.prune_matrix(jnp.asarray(W), jnp.asarray(Hr), 0.7)
    assert bool(np.isfinite(np.asarray(rw)).all())
    pw, pm = SGPT.prune_matrix(torch.tensor(W), Hp, 0.7)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm) != 0)
    assert _rel(pw.numpy(), rw) <= W_RTOL


def test_gram_past_the_damping_gives_nan_in_the_reference_and_raises_in_the_port():
    """A Gram whose smallest eigenvalue lies about 3.2 times the damping
    below 0, as an f32 sum of a pretrained Llama-width block's inputs left
    it on the card (PERF.md): the outlier-channel Gram moved along its
    smallest eigenvector. The reference's f32 steps give NaN; the port's
    raise."""
    _, ref_st, _ = _outlier_stats(11)
    H = np.asarray(ref_st.hessian, np.float64)
    ev, V = np.linalg.eigh(H)
    damp = 0.01 * float(np.mean(np.diag(H)))
    bad = (H - 3.2 * damp * np.outer(V[:, 0], V[:, 0])).astype(np.float32)
    assert np.linalg.eigvalsh(bad.astype(np.float64))[0] < -2 * damp
    assert bool(jnp.isnan(RSGPT._hinv_upper(jnp.asarray(bad))).any())
    with pytest.raises(torch.linalg.LinAlgError):
        SGPT._hinv_upper(torch.tensor(bad))


def test_leaf_prune_without_a_gram_is_wanda():
    rng = np.random.default_rng(0)
    leaf = torch.tensor(rng.normal(size=(16, 2, 4)).astype(np.float32))
    st = C.LeafStats(4.0, torch.ones(16), torch.tensor(rng.uniform(1, 2, 16).astype(np.float32)))
    nw, mk = SGPT.leaf_prune("wq", leaf, st, 0.5)
    mat = SP.to_matrix("wq", leaf)[0]
    want = SP.topk_mask_rows(mat.abs() * st.col_norm[:, None], 0.5)
    assert torch.equal(SP.to_matrix("wq", mk)[0], want)
    assert torch.equal(nw, leaf * mk)


# ---------------------------------------------------------------------------
# DSnoT
# ---------------------------------------------------------------------------
def _dsnot_case(seed, R=64, O=24, keep=0.4):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(R, O)).astype(np.float32)
    mean = rng.normal(size=R).astype(np.float32)
    norm = rng.uniform(0.5, 2.0, size=R).astype(np.float32)
    mask = rng.random((R, O)) < keep
    return W, mask, mean, norm


@pytest.mark.parametrize("pattern", [None, (2, 4)])
def test_reselect_matches_reference_bit_for_bit(pattern):
    W, mask, mean, norm = _dsnot_case(1)
    if pattern is not None:
        mask = SP.nm_mask(torch.tensor(np.random.default_rng(2).random(W.shape)), 2, 4).numpy()
    # a column with no pruned slot (all gains -1e30: ties everywhere) and
    # one with no kept slot
    mask[:, 0] = True
    mask[:, 1] = False
    ref = np.asarray(RDSNOT.reselect(jnp.asarray(W), jnp.asarray(mask, jnp.float32),
                                     jnp.asarray(mean), jnp.asarray(norm), 30, pattern)) != 0
    got = DSNOT.reselect(torch.tensor(W), torch.tensor(mask), torch.tensor(mean),
                         torch.tensor(norm), 30, pattern)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not np.array_equal(ref, mask)  # some swaps happened
    # a swap keeps each column's count (and, under N:M, each group's)
    np.testing.assert_array_equal(got.numpy().sum(0), mask.sum(0))
    if pattern is not None:
        assert bool((got[:, 2:].reshape(-1, 4, W.shape[1] - 2).sum(dim=1) == 2).all())
    E0 = DSNOT.expected_error(torch.tensor(W, dtype=torch.float64), torch.tensor(mask),
                              torch.tensor(mean, dtype=torch.float64)).abs()
    E1 = DSNOT.expected_error(torch.tensor(W, dtype=torch.float64), got,
                              torch.tensor(mean, dtype=torch.float64)).abs()
    assert bool((E1 <= E0 + 1e-5).all()) and float(E1.sum()) < float(E0.sum())


def test_argmax_and_argmin_take_the_first_of_ties():
    """DSnoT relies on it: a column of equal gains grows its first slot."""
    t = torch.tensor([[-1e30, 3.0], [-1e30, 3.0], [-1e30, 1.0]])
    assert torch.argmax(t, dim=0).tolist() == [0, 0] == \
        np.asarray(jnp.argmax(jnp.asarray(t.numpy()), axis=0)).tolist()
    assert torch.argmin(-t, dim=0).tolist() == [0, 0]


# ---------------------------------------------------------------------------
# FLAP
# ---------------------------------------------------------------------------
def test_standardize_is_the_population_std():
    x = np.random.default_rng(0).normal(size=37).astype(np.float32)
    np.testing.assert_allclose(FLAP._standardize(torch.tensor(x)).numpy(),
                               np.asarray(RFLAP._standardize(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-6)


def test_global_threshold_keeps_ties_and_a_unit_per_block():
    scores = [{"heads": torch.tensor([1.0, 2.0, 2.0, 3.0]), "channels": torch.tensor([5.0, 5.0])},
              {"heads": torch.tensor([0.0, 0.0, 0.0, 1.0]), "channels": torch.tensor([1.0, 9.0])}]
    ref = RFLAP.global_structured_masks(
        [{k: jnp.asarray(v.numpy()) for k, v in s.items()} for s in scores], 0.6)
    got = FLAP.global_structured_masks(scores, 0.6)
    for r, g in zip(ref, got):
        for k in r:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]) != 0)
    assert bool(got[0]["channels"].any())  # a block that lost every channel keeps one


# ---------------------------------------------------------------------------
# the drivers on tiny_dense
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def setup(request):
    """tiny_dense with the reference's init (num_kv_heads 4: MHA; 2: GQA),
    and the same weights in the port."""
    kv = request.param
    cfg = ref_get_config("tiny_dense").replace(num_kv_heads=kv)
    ref_model = ref_build(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(3))
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib = calibration_set(corpus, 16, 64)
    params = interop.params_to_torch(_np(ref_params), "cpu")
    return ref_model, ref_params, build(get_config("tiny_dense").replace(num_kv_heads=kv)), \
        params, calib


def _prunable(masks):
    return {p: m for p, m in T.leaves_with_path(masks) if p[-1] in SP.PRUNABLE_NAMES}


def _flips(port_masks, ref_masks, gap_fn=None):
    """Slots that differ from the reference, each within TIE_RTOL of its
    threshold (``gap_fn(block, path)`` -> the (R, O) relative gaps)."""
    ref = _prunable(interop.masks_to_torch(_np(ref_masks), "cpu"))
    port = _prunable(port_masks)
    assert ref.keys() == port.keys()
    flips = 0
    for path, m in port.items():
        diff = m != ref[path]
        for i in range(m.shape[0]):
            d = diff[i]
            if d.any():
                assert gap_fn is not None, f"{path} block {i}: {int(d.sum())} slots differ"
                gaps = gap_fn(i, path)
                assert float(gaps[SP.to_matrix(path[-1], d)[0]].max()) <= TIE_RTOL, (path, i)
                flips += int(d.sum())
    return flips


@pytest.mark.parametrize("sparsity,pattern", [(0.5, None), (0.7, None), (0.5, (2, 4))])
def test_sparsegpt_prune_matches_reference(setup, sparsity, pattern):
    ref_model, ref_params, model, params, calib = setup
    ref_masks, ref_pruned = RMASKS.prune(ref_model, ref_params, calib, method="sparsegpt",
                                         sparsity=sparsity, pattern=pattern)
    scores = {}
    masks, pruned = MASKS.prune(model, params, calib, method="sparsegpt", sparsity=sparsity,
                                pattern=pattern, scores_out=scores)
    # every tiny leaf has R <= 128: one block, so the group is the column
    _flips(masks, ref_masks,
           lambda i, p: SP.threshold_gaps(scores[(i, *p[1:])], sparsity, pattern))
    for path, w in T.leaves_with_path(pruned):
        assert _rel(w.numpy(), T.get_path(_np(ref_pruned), path)) <= W_RTOL, path
        if path[-1] in SP.PRUNABLE_NAMES:
            assert bool((w[~T.get_path(masks, path)] == 0).all())
    assert set(scores) == {(i, *p[1:]) for p in _prunable(masks) for i in range(2)}


@pytest.mark.parametrize("init,pattern", [("wanda", None), ("sparsegpt", None),
                                          ("wanda", (2, 4))])
def test_dsnot_prune_matches_reference(setup, init, pattern):
    ref_model, ref_params, model, params, calib = setup
    ref_masks, ref_pruned = RMASKS.prune(ref_model, ref_params, calib, method="dsnot",
                                         sparsity=0.6 if pattern is None else 0.5,
                                         pattern=pattern, dsnot_init=init)
    errs = {}
    masks, pruned = MASKS.prune(model, params, calib, method="dsnot",
                                sparsity=0.6 if pattern is None else 0.5, pattern=pattern,
                                dsnot_init=init, scores_out=errs)
    _flips(masks, ref_masks)
    for path, w in T.leaves_with_path(pruned):
        np.testing.assert_array_equal(w.numpy(), T.get_path(_np(ref_pruned), path))
    init_masks, _ = MASKS.prune(model, params, calib, method=init,
                                sparsity=0.6 if pattern is None else 0.5, pattern=pattern)
    for path, m in _prunable(masks).items():  # a swap keeps each column's count
        a = SP.to_matrix_stacked(path[-1], m)[0].sum(dim=-2)
        b = SP.to_matrix_stacked(path[-1], T.get_path(init_masks, path))[0].sum(dim=-2)
        assert torch.equal(a, b), path
    for before, after, scale in errs.values():  # |E| of no column grew
        assert bool((after <= before + 1e-6 * scale).all())
        assert float(after.sum()) < float(before.sum())


def test_flap_prune_matches_reference(setup):
    ref_model, ref_params, model, params, calib = setup
    ref_masks, ref_pruned = RMASKS.prune(ref_model, ref_params, calib, method="flap",
                                         sparsity=0.3)
    scores = {}
    masks, pruned = MASKS.prune(model, params, calib, method="flap", sparsity=0.3,
                                scores_out=scores)
    _flips(masks, ref_masks)
    for path, w in T.leaves_with_path(pruned):
        np.testing.assert_array_equal(w.numpy(), T.get_path(_np(ref_pruned), path))
    H, kv = model.cfg.num_heads, model.cfg.num_kv_heads
    for i in range(model.num_blocks):
        mb = model.get_block(masks, i)
        heads = mb["attn"]["wo"][:, 0, 0]
        assert torch.equal(mb["attn"]["wq"][0, :, 0], heads)
        for name in ("wk", "wv"):  # MHA: with their head; GQA: kept
            kvm = mb["attn"][name]
            assert torch.equal(kvm[0, :, 0], heads) if kv == H else bool(kvm.all())
        assert 1 <= int(heads.sum()) and 1 <= int(mb["mlp"]["w_down"][:, 0].sum())
    assert set(scores) == {(i, k) for i in range(2) for k in ("heads", "channels")}
    assert FLAP.remaining_param_fraction(masks, params) == pytest.approx(
        RFLAP.remaining_param_fraction(ref_masks, ref_params), abs=1e-6)


def test_flap_unit_scores_match_reference(setup):
    ref_model, ref_params, model, params, calib = setup
    h = np.random.default_rng(0).normal(size=(2, 32, model.cfg.d_model)).astype(np.float32)
    pos = np.arange(32)[None, :]
    rbp = ref_model.get_block(ref_params, 1)
    rstats = RC.collect_block_stats(ref_model, rbp, 1, [jnp.asarray(h)], [jnp.asarray(pos)],
                                    [{}])
    bp = model.get_block(params, 1)
    stats = C.collect_block_stats(model, bp, 1, [torch.tensor(h)], [torch.tensor(pos)])
    ref = RFLAP.block_unit_scores(rbp, rstats, ref_model.cfg)
    got = FLAP.block_unit_scores(bp, stats, model.cfg)
    assert got.keys() == ref.keys() == {"heads", "channels"}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4)
    np.testing.assert_allclose(stats["wo"].fluctuation.numpy(),
                               np.asarray(rstats["wo"].fluctuation), rtol=1e-4, atol=1e-4)


def test_block_stats_gram_matches_reference(setup):
    ref_model, ref_params, model, params, _ = setup
    h = np.random.default_rng(1).normal(size=(2, 16, model.cfg.d_model)).astype(np.float32)
    pos = np.arange(16)[None, :]
    rstats = RC.collect_block_stats(ref_model, ref_model.get_block(ref_params, 0), 0,
                                    [jnp.asarray(h)] * 2, [jnp.asarray(pos)] * 2, [{}, {}],
                                    want_hessian=True)
    stats = C.collect_block_stats(model, model.get_block(params, 0), 0, [torch.tensor(h)] * 2,
                                  [torch.tensor(pos)] * 2, want_hessian=True)
    for key in ("wq", "w_down"):
        np.testing.assert_allclose(stats[key].hessian.numpy(), np.asarray(rstats[key].hessian),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(stats[key].mean.numpy(), np.asarray(rstats[key].mean),
                                   rtol=1e-5, atol=1e-6)
        assert stats[key].n == rstats[key].n == 64
    names = sorted(n for n, _ in C.iter_prunable(model.get_block(params, 0)))
    assert names == sorted(n for n, _ in RC.iter_prunable(ref_model.get_block(ref_params, 0)))
    assert len(names) == 7
    assert C.lookup_tap(stats, ("attn", "wq")) is stats["wq"]
