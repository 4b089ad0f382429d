"""The port's pruning against the JAX reference on tiny_dense, on the CPU.

Masks must equal the reference's exactly. The calibration statistics are
f32 sums taken in another order on each side, so a score that sits on its
comparison group's threshold may land on the other side of it: such a
flip is reported, and passes only when the slot's score lies within 1e-6
(relative) of its group's threshold.
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
from repro.core.pruning import wanda as RWANDA
from repro.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set
from repro.models.model import build as ref_build
from repro.sparsity import sparse_params as RSP
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import masks as MASKS
from repro_torch.core.pruning import common as C
from repro_torch.core.pruning import wanda as WANDA
from repro_torch.models.model import build
from repro_torch.sparsity import sparse_params as SP

from _torch_threads import one_thread_module  # noqa: F401

TIE_RTOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    cfg = ref_get_config("tiny_dense")
    ref_model = ref_build(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(3))
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib = calibration_set(corpus, 16, 64)
    params = interop.params_to_torch(jax.tree.map(np.asarray, ref_params), "cpu")
    return ref_model, ref_params, build(get_config("tiny_dense")), params, calib


def _prunable_masks(masks):
    return {path: m for path, m in T.leaves_with_path(masks)
            if path[-1] in SP.PRUNABLE_NAMES}


def _compare(port_masks, ref_masks, scores=None, sparsity=None, pattern=None):
    """Exact equality, bar flips within TIE_RTOL of their threshold.
    Returns the number of flipped slots."""
    ref = _prunable_masks(interop.masks_to_torch(jax.tree.map(np.asarray, ref_masks), "cpu"))
    port = _prunable_masks(port_masks)
    assert ref.keys() == port.keys()
    flips = 0
    for path, m in port.items():
        diff = m != ref[path]
        n = int(diff.sum())
        if n == 0:
            continue
        assert scores is not None, f"{path}: {n} slots differ"
        L = m.shape[0]
        for i in range(L):
            d = diff[i].reshape(scores[(i, *path[1:])].shape)
            if d.any():
                gaps = SP.threshold_gaps(scores[(i, *path[1:])], sparsity, pattern)[d]
                assert float(gaps.max()) <= TIE_RTOL, (path, i, float(gaps.max()))
        flips += n
    return flips


@pytest.mark.parametrize("sparsity,pattern", [(0.5, None), (0.7, None), (0.5, (2, 4))])
def test_wanda_masks_match_reference(setup, sparsity, pattern):
    ref_model, ref_params, model, params, calib = setup
    ref_masks, ref_pruned = RMASKS.prune(ref_model, ref_params, calib, method="wanda",
                                         sparsity=sparsity, pattern=pattern)
    scores = {}
    masks, pruned = MASKS.prune(model, params, calib, method="wanda", sparsity=sparsity,
                                pattern=pattern, scores_out=scores)
    flips = _compare(masks, ref_masks, scores, sparsity, pattern)
    print(f"wanda s={sparsity} pattern={pattern}: {flips} near-tie flips")
    assert abs(SP.sparsity_of(masks, params) - RSP.sparsity_of(ref_masks, ref_params)) < 1e-3
    # pruned weights are exactly the masked weights (zeros at pruned slots)
    for path, m in _prunable_masks(masks).items():
        w = T.get_path(pruned, path)
        assert bool((w[~m] == 0).all())
        torch.testing.assert_close(w[m], T.get_path(params, path)[m], rtol=0, atol=0)


@pytest.mark.parametrize("sparsity,pattern", [(0.5, None), (0.6, None), (0.5, (2, 4)),
                                              (0.5, (4, 8))])
def test_magnitude_masks_match_reference_exactly(setup, sparsity, pattern):
    ref_model, ref_params, model, params, _ = setup
    ref_masks, ref_pruned = RMASKS.prune(ref_model, ref_params, None, method="magnitude",
                                         sparsity=sparsity, pattern=pattern)
    masks, pruned = MASKS.prune(model, params, None, method="magnitude", sparsity=sparsity,
                                pattern=pattern)
    assert _compare(masks, ref_masks) == 0
    for path, w in T.leaves_with_path(pruned):
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(T.get_path(ref_pruned, path)))


def test_wanda_leaf_mask_from_reference_stats(setup):
    """The reference's LeafStats fed straight into the port's leaf_mask
    give the reference's masks bit for bit (no summation in between)."""
    ref_model, ref_params, _, params, calib = setup
    batches = RC._make_batches(ref_model.cfg, calib, None, 8)
    h_mb, pos_mb = zip(*(ref_model.embed_tokens(ref_params, b) for b in batches))
    bp = ref_model.get_block(ref_params, 0)
    stats = RC.collect_block_stats(ref_model, bp, 0, list(h_mb), list(pos_mb),
                                   [{}] * len(h_mb))
    for path, leaf in RC.iter_prunable(bp):
        st = RC.stats_for_leaf(stats, path)
        port_st = C.LeafStats(st.n, torch.tensor(np.asarray(st.sum)),
                              torch.tensor(np.asarray(st.sumsq)))
        for sparsity, pattern in ((0.5, None), (0.5, (2, 4))):
            ref = np.asarray(RWANDA.leaf_mask(path[-1], leaf, st, sparsity, pattern)) > 0
            port = WANDA.leaf_mask(path[-1], torch.tensor(np.asarray(leaf)), port_st,
                                   sparsity, pattern)
            np.testing.assert_array_equal(port.numpy(), ref, err_msg=str(path))


def test_collect_block_stats_matches_reference(setup):
    ref_model, ref_params, model, params, calib = setup
    batches = RC._make_batches(ref_model.cfg, calib, None, 8)
    h_mb, pos_mb = zip(*(ref_model.embed_tokens(ref_params, b) for b in batches))
    ref = RC.collect_block_stats(ref_model, ref_model.get_block(ref_params, 0), 0,
                                 list(h_mb), list(pos_mb), [{}] * len(h_mb))
    pb = C._make_batches(calib, 8, "cpu")
    ph, pp = zip(*(model.embed_tokens(params, b) for b in pb))
    port = C.collect_block_stats(model, model.get_block(params, 0), 0, list(ph), list(pp))
    assert port.keys() == ref.keys()
    for k, st in ref.items():
        assert port[k].n == st.n
        np.testing.assert_allclose(port[k].sumsq.numpy(), np.asarray(st.sumsq), rtol=1e-5)
        np.testing.assert_allclose(port[k].sum.numpy(), np.asarray(st.sum), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("kind", ["rows", "nm", "global"])
def test_forced_ties_rank_as_the_reference(kind):
    """Integer scores with many ties: the stable argsort (and the >=
    threshold of the global mask) must pick the same slots as jnp."""
    rng = np.random.default_rng(12)
    scores = rng.integers(0, 4, size=(2, 16, 12)).astype(np.float32)
    s_t, s_j = torch.tensor(scores), jnp.asarray(scores)
    if kind == "rows":
        port, ref = SP.topk_mask_rows(s_t, 0.5), RSP.topk_mask_rows(s_j, 0.5)
    elif kind == "nm":
        port, ref = SP.nm_mask(s_t, 2, 4), RSP.nm_mask(s_j, 2, 4)
    else:
        port, ref = SP.global_topk_mask(s_t, 0.5), RSP.global_topk_mask(s_j, 0.5)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref) > 0)


def test_threshold_gaps_mark_the_boundary():
    scores = torch.tensor([[4.0], [3.0], [2.0], [1.0]])
    gaps = SP.threshold_gaps(scores, 0.5)  # keeps 2: threshold 3.0
    torch.testing.assert_close(gaps[:, 0], torch.tensor([1 / 3, 0.0, 1 / 3, 2 / 3]))
    gaps = SP.threshold_gaps(scores, 0.5, (1, 2))  # groups (4, 3), (2, 1)
    torch.testing.assert_close(gaps[:, 0], torch.tensor([0.0, 0.25, 0.0, 0.5]))


@pytest.mark.parametrize("pattern", [None, (2, 4)])
def test_thresholds_bound_the_slots_that_flip(pattern):
    """The threshold is the lowest kept score of each group; a slot kept
    under one set of scores and dropped under another lies no farther from
    the first threshold than the scores and thresholds moved."""
    rng = np.random.default_rng(3)
    s_a = torch.tensor(np.abs(rng.standard_normal((2, 64, 48))), dtype=torch.float64)
    s_b = s_a * torch.tensor(1 + 3e-2 * rng.standard_normal(s_a.shape))

    def mask(s):
        return SP.topk_mask_rows(s, 0.7) if pattern is None else SP.nm_mask(s, *pattern)

    m_a, m_b = mask(s_a), mask(s_b)
    t_a, t_b = SP.thresholds(s_a, 0.7, pattern), SP.thresholds(s_b, 0.7, pattern)
    assert t_a.shape == s_a.shape
    assert bool(((s_a >= t_a) == m_a).all())  # no ties: kept <=> at or above
    flip = m_a != m_b
    assert bool(flip.any())
    lhs = (s_a - t_a).abs()[flip]
    rhs = ((s_a - s_b).abs() + (t_a - t_b).abs())[flip]
    assert bool((lhs <= rhs).all())


def test_to_matrix_views_match_reference(setup):
    _, ref_params, _, params, _ = setup
    for name, sub in (("wq", "attn"), ("wo", "attn"), ("w_down", "mlp")):
        leaf = params["blocks"][sub][name]
        ref_leaf = ref_params["blocks"][sub][name]
        mat, tag = SP.to_matrix_stacked(name, leaf)
        ref_mat, _ = RSP.to_matrix_stacked(name, ref_leaf)
        np.testing.assert_array_equal(mat.numpy(), np.asarray(ref_mat))
        assert torch.equal(SP.from_matrix(mat, tag), leaf)
        one, tag1 = SP.to_matrix(name, leaf[0])
        np.testing.assert_array_equal(one.numpy(), np.asarray(RSP.to_matrix(name, ref_leaf[0])[0]))


def test_ones_and_expand_masks(setup):
    _, _, _, params, _ = setup
    ones = SP.ones_masks(params)
    assert ones["embed"]["tok"].dim() == 0 and ones["blocks"]["attn"]["wq"].shape == \
        params["blocks"]["attn"]["wq"].shape
    full = MASKS.expand_masks(params, ones)
    for path, m in T.leaves_with_path(full):
        assert m.shape == T.get_path(params, path).shape and bool(m.all())
    assert SP.sparsity_of(full, params) == 0.0
    applied = SP.apply_masks(params, ones)
    for path, w in T.leaves_with_path(applied):
        assert torch.equal(w, T.get_path(params, path))


def test_map_prunable_touches_only_prunable_leaves(setup):
    _, _, _, params, _ = setup
    out = SP.map_prunable(lambda name, leaf, m: (name, leaf.shape == m.shape), params,
                          SP.ones_masks(params))
    for path, leaf in T.leaves_with_path(params):
        got = T.get_path(out, path)
        if path[-1] in SP.PRUNABLE_NAMES:
            assert got == (path[-1], True)
        else:
            assert got is leaf


def test_unported_methods_raise(setup):
    """Every method of the reference is ported; a method that neither
    package has raises ValueError."""
    _, _, model, params, calib = setup
    with pytest.raises(ValueError, match="unknown pruning method 'obs'"):
        MASKS.prune(model, params, calib, method="obs")
    assert MASKS.METHODS == ("magnitude", "wanda", "sparsegpt", "dsnot", "flap")
