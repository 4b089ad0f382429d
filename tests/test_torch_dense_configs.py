"""The dense family's other four configurations (Qwen1.5-4B, Nemotron-4-15B,
Qwen2.5-32B, Qwen1.5-110B) in the port against the JAX reference, on the
CPU, at their SMOKE sizes (2 layers, d 64, 4 heads): the configs field by
field, then forward and loss, Wanda's masks, EBFT and the perplexities.
Together they hold what Llama-7B does not use: QKV biases (the Qwens),
GQA (Nemotron and Qwen2.5/1.5-110B, 4 heads over 2 KV heads), the
squared-ReLU MLP and LayerNorm with its bias (Nemotron), and
``rope_theta`` 1e6. The weights are the reference's ``init``, carried
across with ``interop.params_to_torch``.

Stated tolerances (f32, sums taken in another order on each side):
- logits and loss: rel 1e-5;
- Wanda masks: equal, bar slots whose score lies within 1e-6 (relative)
  of its column's threshold;
- EBFT's per-block losses and the perplexities: rel 1e-4.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import ebft as REBFT
from repro.core.evaluate import perplexity as ref_perplexity
from repro.core.masks import prune as ref_prune
from repro.data import tokens as RTOK
from repro.models.model import build as ref_build
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import ebft as EBFT
from repro_torch.core.evaluate import perplexity
from repro_torch.core.masks import expand_masks, prune
from repro_torch.models.model import build
from repro_torch.sparsity import sparse_params as SP

ARCHS = ["qwen1_5_4b", "nemotron_4_15b", "qwen2_5_32b", "qwen1_5_110b"]
REL = 1e-5
PIPE_REL = 1e-4
TIE_RTOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=REL):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(got.detach().double().numpy(), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke)) == \
        dataclasses.asdict(ref_get_config(arch, smoke))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    rmodel = ref_build(rcfg)
    rparams = jax.jit(rmodel.init)(jax.random.PRNGKey(0))
    # the reference inits biases and LayerNorm's shift at 0: move them, so
    # that the comparison reaches them
    rng = np.random.default_rng(1)
    moved = {"bq", "bk", "bv", "b"}
    rparams = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if getattr(p[-1], "key", None) in moved else a, rparams)
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    return dict(arch=arch, cfg=cfg, rmodel=rmodel, rparams=rparams, model=build(cfg),
                params=interop.params_to_torch(_np(rparams), "cpu"),
                calib=RTOK.calibration_set(corpus, 16, 32), ev=RTOK.eval_set(corpus, 16, 32))


def test_what_each_config_holds(pair):
    """The features each one brings, as the port's tree carries them."""
    cfg, params = pair["cfg"], pair["params"]
    attn, ln = params["blocks"]["attn"], params["blocks"]["ln1"]
    assert ("bq" in attn) == cfg.qkv_bias == pair["arch"].startswith("qwen")
    assert ("b" in ln) == (cfg.norm == "layernorm") == (pair["arch"] == "nemotron_4_15b")
    assert ("w_gate" in params["blocks"]["mlp"]) == (cfg.mlp_act == "swiglu")
    assert attn["wk"].shape[-2] == cfg.num_kv_heads
    own = pair["model"].init(torch.Generator().manual_seed(0))
    assert sorted((p, t.shape) for p, t in T.leaves_with_path(own)) == \
        sorted((p, t.shape) for p, t in T.leaves_with_path(params))


def test_forward_and_loss_match_reference(pair):
    toks = np.random.default_rng(2).integers(0, pair["cfg"].vocab_size, (2, 40)).astype(np.int32)
    loss, m = pair["model"].loss(pair["params"], {"tokens": torch.as_tensor(toks)})
    rloss, rlogits = jax.jit(lambda p, t: (pair["rmodel"].loss(p, {"tokens": t})[0],
                                           pair["rmodel"].forward(p, {"tokens": t})))(
        pair["rparams"], toks)
    _close(loss, rloss)
    assert set(m) == {"nll"}
    _close(pair["model"].forward(pair["params"], {"tokens": torch.as_tensor(toks)}), rlogits)


def test_wanda_ebft_perplexity_match_reference(pair, one_thread):
    """Wanda 0.7 (masks bar near-ties), then EBFT from the reference's masks
    and pruned weights (each block's losses, epochs, early stop) and the
    dense, Wanda and EBFT perplexities."""
    model, params, calib, ev = pair["model"], pair["params"], pair["calib"], pair["ev"]
    scores = {}
    masks, pruned = prune(model, params, calib, method="wanda", sparsity=0.7, scores_out=scores)
    rmasks, rpruned = ref_prune(pair["rmodel"], pair["rparams"], calib, method="wanda",
                                sparsity=0.7)
    ref_masks = expand_masks(params, interop.masks_to_torch(_np(rmasks), "cpu"))
    for path, m in T.leaves_with_path(masks):
        if not SP.is_prunable(path, m):
            continue
        diff = m != T.get_path(ref_masks, path)
        for i in range(m.shape[0]):
            d = SP.to_matrix(path[-1], diff[i])[0]
            if d.any():
                gaps = SP.threshold_gaps(scores[(i, *path[1:])], 0.7)
                assert float(gaps[d].max()) <= TIE_RTOL, (path, i)
    ecfg = dict(lr=1e-2, epochs=3, microbatch=8, patience=2)
    rtuned, rreports = REBFT.finetune(pair["rmodel"], pair["rparams"], rpruned, rmasks, calib,
                                      REBFT.EBFTConfig(**ecfg))
    start = interop.params_to_torch(_np(rpruned), "cpu")
    tuned, reports = EBFT.finetune(model, params, start, ref_masks, calib,
                                   EBFT.EBFTConfig(**ecfg))
    assert len(reports) == len(rreports) == 2
    for a, b in zip(reports, rreports):
        assert (a.epochs_run, a.early_stop) == (b.epochs_run, b.early_stop), a.index
        for x, y in zip(a.history + [a.loss_before, a.loss_after],
                        b.history + [b.loss_before, b.loss_after]):
            assert x == pytest.approx(y, rel=PIPE_REL), a.index
        assert a.loss_after < a.loss_before
    got = {"dense": perplexity(model, params, ev),
           "wanda": perplexity(model, pruned, ev, masks=masks),
           "EBFT": perplexity(model, tuned, ev, masks=ref_masks)}
    want = {"dense": ref_perplexity(pair["rmodel"], pair["rparams"], ev),
            "wanda": ref_perplexity(pair["rmodel"], rpruned, ev),
            "EBFT": ref_perplexity(pair["rmodel"], rtuned, ev)}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=PIPE_REL), k
