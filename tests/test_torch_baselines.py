"""The port's baselines (mask tuning, LoRA, DSnoT through the driver), the
mask's gradient through the masked matmul, global-norm clipping and the
cloze accuracy against the JAX reference on tiny_dense, on the CPU.

Stated tolerances:
- ``clip_by_global_norm``: rel 1e-6 (the same f32 formula, leaves summed
  in another order);
- the dM plain version against ``jax.grad`` with respect to the mask: f32
  at 1e-5 (sums taken in another order); ``gradcheck`` in f64;
- ``cloze_accuracy``: equal;
- mask tuning: epoch histories within rel 1e-4; masks equal, bar slots
  whose final score lies within 1e-5 (relative) of its column's threshold
  (the scores are 20 Adam steps of f32 gradients summed in another order);
- LoRA, 5 steps from the reference's A (carried across: the port does not
  reproduce ``jax.random``): merged weights within rel 1e-4, their
  adapter deltas within rel 1e-3 (in norm, per leaf);
- the driver with ``--baselines dsnot,mask,lora``: every perplexity within
  rel 1e-4 of the reference functions called in the same order. Mask
  tuning (hard thresholds under Adam's sign-like steps) and 200 LoRA steps
  can be chaotic: the reference's own perplexity moves by up to ~5e-3 when
  its start moves by 1e-6 (relative). Their perplexities are held within
  rel 1e-4 or twice that spread, measured in the test on the reference.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import ebft as REBFT
from repro.core import lora as RLORA
from repro.core import mask_tuning as RMT
from repro.core.evaluate import cloze_accuracy as ref_cloze
from repro.core.evaluate import perplexity as ref_perplexity
from repro.core.masks import prune as ref_prune
from repro.data import tokens as RTOK
from repro.kernels.masked_matmul.ref import masked_matmul_ref
from repro.models.model import build as ref_build
from repro.optim import optimizers as ROPT
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import lora as LORA
from repro_torch.core import mask_tuning as MT
from repro_torch.core.evaluate import cloze_accuracy
from repro_torch.core.masks import expand_masks
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.kernels.masked_matmul.ref import masked_matmul_dm_plain
from repro_torch.launch import ebft_run
from repro_torch.models.model import build
from repro_torch.optim import optimizers as OPT
from repro_torch.sparsity import sparse_params as SP

from _torch_threads import one_thread_module  # noqa: F401

REL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# clip_by_global_norm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(4, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    ref, ref_gn = ROPT.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
    got, gn = OPT.clip_by_global_norm(T.tree_map(torch.tensor, tree), max_norm)
    assert float(gn) == pytest.approx(float(ref_gn), rel=1e-6)
    for path, g in T.leaves_with_path(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(T.get_path(ref, path)), rtol=1e-6)
    if max_norm > 1e2:  # below the limit: unchanged
        assert torch.equal(got["a"], torch.tensor(tree["a"]))


# ---------------------------------------------------------------------------
# the mask's gradient through the masked matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (5, 33, 7)])
def test_masked_matmul_dm_plain_equals_jax_grad(m, k, n):
    rng = np.random.default_rng(k)
    x, w = rng.normal(size=(m, k)).astype(np.float32), rng.normal(size=(k, n)).astype(np.float32)
    mask = (rng.random((k, n)) > 0.5).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    want = jax.grad(lambda mm: jnp.sum(masked_matmul_ref(jnp.asarray(x), jnp.asarray(w), mm)
                                       * dy))(jnp.asarray(mask))
    got = masked_matmul_dm_plain(torch.tensor(x), torch.tensor(dy), torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert bool((got[torch.tensor(mask) == 0] != 0).any())  # pruned slots are not zeroed
    # through the Function: a 0/1 float mask that requires grad gets dm
    tm = torch.tensor(mask).requires_grad_(True)
    out = MM.masked_matmul(torch.tensor(x), torch.tensor(w), tm)
    assert type(out.grad_fn).__name__ == "MaskedMatmulFnBackward"
    (gm,) = torch.autograd.grad(out, tm, torch.tensor(dy))
    torch.testing.assert_close(gm, got, rtol=0, atol=0)


def test_masked_matmul_gradcheck_f64_with_respect_to_the_mask():
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(6, 10)), dtype=torch.float64, requires_grad=True)
    w = torch.tensor(rng.normal(size=(10, 4)), dtype=torch.float64)
    m = torch.tensor((rng.random((10, 4)) > 0.4).astype(np.float64), requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: MM.masked_matmul(a, w, b), (x, m))
    (gm,) = torch.autograd.grad(MM.masked_matmul(x.detach(), w, m).sum(), m)
    torch.testing.assert_close(gm, (x.detach().T @ torch.ones(6, 4, dtype=torch.float64)) * w)


def test_masked_matmul_dm_validates_and_refuses():
    with pytest.raises(ValueError, match="inconsistent operand shapes"):
        MM.masked_matmul_dm(torch.zeros(4, 8), torch.zeros(3, 5), torch.zeros(8, 5))
    t = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        MM.masked_matmul_dm(t, t, t)
    before = MM.dm_launches
    MM.masked_matmul_dm(torch.zeros(2, 3), torch.zeros(2, 4), torch.ones(3, 4))
    assert MM.dm_launches == before  # the plain version is no launch
    with pytest.raises(TypeError, match="operands' dtype"):
        MM._launch_dm(torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(8, 8, dtype=torch.bool))
    bf = torch.bfloat16
    x, dy = torch.zeros(4, 16, dtype=bf), torch.zeros(4, 16, dtype=bf)
    with pytest.raises(ValueError, match="bf16 kernel takes"):  # w's row stride 20 values
        MM._launch_dm(x, dy, torch.zeros(16, 20, dtype=bf)[:, :16])
    with pytest.raises(ValueError, match="bf16 kernel takes"):  # w off 16 bytes
        MM._launch_dm(x, dy, torch.zeros(16 * 16 + 1, dtype=bf)[1:].view(16, 16))


# ---------------------------------------------------------------------------
# tiny_dense: the reference's weights and Wanda 0.7 masks in the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    cfg = ref_get_config("tiny_dense")
    ref_model = ref_build(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib = RTOK.calibration_set(corpus, 16, 32)
    ev = RTOK.eval_set(corpus, 16, 32)
    ref_masks, ref_pruned = ref_prune(ref_model, ref_params, calib, method="wanda",
                                      sparsity=0.7)
    params = interop.params_to_torch(_np(ref_params), "cpu")
    pruned = interop.params_to_torch(_np(ref_pruned), "cpu")
    masks = expand_masks(params, interop.masks_to_torch(_np(ref_masks), "cpu"))
    return dict(ref_model=ref_model, ref_params=ref_params, ref_masks=ref_masks,
                ref_pruned=ref_pruned, corpus=corpus, model=build(get_config("tiny_dense")),
                params=params, pruned=pruned, masks=masks, calib=calib, ev=ev)


def test_cloze_accuracy_matches_reference(setup):
    s = setup
    ctx, t, d = RTOK.cloze_task(s["corpus"], 20, 32)
    want = ref_cloze(s["ref_model"], s["ref_pruned"], ctx, t, d)
    got = cloze_accuracy(s["model"], s["pruned"], ctx, t, d, masks=s["masks"])
    assert got == want and 0.0 < got < 1.0
    assert cloze_accuracy(s["model"], s["params"], ctx, t, d) == \
        ref_cloze(s["ref_model"], s["ref_params"], ctx, t, d)


# ---------------------------------------------------------------------------
# mask tuning
# ---------------------------------------------------------------------------
def _ref_histories(monkeypatch):
    """Each reference block's epoch history, read where its loop hands it to
    the plateau rule (the reference only logs the first and last)."""
    seen = []
    orig = RMT.plateau_early_stop

    def spy(history, *a, **kw):
        if len(history) == 1:
            seen.append(None)
        seen[-1] = list(history)
        return orig(history, *a, **kw)

    monkeypatch.setattr(RMT, "plateau_early_stop", spy)
    return seen


def _ste_flips(port_masks, ref_masks, scores, sparsity, pattern=None, tie=1e-5):
    """Slots where the port's tuned masks differ from the reference's, each
    within ``tie`` (relative) of its group's threshold of the port's final
    scores."""
    ref = interop.masks_to_torch(_np(ref_masks), "cpu")
    flips = 0
    for path, m in T.leaves_with_path(port_masks):
        if path[-1] not in SP.PRUNABLE_NAMES:
            continue
        diff = m != T.get_path(ref, path)
        for i in range(m.shape[0]):
            d = SP.to_matrix(path[-1], diff[i])[0]
            if d.any():
                gaps = SP.threshold_gaps(scores[(i, *path[1:])], sparsity, pattern)
                assert float(gaps[d].max()) <= tie, (path, i, float(gaps[d].max()))
                flips += int(d.sum())
    return flips


@pytest.mark.parametrize("sparsity,pattern", [(0.7, None), (0.5, (2, 4))])
def test_finetune_masks_matches_reference(setup, monkeypatch, sparsity, pattern):
    s = setup
    ecfg = dict(lr=2e-2, epochs=6, microbatch=8, patience=2)
    ref_hist = _ref_histories(monkeypatch)
    ref_masks0, _ = ref_prune(s["ref_model"], s["ref_params"], s["calib"], method="wanda",
                              sparsity=sparsity, pattern=pattern)
    ref_mt, ref_masks = RMT.finetune_masks(s["ref_model"], s["ref_params"], ref_masks0,
                                           sparsity, s["calib"], REBFT.EBFTConfig(**ecfg),
                                           pattern=pattern)
    masks0 = expand_masks(s["params"], interop.masks_to_torch(_np(ref_masks0), "cpu"))
    hist, scores = [], {}
    mt, masks = MT.finetune_masks(s["model"], s["params"], masks0, sparsity, s["calib"],
                                  MT.EBFTConfig(**ecfg), pattern=pattern, histories=hist,
                                  scores_out=scores)
    assert len(hist) == len(ref_hist) == 2
    for a, b in zip(hist, ref_hist):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, rtol=REL)
    assert hist[0][-1] < hist[0][0]  # the scores moved the loss
    _ste_flips(masks, ref_masks, scores, sparsity, pattern)
    for path, w in T.leaves_with_path(mt):
        m = T.get_path(masks, path)
        dense = T.get_path(s["params"], path)
        assert torch.equal(w, dense * m)  # the weights never change
        if path[-1] in SP.PRUNABLE_NAMES:  # each column keeps its share
            mat = SP.to_matrix_stacked(path[-1], m)[0]
            if pattern is None:
                assert bool((mat.sum(-2) == max(1, round(mat.shape[-2] * (1 - sparsity)))).all())
            else:
                assert bool((mat.reshape(*mat.shape[:-2], -1, 4, mat.shape[-1]).sum(-2)
                             == 2).all())
    assert not torch.equal(masks["blocks"]["mlp"]["w_up"], masks0["blocks"]["mlp"]["w_up"])
    assert torch.equal(masks0["blocks"]["attn"]["wq"],  # init_masks not written
                       expand_masks(s["params"], interop.masks_to_torch(
                           _np(ref_masks0), "cpu"))["blocks"]["attn"]["wq"])


def test_ste_passes_the_mask_gradient_to_the_scores():
    scores = torch.tensor([[0.9, 0.1], [0.2, 0.8], [0.5, 0.4]], requires_grad=True)
    m = MT._ste(scores, "w_up", 1 / 3, None, torch.float32)
    assert m.tolist() == [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]
    (g,) = torch.autograd.grad((m * torch.arange(6.0).view(3, 2)).sum(), scores)
    assert g.tolist() == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------
def test_init_lora_shapes_match_reference(setup):
    s = setup
    lcfg = RLORA.LoRAConfig()
    ref = interop.lora_to_torch(_np(RLORA.init_lora(s["ref_pruned"], lcfg)), "cpu")
    got = LORA.init_lora(s["pruned"], LORA.LoRAConfig(), torch.Generator().manual_seed(0))
    assert sorted(p for p, _ in T.leaves_with_path(got)) == \
        sorted(p for p, _ in T.leaves_with_path(ref))
    for path, a in T.leaves_with_path(got):
        b = T.get_path(ref, path)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path[-1] == "B":
            assert bool((a == 0).all())
        else:  # N(0, 1/R)
            assert float(a.std()) == pytest.approx(1 / np.sqrt(a.shape[-2]), rel=0.3)


def test_merge_matches_reference(setup):
    s = setup
    lcfg = RLORA.LoRAConfig()
    rng = np.random.default_rng(4)
    ref_l = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
                         RLORA.init_lora(s["ref_pruned"], lcfg))
    want = RLORA.merge(s["ref_pruned"], s["ref_masks"], ref_l, lcfg)
    got = LORA.merge(s["pruned"], s["masks"], interop.lora_to_torch(_np(ref_l), "cpu"),
                     LORA.LoRAConfig())
    for path, w in T.leaves_with_path(got):
        np.testing.assert_allclose(w.numpy(), np.asarray(T.get_path(want, path)), rtol=1e-6,
                                   atol=1e-6)
        if path[-1] in SP.PRUNABLE_NAMES:
            assert bool((w[~T.get_path(s["masks"], path)] == 0).all())


def test_finetune_lora_matches_reference_from_its_init(setup):
    s = setup
    steps = 5
    rl = RLORA.LoRAConfig(steps=steps, lr=1e-3)
    it = RTOK.corpus_iterator(s["corpus"], batch=4, seq_len=32, seed=9)
    want = RLORA.finetune_lora(s["ref_model"], s["ref_pruned"], s["ref_masks"], it, rl)
    init = interop.lora_to_torch(_np(RLORA.init_lora(s["ref_pruned"], rl)), "cpu")
    losses = []
    got = LORA.finetune_lora(s["model"], s["pruned"], s["masks"],
                             RTOK.corpus_iterator(s["corpus"], batch=4, seq_len=32, seed=9),
                             LORA.LoRAConfig(steps=steps, lr=1e-3), lora=init, losses=losses)
    assert len(losses) == steps and all(np.isfinite(float(v)) for v in losses)
    moved = 0
    for path, w in T.leaves_with_path(got):
        ref_w = np.asarray(T.get_path(want, path))
        assert _rel(w.numpy(), ref_w) <= REL, path
        if path[-1] in SP.PRUNABLE_NAMES:
            base = T.get_path(s["pruned"], path).numpy()
            assert _rel(w.numpy() - base, ref_w - base) <= 1e-3, path
            assert bool((w[~T.get_path(s["masks"], path)] == 0).all())
            moved += int(not np.array_equal(w.numpy(), base))
    assert moved == 7
    assert torch.equal(init["blocks"]["mlp"]["w_up"]["B"], torch.zeros_like(
        init["blocks"]["mlp"]["w_up"]["B"]))  # the given adapters are not written


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["sparsegpt", "flap"])
def test_driver_baselines_match_reference(setup, monkeypatch, method):
    """``ebft_run.run`` with ``--baselines dsnot,mask,lora`` against the
    reference's functions called in the order its driver calls them, on the
    reference's weights; LoRA starts from the reference's A."""
    s = setup
    sp = 0.5 if method == "sparsegpt" else 0.3
    spec = ebft_run.RunSpec(seed=0, seq=32, method=method, sparsity=sp, calib_samples=16,
                            pretrain_steps=0, epochs=4, baselines="dsnot,mask,lora")
    model, params = s["ref_model"], s["ref_params"]
    corpus, ev = s["corpus"], s["ev"]
    calib = RTOK.calibration_set(corpus, spec.calib_samples, spec.seq)
    ppl = {"dense": ref_perplexity(model, params, ev)}
    masks, pruned = ref_prune(model, params, calib, method=method, sparsity=sp)
    ppl[method] = ref_perplexity(model, pruned, ev)
    tuned, _ = REBFT.finetune(model, params, pruned, masks, calib,
                              REBFT.EBFTConfig(lr=spec.lr, epochs=spec.epochs))
    ppl["EBFT"] = ref_perplexity(model, tuned, ev)
    _, ds = ref_prune(model, params, calib, method="dsnot", sparsity=sp, dsnot_init=method)
    ppl["DSnoT"] = ref_perplexity(model, ds, ev)
    lcfg = RLORA.LoRAConfig(steps=200, lr=1e-3)
    init_lora = RLORA.init_lora
    rel = {k: REL for k in ppl}
    for bump in (1.0, 1.0 + 1e-6):  # the reference, then its start moved by 1e-6
        mt, _ = RMT.finetune_masks(model, params, masks, sp, calib, bonus=0.1 * bump)
        monkeypatch.setattr(RLORA, "init_lora", lambda p, c, b=bump: jax.tree.map(
            lambda a: a * b, init_lora(p, c)))
        it = RTOK.corpus_iterator(corpus, batch=8, seq_len=spec.seq, seed=9)
        lr_ppl = ref_perplexity(model, RLORA.finetune_lora(model, pruned, masks, it, lcfg), ev)
        for k, v in (("mask-tune", ref_perplexity(model, mt, ev)), ("LoRA", lr_ppl)):
            if bump == 1.0:
                ppl[k] = v
            else:
                rel[k] = max(REL, 2 * abs(v / ppl[k] - 1))

    ref_a = interop.lora_to_torch(_np(init_lora(pruned, lcfg)), "cpu")
    monkeypatch.setattr(LORA, "init_lora", lambda *a, **k: ref_a)
    res = ebft_run.run(get_config("tiny_dense"), spec, "cpu", params=s["params"])
    assert set(res.perplexity) == set(ppl)
    for k, v in ppl.items():
        assert res.perplexity[k] == pytest.approx(v, rel=rel[k]), (k, rel[k])
    assert {"baseline_dsnot", "baseline_mask", "baseline_lora"} <= set(res.phases)
    assert len(res.baselines["lora"]["losses"]) == 200
    assert len(res.baselines["mask"]["histories"]) == model.num_blocks


def test_driver_refuses_unknown_baselines_and_methods():
    spec = ebft_run.RunSpec(pretrain_steps=0, epochs=0, baselines="dsnot,qlora")
    with pytest.raises(ValueError, match="qlora"):
        ebft_run.run(get_config("tiny_dense"), spec, "cpu")
    with pytest.raises(SystemExit):
        ebft_run.main(["--method", "obs", "--device", "cpu", "--pretrain-steps", "0"])


def test_main_prints_every_baseline(capsys, tmp_path):
    res = ebft_run.main(["--arch", "tiny_dense", "--pretrain-steps", "0", "--epochs", "1",
                         "--calib-samples", "8", "--seq", "16", "--device", "cpu",
                         "--method", "flap", "--sparsity", "0.3", "--baselines", "dsnot,mask",
                         "--bench-out", str(tmp_path / "b.json")])
    out = capsys.readouterr().out
    assert "FLAP remaining params" in out and "DSnoT ppl" in out and "mask-tune ppl" in out
    assert set(res.perplexity) == {"dense", "flap", "EBFT", "DSnoT", "mask-tune"}
