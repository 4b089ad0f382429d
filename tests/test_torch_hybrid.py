"""The port's hybrid family (Zamba2: Mamba2 blocks and one shared attention
block) against the JAX reference, on the CPU: tiny_hybrid (Zamba2-1.2B's
SMOKE: 5 Mamba layers, the shared block after every 2, so G 2, K 2 and
one trailing block; d 64, 4 heads x 16) through Wanda and magnitude, EBFT
(the shared block tuned once on the union of its two sites), perplexity,
serving and checkpoints. The weights are the reference's ``init``,
carried across with ``interop.params_to_torch``; inputs are numpy arrays
from a seed.

Stated tolerances (f32, sums taken in another order on each side):
- logits, loss, gradients, each block's output and taps: rel 1e-5;
- Wanda and magnitude masks: equal, bar Wanda flips whose score lies
  within 1e-6 (relative) of its comparison group's threshold;
- EBFT's per-block losses and the perplexities: rel 1e-4;
- served tokens: equal, token for token.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RCK
from repro.configs import get_config as ref_get_config
from repro.core import ebft as REBFT
from repro.core import reconstruction as RRECON
from repro.core.evaluate import perplexity as ref_perplexity
from repro.core.masks import prune as ref_prune
from repro.data.tokens import CorpusConfig as RCorpusConfig
from repro.data.tokens import SyntheticCorpus as RSyntheticCorpus
from repro.data.tokens import calibration_set as ref_calibration_set
from repro.data.tokens import eval_set as ref_eval_set
from repro.launch import rooflines as RROOF
from repro.models.model import build as ref_build
from repro.serving.decode import Request as RRequest
from repro.serving.decode import Server as RServer
from repro.sparsity import taps as RTAPS
from _torch_baselines import driver_matches_library, leaf_functions_match_reference
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ebft as EBFT
from repro_torch.core import reconstruction as R
from repro_torch.core.evaluate import perplexity
from repro_torch.core.masks import prune
from repro_torch.launch import ebft_run, rooflines
from repro_torch.models import hybrid as HY
from repro_torch.models.model import build
from repro_torch.serving.decode import Request, Server
from repro_torch.sparsity import sparse_params as SP
from repro_torch.sparsity import taps as TAPS
from repro_torch.training.train_loop import value_and_grad

ARCH = "tiny_hybrid"
REL = 1e-5
PIPE_REL = 1e-4
TIE_RTOL = 1e-6
SPEC = ebft_run.RunSpec(arch=ARCH, seed=0, seq=32, calib_samples=16, pretrain_steps=0,
                        epochs=3, lr=1e-2, bench_out="")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=REL):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.fixture()
def one_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    under several test workers on few cores the threads' waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    rcfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    rmodel = ref_build(rcfg)
    rparams = jax.jit(rmodel.init)(jax.random.PRNGKey(0))
    return dict(rcfg=rcfg, cfg=cfg, rmodel=rmodel, rparams=rparams, model=build(cfg),
                params=interop.params_to_torch(_np(rparams), "cpu"))


def _block_index(cfg, path, j):
    """The model's block index of slice j of a stacked leaf (``groups``:
    (G, K) flattened; ``trailing``), or the shared block's."""
    G, K, _ = HY.schedule(cfg)
    if path[0] == "shared":
        return cfg.num_layers
    return j if path[0] == "groups" else G * K + j


# ---------------------------------------------------------------------------
# configs, rooflines, the tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["zamba2_1_2b", "tiny_hybrid"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke)) == \
        dataclasses.asdict(ref_get_config(arch, smoke))


@pytest.mark.parametrize("kind,batch,seq", [("train", 8, 2048), ("ebft", 8, 2048),
                                            ("prefill", 8, 512), ("decode", 8, 1)])
def test_model_flops_match_reference(kind, batch, seq):
    shape = ShapeConfig("s", seq, batch, kind)
    want = RROOF.model_flops_per_chip(ref_get_config("zamba2_1_2b"), shape, 1)
    assert rooflines.model_flops_per_chip(get_config("zamba2_1_2b"), shape, 1) == \
        pytest.approx(want)


def test_reference_tree_is_taken_as_it_is(pair):
    """(G, K) stacks, ``trailing``, ``shared`` and f32 A_log, D, dt_bias:
    the port's own init has the reference's paths, shapes and dtypes."""
    cfg, params = pair["cfg"], pair["params"]
    assert HY.schedule(cfg) == (2, 2, 1)
    own = pair["model"].init(torch.Generator().manual_seed(0))
    assert sorted((p, t.shape, t.dtype) for p, t in T.leaves_with_path(own)) == \
        sorted((p, t.shape, t.dtype) for p, t in T.leaves_with_path(params))
    assert params["groups"]["in_x"].shape[:2] == (2, 2)
    assert params["trailing"]["in_x"].shape[0] == 1
    assert params["shared"]["attn"]["wq"].dim() == 3  # one unstacked dense block
    for part in ("groups", "trailing"):
        for k in ("A_log", "D", "dt_bias"):
            assert params[part][k].dtype == torch.float32


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_loss_and_logits_match_reference(pair):
    toks = np.random.default_rng(1).integers(0, pair["cfg"].vocab_size, (2, 70)).astype(np.int32)
    loss, m = pair["model"].loss(pair["params"], {"tokens": torch.as_tensor(toks)})
    rloss, rlogits = jax.jit(lambda p, t: (pair["rmodel"].loss(p, {"tokens": t})[0],
                                           pair["rmodel"].forward(p, {"tokens": t})))(
        pair["rparams"], jnp.asarray(toks))
    _close(loss, rloss)
    assert set(m) == {"nll"}
    _close(pair["model"].forward(pair["params"], {"tokens": torch.as_tensor(toks)}), rlogits)


def test_loss_gradients_match_reference(pair, one_thread):
    """Every leaf's gradient, the shared block's summed over its sites."""
    toks = np.random.default_rng(2).integers(0, pair["cfg"].vocab_size, (2, 40)).astype(np.int32)
    _, g = value_and_grad(pair["model"].loss, pair["params"], {"tokens": torch.as_tensor(toks)})
    rg = _np(jax.jit(jax.grad(lambda p: pair["rmodel"].loss(p, {"tokens": jnp.asarray(toks)})[0]))(
        pair["rparams"]))
    for path, t in T.leaves_with_path(g):
        assert bool(torch.isfinite(t).all()), path
        _close(t, T.get_path(rg, path))


def test_blocks_plan_and_taps_match_reference(pair):
    """Block indices: Mamba blocks 0..4 in execution order, the shared block
    5; the visit order (K Mamba blocks, then the shared block as site g;
    the trailing block last), the block kinds, each block's output and the
    tap dispatch (the last index takes ``dense_taps``) as the reference's,
    each block's output and taps for a grouped, the trailing and the shared
    block."""
    model, rmodel, cfg, rcfg = pair["model"], pair["rmodel"], pair["cfg"], pair["rcfg"]
    assert model.num_blocks == rmodel.num_blocks == cfg.num_layers + 1
    assert R.execution_plan(model)[0].visits == RRECON.execution_plan(rmodel)[0].visits == \
        [(0, 0), (1, 0), (5, 0), (2, 0), (3, 0), (5, 1), (4, 0)]
    h = np.random.default_rng(3).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24)[None, :]
    for i in range(model.num_blocks):
        assert R.block_kind(model, i) == RRECON.block_kind(rmodel, i)
        fn = TAPS.taps_for_block(cfg, i, model.num_blocks)
        assert fn is (TAPS.dense_taps if i == cfg.num_layers else TAPS.ssm_taps)
    for i in (1, 4, 5):
        bp, rbp = model.get_block(pair["params"], i), rmodel.get_block(pair["rparams"], i)
        out = model.apply_block(None, i, bp, torch.as_tensor(h), torch.as_tensor(pos))
        rout = jax.jit(lambda b, h_: rmodel.apply_block(None, i, b, h_, jnp.asarray(pos)))(
            rbp, jnp.asarray(h))
        _close(out, rout)
        fn = TAPS.taps_for_block(cfg, i, model.num_blocks)
        rfn = RTAPS.taps_for_block(rcfg, i, rmodel.num_blocks)
        taps = fn(bp, cfg, torch.as_tensor(h), torch.as_tensor(pos))
        rtaps = jax.jit(lambda b, h_: rfn(b, rcfg, h_, jnp.asarray(pos)))(rbp, jnp.asarray(h))
        assert taps.keys() == rtaps.keys()
        for k in taps:
            _close(taps[k], rtaps[k])


def test_set_block_writes_in_place(pair):
    """``get_block`` gives views (the shared block: the live tree);
    ``set_block`` copies into them."""
    model = pair["model"]
    params = T.tree_map(torch.clone, pair["params"])
    for i in (3, 4, 5):
        bp = T.tree_map(lambda t: t + 1, model.get_block(params, i))
        assert model.set_block(params, i, bp) is params
        for path, t in T.leaves_with_path(model.get_block(params, i)):
            assert torch.equal(t, T.get_path(bp, path)), (i, path)
    assert model.get_block(params, 5) is params["shared"]
    assert torch.equal(params["groups"]["in_x"][1, 1], pair["params"]["groups"]["in_x"][1, 1] + 1)
    assert torch.equal(params["groups"]["in_x"][1, 0], pair["params"]["groups"]["in_x"][1, 0])


# ---------------------------------------------------------------------------
# pruning, EBFT, the pipeline
# ---------------------------------------------------------------------------
# the other two (and the conv taps' rules) in tests/test_torch_ssm.py
PRUNES = [("wanda", 0.7, None), ("magnitude", 0.5, (2, 4))]


@pytest.fixture(scope="module")
def pruned(pair):
    corpus = RSyntheticCorpus(RCorpusConfig(vocab_size=pair["cfg"].vocab_size, seed=0))
    calib = ref_calibration_set(corpus, SPEC.calib_samples, SPEC.seq)
    out = {"calib": calib, "ev": ref_eval_set(corpus, ebft_run.EVAL_SAMPLES, SPEC.seq)}
    for method, sp, pat in PRUNES:
        scores = {}
        masks, pr = prune(pair["model"], pair["params"], calib, method=method, sparsity=sp,
                          pattern=pat, scores_out=scores)
        rmasks, rpr = ref_prune(pair["rmodel"], pair["rparams"], calib, method=method,
                                sparsity=sp, pattern=pat)
        out[(method, pat)] = dict(masks=masks, pruned=pr, rmasks=rmasks, rpruned=rpr,
                                  scores=scores, sparsity=sp)
    return out


@pytest.mark.parametrize("method,pattern", [(m, p) for m, _, p in PRUNES],
                         ids=[f"{m}-{'2:4' if p else 'unstructured'}" for m, _, p in PRUNES])
def test_prune_masks_equal_reference(pair, pruned, method, pattern):
    """Every leaf's mask the reference's (Wanda: bar near-tie flips), the
    shared block's included (pruned at each of its sites, as the
    reference's walk visits it); pruned slots 0; conv taps dense under 2:4."""
    r = pruned[(method, pattern)]
    cfg = pair["cfg"]
    ref = interop.masks_to_torch(_np(r["rmasks"]), "cpu")
    for path, m in T.leaves_with_path(r["masks"]):
        want = T.get_path(ref, path).expand(m.shape)
        diff = m != want
        if bool(diff.any()):
            assert method == "wanda" and pattern is None, path
            stack = m.reshape(-1, *m.shape[2:]) if path[0] == "groups" else \
                m[None] if path[0] == "shared" else m
            dstack = diff.reshape(stack.shape)
            for j in range(stack.shape[0]):
                if dstack[j].any():
                    s = r["scores"][(_block_index(cfg, path, j), *path[1:])]
                    gaps = SP.threshold_gaps(s, r["sparsity"])[dstack[j].reshape(s.shape)]
                    assert float(gaps.max()) <= TIE_RTOL, path
        if SP.is_prunable(path, m):
            assert bool((T.get_path(r["pruned"], path)[~m] == 0).all()), path
    if pattern is not None:
        assert bool(r["masks"]["groups"]["conv_w"].all())
        assert bool(r["masks"]["trailing"]["conv_w"].all())
    assert not bool(r["masks"]["shared"]["attn"]["wq"].all())


def test_unported_methods_raise(pair, pruned, one_thread):
    """FLAP still refuses the family. The baselines that refused it until
    they were ported now agree with the reference: SparseGPT's (``conv_w``
    Wanda's mask, no update) and DSnoT's leaf functions on Mamba block 1,
    mask tuning's final masks and LoRA's merge
    (``leaf_functions_match_reference``); and the driver takes ``--baselines
    dsnot,mask`` on the family, their perplexities the library's
    (``test_torch_hybrid_baselines.py`` holds the driver's baselines, the
    walks and the shared block's order to the reference's)."""
    model, params, calib = pair["model"], pair["params"], pruned["calib"]
    with pytest.raises(ValueError, match="FLAP"):
        prune(model, params, calib, method="flap", sparsity=0.2)
    assert leaf_functions_match_reference(model, params, pair["rmodel"], pair["rparams"],
                                          calib[:8], pruned[("wanda", None)]["rmasks"],
                                          block=1) == 7
    res = driver_matches_library(pair["cfg"], params,
                                 dataclasses.replace(SPEC, baselines="dsnot,mask", epochs=0))
    assert len(res.baselines["mask"]["histories"]) == pair["cfg"].num_layers + 2


@pytest.fixture(scope="module")
def ref_ebft(pair, pruned):
    w = pruned[("wanda", None)]
    tuned, reports = REBFT.finetune(pair["rmodel"], pair["rparams"], w["rpruned"], w["rmasks"],
                                    pruned["calib"],
                                    REBFT.EBFTConfig(lr=SPEC.lr, epochs=SPEC.epochs))
    ev = pruned["ev"]
    return dict(tuned=tuned, reports=reports,
                ppl={"dense": ref_perplexity(pair["rmodel"], pair["rparams"], ev),
                     "wanda": ref_perplexity(pair["rmodel"], w["rpruned"], ev),
                     "EBFT": ref_perplexity(pair["rmodel"], tuned, ev)})


def _same_reports(reports, rreports):
    assert [(r.index, r.kind) for r in reports] == [(r.index, r.kind) for r in rreports]
    for a, b in zip(reports, rreports):
        assert (a.epochs_run, a.early_stop) == (b.epochs_run, b.early_stop), a.index
        for x, y in zip(a.history + [a.loss_after], b.history + [b.loss_after]):
            assert x == pytest.approx(y, rel=PIPE_REL), a.index
        assert a.loss_after < a.loss_before


def test_ebft_tunes_the_shared_block_once_on_both_sites(pair, pruned, ref_ebft, one_thread,
                                                        monkeypatch):
    """From the reference's masks and pruned weights: the reports (Mamba
    blocks in walk order, the shared block last) and the tuned perplexity
    as the reference's; the shared block tuned by one ``tune_block`` call
    on both sites' microbatches; the student stream at both sites ran the
    untuned pruned shared block."""
    w = pruned[("wanda", None)]
    model, cfg = pair["model"], pair["cfg"]
    shared = model.num_blocks - 1
    masks = interop.masks_to_torch(_np(w["rmasks"]), "cpu")
    start = interop.params_to_torch(_np(w["rpruned"]), "cpu")
    tuned_calls, student_bps = [], []
    tune_block, advance_with = EBFT.tune_block, R.advance_with

    def spy_tune(model_, i, bp, mask_bp, data, *a):
        tuned_calls.append((i, len(data)))
        return tune_block(model_, i, bp, mask_bp, data, *a)

    def spy_advance(model_, params, i, bp, h, pos, masks_=None):
        if i == shared and masks_ is not None:  # the student's advance
            student_bps.append(T.tree_map(torch.clone, bp))
        return advance_with(model_, params, i, bp, h, pos, masks_)

    monkeypatch.setattr(EBFT, "tune_block", spy_tune)
    monkeypatch.setattr(R, "advance_with", spy_advance)
    tuned, reports = EBFT.finetune(model, pair["params"], start, masks, pruned["calib"],
                                   EBFT.EBFTConfig(lr=SPEC.lr, epochs=SPEC.epochs))
    _same_reports(reports, ref_ebft["reports"])
    assert reports[-1].index == shared and reports[-1].kind == "shared"
    n_mb = math.ceil(SPEC.calib_samples / 8)
    G = HY.schedule(cfg)[0]
    assert [c for c in tuned_calls if c[0] == shared] == [(shared, G * n_mb)]
    assert len(student_bps) == G * n_mb
    for bp in student_bps:
        for path, t in T.leaves_with_path(bp):
            assert torch.equal(t, T.get_path(start["shared"], path)), path
    assert not torch.equal(tuned["shared"]["attn"]["wq"], start["shared"]["attn"]["wq"])
    assert perplexity(model, tuned, pruned["ev"], masks=masks) == pytest.approx(
        ref_ebft["ppl"]["EBFT"], rel=PIPE_REL)
    for path, m in T.leaves_with_path(masks):
        if SP.is_prunable(path, m):
            t = T.get_path(tuned, path)
            assert bool((t[~m.expand(t.shape)] == 0).all()), path


def test_ebft_run_matches_reference(pair, ref_ebft, one_thread):
    """``ebft_run.run`` (Wanda 0.7, EBFT) on the reference's weights: the
    dense, pruned and EBFT perplexities, each block's losses, epochs and
    early stop."""
    res = ebft_run.run(pair["cfg"], SPEC, "cpu", params=pair["params"])
    for k, v in ref_ebft["ppl"].items():
        assert res.perplexity[k] == pytest.approx(v, rel=PIPE_REL), k
    _same_reports(res.reports, ref_ebft["reports"])


# ---------------------------------------------------------------------------
# serving, checkpoints, the launchers
# ---------------------------------------------------------------------------
def test_served_tokens_match_reference(pair):
    """Continuous batching (5 requests over 2 slots) token for token; each request's Mamba states and its two sites' keys and
    values enter its slot of the cache."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, pair["cfg"].vocab_size, n).astype(np.int32)
               for n in (40, 12, 40, 7, 40)]

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new=3 + i % 3) for i, p in enumerate(prompts)]

    got = Server(pair["model"], pair["params"], batch_size=2, max_len=64).serve(reqs(Request))
    want = RServer(pair["rmodel"], pair["rparams"], batch_size=2, max_len=64).serve(
        reqs(RRequest))
    assert got == want


def test_cache_layout(pair):
    """The shared block's cache is (G, B, Hkv, max_len, hd): a site's slab
    is the (B, Hkv, max_len, hd) view the attention takes; the Mamba states
    carry (G, K) and (R,) stack axes."""
    cfg = pair["cfg"]
    cache = pair["model"].init_serve_state(3, 64, "cpu")
    G, K, R_ = HY.schedule(cfg)
    kv = cache["shared_kv"]["k"]
    assert kv.shape == (G, 3, cfg.num_kv_heads, 64, cfg.resolved_head_dim)
    assert kv[1].data_ptr() == kv.data_ptr() + kv.stride(0) * kv.element_size()
    assert cache["groups"]["ssm"].shape[:3] == (G, K, 3)
    assert cache["groups"]["ssm"].dtype == torch.float32
    assert cache["trailing"]["conv"].shape[:2] == (R_, 3) and cache["len"] == 0
    _, cache = pair["model"].prefill(pair["params"], {"tokens": torch.zeros(3, 5,
                                                                           dtype=torch.long)},
                                     cache)
    assert cache["len"] == 5 and bool(cache["shared_kv"]["k"][:, :, :, :5].abs().sum(-1).all())


def test_checkpoint_restores_across_packages(pair, tmp_path):
    CK.save(str(tmp_path / "port"), {"params": pair["params"]}, step=1, async_write=False)
    out = RCK.restore(str(tmp_path / "port"), {"params": pair["rparams"]})
    for path, t in T.leaves_with_path(pair["params"]):
        np.testing.assert_array_equal(np.asarray(T.get_path(out["params"], path)), t.numpy())
    RCK.save(str(tmp_path / "ref"), {"params": pair["rparams"]}, step=2, async_write=False)
    own = pair["model"].init(torch.Generator().manual_seed(1))
    back = CK.restore(str(tmp_path / "ref"), {"params": own})["params"]
    for path, t in T.leaves_with_path(back):
        assert torch.equal(t, T.get_path(pair["params"], path)), path


def test_launchers_run_on_the_cpu(tmp_path, capsys, one_thread):
    from repro_torch.launch import serve, train

    out = tmp_path / "bench.json"
    res = ebft_run.main(["--arch", ARCH, "--pretrain-steps", "3", "--batch", "4", "--seq", "32",
                         "--calib-samples", "8", "--epochs", "1", "--microbatches", "2",
                         "--device", "cpu", "--bench-out", str(out)])
    assert out.exists() and math.isfinite(res.perplexity["EBFT"])
    assert [r.kind for r in res.reports] == ["mamba"] * 5 + ["shared"]
    argv = ["--arch", ARCH, "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--device", "cpu", "--no-obs"]
    assert train.main(argv + ["--steps", "2"]).start == 0
    assert train.main(argv + ["--steps", "3"]).start == 2
    served = serve.main(["--arch", ARCH, "--requests", "3", "--slots", "2", "--sparse", "0.5",
                         "--device", "cpu", "--no-obs"])
    assert len(served) == 3
    text = capsys.readouterr().out
    assert "EBFT ppl" in text and "resumed from step 2" in text and "served 3 requests" in text
