"""The port's SSM family (Mamba2) against the JAX reference, on the CPU:
the SSD primitives, a Mamba block with masks, tiny_ssm (Mamba2-130M's
SMOKE: 2 layers, d 64, 8 heads x 16, state 16, chunk 32) through Wanda
and magnitude, EBFT, perplexity, pretraining, serving and checkpoints.
The weights are the reference's ``init``, carried across with
``interop.params_to_torch``; inputs are numpy arrays from a seed.

Stated tolerances (f32, sums taken in another order on each side):
- causal conv, SSD (chunked and one step), a block's output, logits,
  loss, gradients, taps: rel 1e-5;
- Wanda and magnitude masks: equal, bar Wanda flips whose score lies
  within 1e-6 (relative) of its comparison group's threshold;
- EBFT's per-block losses, pretraining's losses and the perplexities:
  rel 1e-4 (pretraining's losses 1e-5);
- served tokens: equal, token for token;
- the SSD gradient at Mamba2-130M's widths, where the reference's is
  NaN: rel 1e-4 of an f64 recurrence's.
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
from repro.core import mask_tuning as RMT
from repro.core.evaluate import perplexity as ref_perplexity
from repro.core.masks import prune as ref_prune
from repro.data.tokens import CorpusConfig as RCorpusConfig
from repro.data.tokens import SyntheticCorpus as RSyntheticCorpus
from repro.data.tokens import calibration_set as ref_calibration_set
from repro.data.tokens import eval_set as ref_eval_set
from repro.launch import rooflines as RROOF
from repro.launch.ebft_run import pretrain as ref_pretrain
from repro.models import ssm as RSSM
from repro.models.model import build as ref_build
from repro.obs import metrics as ROM
from repro.serving.decode import Request as RRequest
from repro.serving.decode import Server as RServer
from repro.sparsity import sparse_params as RSP
from repro.sparsity import taps as RTAPS
from _torch_baselines import driver_matches_library, leaf_functions_match_reference
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ebft as EBFT
from repro_torch.core import lora, mask_tuning
from repro_torch.core import reconstruction as R
from repro_torch.core.evaluate import perplexity
from repro_torch.core.masks import prune
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.launch import ebft_run, rooflines
from repro_torch.models import ssm as SSM
from repro_torch.models.model import build
from repro_torch.serving.decode import Request, Server
from repro_torch.sparsity import sparse_params as SP
from repro_torch.sparsity import taps as TAPS
from repro_torch.training.train_loop import value_and_grad

from _torch_threads import one_thread_module  # noqa: F401

ARCH = "tiny_ssm"
REL = 1e-5
PIPE_REL = 1e-4
TIE_RTOL = 1e-6
# the pipeline's settings in the tests: Wanda 0.7 on 16 segments of 32
# tokens, EBFT at lr 1e-2 for 3 epochs (at 10 epochs the reference's own
# EBFT goes NaN on tiny_hybrid: ROADMAP.md C, the SSD gradient)
SPEC = ebft_run.RunSpec(arch=ARCH, seed=0, seq=32, calib_samples=16, pretrain_steps=0,
                        epochs=3, lr=1e-2, bench_out="")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _close(got, want, rel=REL):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def pair():
    rcfg, cfg = ref_get_config(ARCH), get_config(ARCH)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    return dict(rcfg=rcfg, cfg=cfg, rmodel=rmodel, rparams=rparams, model=build(cfg),
                params=interop.params_to_torch(_np(rparams), "cpu"))


# ---------------------------------------------------------------------------
# configs, rooflines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2_130m", "tiny_ssm"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke)) == \
        dataclasses.asdict(ref_get_config(arch, smoke))


@pytest.mark.parametrize("kind,batch,seq", [("train", 8, 2048), ("ebft", 8, 2048),
                                            ("prefill", 8, 512), ("decode", 8, 1)])
def test_model_flops_match_reference(kind, batch, seq):
    shape = ShapeConfig("s", seq, batch, kind)
    want = RROOF.model_flops_per_chip(ref_get_config("mamba2_130m"), shape, 1)
    assert rooflines.model_flops_per_chip(get_config("mamba2_130m"), shape, 1) == \
        pytest.approx(want)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    y, ns = SSM.causal_conv(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                            None if st is None else torch.as_tensor(st))
    ry, rns = RSSM.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    _close(y, ry)
    _close(ns, rns)


def _ssd_inputs(S, H=3, P=4, N=5, B=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    st = rng.normal(size=(B, H, N, P)).astype(np.float32)
    return x, dt, A, Bm, Cm, st


@pytest.mark.parametrize("S,with_state", [(64, False), (50, False), (10, False), (40, True)],
                         ids=["multiple", "ragged", "shorter", "init_state"])
def test_ssd_chunked_matches_reference(S, with_state):
    """S a multiple of the chunk (16), not a multiple (padded), shorter
    than one chunk, and from a carried state."""
    x, dt, A, Bm, Cm, st = _ssd_inputs(S)
    init = st if with_state else None
    y, fs = SSM.ssd_chunked(*map(torch.as_tensor, (x, dt, A, Bm, Cm)), 16,
                            None if init is None else torch.as_tensor(init))
    ry, rfs = jax.jit(RSSM.ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), 16, None if init is None else jnp.asarray(init))
    _close(y, ry)
    _close(fs, rfs)


def test_ssd_step_matches_reference_and_chains_to_the_chunked_scan():
    x, dt, A, Bm, Cm, st = _ssd_inputs(20)
    y, ns = SSM.ssd_step(*map(torch.as_tensor, (x[:, :1], dt[:, :1], A, Bm[:, :1], Cm[:, :1],
                                                st)))
    ry, rns = RSSM.ssd_step(*map(jnp.asarray, (x[:, :1], dt[:, :1], A, Bm[:, :1], Cm[:, :1],
                                               st)))
    _close(y, ry)
    _close(ns, rns)
    # twenty steps from a state give the chunked scan's outputs and state
    state, ys = torch.as_tensor(st), []
    for t in range(20):
        yt, state = SSM.ssd_step(*(torch.as_tensor(a[:, t:t + 1]) for a in (x, dt)),
                                 torch.as_tensor(A), torch.as_tensor(Bm[:, t:t + 1]),
                                 torch.as_tensor(Cm[:, t:t + 1]), state)
        ys.append(yt)
    yc, sc = SSM.ssd_chunked(*map(torch.as_tensor, (x, dt, A, Bm, Cm)), 8, torch.as_tensor(st))
    _close(torch.cat(ys, dim=1), yc.numpy())
    _close(state, sc.numpy())


def _f64_scan_grads(x, dt, A, Bm, Cm, wy):
    """The recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t
    step by step in f64, and the gradients of sum(y * wy)."""
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (x, dt, Bm, Cm)]
    xt, dtt, Bt, Ct = ts
    A64 = torch.tensor(A, dtype=torch.float64)
    h = torch.zeros(x.shape[0], x.shape[2], Bm.shape[-1], x.shape[3], dtype=torch.float64)
    ys = []
    for t in range(x.shape[1]):
        h = h * torch.exp(dtt[:, t] * A64)[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", Bt[:, t], dtt[:, t], xt[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Ct[:, t], h))
    (torch.stack(ys, dim=1) * torch.tensor(wy, dtype=torch.float64)).sum().backward()
    return [t.grad for t in ts]


def test_ssd_gradient_is_finite_at_mamba2_130m_widths():
    """The reference's ``where(tri, exp(diff), 0)`` overflows above the
    diagonal at H 24, Q 256 (dt = softplus(-2), A = -(1..H)): its dt
    gradient is not finite. The port masks before the exp: the same
    forward, finite gradients within rel 1e-4 of an f64 recurrence's, and
    the reference's gradients wherever those are finite."""
    B, S, H, P, N = 1, 256, 24, 4, 8
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    dt = np.full((B, S, H), np.log1p(np.exp(-2.0)), np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    wy = rng.normal(size=(B, S, H, P)).astype(np.float32)

    def ref_loss(x_, dt_, b_, c_):
        y_ = RSSM.ssd_chunked(x_, dt_, jnp.asarray(A), b_, c_, 256)[0]
        return jnp.sum(y_ * wy), y_

    (_, ry), rgrads = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (x, dt, Bm, Cm)))
    assert not bool(jnp.isfinite(rgrads[1]).all())  # the reference's fault

    ts = [torch.tensor(a, requires_grad=True) for a in (x, dt, Bm, Cm)]
    y, _ = SSM.ssd_chunked(ts[0], ts[1], torch.as_tensor(A), ts[2], ts[3], 256)
    (y * torch.as_tensor(wy)).sum().backward()
    _close(y, ry)
    for t, g64, rg in zip(ts, _f64_scan_grads(x, dt, A, Bm, Cm, wy), rgrads):
        assert bool(torch.isfinite(t.grad).all())
        _close(t.grad, g64.numpy(), rel=PIPE_REL)
        rg = np.asarray(rg)
        ok = np.isfinite(rg)
        if ok.any():
            np.testing.assert_allclose(t.grad.numpy()[ok], rg[ok], rtol=0,
                                       atol=REL * max(1.0, float(np.abs(rg[ok]).max())))
    # exp(-inf) is exactly 0: the masked form's decay is the where form's
    diff = torch.randn(6, 6) * 200
    tri = torch.ones(6, 6, dtype=torch.bool).tril()
    assert torch.equal(torch.exp(diff.masked_fill(~tri, -math.inf)),
                       torch.where(tri, torch.exp(diff), torch.zeros(())))


def _random_masks(bp, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.random(tuple(v.shape)) < 0.5)
            for k, v in bp.items() if SP.is_prunable((k,), v)}


def test_mamba_block_with_masks_matches_reference(pair):
    """Masked projections through the masked matmul (its plain version on
    the CPU), conv_w as w * m, from a carried state too."""
    cfg, rcfg = pair["cfg"], pair["rcfg"]
    bp = T.tree_map(lambda t: t[1], pair["params"]["blocks"])
    mk = _random_masks(bp, 5)
    assert set(mk) == {"in_z", "in_x", "in_B", "in_C", "in_dt", "out", "conv_w"}
    rbp = RSP.apply_masks(_j(bp), T.map_with_path(
        lambda p, _: jnp.asarray(mk[p[0]].numpy().astype(np.float32)) if p[0] in mk
        else jnp.ones(()), bp))
    h = np.random.default_rng(6).normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    ch = cfg.ssm_num_heads * cfg.ssm_head_dim + 2 * cfg.ssm_state
    rng = np.random.default_rng(7)
    st = {"conv": rng.normal(size=(2, cfg.ssm_conv - 1, ch)).astype(np.float32),
          "ssm": rng.normal(size=(2, cfg.ssm_num_heads, cfg.ssm_state,
                                  cfg.ssm_head_dim)).astype(np.float32)}
    ref = jax.jit(lambda h_, st_: RSSM.mamba_block_apply(rbp, rcfg, h_, st_))
    for S in (40, 1):  # a prompt from a state (chunked), one token (ssd_step)
        out, ns = SSM.mamba_block_apply(bp, cfg, torch.as_tensor(h[:, :S]),
                                        state=T.tree_map(torch.as_tensor, st), masks=mk)
        rout, rns = ref(jnp.asarray(h[:, :S]), jax.tree.map(jnp.asarray, st))
        _close(out, rout)
        for k in ("conv", "ssm"):
            _close(ns[k], rns[k])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_reference_tree_is_taken_as_it_is(pair):
    """``build`` runs the reference's tree: (L, ...) stacks, f32 A_log,
    D and dt_bias; its own init has the same paths, shapes and dtypes."""
    params = pair["params"]
    own = pair["model"].init(torch.Generator().manual_seed(0))
    assert sorted((p, t.shape, t.dtype) for p, t in T.leaves_with_path(own)) == \
        sorted((p, t.shape, t.dtype) for p, t in T.leaves_with_path(params))
    for k in ("A_log", "D", "dt_bias"):
        assert params["blocks"][k].dtype == torch.float32
    _close(own["blocks"]["A_log"], pair["rparams"]["blocks"]["A_log"])


def test_loss_and_logits_match_reference(pair):
    toks = np.random.default_rng(8).integers(0, pair["cfg"].vocab_size, (2, 70)).astype(np.int32)
    loss, m = pair["model"].loss(pair["params"], {"tokens": torch.as_tensor(toks)})
    rloss, _ = pair["rmodel"].loss(pair["rparams"], {"tokens": jnp.asarray(toks)})
    _close(loss, rloss)
    assert set(m) == {"nll"}
    _close(pair["model"].forward(pair["params"], {"tokens": torch.as_tensor(toks)}),
           pair["rmodel"].forward(pair["rparams"], {"tokens": jnp.asarray(toks)}))


def test_loss_gradients_match_reference(pair):
    """Every leaf's gradient, at tiny_ssm's widths (H 8, Q 32), where the
    reference's SSD gradient is finite."""
    toks = np.random.default_rng(9).integers(0, pair["cfg"].vocab_size, (2, 40)).astype(np.int32)
    _, g = value_and_grad(pair["model"].loss, pair["params"], {"tokens": torch.as_tensor(toks)})
    rg = _np(jax.jit(jax.grad(lambda p: pair["rmodel"].loss(p, {"tokens": jnp.asarray(toks)})[0]))(
        pair["rparams"]))
    for path, t in T.leaves_with_path(g):
        assert bool(torch.isfinite(t).all()), path
        _close(t, T.get_path(rg, path))


def test_taps_match_reference(pair):
    model, cfg = pair["model"], pair["cfg"]
    h = np.random.default_rng(10).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    for i in range(model.num_blocks):
        assert R.block_kind(model, i) == "block"
        fn = TAPS.taps_for_block(cfg, i, model.num_blocks)
        assert fn is TAPS.ssm_taps
        taps = fn(model.get_block(pair["params"], i), cfg, torch.as_tensor(h))
        rfn = RTAPS.taps_for_block(pair["rcfg"], i, model.num_blocks)
        rtaps = jax.jit(lambda bp, h_: rfn(bp, pair["rcfg"], h_))(
            pair["rmodel"].get_block(pair["rparams"], i), jnp.asarray(h))
        assert taps.keys() == rtaps.keys()
        for k in taps:
            _close(taps[k], rtaps[k])


# ---------------------------------------------------------------------------
# pruning, EBFT, the pipeline
# ---------------------------------------------------------------------------
PRUNES = [("wanda", 0.7, None), ("wanda", 0.5, (2, 4)), ("magnitude", 0.5, None),
          ("magnitude", 0.5, (2, 4))]


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
                                  scores=scores, sparsity=sp, pattern=pat)
    return out


@pytest.mark.parametrize("method,pattern", [(m, p) for m, _, p in PRUNES],
                         ids=[f"{m}-{'2:4' if p else 'unstructured'}" for m, _, p in PRUNES])
def test_prune_masks_equal_reference(pair, pruned, method, pattern):
    """Every leaf's mask the reference's (Wanda: bar near-tie flips); the
    conv taps dense under 2:4 and, unstructured, kept per channel."""
    r = pruned[(method, pattern)]
    ref = interop.masks_to_torch(_np(r["rmasks"]), "cpu")
    for path, m in T.leaves_with_path(r["masks"]):
        want = T.get_path(ref, path).expand(m.shape)
        diff = m != want
        if bool(diff.any()):
            assert method == "wanda" and pattern is None, path
            for j in range(m.shape[0]):
                if diff[j].any():
                    s = r["scores"][(j, *path[1:])]
                    gaps = SP.threshold_gaps(s, r["sparsity"])[
                        diff[j].reshape(SP.to_matrix(path[-1], m[j])[0].shape)]
                    assert float(gaps.max()) <= TIE_RTOL, path
        if SP.is_prunable(path, m):
            assert bool((T.get_path(r["pruned"], path)[~m] == 0).all()), path
    conv = r["masks"]["blocks"]["conv_w"]  # (L, K, ch)
    if pattern is not None:
        assert bool(conv.all())
    elif method == "wanda":
        assert bool((conv.sum(dim=1) == round(conv.shape[1] * 0.3)).all())
    for k in ("A_log", "D", "dt_bias", "conv_b"):
        assert bool(r["masks"]["blocks"][k].all())


def test_hard_mask_keeps_conv_w_dense_under_nm():
    """Mask tuning's threshold: under N:M a ``conv_w`` mask is all ones, as
    the reference's; other leaves and unstructured masks as before."""
    rng = np.random.default_rng(11)
    for name, shape in (("conv_w", (4, 160)), ("in_x", (64, 128))):
        s = rng.normal(size=shape).astype(np.float32)
        for sp, pat in ((0.5, (2, 4)), (0.7, None)):
            got = mask_tuning._hard_mask(name, torch.as_tensor(s), sp, pat)
            want = np.asarray(RMT._hard_mask(name, jnp.asarray(s), sp, pat))
            np.testing.assert_array_equal(got.numpy(), want != 0)
            assert bool(got.all()) == (name == "conv_w" and pat is not None)


def test_bf16_kernel_takes_a_narrow_mask_as_a_padded_view():
    """Mamba2-130M's ``in_dt`` (768, 24): a contiguous bool mask has rows
    24 bytes apart, which the bf16 kernel (TMA) refuses; ``prune`` keeps it
    in a (768, 32) buffer and the wrapper takes the 24-column view for the
    forward, dX and dW. Nothing falls back to the plain version."""
    bf = torch.bfloat16
    x, w, dy = torch.zeros(16, 768, dtype=bf), torch.zeros(768, 24, dtype=bf), \
        torch.zeros(16, 24, dtype=bf)
    m = torch.rand(768, 24) < 0.3
    with pytest.raises(ValueError, match="mask row stride"):
        MM.check_operands("masked_matmul", x, w, m)
    mv = MM.aligned_mask(m)
    assert mv.shape == (768, 24) and mv.stride() == (32, 1) and torch.equal(mv, m)
    MM.check_operands("masked_matmul", x, w, mv)
    MM.check_operands("masked_matmul_dx", dy, w, mv)
    MM.check_operands("masked_matmul_dw", x, dy, mv)
    assert MM.aligned_mask(torch.ones(4, 32, dtype=torch.bool)).stride() == (32, 1)
    # the masks prune gives a Mamba2-130M block are laid out so
    cfg = get_config("mamba2_130m").replace(num_layers=1, vocab_size=512)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    calib = np.random.default_rng(12).integers(0, 512, (2, 16)).astype(np.int32)
    for method in ("magnitude", "wanda"):
        masks, _ = prune(model, params, calib, method=method, sparsity=0.7)
        blk = model.get_block(masks, 0)
        assert blk["in_dt"].shape == (768, 24) and blk["in_dt"].stride() == (32, 1), method
        MM.check_operands("masked_matmul", x, w, blk["in_dt"])


def test_unported_methods_raise(pair, pruned, monkeypatch):
    """FLAP still refuses the family, as the reference's assert does. The
    baselines that refused it until they were ported now agree with the
    reference: SparseGPT's (``conv_w`` Wanda's mask, no update) and DSnoT's
    leaf functions on block 1, mask tuning's final masks and LoRA's merge
    (``leaf_functions_match_reference``); and the driver takes ``--baselines
    lora`` on the family (3 steps here), its perplexity the library's
    (``test_torch_ssm_baselines.py`` holds the driver's baselines and the
    walks to the reference's)."""
    model, params, calib = pair["model"], pair["params"], pruned["calib"]
    with pytest.raises(ValueError, match="FLAP"):
        prune(model, params, calib, method="flap", sparsity=0.2)
    with pytest.raises(AssertionError):  # the reference refuses it too
        ref_prune(pair["rmodel"], pair["rparams"], calib, method="flap", sparsity=0.2)
    assert leaf_functions_match_reference(model, params, pair["rmodel"], pair["rparams"],
                                          calib[:8], pruned[("wanda", None)]["rmasks"],
                                          block=1) == 7
    monkeypatch.setattr(ebft_run, "LORA", lora.LoRAConfig(steps=3, lr=1e-3))
    res = driver_matches_library(pair["cfg"], params,
                                 dataclasses.replace(SPEC, baselines="lora", epochs=0))
    assert len(res.baselines["lora"]["losses"]) == 3


@pytest.fixture(scope="module")
def ref_ebft(pair, pruned):
    """The reference's EBFT of its Wanda-0.7 prune at the pipeline's settings."""
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


def test_ebft_matches_reference(pair, pruned, ref_ebft):
    """EBFT from the reference's masks and pruned weights: per block the
    epochs run and early stops equal, the losses within rel 1e-4, pruned
    slots still 0; the tuned perplexity within rel 1e-4."""
    w = pruned[("wanda", None)]
    masks = interop.masks_to_torch(_np(w["rmasks"]), "cpu")
    tuned, reports = EBFT.finetune(pair["model"], pair["params"],
                                   interop.params_to_torch(_np(w["rpruned"]), "cpu"), masks,
                                   pruned["calib"], EBFT.EBFTConfig(lr=SPEC.lr,
                                                                    epochs=SPEC.epochs))
    _same_reports(reports, ref_ebft["reports"])
    assert perplexity(pair["model"], tuned, pruned["ev"], masks=masks) == pytest.approx(
        ref_ebft["ppl"]["EBFT"], rel=PIPE_REL)
    for path, m in T.leaves_with_path(masks):
        if SP.is_prunable(path, m):
            assert bool((T.get_path(tuned, path)[~m.expand(T.get_path(tuned, path).shape)]
                         == 0).all()), path


def test_ebft_run_matches_reference(pair, ref_ebft):
    """``ebft_run.run`` (Wanda 0.7, EBFT) on the reference's weights: the
    dense, pruned and EBFT perplexities, each block's losses, epochs and
    early stop, against the reference's functions."""
    res = ebft_run.run(pair["cfg"], SPEC, "cpu", params=pair["params"])
    for k, v in ref_ebft["ppl"].items():
        assert res.perplexity[k] == pytest.approx(v, rel=PIPE_REL), k
    _same_reports(res.reports, ref_ebft["reports"])
    assert not any(math.isnan(v) for v in res.perplexity.values())


def test_pretrain_matches_reference(pair):
    """Five AdamW steps (``ebft_run.pretrain``): the recorded losses
    within rel 1e-5 of the reference's."""
    corpus = RSyntheticCorpus(RCorpusConfig(vocab_size=pair["cfg"].vocab_size, seed=0))
    ROM.set_registry(ROM.Metrics())
    try:
        ref_pretrain(pair["rmodel"], pair["rparams"], corpus, 5, 4, 32, ebft_run.PRETRAIN_LR,
                     say=lambda *_: None)
        ref_losses = ROM.series("pretrain/loss").points
    finally:
        ROM.set_registry(None)
    _, hist = ebft_run.pretrain(pair["model"], pair["params"], corpus, 5, 4, 32,
                                ebft_run.PRETRAIN_LR)
    assert [s for s, _, _ in hist] == [int(s) for s, _ in ref_losses] == [0, 4]
    for (_, loss, gnorm), (_, want) in zip(hist, ref_losses):
        assert loss == pytest.approx(want, rel=1e-5) and math.isfinite(gnorm)


# ---------------------------------------------------------------------------
# serving, checkpoints, the launchers
# ---------------------------------------------------------------------------
def test_served_tokens_match_reference(pair):
    """``generate`` and continuous batching (5 requests over 2 slots, the
    prompts of several lengths) token for token; the cache is the
    reference's, ``len`` a host int."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, pair["cfg"].vocab_size, n).astype(np.int32)
               for n in (40, 12, 40, 7, 40)]

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new=3 + i % 3) for i, p in enumerate(prompts)]

    got = Server(pair["model"], pair["params"], batch_size=2, max_len=64).serve(reqs(Request))
    want = RServer(pair["rmodel"], pair["rparams"], batch_size=2, max_len=64).serve(
        reqs(RRequest))
    assert got == want
    assert Server(pair["model"], pair["params"], batch_size=2, max_len=64).generate(
        prompts[:2], max_new=5) == RServer(pair["rmodel"], pair["rparams"], batch_size=2,
                                           max_len=64).generate(prompts[:2], max_new=5)
    cache = pair["model"].init_serve_state(3, 64, "cpu")
    cfg = pair["cfg"]
    assert cache["conv"].shape == (cfg.num_layers, 3, cfg.ssm_conv - 1,
                                   cfg.ssm_num_heads * cfg.ssm_head_dim + 2 * cfg.ssm_state)
    assert cache["ssm"].dtype == torch.float32 and cache["len"] == 0


def _bf16_decode_gaps(forward, prefill, decode, toks, s0):
    """Each teacher-forced decode step's distance from the no-cache
    forward's logits at its position, over the largest of those logits."""
    full = np.asarray(forward(toks), dtype=np.float32)
    state = prefill(toks[:, :s0])
    gaps = []
    for j in range(s0, toks.shape[1]):
        logits, state = decode(toks[:, j:j + 1], state)
        got = np.asarray(logits[:, -1], dtype=np.float32)
        gaps.append(float(np.abs(got - full[:, j]).max() / np.abs(full[:, j]).max()))
    return gaps


@pytest.mark.parametrize("arch", ["tiny_ssm", "tiny_hybrid"])
def test_bf16_cached_decode_departs_from_the_forward_as_the_reference_does(arch):
    """In bf16 the one-step recurrence of a Mamba block (decode) and the
    chunked scan (the forward, and the prefill) round apart. With the same
    weights and prompts, the port's cached decode is as far from its own
    no-cache forward as the reference's is from its own, over 8 steps after
    a 24-token prompt: the largest and the mean gap each within bf16's unit
    rounding (2^-8) of the largest logit of the reference's (one step's gap
    is one draw of the rounding, on each side its own; ROADMAP.md C.6)."""
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    rcfg, cfg = ref_get_config(arch).replace(**kw), get_config(arch).replace(**kw)
    rmodel, model = ref_build(rcfg), build(cfg)
    rparams = jax.jit(rmodel.init)(jax.random.PRNGKey(0))
    params = interop.params_to_torch(jax.tree.map(np.asarray, rparams), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    rdec = jax.jit(lambda p, t, s: rmodel.decode_step(p, t, s))
    want = _bf16_decode_gaps(
        lambda t: jax.jit(lambda p, t_: rmodel.forward(p, {"tokens": t_}))(rparams, t),
        lambda t: jax.jit(lambda p, t_, s: rmodel.prefill(p, {"tokens": t_}, s))(
            rparams, t, rmodel.init_serve_state(2, 40))[1],
        lambda t, s: rdec(rparams, jnp.asarray(t), s), toks, 24)
    tt = torch.as_tensor
    got = _bf16_decode_gaps(
        lambda t: model.forward(params, {"tokens": tt(t)}).float(),
        lambda t: model.prefill(params, {"tokens": tt(t)}, model.init_serve_state(2, 40,
                                                                                 "cpu"))[1],
        lambda t, s: (lambda lg, st: (lg.float(), st))(
            *model.decode_step(params, tt(t), s)), toks, 24)
    assert len(got) == len(want) == 8
    assert max(want) > 1e-3  # the reference's own decode departs from its forward in bf16
    assert max(got) <= max(want) + 2.0 ** -8, (got, want)
    assert np.mean(got) <= np.mean(want) + 2.0 ** -8, (got, want)


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


def test_launchers_run_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve, train

    out = tmp_path / "bench.json"
    res = ebft_run.main(["--arch", ARCH, "--pretrain-steps", "3", "--batch", "4", "--seq", "32",
                         "--calib-samples", "8", "--epochs", "1", "--device", "cpu",
                         "--bench-out", str(out)])
    assert out.exists() and math.isfinite(res.perplexity["EBFT"])
    argv = ["--arch", ARCH, "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--device", "cpu", "--no-obs"]
    assert train.main(argv + ["--steps", "2"]).start == 0
    assert train.main(argv + ["--steps", "3"]).start == 2
    served = serve.main(["--arch", ARCH, "--requests", "3", "--slots", "2", "--sparse", "0.5",
                         "--device", "cpu", "--no-obs"])
    assert len(served) == 3
    text = capsys.readouterr().out
    assert "EBFT ppl" in text and "resumed from step 2" in text and "served 3 requests" in text
