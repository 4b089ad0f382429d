"""The port's MoE family against the JAX reference, on the CPU: tiny_moe
(DeepSeek-MoE-16B's SMOKE: 3 layers, the first dense, 8 experts top-2, 2
shared) and Kimi-K2's SMOKE (GQA, 4 heads over 2 KV heads, head_dim 16, 1
shared expert). The weights are the reference's ``init``, carried across
with ``interop.params_to_torch``; inputs are numpy arrays from a seed.

Stated tolerances (f32, sums taken in another order on each side):
- routing, dispatch (drops under cf 0.5, G = 2), logits, nll, aux, each
  block's output and taps: rel 1e-5;
- Wanda and magnitude masks: equal, bar Wanda flips whose score lies
  within 1e-6 (relative) of its comparison group's threshold;
- EBFT's per-block losses and the pipeline's perplexities: rel 1e-4;
- served tokens: equal, token for token;
- the plain expert-batched masked GEMM and its gradients against an
  einsum on masked weights: rel 1e-6.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import ebft as REBFT
from repro.core.evaluate import perplexity as ref_perplexity
from repro.core.masks import prune as ref_prune
from repro.data.tokens import CorpusConfig as RCorpusConfig
from repro.data.tokens import SyntheticCorpus as RSyntheticCorpus
from repro.data.tokens import calibration_set as ref_calibration_set
from repro.data.tokens import eval_set as ref_eval_set
from repro.launch import rooflines as RROOF
from repro.models import moe as RMOE
from repro.models.model import build as ref_build
from repro.serving.decode import Request as RRequest
from repro.serving.decode import Server as RServer
from repro.sparsity import sparse_params as RSP
from repro.sparsity import taps as RTAPS
from _torch_baselines import driver_matches_library, leaf_functions_match_reference
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ebft as EBFT
from repro_torch.core import reconstruction as R
from repro_torch.core.evaluate import perplexity
from repro_torch.core.masks import prune
from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set
from repro_torch.kernels.masked_matmul import ops as MM
from repro_torch.kernels.masked_matmul.ref import masked_matmul_batched_plain
from repro_torch.launch import ebft_run, rooflines, serve
from repro_torch.models import moe as MOE
from repro_torch.models.model import build
from repro_torch.serving.decode import Request, Server, _slot_update
from repro_torch.sparsity import sparse_params as SP
from repro_torch.sparsity import taps as TAPS

ARCHS = ["tiny_moe", "kimi_k2_1t_a32b"]
REL = 1e-5
PIPE_REL = 1e-4
TIE_RTOL = 1e-6


def _cfgs(arch, **kw):
    smoke = arch != "tiny_moe"
    return (ref_get_config(arch, smoke=smoke).replace(**kw),
            get_config(arch, smoke=smoke).replace(**kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture()
def one_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    under several test workers on few cores the threads' waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    rcfg, cfg = _cfgs(request.param)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    params = interop.params_to_torch(_np(rparams), "cpu")
    return dict(arch=request.param, rcfg=rcfg, cfg=cfg, rmodel=rmodel, rparams=rparams,
                model=build(cfg), params=params)


def _close(got, want, rel=REL):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def _tokens(cfg, b=2, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs, views, rooflines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "tiny_moe", "kimi_k2_1t_a32b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke)) == \
        dataclasses.asdict(ref_get_config(arch, smoke))


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "kimi_k2_1t_a32b"])
@pytest.mark.parametrize("kind,batch,seq", [("train", 8, 2048), ("ebft", 8, 2048),
                                            ("prefill", 8, 512), ("decode", 8, 1)])
def test_model_flops_count_active_parameters(arch, kind, batch, seq):
    shape = ShapeConfig("s", seq, batch, kind)
    want = RROOF.model_flops_per_chip(ref_get_config(arch), shape, 1)
    assert rooflines.model_flops_per_chip(get_config(arch), shape, 1) == pytest.approx(want)
    cfg = get_config(arch)
    assert cfg.param_count(active_only=True) < cfg.param_count()


def test_expert_views_match_reference(pair):
    """Expert leaves are (E, R, O) whole; stacked ones (L, E, R, O)."""
    params, rparams = pair["params"], _np(pair["rparams"])
    for path, leaf in T.leaves_with_path(params["moe_blocks"]):
        if not SP.is_prunable(path, leaf):
            continue
        ref_leaf = T.get_path(rparams["moe_blocks"], path)
        mat, tag = SP.to_matrix_stacked(path[-1], leaf)
        np.testing.assert_array_equal(mat.numpy(),
                                      np.asarray(RSP.to_matrix_stacked(path[-1], ref_leaf)[0]))
        one, ref_one = leaf[0], ref_leaf[0]
        assert SP.is_expert_batched(path[-1], one) == RSP.is_expert_batched(path[-1], ref_one)
        mat, tag = SP.to_matrix(path[-1], one)
        np.testing.assert_array_equal(mat.numpy(), np.asarray(RSP.to_matrix(path[-1], ref_one)[0]))
        assert SP.from_matrix(mat, tag).shape == one.shape
    assert not SP.is_prunable(("moe_blocks", "moe", "router", "w"),
                              params["moe_blocks"]["moe"]["router"]["w"])


# ---------------------------------------------------------------------------
# routing, dispatch, the model
# ---------------------------------------------------------------------------
def test_route_matches_reference(pair):
    cfg, p = pair["cfg"], pair["params"]["moe_blocks"]["moe"]["router"]["w"][0]
    xf = np.random.default_rng(1).normal(size=(40, cfg.d_model)).astype(np.float32)
    gates, idx, probs = MOE.route(p, torch.as_tensor(xf), cfg.moe_top_k)
    rg, ri, rp = RMOE.route(jnp.asarray(p.numpy()), jnp.asarray(xf), cfg.moe_top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    _close(gates, rg)
    _close(probs, rp)


def test_route_breaks_ties_toward_the_lower_expert():
    """``lax.top_k`` takes the lower index among equal scores: so does the
    port's stable sort (a router of zeros ties every expert)."""
    w = torch.zeros(4, 6)
    _, idx, _ = MOE.route(w, torch.randn(3, 4), 2)
    assert idx.tolist() == [[0, 1]] * 3
    _, ridx, _ = RMOE.route(jnp.zeros((4, 6)), jnp.ones((3, 4)), 2)
    assert np.asarray(ridx).tolist() == idx.tolist()


@pytest.mark.parametrize("cf,groups", [(1.25, 1), (0.5, 1), (0.5, 2)])
def test_moe_mlp_matches_reference(pair, cf, groups):
    """cf 0.5 drops assignments (each drop adds a zero into slot (e, 0) and
    reads back as zero); G = 2 routes two independent groups."""
    rcfg, cfg = _cfgs(pair["arch"], moe_capacity_factor=cf, moe_dispatch_groups=groups)
    p = T.tree_map(lambda t: t[0], pair["params"]["moe_blocks"]["moe"])
    x = np.random.default_rng(2).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    out, aux = MOE.moe_mlp(p, torch.as_tensor(x), cfg)
    rout, raux = RMOE.moe_mlp(jax.tree.map(lambda a: jnp.asarray(a.numpy()), p),
                              jnp.asarray(x), rcfg)
    _close(out, rout)
    _close(aux, raux)
    if cf < 1:  # drops happened
        C = MOE.capacity(cfg, 48 // groups)
        keep = MOE.dispatch(p["router"]["w"], torch.as_tensor(x[0]), cfg)[3]
        assert C < 48 // groups * cfg.moe_top_k / cfg.moe_num_experts or not bool(keep.all())


def test_loss_logits_nll_and_aux_match_reference(pair):
    toks = _tokens(pair["cfg"])
    loss, m = pair["model"].loss(pair["params"], {"tokens": torch.as_tensor(toks)})
    rloss, rm = pair["rmodel"].loss(pair["rparams"], {"tokens": jnp.asarray(toks)})
    _close(loss, rloss)
    _close(m["nll"], rm["nll"])
    _close(m["aux"], rm["aux"])
    assert float(loss) == pytest.approx(float(m["nll"]) + 0.01 * float(m["aux"]), rel=1e-6)
    logits = pair["model"].forward(pair["params"], {"tokens": torch.as_tensor(toks)})
    _close(logits, pair["rmodel"].forward(pair["rparams"], {"tokens": jnp.asarray(toks)}))


def test_loss_gradients_match_reference(pair, one_thread):
    """The gradient of nll + 0.01·aux, the f32 router's included."""
    from repro_torch.training.train_loop import value_and_grad

    toks = _tokens(pair["cfg"], seed=1)
    _, g = value_and_grad(pair["model"].loss, pair["params"], {"tokens": torch.as_tensor(toks)})
    rg = _np(jax.grad(lambda p: pair["rmodel"].loss(p, {"tokens": jnp.asarray(toks)})[0])(
        pair["rparams"]))
    for path, t in T.leaves_with_path(g):
        _close(t, T.get_path(rg, path))


def test_apply_block_matches_reference(pair):
    model, rmodel = pair["model"], pair["rmodel"]
    h = np.random.default_rng(3).normal(size=(2, 16, pair["cfg"].d_model)).astype(np.float32)
    pos = np.arange(16)[None, :]
    for i in range(model.num_blocks):
        out = model.apply_block(None, i, model.get_block(pair["params"], i), torch.as_tensor(h),
                                torch.as_tensor(pos))
        rout = rmodel.apply_block(None, i, rmodel.get_block(pair["rparams"], i),
                                  jnp.asarray(h), jnp.asarray(pos))
        _close(out, rout)
        assert R.block_kind(model, i) == ("dense" if i < pair["cfg"].moe_first_dense else "moe")


def test_taps_match_reference(pair):
    """Expert leaves get the dispatched (E, C, d) inputs and their (E, C, ff)
    hidden; the shared experts' the ``shared/…`` keys."""
    model, rmodel, cfg, rcfg = pair["model"], pair["rmodel"], pair["cfg"], pair["rcfg"]
    h = np.random.default_rng(4).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    pos = np.arange(16)[None, :]
    for i in range(model.num_blocks):
        taps = TAPS.taps_for_block(cfg, i, model.num_blocks)(
            model.get_block(pair["params"], i), cfg, torch.as_tensor(h), torch.as_tensor(pos))
        rtaps = RTAPS.taps_for_block(rcfg, i, rmodel.num_blocks)(
            rmodel.get_block(pair["rparams"], i), rcfg, jnp.asarray(h), jnp.asarray(pos))
        assert taps.keys() == rtaps.keys()
        if i >= cfg.moe_first_dense:
            assert {"shared/w_up", "shared/w_down"} <= taps.keys()
            assert taps["w_up"].shape == (cfg.moe_num_experts, MOE.capacity(cfg, 32), cfg.d_model)
        for k in taps:
            _close(taps[k], rtaps[k])


# ---------------------------------------------------------------------------
# the expert-batched masked GEMM's plain version
# ---------------------------------------------------------------------------
def test_batched_plain_and_gradients_match_einsum():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 7, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16, 24)).astype(np.float32)
    m = rng.random((4, 16, 24)) < 0.3
    dy = rng.normal(size=(4, 7, 24)).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = torch.as_tensor(w).requires_grad_(True)
    out = MM.masked_matmul_batched(xt, wt, torch.as_tensor(m))
    out.backward(torch.as_tensor(dy))

    def f(x_, w_):
        return jnp.einsum("ecd,edf->ecf", x_, w_ * m)

    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(dy))
    for got, ref in ((out, want), (xt.grad, gx), (wt.grad, gw)):
        _close(got, ref, rel=1e-6)
    assert bool((wt.grad[~torch.as_tensor(m)] == 0).all())
    # each slab is the 2-D plain version on that slab
    plain = masked_matmul_batched_plain(xt.detach(), wt.detach(), torch.as_tensor(m))
    assert torch.equal(plain, out.detach())


def test_batched_wrappers_refuse_what_they_do_not_take():
    x, w, m = torch.zeros(2, 3, 8), torch.zeros(2, 8, 4), torch.ones(2, 8, 4, dtype=torch.bool)
    with pytest.raises(ValueError):
        MM.masked_matmul_batched(x[0], w[0], m[0])
    with pytest.raises(ValueError):
        MM.masked_matmul_batched(x, w[:1], m[:1])
    with pytest.raises(ValueError):
        MM.masked_matmul_batched_dx(torch.zeros(2, 3, 5), w, m)
    with pytest.raises(ValueError):
        MM.masked_matmul_batched_dw(x, torch.zeros(2, 4, 4), m)
    with pytest.raises(ValueError):
        MM.masked_matmul_batched_dm(x, torch.zeros(2, 3, 5), w)
    # a tuned mask on slabs, refused until mask tuning on MoE was ported,
    # takes its gradient from the batched dM: the reference's autodiff of
    # the masked einsum with respect to the mask
    rng = np.random.default_rng(3)
    xs, ws, dy = (rng.normal(size=s).astype(np.float32) for s in ((2, 3, 8), (2, 8, 4), (2, 3, 4)))
    ms = (rng.random((2, 8, 4)) < 0.5).astype(np.float32)
    mt = torch.tensor(ms, requires_grad=True)
    (gm,) = torch.autograd.grad(MM.masked_matmul_batched(torch.tensor(xs), torch.tensor(ws), mt),
                                mt, torch.tensor(dy))
    _, vjp = jax.vjp(lambda m_: jnp.einsum("eck,ekn->ecn", jnp.asarray(xs), jnp.asarray(ws) * m_),
                     jnp.asarray(ms))
    _close(gm, vjp(jnp.asarray(dy))[0], rel=1e-6)
    with pytest.raises(ValueError):  # mixed devices
        MM.masked_matmul_batched(x, w, m.to("meta"))


def test_batched_launches_are_booked_by_obs():
    """Under a live obs run each batched call is booked under its own name
    with 2·E·C·K·N FLOPs and the bytes of its operands and output."""
    from repro_torch.obs.run import start_run

    x = torch.randn(3, 5, 16, requires_grad=True)
    w = torch.randn(3, 16, 8, requires_grad=True)
    m = torch.rand(3, 16, 8) < 0.5
    run = start_run("moe", device="cpu", console=False)
    MM.masked_matmul_batched(x, w, m).sum().backward()
    summ = run.finish()["metrics"]
    for name in ("masked_matmul_batched", "masked_matmul_batched_dx", "masked_matmul_batched_dw"):
        assert summ[f"kernels/{name}/calls"]["value"] == 1, name
        assert summ[f"kernels/{name}/flops"]["value"] == 2.0 * 3 * 5 * 16 * 8, name
    assert summ["kernels/masked_matmul_batched/bytes"]["value"] == \
        4 * (3 * 5 * 16 + 3 * 16 * 8 + 3 * 5 * 8) + 3 * 16 * 8


# ---------------------------------------------------------------------------
# pruning, EBFT, the pipeline
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pruned(pair):
    cfg = pair["cfg"]
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib = calibration_set(corpus, 16, 32)
    out = {"calib": calib}
    for method, sp in (("wanda", 0.7), ("magnitude", 0.5)):
        scores = {}
        masks, pr = prune(pair["model"], pair["params"], calib, method=method, sparsity=sp,
                          scores_out=scores)
        rmasks, rpr = ref_prune(pair["rmodel"], pair["rparams"], calib, method=method,
                                sparsity=sp)
        out[method] = dict(masks=masks, pruned=pr, rmasks=rmasks, rpruned=rpr, scores=scores,
                           sparsity=sp)
    return out


def _block_of(cfg, path):
    """(group, j) of a stacked leaf's path -> the model's block index i."""
    return lambda j: j if path[0] == "dense_blocks" else j + cfg.moe_first_dense


@pytest.mark.parametrize("method", ["wanda", "magnitude"])
def test_prune_masks_equal_reference(pair, pruned, method):
    r = pruned[method]
    ref = interop.masks_to_torch(_np(r["rmasks"]), "cpu")
    flips = 0
    for path, m in T.leaves_with_path(r["masks"]):
        want = T.get_path(ref, path).expand(m.shape)
        diff = m != want
        if not bool(diff.any()):
            continue
        assert method == "wanda", path  # magnitude reads the weights alone: exact
        for j in range(m.shape[0]):
            if diff[j].any():
                s = r["scores"][(_block_of(pair["cfg"], path)(j), *path[1:])]
                gaps = SP.threshold_gaps(s, r["sparsity"])[diff[j].reshape(s.shape)]
                assert float(gaps.max()) <= TIE_RTOL, path
        flips += int(diff.sum())
    print(f"{pair['arch']} {method}: {flips} near-tie flips")


@pytest.mark.parametrize("method", ["wanda", "magnitude"])
def test_prune_leaves_the_router_and_hits_the_sparsity(pair, pruned, method):
    r = pruned[method]
    router = r["masks"]["moe_blocks"]["moe"]["router"]["w"]
    assert bool(router.all())
    assert torch.equal(r["pruned"]["moe_blocks"]["moe"]["router"]["w"],
                       pair["params"]["moe_blocks"]["moe"]["router"]["w"])
    keep = 1.0 - r["sparsity"]
    for path, m in T.leaves_with_path(r["masks"]):
        if not SP.is_prunable(path, m):
            continue
        mat, _ = SP.to_matrix_stacked(path[-1], m)  # (L, [E,] R, O)
        R_ = mat.shape[-2]
        if method == "wanda":  # every output column of every (layer, expert)
            assert bool((mat.sum(dim=-2) == max(1, round(R_ * keep))).all()), path
        else:  # at least the kept count per (layer, expert) matrix, ties kept
            n = mat.shape[-2] * mat.shape[-1]
            assert bool((mat.sum(dim=(-2, -1)) >= max(1, round(n * keep))).all()), path
        assert bool((T.get_path(r["pruned"], path)[~m] == 0).all()), path
    ref_np = _np(r["rpruned"])
    for path, t in T.leaves_with_path(r["pruned"]):
        mk = T.get_path(r["masks"], path)
        want = T.get_path(ref_np, path)
        if bool(torch.equal(mk, T.get_path(interop.masks_to_torch(_np(r["rmasks"]), "cpu"),
                                           path).expand(mk.shape))):
            np.testing.assert_array_equal(t.numpy(), want, err_msg=str(path))


def test_unported_methods_raise(pair, pruned, monkeypatch, one_thread):
    """FLAP still refuses the family, as the reference's assert does. The
    baselines that refused it until they were ported now agree with the
    reference: SparseGPT's and DSnoT's leaf functions on block 1's routed
    experts, shared experts and attention, mask tuning's final masks and
    LoRA's merge (``leaf_functions_match_reference``); and the driver takes
    ``--baselines dsnot`` on the family, its DSnoT perplexity the library's
    (``test_torch_moe_baselines.py`` holds the driver's baselines and the
    walks to the reference's)."""
    model, params, calib = pair["model"], pair["params"], pruned["calib"]
    with pytest.raises(ValueError, match="FLAP"):
        prune(model, params, calib, method="flap", sparsity=0.2)
    with pytest.raises(AssertionError):  # the reference refuses it too
        ref_prune(pair["rmodel"], pair["rparams"], calib, method="flap", sparsity=0.2)
    assert leaf_functions_match_reference(model, params, pair["rmodel"], pair["rparams"],
                                          calib[:8], pruned["wanda"]["rmasks"],
                                          block=pair["cfg"].moe_first_dense) == 10
    spec = ebft_run.RunSpec(arch=pair["arch"], baselines="dsnot", pretrain_steps=0, epochs=0,
                            calib_samples=8, seq=16)
    res = driver_matches_library(pair["cfg"], params, spec)
    assert set(res.perplexity) == {"dense", "wanda", "EBFT", "DSnoT"}


# lr 1e-3: at the dense tests' 1e-2 tiny_moe's EBFT is chaotic (a router
# top-k on a near-tie flips with the order of a sum, and Adam carries the
# flip far)
ECFG = dict(lr=1e-3, epochs=4, microbatch=8, patience=3)


def test_ebft_matches_reference(pair, pruned, one_thread):
    """Per block: epochs run and early stops equal, the losses (before,
    every epoch, after) within rel 1e-4; the tuned model's perplexity
    within rel 1e-4; the router moves (Adam runs over the whole block)."""
    w, calib = pruned["wanda"], pruned["calib"]
    tuned, reports = EBFT.finetune(pair["model"], pair["params"], w["pruned"], w["masks"], calib,
                                   EBFT.EBFTConfig(**ECFG))
    rtuned, rreports = REBFT.finetune(pair["rmodel"], pair["rparams"], w["rpruned"], w["rmasks"],
                                      calib, REBFT.EBFTConfig(**ECFG))
    assert [r.kind for r in reports] == [r.kind for r in rreports] == \
        ["dense"] + ["moe"] * (pair["cfg"].num_layers - 1)
    for a, b in zip(reports, rreports):
        assert (a.epochs_run, a.early_stop) == (b.epochs_run, b.early_stop)
        for x, y in zip(a.history + [a.loss_after], b.history + [b.loss_after]):
            assert x == pytest.approx(y, rel=PIPE_REL)
    ev = ref_eval_set(RSyntheticCorpus(RCorpusConfig(vocab_size=pair["cfg"].vocab_size)), 8, 32)
    assert perplexity(pair["model"], tuned, ev, masks=w["masks"]) == pytest.approx(
        ref_perplexity(pair["rmodel"], rtuned, ev), rel=PIPE_REL)
    r0 = pair["params"]["moe_blocks"]["moe"]["router"]["w"]
    assert not torch.equal(tuned["moe_blocks"]["moe"]["router"]["w"], r0)
    for path, m in T.leaves_with_path(w["masks"]):
        if SP.is_prunable(path, m):
            assert bool((T.get_path(tuned, path)[~m] == 0).all()), path


def test_ebft_repeats_bit_for_bit(pair, pruned, one_thread):
    w, calib = pruned["wanda"], pruned["calib"][:8]
    runs = [EBFT.finetune(pair["model"], pair["params"], w["pruned"], w["masks"], calib,
                          EBFT.EBFTConfig(**dict(ECFG, epochs=2)))[0] for _ in range(2)]
    for path, t in T.leaves_with_path(runs[0]):
        assert torch.equal(t, T.get_path(runs[1], path)), path


def test_perplexity_reads_the_nll_not_the_loss(pair):
    """The loss carries 0.01·aux; perplexity is exp(nll) alone."""
    toks = _tokens(pair["cfg"], b=3, s=24, seed=5)
    loss, m = pair["model"].loss(pair["params"], {"tokens": torch.as_tensor(toks)})
    ppl = perplexity(pair["model"], pair["params"], toks)
    assert ppl == pytest.approx(float(np.exp(float(m["nll"]))), rel=1e-6)
    assert float(m["aux"]) > 0 and ppl != pytest.approx(float(np.exp(float(loss))), rel=1e-6)
    assert ppl == pytest.approx(ref_perplexity(pair["rmodel"], pair["rparams"], toks), rel=REL)


def test_ebft_run_matches_reference(one_thread):
    """``ebft_run.run`` on tiny_moe (Wanda 0.7, EBFT) against the reference's
    functions on the same weights: the dense, pruned and EBFT perplexities
    within rel 1e-4."""
    spec = ebft_run.RunSpec(arch="tiny_moe", seed=0, seq=32, calib_samples=16, pretrain_steps=0,
                            epochs=3, lr=1e-2)
    rcfg, cfg = _cfgs("tiny_moe")
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(spec.seed))
    corpus = RSyntheticCorpus(RCorpusConfig(vocab_size=cfg.vocab_size, seed=spec.seed))
    calib = ref_calibration_set(corpus, spec.calib_samples, spec.seq)
    ev = ref_eval_set(corpus, ebft_run.EVAL_SAMPLES, spec.seq)
    rmasks, rpruned = ref_prune(rmodel, rparams, calib, method="wanda", sparsity=spec.sparsity)
    rtuned, _ = REBFT.finetune(rmodel, rparams, rpruned, rmasks, calib,
                               REBFT.EBFTConfig(lr=spec.lr, epochs=spec.epochs))
    res = ebft_run.run(cfg, spec, "cpu", params=interop.params_to_torch(_np(rparams), "cpu"))
    assert res.perplexity["dense"] == pytest.approx(ref_perplexity(rmodel, rparams, ev),
                                                    rel=PIPE_REL)
    assert res.perplexity["wanda"] == pytest.approx(ref_perplexity(rmodel, rpruned, ev),
                                                    rel=PIPE_REL)
    assert res.perplexity["EBFT"] == pytest.approx(ref_perplexity(rmodel, rtuned, ev),
                                                   rel=PIPE_REL)
    assert [r.kind for r in res.reports] == ["dense", "moe", "moe"]


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys, one_thread):
    from repro_torch.launch import train

    argv = ["--arch", "tiny_moe", "--batch", "4", "--seq", "32", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--device", "cpu", "--no-obs"]
    first = train.main(argv + ["--steps", "2"])
    again = train.main(argv + ["--steps", "3"])
    assert first.start == 0 and again.start == 2
    assert "resumed from step 2" in capsys.readouterr().out


def test_ebft_run_cli_runs_on_the_cpu(tmp_path, capsys, one_thread):
    out = tmp_path / "bench.json"
    res = ebft_run.main(["--arch", "tiny_moe", "--pretrain-steps", "3", "--batch", "4",
                         "--seq", "32", "--calib-samples", "8", "--epochs", "1",
                         "--device", "cpu", "--bench-out", str(out)])
    assert out.exists() and res.perplexity["EBFT"] > 0
    assert "EBFT ppl" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def _prompts(seed, lengths, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _requests(cls, seed, vocab):
    return [cls(uid=i, prompt=p, max_new=3 + i % 3)
            for i, p in enumerate(_prompts(seed, [10] * 5, vocab))]


@pytest.mark.parametrize("cf", ["default", "E/k+1"])
def test_served_tokens_match_reference(pair, cf):
    """``generate`` and continuous batching (5 requests over 2 slots) token
    for token, at the default capacity (a decode step of 2 slots has
    C = 1: most assignments drop, as in the reference) and at cf = E/k + 1
    (no drops)."""
    kw = {} if cf == "default" else dict(
        moe_capacity_factor=pair["cfg"].moe_num_experts / pair["cfg"].moe_top_k + 1.0)
    rcfg, cfg = _cfgs(pair["arch"], **kw)
    rmodel, model = ref_build(rcfg), build(cfg)
    V = cfg.vocab_size
    prompts = _prompts(1, (12, 12), V)
    out = Server(model, pair["params"], batch_size=2, max_len=48).generate(prompts, max_new=6)
    assert out == RServer(rmodel, pair["rparams"], batch_size=2, max_len=48).generate(
        prompts, max_new=6)
    res = Server(model, pair["params"], batch_size=2, max_len=48).serve(
        _requests(Request, 2, V))
    assert res == RServer(rmodel, pair["rparams"], batch_size=2, max_len=48).serve(
        _requests(RRequest, 2, V))


def test_teacher_forced_decode_equals_forward_without_drops(pair):
    """At cf = E/k + 1 nothing drops, so prefill + decode steps give the
    forward's logits (the reference's tests/test_models.py invariant)."""
    _, cfg = _cfgs(pair["arch"],
                   moe_capacity_factor=pair["cfg"].moe_num_experts / pair["cfg"].moe_top_k + 1)
    model = build(cfg)
    toks = torch.as_tensor(_tokens(cfg, b=2, s=20, seed=7))
    full = model.forward(pair["params"], {"tokens": toks})
    state = model.init_serve_state(2, 24, "cpu")
    assert set(state) == {"dense", "moe", "len"}
    assert state["moe"]["k"].shape == (cfg.num_layers - cfg.moe_first_dense, 2,
                                       cfg.num_kv_heads, 24, cfg.resolved_head_dim)
    logits, state = model.prefill(pair["params"], {"tokens": toks[:, :12]}, state)
    steps = [logits]
    for t in range(12, 20):
        logits, state = model.decode_step(pair["params"], toks[:, t:t + 1], state)
        steps.append(logits)
    assert state["len"] == 20
    got = torch.cat(steps[:-1], dim=1)
    torch.testing.assert_close(got, full[:, 11:19], rtol=1e-4, atol=1e-4)


def test_slot_update_writes_every_cache_group():
    full = MOE.init_cache(get_config("tiny_moe"), 3, 8, "cpu")
    one = MOE.init_cache(get_config("tiny_moe"), 1, 8, "cpu")
    for grp in ("dense", "moe"):
        one[grp]["k"].fill_(1.0)
    one["len"] = 5
    new = {k: _slot_update(full[k], one[k], 1) for k in full}
    assert new["len"] == 5
    for grp in ("dense", "moe"):
        assert bool((new[grp]["k"][:, 1] == 1).all()) and bool((new[grp]["k"][:, 0] == 0).all())


def test_serve_cli_runs_on_the_cpu(capsys):
    res = serve.main(["--arch", "tiny_moe", "--requests", "3", "--slots", "2",
                      "--max-new", "4", "--sparse", "0.5", "--device", "cpu", "--no-obs"])
    assert sorted(res) == [0, 1, 2] and all(len(v) == 4 for v in res.values())
    assert "served 3 requests" in capsys.readouterr().out
