"""The port's VLM family (LLaVA-NeXT: the dense transformer behind a stub
vision frontend) against the JAX reference, on the CPU: tiny_vlm
(LLaVA-NeXT-Mistral-7B's SMOKE: 2 layers, d 64, 4 heads over 2 KV heads,
8 patch positions) through the model, the five pruning methods, EBFT,
mask tuning, LoRA, perplexity, cloze, greedy prefill and decode, and
``launch/train``'s batch. The weights are the reference's ``init``,
carried across with ``interop.params_to_torch``; tokens and patches are
numpy arrays from a seed, the same on both sides.

Stated tolerances (f32, sums taken in another order on each side):
- logits, loss, gradients, each block's output and taps: rel 1e-5;
- masks: equal, bar slots whose score lies within 1e-6 (relative) of its
  comparison group's threshold (Wanda, SparseGPT); DSnoT, FLAP and
  magnitude equal;
- EBFT's per-block losses and the perplexities: rel 1e-4;
- mask tuning: epoch histories within rel 1e-4, masks equal bar slots
  within 1e-5 of the final scores' threshold; LoRA (5 steps from the
  reference's A): merged weights within rel 1e-4;
- cloze accuracy and greedy tokens: equal.
"""
from __future__ import annotations

import dataclasses
import math

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
from repro.launch import rooflines as RROOF
from repro.launch import train as RTRAIN
from repro.models import transformer as RT
from repro.models import vlm as RVLM
from repro.models.model import build as ref_build
from repro.sparsity import taps as RTAPS
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ebft as EBFT
from repro_torch.core import lora as LORA
from repro_torch.core import mask_tuning as MT
from repro_torch.core import reconstruction as R
from repro_torch.core.evaluate import cloze_accuracy, perplexity
from repro_torch.core.masks import expand_masks, prune
from repro_torch.launch import ebft_run, rooflines, serve, train
from repro_torch.models.model import build
from repro_torch.sparsity import sparse_params as SP
from repro_torch.sparsity import taps as TAPS
from repro_torch.training.train_loop import value_and_grad

ARCH = "tiny_vlm"
REL = 1e-5
PIPE_REL = 1e-4
TIE_RTOL = 1e-6
SEQ = 24  # text tokens; with the 8 patch positions a stream of 32
N_CAL = 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=REL):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _patches(n, cfg, seed):
    return np.random.default_rng(seed).normal(
        size=(n, cfg.frontend_len, cfg.d_model)).astype(np.float32)


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
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib = RTOK.calibration_set(corpus, N_CAL, SEQ)
    ev = RTOK.eval_set(corpus, 16, SEQ)
    return dict(rcfg=rcfg, cfg=cfg, rmodel=rmodel, rparams=rparams, model=build(cfg),
                params=interop.params_to_torch(_np(rparams), "cpu"), corpus=corpus,
                calib=calib, ev=ev, calib_x={"patches": _patches(N_CAL, cfg, 1)},
                ev_x={"patches": _patches(16, cfg, 2)})


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "patches": _patches(b, cfg, seed + 100)}


def _tt(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jj(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs, input specs, rooflines, the tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "tiny_vlm"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke)) == \
        dataclasses.asdict(ref_get_config(arch, smoke))


@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "tiny_vlm"])
@pytest.mark.parametrize("seq,batch", [(2048, 8), (64, 2), (8000, 1)])
def test_input_specs_match_reference(arch, seq, batch):
    """P = min(frontend_len, S // 2): LLaVA at seq 2048 takes 1024 patch
    positions and 1024 text tokens."""
    shape = ShapeConfig("s", seq, batch, "train")
    got = build(get_config(arch)).input_specs(shape)
    want = ref_build(ref_get_config(arch)).input_specs(shape)
    assert got.keys() == want.keys() == {"tokens", "patches"}
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    if arch == "llava_next_mistral_7b" and seq == 2048:
        assert got["patches"].shape == (8, 1024, 4096) and got["tokens"].shape == (8, 1024)


@pytest.mark.parametrize("kind,batch,seq", [("train", 8, 2048), ("ebft", 8, 2048),
                                            ("prefill", 8, 512), ("decode", 8, 1)])
def test_model_flops_match_reference(kind, batch, seq):
    shape = ShapeConfig("s", seq, batch, kind)
    want = RROOF.model_flops_per_chip(ref_get_config("llava_next_mistral_7b"), shape, 1)
    assert rooflines.model_flops_per_chip(get_config("llava_next_mistral_7b"), shape, 1) == \
        pytest.approx(want)


def test_tree_is_the_dense_tree(pair):
    """``vlm.init`` is the transformer's: the port's own init, the
    reference's carried across by ``interop`` (unchanged) and the dense
    model's tree share paths, shapes and dtypes."""
    own = pair["model"].init(torch.Generator().manual_seed(0))
    dense = build(pair["cfg"].replace(family="dense")).init(torch.Generator().manual_seed(0))
    key = lambda tree: sorted((p, tuple(t.shape), t.dtype) for p, t in T.leaves_with_path(tree))
    assert key(own) == key(pair["params"]) == key(dense)
    assert pair["params"]["blocks"]["attn"]["wk"].shape[-2] == pair["cfg"].num_kv_heads == 2


# ---------------------------------------------------------------------------
# the model (the tests/test_models.py cases for tiny_vlm, then against the reference)
# ---------------------------------------------------------------------------
def test_forward_loss_shapes_and_finite(pair):
    cfg, model = pair["cfg"], pair["model"]
    b = _tt(_batch(cfg, 2, 32, 0))
    loss, m = model.loss(pair["params"], b)
    assert loss.shape == () and bool(torch.isfinite(loss)) and set(m) == {"nll"}
    logits = model.forward(pair["params"], b)
    assert logits.shape == (2, 32, cfg.padded_vocab) and bool(torch.isfinite(logits).all())


def test_block_api_roundtrip(pair):
    model = pair["model"]
    params = T.tree_map(torch.clone, pair["params"])
    bp0 = T.tree_map(torch.clone, model.get_block(params, 0))
    model.set_block(params, 0, T.tree_map(lambda a: a * 0.5, bp0))
    for path, t in T.leaves_with_path(model.get_block(params, 0)):
        torch.testing.assert_close(t, T.get_path(bp0, path) * 0.5, rtol=1e-6, atol=0)
    for path, t in T.leaves_with_path(model.get_block(params, 1)):
        assert torch.equal(t, T.get_path(model.get_block(pair["params"], 1), path))


def test_blockwise_apply_equals_forward(pair):
    """embed -> apply_block (x L) -> finalize reproduces forward on the text
    positions; the stream covers [patches ; text]."""
    model, params = pair["model"], pair["params"]
    b = _tt(_batch(pair["cfg"], 2, 20, 1))
    h, pos = model.embed_tokens(params, b)
    for i in range(model.num_blocks):
        h = model.apply_block(params, i, model.get_block(params, i), h, pos)
    full = model.finalize(params, h)
    P = b["patches"].shape[1]
    assert full.shape[1] == P + 20
    torch.testing.assert_close(full[:, P:], model.forward(params, b), rtol=2e-4, atol=2e-4)


def test_vlm_concatenates_patches_before_tokens(pair):
    """The stream is [patches ; token embeddings] at positions 0 .. P + S - 1,
    as the reference's ``embed_tokens``."""
    model, params, cfg = pair["model"], pair["params"], pair["cfg"]
    raw = _batch(cfg, 2, 12, 2)
    h, pos = model.embed_tokens(params, _tt(raw))
    P = raw["patches"].shape[1]
    assert h.shape == (2, P + 12, cfg.d_model)
    assert torch.equal(h[:, :P], torch.as_tensor(raw["patches"]))
    assert torch.equal(pos, torch.arange(P + 12)[None, :])
    rh, rpos = pair["rmodel"].embed_tokens(pair["rparams"], _jj(raw))
    _close(h, rh, rel=0)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))


def test_forward_and_loss_match_reference(pair):
    raw = _batch(pair["cfg"], 2, 40, 3)
    loss, _ = pair["model"].loss(pair["params"], _tt(raw))
    rloss, rlogits = jax.jit(lambda p, b: (pair["rmodel"].loss(p, b)[0],
                                           pair["rmodel"].forward(p, b)))(
        pair["rparams"], _jj(raw))
    _close(loss, rloss)
    logits = pair["model"].forward(pair["params"], _tt(raw))
    assert logits.shape[1] == 40  # text positions only
    _close(logits, rlogits)


def test_loss_gradients_match_reference(pair, one_thread):
    raw = _batch(pair["cfg"], 2, 16, 4)
    _, g = value_and_grad(pair["model"].loss, pair["params"], _tt(raw))
    rg = _np(jax.jit(jax.grad(lambda p: pair["rmodel"].loss(p, _jj(raw))[0]))(pair["rparams"]))
    for path, t in T.leaves_with_path(g):
        _close(t, T.get_path(rg, path))


def test_blocks_plan_and_taps_match_reference(pair):
    """One segment visiting every block; block kind, tap dispatch (the
    dense taps), each block's output and taps as the reference's."""
    model, rmodel, cfg, rcfg = pair["model"], pair["rmodel"], pair["cfg"], pair["rcfg"]
    assert [s.visits for s in R.execution_plan(model)] == [[(0, 0), (1, 0)]]
    h = np.random.default_rng(5).normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    pos = np.arange(32)[None, :]
    for i in range(model.num_blocks):
        assert R.block_kind(model, i) == "block"
        fn = TAPS.taps_for_block(cfg, i, model.num_blocks)
        assert fn is TAPS.dense_taps
        bp, rbp = model.get_block(pair["params"], i), rmodel.get_block(pair["rparams"], i)
        _close(model.apply_block(None, i, bp, torch.as_tensor(h), torch.as_tensor(pos)),
               jax.jit(lambda b, h_: rmodel.apply_block(None, i, b, h_, jnp.asarray(pos)))(
                   rbp, jnp.asarray(h)))
        rfn = RTAPS.taps_for_block(rcfg, i, rmodel.num_blocks)
        taps = fn(bp, cfg, torch.as_tensor(h), torch.as_tensor(pos))
        rtaps = jax.jit(lambda b, h_: rfn(b, rcfg, h_, jnp.asarray(pos)))(rbp, jnp.asarray(h))
        assert taps.keys() == rtaps.keys()
        for k in taps:
            _close(taps[k], rtaps[k])


# ---------------------------------------------------------------------------
# pruning: the five methods with the calibration patches
# ---------------------------------------------------------------------------
PRUNES = [("magnitude", 0.5, None), ("wanda", 0.7, None), ("sparsegpt", 0.5, None),
          ("dsnot", 0.6, None), ("flap", 0.3, None), ("wanda", 0.5, (2, 4))]


def _prunable(masks):
    return {p: m for p, m in T.leaves_with_path(masks) if SP.is_prunable(p, m)}


@pytest.mark.parametrize("method,sparsity,pattern", PRUNES,
                         ids=[f"{m}-{'2:4' if p else s}" for m, s, p in PRUNES])
def test_prune_matches_reference(pair, method, sparsity, pattern, one_thread):
    """Every method's masks and pruned weights as the reference's, both
    walks fed the same calibration patches (``extra_batch``)."""
    scores = {}
    masks, pruned = prune(pair["model"], pair["params"], pair["calib"], method=method,
                          sparsity=sparsity, pattern=pattern, extra_batch=pair["calib_x"],
                          scores_out=scores)
    rmasks, rpruned = ref_prune(pair["rmodel"], pair["rparams"], pair["calib"], method=method,
                                sparsity=sparsity, pattern=pattern,
                                extra_batch=pair["calib_x"])
    ref = _prunable(expand_masks(pair["params"], interop.masks_to_torch(_np(rmasks), "cpu")))
    port = _prunable(masks)
    assert ref.keys() == port.keys()
    flips = 0
    for path, m in port.items():
        diff = m != ref[path]
        for i in range(m.shape[0]):
            d = diff[i]
            if d.any():
                assert method in ("wanda", "sparsegpt"), (path, i)
                gaps = SP.threshold_gaps(scores[(i, *path[1:])], sparsity, pattern)
                assert float(gaps[SP.to_matrix(path[-1], d)[0]].max()) <= TIE_RTOL, (path, i)
                flips += int(d.sum())
        assert bool((T.get_path(pruned, path)[~m] == 0).all()), path
    for path, w in T.leaves_with_path(pruned):
        if flips == 0:
            assert _rel(w.numpy(), T.get_path(_np(rpruned), path)) <= REL, path
    assert 0 < sum(int((~m).sum()) for m in port.values())


def test_patches_reach_the_walk(pair):
    """Wanda's scores read the stream over the patches: other patches give
    other masks."""
    other = {"patches": _patches(N_CAL, pair["cfg"], 7)}
    a, _ = prune(pair["model"], pair["params"], pair["calib"], method="wanda", sparsity=0.7,
                 extra_batch=pair["calib_x"])
    b, _ = prune(pair["model"], pair["params"], pair["calib"], method="wanda", sparsity=0.7,
                 extra_batch=other)
    assert any(not torch.equal(m, T.get_path(b, p)) for p, m in _prunable(a).items())


# ---------------------------------------------------------------------------
# EBFT, perplexity, cloze
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def wanda(pair):
    rmasks, rpruned = ref_prune(pair["rmodel"], pair["rparams"], pair["calib"], method="wanda",
                                sparsity=0.7, extra_batch=pair["calib_x"])
    params = pair["params"]
    return dict(rmasks=rmasks, rpruned=rpruned,
                masks=expand_masks(params, interop.masks_to_torch(_np(rmasks), "cpu")),
                pruned=interop.params_to_torch(_np(rpruned), "cpu"))


def test_ebft_matches_reference(pair, wanda, one_thread):
    """From the reference's Wanda masks and pruned weights, both walks fed
    the same calibration patches: each block's losses, epochs and early
    stop, and the tuned perplexity on the evaluation patches."""
    ecfg = dict(lr=1e-2, epochs=4, microbatch=8, patience=2)
    rtuned, rreports = REBFT.finetune(pair["rmodel"], pair["rparams"], wanda["rpruned"],
                                      wanda["rmasks"], pair["calib"], REBFT.EBFTConfig(**ecfg),
                                      extra_batch=pair["calib_x"])
    tuned, reports = EBFT.finetune(pair["model"], pair["params"], wanda["pruned"],
                                   wanda["masks"], pair["calib"], EBFT.EBFTConfig(**ecfg),
                                   extra_batch=pair["calib_x"])
    assert [(r.index, r.kind) for r in reports] == [(r.index, r.kind) for r in rreports]
    for a, b in zip(reports, rreports):
        assert (a.epochs_run, a.early_stop) == (b.epochs_run, b.early_stop), a.index
        for x, y in zip(a.history + [a.loss_before, a.loss_after],
                        b.history + [b.loss_before, b.loss_after]):
            assert x == pytest.approx(y, rel=PIPE_REL), a.index
        assert a.loss_after < a.loss_before
    ppl = perplexity(pair["model"], tuned, pair["ev"], extra_batch=pair["ev_x"],
                     masks=wanda["masks"])
    assert ppl == pytest.approx(ref_perplexity(pair["rmodel"], rtuned, pair["ev"],
                                               extra_batch=pair["ev_x"]), rel=PIPE_REL)


def test_perplexity_and_cloze_match_reference(pair, wanda):
    """Dense and pruned perplexity (the pruned one through the masked
    linears), and the cloze accuracy, with the patches sliced per
    microbatch as the reference's (12 rows: a last microbatch of 4)."""
    model, ev, x = pair["model"], pair["ev"][:12], {"patches": pair["ev_x"]["patches"][:12]}
    for params, rparams, masks in ((pair["params"], pair["rparams"], None),
                                   (wanda["pruned"], wanda["rpruned"], wanda["masks"])):
        got = perplexity(model, params, ev, extra_batch=x, masks=masks)
        assert got == pytest.approx(ref_perplexity(pair["rmodel"], rparams, ev, extra_batch=x),
                                    rel=PIPE_REL)
    ctx, t, d = RTOK.cloze_task(pair["corpus"], 20, SEQ)
    cx = {"patches": _patches(20, pair["cfg"], 3)}
    for params, rparams, masks in ((pair["params"], pair["rparams"], None),
                                   (wanda["pruned"], wanda["rpruned"], wanda["masks"])):
        assert cloze_accuracy(model, params, ctx, t, d, extra_batch=cx, masks=masks) == \
            ref_cloze(pair["rmodel"], rparams, ctx, t, d, extra_batch=cx)
    assert perplexity(model, pair["params"], ev, extra_batch=x) != \
        perplexity(model, pair["params"], ev, extra_batch={"patches": x["patches"] * 0})


# ---------------------------------------------------------------------------
# mask tuning, LoRA
# ---------------------------------------------------------------------------
def test_finetune_masks_matches_reference(pair, wanda, monkeypatch, one_thread):
    """Epoch histories within rel 1e-4; tuned masks equal bar slots within
    1e-5 of the port's final scores' threshold; the weights the dense ones
    under the tuned masks."""
    ecfg = dict(lr=2e-2, epochs=6, microbatch=8, patience=2)
    seen = []
    orig = RMT.plateau_early_stop

    def spy(history, *a, **kw):
        if len(history) == 1:
            seen.append(None)
        seen[-1] = list(history)
        return orig(history, *a, **kw)

    monkeypatch.setattr(RMT, "plateau_early_stop", spy)
    _, rmasks = RMT.finetune_masks(pair["rmodel"], pair["rparams"], wanda["rmasks"], 0.7,
                                   pair["calib"], REBFT.EBFTConfig(**ecfg),
                                   extra_batch=pair["calib_x"])
    hist, scores = [], {}
    mt, masks = MT.finetune_masks(pair["model"], pair["params"], wanda["masks"], 0.7,
                                  pair["calib"], MT.EBFTConfig(**ecfg),
                                  extra_batch=pair["calib_x"], histories=hist,
                                  scores_out=scores)
    assert len(hist) == len(seen) == 2
    for a, b in zip(hist, seen):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, rtol=PIPE_REL)
    assert hist[0][-1] < hist[0][0]
    ref = _prunable(expand_masks(pair["params"], interop.masks_to_torch(_np(rmasks), "cpu")))
    for path, m in _prunable(masks).items():
        diff = m != ref[path]
        for i in range(m.shape[0]):
            d = SP.to_matrix(path[-1], diff[i])[0]
            if d.any():
                gaps = SP.threshold_gaps(scores[(i, *path[1:])], 0.7)
                assert float(gaps[d].max()) <= 1e-5, (path, i)
        assert torch.equal(T.get_path(mt, path), T.get_path(pair["params"], path) * m)
    assert not torch.equal(masks["blocks"]["mlp"]["w_up"], wanda["masks"]["blocks"]["mlp"]["w_up"])


def test_finetune_lora_matches_reference(pair, wanda, one_thread):
    """5 steps from the reference's adapter init, each step's patches from
    ``extra_batch_fn(step)``: merged weights within rel 1e-4, pruned slots 0."""
    steps = 5
    rl = RLORA.LoRAConfig(steps=steps, lr=1e-3)
    fn = lambda s: {"patches": _patches(4, pair["cfg"], 50 + s)}
    want = RLORA.finetune_lora(pair["rmodel"], wanda["rpruned"], wanda["rmasks"],
                               RTOK.corpus_iterator(pair["corpus"], batch=4, seq_len=SEQ, seed=9),
                               rl, extra_batch_fn=fn)
    init = interop.lora_to_torch(_np(RLORA.init_lora(wanda["rpruned"], rl)), "cpu")
    losses = []
    got = LORA.finetune_lora(pair["model"], wanda["pruned"], wanda["masks"],
                             RTOK.corpus_iterator(pair["corpus"], batch=4, seq_len=SEQ, seed=9),
                             LORA.LoRAConfig(steps=steps, lr=1e-3), extra_batch_fn=fn,
                             lora=init, losses=losses)
    assert len(losses) == steps and all(math.isfinite(float(v)) for v in losses)
    moved = 0
    for path, w in T.leaves_with_path(got):
        ref_w = np.asarray(T.get_path(want, path))
        assert _rel(w.numpy(), ref_w) <= PIPE_REL, path
        if SP.is_prunable(path, w):
            assert bool((w[~T.get_path(wanda["masks"], path)] == 0).all())
            moved += int(not np.array_equal(w.numpy(), T.get_path(wanda["pruned"], path).numpy()))
    assert moved == 7


# ---------------------------------------------------------------------------
# serving: the multimodal prefill, then the transformer's decode
# ---------------------------------------------------------------------------
def test_prefill_decode_matches_forward(pair):
    """prefill_multimodal of [patches ; text[:-1]] gives forward's logits at
    the second-to-last text position, one decode step its last."""
    model, params, cfg = pair["model"], pair["params"], pair["cfg"]
    b = _tt(_batch(cfg, 2, 16, 6))
    full = model.forward(params, b)
    state = model.init_serve_state(2, 32, "cpu")
    lp, state = model.prefill(params, {"tokens": b["tokens"][:, :-1], "patches": b["patches"]},
                              state)
    assert state["len"] == cfg.frontend_len + 15
    torch.testing.assert_close(lp[:, -1], full[:, -2], rtol=2e-4, atol=2e-4)
    ld, state = model.decode_step(params, b["tokens"][:, -1:], state)
    torch.testing.assert_close(ld[:, -1], full[:, -1], rtol=2e-4, atol=2e-4)


def test_greedy_decode_matches_reference(pair, wanda):
    """Greedy prefill_multimodal + 8 decode steps, token for token against
    the reference's ``vlm.prefill_multimodal`` and ``decode_step``, on the
    dense and the Wanda weights."""
    cfg, rcfg, model = pair["cfg"], pair["rcfg"], pair["model"]
    raw = _batch(cfg, 3, 10, 7)
    for params, rparams in ((pair["params"], pair["rparams"]),
                            (wanda["pruned"], wanda["rpruned"])):
        state = model.init_serve_state(3, 40, "cpu")
        logits, state = model.prefill(params, _tt(raw), state)
        rcache = RT.init_cache(rcfg, 3, 40)
        rlogits, rcache = jax.jit(lambda p, t, x, c: RVLM.prefill_multimodal(p, rcfg, t, x, c))(
            rparams, jnp.asarray(raw["tokens"]), jnp.asarray(raw["patches"]), rcache)
        _close(logits, rlogits)
        rstep = jax.jit(lambda p, t, c: RVLM.decode_step(p, rcfg, t, c))
        got, want = [], []
        for _ in range(8):
            tok = logits[:, -1].argmax(-1)
            rtok = jnp.argmax(rlogits[:, -1], -1)
            got.append(tok.tolist())
            want.append(np.asarray(rtok).tolist())
            logits, state = model.decode_step(params, tok[:, None], state)
            rlogits, rcache = rstep(rparams, rtok[:, None].astype(jnp.int32), rcache)
        assert got == want
        assert state["len"] == int(rcache["len"]) == cfg.frontend_len + 10 + 8


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
def _data_fn(module, monkeypatch, argv_or_call):
    """The ``data_fn`` a launcher hands its ``Trainer``."""
    class Stop(Exception):
        pass

    got = {}

    def trainer(step_fn, data_fn, **kw):
        got["fn"] = data_fn
        raise Stop

    monkeypatch.setattr(module, "Trainer", trainer)
    with pytest.raises(Stop):
        argv_or_call()
    return got["fn"]


def test_train_batch_matches_reference(monkeypatch):
    """``launch/train``'s VLM batch: the step's tokens cut to seq - P, then
    the patches from the same generator, as the reference's ``data_fn``."""
    ref_fn = _data_fn(RTRAIN, monkeypatch, lambda: RTRAIN.main(
        ["--arch", ARCH, "--steps", "2", "--batch", "3", "--seq", "32", "--seed", "5",
         "--no-obs"]))
    fn = _data_fn(train, monkeypatch, lambda: train.run(
        get_config(ARCH), train.TrainSpec(arch=ARCH, steps=2, batch=3, seq=32, seed=5,
                                          no_obs=True), "cpu"))
    for step in (0, 7):
        got, want = fn(step), ref_fn(step)
        assert got.keys() == want.keys() == {"tokens", "patches"}
        assert tuple(got["tokens"].shape) == (3, 24) and tuple(got["patches"].shape) == (3, 8, 64)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_launcher_runs_vlm_on_the_cpu(capsys, one_thread):
    res = train.main(["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "32",
                      "--device", "cpu", "--no-obs"])
    assert len(res.history) == 1 and math.isfinite(res.history[0][1])
    assert "3 steps in" in capsys.readouterr().out


@pytest.mark.parametrize("driver", ["ebft_run", "ebft_run.run", "serve"])
def test_drivers_refuse_vlm(driver):
    """The reference's drivers pass the tokens alone (its ``--arch
    tiny_vlm`` stops at the missing patches); the port's refuse the family
    before any work, naming the library calls that run it."""
    calls = {"ebft_run": lambda: ebft_run.main(["--arch", ARCH, "--device", "cpu"]),
             "ebft_run.run": lambda: ebft_run.run(get_config(ARCH), ebft_run.RunSpec(arch=ARCH),
                                                  "cpu"),
             "serve": lambda: serve.main(["--arch", ARCH, "--device", "cpu"])}
    with pytest.raises(NotImplementedError, match="extra_batch.*prefill_multimodal"):
        calls[driver]()
