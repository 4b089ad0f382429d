"""The port's encoder-decoder family (Seamless-M4T-medium's text stack
behind a stub audio frontend) against the JAX reference, on the CPU:
tiny_encdec (Seamless's SMOKE: 2 encoder + 2 decoder layers, d 64, 4
heads x 16, d_ff 128, vocab 512, GELU, LayerNorm) at S = 64 decoder tokens
and F = 8 frames, through the model, the encoder, the taps, the
calibration walk's memory rule, the pruning methods, EBFT, mask tuning,
LoRA, perplexity, cloze, cached prefill and decode, ``launch/train``'s
batch and the rooflines. The weights are the reference's ``init``,
carried across with ``interop.params_to_torch``; tokens and frames are
numpy arrays from a seed, the same on both sides.

Stated tolerances (f32, sums taken in another order on each side):
- logits, loss, gradients, the memory, each block's output and taps:
  rel 1e-5;
- masks: equal, bar slots whose score lies within 1e-6 (relative) of its
  comparison group's threshold (Wanda, SparseGPT); DSnoT and magnitude
  equal;
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
from repro.models import encdec as RED
from repro.models.model import build as ref_build
from repro.sparsity import taps as RTAPS
from repro.sparsity.sparse_params import apply_masks as ref_apply_masks
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
from repro_torch.core.pruning import common as C
from repro_torch.launch import ebft_run, rooflines, serve, train
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models.model import build
from repro_torch.sparsity import sparse_params as SP
from repro_torch.sparsity import taps as TAPS
from repro_torch.training.train_loop import value_and_grad

from _torch_threads import one_thread_module  # noqa: F401

ARCH = "tiny_encdec"
REL = 1e-5
PIPE_REL = 1e-4
TIE_RTOL = 1e-6
SEQ = 64  # decoder tokens; F = max(frontend_len, SEQ // 8) = 8 frames
F = 8
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


def _frames(n, cfg, seed, f=F):
    return np.random.default_rng(seed).normal(size=(n, f, cfg.d_model)).astype(np.float32)


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
                calib=calib, ev=ev, calib_x={"frames": _frames(N_CAL, cfg, 1)},
                ev_x={"frames": _frames(16, cfg, 2)})


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "frames": _frames(b, cfg, seed + 100, max(cfg.frontend_len, s // 8))}


def _tt(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jj(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _stream(cfg, seed, s=SEQ):
    return np.random.default_rng(seed).normal(size=(2, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# configs, input specs, rooflines, the tree
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "tiny_encdec"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(arch, smoke):
    cfg, rcfg = get_config(arch, smoke), ref_get_config(arch, smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()


def test_seamless_widths_and_parameter_count():
    """Seamless-M4T-medium at its published widths: a tree of about 0.88 B
    parameters, 2 x 262.4 M of them the embedding and the head, 12.6 M an
    encoder block and 16.8 M a decoder block."""
    cfg = get_config("seamless_m4t_medium")
    assert (cfg.enc_layers, cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff) == \
        (12, 12, 1024, 16, 4096)
    assert cfg.padded_vocab == 256256 and cfg.frontend_len == 0
    params = build(cfg.replace(enc_layers=1, num_layers=1, vocab_size=512)).init(
        torch.Generator().manual_seed(0))
    per_enc = sum(t.numel() for _, t in T.leaves_with_path(params["enc_blocks"]))
    per_dec = sum(t.numel() for _, t in T.leaves_with_path(params["dec_blocks"]))
    embed = 2 * cfg.padded_vocab * cfg.d_model
    total = embed + 12 * per_enc + 12 * per_dec + 4 * cfg.d_model
    # the config's formula counts the norms' vectors as the reference's does,
    # not leaf for leaf: within 1e-4 of the tree
    assert abs(total - cfg.param_count()) < 1e-4 * total
    assert 0.87e9 < total < 0.89e9 and round(per_enc / 1e5) == 126 and round(per_dec / 1e5) == 168


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "tiny_encdec"])
@pytest.mark.parametrize("seq,batch", [(2048, 8), (64, 2), (100, 1)])
def test_input_specs_match_reference(arch, seq, batch):
    """F = max(frontend_len, S // 8): Seamless at seq 2048 takes 256 frames."""
    shape = ShapeConfig("s", seq, batch, "train")
    got = build(get_config(arch)).input_specs(shape)
    want = ref_build(ref_get_config(arch)).input_specs(shape)
    assert got.keys() == want.keys() == {"tokens", "frames"}
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    if arch == "seamless_m4t_medium" and seq == 2048:
        assert got["frames"].shape == (8, 256, 1024) and got["tokens"].shape == (8, 2048)


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "tiny_encdec"])
@pytest.mark.parametrize("kind,batch,seq,chips", [("train", 8, 2048, 1), ("ebft", 8, 2048, 1),
                                                  ("prefill", 8, 512, 4), ("decode", 8, 1, 1)])
def test_model_flops_match_reference(arch, kind, batch, seq, chips):
    """The encoder's parameters see 8x fewer tokens than the decoder's."""
    shape = ShapeConfig("s", seq, batch, kind)
    assert rooflines.model_flops_per_chip(get_config(arch), shape, chips) == \
        RROOF.model_flops_per_chip(ref_get_config(arch), shape, chips)


def test_tree_round_trips_through_interop(pair):
    """The reference's tree crosses unchanged: the same paths, shapes and
    dtypes as the port's own init, and back to numpy bit for bit."""
    own = pair["model"].init(torch.Generator().manual_seed(0))
    key = lambda tree: sorted((p, tuple(t.shape), t.dtype) for p, t in T.leaves_with_path(tree))
    assert key(own) == key(pair["params"])
    paths = {p[:2] for p, _ in T.leaves_with_path(own)}
    assert {("dec_blocks", "ln_x"), ("dec_blocks", "xattn"), ("enc_norm", "w"),
            ("enc_norm", "b"), ("head", "w")} <= paths
    back = interop.params_to_numpy(pair["params"])
    for path, a in T.leaves_with_path(_np(pair["rparams"])):
        np.testing.assert_array_equal(T.get_path(back, path), a)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
def test_forward_loss_shapes_and_finite(pair):
    cfg, model = pair["cfg"], pair["model"]
    b = _tt(_batch(cfg, 2, 32, 0))
    loss, m = model.loss(pair["params"], b)
    assert loss.shape == () and bool(torch.isfinite(loss)) and set(m) == {"nll"}
    logits = model.forward(pair["params"], b)
    assert logits.shape == (2, 32, cfg.padded_vocab) and bool(torch.isfinite(logits).all())


def test_encode_matches_reference(pair):
    frames = _frames(2, pair["cfg"], 3)
    got = ED.encode(pair["params"], pair["cfg"], torch.as_tensor(frames))
    want = jax.jit(lambda p, f: RED.encode(p, pair["rcfg"], f))(pair["rparams"],
                                                                jnp.asarray(frames))
    assert got.shape == (2, F, pair["cfg"].d_model)
    _close(got, want)


def test_forward_and_loss_match_reference(pair):
    raw = _batch(pair["cfg"], 2, SEQ, 3)
    loss, _ = pair["model"].loss(pair["params"], _tt(raw))
    rloss, rlogits = jax.jit(lambda p, b: (pair["rmodel"].loss(p, b)[0],
                                           pair["rmodel"].forward(p, b)))(
        pair["rparams"], _jj(raw))
    _close(loss, rloss)
    _close(pair["model"].forward(pair["params"], _tt(raw)), rlogits)


def test_loss_gradients_match_reference(pair):
    """The gradient with respect to every leaf, the encoder's included."""
    raw = _batch(pair["cfg"], 2, 32, 4)
    _, g = value_and_grad(pair["model"].loss, pair["params"], _tt(raw))
    rg = _np(jax.jit(jax.grad(lambda p: pair["rmodel"].loss(p, _jj(raw))[0]))(pair["rparams"]))
    n = 0
    for path, t in T.leaves_with_path(g):
        _close(t, T.get_path(rg, path))
        n += 1
    assert n == len(jax.tree.leaves(rg))


def test_block_api_roundtrip(pair):
    """Encoder blocks take indices [0, 2), decoder blocks [2, 4)."""
    model = pair["model"]
    params = T.tree_map(torch.clone, pair["params"])
    assert model.num_blocks == 4
    for i in (1, 2):
        bp = T.tree_map(torch.clone, model.get_block(params, i))
        model.set_block(params, i, T.tree_map(lambda a: a * 0.5, bp))
        for path, t in T.leaves_with_path(model.get_block(params, i)):
            torch.testing.assert_close(t, T.get_path(bp, path) * 0.5, rtol=1e-6, atol=0)
    assert "xattn" in model.get_block(params, 2) and "xattn" not in model.get_block(params, 1)
    torch.testing.assert_close(params["enc_blocks"]["attn"]["wq"][1],
                               pair["params"]["enc_blocks"]["attn"]["wq"][1] * 0.5)
    torch.testing.assert_close(params["dec_blocks"]["attn"]["wq"][0],
                               pair["params"]["dec_blocks"]["attn"]["wq"][0] * 0.5)
    for i in (0, 3):
        for path, t in T.leaves_with_path(model.get_block(params, i)):
            assert torch.equal(t, T.get_path(model.get_block(pair["params"], i), path))


def test_blockwise_apply_equals_forward(pair):
    """frames -> encoder blocks -> enc_norm is the memory; embed ->
    decoder blocks (memory=) -> finalize reproduces forward."""
    model, params, cfg = pair["model"], pair["params"], pair["cfg"]
    b = _tt(_batch(cfg, 2, 32, 1))
    h = b["frames"]
    fpos = torch.arange(h.shape[1])[None, :]
    for i in range(cfg.enc_layers):
        h = model.apply_block(params, i, model.get_block(params, i), h, fpos)
    memory = L.apply_norm(params["enc_norm"], h, cfg.norm)
    torch.testing.assert_close(memory, ED.encode(params, cfg, b["frames"]), rtol=0, atol=0)
    h, pos = model.embed_tokens(params, b)
    for i in range(cfg.enc_layers, model.num_blocks):
        h = model.apply_block(params, i, model.get_block(params, i), h, pos, memory=memory)
    torch.testing.assert_close(model.finalize(params, h), model.forward(params, b),
                               rtol=2e-4, atol=2e-4)


def test_blocks_plan_kinds_and_taps_match_reference(pair):
    """Two segments (encoder, decoder); block kinds "enc" and "dec"; every
    block's output (the decoder's with memory=) and both tap functions as
    the reference's."""
    model, rmodel, cfg, rcfg = pair["model"], pair["rmodel"], pair["cfg"], pair["rcfg"]
    segs = R.execution_plan(model)
    assert [s.visits for s in segs] == [[(0, 0), (1, 0)], [(2, 0), (3, 0)]]
    assert segs[0].aux is None and segs[1].aux is not None
    h = _stream(cfg, 5)
    pos = np.arange(SEQ)[None, :]
    mem = _frames(2, cfg, 6)
    for i in range(model.num_blocks):
        enc = i < cfg.enc_layers
        assert R.block_kind(model, i) == ("enc" if enc else "dec")
        fn = TAPS.taps_for_block(cfg, i, model.num_blocks)
        assert fn is (TAPS.encdec_enc_taps if enc else TAPS.encdec_dec_taps)
        aux, raux = ({}, {}) if enc else ({"memory": torch.as_tensor(mem)},
                                          {"memory": jnp.asarray(mem)})
        bp, rbp = model.get_block(pair["params"], i), rmodel.get_block(pair["rparams"], i)
        _close(model.apply_block(None, i, bp, torch.as_tensor(h), torch.as_tensor(pos), **aux),
               jax.jit(lambda b, h_, a: rmodel.apply_block(None, i, b, h_, jnp.asarray(pos),
                                                           **a))(rbp, jnp.asarray(h), raux))
        rfn = RTAPS.taps_for_block(rcfg, i, rmodel.num_blocks)
        taps = fn(bp, cfg, torch.as_tensor(h), torch.as_tensor(pos), **aux)
        rtaps = jax.jit(lambda b, h_, a: rfn(b, rcfg, h_, jnp.asarray(pos), **a))(
            rbp, jnp.asarray(h), raux)
        assert taps.keys() == rtaps.keys()
        for k in taps:
            _close(taps[k], rtaps[k])
        if not enc:
            assert taps["xattn/wk"].shape == (2 * F, cfg.d_model)
            torch.testing.assert_close(taps["xattn/wv"], torch.as_tensor(mem).reshape(-1, 64),
                                       rtol=0, atol=0)


def test_masked_blocks_match_reference(pair):
    """Each block with Wanda-like random masks passed beside its weights
    (every masked linear, the two memory projections too, through the
    masked matmul) against the reference's ``apply_masks`` + ``apply_block``."""
    model, rmodel, cfg = pair["model"], pair["rmodel"], pair["cfg"]
    rng = np.random.default_rng(8)
    h, pos, mem = _stream(cfg, 9), np.arange(SEQ)[None, :], _frames(2, cfg, 10)
    for i in range(model.num_blocks):
        bp, rbp = model.get_block(pair["params"], i), rmodel.get_block(pair["rparams"], i)
        mb = T.map_with_path(lambda p, w: torch.as_tensor(rng.random(tuple(w.shape)) > 0.6)
                             if SP.is_prunable(p, w) else torch.ones((), dtype=torch.bool), bp)
        rmb = T.tree_map(lambda m: jnp.asarray(m.numpy().astype(np.float32)), mb)
        aux, raux = ({}, {}) if i < cfg.enc_layers else (
            {"memory": torch.as_tensor(mem)}, {"memory": jnp.asarray(mem)})
        got = model.apply_block(None, i, bp, torch.as_tensor(h), torch.as_tensor(pos), mb, **aux)
        want = jax.jit(lambda b, m, h_, a: rmodel.apply_block(
            None, i, ref_apply_masks(b, m), h_, jnp.asarray(pos), **a))(
            rbp, rmb, jnp.asarray(h), raux)
        _close(got, want)
        dense = model.apply_block(None, i, bp, torch.as_tensor(h), torch.as_tensor(pos), **aux)
        assert _rel(got.numpy(), dense.numpy()) > 1e-2


def test_encoder_wo_tap_has_no_rope(pair, monkeypatch):
    """The encoder's ``wo`` tap is the reference's, taken from q and k
    without RoPE, so it differs from the attention output that the
    encoder's forward (RoPE applied) feeds to ``wo``."""
    model, rmodel, cfg, rcfg = pair["model"], pair["rmodel"], pair["cfg"], pair["rcfg"]
    h, pos = _stream(cfg, 11, F), np.arange(F)[None, :]
    bp = model.get_block(pair["params"], 0)
    tap = TAPS.encdec_enc_taps(bp, cfg, torch.as_tensor(h), torch.as_tensor(pos))["wo"]
    rtap = RTAPS.encdec_enc_taps(rmodel.get_block(pair["rparams"], 0), rcfg, jnp.asarray(h),
                                 jnp.asarray(pos))["wo"]
    _close(tap, rtap)
    seen = []
    orig = L.out_proj

    def spy(p, o, masks=None):
        seen.append(o.reshape(-1, o.shape[-2] * o.shape[-1]))
        return orig(p, o, masks)

    monkeypatch.setattr(L, "out_proj", spy)
    ED.enc_block_apply(bp, cfg, torch.as_tensor(h), torch.as_tensor(pos))
    (fwd,) = seen
    assert _rel(tap.numpy(), fwd.numpy()) > 1e-2


# ---------------------------------------------------------------------------
# the walk's memory rule, pruning
# ---------------------------------------------------------------------------
def test_single_stream_walk_reads_the_dense_encoders_memory(pair, monkeypatch):
    """The pruning walk hands every decoder visit the memory of the dense
    encoder (the reference's list walk takes its aux from ``params``), not
    the memory of the encoder it has just pruned."""
    model, params, cfg = pair["model"], pair["params"], pair["cfg"]
    seen = []
    orig = C.collect_block_stats

    def spy(model_, bp, i, h_mb, pos_mb, aux_mb=None, **kw):
        seen.append((i, aux_mb))
        return orig(model_, bp, i, h_mb, pos_mb, aux_mb, **kw)

    monkeypatch.setattr(C, "collect_block_stats", spy)
    masks, pruned = prune(model, params, pair["calib"], method="wanda", sparsity=0.7,
                          extra_batch=pair["calib_x"])
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    frames = torch.as_tensor(pair["calib_x"]["frames"])
    dense = [ED.encode(params, cfg, frames[s:s + 8]) for s in (0, 8)]
    sparse = [ED.encode(pruned, cfg, frames[s:s + 8], masks) for s in (0, 8)]
    for i, aux_mb in seen:
        if i < cfg.enc_layers:
            assert aux_mb == [{}, {}]
            continue
        for a, d, s in zip(aux_mb, dense, sparse):
            assert torch.equal(a["memory"], d)
            assert _rel(a["memory"].numpy(), s.numpy()) > 1e-2


PRUNES = [("magnitude", 0.5, None), ("wanda", 0.7, None), ("sparsegpt", 0.5, None),
          ("dsnot", 0.6, None), ("wanda", 0.5, (2, 4))]


def _prunable(masks):
    return {p: m for p, m in T.leaves_with_path(masks) if SP.is_prunable(p, m)}


@pytest.mark.parametrize("method,sparsity,pattern", PRUNES,
                         ids=[f"{m}-{'2:4' if p else s}" for m, s, p in PRUNES])
def test_prune_matches_reference(pair, method, sparsity, pattern):
    """Every method's masks and pruned weights as the reference's, both
    walks fed the same calibration frames (``extra_batch``), the encoder's
    and the decoder's leaves (cross-attention's too)."""
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
    assert ("dec_blocks", "xattn", "wk") in port and ("enc_blocks", "attn", "wo") in port
    n_enc = pair["cfg"].enc_layers
    flips = 0
    for path, m in port.items():
        diff = m != ref[path]
        off = 0 if path[0] == "enc_blocks" else n_enc
        for i in range(m.shape[0]):
            d = diff[i]
            if d.any():
                assert method in ("wanda", "sparsegpt"), (path, i)
                gaps = SP.threshold_gaps(scores[(off + i, *path[1:])], sparsity, pattern)
                assert float(gaps[SP.to_matrix(path[-1], d)[0]].max()) <= TIE_RTOL, (path, i)
                flips += int(d.sum())
        assert bool((T.get_path(pruned, path)[~m] == 0).all()), path
    for path, w in T.leaves_with_path(pruned):
        if flips == 0:
            assert _rel(w.numpy(), T.get_path(_np(rpruned), path)) <= REL, path
    assert 0 < sum(int((~m).sum()) for m in port.values())


def test_flap_refuses_encdec_as_the_reference_does(pair):
    with pytest.raises(AssertionError, match="FLAP"):
        ref_prune(pair["rmodel"], pair["rparams"], pair["calib"], method="flap", sparsity=0.3,
                  extra_batch=pair["calib_x"])
    with pytest.raises(ValueError, match="FLAP"):
        prune(pair["model"], pair["params"], pair["calib"], method="flap", sparsity=0.3,
              extra_batch=pair["calib_x"])


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


def test_ebft_matches_reference(pair, wanda):
    """From the reference's Wanda masks and pruned weights, both walks fed
    the same calibration frames: each block's kind, losses, epochs and
    early stop (the decoder's student on its tuned encoder's memory), and
    the dense, pruned and tuned perplexities on the evaluation frames."""
    ecfg = dict(lr=1e-2, epochs=4, microbatch=8, patience=2)
    rtuned, rreports = REBFT.finetune(pair["rmodel"], pair["rparams"], wanda["rpruned"],
                                      wanda["rmasks"], pair["calib"], REBFT.EBFTConfig(**ecfg),
                                      extra_batch=pair["calib_x"])
    tuned, reports = EBFT.finetune(pair["model"], pair["params"], wanda["pruned"],
                                   wanda["masks"], pair["calib"], EBFT.EBFTConfig(**ecfg),
                                   extra_batch=pair["calib_x"])
    assert [(r.index, r.kind) for r in reports] == [(r.index, r.kind) for r in rreports] == \
        [(0, "enc"), (1, "enc"), (2, "dec"), (3, "dec")]
    for a, b in zip(reports, rreports):
        assert (a.epochs_run, a.early_stop) == (b.epochs_run, b.early_stop), a.index
        for x, y in zip(a.history + [a.loss_before, a.loss_after],
                        b.history + [b.loss_before, b.loss_after]):
            assert x == pytest.approx(y, rel=PIPE_REL), a.index
        assert a.loss_after < a.loss_before
    for params, rparams, masks in ((pair["params"], pair["rparams"], None),
                                   (wanda["pruned"], wanda["rpruned"], wanda["masks"]),
                                   (tuned, rtuned, wanda["masks"])):
        ppl = perplexity(pair["model"], params, pair["ev"], extra_batch=pair["ev_x"],
                         masks=masks)
        assert ppl == pytest.approx(ref_perplexity(pair["rmodel"], rparams, pair["ev"],
                                                   extra_batch=pair["ev_x"]), rel=PIPE_REL)


def test_perplexity_and_cloze_match_reference(pair, wanda):
    """Perplexity with the frames sliced per microbatch as the reference's
    (12 rows: a last microbatch of 4), and the cloze accuracy, dense and
    through the masked linears; the frames reach the loss."""
    model, ev, x = pair["model"], pair["ev"][:12], {"frames": pair["ev_x"]["frames"][:12]}
    for params, rparams, masks in ((pair["params"], pair["rparams"], None),
                                   (wanda["pruned"], wanda["rpruned"], wanda["masks"])):
        got = perplexity(model, params, ev, extra_batch=x, masks=masks)
        assert got == pytest.approx(ref_perplexity(pair["rmodel"], rparams, ev, extra_batch=x),
                                    rel=PIPE_REL)
    ctx, t, d = RTOK.cloze_task(pair["corpus"], 20, SEQ)
    cx = {"frames": _frames(20, pair["cfg"], 3)}
    for params, rparams, masks in ((pair["params"], pair["rparams"], None),
                                   (wanda["pruned"], wanda["rpruned"], wanda["masks"])):
        assert cloze_accuracy(model, params, ctx, t, d, extra_batch=cx, masks=masks) == \
            ref_cloze(pair["rmodel"], rparams, ctx, t, d, extra_batch=cx)
    assert perplexity(model, pair["params"], ev, extra_batch=x) != \
        perplexity(model, pair["params"], ev, extra_batch={"frames": x["frames"] * 0})


# ---------------------------------------------------------------------------
# mask tuning, LoRA
# ---------------------------------------------------------------------------
def test_finetune_masks_matches_reference(pair, wanda, monkeypatch):
    """Epoch histories within rel 1e-4 (four blocks, the decoder's on its
    mask-tuned encoder's memory); tuned masks equal bar slots within 1e-5
    of the port's final scores' threshold; the weights the dense ones
    under the tuned masks."""
    ecfg = dict(lr=2e-2, epochs=4, microbatch=8, patience=2)
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
    assert len(hist) == len(seen) == 4
    for a, b in zip(hist, seen):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, rtol=PIPE_REL)
    assert hist[0][-1] < hist[0][0] and hist[2][-1] < hist[2][0]
    ref = _prunable(expand_masks(pair["params"], interop.masks_to_torch(_np(rmasks), "cpu")))
    n_enc = pair["cfg"].enc_layers
    for path, m in _prunable(masks).items():
        diff = m != ref[path]
        off = 0 if path[0] == "enc_blocks" else n_enc
        for i in range(m.shape[0]):
            d = SP.to_matrix(path[-1], diff[i])[0]
            if d.any():
                gaps = SP.threshold_gaps(scores[(off + i, *path[1:])], 0.7)
                assert float(gaps[d].max()) <= 1e-5, (path, i)
        assert torch.equal(T.get_path(mt, path), T.get_path(pair["params"], path) * m)
    assert not torch.equal(masks["dec_blocks"]["xattn"]["wk"],
                           wanda["masks"]["dec_blocks"]["xattn"]["wk"])


def test_finetune_lora_matches_reference(pair, wanda):
    """5 steps from the reference's adapter init, each step's frames from
    ``extra_batch_fn(step)``: merged weights within rel 1e-4, pruned slots
    0, every prunable leaf of both stacks moved."""
    steps = 5
    rl = RLORA.LoRAConfig(steps=steps, lr=1e-3)
    fn = lambda s: {"frames": _frames(4, pair["cfg"], 50 + s)}
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
    assert moved == 6 + 10


# ---------------------------------------------------------------------------
# serving at the model level: prefill encodes the frames, decode carries the memory
# ---------------------------------------------------------------------------
def test_prefill_decode_matches_forward(pair):
    """The port's counterpart of the reference's
    ``test_encdec_prefill_decode_consistent``: prefill of tokens[:-1] over
    the frames gives forward's logits at the second-to-last position, one
    decode step its last, and the state carries the memory."""
    model, params, cfg = pair["model"], pair["params"], pair["cfg"]
    b = _tt(_batch(cfg, 2, 32, 6))
    full = model.forward(params, b)
    state = model.init_serve_state(2, 32, "cpu")
    assert state["memory"].shape == (2, 4, cfg.d_model) and state["cache"]["len"] == 0
    lp, state = model.prefill(params, {"tokens": b["tokens"][:, :-1], "frames": b["frames"]},
                              state)
    assert state["cache"]["len"] == 31
    torch.testing.assert_close(state["memory"], ED.encode(params, cfg, b["frames"]),
                               rtol=0, atol=0)
    torch.testing.assert_close(lp[:, -1], full[:, -2], rtol=2e-4, atol=2e-4)
    ld, state = model.decode_step(params, b["tokens"][:, -1:], state)
    torch.testing.assert_close(ld[:, -1], full[:, -1], rtol=2e-4, atol=2e-4)
    assert state["cache"]["len"] == 32


def test_greedy_decode_matches_reference(pair, wanda):
    """Greedy prefill + 8 decode steps, token for token against the
    reference's model-level ``prefill`` and ``decode_step``, on the dense
    and the Wanda weights."""
    model, rmodel, cfg = pair["model"], pair["rmodel"], pair["cfg"]
    raw = _batch(cfg, 3, 24, 7)
    rprefill, rstep = jax.jit(rmodel.prefill), jax.jit(rmodel.decode_step)
    for params, rparams in ((pair["params"], pair["rparams"]),
                            (wanda["pruned"], wanda["rpruned"])):
        state = model.init_serve_state(3, 40, "cpu")
        logits, state = model.prefill(params, _tt(raw), state)
        rlogits, rstate = rprefill(rparams, _jj(raw), rmodel.init_serve_state(3, 40))
        _close(logits, rlogits)
        _close(state["memory"], rstate["memory"])
        got, want = [], []
        for _ in range(8):
            tok = logits[:, -1].argmax(-1)
            rtok = jnp.argmax(rlogits[:, -1], -1)
            got.append(tok.tolist())
            want.append(np.asarray(rtok).tolist())
            logits, state = model.decode_step(params, tok[:, None], state)
            rlogits, rstate = rstep(rparams, rtok[:, None].astype(jnp.int32), rstate)
        assert got == want
        assert state["cache"]["len"] == int(rstate["cache"]["len"]) == 24 + 8


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
    """``launch/train``'s encoder-decoder batch: the step's tokens, then
    the frames from the same generator, as the reference's ``data_fn``,
    bit for bit."""
    ref_fn = _data_fn(RTRAIN, monkeypatch, lambda: RTRAIN.main(
        ["--arch", ARCH, "--steps", "2", "--batch", "3", "--seq", "64", "--seed", "5",
         "--no-obs"]))
    fn = _data_fn(train, monkeypatch, lambda: train.run(
        get_config(ARCH), train.TrainSpec(arch=ARCH, steps=2, batch=3, seq=64, seed=5,
                                          no_obs=True), "cpu"))
    for step in (0, 7):
        got, want = fn(step), ref_fn(step)
        assert got.keys() == want.keys() == {"tokens", "frames"}
        assert tuple(got["tokens"].shape) == (3, 64) and tuple(got["frames"].shape) == (3, 8, 64)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_launcher_runs_encdec_on_the_cpu(capsys):
    res = train.main(["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "32",
                      "--device", "cpu", "--no-obs"])
    assert len(res.history) == 1 and math.isfinite(res.history[0][1])
    assert "3 steps in" in capsys.readouterr().out


@pytest.mark.parametrize("driver", ["ebft_run", "ebft_run.run", "serve"])
def test_drivers_refuse_encdec(driver, monkeypatch):
    """The reference's drivers pass the tokens alone (its ``--arch
    tiny_encdec`` stops at the missing frames); the port's refuse the
    family before any work (no model is built), naming the library calls
    that run it."""
    def no_build(cfg):
        raise AssertionError("a driver built the model before refusing the family")

    monkeypatch.setattr(ebft_run, "build", no_build)
    monkeypatch.setattr(serve, "build", no_build)
    calls = {"ebft_run": lambda: ebft_run.main(["--arch", ARCH, "--device", "cpu"]),
             "ebft_run.run": lambda: ebft_run.run(get_config(ARCH), ebft_run.RunSpec(arch=ARCH),
                                                  "cpu"),
             "serve": lambda: serve.main(["--arch", ARCH, "--device", "cpu"])}
    with pytest.raises(NotImplementedError, match="encdec.*frames.*extra_batch"):
        calls[driver]()
