"""Shared machinery of ``test_torch_{moe,ssm,hybrid}_baselines.py``: the
port's baselines (SparseGPT, DSnoT, mask tuning, LoRA, ``ebft_run
--baselines``) held to the JAX reference on one tiny config of a family,
on the CPU, from the reference's ``init`` carried across with
``interop``. Numpy inputs from a seed, the same on both sides.

Stated tolerances (f32, sums taken in another order on each side):
- SparseGPT's masks equal, bar slots whose score lies within 1e-4
  (relative) of its 128-row block's threshold (its scores pass through an
  inverse and a Cholesky factor of a Gram that the port sums in f64, the
  reference in f32); DSnoT's equal; where the masks agree, the pruned
  weights and the perplexities within rel 1e-4;
- mask tuning: epoch histories within rel 1e-4, masks equal bar slots
  within 1e-5 of the port's final scores' threshold, or (where the run is
  chaotic, ROADMAP.md C.5) no more flipped slots, and a perplexity no
  further, than twice the reference's own under a 1e-6 move of its start
  (the dense weights, seeded noise);
- LoRA from the reference's adapter init: merged weights within rel 1e-4,
  the perplexity within rel 1e-4 or twice the reference's own spread under
  a 1e-6 move of its init;
- the driver: every perplexity as the reference's functions give it,
  called in the order its driver calls them, within the limits above.
"""
from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import ebft as REBFT
from repro.core import lora as RLORA
from repro.core import mask_tuning as RMT
from repro.core.evaluate import perplexity as ref_perplexity
from repro.core.masks import prune as ref_prune
from repro.data import tokens as RTOK
from repro.models.model import build as ref_build
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import lora as LORA
from repro_torch.core import mask_tuning as MT
from repro_torch.core import reconstruction as R
from repro_torch.core.evaluate import perplexity
from repro_torch.core.masks import expand_masks, prune
from repro_torch.launch import ebft_run
from repro_torch.models.model import build
from repro_torch.sparsity import sparse_params as SP

REL = 1e-4
SGPT_TIE = 1e-4
MT_TIE = 1e-5
SEQ = 32
N_CAL = 16
SPARSITY = 0.7
LORA_STEPS = 5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_pair(arch: str) -> dict:
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    return dict(arch=arch, rcfg=rcfg, cfg=cfg, rmodel=rmodel, rparams=rparams, model=build(cfg),
                params=interop.params_to_torch(np_tree(rparams), "cpu"), corpus=corpus,
                calib=RTOK.calibration_set(corpus, N_CAL, SEQ), ev=RTOK.eval_set(corpus, 16, SEQ))


def ref_prunes(pair) -> dict:
    """The reference's Wanda, SparseGPT and DSnoT (from Wanda) at SPARSITY,
    each with its perplexity, and each mask tree as the port's."""
    out = {}
    for method in ("wanda", "sparsegpt", "dsnot"):
        rmasks, rpruned = ref_prune(pair["rmodel"], pair["rparams"], pair["calib"],
                                    method=method, sparsity=SPARSITY)
        out[method] = dict(
            rmasks=rmasks, rpruned=rpruned,
            ppl=ref_perplexity(pair["rmodel"], rpruned, pair["ev"]),
            masks=expand_masks(pair["params"], interop.masks_to_torch(np_tree(rmasks), "cpu")),
            pruned=interop.params_to_torch(np_tree(rpruned), "cpu"))
    return out


def block_slices(cfg, path, t):
    """[(block index, slice)] of a prunable leaf of a full tree: a stacked
    leaf's slices by the model's block index; the hybrid's unstacked shared
    block is block ``num_layers``."""
    name = path[-1]
    stack = t.dim() - SP._LOGICAL_NDIM[name] - SP.is_expert_batched(name, t[0])
    if stack == 0:
        return [(cfg.num_layers, t)]
    K = cfg.hybrid_attn_every
    first = {"moe_blocks": cfg.moe_first_dense,
             "trailing": K and cfg.num_layers // K * K}.get(path[0], 0)
    flat = t.reshape(-1, *t.shape[stack:])
    return [(first + j, flat[j]) for j in range(flat.shape[0])]


def sgpt_gaps(scores, sparsity):
    """Each slot's distance from its SparseGPT comparison group's threshold
    (its column within its 128-row block), relative to it."""
    R_ = scores.shape[-2]
    return torch.cat([SP.threshold_gaps(scores[..., v:v + 128, :], sparsity)
                      for v in range(0, R_, 128)], dim=-2)


def prunable(masks):
    return {p: m for p, m in T.leaves_with_path(masks) if SP.is_prunable(p, m)}


def check_prune(pair, refs, method: str) -> int:
    """The port's ``method`` prune against the reference's: masks (with
    SparseGPT's near-threshold slots let go), pruned slots 0, weights and
    perplexity. Returns the flipped slots."""
    cfg, scores = pair["cfg"], {}
    masks, pruned = prune(pair["model"], pair["params"], pair["calib"], method=method,
                          sparsity=SPARSITY, scores_out=scores)
    ref = refs[method]
    want = prunable(ref["masks"])
    got = prunable(masks)
    assert got.keys() == want.keys()
    flips = 0
    for path, m in got.items():
        for i, d in block_slices(cfg, path, m != want[path]):
            if d.any():
                assert method == "sparsegpt", (path, i)
                gaps = sgpt_gaps(scores[(i, *path[1:])], SPARSITY)
                assert float(gaps[SP.to_matrix(path[-1], d)[0]].max()) <= SGPT_TIE, (path, i)
                flips += int(d.sum())
        assert bool((T.get_path(pruned, path)[~m] == 0).all()), path
    if flips == 0:
        for path, w in T.leaves_with_path(pruned):
            assert rel_norm(w.numpy(), T.get_path(np_tree(ref["rpruned"]), path)) <= REL, path
    assert perplexity(pair["model"], pruned, pair["ev"], masks=masks) == \
        pytest.approx(ref["ppl"], rel=REL)
    return flips


def flipped(a, b) -> int:
    return sum(int((m != T.get_path(b, p)).sum()) for p, m in prunable(a).items())


class RefRun:
    """A reference run (mask tuning or LoRA) and, on first asking, the same
    run from its start moved by 1e-6 (relative): the spread that rounding
    alone can cause (ROADMAP.md C.5)."""

    def __init__(self, run):
        self._run = run
        self.base = run(1.0)
        self._moved = None

    @property
    def moved(self):
        if self._moved is None:
            self._moved = self._run(1.0 + 1e-6)
        return self._moved

    def ppl_rel(self, got: float):
        """``got``'s distance from the base run's perplexity, and the
        limit: rel 1e-4, or twice the moved run's distance if that is
        larger."""
        want = self.base["ppl"]
        err = abs(got / want - 1)
        if err <= REL:
            return err, REL
        return err, max(REL, 2 * abs(self.moved["ppl"] / want - 1))


def moved_weights(tree, eps: float, seed: int = 1):
    """``tree`` with every leaf moved by ``eps`` (relative), seeded normal
    noise: a start that only rounding tells apart."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) * (1 + eps * rng.standard_normal(np.shape(a))).astype(np.float32)), tree)


def ref_mask_tuning(pair, refs) -> RefRun:
    """The reference's mask tuning (the driver's settings: lr 2e-2, 10
    epochs, patience 2) from its Wanda masks: tuned masks (as the port's),
    perplexity and each visit's epoch history, read where its loop hands
    it to the plateau rule; moved: the same from the dense weights moved
    by 1e-6 (relative)."""
    def run(bump):
        seen = []
        orig = RMT.plateau_early_stop

        def spy(history, *a, **kw):
            if len(history) == 1:
                seen.append(None)
            seen[-1] = list(history)
            return orig(history, *a, **kw)

        params = pair["rparams"] if bump == 1.0 else moved_weights(pair["rparams"], bump - 1.0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(RMT, "plateau_early_stop", spy)
            mt, masks = RMT.finetune_masks(pair["rmodel"], params, refs["wanda"]["rmasks"],
                                           SPARSITY, pair["calib"])
        return dict(masks=expand_masks(pair["params"],
                                       interop.masks_to_torch(np_tree(masks), "cpu")),
                    ppl=ref_perplexity(pair["rmodel"], mt, pair["ev"]), histories=seen)

    return RefRun(run)


def ref_lora(pair, refs, steps=LORA_STEPS) -> RefRun:
    """The reference's LoRA (lr 1e-3, ``steps`` steps at batch 8) on its
    Wanda prune: merged weights and perplexity; moved: its adapter init
    times (1 + 1e-6). ``init`` is the unmoved init as the port's tree."""
    lcfg = RLORA.LoRAConfig(steps=steps, lr=1e-3)
    w = refs["wanda"]
    init_lora = RLORA.init_lora

    def run(bump):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(RLORA, "init_lora", lambda p, c: jax.tree.map(lambda a: a * bump,
                                                                     init_lora(p, c)))
            merged = RLORA.finetune_lora(pair["rmodel"], w["rpruned"], w["rmasks"],
                                         RTOK.corpus_iterator(pair["corpus"], batch=8,
                                                              seq_len=SEQ, seed=9), lcfg)
        return dict(merged=np_tree(merged), ppl=ref_perplexity(pair["rmodel"], merged,
                                                                pair["ev"]))

    ref = RefRun(run)
    ref.steps = steps
    ref.init = interop.lora_to_torch(np_tree(init_lora(w["rpruned"], lcfg)), "cpu")
    return ref


def check_mask_tuning(pair, refs, ref: RefRun):
    """The port's mask tuning from the reference's Wanda masks at the same
    settings: histories within rel 1e-4 (all finite), masks equal bar
    slots near the port's final threshold (or no more flips than twice the
    reference's own spread), the perplexity within rel 1e-4 (or twice the
    spread), the weights the dense ones under the tuned masks, every
    column keeping its share. Returns the port's masks."""
    hist, scores = [], {}
    mt, masks = MT.finetune_masks(pair["model"], pair["params"], refs["wanda"]["masks"],
                                  SPARSITY, pair["calib"], histories=hist, scores_out=scores)
    base = ref.base
    visits = [i for seg in R.execution_plan(pair["model"]) for i, _ in seg.visits]
    assert len(hist) == len(base["histories"]) == len(visits)
    assert all(math.isfinite(x) for h in base["histories"] + hist for x in h)
    far = 0
    want = prunable(base["masks"])
    for path, m in prunable(masks).items():
        for i, d in block_slices(pair["cfg"], path, m != want[path]):
            if d.any():
                gaps = SP.threshold_gaps(scores[(i, *path[1:])], SPARSITY)
                far += int((gaps[SP.to_matrix(path[-1], d)[0]] > MT_TIE).sum())
    if far:  # a chaotic run: no more flips than the reference's own spread
        assert flipped(masks, base["masks"]) <= 2 * flipped(ref.moved["masks"], base["masks"])
    else:
        for a, b in zip(hist, base["histories"]):
            assert len(a) == len(b)
            np.testing.assert_allclose(a, b, rtol=REL)
    err, lim = ref.ppl_rel(perplexity(pair["model"], mt, pair["ev"], masks=masks))
    assert err <= lim, (err, lim)
    for path, w in T.leaves_with_path(mt):
        assert torch.equal(w, T.get_path(pair["params"], path) * T.get_path(masks, path)), path
    for path, m in prunable(masks).items():
        mat = SP.to_matrix_stacked(path[-1], m)[0]
        assert bool((mat.sum(-2) == max(1, round(mat.shape[-2] * (1 - SPARSITY)))).all()), path
    assert flipped(masks, refs["wanda"]["masks"]) > 0
    return masks


def check_lora(pair, refs, ref: RefRun):
    """LoRA from the reference's adapter init (``interop.lora_to_torch``) on
    the reference's Wanda prune: the LM losses finite, the merged weights
    within rel 1e-4, pruned slots 0, every prunable leaf moved, the
    perplexity within rel 1e-4 (or twice the reference's own spread)."""
    w = refs["wanda"]
    losses = []
    got = LORA.finetune_lora(pair["model"], w["pruned"], w["masks"],
                             RTOK.corpus_iterator(pair["corpus"], batch=8, seq_len=SEQ, seed=9),
                             LORA.LoRAConfig(steps=ref.steps, lr=1e-3), lora=ref.init,
                             losses=losses)
    assert len(losses) == ref.steps and all(math.isfinite(float(v)) for v in losses)
    moved = total = 0
    for path, t in T.leaves_with_path(got):
        assert rel_norm(t.numpy(), T.get_path(ref.base["merged"], path)) <= REL, path
        if SP.is_prunable(path, t):
            assert bool((t[~T.get_path(w["masks"], path)] == 0).all()), path
            moved += int(not torch.equal(t, T.get_path(w["pruned"], path)))
            total += 1
    assert moved == total
    err, lim = ref.ppl_rel(perplexity(pair["model"], got, pair["ev"], masks=w["masks"]))
    assert err <= lim, (err, lim)


def adapter_shapes(pair) -> dict:
    """{path: (A shape, B shape)} of the port's adapters, each equal to the
    reference's ``init_lora`` on the same tree."""
    lcfg = RLORA.LoRAConfig()
    ref = interop.lora_to_torch(np_tree(RLORA.init_lora(pair["rparams"], lcfg)), "cpu")
    got = LORA.init_lora(pair["params"], LORA.LoRAConfig(), torch.Generator().manual_seed(0))
    assert sorted(p for p, _ in T.leaves_with_path(got)) == \
        sorted(p for p, _ in T.leaves_with_path(ref))
    out = {}
    for path, a in T.leaves_with_path(got):
        assert a.shape == T.get_path(ref, path).shape, path
        out.setdefault(path[:-1], {})[path[-1]] = tuple(a.shape)
    return {"/".join(p): (ab["A"], ab["B"]) for p, ab in out.items()}


def check_driver(pair, refs, ref_mt: RefRun, ref_lr: RefRun, monkeypatch):
    """``ebft_run.run`` with ``--baselines dsnot,mask,lora`` (Wanda 0.7, EBFT
    at lr 1e-3 for 2 epochs; LoRA at the reference runs' steps of the
    driver's config, from the reference's init) against the reference's
    functions in the order its driver calls them: every perplexity within
    rel 1e-4, mask tuning's and LoRA's within twice the reference's own
    spread where they are further."""
    spec = ebft_run.RunSpec(arch=pair["arch"], seed=0, seq=SEQ, calib_samples=N_CAL,
                            pretrain_steps=0, epochs=2, lr=1e-3, baselines="dsnot,mask,lora")
    rmodel, rparams, ev = pair["rmodel"], pair["rparams"], pair["ev"]
    w = refs["wanda"]
    tuned, _ = REBFT.finetune(rmodel, rparams, w["rpruned"], w["rmasks"], pair["calib"],
                              REBFT.EBFTConfig(lr=spec.lr, epochs=spec.epochs))
    want = {"dense": ref_perplexity(rmodel, rparams, ev), "wanda": w["ppl"],
            "EBFT": ref_perplexity(rmodel, tuned, ev), "DSnoT": refs["dsnot"]["ppl"]}
    monkeypatch.setattr(LORA, "init_lora", lambda *a, **k: ref_lr.init)
    monkeypatch.setattr(ebft_run, "LORA", LORA.LoRAConfig(steps=ref_lr.steps, lr=1e-3))
    res = ebft_run.run(pair["cfg"], spec, "cpu", params=pair["params"])
    assert set(res.perplexity) == set(want) | {"mask-tune", "LoRA"}
    for k, v in want.items():
        assert res.perplexity[k] == pytest.approx(v, rel=REL), k
    for k, ref in (("mask-tune", ref_mt), ("LoRA", ref_lr)):
        err, lim = ref.ppl_rel(res.perplexity[k])
        assert err <= lim, (k, err, lim)
    assert {"baseline_dsnot", "baseline_mask", "baseline_lora"} <= set(res.phases)
    assert len(res.baselines["lora"]["losses"]) == ref_lr.steps
    assert len(res.baselines["mask"]["histories"]) == \
        sum(len(seg.visits) for seg in R.execution_plan(pair["model"]))
    return res


def leaf_functions_match_reference(model, params, rmodel, rparams, calib, rmasks, block: int,
                                   sparsity: float = 0.5):
    """The baselines' per-leaf functions on block ``block`` (its inputs
    tapped on ``calib`` through the dense blocks before it) against the
    reference's on the same arrays: SparseGPT's ``leaf_prune`` (the port's
    Gram handed to both: masks equal bar near-threshold slots, weights
    within rel 1e-4 where they agree) and DSnoT's ``leaf_reselect`` from
    the reference's masks ``rmasks`` (equal); mask tuning's final masks of
    seeded scores (equal); and LoRA's merge of seeded adapters over the
    whole model (within 1e-6 of each leaf's largest value)."""
    import jax.numpy as jnp

    from repro.core.pruning import common as RC
    from repro.core.pruning import dsnot as RDSNOT
    from repro.core.pruning import sparsegpt as RSGPT
    from repro.sparsity import sparse_params as RSP
    from repro_torch.core.pruning import common as C
    from repro_torch.core.pruning import dsnot as DSNOT
    from repro_torch.core.pruning import sparsegpt as SGPT

    masks = expand_masks(params, interop.masks_to_torch(np_tree(rmasks), "cpu"))
    bp, mb = model.get_block(params, block), model.get_block(masks, block)
    h, pos = model.embed_tokens(params, {"tokens": torch.as_tensor(calib)})
    with torch.no_grad():
        for i in range(block):
            h = R.advance(model, params, i, h, pos)
        stats = C.collect_block_stats(model, bp, block, [h], [pos], want_hessian=True)
    rng = np.random.default_rng(block)
    scores, rscores = {}, {}
    names_seen = []
    for names, leaf in C.iter_prunable(bp):
        st = C.stats_for_leaf(stats, names)
        name = names[-1]
        rst = RC.LeafStats(st.n, jnp.asarray(st.sum.numpy()), jnp.asarray(st.sumsq.numpy()),
                           None if st.hessian is None else jnp.asarray(st.hessian.float().numpy()))
        w, m = SGPT.leaf_prune(name, leaf, st, sparsity)
        rw, rm = RSGPT.leaf_prune(name, jnp.asarray(leaf.numpy()), rst, sparsity)
        rm = torch.as_tensor(np.asarray(rm) != 0)
        if torch.equal(m, rm):
            assert rel_norm(w.numpy(), np.asarray(rw)) <= REL, names
        else:
            assert name != "conv_w" and float((m != rm).float().mean()) < 1e-2, names
        mk = T.get_path(mb, names)
        ds = DSNOT.leaf_reselect(name, leaf, mk, st)
        rds = RDSNOT.leaf_reselect(name, jnp.asarray(leaf.numpy()),
                                   jnp.asarray(mk.numpy(), jnp.float32), rst)
        assert torch.equal(ds, torch.as_tensor(np.asarray(rds) != 0)), names
        s = rng.random(leaf.shape).astype(np.float32)
        T.set_path(scores, names, torch.as_tensor(s))
        names_seen.append(names)
    rbp = rmodel.get_block(rparams, block)
    rscores = jax.tree_util.tree_map_with_path(
        lambda p, w: jnp.asarray(T.get_path(scores, RSP._path_names(p)).numpy())
        if RSP.is_prunable(p, w) else jnp.zeros(w.shape, jnp.float32), rbp)
    got = MT._final_masks(bp, scores, sparsity, None)
    want = RMT._final_masks(rbp, rscores, sparsity, None)
    for names in names_seen:
        assert torch.equal(T.get_path(got, names),
                           torch.as_tensor(np.asarray(T.get_path(np_tree(want), names)) != 0))
    lcfg = RLORA.LoRAConfig()
    ref_l = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)),
                         RLORA.init_lora(rparams, lcfg))
    merged = RLORA.merge(rparams, rmasks, ref_l, lcfg)
    got = LORA.merge(params, masks, interop.lora_to_torch(np_tree(ref_l), "cpu"),
                     LORA.LoRAConfig())
    for path, t in T.leaves_with_path(got):
        want = np.asarray(T.get_path(merged, path))
        np.testing.assert_allclose(t.numpy(), want, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(want).max())))
    return len(names_seen)


def driver_matches_library(cfg, params, spec):
    """``ebft_run.run`` with ``spec.baselines`` on ``cfg``'s family: each
    baseline's perplexity is the one its library call gives on the same
    inputs, called in the driver's order (both on the port, so equal)."""
    from repro_torch.data.tokens import (
        CorpusConfig, SyntheticCorpus, calibration_set, corpus_iterator, eval_set,
    )

    res = ebft_run.run(cfg, spec, "cpu", params=params)
    model = build(cfg)
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=spec.seed))
    calib = calibration_set(corpus, spec.calib_samples, spec.seq)
    ev = eval_set(corpus, ebft_run.EVAL_SAMPLES, spec.seq)
    masks, pruned = prune(model, params, calib, method=spec.method, sparsity=spec.sparsity)
    want = {}
    wants = spec.baselines.split(",")
    if "dsnot" in wants:
        m, p = prune(model, params, calib, method="dsnot", sparsity=spec.sparsity,
                     dsnot_init=spec.method)
        want["DSnoT"] = perplexity(model, p, ev, masks=m)
    if "mask" in wants:
        p, m = MT.finetune_masks(model, params, masks, spec.sparsity, calib)
        want["mask-tune"] = perplexity(model, p, ev, masks=m)
    if "lora" in wants:
        p = LORA.finetune_lora(model, pruned, masks, corpus_iterator(corpus, batch=8,
                                                                    seq_len=spec.seq, seed=9),
                               ebft_run.LORA)
        want["LoRA"] = perplexity(model, p, ev, masks=masks)
    assert {k: res.perplexity[k] for k in want} == want
    assert all(math.isfinite(v) for v in res.perplexity.values())
    return res
