"""The port's training side held against the reference on the CPU, on the
same numpy-seeded inputs: schedules, SGD, gradient compression, the train
step, ``Trainer`` with checkpoint and restart, ``launch/train.py`` and the
driver's pretraining.

Stated tolerances: schedules rel 1e-6 (or 1e-6 of the peak lr), the device
plateau predicate exact; SGD and compression rel 1e-6; the train step's loss and grad norm
rel 1e-5 at every step, and its params rel 1e-5 (relative L2 norm of each
leaf) after one step. Adam's first steps move a weight by about lr times
the sign of its gradient, so a gradient near zero turns rounding into a
move of up to lr: after five steps the params are held within
max(1e-5, 2 x the reference's own move under a 1e-6 change of its start),
measured here, as the baselines' chaotic cases are (ROADMAP.md C.5).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as RCK
from repro.configs import get_config as ref_get_config
from repro.core import ebft as REBFT
from repro.core.evaluate import perplexity as ref_perplexity
from repro.core.masks import prune as ref_prune
from repro.data import tokens as RTOK
from repro.launch.ebft_run import pretrain as ref_pretrain
from repro.models.model import build as ref_build
from repro.obs import metrics as OM
from repro.optim import grad_compress as RGC
from repro.optim import optimizers as ROPT
from repro.optim import schedules as RSCH
from repro.training.train_loop import Trainer as RTrainer
from repro.training.train_loop import make_train_step as ref_make_train_step
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.launch import ebft_run
from repro_torch.launch import train as TRAIN
from repro_torch.models.model import build
from repro_torch.optim import grad_compress as GC
from repro_torch.optim import optimizers as OPT
from repro_torch.optim import schedules as SCH
from repro_torch.training.train_loop import Trainer, make_train_step

MOVE = 1 + 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    under several test workers on few cores the threads' waits dominate."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)), ("warmup_cosine", (3e-3, 20, 100)),
    ("warmup_cosine", (1.0, 10, 100, 0.1)), ("linear_decay", (2e-4, 5, 50, 1e-5)),
])
def test_schedules_match_reference(name, args):
    """Within rel 1e-6, or 1e-6 of the peak where the cosine's 1 + cos(pi t)
    cancels at the end of its decay (one ulp of cos apart)."""
    port, ref = getattr(SCH, name)(*args), getattr(RSCH, name)(*args)
    for step in range(0, 130):
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        want = float(ref(jnp.asarray(step, jnp.int32)))
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-6 * args[0]), step


def test_schedule_drives_the_optimizer_without_a_host_value():
    """The optimizer hands the schedule its int32 step tensor."""
    opt = OPT.sgd(SCH.warmup_cosine(1.0, warmup=4, total=10))
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    upd, state = opt.update({"w": torch.ones(3)}, state, params)
    assert torch.equal(upd["w"], torch.full((3,), -0.25))  # lr at step 1 = 1/4


@pytest.mark.parametrize("patience,rel_tol", [(2, 1e-3), (3, 0.0), (1, 0.05), (0, 1e-3)])
def test_plateau_device_matches_host_predicate(patience, rel_tol):
    rng = np.random.default_rng(patience)
    for trial in range(40):
        size = 12
        hist = rng.uniform(0.5, 2.0, size).astype(np.float32)
        if trial % 3 == 0:  # plateaus and exact repeats
            hist[rng.integers(0, size, 4)] = hist[0]
        for n in range(0, size + 1):
            want = SCH.plateau_early_stop(list(map(float, hist[:n])), patience, rel_tol)
            got = SCH.plateau_early_stop_device(torch.tensor(hist), n, patience, rel_tol)
            assert got.dtype == torch.bool and bool(got) == want, (trial, n)
            ref = RSCH.plateau_early_stop_device(jnp.asarray(hist), n, patience, rel_tol)
            assert bool(ref) == want
            if n:  # n as a tensor on the buffer's device
                got_t = SCH.plateau_early_stop_device(torch.tensor(hist), torch.tensor(n),
                                                      patience, rel_tol)
                assert bool(got_t) == want


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False), (0.9, True)])
def test_sgd_matches_reference(momentum, nesterov):
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(5, 4)).astype(np.float32),
          "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    sched = RSCH.linear_decay(0.1, 2, 6)
    ropt = ROPT.sgd(sched, momentum=momentum, nesterov=nesterov)
    opt = OPT.sgd(SCH.linear_decay(0.1, 2, 6), momentum=momentum, nesterov=nesterov)
    rp = jax.tree.map(jnp.asarray, p0)
    pp = T.tree_map(torch.tensor, p0)
    rs, ps = ropt.init(rp), opt.init(pp)
    assert set(ps) == {"step", "mu"} and (ps["mu"] is None) == (momentum == 0.0)
    for _ in range(4):
        g = {"a": rng.normal(size=(5, 4)).astype(np.float32),
             "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
        ru, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        pu, ps = opt.update(T.tree_map(torch.tensor, g), ps, pp)
        rp = ROPT.apply_updates(rp, ru)
        pp = OPT.apply_updates(pp, pu)
        for path, t in T.leaves_with_path(pp):
            np.testing.assert_allclose(_np(t), np.asarray(T.get_path(rp, path)), rtol=1e-6,
                                       atol=1e-7)
    assert int(ps["step"]) == int(rs["step"]) == 4


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------
def _grads(rng):
    return {"big": rng.normal(size=(64, 48)).astype(np.float32),
            "tied": np.repeat(rng.normal(size=(8,)), 160).astype(np.float32),  # ties at k
            "tiny": rng.normal(size=(10, 10)).astype(np.float32)}


@pytest.mark.parametrize("ratio", [0.25, 0.01, 1.0])
def test_compress_matches_reference(ratio):
    rng = np.random.default_rng(5)
    g0 = _grads(rng)
    rerr = RGC.init_error_state(jax.tree.map(jnp.asarray, g0))
    err = GC.init_error_state(T.tree_map(torch.tensor, g0))
    for _ in range(3):  # error feedback carries over
        g = _grads(rng)
        rsent, rerr_new = RGC.compress(jax.tree.map(jnp.asarray, g), rerr, ratio)
        sent, err_new = GC.compress(T.tree_map(torch.tensor, g), err, ratio)
        for path, t in T.leaves_with_path(sent):
            np.testing.assert_allclose(_np(t), np.asarray(T.get_path(rsent, path)), rtol=1e-6)
            e = T.get_path(err_new, path)
            assert e.dtype == torch.float32
            np.testing.assert_allclose(_np(e), np.asarray(T.get_path(rerr_new, path)),
                                       rtol=1e-6, atol=1e-7)
            # error feedback: what is sent plus what is kept is g + the old residual
            np.testing.assert_allclose(_np(t) + _np(e),
                                       T.get_path(g, path) + _np(T.get_path(err, path)),
                                       rtol=1e-6, atol=1e-7)
        # a leaf under 1024 elements passes through, its residual untouched
        assert torch.equal(sent["tiny"], torch.tensor(g["tiny"]))
        assert torch.equal(err_new["tiny"], err["tiny"])
        if ratio < 1.0:
            k = max(1, int(g["big"].size * ratio))
            assert int((sent["big"] != 0).sum()) == k  # continuous values: no ties
            assert int((sent["tied"] != 0).sum()) >= max(1, int(1280 * ratio))
        rerr, err = rerr_new, err_new
    params = T.tree_map(torch.tensor, g0)
    assert GC.compressed_bytes(params, ratio) == RGC.compressed_bytes(
        jax.tree.map(jnp.asarray, g0), ratio)


# ---------------------------------------------------------------------------
# the train step on tiny_dense, from the reference's weights
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _tiny():
    cfg = ref_get_config("tiny_dense")
    model = ref_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=cfg.vocab_size))
    return model, params, corpus


def _data(corpus, batch, seq, base=1000):
    def f(step: int) -> np.ndarray:
        r = np.random.default_rng(base + step)
        return np.stack([corpus.sample(r, seq) for _ in range(batch)])
    return f


@functools.lru_cache(maxsize=None)
def _trajectories(microbatches: int, compress: float, steps: int = 5):
    """Per step: the reference's (loss, grad norm, params), the same from a
    start moved by 1e-6, and the port's."""
    model, params, corpus = _tiny()
    data = _data(corpus, 8, 64)
    ropt = ROPT.adamw(3e-3)
    rstep = jax.jit(ref_make_train_step(model.loss, ropt, microbatches=microbatches,
                                        compress_ratio=compress))

    def ref_run(p):
        s, e, out = ropt.init(p), (RGC.init_error_state(p) if compress < 1 else None), []
        for i in range(steps):
            p, s, m, e = rstep(p, s, {"tokens": jnp.asarray(data(i))}, e)
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        jax.tree.map(np.asarray, p)))
        return out

    ref = ref_run(params)
    moved = ref_run(jax.tree.map(lambda a: a * MOVE, params))
    pmodel = build(get_config("tiny_dense"))
    opt = OPT.adamw(3e-3)
    step = make_train_step(pmodel.loss, opt, microbatches=microbatches, compress_ratio=compress)
    p = interop.params_to_torch(jax.tree.map(np.asarray, params), "cpu")
    s, e, port = opt.init(p), (GC.init_error_state(p) if compress < 1 else None), []
    for i in range(steps):
        p, s, m, e = step(p, s, {"tokens": torch.as_tensor(data(i))}, e)
        assert m["loss"].dim() == 0 and m["grad_norm"].dim() == 0
        assert not any(t.requires_grad for _, t in T.leaves_with_path(p))
        port.append((float(m["loss"]), float(m["grad_norm"]),
                     T.tree_map(lambda t: t.clone(), p)))
    return ref, moved, port


@pytest.mark.parametrize("compress", [1.0, 0.25])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("steps", [1, 5])
def test_train_step_matches_reference(steps, microbatches, compress):
    ref, moved, port = _trajectories(microbatches, compress)
    for i in range(steps):
        assert port[i][0] == pytest.approx(ref[i][0], rel=1e-5)
        assert port[i][1] == pytest.approx(ref[i][1], rel=1e-5)
    _, _, rp = ref[steps - 1]
    spread = max(_rel(m, r) for m, r in zip(jax.tree.leaves(moved[steps - 1][2]),
                                            jax.tree.leaves(rp))) if steps > 1 else 0.0
    tol = max(1e-5, 2 * spread)
    for path, t in T.leaves_with_path(port[steps - 1][2]):
        assert _rel(_np(t), T.get_path(rp, path)) <= tol, (path, tol)


def test_microbatches_accumulate_to_the_whole_batch():
    """With SGD the two-microbatch step moves the weights as the one-batch
    step does (f32 accumulation), as the reference's own test holds it."""
    model = build(get_config("tiny_dense"))
    params = model.init(torch.Generator().manual_seed(0))
    _, _, corpus = _tiny()
    batch = {"tokens": torch.as_tensor(_data(corpus, 8, 64)(0))}
    opt = OPT.sgd(1e-2)
    outs = []
    for mb in (1, 4):
        p = T.tree_map(lambda t: t.clone(), params)
        outs.append(make_train_step(model.loss, opt, microbatches=mb)(p, opt.init(p), batch)[0])
    for path, a in T.leaves_with_path(outs[0]):
        np.testing.assert_allclose(_np(a), _np(T.get_path(outs[1], path)), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("compress", [1.0, 0.25])
def test_stage_hook_sees_each_stage_and_changes_nothing(compress):
    """``on_stage`` is called once per stage, in the step's order, and the
    step with the hook gives the bits of the step without it."""
    model = build(get_config("tiny_dense"))
    params = model.init(torch.Generator().manual_seed(0))
    _, _, corpus = _tiny()
    batch = {"tokens": torch.as_tensor(_data(corpus, 4, 32)(0))}
    opt = OPT.adamw(3e-3)
    seen, outs = [], []
    for hook in (None, seen.append):
        p = T.tree_map(lambda t: t.clone(), params)
        step = make_train_step(model.loss, opt, compress_ratio=compress, on_stage=hook)
        s, e = opt.init(p), GC.init_error_state(p)
        for _ in range(2):
            p, s, m, e = step(p, s, batch, e)
        outs.append((p, m))
    stages = ["start", "grads"] + (["compress"] if compress < 1 else []) + ["clip", "update"]
    assert seen == stages * 2
    assert torch.equal(outs[0][1]["loss"], outs[1][1]["loss"])
    for path, a in T.leaves_with_path(outs[0][0]):
        assert torch.equal(a, T.get_path(outs[1][0], path)), path


# ---------------------------------------------------------------------------
# Trainer: checkpoint and restart
# ---------------------------------------------------------------------------
def test_trainer_resume_is_bit_exact(tmp_path):
    """Six steps straight equal three steps, a restore from disk and three
    more, bit for bit, weights and optimizer state."""
    model = build(get_config("tiny_dense"))
    params0 = model.init(torch.Generator().manual_seed(0))
    _, _, corpus = _tiny()
    data = _data(corpus, 8, 64)

    def data_fn(step):
        return {"tokens": torch.as_tensor(data(step))}

    opt = OPT.adamw(1e-3)
    step = make_train_step(model.loss, opt)
    p = T.tree_map(lambda t: t.clone(), params0)  # the step writes in place
    s = opt.init(p)
    for i in range(6):
        p, s, _, _ = step(p, s, data_fn(i), None)
    straight = {"params": p, "opt_state": s}

    ck = str(tmp_path / "ck")
    tr = Trainer(step_fn=step, data_fn=data_fn, ckpt_dir=ck, ckpt_every=3, log_every=1)
    p = T.tree_map(lambda t: t.clone(), params0)
    p, s, hist = tr.run(p, opt.init(p), 0, 3)
    assert [h[0] for h in hist] == [0, 1, 2] and CK.latest_step(ck) == 3
    template = {"params": model.init(torch.Generator().manual_seed(9)),
                "opt_state": opt.init(p)}
    restored = CK.restore(ck, template)
    p2, s2, _ = tr.run(restored["params"], restored["opt_state"], 3, 3)
    assert CK.latest_step(ck) == 6
    for (pa, a), (pb, b) in zip(CK._flatten(straight),
                                CK._flatten({"params": p2, "opt_state": s2})):
        assert pa == pb and torch.equal(a, b), pa


def test_trainer_final_save_holds_the_end_state(tmp_path):
    model = build(get_config("tiny_dense"))
    p = model.init(torch.Generator().manual_seed(0))
    _, _, corpus = _tiny()
    data = _data(corpus, 4, 32)
    opt = OPT.adamw(1e-3)
    tr = Trainer(step_fn=make_train_step(model.loss, opt),
                 data_fn=lambda s: {"tokens": torch.as_tensor(data(s))},
                 ckpt_dir=str(tmp_path), ckpt_every=4, log_every=2)
    p, s, hist = tr.run(p, opt.init(p), 0, 5)
    assert [h[0] for h in hist] == [0, 2, 4]
    assert sorted(d.name for d in tmp_path.iterdir()) == ["step_00000004", "step_00000005"]
    out = CK.restore(str(tmp_path), {"params": p, "opt_state": s})
    assert int(out["opt_state"]["step"]) == 5
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(CK._flatten(out["params"]),
                                                           CK._flatten(p)))


# ---------------------------------------------------------------------------
# launch/train.py against the reference's train step and Trainer
# ---------------------------------------------------------------------------
def test_train_cli_resumes_and_matches_reference(tmp_path, capsys):
    """12 steps with checkpoints every 6, then ``--steps 16`` resumes from
    step 12; the losses and the final checkpoint equal the reference's
    ``make_train_step`` + ``Trainer`` on the same data order and schedule
    from the same weights. The reference restores the port's checkpoint."""
    model, params, corpus = _tiny()
    ck = str(tmp_path / "ck")
    spec = TRAIN.TrainSpec(steps=12, batch=4, seq=32, ckpt_dir=ck, ckpt_every=6)
    carried = interop.params_to_torch(jax.tree.map(np.asarray, params), "cpu")
    first = TRAIN.run(get_config("tiny_dense"), spec, "cpu", params=carried)
    assert [s for s, _ in first.history] == [0, 10]
    assert sorted(d.name for d in (tmp_path / "ck").iterdir()) == [
        "step_00000006", "step_00000012"]
    second = TRAIN.main(["--steps", "16", "--batch", "4", "--seq", "32", "--ckpt-dir", ck,
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 12" in out and "4 steps in" in out
    assert second.start == 12 and CK.latest_step(ck) == 16

    ropt = ROPT.adamw(RSCH.warmup_cosine(3e-3, warmup=20, total=21))
    rstep = jax.jit(ref_make_train_step(model.loss, ropt))
    rcorpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=model.cfg.vocab_size, seed=0))

    def data_fn(step):
        r = np.random.default_rng((0 << 20) + step)
        return {"tokens": jnp.asarray(np.stack([rcorpus.sample(r, 32) for _ in range(4)]))}

    rtr = RTrainer(step_fn=rstep, data_fn=data_fn, log_every=10)
    rp, rs, rhist = rtr.run(params, ropt.init(params), 0, 16)
    assert [s for s, _ in rhist] == [s for s, _ in first.history]
    for (_, a), (_, b) in zip(first.history, rhist):
        assert a == pytest.approx(b, rel=1e-5)
    # the reference reads the port's step-16 checkpoint
    got = RCK.restore(ck, {"params": params, "opt_state": ropt.init(params)}, step=16)
    assert int(got["opt_state"]["step"]) == 16
    moved = rtr.run(jax.tree.map(lambda a: a * MOVE, params), ropt.init(params), 0, 16)[0]
    for a, want, m in zip(*(jax.tree.leaves(t) for t in (got["params"], rp, moved))):
        tol = max(1e-5, 2 * _rel(m, want))
        assert _rel(a, want) <= tol, tol


# ---------------------------------------------------------------------------
# the driver's pretraining
# ---------------------------------------------------------------------------
def test_pretrain_matches_reference():
    """``ebft_run.run`` with 25 pretraining steps on the reference's
    weights against the reference's ``pretrain`` and its prune and EBFT:
    the recorded losses (steps 0, 20, 24) within rel 1e-5; the dense,
    pruned and EBFT perplexities within rel 1e-4."""
    spec = ebft_run.RunSpec(seed=0, seq=64, batch=8, calib_samples=16, pretrain_steps=25,
                            epochs=2, bench_out="")
    model, params, _ = _tiny()
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=model.cfg.vocab_size, seed=0))
    OM.set_registry(OM.Metrics())
    try:
        trained = ref_pretrain(model, params, corpus, spec.pretrain_steps, spec.batch, spec.seq,
                               ebft_run.PRETRAIN_LR, say=lambda *_: None)
        ref_losses = OM.series("pretrain/loss").points
    finally:
        OM.set_registry(None)
    calib = RTOK.calibration_set(corpus, spec.calib_samples, spec.seq)
    ev = RTOK.eval_set(corpus, ebft_run.EVAL_SAMPLES, spec.seq)
    ref = {"dense": ref_perplexity(model, trained, ev)}
    masks, pruned = ref_prune(model, trained, calib, method="wanda", sparsity=spec.sparsity)
    ref["wanda"] = ref_perplexity(model, pruned, ev)
    tuned, _ = REBFT.finetune(model, trained, pruned, masks, calib,
                              REBFT.EBFTConfig(lr=spec.lr, epochs=spec.epochs))
    ref["EBFT"] = ref_perplexity(model, tuned, ev)

    carried = interop.params_to_torch(jax.tree.map(np.asarray, params), "cpu")
    before = T.tree_map(lambda t: t.clone(), carried)
    res = ebft_run.run(get_config("tiny_dense"), spec, "cpu", params=carried)
    assert [s for s, _, _ in res.pretrain_losses] == [int(s) for s, _ in ref_losses] == [0, 20, 24]
    for (_, loss, gnorm), (_, want) in zip(res.pretrain_losses, ref_losses):
        assert loss == pytest.approx(want, rel=1e-5) and np.isfinite(gnorm)
    for k, v in ref.items():
        assert res.perplexity[k] == pytest.approx(v, rel=1e-4), k
    assert list(res.phases) == ["pretrain", "eval_dense", "prune", "ebft", "eval_ebft"]
    # the caller's weights are left as they were; the run's carry no autograd state
    assert all(torch.equal(a, T.get_path(before, p)) for p, a in T.leaves_with_path(carried))
    assert not any(t.requires_grad for _, t in T.leaves_with_path(res.dense))
    assert res.perplexity["EBFT"] < res.perplexity["wanda"]
