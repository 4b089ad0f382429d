"""The port's EBFT slice against the JAX reference on tiny_dense, on the CPU.

Stated tolerances:
- Adam: rel 1e-6 (the same f32 formula; XLA and PyTorch may round a pow
  or a sqrt one ulp apart);
- plateau predicates: exact;
- block_loss, its gradient and reconstruction_error: rel 1e-5 (f32, sums
  taken in another order);
- finetune: epochs_run and early stops equal; loss_before, loss_after,
  history and the EBFT perplexity within rel 1e-4; tuned weights within
  1e-4 of the largest weight (8 epochs of Adam at lr 1e-2 carry the f32
  rounding of every step); pruned slots exactly 0.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import ebft as REBFT
from repro.core import reconstruction as RR
from repro.core.evaluate import perplexity as ref_perplexity
from repro.core.masks import prune as ref_prune
from repro.data.tokens import CorpusConfig, SyntheticCorpus, calibration_set, eval_set
from repro.models.model import build as ref_build
from repro.optim import optimizers as ROPT
from repro.optim import schedules as RSCHED
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import ebft as EBFT
from repro_torch.core import reconstruction as R
from repro_torch.core.evaluate import perplexity
from repro_torch.core.masks import expand_masks
from repro_torch.core.pruning import common as C
from repro_torch.launch import ebft_run
from repro_torch.models.model import build
from repro_torch.optim import optimizers as OPT
from repro_torch.optim import schedules as SCHED
from repro_torch.sparsity import sparse_params as SP

from _torch_threads import one_thread_module  # noqa: F401

ECFG = dict(lr=1e-2, epochs=8, microbatch=8, patience=3)  # tests/test_ebft.py:22
REL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------
def _adam_case(seed):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(5, 7)).astype(np.float32),
              "b": {"c": rng.normal(size=(3,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 0.1, params)
             for _ in range(4)]
    return params, grads


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("kind", ["adam", "adamw", "schedule"])
def test_adam_matches_reference(steps, kind):
    params, grads = _adam_case(steps)
    if kind == "adam":
        ref, port = ROPT.adam(1e-2), OPT.adam(1e-2)
    elif kind == "adamw":
        ref, port = ROPT.adamw(1e-2, weight_decay=0.1), OPT.adamw(1e-2, weight_decay=0.1)
    else:
        ref = ROPT.adam(lambda s: 1e-2 / s.astype(jnp.float32))
        port = OPT.adam(lambda s: 1e-2 / s.to(torch.float32))
    rp = jax.tree.map(jnp.asarray, params)
    tp = interop.params_to_torch(params, "cpu")
    rs, ts = ref.init(rp), port.init(tp)
    for g in grads[:steps]:
        upd, rs = ref.update(jax.tree.map(jnp.asarray, g), rs, rp)
        rp = ROPT.apply_updates(rp, upd)
        tupd, ts = port.update(interop.params_to_torch(g, "cpu"), ts, tp)
        assert OPT.apply_updates(tp, tupd) is tp  # in place
    assert int(ts["step"]) == steps and ts["step"].dtype == torch.int32
    for path, t in T.leaves_with_path(tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(T.get_path(rp, path)), rtol=1e-6,
                                   atol=1e-7)
        for mom in ("m", "v"):
            assert T.get_path(ts[mom], path).dtype == torch.float32
            np.testing.assert_allclose(T.get_path(ts[mom], path).numpy(),
                                       np.asarray(T.get_path(rs[mom], path)), rtol=1e-6,
                                       atol=1e-12)


def test_apply_updates_keeps_param_dtype():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    OPT.apply_updates(p, {"w": torch.full((4,), 0.5)})
    assert p["w"].dtype == torch.bfloat16 and float(p["w"][0]) == 1.5


# ---------------------------------------------------------------------------
# plateau predicate (the edge cases of tests/test_ebft_fused.py:152-187)
# ---------------------------------------------------------------------------
HISTORIES = [[], [1.0], [1.0, 0.9], [1.0, 0.5, 0.5, 0.5], [1.0, 0.8, 0.6, 0.4],
             [1.0, 0.99999, 0.99998, 0.99997], [2.0, 1.0, 1.5, 1.4, 1.45],
             [1.0, 0.5, 0.4, 0.41, 0.42, 0.43], [1.0, 1.0, 1.0]]


@pytest.mark.parametrize("patience", [-2, 0, 1, 2, 3, 5, 7])
def test_plateau_predicates_match_reference(patience):
    for h in HISTORIES:
        want = RSCHED.plateau_early_stop(h, patience, 1e-3)
        assert SCHED.plateau_early_stop(h, patience, 1e-3) is want, (h, patience)


# ---------------------------------------------------------------------------
# block_loss and reconstruction_error
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    """tiny_dense (dot attention) with the reference's init, its Wanda 0.7
    masks, and the same weights and masks in the port."""
    cfg = ref_get_config("tiny_dense")
    ref_model = ref_build(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=0))
    calib = calibration_set(corpus, 16, 32)
    ev = eval_set(corpus, 16, 32)
    ref_masks, ref_pruned = ref_prune(ref_model, ref_params, calib, method="wanda",
                                      sparsity=0.7)
    params = interop.params_to_torch(_np(ref_params), "cpu")
    pruned = interop.params_to_torch(_np(ref_pruned), "cpu")
    masks = expand_masks(params, interop.masks_to_torch(_np(ref_masks), "cpu"))
    return dict(ref_model=ref_model, ref_params=ref_params, ref_masks=ref_masks,
                ref_pruned=ref_pruned, model=build(get_config("tiny_dense")), params=params,
                pruned=pruned, masks=masks, calib=calib, ev=ev)


def _block_inputs(seed, d):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(2, 16, d)).astype(np.float32)
    target = rng.normal(size=(2, 16, d)).astype(np.float32)
    return h, target, np.arange(16)[None, :]


@pytest.mark.parametrize("block", [0, 1])
def test_block_loss_and_grad_match_reference(setup, block):
    s = setup
    h, target, pos = _block_inputs(block, s["model"].cfg.d_model)
    rbp = s["ref_model"].get_block(s["ref_pruned"], block)
    rmb = s["ref_model"].get_block(s["ref_masks"], block)
    args = (jnp.asarray(h), jnp.asarray(target), jnp.asarray(pos), {})
    ref_loss, ref_grads = jax.value_and_grad(
        lambda bw: RR.block_loss(s["ref_model"], block, bw, rmb, *args))(rbp)
    ref_err = RR.reconstruction_error(s["ref_model"], block, rbp, rmb, *args)

    model = s["model"]
    bw = T.tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    model.get_block(s["pruned"], block))
    mb = model.get_block(s["masks"], block)
    targs = (torch.tensor(h), torch.tensor(target), torch.tensor(pos))
    loss = R.block_loss(model, block, bw, mb, *targs)
    leaves = [t for _, t in T.leaves_with_path(bw)]
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    for (path, _), g in zip(T.leaves_with_path(bw), grads):
        want = np.asarray(T.get_path(ref_grads, path))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
        if SP.is_prunable(path, g):  # the mask's chain rule: exactly 0 gradient
            assert bool((g[~T.get_path(mb, path)] == 0).all())
    with torch.no_grad():
        err = R.reconstruction_error(model, block, bw, mb, *targs)
    assert float(err) == pytest.approx(float(ref_err), rel=1e-5)


def test_block_kind_is_the_reference_kind(setup):
    s = setup
    assert R.block_kind(s["model"], 1) == RR.block_kind(s["ref_model"], 1) == "block"


# ---------------------------------------------------------------------------
# finetune against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tuned(setup):
    s = setup
    ref_tuned, ref_reports = REBFT.finetune(s["ref_model"], s["ref_params"], s["ref_pruned"],
                                            s["ref_masks"], s["calib"],
                                            REBFT.EBFTConfig(**ECFG))
    port_tuned, port_reports = EBFT.finetune(s["model"], s["params"], s["pruned"], s["masks"],
                                             s["calib"], EBFT.EBFTConfig(**ECFG))
    return ref_tuned, ref_reports, port_tuned, port_reports


def _assert_reports_match(ref_reports, port_reports):
    assert len(port_reports) == len(ref_reports)
    for a, b in zip(ref_reports, port_reports):
        assert (b.index, b.kind, b.epochs_run, b.early_stop) == \
            (a.index, a.kind, a.epochs_run, a.early_stop)
        assert b.loss_before == pytest.approx(a.loss_before, rel=REL)
        assert b.loss_after == pytest.approx(a.loss_after, rel=REL)
        np.testing.assert_allclose(b.history, a.history, rtol=REL)


def test_finetune_matches_reference(setup, tuned):
    s = setup
    ref_tuned, ref_reports, port_tuned, port_reports = tuned
    _assert_reports_match(ref_reports, port_reports)
    for r, ref in zip(port_reports, ref_reports):
        # the reference's default, its fused loop: one dispatch, one host read
        assert r.path == ref.path == "fused" and r.loss_after < r.loss_before
        assert (r.dispatches, r.host_syncs) == (ref.dispatches, ref.host_syncs) == (1, 1)
        assert r.live_bytes > 0
    ref_np = _np(ref_tuned)
    for path, t in T.leaves_with_path(port_tuned):
        want = T.get_path(ref_np, path)
        np.testing.assert_allclose(t.numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
    ppl = perplexity(s["model"], port_tuned, s["ev"], masks=s["masks"])
    assert ppl == pytest.approx(ref_perplexity(s["ref_model"], ref_tuned, s["ev"]), rel=REL)


def test_finetune_keeps_pruned_slots_zero_and_inputs_intact(setup, tuned):
    s = setup
    port_tuned = tuned[2]
    for path, m in T.leaves_with_path(s["masks"]):
        if SP.is_prunable(path, m):
            assert bool((T.get_path(port_tuned, path)[~m] == 0.0).all()), path
    # the dense teacher and the pruned input trees are not written
    ref_np = _np(s["ref_params"])
    for path, t in T.leaves_with_path(s["params"]):
        np.testing.assert_array_equal(t.numpy(), T.get_path(ref_np, path))
    ref_np = _np(s["ref_pruned"])
    for path, t in T.leaves_with_path(s["pruned"]):
        np.testing.assert_array_equal(t.numpy(), T.get_path(ref_np, path))


def test_ragged_calibration_takes_the_list_walk(setup):
    """12 segments in microbatches of 8 are ragged (8 + 4): the port's list
    walk and the reference's legacy loop give the same numbers."""
    s = setup
    calib = s["calib"][:12]
    cfg = dict(ECFG, epochs=3)
    _, ref_reports = REBFT.finetune(s["ref_model"], s["ref_params"], s["ref_pruned"],
                                    s["ref_masks"], calib, REBFT.EBFTConfig(**cfg))
    assert all(r.path == "legacy" for r in ref_reports)
    _, reports = EBFT.finetune(s["model"], s["params"], s["pruned"], s["masks"], calib,
                               EBFT.EBFTConfig(**cfg))
    _assert_reports_match(ref_reports, reports)


@pytest.mark.parametrize("n_calib", [16, 12])
def test_dual_stream_targets_are_the_dense_stream(setup, n_calib):
    """Each visit's ``target_mb`` is the dense model's stream after its
    block, and its ``h_mb`` the student's stream before it (Eq. 3/4)."""
    s = setup
    model, params, calib = s["model"], s["params"], s["calib"][:n_calib]
    student = SP.apply_masks(s["pruned"], s["masks"])
    seen = {}

    def visit(i, bp, ctx):
        seen[i] = ([t.clone() for t in ctx["target_mb"]], [h.clone() for h in ctx["h_mb"]],
                   [p.clone() for p in ctx["pos_mb"]])

    C.walk_blocks(model, params, calib, visit, params_student=student, masks=s["masks"],
                  dual_stream=True)
    assert sorted(seen) == list(range(model.cfg.num_layers))
    (seg,) = R.execution_plan(model)
    for mb_idx, start in enumerate(range(0, n_calib, 8)):
        batch = {"tokens": torch.as_tensor(calib[start:start + 8])}
        ht, pos = seg.h0(params, batch)
        hs, _ = seg.h0(student, batch)
        for i in range(model.cfg.num_layers):
            targets, hs_mb, pos_mb = seen[i]
            assert torch.equal(pos_mb[mb_idx], pos)
            assert torch.equal(hs_mb[mb_idx], hs)
            with torch.no_grad():
                ht = R.advance_with(model, params, i, model.get_block(params, i), ht, pos)
                hs = R.advance_with(model, student, i, model.get_block(student, i), hs, pos,
                                    model.get_block(s["masks"], i))
            assert torch.equal(targets[mb_idx], ht), (i, mb_idx)


def test_dual_stream_walk_refuses_to_write_the_teacher(setup):
    s = setup
    with pytest.raises(ValueError, match="student tree of its own"):
        C.walk_blocks(s["model"], s["params"], s["calib"], lambda i, bp, ctx: None,
                      dual_stream=True)


def test_mesh_plan_is_refused(setup, tuned):
    """An inactive plan (``make_ebft_plan(1, 1)``, ``ebft_run``'s default) is
    the single-device path: the reference's reports within the file's
    tolerance, and the bits of ``mesh_plan=None``. What is not a MeshPlan
    is still refused. (Active plans: tests/test_torch_mesh_ebft.py.)"""
    from repro_torch.distributed.meshplan import MeshPlan
    from repro_torch.launch.mesh import make_ebft_plan

    s = setup
    ref_tuned, ref_reports, port_tuned, port_reports = tuned
    plan = make_ebft_plan(1, 1)
    assert plan == MeshPlan.single() and not plan.active
    got, reports = EBFT.finetune(s["model"], s["params"], s["pruned"], s["masks"], s["calib"],
                                 EBFT.EBFTConfig(**ECFG, mesh_plan=plan))
    _assert_reports_match(ref_reports, reports)
    assert [r.asdict() for r in reports] == [r.asdict() for r in port_reports]
    for path, t in T.leaves_with_path(got):
        assert torch.equal(t, T.get_path(port_tuned, path)), path
    with pytest.raises(TypeError, match="MeshPlan"):
        EBFT.finetune(s["model"], s["params"], s["pruned"], s["masks"], s["calib"],
                      EBFT.EBFTConfig(mesh_plan=object()))


def test_config_and_report_fields_mirror_reference():
    """The port's fields are the reference's that it reads, with the same
    defaults and order."""
    ref = [(f.name, f.default) for f in dataclasses.fields(REBFT.EBFTConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(EBFT.EBFTConfig)]
    assert port == [r for r in ref if r in port] and len(port) == 8
    ref = [f.name for f in dataclasses.fields(REBFT.BlockReport)]
    port = [f.name for f in dataclasses.fields(EBFT.BlockReport)]
    assert port == ref and len(port) == 14


# ---------------------------------------------------------------------------
# the pipeline command (ebft_run)
# ---------------------------------------------------------------------------
def test_ebft_run_writes_the_reference_sections(tmp_path):
    out = tmp_path / "bench.json"
    res = ebft_run.main(["--arch", "tiny_dense", "--pretrain-steps", "0", "--epochs", "2",
                         "--calib-samples", "16", "--seq", "32", "--device", "cpu",
                         "--bench-out", str(out)])
    data = json.loads(out.read_text())
    assert set(data["phases"]) == {"kernel_tune", "eval_dense", "prune", "ebft", "eval_ebft"}
    assert data["perplexity"] == res.perplexity and np.isfinite(data["perplexity"]["EBFT"])
    assert len(data["blocks"]) == 2
    assert set(data["blocks"][0]) == {f.name for f in dataclasses.fields(EBFT.BlockReport)}
    assert set(data["blocks"][0]) == {f.name for f in dataclasses.fields(REBFT.BlockReport)}
    assert set(data["ebft"]) == {"num_blocks", "mean_e_drop", "peak_live_block_bytes",
                                 "fused_epochs", "prefetch_depth", "early_stops"}
    assert (data["ebft"]["fused_epochs"], data["ebft"]["prefetch_depth"]) == (True, 1)
    assert data["ebft"]["num_blocks"] == 2 and data["run_spec"]["lr"] == 1e-2
    assert all(b["epochs_run"] <= 2 for b in data["blocks"])
