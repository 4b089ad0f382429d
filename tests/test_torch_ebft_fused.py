"""The port's fused EBFT path (``core/ebft.py``'s fused loop, the stacked
dual-stream walk and its teacher prefetcher in ``core/pruning/common.py``)
on the CPU: the counterparts of ``tests/test_ebft_fused.py``.

Stated tolerances:
- the fused loop against the port's per-epoch loop, every prefetch depth
  against another, the stacked walk against the list walk: bit for bit
  (``torch.equal``; the same operations on the same values, in the same
  order);
- the port's fused path against the reference's on tiny_dense: equal
  epochs and early stops, histories and losses within rel 1e-4 (f32,
  sums taken in another order).

Each setting tunes 16 segments of 32 tokens in microbatches of 8 for 4
epochs; ``PLATEAU`` (rel_tol 0.5, patience 2) stops every block after 2
of them, so the fused loop's predicated epochs run.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import ebft as REBFT
from repro.core.masks import prune as ref_prune
from repro.launch.api import RunSpec as RefSpec
from repro.models.model import build as ref_build
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.core import ebft as EBFT
from repro_torch.core.masks import expand_masks, prune
from repro_torch.core.pruning import common as C
from repro_torch.launch import ebft_run
from repro_torch.launch.api import to_manifest
from repro_torch.models.model import build
from repro_torch.obs.run import validate_payload
from repro_torch.obs.sinks import load_artifact
from repro_torch.sparsity import sparse_params as SP

from _torch_threads import one_thread_module  # noqa: F401

BASE = dict(lr=1e-2, epochs=4, microbatch=8, patience=2)
PLATEAU = dict(BASE, rel_tol=0.5)
FAMILIES = ["tiny_dense", "tiny_moe", "tiny_ssm", "tiny_hybrid", "tiny_vlm", "tiny_encdec"]
REL = 1e-4


def _extra(cfg, n: int, seq: int):
    """The frontend arrays of a batch of ``n`` segments (``Model.input_specs``)."""
    rng = np.random.default_rng(1)
    if cfg.family == "vlm":
        P = min(cfg.frontend_len, seq // 2)
        return {"patches": rng.normal(size=(n, P, cfg.d_model)).astype(np.float32)}, seq - P
    if cfg.family == "encdec":
        F = max(cfg.frontend_len, seq // 8)
        return {"frames": rng.normal(size=(n, F, cfg.d_model)).astype(np.float32)}, seq
    return None, seq


def _family(arch: str, n: int = 16, seq: int = 32) -> dict:
    """The port's model with seeded weights and its magnitude 0.5 masks."""
    cfg = get_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    extra, tokens = _extra(cfg, n, seq)
    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(n, tokens)).astype(np.int32)
    masks, pruned = prune(model, params, calib, method="magnitude", sparsity=0.5,
                          extra_batch=extra)
    return dict(model=model, params=params, masks=masks, pruned=pruned, calib=calib,
                extra=extra)


def _finetune(s: dict, calib=None, **kw):
    return EBFT.finetune(s["model"], s["params"], s["pruned"], s["masks"],
                         s["calib"] if calib is None else calib, EBFT.EBFTConfig(**kw),
                         extra_batch=s["extra"])


def _assert_same_bits(a, b):
    (tuned_a, reps_a), (tuned_b, reps_b) = a, b
    assert [(r.index, r.kind, r.epochs_run, r.early_stop, r.history, r.loss_before,
             r.loss_after) for r in reps_a] == \
        [(r.index, r.kind, r.epochs_run, r.early_stop, r.history, r.loss_before, r.loss_after)
         for r in reps_b]
    for path, t in T.leaves_with_path(tuned_a):
        assert torch.equal(t, T.get_path(tuned_b, path)), path


@pytest.fixture(scope="module")
def dense():
    return _family("tiny_dense")


# ---------------------------------------------------------------------------
# the fused loop against the per-epoch loop, every family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_fused_equals_legacy_bit_for_bit(arch):
    s = _family(arch)
    for cfg in (BASE, PLATEAU):
        fused = _finetune(s, **cfg)
        legacy = _finetune(s, **cfg, fused_epochs=False)
        assert {r.path for r in fused[1]} == {"fused"}
        assert {r.path for r in legacy[1]} == {"legacy"}
        _assert_same_bits(fused, legacy)
    # the plateau setting stops every block before its last epoch
    assert all((r.epochs_run, r.early_stop) == (2, "plateau") for r in fused[1])
    if arch == "tiny_hybrid":  # the shared block, tuned on its sites, reports last
        assert fused[1][-1].kind == "shared"


@pytest.mark.parametrize("setting", ["base", "plateau"])
def test_fused_matches_the_reference(setting):
    """The reference's fused path (its default) from the same weights and
    masks: equal epochs and stops, histories within rel 1e-4."""
    cfg = BASE if setting == "base" else PLATEAU
    rcfg = ref_get_config("tiny_dense")
    ref_model = ref_build(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    calib = np.random.default_rng(0).integers(0, rcfg.vocab_size, size=(16, 32)).astype(np.int32)
    ref_masks, ref_pruned = ref_prune(ref_model, ref_params, calib, method="wanda",
                                      sparsity=0.7)
    _, ref_reports = REBFT.finetune(ref_model, ref_params, ref_pruned, ref_masks, calib,
                                    REBFT.EBFTConfig(**cfg))
    params = interop.params_to_torch(jax.tree.map(np.asarray, ref_params), "cpu")
    pruned = interop.params_to_torch(jax.tree.map(np.asarray, ref_pruned), "cpu")
    masks = expand_masks(params, interop.masks_to_torch(jax.tree.map(np.asarray, ref_masks),
                                                        "cpu"))
    _, reports = EBFT.finetune(build(get_config("tiny_dense")), params, pruned, masks, calib,
                               EBFT.EBFTConfig(**cfg))
    assert len(reports) == len(ref_reports) == 2
    for a, b in zip(ref_reports, reports):
        assert (b.path, b.epochs_run, b.early_stop) == (a.path, a.epochs_run, a.early_stop)
        assert (b.dispatches, b.host_syncs) == (a.dispatches, a.host_syncs) == (1, 1)
        np.testing.assert_allclose(b.history, a.history, rtol=REL)
        assert b.loss_after == pytest.approx(a.loss_after, rel=REL)
    if setting == "plateau":
        assert all(r.early_stop == "plateau" and r.epochs_run < cfg["epochs"]
                   for r in ref_reports)


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_depth_changes_no_bit(dense, depth):
    _assert_same_bits(_finetune(dense, **PLATEAU, prefetch_depth=depth),
                      _finetune(dense, **PLATEAU, prefetch_depth=1))


def test_ragged_microbatches_fall_back_to_legacy(dense):
    """12 segments in microbatches of 8 are ragged (8 + 4): every block
    runs the per-epoch loop, the bits of ``fused_epochs=False``."""
    calib = dense["calib"][:12]
    got = _finetune(dense, calib, **BASE)
    assert {r.path for r in got[1]} == {"legacy"}
    _assert_same_bits(got, _finetune(dense, calib, **BASE, fused_epochs=False))


@pytest.mark.parametrize("arch", ["tiny_dense", "tiny_hybrid"])
def test_callers_trees_are_untouched(arch):
    """The pruned params, the dense params and the masks come back as they
    went in (the hybrid's shared block, whose leaves ``get_block`` returns
    as they are stored, included), and a second run repeats the first."""
    s = _family(arch)
    before = {k: T.tree_map(lambda t: t.clone(), s[k]) for k in ("params", "pruned", "masks")}
    first = _finetune(s, **PLATEAU)
    for k, tree in before.items():
        for path, t in T.leaves_with_path(tree):
            assert torch.equal(t, T.get_path(s[k], path)), (k, path)
    _assert_same_bits(first, _finetune(s, **PLATEAU))
    for path, m in T.leaves_with_path(s["masks"]):
        if SP.is_prunable(path, m):  # pruned slots stay 0
            assert bool((T.get_path(first[0], path)[~m] == 0).all()), path


def test_dispatch_budget(dense):
    """A fused block: 1 dispatch and 1 host sync (with the walk's two
    stream advances, 3 <= epochs + 2, the reference's gate); a legacy
    block dispatches per microbatch and epoch."""
    _, fused = _finetune(dense, **BASE)
    _, legacy = _finetune(dense, **BASE, fused_epochs=False)
    for r in fused:
        assert (r.dispatches, r.host_syncs) == (1, 1)
        assert r.dispatches + 2 <= BASE["epochs"] + 2
    for r in legacy:
        assert r.dispatches > r.epochs_run and r.host_syncs == r.epochs_run + 2


# ---------------------------------------------------------------------------
# helpers: stacking, Unstacked, the stacked walk and its prefetcher
# ---------------------------------------------------------------------------
def test_stacking_helper_rejects_ragged_and_empty():
    a = (torch.ones(2, 3), torch.zeros(2), {"m": torch.ones(2, 1)})
    b = (torch.full((2, 3), 2.0), torch.ones(2), {"m": torch.zeros(2, 1)})
    stacked = EBFT._stack_microbatches([a, b])
    assert stacked[0].shape == (2, 2, 3) and stacked[2]["m"].shape == (2, 2, 1)
    assert torch.equal(stacked[0][1], b[0]) and torch.equal(stacked[1][0], a[1])
    assert EBFT._stack_microbatches([a, (torch.ones(1, 3), torch.zeros(1), {"m": a[2]["m"]})]) \
        is None
    assert EBFT._stack_microbatches([a, (a[0], a[1], {})]) is None  # another structure
    assert EBFT._stack_microbatches([]) is None


def test_unstacked_views():
    st = (torch.arange(12.0).reshape(3, 2, 2), {"m": torch.arange(3.0)})
    u = C.Unstacked(st, 3)
    assert len(u) == 3
    h, aux = u[1]
    assert torch.equal(h, st[0][1]) and float(aux["m"]) == 1.0
    assert h.data_ptr() == st[0][1].data_ptr()  # a view, no copy
    assert torch.equal(u[-1][0], st[0][2])
    assert [float(x[1]["m"]) for x in u] == [0.0, 1.0, 2.0]
    for j in (3, -4):
        with pytest.raises(IndexError):
            u[j]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_stacked_walk_targets_equal_the_list_walk(dense, depth, monkeypatch):
    """The stacked walk hands each visit the list walk's student inputs
    and teacher targets bit for bit, with at most depth + 1 visits'
    targets alive."""
    s = dense
    model, params = s["model"], s["params"]
    student = SP.apply_masks(s["pruned"], s["masks"])
    inflight = []
    orig = C.TeacherPrefetcher._dispatch_until

    def spy(self, k):
        orig(self, k)
        inflight.append(self.in_flight())

    monkeypatch.setattr(C.TeacherPrefetcher, "_dispatch_until", spy)

    def record(seen):
        def visit(i, bp, ctx):
            seen[i] = [[t.clone() for t in ctx[k]] for k in ("h_mb", "target_mb", "pos_mb")]
            seen[i].append("h_st" in ctx)
        return visit

    stacked, listed = {}, {}
    C.walk_blocks(model, params, s["calib"], record(stacked), params_student=student,
                  masks=s["masks"], dual_stream=True, prefetch_depth=depth)
    batches = C._make_batches(s["calib"], 8, torch.device("cpu"))
    C._walk(model, params, SP.apply_masks(s["pruned"], s["masks"]), batches, record(listed),
            s["masks"], True, lambda x: x)
    assert sorted(stacked) == sorted(listed) == [0, 1]
    for i in stacked:
        assert stacked[i][3] and not listed[i][3]
        for got, want in zip(stacked[i][:3], listed[i][:3]):
            assert len(got) == len(want) == 2
            assert all(torch.equal(a, b) for a, b in zip(got, want)), i
    assert inflight and max(inflight) <= depth + 1


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
ARGV = ["--arch", "tiny_dense", "--pretrain-steps", "0", "--calib-samples", "16", "--seq", "32",
        "--epochs", "2", "--kernel-tune", "off"]


def test_no_fused_epochs_flag_and_the_artifact(tmp_path):
    """``--no-fused-epochs`` runs the per-epoch loop; the default the fused
    one. Each artifact's ``ebft`` and ``dispatch`` settings follow the
    reference's rules, and the fused one passes the reference's CI gate,
    ``validate_payload(max_dispatches_per_block=epochs + 2)``."""
    runs = {}
    for name, extra in (("fused", []), ("legacy", ["--no-fused-epochs"])):
        out = tmp_path / f"{name}.json"
        res = ebft_run.main(ARGV + ["--device", "cpu", "--bench-out", str(out)] + extra)
        runs[name] = (res, load_artifact(str(out)))
    res, art = runs["fused"]
    assert {r.path for r in res.reports} == {"fused"}
    assert (art["ebft"]["fused_epochs"], art["ebft"]["prefetch_depth"]) == (True, 1)
    d = art["dispatch"]
    assert d["fused_all_blocks"] is True and d["tune_per_block_max"] == 1
    assert d["per_block_max"] == 3 and d["tune_host_syncs_per_block_max"] == 1
    assert d["walk_total"] == 4 + 2 * len(res.reports)
    assert validate_payload(art, max_dispatches_per_block=2 + 2) == []
    res, art = runs["legacy"]
    assert {r.path for r in res.reports} == {"legacy"}
    assert art["ebft"]["fused_epochs"] is False
    assert art["dispatch"]["fused_all_blocks"] is False
    assert art["dispatch"]["per_block_max"] == art["dispatch"]["tune_per_block_max"] > 4
    assert validate_payload(art, max_dispatches_per_block=2 + 2) != []
    # the same tuned bits either way
    for path, t in T.leaves_with_path(runs["fused"][0].tuned):
        assert torch.equal(t, T.get_path(runs["legacy"][0].tuned, path)), path


def test_prefetch_depth_zero_is_refused_with_the_reference_words(capsys):
    with pytest.raises(SystemExit) as exc:
        ebft_run.main(ARGV + ["--device", "cpu", "--prefetch-depth", "0"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    with pytest.raises(SystemExit):
        RefSpec.from_argv("ebft", ["--prefetch-depth", "0"])
    ref_err = capsys.readouterr().err
    words = ref_err.strip().splitlines()[-1].split("error: ", 1)[1]
    assert words.startswith("--prefetch-depth must be >= 1 (got 0)")
    assert err.strip().splitlines()[-1].split("error: ", 1)[1] == words


@pytest.mark.parametrize("argv", [[], ["--no-fused-epochs"], ["--prefetch-depth", "3"]])
def test_manifest_sections_equal_the_reference(argv):
    """The flat manifest keys of the same spec equal the reference's, and
    the artifact's ``ebft``/``dispatch`` settings follow them."""
    spec, _ = ebft_run.parse(ebft_run.RunSpec, ARGV + argv, "p", "")
    ref = RefSpec.from_argv("ebft", ARGV + argv).to_manifest()
    port = to_manifest(spec, "ebft")
    for key in ("ebft_lr", "ebft_epochs", "calib_samples", "seq", "seed", "fused_epochs",
                "prefetch_depth", "mesh"):
        assert port[key] == ref[key], key
    assert port["run_spec"]["no_fused_epochs"] == ref["run_spec"]["no_fused_epochs"]
    assert port["run_spec"]["prefetch_depth"] == ref["run_spec"]["prefetch_depth"]
    fields = {f.name for f in dataclasses.fields(ebft_run.RunSpec)}
    assert {"no_fused_epochs", "prefetch_depth"} <= fields
    rec = ebft_run.bench_record(spec, ebft_run.RunResult({}, {}, 0.0, None, None, None))
    assert (rec["ebft"]["fused_epochs"], rec["ebft"]["prefetch_depth"]) == \
        (ref["fused_epochs"], ref["prefetch_depth"])
    assert json.loads(json.dumps(rec["dispatch"]))["fused_all_blocks"] is False  # no block


# ---------------------------------------------------------------------------
# obs on two streams
# ---------------------------------------------------------------------------
class _Done:
    """An event pair's end with a fixed answer to ``query`` (no card here)."""

    def __init__(self, done: bool):
        self.done = done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end) -> float:
        return 1.0


def test_pending_pairs_are_booked_per_stream():
    """A prefetched teacher's launches on the side stream complete beside
    the tuning's: a pair still queued on one stream holds back only the
    later pairs of its own stream."""
    from repro_torch.obs import metrics as OM
    from repro_torch.obs import profile as P
    from repro_torch.obs.run import start_run

    run = start_run("t", device="cpu", console=False)
    dev = torch.device("cuda", 0)
    pairs = [("kernels/a", 1.0, 1.0, dev, _Done(True), _Done(True), "walk"),
             ("kernels/b", 1.0, 1.0, dev, _Done(False), _Done(False), "side"),
             ("kernels/a", 1.0, 1.0, dev, _Done(True), _Done(True), "walk"),
             ("kernels/b", 1.0, 1.0, dev, _Done(True), _Done(True), "side")]
    P._PENDING[:] = pairs
    try:
        P._book_completed()
        assert P._PENDING == pairs[1:2] + pairs[3:]
        assert OM.summary()["kernels/a/calls"]["value"] == 2.0
        assert "kernels/b/calls" not in OM.summary()
    finally:
        P.drop_pending_kernels()
        run.finish()
