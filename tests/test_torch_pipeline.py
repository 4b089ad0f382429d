"""The port's prune-and-evaluate slice against the reference path on the
same weights (tiny_dense, CPU), and its token pipeline against the
reference's. Stated tolerance: perplexities within rel 1e-4."""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.evaluate import perplexity as ref_perplexity
from repro.core.masks import prune as ref_prune
from repro.data import tokens as RTOK
from repro.models.model import build as ref_build
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.evaluate import perplexity
from repro_torch.data import tokens as TOK
from repro_torch.launch import ebft_run
from repro_torch.models.model import build

from _torch_threads import one_thread_module  # noqa: F401

REL = 1e-4


@pytest.mark.parametrize("vocab,seed", [(512, 0), (32000, 3)])
def test_tokens_equal_reference(vocab, seed):
    ref = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=vocab, seed=seed))
    port = TOK.SyntheticCorpus(TOK.CorpusConfig(vocab_size=vocab, seed=seed))
    np.testing.assert_array_equal(TOK.calibration_set(port, 3, 64),
                                  RTOK.calibration_set(ref, 3, 64))
    np.testing.assert_array_equal(TOK.eval_set(port, 2, 48), RTOK.eval_set(ref, 2, 48))
    np.testing.assert_array_equal(next(TOK.corpus_iterator(port, 2, 32, seed=1)),
                                  next(RTOK.corpus_iterator(ref, 2, 32, seed=1)))
    for got, want in zip(TOK.cloze_task(port, 2, 32), RTOK.cloze_task(ref, 2, 32)):
        np.testing.assert_array_equal(got, want)


def test_sampler_equals_reference_on_long_segments():
    """The port's sampler builds each Markov CDF once (the reference's
    ``rng.choice`` builds it per token): the same tokens, bit for bit, on
    LoRA-sized batches of the Llama vocabulary."""
    ref = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=32000, seed=1))
    port = TOK.SyntheticCorpus(TOK.CorpusConfig(vocab_size=32000, seed=1))
    np.testing.assert_array_equal(next(TOK.corpus_iterator(port, 2, 2048, seed=9)),
                                  next(RTOK.corpus_iterator(ref, 2, 2048, seed=9)))


@pytest.mark.parametrize("method,sparsity,pattern",
                         [("wanda", 0.7, ""), ("wanda", 0.5, "2:4"), ("magnitude", 0.5, "")])
def test_run_matches_reference_path(method, sparsity, pattern):
    spec = ebft_run.RunSpec(seed=0, seq=64, method=method, sparsity=sparsity,
                            pattern=pattern, calib_samples=16, pretrain_steps=0, epochs=0)
    cfg = ref_get_config("tiny_dense")
    ref_model = ref_build(cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(spec.seed))
    corpus = RTOK.SyntheticCorpus(RTOK.CorpusConfig(vocab_size=cfg.vocab_size, seed=spec.seed))
    calib = RTOK.calibration_set(corpus, spec.calib_samples, spec.seq)
    ev = RTOK.eval_set(corpus, 16, spec.seq)
    pat = tuple(int(x) for x in pattern.split(":")) if pattern else None
    ref_dense = ref_perplexity(ref_model, ref_params, ev)
    _, ref_pruned = ref_prune(ref_model, ref_params, calib, method=method,
                              sparsity=sparsity, pattern=pat)
    ref_sparse = ref_perplexity(ref_model, ref_pruned, ev)

    params = interop.params_to_torch(jax.tree.map(np.asarray, ref_params), "cpu")
    res = ebft_run.run(get_config("tiny_dense"), spec, "cpu", params=params)
    assert res.perplexity["dense"] == pytest.approx(ref_dense, rel=REL)
    assert res.perplexity[method] == pytest.approx(ref_sparse, rel=REL)
    assert set(res.phases) == {"kernel_tune", "eval_dense", "prune", "ebft", "eval_ebft"}
    assert res.sparsity == pytest.approx(sparsity, abs=0.02)


def test_perplexity_weights_microbatches_by_rows():
    """A ragged last microbatch counts by its row count, as the reference."""
    cfg = get_config("tiny_dense")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (5, 16))
    nll = [float(model.loss(params, {"tokens": torch.as_tensor(toks[s:s + 2])})[0])
           for s in (0, 2, 4)]
    want = np.exp((nll[0] * 2 + nll[1] * 2 + nll[2] * 1) / 5)
    assert perplexity(model, params, toks, microbatch=2) == pytest.approx(want, rel=1e-6)


def test_main_cli_writes_bench(tmp_path):
    out = tmp_path / "bench.json"
    res = ebft_run.main(["--arch", "tiny_dense", "--pretrain-steps", "0", "--epochs", "0",
                         "--calib-samples", "8", "--seq", "32", "--device", "cpu",
                         "--bench-out", str(out)])
    data = json.loads(out.read_text())
    assert set(data["phases"]) == {"kernel_tune", "eval_dense", "prune", "ebft", "eval_ebft"}
    assert data["perplexity"] == res.perplexity
    assert data["run_spec"]["method"] == "wanda"


def test_spec_defaults_mirror_reference():
    from repro.launch.api import RunSpec as RefSpec

    ref = RefSpec()
    for f in ("arch", "seed", "seq", "method", "sparsity", "pattern", "calib_samples",
              "pretrain_steps", "batch", "lr", "epochs"):
        assert getattr(ebft_run.RunSpec(), f) == getattr(ref, f), f


@pytest.mark.parametrize("argv", [[], ["--pretrain-steps", "5"], ["--epochs", "0"]])
def test_unported_tuning_raises(argv, tmp_path):
    """Pretraining (the default 200 steps, or 5) and ``--epochs 0`` run
    through to EBFT and raise nothing, on small batches; the bench JSON's
    phases are the reference's."""
    out = tmp_path / "bench.json"
    res = ebft_run.main(argv + ["--device", "cpu", "--bench-out", str(out), "--batch", "8",
                                "--seq", "32", "--calib-samples", "8"])
    steps = int(argv[1]) if argv[:1] == ["--pretrain-steps"] else 200
    assert list(json.loads(out.read_text())["phases"]) == [
        "kernel_tune", "pretrain", "eval_dense", "prune", "ebft", "eval_ebft"]
    assert [s for s, _, _ in res.pretrain_losses][-1] == steps - 1
    assert all(np.isfinite(loss) for _, loss, _ in res.pretrain_losses)


def test_run_refuses_params_on_another_device():
    cfg = get_config("tiny_dense")
    params = build(cfg).init(torch.Generator().manual_seed(0))
    params = {k: {kk: (vv.to("meta") if torch.is_tensor(vv) else vv) for kk, vv in v.items()}
              for k, v in params.items()}
    spec = ebft_run.RunSpec(pretrain_steps=0, epochs=0, calib_samples=8, seq=16)
    with pytest.raises(ValueError, match="params live on"):
        ebft_run.run(cfg, spec, "cpu", params=params)


def test_epochs_0_output_matches_reference(tmp_path):
    """``--epochs 0`` as the reference's driver writes it, on the same
    weights: the same phases, perplexities, blocks (each ``epochs_run`` 0)
    and ``ebft`` keys, and an EBFT perplexity equal to the pruned one within
    rel 1e-6; each perplexity the reference's within rel 1e-4."""
    from repro.launch import ebft_run as ref_ebft_run

    argv = ["--arch", "tiny_dense", "--pretrain-steps", "0", "--epochs", "0",
            "--calib-samples", "8", "--seq", "32"]
    ref_out = tmp_path / "ref.json"
    ref_ebft_run.main(argv + ["--kernel-tune", "off", "--bench-out", str(ref_out)])
    ref = json.loads(ref_out.read_text())

    spec = ebft_run.RunSpec(pretrain_steps=0, epochs=0, calib_samples=8, seq=32,
                            kernel_tune="off")
    ref_params = ref_build(ref_get_config("tiny_dense")).init(jax.random.PRNGKey(spec.seed))
    params = interop.params_to_torch(jax.tree.map(np.asarray, ref_params), "cpu")
    port = ebft_run.bench_record(spec, ebft_run.run(get_config("tiny_dense"), spec, "cpu",
                                                    params=params))
    assert list(port["phases"]) == ["eval_dense", "prune", "ebft", "eval_ebft"]
    assert set(port["phases"]) == set(ref["phases"])
    assert set(port["perplexity"]) == set(ref["perplexity"]) == {"dense", "wanda", "EBFT"}
    assert set(port["ebft"]) == set(ref["ebft"])
    assert len(port["blocks"]) == len(ref["blocks"]) == 2
    for b, rb in zip(port["blocks"], ref["blocks"]):
        assert set(b) <= set(rb) and b["epochs_run"] == rb["epochs_run"] == 0
        assert b["loss_after"] == pytest.approx(b["loss_before"], rel=1e-6)
    for out in (port, ref):
        ppl = out["perplexity"]
        assert ppl["EBFT"] == pytest.approx(ppl["wanda"], rel=1e-6)
    for k, v in ref["perplexity"].items():
        assert port["perplexity"][k] == pytest.approx(v, rel=REL), k
