"""The paper's pipeline as one command (port of ``repro.launch.ebft_run``):
build the dense model, take its perplexity, prune (magnitude, Wanda,
SparseGPT, DSnoT or FLAP) through the calibration walk, take the pruned
model's perplexity, tune it block by block with EBFT (``--epochs`` > 0) and
take the tuned model's perplexity; then the baselines the paper sets EBFT
against (``--baselines``, a comma list of ``dsnot``, ``mask``, ``lora``):
DSnoT's training-free reselection of the method's masks, mask tuning, and
200 LoRA steps on the LM loss, each with its perplexity. Every masked
linear runs on the masked matmul kernel, and each tuning step
backpropagates through the kernels' backward.

    python -m repro_torch.launch.ebft_run --arch tiny_dense --pretrain-steps 0 \
        --epochs 8 --method sparsegpt --sparsity 0.7 --baselines dsnot,mask,lora --device cpu

Runs on the card unless ``--device cpu``. Pretraining is not ported yet: a
run that asks for it raises. The bench JSON holds the reference's
``phases``, ``perplexity``, ``blocks`` and ``ebft`` sections.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ebft, lora, mask_tuning
from repro_torch.core.evaluate import perplexity
from repro_torch.core.masks import METHODS, prune
from repro_torch.core.pruning.flap import remaining_param_fraction
from repro_torch.data.tokens import (
    CorpusConfig, SyntheticCorpus, calibration_set, corpus_iterator, eval_set,
)
from repro_torch.models.model import build
from repro_torch.sparsity.sparse_params import sparsity_of

EVAL_SAMPLES = 16  # held-out segments, as the reference's eval_set
BASELINES = ("dsnot", "mask", "lora")
LORA = lora.LoRAConfig(steps=200, lr=1e-3)  # the reference driver's LoRA run


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """The fields of the reference's ``RunSpec`` (``repro.launch.api``)
    this path reads, with the same names and defaults."""

    arch: str = "tiny_dense"
    seed: int = 0
    seq: int = 128
    method: str = "wanda"
    sparsity: float = 0.7
    pattern: str = ""
    calib_samples: int = 64
    pretrain_steps: int = 200
    lr: float = 1e-2
    epochs: int = 10
    baselines: str = ""  # comma list of BASELINES
    bench_out: str = "BENCH_ebft.json"


@dataclasses.dataclass
class RunResult:
    perplexity: Dict[str, float]
    phases: Dict[str, float]
    sparsity: float
    masks: Any
    pruned: Any
    tuned: Any = None  # the EBFT-tuned params (``epochs`` > 0)
    reports: List[ebft.BlockReport] = dataclasses.field(default_factory=list)
    # per baseline run: "dsnot" and "mask" {"masks", "params"} (DSnoT also
    # "errors", each leaf's per-column |E| before and after, as
    # ``prune``'s scores_out; mask tuning "histories", each block's epoch
    # mean losses); "lora" {"params", "losses", each step's LM loss as a
    # 0-d device tensor}
    baselines: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)


def _parse(argv) -> tuple:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.ebft_run", description=__doc__)
    choices = {"method": METHODS}
    for f in dataclasses.fields(RunSpec):
        ap.add_argument("--" + f.name.replace("_", "-"), type=type(f.default),
                        default=f.default, choices=choices.get(f.name))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; never falls back")
    args = vars(ap.parse_args(argv))
    device = args.pop("device")
    return RunSpec(**args), device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _phase:
    """Wall time of a phase, fenced by a device synchronise at both ends."""

    def __init__(self, device: torch.device):
        self.device = device
        self.duration = 0.0

    def __enter__(self) -> "_phase":
        _sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        _sync(self.device)
        self.duration = time.perf_counter() - self._t0
        return False


def run(cfg: ModelConfig, spec: RunSpec, device=None,
        params: Optional[Any] = None) -> RunResult:
    """eval_dense -> prune -> pruned eval, then with ``spec.epochs`` > 0
    EBFT -> tuned eval, then each of ``spec.baselines`` with its eval, as
    the reference's ``ebft_run.py``. ``params`` defaults to the port's init
    seeded with ``spec.seed``."""
    if spec.pretrain_steps > 0:
        raise NotImplementedError(
            "pretraining is not ported yet (ROADMAP.md queue A, item 11); "
            "run with --pretrain-steps 0")
    wants = set(spec.baselines.split(",")) if spec.baselines else set()
    if wants - set(BASELINES):
        raise ValueError(f"unknown baselines {sorted(wants - set(BASELINES))}; "
                         f"a comma list of {BASELINES}")
    device = resolve_device(device)
    model = build(cfg)
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=spec.seed))
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(spec.seed))
    elif params["embed"]["tok"].device.type != device.type:
        raise ValueError(f"params live on {params['embed']['tok'].device}, the run on {device}")
    calib = calibration_set(corpus, spec.calib_samples, spec.seq)
    ev = eval_set(corpus, EVAL_SAMPLES, spec.seq)
    pattern = tuple(int(x) for x in spec.pattern.split(":")) if spec.pattern else None

    phases: Dict[str, float] = {}
    ppl: Dict[str, float] = {}
    with _phase(device) as sp:
        ppl["dense"] = perplexity(model, params, ev)
    phases["eval_dense"] = sp.duration
    with _phase(device) as sp:
        masks, pruned = prune(model, params, calib, method=spec.method,
                              sparsity=spec.sparsity, pattern=pattern)
    phases["prune"] = sp.duration
    with _phase(device) as sp:
        ppl[spec.method] = perplexity(model, pruned, ev, masks=masks)
    phases["eval_pruned"] = sp.duration
    res = RunResult(ppl, phases, sparsity_of(masks, params), masks, pruned)
    if spec.epochs > 0:
        ecfg = ebft.EBFTConfig(lr=spec.lr, epochs=spec.epochs)
        with _phase(device) as sp:
            res.tuned, res.reports = ebft.finetune(model, params, pruned, masks, calib, ecfg)
        phases["ebft"] = sp.duration
        with _phase(device) as sp:
            ppl["EBFT"] = perplexity(model, res.tuned, ev, masks=masks)
        phases["eval_ebft"] = sp.duration
    # each baseline's phase holds its evaluation, as the reference's
    if "dsnot" in wants:
        errors: Dict = {}
        with _phase(device) as sp:
            ds_masks, ds = prune(model, params, calib, method="dsnot", sparsity=spec.sparsity,
                                 pattern=pattern, scores_out=errors,
                                 dsnot_init=spec.method if spec.method != "dsnot" else "wanda")
            ppl["DSnoT"] = perplexity(model, ds, ev, masks=ds_masks)
        phases["baseline_dsnot"] = sp.duration
        res.baselines["dsnot"] = dict(masks=ds_masks, params=ds, errors=errors)
    if "mask" in wants:
        histories: List[List[float]] = []
        with _phase(device) as sp:
            mt, mt_masks = mask_tuning.finetune_masks(model, params, masks, spec.sparsity, calib,
                                                      pattern=pattern, histories=histories)
            ppl["mask-tune"] = perplexity(model, mt, ev, masks=mt_masks)
        phases["baseline_mask"] = sp.duration
        res.baselines["mask"] = dict(masks=mt_masks, params=mt, histories=histories)
    if "lora" in wants:
        losses: List[torch.Tensor] = []
        with _phase(device) as sp:
            it = corpus_iterator(corpus, batch=8, seq_len=spec.seq, seed=9)
            lr_params = lora.finetune_lora(model, pruned, masks, it, LORA, losses=losses)
            ppl["LoRA"] = perplexity(model, lr_params, ev, masks=masks)
        phases["baseline_lora"] = sp.duration
        res.baselines["lora"] = dict(params=lr_params, losses=losses)
    return res


def bench_record(spec: RunSpec, res: RunResult) -> Dict[str, Any]:
    """The bench JSON: the reference's ``phases``, ``perplexity``,
    ``blocks`` and ``ebft`` sections (``dispatch``, ``walk_phases``,
    ``mesh`` and ``kernel_tuning`` wait for ``obs/``, ROADMAP.md A.12)."""
    reports = res.reports
    out: Dict[str, Any] = {"run_spec": dataclasses.asdict(spec), "phases": res.phases,
                           "perplexity": res.perplexity}
    if spec.epochs > 0:
        out["blocks"] = [r.asdict() for r in reports]
        out["ebft"] = {
            "num_blocks": len(reports),
            "mean_e_drop": _mean_drop(reports),
            "peak_live_block_bytes": max((r.live_bytes for r in reports), default=None),
            "fused_epochs": False,   # the per-epoch loop
            "prefetch_depth": 0,     # the teacher runs just before each visit
            "early_stops": {reason: sum(1 for r in reports if r.early_stop == reason)
                            for reason in {r.early_stop for r in reports}},
        }
    return out


def _mean_drop(reports) -> float:
    return sum(r.loss_before - r.loss_after for r in reports) / max(len(reports), 1)


def main(argv=None) -> RunResult:
    spec, device = _parse(argv)
    cfg = get_config(spec.arch)
    res = run(cfg, spec, device)
    print(f"dense ppl          {res.perplexity['dense']:8.2f}")
    print(f"{spec.method} ppl {' ' * (10 - len(spec.method))}"
          f"{res.perplexity[spec.method]:8.2f}   ({res.phases['prune']:.0f}s, "
          f"sparsity {res.sparsity:.4f})")
    if spec.method == "flap":
        print(f"FLAP remaining params {remaining_param_fraction(res.masks, res.pruned):.4f}")
    if spec.epochs > 0:
        print(f"EBFT ppl           {res.perplexity['EBFT']:8.2f}   "
              f"({res.phases['ebft']:.0f}s, {len(res.reports)} blocks, "
              f"mean E drop {_mean_drop(res.reports):.3e})")
    for name, key in (("DSnoT", "dsnot"), ("mask-tune", "mask"), ("LoRA", "lora")):
        if name in res.perplexity:
            print(f"{name + ' ppl':<19}{res.perplexity[name]:8.2f}   "
                  f"({res.phases['baseline_' + key]:.0f}s)")
    if spec.bench_out:
        with open(spec.bench_out, "w") as f:
            json.dump(bench_record(spec, res), f, indent=2)
        print(f"wrote {spec.bench_out}")
    return res


if __name__ == "__main__":
    main()
