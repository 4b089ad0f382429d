"""The paper's pipeline as one command (port of ``repro.launch.ebft_run``):
build the dense model, pretrain it on the synthetic corpus
(``--pretrain-steps``, AdamW at lr 3e-3), take its perplexity, prune
(magnitude, Wanda, SparseGPT, DSnoT or FLAP) through the calibration walk,
take the pruned model's perplexity, tune it block by block with EBFT
(``--epochs``; at 0 every block reports its loss and runs no epoch) and
take the tuned model's perplexity; then the baselines the paper sets EBFT
against (``--baselines``, a comma list of ``dsnot``, ``mask``, ``lora``):
DSnoT's training-free reselection of the method's masks, mask tuning, and
200 LoRA steps on the LM loss, each with its perplexity. Every masked
linear runs on the masked matmul kernel, each tuning step backpropagates
through the kernels' backward, and each pretraining step through the
attention kernel's.

    python -m repro_torch.launch.ebft_run --arch tiny_dense --pretrain-steps 200 \
        --epochs 8 --method sparsegpt --sparsity 0.7 --baselines dsnot,mask,lora --device cpu

Runs on the card unless ``--device cpu``. The bench JSON holds the
reference's ``phases``, ``perplexity``, ``blocks`` and ``ebft`` sections.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import ebft, lora, mask_tuning
from repro_torch.core.evaluate import perplexity
from repro_torch.core.masks import METHODS, prune
from repro_torch.core.pruning.flap import remaining_param_fraction
from repro_torch.data.tokens import (
    CorpusConfig, SyntheticCorpus, calibration_set, corpus_iterator, eval_set,
)
from repro_torch.launch.api import parse
from repro_torch.models.model import build
from repro_torch.optim.optimizers import adamw
from repro_torch.sparsity.sparse_params import sparsity_of
from repro_torch.training.train_loop import make_train_step

EVAL_SAMPLES = 16  # held-out segments, as the reference's eval_set
BASELINES = ("dsnot", "mask", "lora")
LORA = lora.LoRAConfig(steps=200, lr=1e-3)  # the reference driver's LoRA run
PRETRAIN_LR = 3e-3  # the reference driver's, a constant
PRETRAIN_LOG_EVERY = 20  # the loss is read on the host at these steps and the last


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
    batch: int = 32  # pretraining batch
    lr: float = 1e-2
    epochs: int = 10
    baselines: str = ""  # comma list of BASELINES
    bench_out: str = "BENCH_ebft.json"


@dataclasses.dataclass
class RunResult:
    perplexity: Dict[str, float]
    phases: Dict[str, float]
    sparsity: float
    dense: Any  # the weights the run pruned from (pretrained when steps > 0)
    masks: Any
    pruned: Any
    tuned: Any = None  # the EBFT-tuned params
    reports: List[ebft.BlockReport] = dataclasses.field(default_factory=list)
    # pretraining's (step, loss, grad norm) at every PRETRAIN_LOG_EVERY-th
    # step and the last
    pretrain_losses: List[Tuple[int, float, float]] = dataclasses.field(default_factory=list)
    # per baseline run: "dsnot" and "mask" {"masks", "params"} (DSnoT also
    # "errors", each leaf's per-column |E| before and after, as
    # ``prune``'s scores_out; mask tuning "histories", each block's epoch
    # mean losses); "lora" {"params", "losses", each step's LM loss as a
    # 0-d device tensor}
    baselines: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)


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


def pretrain(model, params, corpus, steps: int, batch: int, seq: int, lr: float,
             on_stage: Optional[Callable[[str], None]] = None
             ) -> Tuple[Any, List[Tuple[int, float, float]]]:
    """``steps`` AdamW steps (``make_train_step``: clip 1.0) on batches of
    ``corpus_iterator(corpus, batch, seq, seed=1)``, as the reference's
    ``pretrain``. Trains a copy: ``params`` are left as they are. Returns
    the trained weights and (step, loss, grad norm) at every
    ``PRETRAIN_LOG_EVERY``-th step and the last, the only steps at which
    the host waits for the device. ``on_stage`` is ``make_train_step``'s
    stage hook."""
    params = T.tree_map(lambda p: p.detach().clone(), params)
    device = params["embed"]["tok"].device
    opt = adamw(lr)
    step = make_train_step(model.loss, opt, on_stage=on_stage)
    opt_state = opt.init(params)
    it = corpus_iterator(corpus, batch=batch, seq_len=seq, seed=1)
    history = []
    for i in range(steps):
        tokens = torch.as_tensor(next(it), device=device)
        params, opt_state, metrics, _ = step(params, opt_state, {"tokens": tokens}, None)
        if i % PRETRAIN_LOG_EVERY == 0 or i == steps - 1:
            history.append((i, float(metrics["loss"]), float(metrics["grad_norm"])))
    return params, history


def run(cfg: ModelConfig, spec: RunSpec, device=None, params: Optional[Any] = None,
        on_stage: Optional[Callable[[str], None]] = None) -> RunResult:
    """pretrain (``spec.pretrain_steps`` > 0) -> eval_dense -> prune ->
    pruned eval -> EBFT -> tuned eval, then each of ``spec.baselines`` with
    its eval, as the reference's ``ebft_run.py``. ``params`` defaults to
    the port's init seeded with ``spec.seed``; they are not changed.
    ``on_stage`` is handed to each pretraining step (``make_train_step``)."""
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
    phases: Dict[str, float] = {}
    ppl: Dict[str, float] = {}
    history: List[Tuple[int, float, float]] = []
    if spec.pretrain_steps > 0:
        with _phase(device) as sp:
            params, history = pretrain(model, params, corpus, spec.pretrain_steps, spec.batch,
                                       spec.seq, PRETRAIN_LR, on_stage)
        phases["pretrain"] = sp.duration
    calib = calibration_set(corpus, spec.calib_samples, spec.seq)
    ev = eval_set(corpus, EVAL_SAMPLES, spec.seq)
    pattern = tuple(int(x) for x in spec.pattern.split(":")) if spec.pattern else None

    with _phase(device) as sp:
        ppl["dense"] = perplexity(model, params, ev)
    phases["eval_dense"] = sp.duration
    with _phase(device) as sp:
        masks, pruned = prune(model, params, calib, method=spec.method,
                              sparsity=spec.sparsity, pattern=pattern)
    phases["prune"] = sp.duration
    ppl[spec.method] = perplexity(model, pruned, ev, masks=masks)  # not a phase, as the reference
    res = RunResult(ppl, phases, sparsity_of(masks, params), params, masks, pruned,
                    pretrain_losses=history)
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
    ``mesh`` and ``kernel_tuning`` wait for ``obs/``, ROADMAP.md A.2)."""
    reports = res.reports
    return {
        "run_spec": dataclasses.asdict(spec), "phases": res.phases,
        "perplexity": res.perplexity, "blocks": [r.asdict() for r in reports],
        "ebft": {
            "num_blocks": len(reports),
            "mean_e_drop": _mean_drop(reports),
            "peak_live_block_bytes": max((r.live_bytes for r in reports), default=None),
            "fused_epochs": False,   # the per-epoch loop
            "prefetch_depth": 0,     # the teacher runs just before each visit
            "early_stops": {reason: sum(1 for r in reports if r.early_stop == reason)
                            for reason in {r.early_stop for r in reports}},
        },
    }


def _mean_drop(reports) -> float:
    return sum(r.loss_before - r.loss_after for r in reports) / max(len(reports), 1)


def main(argv=None) -> RunResult:
    spec, device = parse(RunSpec, argv, "repro_torch.launch.ebft_run", __doc__,
                         {"method": METHODS})
    cfg = get_config(spec.arch)
    res = run(cfg, spec, device)
    if res.pretrain_losses:
        print(f"pretrained {spec.pretrain_steps} steps, final loss "
              f"{res.pretrain_losses[-1][1]:.3f}")
    print(f"dense ppl          {res.perplexity['dense']:8.2f}")
    print(f"{spec.method} ppl {' ' * (10 - len(spec.method))}"
          f"{res.perplexity[spec.method]:8.2f}   ({res.phases['prune']:.0f}s, "
          f"sparsity {res.sparsity:.4f})")
    if spec.method == "flap":
        print(f"FLAP remaining params {remaining_param_fraction(res.masks, res.pruned):.4f}")
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
