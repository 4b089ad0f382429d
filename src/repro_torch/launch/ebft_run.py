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

Runs on the card unless ``--device cpu``. Instrumented through
``repro_torch.obs`` as the reference through ``repro.obs``: every phase is
a span (``phase/pretrain``, ``phase/eval``, ``phase/prune``,
``phase/ebft``, ``phase/baseline``), the walk, the blocks and every kernel
launch feed the metrics registry, and the run writes ``--bench-out``
(``BENCH_ebft.json``) in the reference's schema: manifest, metrics, the
span tree, and the sections ``phases``, ``blocks``, ``perplexity``,
``ebft``, ``mesh``, ``dispatch``, ``walk_phases`` and ``kernel_tuning``
(``python -m repro_torch.obs report`` renders it, and so does the
reference's CLI). ``--obs-jsonl`` streams the events as they happen.
``--no-obs`` turns all of it off and writes no artifact; the console
lines are the same either way.

EBFT runs the reference's default path: each block's whole tuning loop
enqueued with the plateau decided on the card and one host read a block
(``core.ebft``'s fused loop), the teacher stream one visit ahead on a
side stream. ``--no-fused-epochs`` runs the per-epoch loop instead (one
host read an epoch); ``--prefetch-depth N`` puts the teacher N visits
ahead (at least 1, as the reference's flag; ``EBFTConfig.prefetch_depth=0``
is the library's strictly serial order). The artifact's ``ebft`` section
carries both settings, and its ``dispatch`` section ``fused_all_blocks``
and ``per_block_max``, the reference's.

``--kernel-tune {off,cache,search}`` (default ``cache``, as the
reference's) and ``--kernel-cache PATH`` (default
``experiments/kernel_cache_torch.json``) drive the tile autotuner
(``kernels.tuning``): unless the mode is ``off``, a ``phase/kernel_tune``
first resolves every launch shape the run makes (``ebft_workloads``),
measuring and persisting the misses in ``search``, and every launch on the
card then takes its tiles from the cache. ``kernel_tuning`` in the
artifact holds the mode, the cache path and the hits, misses, searches and
search seconds; a second run on a warm cache shows no miss.

``--mesh-data`` and ``--mesh-model`` run the EBFT walk on a (data,
model) mesh of ranks (``launch.mesh.make_ebft_plan``; the dense, MoE, SSM
and hybrid families): one
process per rank under ``torchrun``, e.g. four gloo ranks on the CPU::

    torchrun --nproc-per-node 4 -m repro_torch.launch.ebft_run --arch tiny_dense \
        --device cpu --mesh-data 2 --mesh-model 2

(nccl on the card). Every rank runs the whole pipeline; the walk is
sharded, everything else replicated. Rank 0 alone prints and writes the
artifact, whose ``mesh`` section is the plan's ``describe()`` with the
peak per-shard live block bytes and the total collective bytes. The
default, 1 × 1, is the single-device path bit for bit.

The VLM and encoder-decoder families are refused
(``launch.api.refuse_frontend_families``): the reference's driver passes
no patches and no frames.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.kernels import tuning
from repro_torch.launch.api import parse, quiet, refuse_frontend_families, start_obs_run
from repro_torch.launch.mesh import init_from_env, make_ebft_plan
from repro_torch.models.model import build
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import kernel_time
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
    # the reference RunSpec's field (its train launcher's), kept for parity: here
    # pretraining's gradients are accumulated over this many splits of a batch
    microbatches: int = 1
    lr: float = 1e-2
    epochs: int = 10
    no_fused_epochs: bool = dataclasses.field(default=False, metadata={
        "help": "run the legacy per-microbatch tune loop instead of the fused one (every "
                "epoch enqueued, the plateau decided on the device, one host read a block)"})
    prefetch_depth: int = dataclasses.field(default=1, metadata={
        "help": "teacher stream dispatched this many blocks ahead of the tuner (must be >= 1; "
                "EBFTConfig.prefetch_depth=0 is the programmatic strictly-serial mode)"})
    baselines: str = ""  # comma list of BASELINES
    bench_out: str = "BENCH_ebft.json"
    no_obs: bool = False
    obs_jsonl: str = ""
    kernel_tune: str = "cache"  # off | cache | search (kernels.tuning)
    kernel_cache: str = ""      # "" keeps the tuner's path (experiments/kernel_cache_torch.json)
    mesh_data: int = 1    # the EBFT walk's data axis (0: every rank the model axis leaves)
    mesh_model: int = 1   # its model axis

    def validate(self) -> "RunSpec":
        """The reference's check that argparse's types cannot express."""
        if self.prefetch_depth < 1:
            raise ValueError(
                f"--prefetch-depth must be >= 1 (got {self.prefetch_depth}); "
                "the dispatch-ahead teacher stream needs at least one block "
                "in flight. Strictly serial runs are a library-level mode "
                "(EBFTConfig.prefetch_depth=0), not a launcher flag.")
        return self


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
    # the kernel_tune phase's one record per workload (kernels.tuning.pretune)
    kernel_plans: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # the artifact's kernel_tuning section: mode, cache path and the tuner's
    # stats at the run's end (the pre-tune and every launch's resolution)
    kernel_tuning: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the EBFT walk's plan (MeshPlan.describe())
    mesh: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"devices": 1, "axes": {}, "active": False})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _phase:
    """A pipeline phase: an obs span when observability is on, and a host
    wall time either way (the console timings survive ``--no-obs``), fenced
    by a device synchronise at both ends. Under a live run the span also
    carries ``kernel_s`` and ``kernel_launches``: the event time and count
    of the kernel launches the phase made (``obs.profile.kernel_time``,
    read after the closing synchronise), so the rest of its time is
    everything else (cuBLAS, elementwise work, the host)."""

    def __init__(self, device: torch.device, name: str, **attrs):
        self.device = device
        self.span = OT.span(name, **attrs)
        self.duration = 0.0
        self._k0 = None

    def __enter__(self) -> "_phase":
        _sync(self.device)
        if OT.enabled():
            self._k0 = kernel_time()
        self._t0 = time.perf_counter()
        self.span.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        _sync(self.device)
        self.duration = time.perf_counter() - self._t0
        if self._k0 is not None:
            secs, n = kernel_time()
            self.span.set(kernel_s=secs - self._k0[0], kernel_launches=n - self._k0[1])
        self.span.__exit__(*exc)
        return False


def pretrain(model, params, corpus, steps: int, batch: int, seq: int, lr: float,
             on_stage: Optional[Callable[[str], None]] = None, microbatches: int = 1
             ) -> Tuple[Any, List[Tuple[int, float, float]]]:
    """``steps`` AdamW steps (``make_train_step``: clip 1.0) on batches of
    ``corpus_iterator(corpus, batch, seq, seed=1)``, as the reference's
    ``pretrain``; with ``microbatches`` > 1 each batch's gradient is
    accumulated in f32 over that many splits (``make_train_step``'s, as the
    reference's train kind takes it), which bounds the activations' memory
    (a 102400-word vocabulary's f32 logits are 6.7 GB at 8 × 2048 tokens).
    Trains a copy: ``params`` are left as they are. Returns
    the trained weights and (step, loss, grad norm) at every
    ``PRETRAIN_LOG_EVERY``-th step and the last, the only steps at which
    the host waits for the device. ``on_stage`` is ``make_train_step``'s
    stage hook."""
    params = T.tree_map(lambda p: p.detach().clone(), params)
    device = params["embed"]["tok"].device
    opt = adamw(lr)
    step = make_train_step(model.loss, opt, microbatches=microbatches, on_stage=on_stage)
    opt_state = opt.init(params)
    it = corpus_iterator(corpus, batch=batch, seq_len=seq, seed=1)
    history = []
    for i in range(steps):
        tokens = torch.as_tensor(next(it), device=device)
        params, opt_state, metrics, _ = step(params, opt_state, {"tokens": tokens}, None)
        if i % PRETRAIN_LOG_EVERY == 0 or i == steps - 1:
            history.append((i, float(metrics["loss"]), float(metrics["grad_norm"])))
            OM.series("pretrain/loss").append(history[-1][1], step=i)
    return params, history


def run(cfg: ModelConfig, spec: RunSpec, device=None, params: Optional[Any] = None,
        on_stage: Optional[Callable[[str], None]] = None, mesh_plan=None,
        lora_cfg: Optional[lora.LoRAConfig] = None) -> RunResult:
    """pretrain (``spec.pretrain_steps`` > 0) -> eval_dense -> prune ->
    pruned eval -> EBFT -> tuned eval, then each of ``spec.baselines`` with
    its eval, as the reference's ``ebft_run.py``. ``params`` defaults to
    the port's init seeded with ``spec.seed``; they are not changed.
    ``on_stage`` is handed to each pretraining step (``make_train_step``).
    ``mesh_plan`` (a ``MeshPlan``; None is one device) is EBFT's;
    ``lora_cfg`` (default ``LORA``) the LoRA baseline's."""
    refuse_frontend_families(cfg, "ebft_run")
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
    pattern = tuple(int(x) for x in spec.pattern.split(":")) if spec.pattern else None
    tuning.configure(mode=spec.kernel_tune, path=spec.kernel_cache or None)
    tuning.reset_stats()
    plans: List[Dict[str, Any]] = []
    if spec.kernel_tune != "off":
        # the tile plans of every launch shape this run makes, resolved (and
        # in search mode measured) before the hot path; in cache mode a
        # lookup each, whose hits and misses land in the artifact
        with _phase(device, "phase/kernel_tune", mode=spec.kernel_tune) as sp:
            plans = tuning.pretune(run_workloads(cfg, spec, pattern, wants), device=device)
        phases["kernel_tune"] = sp.duration
    if spec.pretrain_steps > 0:
        with _phase(device, "phase/pretrain", steps=spec.pretrain_steps) as sp:
            params, history = pretrain(model, params, corpus, spec.pretrain_steps, spec.batch,
                                       spec.seq, PRETRAIN_LR, on_stage, spec.microbatches)
        phases["pretrain"] = sp.duration
    calib = calibration_set(corpus, spec.calib_samples, spec.seq)
    ev = eval_set(corpus, EVAL_SAMPLES, spec.seq)

    with _phase(device, "phase/eval", what="dense") as sp:
        ppl["dense"] = perplexity(model, params, ev)
    phases["eval_dense"] = sp.duration
    with _phase(device, "phase/prune", method=spec.method, sparsity=spec.sparsity) as sp:
        masks, pruned = prune(model, params, calib, method=spec.method,
                              sparsity=spec.sparsity, pattern=pattern)
    phases["prune"] = sp.duration
    ppl[spec.method] = perplexity(model, pruned, ev, masks=masks)  # not a phase, as the reference
    res = RunResult(ppl, phases, sparsity_of(masks, params), params, masks, pruned,
                    pretrain_losses=history, kernel_plans=plans)
    ecfg = ebft.EBFTConfig(lr=spec.lr, epochs=spec.epochs, fused_epochs=not spec.no_fused_epochs,
                           prefetch_depth=spec.prefetch_depth, mesh_plan=mesh_plan)
    if mesh_plan is not None:
        res.mesh = mesh_plan.describe()
    with _phase(device, "phase/ebft", lr=spec.lr, epochs=spec.epochs) as sp:
        res.tuned, res.reports = ebft.finetune(model, params, pruned, masks, calib, ecfg)
    phases["ebft"] = sp.duration
    with _phase(device, "phase/eval", what="ebft") as sp:
        ppl["EBFT"] = perplexity(model, res.tuned, ev, masks=masks)
    phases["eval_ebft"] = sp.duration
    # each baseline's phase holds its evaluation, as the reference's
    if "dsnot" in wants:
        errors: Dict = {}
        with _phase(device, "phase/baseline", which="dsnot") as sp:
            ds_masks, ds = prune(model, params, calib, method="dsnot", sparsity=spec.sparsity,
                                 pattern=pattern, scores_out=errors,
                                 dsnot_init=spec.method if spec.method != "dsnot" else "wanda")
            ppl["DSnoT"] = perplexity(model, ds, ev, masks=ds_masks)
        phases["baseline_dsnot"] = sp.duration
        res.baselines["dsnot"] = dict(masks=ds_masks, params=ds, errors=errors)
    if "mask" in wants:
        histories: List[List[float]] = []
        with _phase(device, "phase/baseline", which="mask") as sp:
            mt, mt_masks = mask_tuning.finetune_masks(model, params, masks, spec.sparsity, calib,
                                                      pattern=pattern, histories=histories)
            ppl["mask-tune"] = perplexity(model, mt, ev, masks=mt_masks)
        phases["baseline_mask"] = sp.duration
        res.baselines["mask"] = dict(masks=mt_masks, params=mt, histories=histories)
    if "lora" in wants:
        losses: List[torch.Tensor] = []
        with _phase(device, "phase/baseline", which="lora") as sp:
            it = corpus_iterator(corpus, batch=8, seq_len=spec.seq, seed=9)
            lr_params = lora.finetune_lora(model, pruned, masks, it, lora_cfg or LORA,
                                            losses=losses)
            ppl["LoRA"] = perplexity(model, lr_params, ev, masks=masks)
        phases["baseline_lora"] = sp.duration
        res.baselines["lora"] = dict(params=lr_params, losses=losses)
    res.kernel_tuning = {"mode": spec.kernel_tune, "cache_path": tuning.state()["path"],
                         **tuning.stats()}
    return res


def run_workloads(cfg: ModelConfig, spec: RunSpec, pattern, baselines=()) -> List[Tuple]:
    """Every tunable launch shape of ``run``: ``tuning.ebft_workloads`` at
    each microbatch the walks and the evaluations take (8 rows, and a
    ragged last one), the pretraining's attention forward, and mask
    tuning's dM routes when that baseline runs."""
    mb = ebft.EBFTConfig().microbatch
    rows = {min(mb, spec.calib_samples), spec.calib_samples % mb, min(mb, EVAL_SAMPLES),
            EVAL_SAMPLES % mb} - {0}
    work: List[Tuple] = []
    for r in sorted(rows, reverse=True):
        work += tuning.ebft_workloads(cfg, tokens=r * spec.seq, seq=spec.seq, pattern=pattern)
    if "mask" in baselines:
        work += [(kernel.replace("_dw", "_dm"), dims, dtypes, params)
                 for kernel, dims, dtypes, params in work if kernel.endswith("_dw")]
    if spec.pretrain_steps > 0 and cfg.family != "ssm":
        BH = spec.batch // max(spec.microbatches, 1) * cfg.num_heads
        work.append(("flash_attention", {"BH": BH, "Sq": spec.seq, "Sk": spec.seq,
                                         "d": cfg.resolved_head_dim},
                     {"q": cfg.dtype}, {"causal": True}))
    seen, out = set(), []
    for w in work:
        key = tuning.cache_key(w[0], w[1], w[2], w[3], "", "", "")
        if key not in seen:
            seen.add(key)
            out.append(w)
    return out


def bench_record(spec: RunSpec, res: RunResult,
                 summ: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The artifact's sections beside its manifest, metrics and trace, in
    the reference's schema (``repro.launch.ebft_run.main``): ``phases``,
    ``blocks``, ``perplexity``, ``ebft``, ``mesh``, ``dispatch``,
    ``walk_phases`` and ``kernel_tuning``, and the spec as ``run_spec``.
    ``summ`` is the run's metric summary; without it the sections that
    read it hold None. ``dispatch.per_block_max`` adds the walk's two
    stream advances to the tune loop's dispatches when every block ran
    fused, as the reference's; ``mesh`` is the walk's plan (``MeshPlan.describe()``)
    with the peak per-shard live block bytes and the total collective
    bytes, as the reference's. ``kernel_tuning``
    is the tuner's mode, cache path, hits, misses, searches and search
    seconds over the run, the reference's keys."""
    reports = res.reports
    summ = summ or {}

    def metric(name: str, key: str):
        return summ.get(name, {}).get(key)

    peak = max((r.live_bytes for r in reports), default=None)
    tune_max = max((r.dispatches for r in reports), default=0)
    fused_all = bool(reports) and all(r.path == "fused" for r in reports)
    return {
        "run_spec": dataclasses.asdict(spec), "phases": res.phases,
        "perplexity": res.perplexity, "blocks": [r.asdict() for r in reports],
        "ebft": {
            "num_blocks": len(reports),
            "mean_e_drop": _mean_drop(reports),
            "peak_live_block_bytes": peak,
            "fused_epochs": not spec.no_fused_epochs,
            "prefetch_depth": spec.prefetch_depth,
            "early_stops": {reason: sum(1 for r in reports if r.early_stop == reason)
                            for reason in {r.early_stop for r in reports}},
        },
        "mesh": {**res.mesh,
                 "peak_live_block_bytes_per_shard": max(
                     (r.live_bytes_per_shard for r in reports), default=None),
                 "collective_bytes_total": sum(r.collective_bytes for r in reports)},
        # per block: the tune loop's dispatches, and in the stacked walk
        # (every block fused) its two stream advances
        "dispatch": {
            "tune_per_block_max": tune_max,
            "tune_host_syncs_per_block_max": max((r.host_syncs for r in reports), default=0),
            "per_block_max": tune_max + (2 if fused_all else 0),
            "fused_all_blocks": fused_all,
            "walk_total": metric("ebft/walk/dispatches", "value"),
            "walk_host_syncs": metric("ebft/walk/host_syncs", "value"),
            "device_dispatches_per_block": {str(r.index): r.device_dispatches for r in reports},
            "tune_device_total": metric("ebft/tune/device_dispatches", "value"),
            "walk_device_total": metric("ebft/walk/device_dispatches", "value"),
        },
        # each walk phase's seconds, the first calls' host time apart
        "walk_phases": {
            **{p: metric(f"ebft/walk/{p}_s", "sum") for p in ("teacher", "tune", "student")},
            **{f"{p}_compile": metric(f"ebft/walk/{p}_compile_s", "sum")
               for p in ("teacher", "tune", "student")},
        },
        "kernel_tuning": dict(res.kernel_tuning),
    }


def _mean_drop(reports) -> float:
    return sum(r.loss_before - r.loss_after for r in reports) / max(len(reports), 1)


def main(argv=None) -> RunResult:
    spec, device = parse(RunSpec, argv, "repro_torch.launch.ebft_run", __doc__,
                         {"method": METHODS, "kernel_tune": tuning.MODES})
    device = resolve_device(device)
    cfg = get_config(spec.arch)
    refuse_frontend_families(cfg, "ebft_run")
    owned = not torch.distributed.is_initialized()
    rank = init_from_env(device.type)
    plan = make_ebft_plan(spec.mesh_data, spec.mesh_model, device_type=device.type)
    obs_run = start_obs_run(spec, "ebft", device) if rank == 0 else None
    say = obs_run.say if obs_run is not None else (print if rank == 0 else quiet)
    if plan.active:
        say(f"calibration mesh: {plan.describe()['axes']} ({plan.device_count} devices)")
    res = run(cfg, spec, device, mesh_plan=plan)
    if spec.kernel_tune != "off":
        got = [p["source"] for p in res.kernel_plans]
        say(f"kernel plans: {len(got)} workloads, {got.count('cache')} cached, "
            f"{got.count('search')} searched ({res.phases['kernel_tune']:.0f}s)")
    if res.pretrain_losses:
        say(f"pretrained {spec.pretrain_steps} steps, final loss "
            f"{res.pretrain_losses[-1][1]:.3f}")
    say(f"dense ppl          {res.perplexity['dense']:8.2f}")
    say(f"{spec.method} ppl {' ' * (10 - len(spec.method))}"
        f"{res.perplexity[spec.method]:8.2f}   ({res.phases['prune']:.0f}s, "
        f"sparsity {res.sparsity:.4f})")
    if spec.method == "flap":
        say(f"FLAP remaining params {remaining_param_fraction(res.masks, res.pruned):.4f}")
    say(f"EBFT ppl           {res.perplexity['EBFT']:8.2f}   "
        f"({res.phases['ebft']:.0f}s, {len(res.reports)} blocks, "
        f"mean E drop {_mean_drop(res.reports):.3e})")
    for name, key in (("DSnoT", "dsnot"), ("mask-tune", "mask"), ("LoRA", "lora")):
        if name in res.perplexity:
            say(f"{name + ' ppl':<19}{res.perplexity[name]:8.2f}   "
                f"({res.phases['baseline_' + key]:.0f}s)")
    if obs_run is not None:
        summ = obs_run.payload()["metrics"]
        obs_run.finish(extra=bench_record(spec, res, summ), summary_path=spec.bench_out or None)
        if spec.bench_out:
            print(f"wrote {spec.bench_out}  (render with: python -m repro_torch.obs report "
                  f"{spec.bench_out})")
    if owned and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
