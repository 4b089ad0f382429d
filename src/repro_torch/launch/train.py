"""The training driver (port of ``repro.launch.train``), on one device or
on a (data, model) mesh of ranks.

    python -m repro_torch.launch.train --arch tiny_dense --steps 200 \
        --batch 32 --seq 128 --ckpt-dir /tmp/ckpt --device cpu

AdamW on a warmup-cosine schedule (20 warmup steps) over batches that are
a pure function of the step, checkpointed every ``--ckpt-every`` steps.
If ``--ckpt-dir`` holds a checkpoint, training resumes from it, and the
run ends with the same weights as one that was never stopped. A VLM's
batch is the reference's: the step's tokens cut to ``seq - P`` and then
``patches`` (batch, P, d_model) drawn from the same generator, with P
from ``Model.input_specs``. The
checkpoint layout is the reference's, so either package resumes the
other's run. Runs on the card unless ``--device cpu``. The step is
``obs.profile.profiled`` as ``train/step`` (first call apart, later calls
fenced) and the loop books the reference's ``train/*`` spans and metrics;
with ``--bench-out`` the run writes its artifact with the reference's
``trained`` section (``--obs-jsonl`` streams the events, ``--no-obs``
turns it all off).

Under ``torchrun`` the run is sharded, as the reference's: the mesh is
``--mesh-data`` × ``--mesh-model`` (data 0: every rank the model axis
leaves), the params are placed by ``param_pspecs`` (no FSDP), AdamW's
moments take the params' placements, and each step's batch is placed by
``batch_pspecs`` (a VLM's ``patches`` and an encoder-decoder's
``frames`` as its tokens, and in microbatches each rank's rows of them:
``constrain_microbatch``); every rank runs the step on its DTensor
shards, every family (``launch/steps.py``). Rank 0 alone prints and writes the
artifact and the checkpoints; a checkpoint restores onto whatever mesh
(or single device) the resuming run has::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --arch tiny_dense --mesh-data 2 --mesh-model 2 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt as CK
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.tokens import CorpusConfig, SyntheticCorpus
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.api import parse, quiet, start_obs_run
from repro_torch.launch.mesh import init_from_env, make_debug_mesh, resolve_axes
from repro_torch.models.model import build
from repro_torch.obs import trace as OT
from repro_torch.obs.profile import profiled
from repro_torch.optim import grad_compress as GC
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.training.train_loop import Trainer, make_train_step

WARMUP = 20
LOG_EVERY = 10


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """The reference ``RunSpec``'s train-kind fields that one device
    reads, with the same names and defaults."""

    arch: str = "tiny_dense"
    steps: int = 100
    batch: int = 16
    seq: int = 128
    lr: float = 3e-3
    microbatches: int = 1
    compress: float = 1.0  # < 1: top-k gradient compression with error feedback
    ckpt_dir: str = ""
    ckpt_every: int = 50
    seed: int = 0
    mesh_data: int = 0   # the data axis; 0: every rank the model axis leaves
    mesh_model: int = 1
    no_obs: bool = False
    bench_out: str = ""
    obs_jsonl: str = ""


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    start: int  # the step the run resumed from (0 for a fresh run)
    history: List[Tuple[int, float]]  # (step, loss) every LOG_EVERY-th step
    seconds: float


def _sharded(step_fn, mesh, bspecs):
    """The train step on a mesh: the batch placed by its specs, the step run
    under the mesh's activation policy on DTensors, the metrics whole."""
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.distributed.meshplan import MeshPlan

    pol = AS.make_mesh_policy(mesh)

    def step(params, opt_state, batch, err_state):
        with ST.mesh_scope(mesh, pol):
            params, opt_state, metrics, err_state = step_fn(
                params, opt_state, ST.place(batch, bspecs, mesh), err_state)
        return params, opt_state, MeshPlan.gather(metrics), err_state

    return step


def run(cfg: ModelConfig, spec: TrainSpec, device=None, params: Optional[Any] = None,
        say=print, mesh=None, log_every: int = LOG_EVERY) -> TrainResult:
    """Train ``cfg`` for ``spec.steps`` steps in all, resuming from
    ``spec.ckpt_dir`` when it holds a checkpoint. ``params`` defaults to
    the port's init seeded with ``spec.seed``; they are trained in place.
    ``mesh`` (a ``DeviceMesh`` of more than one rank) shards the run: the
    params (and so the result's) are DTensors. The loss is read (a host
    sync) every ``log_every``-th step. The restore is the
    ``train/restore`` span."""
    device = resolve_device(device)
    model = build(cfg)
    shape = ShapeConfig("cli", spec.seq, spec.batch, "train")
    corpus = SyntheticCorpus(CorpusConfig(vocab_size=cfg.vocab_size, seed=spec.seed))
    sharded = ST.is_active_mesh(mesh)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(spec.seed))
    if sharded:  # every rank holds the same init and keeps its own pieces
        params = ST.place(params, SH.param_pspecs(params, mesh), mesh)
    opt = adamw(warmup_cosine(spec.lr, warmup=WARMUP, total=max(spec.steps, WARMUP + 1)))
    opt_state = opt.init(params)  # the moments take the params' placements
    constrain = None
    if sharded:
        bspecs = SH.batch_pspecs(model.input_specs(shape), mesh)
        if spec.microbatches > 1:
            constrain = ST.microbatch_constraint(bspecs, mesh)
    step_fn = make_train_step(model.loss, opt, microbatches=spec.microbatches,
                              compress_ratio=spec.compress, constrain_microbatch=constrain)
    if sharded:
        step_fn = _sharded(step_fn, mesh, bspecs)
    step_fn = profiled(step_fn, "train/step")
    err_state = GC.init_error_state(params) if spec.compress < 1.0 else None

    def data_fn(step: int):
        r = np.random.default_rng((spec.seed << 20) + step)
        toks = np.stack([corpus.sample(r, spec.seq) for _ in range(spec.batch)])
        batch = {"tokens": toks}
        if cfg.family == "vlm":
            P = model.input_specs(shape)["patches"].shape[1]
            batch["tokens"] = toks[:, :spec.seq - P]
            batch["patches"] = r.normal(size=(spec.batch, P, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            F = model.input_specs(shape)["frames"].shape[1]
            batch["frames"] = r.normal(size=(spec.batch, F, cfg.d_model)).astype(np.float32)
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    start = 0
    latest = CK.latest_step(spec.ckpt_dir) if spec.ckpt_dir else None
    if latest is not None:
        with OT.span("train/restore", step=latest):
            tree = CK.restore(spec.ckpt_dir, {"params": params, "opt_state": opt_state},
                              step=latest)
        params, opt_state = tree["params"], tree["opt_state"]
        start = latest
        say(f"resumed from step {start}")
    trainer = Trainer(step_fn=step_fn, data_fn=data_fn, ckpt_dir=spec.ckpt_dir or None,
                      ckpt_every=spec.ckpt_every, log_every=log_every)
    t0 = time.perf_counter()
    params, opt_state, history = trainer.run(params, opt_state, start, spec.steps - start,
                                             err_state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return TrainResult(params, opt_state, start, history, time.perf_counter() - t0)


def trained_record(spec: TrainSpec, res: TrainResult) -> dict:
    """The artifact's ``trained`` section, as the reference's launcher writes it."""
    n = spec.steps - res.start
    return {"steps": n, "seconds": res.seconds, "steps_per_s": n / max(res.seconds, 1e-9),
            "history": res.history}


def main(argv=None) -> TrainResult:
    spec, device = parse(TrainSpec, argv, "repro_torch.launch.train", __doc__)
    device = resolve_device(device)
    owned = not torch.distributed.is_initialized()
    rank = init_from_env(device.type)
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    data, model_axis = resolve_axes(spec.mesh_data, spec.mesh_model)
    mesh = make_debug_mesh(data, model_axis, device.type) if data * model_axis > 1 else None
    obs_run = start_obs_run(spec, "train", device) if rank == 0 else None
    say = obs_run.say if obs_run is not None else (print if rank == 0 else quiet)
    say(f"devices={world} mesh={{'data': {data}, 'model': {model_axis}}}")
    res = run(get_config(spec.arch), spec, device, say=say, mesh=mesh)
    n = spec.steps - res.start
    for s, loss in res.history[-5:]:
        say(f"step {s:5d} loss {loss:.4f}")
    say(f"{n} steps in {res.seconds:.1f}s ({n / max(res.seconds, 1e-9):.2f} steps/s)")
    if obs_run is not None:
        obs_run.finish(extra={"trained": trained_record(spec, res)},
                       summary_path=spec.bench_out or None)
    if owned and torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
