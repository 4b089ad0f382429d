"""The multi-pod dry run without HLO (port of ``repro.launch.dryrun``):
every (architecture × input shape × mesh) cell of ``launch/steps.py`` is
built for the production mesh and its function run once on fake
arguments, which is the port's counterpart of the reference's "lowers,
SPMD-partitions and compiles".

    python -m repro_torch.launch.dryrun                  # every cell, both meshes
    python -m repro_torch.launch.dryrun --arch llama_7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --arch all --shape ebft_block --mesh single

The mesh is a real ``DeviceMesh`` of 16 × 16 ranks ("single") or 2 × 16
× 16 ("multi") over a fake process group (``launch.mesh.
fake_production_mesh``: ``torch.distributed``'s ``"fake"`` backend, this
process rank 0; every collective returns at once). The arguments are
fake tensors (``FakeTensorMode``) at the cell's full shapes, placed by
its in-specs (``distribute_tensor(src_data_rank=None)``), and the cell
runs through ``steps.run_cell`` on DTensors, so every sharding rule
(DTensor's own and ``distributed.local_kernels``') and every local shape
is exercised. The run allocates nothing on any device and needs no card,
as the reference's runs on placeholder CPU devices; it is how the dry
run works, not a fallback. A missing sharding rule, a local shape that a
kernel's launch plan refuses (each local masked matmul is held to the
card's plan, ``kernels.validation``, at the widths ``local_kernels``
lays a bf16 shard out at) or any other error fails the cell: the record
keeps ``error`` and ``traceback``, the sweep goes on, and the run exits 1.

Each cell writes ``<out>/<tag>/<arch>__<shape>__<mesh>.json`` with the
reference's keys that still have a meaning: ``arch``, ``shape``,
``mesh``, ``chips``, ``kind``, ``fsdp`` and ``memory_analysis``, rank
0's bytes:

    argument_bytes  its shards of every argument, exact from the in-specs
    output_bytes    its shards of every result (a result the cell leaves
                    whole counts whole)
    alias_bytes     its shards of the donated arguments
    temp_bytes      the peak of the fake storages live during the run
                    above the arguments
    peak_bytes_est  argument_bytes + temp_bytes

The peak is read by ``torch.distributed._tools.mem_tracker.MemTracker``
(the arguments tracked as external, every storage the run makes counted
while it lives). ``timing`` has ``build_s`` (the cell) and ``run_s``
(placing and running it). The port compiles no HLO (ROADMAP.md A.7), so
``cost_analysis``, ``hlo_stats`` and ``roofline`` are left out and
``hlo`` says so; the reference's ``--assume-flash`` only shapes its HLO
reading and has no counterpart here.

The process group is this process's own: never import and run this in a
process that does other work (a test runner's); run it as a command.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import tree as T

HLO = "not compiled (ROADMAP A.7)"


@dataclasses.dataclass(frozen=True)
class DryrunSpec:
    """The reference ``RunSpec``'s dryrun fields, with its defaults but the
    output directory (the reference's records are another schema)."""

    arch: str = "all"
    shape: str = "all"
    mesh: str = "both"
    out: str = "experiments/dryrun_torch"
    tag: str = "baseline"
    fsdp: str = "auto"
    microbatches: int = 0
    skip_existing: bool = False
    ebft_dp: bool = False


def _local_bytes(tree) -> int:
    """Rank 0's bytes of every tensor in a nest: a DTensor's local shard, a
    plain tensor whole."""
    n = 0
    for t in T.tensors(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        n += local.numel() * local.element_size()
    return n


def _fake_args(tree):
    """A tree of ``ShapeLeaf``s and ``TensorSpec``s as empty tensors (fake
    under the caller's ``FakeTensorMode``); other leaves pass."""
    return T.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype)
                      if hasattr(x, "shape") and hasattr(x, "dtype") else x, tree)


@contextlib.contextmanager
def held_to_launch_plans():
    """Each masked matmul (forward, dX, dW, dM; matrices or E slabs) built,
    at its local operands' shapes, into the launch plan the card would
    run (``kernels.validation.plan_masked_matmul``), which raises on what
    the kernel does not take. The operands are laid out as the card's
    wrappers lay them: a bf16 depth or width that is not a multiple of 8
    padded to one (``local_kernels._laid_out``), a mask's rows 16 bytes apart
    (``masked_matmul.ops.aligned_mask``), everything else contiguous. No
    address is checked: fake tensors have none."""
    from repro_torch.kernels import validation as V
    from repro_torch.kernels.masked_matmul import ops as MM

    call = MM._call

    def held(fn, a, b, c, tiles=None, **kw):
        if a.dtype in MM._DTYPE:
            M, K, N = MM._dims(fn, a, b, c)
            if a.dtype == torch.bfloat16:
                K, N = K + -K % 8, N + -N % 8
            dims, lead = dict(M=M, K=K, N=N), a.dim() == 3
            operands = []
            for name, d in MM._OPERANDS[fn][:3]:
                rows, cols = dims[d[0]], dims[d[1]]
                if name == "m":
                    cols += -cols % 16
                operands.append(((rows * cols, cols, 1) if lead else (cols, 1), 0))
            V.plan_masked_matmul(MM._entry(fn, a), M, K, N, a.shape[0] if lead else 1,
                                 dtype=MM._DTYPE[a.dtype], operands=operands, **(tiles or {}))
        return call(fn, a, b, c, tiles, **kw)

    MM._call = held
    try:
        yield
    finally:
        MM._call = call


@contextlib.contextmanager
def replaying_microbatches(run: int = 2):
    """A train cell's gradient accumulation runs its first ``run``
    microbatches; each later one takes the last run one's loss and
    gradients, with the same shapes and placements, and is accumulated as
    they are. Every microbatch's work repeats the first's (one body, the
    same local shapes and rules: the reference's scan compiles it once),
    and by the second the f32 accumulators are live beside a microbatch's
    activations, so the peak is the whole loop's; eager fake execution of
    all of them (16 on the single mesh) would take about eight times as
    long."""
    from repro_torch.training import train_loop as TL

    vg = TL.value_and_grad
    seen = []

    def replayed(loss_fn, params, batch):
        if len(seen) < run:
            seen.append(vg(loss_fn, params, batch))
        return seen[-1]

    TL.value_and_grad = replayed
    try:
        yield
    finally:
        TL.value_and_grad = vg


def shape_of(cfg, shape_name: str):
    """The shape cell ``shape_name`` of ``cfg`` (``ebft_block``: the paper's
    EBFT step, ``steps.EBFT_SHAPE``)."""
    from repro_torch.launch import steps as ST

    if shape_name == "ebft_block":
        return ST.EBFT_SHAPE  # the paper's own workload (Alg. 1 inner step)
    found = [s for s in cfg.shapes() if s.name == shape_name]
    if not found:
        raise KeyError(f"{cfg.name} has no shape {shape_name!r} "
                       f"(its shapes: {[s.name for s in cfg.shapes()]}, and ebft_block)")
    return found[0]


def run_cell(arch: str, shape_name: str, mesh_name: str, mesh, out_dir: str,
             fsdp: Optional[bool] = None, microbatches: Optional[int] = None,
             skip_existing: bool = False, ebft_dp: bool = False) -> Dict[str, Any]:
    """Build one cell on ``mesh`` (the ``mesh_name`` production mesh), run
    it once on fake arguments and write its record (the module
    docstring). Never raises for the cell's own failure: the record keeps
    it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST

    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if "error" not in rec:
            print(f"[skip] {arch} {shape_name} {mesh_name} (cached)")
            return rec
    chips = mesh.size()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "chips": chips}
    t0 = time.perf_counter()
    try:
        cfg = get_config(arch)
        shape = shape_of(cfg, shape_name)
        rec["kind"] = shape.kind
        if shape.kind == "train":
            cell = ST.build_cell(cfg, shape, mesh, fsdp=fsdp, microbatches=microbatches)
        elif shape.kind == "ebft":
            cell = ST.build_ebft_cell(cfg, shape, mesh, dp_only=ebft_dp)
        else:
            cell = ST.build_cell(cfg, shape, mesh)
        t_build = time.perf_counter() - t0
        with FakeTensorMode(allow_non_fake_inputs=True), held_to_launch_plans(), \
                replaying_microbatches():
            args = [ST.place(_fake_args(a), s, mesh)
                    for a, s in zip(cell.abstract_args, cell.in_specs)]
            argument = _local_bytes(args)
            alias = _local_bytes([args[i] for i in cell.donate_argnums])
            tracker = MemTracker()
            tracker.track_external(*T.tensors(args))
            with tracker:
                out = ST.run_cell(cell, mesh, *args)
            peak = sum(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
            output = _local_bytes(out)
        t_run = time.perf_counter() - t0 - t_build
        temp = max(peak - argument, 0)
        rec["memory_analysis"] = {"argument_bytes": argument, "output_bytes": output,
                                  "temp_bytes": temp, "alias_bytes": alias,
                                  "peak_bytes_est": argument + temp}
        rec["timing"] = {"build_s": t_build, "run_s": t_run}
        rec["fsdp"] = bool(ST.wants_fsdp(cell.cfg)) if fsdp is None else fsdp
        rec["hlo"] = HLO
        print(f"[ok]   {arch:24s} {shape_name:12s} {mesh_name:6s} "
              f"args/dev={argument / 2**30:.2f}GiB peak/dev={(argument + temp) / 2**30:.2f}GiB "
              f"(build {t_build:.1f}s, run {t_run:.1f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch} {shape_name} {mesh_name}: {rec['error']}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    import torch.distributed as dist

    from repro_torch.configs import CONFIG_IDS, get_config
    from repro_torch.launch.api import parse
    from repro_torch.launch.mesh import fake_production_mesh

    spec, _ = parse(DryrunSpec, argv, "repro_torch.launch.dryrun", __doc__,
                    choices={"mesh": ("single", "multi", "both"),
                             "fsdp": ("auto", "on", "off")}, device=False)
    archs = list(CONFIG_IDS) if spec.arch == "all" else spec.arch.split(",")
    meshes = ["single", "multi"] if spec.mesh == "both" else [spec.mesh]
    fsdp = None if spec.fsdp == "auto" else spec.fsdp == "on"
    out_dir = os.path.join(spec.out, spec.tag)
    failures = 0
    # one fake process group a mesh (256 or 512 ranks), so the mesh is the
    # outer loop
    for mesh_name in meshes:
        mesh = fake_production_mesh(multi_pod=mesh_name == "multi")
        for arch in archs:
            names = ([s.name for s in get_config(arch).shapes()] if spec.shape == "all"
                     else spec.shape.split(","))
            for shape_name in names:
                rec = run_cell(arch, shape_name, mesh_name, mesh, out_dir, fsdp=fsdp,
                               microbatches=spec.microbatches or None,
                               skip_existing=spec.skip_existing, ebft_dp=spec.ebft_dp)
                failures += int("error" in rec)
        dist.destroy_process_group()
    print(f"\ndry-run complete; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
