#!/usr/bin/env python3
"""The EBFT walk on a mesh of nccl ranks, one card each, against one card.

    torchrun --nproc-per-node 4 mesh_nccl.py

Every rank builds the same model, weights and magnitude masks as
``chip_smoke.py``'s ``mesh`` phase (``chip_smoke.MESH``: Llama-7B's
widths at 2 layers, f32, 16 segments of 2048, microbatch 8, 2 EBFT
epochs), runs EBFT alone on its own card (the one-card reference; every
rank's must agree bit for bit), then on each mesh of all the ranks
(data × model: every split of the world, e.g. 4 × 1, 2 × 2 and 1 × 4).
Each mesh's per-block loss histories must equal the one-card run's
within rtol 2e-3, atol 1e-5 (``chip_smoke.MESH_RTOL``, ``MESH_ATOL``).
Rank 0 prints one JSON line per run (the walk's wall between two
synchronises, the kernels' launches on that rank, the collective and
per-shard live bytes) and the card's name and power limit.

    torchrun --nproc-per-node 4 mesh_nccl.py --device cpu --arch tiny_dense --seq 32

rehearses it on gloo ranks on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default=None, help="default: chip_smoke.MESH's")
    ap.add_argument("--seq", type=int, default=None, help="default: chip_smoke.MESH's")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist

    import chip_smoke as CS
    from repro_torch.core import ebft
    from repro_torch.launch.mesh import init_from_env, make_ebft_plan

    conf = dict(CS.MESH)
    if args.arch:
        conf.update(arch=args.arch, lr=1e-2)
    if args.seq:
        conf["seq"] = args.seq
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.kernels import _build

        if int(os.environ.get("LOCAL_RANK", "0")) == 0:
            _build.build(["masked_matmul", "flash_attention"])
    rank = init_from_env(args.device)
    world = dist.get_world_size()
    dist.barrier()  # rank 0's build first
    say = print if rank == 0 else (lambda *a, **k: None)
    if rank == 0 and args.device == "cuda":
        say(CS.smi(), flush=True)
    model, params, pruned, masks, calib = CS._mesh_setup(args.device, conf["layers"], conf)

    def run(plan):
        CS.reset_counts()
        CS._sync(args.device)
        dist.barrier()
        t0 = time.perf_counter()
        _, reports = ebft.finetune(model, params, pruned, masks, calib, CS._mesh_ecfg(plan, conf))
        CS._sync(args.device)
        return time.perf_counter() - t0, reports, CS.read_counts()

    wall, single, launches = run(None)
    hist = [r.history for r in single]
    every = [None] * world
    dist.all_gather_object(every, hist)
    if any(h != hist for h in every):
        raise AssertionError("mesh_nccl: the one-card runs differ between ranks")
    say(json.dumps(dict(mesh="1 card", conf=conf, seconds=wall, histories=hist,
                        launches={k: launches[k] for k in CS.MESH_KERNELS})), flush=True)
    for data in [d for d in range(world, 0, -1) if world % d == 0]:
        plan = make_ebft_plan(data, world // data, device_type=args.device)
        wall, reports, launches = run(plan)
        rel = 0.0
        for rs, rm in zip(single, reports):
            a = torch.tensor(rm.history, dtype=torch.float64)
            b = torch.tensor(rs.history, dtype=torch.float64)
            if rm.epochs_run != rs.epochs_run or not torch.allclose(
                    a, b, rtol=CS.MESH_RTOL, atol=CS.MESH_ATOL):
                raise AssertionError(f"mesh_nccl {data}x{world // data}: block {rm.index} "
                                     f"{rm.history} against one card's {rs.history}")
            rel = max(rel, float(((a - b).abs() / b.abs()).max()))
        say(json.dumps(dict(
            mesh=f"{data}x{world // data}", describe=plan.describe(),
            backend=dist.get_backend(), seconds=wall, max_rel=rel,
            histories=[r.history for r in reports],
            collective_bytes=sum(r.collective_bytes for r in reports),
            live_bytes=max(r.live_bytes for r in reports),
            live_bytes_per_shard=max(r.live_bytes_per_shard for r in reports),
            launches={k: launches[k] for k in CS.MESH_KERNELS})), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
