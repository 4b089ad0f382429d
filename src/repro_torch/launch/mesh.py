"""Meshes (port of ``repro.launch.mesh``).

An ``AbstractMesh`` holds axis names and sizes and no devices: the
sharding rules and the static checks lay out the production meshes with
it (``abstract_production_mesh``: 16 × 16 ("data", "model"), or 2 × 16 ×
16 with a "pod" axis). ``make_debug_mesh`` builds a real ``DeviceMesh``
over the ranks of the default process group, and ``make_ebft_plan`` the
``MeshPlan`` of the EBFT calibration walk.

A multi-rank run starts one process per rank, e.g. on the CPU::

    torchrun --nproc-per-node 4 -m repro_torch.launch.ebft_run \
        --arch tiny_dense --device cpu --mesh-data 2 --mesh-model 2
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: ``axis_names``, ``axis_sizes``, and the
    reference's ``shape`` ({name: size}) and ``size``."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= int(s)
        return n


def make_abstract_mesh(shape, axis_names) -> AbstractMesh:
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(axis_names)}")
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axis_names))


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the ranks of the default process
    group (which must exist: ``init_from_env`` under ``torchrun``), axes
    ("data", "model")."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def init_from_env(device_type: str) -> int:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT``; nccl on the card,
    gloo on the CPU; each rank on ``cuda:LOCAL_RANK``). Returns this rank,
    0 without a multi-rank environment."""
    import os

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank()
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return 0
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", init_method="env://")
    return dist.get_rank()


def make_ebft_plan(data: int = 0, model: int = 1, device_type: str = "cuda"):
    """The ``MeshPlan`` of the EBFT calibration walk. ``data=0`` gives the
    data axis every rank the model axis leaves; 1 × 1 (the CLI default)
    returns the inactive plan, the single-device path bit for bit. More
    ranks than the process group has raise a ValueError."""
    import torch.distributed as dist

    from repro_torch.distributed.meshplan import MeshPlan

    nranks = dist.get_world_size() if dist.is_initialized() else 1
    model = max(int(model), 1)
    if data == 0:
        data = max(nranks // model, 1)
    data = max(int(data), 1)
    if data * model == 1:
        return MeshPlan.single()
    if data * model > nranks:
        raise ValueError(
            f"mesh ({data} data x {model} model) needs {data * model} ranks but the "
            f"process group has {nranks}: start the run under torchrun "
            f"--nproc-per-node {data * model}, or shrink the axes")
    if data * model != nranks:
        raise ValueError(f"mesh ({data} data x {model} model) must use all {nranks} ranks "
                         "of the process group")
    return MeshPlan.from_mesh(make_debug_mesh(data, model, device_type))
