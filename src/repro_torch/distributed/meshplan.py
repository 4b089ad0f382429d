"""MeshPlan: the device-layout contract of the EBFT calibration walk (port
of ``repro.distributed.meshplan``).

A plan says which mesh the walk runs on and how each family of tensors
is laid out on it:

  * the calibration streams: each microbatch (B, ...) of the teacher and
    student streams is sharded on its batch dim over the batch axes
    (("data",), or ("pod", "data") on a multi-pod mesh). This is the
    reference's ``stacked_spec`` dim 1: the port stacks no microbatches;
  * the live block's weights and masks (and Adam's moments, which follow
    their weights): over "model", by the rules of
    :mod:`repro_torch.distributed.sharding` (``param_pspecs``);
  * a leaf that does not divide its mesh axis replicates. A plan never
    fails, it degrades, and :meth:`explain` lists which leaves did (the
    static checks' SHD005).

``MeshPlan.single()`` (or ``mesh_plan=None`` wherever one is accepted)
is the single-device path bit for bit: no DTensor, no collective.

The mesh is a ``DeviceMesh`` (``launch.mesh.make_debug_mesh``) or a
device-free ``launch.mesh.AbstractMesh``; only placing tensors
(``put_*``, ``gather``) needs a real one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.distributed import sharding as SH


def _itemsize(leaf) -> int:
    return (getattr(leaf, "dtype", None) or torch.float32).itemsize


def _whole(t) -> torch.Tensor:
    """A Shard/Replicate DTensor as one whole tensor on every rank. Under
    nccl, ``full_tensor``. Under gloo the pieces cross on the host, by
    ``all_gather`` on CPU tensors: gloo's ``all_gather_into_tensor`` of CUDA
    tensors (what ``full_tensor`` runs) crashed the process on the H100
    (PERF.md §6)."""
    import torch.distributed as dist

    if dist.get_backend() != "gloo":
        return t.full_tensor()
    mesh = t.device_mesh
    x = t.to_local().cpu()
    for dim in reversed(range(mesh.ndim)):  # the innermost split first
        p = t.placements[dim]
        if p.is_partial():
            raise ValueError(f"gather takes Shard and Replicate placements, not {p}")
        if p.is_shard():
            parts = [torch.empty_like(x) for _ in range(mesh.size(dim))]
            dist.all_gather(parts, x.contiguous(), group=mesh.get_group(dim))
            x = torch.cat(parts, dim=p.dim)
    return x.to(t.device)


def _numel(leaf) -> int:
    n = 1
    for s in leaf.shape:
        n *= int(s)
    return n


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Device layout of a mesh-aware EBFT walk; ``mesh=None`` is a single
    device."""

    mesh: Optional[Any] = None

    # -- constructors -------------------------------------------------------
    @staticmethod
    def single() -> "MeshPlan":
        return MeshPlan(None)

    @staticmethod
    def from_mesh(mesh) -> "MeshPlan":
        return MeshPlan(mesh)

    # -- introspection ------------------------------------------------------
    @property
    def device_count(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for s in SH.axis_sizes(self.mesh).values():
            n *= s
        return n

    @property
    def active(self) -> bool:
        """True when the plan shards: a mesh of more than one device."""
        return self.mesh is not None and self.device_count > 1

    @property
    def data_size(self) -> int:
        if self.mesh is None:
            return 1
        size = 1
        for a in SH.batch_axes(self.mesh):
            size *= SH.mesh_axis_size(self.mesh, a)
        return size

    @property
    def model_size(self) -> int:
        return 1 if self.mesh is None else SH.mesh_axis_size(self.mesh, SH.MODEL_AXIS)

    def describe(self) -> Dict[str, Any]:
        """The manifest's summary (the ``mesh`` of a BENCH artifact)."""
        if self.mesh is None:
            return {"devices": 1, "axes": {}, "active": False}
        return {"devices": self.device_count, "axes": SH.axis_sizes(self.mesh),
                "active": self.active}

    # -- sharding rules -----------------------------------------------------
    def stacked_spec(self, leaf) -> SH.Spec:
        """The spec of a stacked-stream leaf (n_mb, B, ...): B over the
        batch axes, replicated when it does not divide."""
        shape = tuple(leaf.shape)
        if self.mesh is None or len(shape) < 2:
            return (None,) * len(shape)
        baxes = SH.batch_axes(self.mesh)
        bsize = self.data_size
        if bsize > 1 and shape[1] % bsize == 0 and shape[1] >= bsize:
            return (None, SH._batch_entry(baxes)) + (None,) * (len(shape) - 2)
        return (None,) * len(shape)

    def microbatch_spec(self, leaf) -> SH.Spec:
        """The spec of one microbatch (B, ...) of a stream: ``stacked_spec``
        of the same leaf with a unit microbatch axis, without that axis."""
        return self.stacked_spec(SH.ShapeLeaf((1, *leaf.shape)))[1:]

    def block_pspecs(self, block_tree: Any) -> Any:
        """The model-axis layout of one block's weights or masks."""
        return SH.param_pspecs(block_tree, self.mesh)

    # -- placement ----------------------------------------------------------
    def _put(self, t: torch.Tensor, spec) -> torch.Tensor:
        from torch.distributed.tensor import distribute_tensor

        # every rank holds the whole tensor: each keeps its own piece, and
        # nothing crosses the wire
        return distribute_tensor(t, self.mesh, SH.to_placements(spec, self.mesh),
                                 src_data_rank=None)

    def put_stacked(self, tree: Any) -> Any:
        """Shard each microbatch leaf (B, ...) of a stream tree over the batch
        axes (a no-op for an inactive plan). Non-tensor leaves pass."""
        if not self.active:
            return tree
        return T.tree_map(lambda t: self._put(t, self.microbatch_spec(t))
                          if isinstance(t, torch.Tensor) else t, tree)

    def put_block(self, block_tree: Any) -> Any:
        """Shard one block's weights or masks over "model" (a no-op when
        inactive)."""
        if not self.active:
            return block_tree
        return T.tree_map(self._put, block_tree, self.block_pspecs(block_tree))

    @staticmethod
    def gather(tree: Any) -> Any:
        """Whole tensors on every rank from a tree of DTensors (other leaves
        pass)."""
        from torch.distributed.tensor import DTensor

        return T.tree_map(lambda t: _whole(t) if isinstance(t, DTensor) else t, tree)

    # -- accounting ---------------------------------------------------------
    def sharded_bytes(self, tree: Any, specs: Optional[Any] = None) -> int:
        """Per-device bytes of ``tree`` under ``specs`` (default: the block
        layout), the per-shard counterpart of ``obs.profile.live_bytes``."""
        leaves = [leaf for _, leaf in T.leaves_with_path(tree)]
        if not self.active:
            return sum(_numel(x) * _itemsize(x) for x in leaves)
        specs = self.block_pspecs(tree) if specs is None else specs
        spec_leaves = [s for _, s in T.leaves_with_path(specs)]
        return sum(-(-_numel(x) // SH.shards_of(s, self.mesh)) * _itemsize(x)
                   for x, s in zip(leaves, spec_leaves))

    def allreduce_bytes(self, payload_bytes: int) -> int:
        """Wire bytes of one ring all-reduce of ``payload_bytes`` across the
        batch axes: 2·(d−1)·payload, summed over devices; 0 when d == 1."""
        d = self.data_size
        return 0 if d <= 1 else 2 * (d - 1) * int(payload_bytes)

    def explain(self, tree: Any, stacked: bool = False) -> List[Tuple[str, SH.Spec, bool]]:
        """(path, spec, sharded?) per leaf; ``sharded?`` False means the leaf
        replicates (for a leaf with a rule, the divisibility fallback).
        ``stacked=True`` reads ``tree`` as stacked streams (n_mb, B, ...)."""
        if self.mesh is None:
            return []
        if stacked:
            specs = T.tree_map(self.stacked_spec, tree)
        else:
            specs = self.block_pspecs(tree)
        return [("/".join(path) or "leaf", spec, any(a is not None for a in spec))
                for path, spec in T.leaves_with_path(specs)]
