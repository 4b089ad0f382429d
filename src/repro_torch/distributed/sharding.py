"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

``param_pspecs`` maps every parameter leaf to a spec by leaf name and
shape, with divisibility checks against the mesh: a rule that does not
divide falls back down its preference list, and at last to replication.

A spec is a tuple with one entry per dimension of the leaf: ``None``
(replicated), an axis name, or a tuple of axis names. It compares entry
by entry with the reference's ``PartitionSpec`` (``tuple(P)``).
``to_placements`` turns one into DTensor placements on a real
``DeviceMesh``: ``Shard(d)`` on every mesh dimension that names tensor
dimension ``d``, ``Replicate()`` on the others.

Canonical tensor-parallel layout (one all-reduce per sub-block,
Megatron-style), as the reference's:

  * q/k/v projections column-parallel over heads (``wq`` (d, H, hd) on H)
  * output projection row-parallel over heads (``wo`` (H, hd, d) on H)
  * MLP up/gate column-parallel over ff, down row-parallel over ff
  * MoE experts expert-parallel over E ("model" doubles as the EP axis)
  * embeddings and the LM head over the vocab
  * Mamba2 in/out projections over heads

Data parallelism: the batch axis of inputs is sharded over ("pod",
"data") when the mesh has a pod axis, else ("data",).

ZeRO-1: optimizer moments take the param spec and also shard their
largest still-free, divisible axis over "data".

Leaves are anything with a ``.shape`` (tensors, meta tensors, or the
shape-only leaves of ``ShapeLeaf``); trees are the port's nested dicts.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or a
``launch.mesh.AbstractMesh``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch import tree as T

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh: shape is a tuple of sizes
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    return (POD_AXIS, DATA_AXIS) if POD_AXIS in axis_names(mesh) else (DATA_AXIS,)


def _fits(dim: int, size: int) -> bool:
    return dim % size == 0 and dim >= size


# ---------------------------------------------------------------------------
# per-leaf rules: name -> (n_logical_dims, [(dim_idx, axis, mode), ...]),
# tried in order; leading stack axes (L, G, K, E...) are padded with None.
# ``mode`` is kept from the reference, where "pad" marks a rule that uneven
# sharding could serve; like the reference's, only an exact fit is taken
# (non-dividing heads are padded at the parameter level instead:
# ``head_padding`` and ``launch.steps.padded_heads``).
#
# Attention shards only over heads: the scores contract head_dim, so
# sharding it would make every attention chunk a cross-device partial
# sum. Under-divisible KV heads (GQA kv=8 on a 16-wide axis) replicate.
# Mamba B/C/dt/conv leaves replicate: they are small, and sharding the
# state dim makes the SSD contraction cross-device.
# ---------------------------------------------------------------------------
_LOGICAL_RULES = {
    "wq": (3, [(1, MODEL_AXIS, "pad")]),       # (d, H, hd)
    "wk": (3, [(1, MODEL_AXIS, "exact")]),     # (d, Hkv, hd)
    "wv": (3, [(1, MODEL_AXIS, "exact")]),
    "bq": (2, [(0, MODEL_AXIS, "pad")]),       # (H, hd)
    "bk": (2, [(0, MODEL_AXIS, "exact")]),
    "bv": (2, [(0, MODEL_AXIS, "exact")]),
    "wo": (3, [(0, MODEL_AXIS, "pad")]),       # (H, hd, d)
    "w_up": (2, [(1, MODEL_AXIS, "exact")]),   # (d, ff)
    "w_gate": (2, [(1, MODEL_AXIS, "exact")]),
    "w_down": (2, [(0, MODEL_AXIS, "exact")]), # (ff, d)
    "in_z": (3, [(1, MODEL_AXIS, "exact")]),   # (d, H, P)
    "in_x": (3, [(1, MODEL_AXIS, "exact")]),
    "in_dt": (2, [(1, MODEL_AXIS, "exact")]),  # (d, H)
    "out": (3, [(0, MODEL_AXIS, "exact")]),    # (H, P, d)
    "gnorm_w": (1, [(0, MODEL_AXIS, "exact")]),# (H*P,) follows heads
    "tok": (2, [(0, MODEL_AXIS, "exact")]),    # (V, d)
    "head_w": (2, [(1, MODEL_AXIS, "exact")]), # (d, V)
}
# expert-batched leaves: E over model (EP) first; ff as the fallback
_EXPERT_LEAF_DIMS = {"w_up": 3, "w_gate": 3, "w_down": 3}


def _replicated(ndim: int) -> Spec:
    return (None,) * ndim


def _leaf_spec(names: Tuple[str, ...], shape: Tuple[int, ...], mesh) -> Spec:
    name = names[-1]
    msize = mesh_axis_size(mesh, MODEL_AXIS)
    ndim = len(shape)

    key = name
    if name == "w" and "head" in names:
        key = "head_w"
    if name == "w" and "gnorm" in names:
        key = "gnorm_w"
    if name == "w" and "router" in names:
        return _replicated(ndim)  # routers replicate

    if key in _EXPERT_LEAF_DIMS and "experts" in names:
        e_idx = ndim - 3
        if _fits(shape[e_idx], msize):
            spec = [None] * ndim
            spec[e_idx] = MODEL_AXIS
            return tuple(spec)

    if key not in _LOGICAL_RULES:
        return _replicated(ndim)
    n_logical, candidates = _LOGICAL_RULES[key]
    lead = ndim - n_logical
    if lead < 0:
        return _replicated(ndim)
    for dim_idx, axis, _mode in candidates:
        d = lead + dim_idx
        if _fits(shape[d], mesh_axis_size(mesh, axis)):
            spec = [None] * ndim
            spec[d] = axis
            return tuple(spec)
    return _replicated(ndim)


def _batch_entry(baxes: Tuple[str, ...]):
    return baxes if len(baxes) > 1 else baxes[0]


def _batch_size(mesh) -> int:
    size = 1
    for a in batch_axes(mesh):
        size *= mesh_axis_size(mesh, a)
    return size


def param_pspecs(params_tree: Any, mesh, fsdp: bool = False) -> Any:
    """Tree of specs matching ``params_tree``. ``fsdp=True`` also shards
    each leaf's largest still-free, divisible axis over the batch axes
    (pod×data): the fully-sharded parameters of the configs whose
    tensor-parallel weights alone exceed a device (``launch.steps.wants_fsdp``)."""
    baxes = batch_axes(mesh)
    bsize = _batch_size(mesh)

    def g(path, leaf):
        shape = tuple(leaf.shape)
        spec = list(_leaf_spec(path, shape, mesh))
        if fsdp and len(shape) >= 2:
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if spec[i] is None and _fits(shape[i], bsize):
                    spec[i] = _batch_entry(baxes)
                    break
        return tuple(spec)

    return T.map_with_path(g, params_tree)


def opt_pspecs(opt_shapes: Any, param_specs_by_path: Any, mesh) -> Any:
    """ZeRO-1 moment sharding: the param's spec, plus "data" on the largest
    free, divisible axis. Moment leaves live under ``m``/``v``/``mu`` and
    mirror the params; leaves without a param analogue (the step counter)
    replicate. ``param_specs_by_path`` is unused, as in the reference."""
    dsize = mesh_axis_size(mesh, DATA_AXIS)

    def g(path, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        base = _leaf_spec(tuple(n for n in path if n not in ("m", "v", "mu")), shape, mesh)
        spec = list(base) + [None] * (len(shape) - len(base))
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if spec[i] is None and _fits(shape[i], dsize):
                spec[i] = DATA_AXIS
                break
        return tuple(spec)

    return T.map_with_path(g, opt_shapes)


def batch_pspecs(batch_tree: Any, mesh) -> Any:
    """Input batches: dim 0 over (pod, data), the rest replicated. A batch
    that does not divide falls back to data alone, then to replication."""
    baxes = batch_axes(mesh)
    bsize = _batch_size(mesh)

    def g(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        if _fits(shape[0], bsize):  # ("data",) as "data", as PartitionSpec keeps it
            return (_batch_entry(baxes),) + _replicated(len(shape) - 1)
        if len(baxes) > 1 and _fits(shape[0], mesh_axis_size(mesh, DATA_AXIS)):
            return (DATA_AXIS,) + _replicated(len(shape) - 1)
        return _replicated(len(shape))

    return T.tree_map(g, batch_tree)


def cache_pspecs(cache_tree: Any, mesh) -> Any:
    """Serve-state sharding, the reference's heuristic: the batch dim (the
    first dim from axis 1 on, for rank >= 3 leaves, that divides the data
    axis) over "data", then dim -2 or else -1 over "model" when it divides.
    Scalars and vectors replicate."""
    dsize = mesh_axis_size(mesh, DATA_AXIS)
    msize = mesh_axis_size(mesh, MODEL_AXIS)

    def g(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) <= 1:
            return _replicated(len(shape))
        spec: list = [None] * len(shape)
        for i in range(1 if len(shape) >= 3 else 0, len(shape)):
            if _fits(shape[i], dsize):
                spec[i] = DATA_AXIS
                break
        for i in (len(shape) - 2, len(shape) - 1):
            if spec[i] is None and _fits(shape[i], msize):
                spec[i] = MODEL_AXIS
                break
        return tuple(spec)

    return T.tree_map(g, cache_tree)


def port_cache_pspecs(cache_tree: Any, mesh) -> Any:
    """``cache_pspecs`` on the port's serve state. The port keeps a KV
    cache as (L, B, Hkv, max_len, hd) where the reference keeps (L, B,
    max_len, Hkv, hd), and ``cache_pspecs``'s "model" rule reads dim -2:
    on the port's layout that is ``max_len``. So each 5-D ``k``/``v`` leaf
    takes the reference's spec of its reference-layout shape, with dims 2
    and 3 swapped back: the batch over "data", the KV heads over "model"
    when they divide, ``max_len`` never sharded. The host-int ``len`` has
    no spec (``None``). The Mamba states take the head-parallel mixer's
    layout (``local_kernels.mamba_mixer``), not the reference's (which
    splits the SSM state along N and the conv state along its channels,
    across head boundaries): an ``ssm`` leaf (..., B, H, N, P) its batch
    over "data" and its heads over "model", a ``conv`` leaf (..., B, K-1,
    ch) its batch over "data" only, each when it divides. Every other leaf
    (the encoder-decoder's memory) is laid out as the reference's."""
    dsize = mesh_axis_size(mesh, DATA_AXIS)
    msize = mesh_axis_size(mesh, MODEL_AXIS)

    def mamba(shape, batch_dim, heads_dim=None):
        spec = [None] * len(shape)
        if _fits(shape[batch_dim], dsize):
            spec[batch_dim] = DATA_AXIS
        if heads_dim is not None and _fits(shape[heads_dim], msize):
            spec[heads_dim] = MODEL_AXIS
        return tuple(spec)

    def g(path, leaf):
        if not hasattr(leaf, "shape"):
            return None
        shape = tuple(leaf.shape)
        name = path[-1] if path else None
        if name == "ssm" and len(shape) >= 4:
            return mamba(shape, -4, -3)
        if name == "conv" and len(shape) >= 3:
            return mamba(shape, -3)
        kv = bool(path) and path[-1] in ("k", "v") and len(shape) == 5
        if kv:
            shape = shape[:2] + (shape[3], shape[2]) + shape[4:]
        spec = cache_pspecs(ShapeLeaf(shape), mesh)
        return spec[:2] + (spec[3], spec[2]) + spec[4:] if kv else spec

    return T.map_with_path(g, cache_tree)


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (``None`` -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shards_of(spec: Spec, mesh) -> int:
    """How many pieces a leaf under ``spec`` is cut into."""
    n = 1
    for entry in spec:
        for a in spec_axes(entry):
            n *= mesh_axis_size(mesh, a)
    return n


def to_placements(spec: Sequence, mesh) -> Tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh`` (the reference's
    ``named``): ``Shard(d)`` on each mesh dimension that spec entry ``d``
    names, ``Replicate()`` elsewhere and on a dimension of size 1. A mesh
    dimension named twice is an error."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    placements = []
    for name in axis_names(mesh):
        dims = [d for d, entry in enumerate(spec) if name in spec_axes(entry)]
        if len(dims) > 1:
            raise ValueError(f"spec {tuple(spec)} names mesh axis {name!r} twice")
        # an axis of size 1 cuts nothing; Replicate keeps DTensor's views
        # free to merge that dim (a one-row microbatch on a 1 x 2 mesh)
        placements.append(Shard(dims[0]) if dims and sizes[name] > 1 else Replicate())
    return tuple(placements)


class ShapeLeaf:
    """A shape-only leaf (the port's ``jax.ShapeDtypeStruct``): what the
    rules read of a parameter without allocating it."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype=None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    def __repr__(self) -> str:
        return f"ShapeLeaf({self.shape}, {self.dtype})"


def abstract_params(model, block: Optional[int] = None) -> Any:
    """The shapes of ``model.init``'s tree (or of block ``block`` of it) as
    ``ShapeLeaf``s, with nothing allocated: the init runs under
    ``FakeTensorMode`` (the port's ``jax.eval_shape``), so a full
    Kimi-K2 (about 1 T parameters) costs no memory."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = model.init(torch.Generator())
        if block is not None:
            params = model.get_block(params, block)
        return T.tree_map(lambda t: ShapeLeaf(t.shape, t.dtype), params)
