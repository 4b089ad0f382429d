"""Atomic, optionally asynchronous checkpoints of tensor dicts (port of
``repro.checkpoint.ckpt``, one device).

The layout is the reference's, so a checkpoint written by either package
restores in the other:

    <dir>/step_00000123.tmp/    (written)
    <dir>/step_00000123/        (made visible by an atomic rename)
        manifest.json           step, mesh_shape, treedef, names, shapes,
                                dtypes, source_specs
        arrays.npz              leaf_0, leaf_1, ... (full leaf values)

Leaves are numbered in ``jax.tree_util``'s order, dict keys sorted at
every level (``repro_torch.tree`` walks insertion order), and named by
their ``/``-joined keys. A ``None`` is an empty subtree, as in jax (SGD's
``mu`` without momentum). numpy has no bfloat16, so a bf16 leaf is stored
as its ``uint16`` bits with the dtype string ``"bfloat16"``. ``treedef``
holds a plain description; no reader reads it.

``save(async_write=True)`` copies every leaf to host memory before it
returns (the train step updates the weights in place, so the writer must
not share their storage) and writes in a background thread; ``wait_all``
joins the writers and raises the first error one of them met. A crash
mid-write leaves only a ``.tmp`` directory, which ``latest_step`` ignores
and the next save of that step removes. Restoring onto a mesh
(``shardings``) waits for the distributed port (ROADMAP.md A.8).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

_PENDING: List[Tuple[threading.Thread, list]] = []  # (writer, its error box)
_BF16 = "bfloat16"


def _flatten(tree: Any, path: T.Path = ()) -> List[Tuple[T.Path, Any]]:
    """(path, leaf) in jax's order: dict keys sorted, None has no leaf."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flatten(tree[k], path + (k,))]
    return [] if tree is None else [(path, tree)]


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A copy of the leaf on the host, as stored (bf16 as its uint16 bits),
    and its dtype string."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def save(directory: str, tree: Any, step: int, mesh_shape: Optional[tuple] = None,
         async_write: bool = False) -> str:
    """Write ``tree`` as ``<directory>/step_<step>``; returns that path."""
    flat = _flatten(tree)
    names = ["/".join(p) for p, _ in flat]
    host = [_to_host(x) for _, x in flat]
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"

    def write():
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
        manifest = {
            "step": step,
            "mesh_shape": list(mesh_shape) if mesh_shape else None,
            "treedef": f"dict tree of {len(host)} leaves, keys sorted",
            "names": names,
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [d for _, d in host],
            "source_specs": [None] * len(host),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic visibility

    if os.path.exists(tmp):  # a stale tmp from a crash
        shutil.rmtree(tmp)
    if async_write:
        errors: list = []

        def guarded():
            try:
                write()
            except Exception as e:  # handed to wait_all, which raises it
                errors.append(e)

        t = threading.Thread(target=guarded, daemon=True)
        t.start()
        _PENDING.append((t, errors))
    else:
        write()
    return final


def wait_all() -> None:
    """Join every background writer; raise the first error one met."""
    first = None
    while _PENDING:
        t, errors = _PENDING.pop()
        t.join()
        if errors and first is None:
            first = errors[0]
    if first is not None:
        raise first


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def restore(directory: str, template: Any, step: Optional[int] = None) -> Any:
    """The checkpoint at ``step`` (default: the latest) in ``template``'s
    structure: each leaf cast to the template leaf's dtype and placed on
    its device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(template)
    n = len(manifest["names"])
    if len(flat) != n:
        raise AssertionError(f"checkpoint has {n} leaves, template {len(flat)} — "
                             "config drift between writer and reader")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        leaves = {path: _from_host(data[f"leaf_{i}"], manifest["dtypes"][i])
                  .to(device=t.device, dtype=t.dtype)
                  for i, (path, t) in enumerate(flat)}
    return T.map_with_path(lambda path, t: None if t is None else leaves[path], template)
