"""Nested-dict trees: the port's stand-in for ``jax.tree`` on param and
mask dicts. A path is the tuple of dict keys from the root to a leaf."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

Path = Tuple[str, ...]


def map_with_path(fn: Callable, tree: Any, *rest: Any, _path: Path = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over every leaf; ``rest`` trees
    mirror ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), _path=_path + (k,))
                for k, v in tree.items()}
    return fn(_path, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return map_with_path(lambda _p, x, *r: fn(x, *r), tree, *rest)


def leaves_with_path(tree: Any, _path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, _path + (k,))
    else:
        yield _path, tree


def get_path(tree: Any, names: Path) -> Any:
    for n in names:
        tree = tree[n]
    return tree


def set_path(tree: dict, names: Path, value: Any) -> None:
    """In-place set of a nested-dict path; missing dicts on the way are made."""
    for n in names[:-1]:
        tree = tree.setdefault(n, {})
    tree[names[-1]] = value


def tensors(nest: Any) -> Iterator[Any]:
    """Every ``torch.Tensor`` in a nest of dicts, lists and tuples."""
    import torch

    if isinstance(nest, torch.Tensor):
        yield nest
    elif isinstance(nest, dict):
        for v in nest.values():
            yield from tensors(v)
    elif isinstance(nest, (list, tuple)):
        for v in nest:
            yield from tensors(v)
