"""The port's kernel registry: one entry point, uniform signatures (the
port of ``repro.kernels``).

Every kernel package here exposes ``ops.call(*operands, **params)`` beside
its named wrappers. :func:`dispatch` is the one way in::

    from repro_torch import kernels
    out = kernels.dispatch("masked_matmul", x, w, m)
    out = kernels.dispatch("flash_attention", q, k, v, layout="bshd")

It resolves each module lazily: importing ``repro_torch.kernels`` builds
nothing and loads no library. On the card every wrapper launches through
a launch plan (``kernels.validation``) and, without explicit tiles,
resolves them through ``kernels.tuning`` (``--kernel-tune
{off,cache,search}`` on ``launch/ebft_run``); explicit tiles always win,
and mode ``off`` (the library default) launches the default tiles.
"""
from __future__ import annotations

import importlib
from typing import Any, Tuple

_REGISTRY = {
    "masked_matmul": "repro_torch.kernels.masked_matmul.ops",
    "nm_spmm": "repro_torch.kernels.nm_spmm.ops",
    "flash_attention": "repro_torch.kernels.flash_attention.ops",
}


def names() -> Tuple[str, ...]:
    """The registered kernels, in a stable order."""
    return tuple(_REGISTRY)


def dispatch(name: str, *operands: Any, **params: Any):
    """Run kernel ``name`` on ``operands`` through its uniform wrapper: the
    plain version on CPU tensors, the kernel on CUDA ones."""
    module = _REGISTRY.get(name)
    if module is None:
        raise KeyError(f"unknown kernel {name!r}; registered: {', '.join(_REGISTRY)}")
    return importlib.import_module(module).call(*operands, **params)
