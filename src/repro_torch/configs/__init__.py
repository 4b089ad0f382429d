"""Config registry: ``get_config(name)``.

A copy of the JAX package's registry, cut to the configurations the port
runs so far: the paper's own Llama-7B and its tiny test variant. Each
module exposes ``CONFIG`` (published numbers) and ``SMOKE`` (same family,
reduced) ModelConfigs.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

CONFIG_IDS = ["llama_7b", "tiny_dense"]

_ALIAS = {i.replace("_", "-"): i for i in CONFIG_IDS}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    name = _ALIAS.get(name, name)
    if name not in CONFIG_IDS:
        raise KeyError(f"{name!r} is not ported yet (ported: {CONFIG_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    if smoke:
        return getattr(mod, "SMOKE", mod.CONFIG)
    return mod.CONFIG
