"""Config registry: ``get_config(name)``.

A copy of the JAX package's registry, with every configuration of every
family: the dense family (the paper's own Llama-7B, its tiny test
variant, Qwen1.5-4B, Nemotron-4-15B, Qwen2.5-32B and Qwen1.5-110B), the
MoE family (DeepSeek-MoE-16B, its tiny variant, and Kimi-K2, whose full
width only the sharded cells lay out, on the production meshes:
``launch/steps.py``; a mesh run of the family waits for ROADMAP.md A.8e),
the SSM family
(Mamba2-130M, tiny_ssm), the hybrid (Zamba2-1.2B, tiny_hybrid), the
VLM (LLaVA-NeXT-Mistral-7B, tiny_vlm) and the encoder-decoder
(Seamless-M4T-medium, tiny_encdec). Each module exposes ``CONFIG``
(published numbers) and ``SMOKE`` (same family, reduced) ModelConfigs.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

CONFIG_IDS = ["llama_7b", "tiny_dense", "qwen1_5_4b", "nemotron_4_15b", "qwen2_5_32b",
              "qwen1_5_110b", "deepseek_moe_16b", "tiny_moe", "kimi_k2_1t_a32b",
              "mamba2_130m", "tiny_ssm", "zamba2_1_2b", "tiny_hybrid",
              "llava_next_mistral_7b", "tiny_vlm", "seamless_m4t_medium", "tiny_encdec"]

_ALIAS = {i.replace("_", "-"): i for i in CONFIG_IDS}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    name = _ALIAS.get(name, name)
    if name not in CONFIG_IDS:
        raise KeyError(f"{name!r} is not ported yet (ported: {CONFIG_IDS})")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    if smoke:
        return getattr(mod, "SMOKE", mod.CONFIG)
    return mod.CONFIG
