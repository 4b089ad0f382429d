"""Tiny dense config for tests/benches (alias of llama_7b SMOKE)."""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs.llama_7b import SMOKE as CONFIG

SMOKE = CONFIG
