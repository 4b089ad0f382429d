"""Tiny ssm config for tests/benches (alias of mamba2_130m SMOKE)."""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs.mamba2_130m import SMOKE as CONFIG

SMOKE = CONFIG
