"""Tiny hybrid config for tests/benches (alias of zamba2_1_2b SMOKE)."""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs.zamba2_1_2b import SMOKE as CONFIG

SMOKE = CONFIG
