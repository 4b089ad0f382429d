"""Tiny moe config for tests/benches (alias of deepseek_moe_16b SMOKE)."""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs.deepseek_moe_16b import SMOKE as CONFIG

SMOKE = CONFIG
