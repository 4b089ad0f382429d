"""Tiny encdec config for tests/benches (alias of seamless_m4t_medium SMOKE)."""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs.seamless_m4t_medium import SMOKE as CONFIG

SMOKE = CONFIG
