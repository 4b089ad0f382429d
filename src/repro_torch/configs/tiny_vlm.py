"""Tiny vlm config for tests/benches (alias of llava_next_mistral_7b SMOKE)."""
from repro_torch.configs.base import ModelConfig

from repro_torch.configs.llava_next_mistral_7b import SMOKE as CONFIG

SMOKE = CONFIG
