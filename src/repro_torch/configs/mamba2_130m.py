"""Mamba2-130M [arXiv:2405.21060; unverified] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    norm="rmsnorm",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
)

SMOKE = CONFIG.replace(
    name="mamba2-smoke", num_layers=2, d_model=64, vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=32,
)
