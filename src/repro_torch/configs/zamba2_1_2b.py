"""Zamba2-1.2B [arXiv:2411.15242; hf] — Mamba2 backbone + one shared attention block every 6 layers."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    mlp_act="swiglu", norm="rmsnorm",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    hybrid_attn_every=6,
)

SMOKE = CONFIG.replace(
    name="zamba2-1.2b-smoke", num_layers=5, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=32, hybrid_attn_every=2,
)
