"""Seamless-M4T-medium [arXiv:2308.11596; hf] — enc-dec text backbone; audio frontend is a stub supplying precomputed frame embeddings (assignment)."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, enc_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    mlp_act="gelu", norm="layernorm",
    frontend="audio",
)

SMOKE = CONFIG.replace(
    name="seamless-m4t-smoke", num_layers=2, enc_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
)
