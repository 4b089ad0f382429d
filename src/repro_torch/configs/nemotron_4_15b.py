"""Nemotron-4-15B [arXiv:2402.16819; unverified] — dense, GQA kv=8, squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000,
    qkv_bias=False, mlp_act="sq_relu", norm="layernorm", rope_theta=10000.0,
)

SMOKE = CONFIG.replace(
    name="nemotron-4-15b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512,
)
