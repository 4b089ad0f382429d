"""Qwen2.5-32B [hf:Qwen/Qwen2.5-0.5B family; hf] — dense, GQA kv=8, QKV bias."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, mlp_act="swiglu", norm="rmsnorm", rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="qwen2.5-32b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512,
)
