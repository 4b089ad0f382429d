"""Qwen1.5-110B [hf:Qwen/Qwen1.5-0.5B family; hf] — dense, GQA kv=8, QKV bias."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064,
    qkv_bias=True, mlp_act="swiglu", norm="rmsnorm", rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="qwen1.5-110b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512,
)
