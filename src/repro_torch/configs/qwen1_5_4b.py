"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family; hf] — dense, GQA kv=20 (MHA), QKV bias."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True, mlp_act="swiglu", norm="rmsnorm", rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="qwen1.5-4b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512,
)
