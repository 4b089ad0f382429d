"""LlamaV1/V2-7B — the paper's own evaluation model (EBFT Tables 1-6)."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="llama-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=32000,
    mlp_act="swiglu", norm="rmsnorm",
)

SMOKE = CONFIG.replace(
    name="llama-7b-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=512,
)
