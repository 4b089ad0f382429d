"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — anyres vision frontend is a stub supplying precomputed patch embeddings (up to 5 tiles x 576 patches)."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    mlp_act="swiglu", norm="rmsnorm", rope_theta=1e6,
    frontend="vision", frontend_len=2880,
)

SMOKE = CONFIG.replace(
    name="llava-next-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512, frontend_len=8,
)
