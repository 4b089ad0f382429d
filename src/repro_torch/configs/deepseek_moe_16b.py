"""DeepSeek-MoE-16B [arXiv:2401.06066; hf] — fine-grained MoE: 64 routed top-6 + 2 shared experts, first layer dense (released dense d_ff=10944)."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    mlp_act="swiglu", norm="rmsnorm",
    moe_num_experts=64, moe_top_k=6, moe_num_shared=2, moe_d_ff=1408,
    moe_first_dense=1,
)

SMOKE = CONFIG.replace(
    name="deepseek-moe-smoke", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=256, vocab_size=512,
    moe_num_experts=8, moe_top_k=2, moe_num_shared=2, moe_d_ff=32,
    moe_first_dense=1,
)
