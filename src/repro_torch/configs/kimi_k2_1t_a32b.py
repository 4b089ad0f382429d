"""Kimi-K2 1T-A32B [arXiv:2501.kimi2; unverified] — trillion-param MoE, 384 routed experts top-8 + 1 shared, first layer dense. head_dim=128 per the released config (64 heads x 128 > d_model, DeepSeek-V3 convention); dense-layer d_ff=18432 = moe_d_ff*(top_k+shared) matches the released dense FFN."""
from repro_torch.configs.base import ModelConfig


CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=18432, vocab_size=163840,
    mlp_act="swiglu", norm="rmsnorm",
    moe_num_experts=384, moe_top_k=8, moe_num_shared=1, moe_d_ff=2048,
    moe_first_dense=1,
)

SMOKE = CONFIG.replace(
    name="kimi-k2-smoke", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
    moe_num_experts=8, moe_top_k=2, moe_num_shared=1, moe_d_ff=32,
    moe_first_dense=1,
)
