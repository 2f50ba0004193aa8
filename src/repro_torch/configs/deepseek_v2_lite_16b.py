"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 2 shared + 64 routed
top-6 experts, per-expert d_ff=1408.
[arXiv:2405.04434; hf]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    moe_experts=64, moe_top_k=6, moe_shared=2, moe_ff=1408,
    mla_kv_lora=512, mla_rope_dim=64, mla_nope_dim=128, mla_v_dim=128,
)

SMOKE = LMArchConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=256,
    moe_experts=4, moe_top_k=2, moe_shared=1, moe_ff=64,
    mla_kv_lora=32, mla_rope_dim=8, mla_nope_dim=16, mla_v_dim=16,
)
