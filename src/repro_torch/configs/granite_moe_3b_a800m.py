"""granite-moe-3b-a800m [moe] — MoE 40e top-8 (assignment header; the
inline comment says 32e — we follow the explicit '40e top-8' spec),
per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    moe_experts=40, moe_top_k=8, moe_shared=0, moe_ff=512,
)

SMOKE = LMArchConfig(
    name="granite-moe-3b-a800m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=256, head_dim=16,
    moe_experts=4, moe_top_k=2, moe_shared=0, moe_ff=64,
)
