"""hymba-1.5b [hybrid] — parallel attention + mamba heads per block;
SWA everywhere except 3 full-attention layers (first/middle/last).
At 500k decode the full-attn layers also ring-buffer to the SWA window
(documented deviation, DESIGN.md §7 — keeps the stacked-layer cache O(W)).
[arXiv:2411.13676; hf]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    mixer="hymba", attn_window=2048, n_full_attn_layers=3,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
)

SMOKE = LMArchConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    mixer="hymba", attn_window=32, n_full_attn_layers=1,
    ssm_state=8, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
)
