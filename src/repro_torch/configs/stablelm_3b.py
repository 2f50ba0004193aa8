"""stablelm-3b [dense] — MHA (kv=32).
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304, head_dim=80,
)

SMOKE = LMArchConfig(
    name="stablelm-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=256, head_dim=16,
)
