"""starcoder2-15b [dense] — GQA kv=4, RoPE.
[arXiv:2402.19173; hf]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152, head_dim=128,
)

SMOKE = LMArchConfig(
    name="starcoder2-15b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=192, vocab=256, head_dim=16,
)
