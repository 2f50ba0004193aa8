"""granite-34b [dense] — llama-arch, code; MQA (kv=1).
[arXiv:2405.04324; hf]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
)

SMOKE = LMArchConfig(
    name="granite-34b-smoke", family="dense",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=192, vocab=256, head_dim=16,
)
