"""smollm-360m [dense] — llama-arch small.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64,
)

SMOKE = LMArchConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
)
