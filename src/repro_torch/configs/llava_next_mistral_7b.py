"""llava-next-mistral-7b [vlm] — mistral-7b backbone; anyres tiling
frontend is a STUB (input_specs provides precomputed patch embeddings,
576 base-resolution patches prepended to the text sequence).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128,
    frontend="vision_stub", n_patches=576,
)

SMOKE = LMArchConfig(
    name="llava-next-mistral-7b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16,
    frontend="vision_stub", n_patches=8,
)
