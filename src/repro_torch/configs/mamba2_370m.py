"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    mixer="ssd", ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
)

SMOKE = LMArchConfig(
    name="mamba2-370m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=256,
    mixer="ssd", ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
)
