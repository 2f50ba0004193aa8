"""whisper-large-v3 [audio] — enc-dec backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from .base import LMArchConfig

CONFIG = LMArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    encoder_decoder=True, dec_layers=32, max_dec_len=448,
    frontend="audio_stub",
)

SMOKE = LMArchConfig(
    name="whisper-large-v3-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    encoder_decoder=True, dec_layers=2, max_dec_len=16,
    frontend="audio_stub",
)
