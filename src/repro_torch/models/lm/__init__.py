"""The LM architecture pool (decoder-only, MoE, SSM, hybrid,
encoder-decoder audio, VLM) on one layer substrate, and its serving
steps.  The paged-cache entry points wait for the paged serving slice."""
from .common import (  # noqa: F401
    blocked_attention,
    chunk_attention,
    gqa_attention,
    plain_attention,
    rmsnorm,
)
from .model import (  # noqa: F401
    FULL_WINDOW,
    LM,
    init_cache,
    init_lm,
    layer_windows,
    lm_decode_step,
    lm_forward,
    lm_params_from_jax,
    lm_prefill_chunk,
)
from .moe import init_moe, moe_apply  # noqa: F401
from .ssd import init_ssd, ssd_decode_step, ssd_forward  # noqa: F401
from .whisper import (  # noqa: F401
    Whisper,
    init_whisper,
    init_whisper_cache,
    whisper_decode_step,
    whisper_encode,
    whisper_forward,
    whisper_params_from_jax,
)
