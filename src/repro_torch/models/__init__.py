"""Operator models and the LM pool of the port."""
from .fno import (  # noqa: F401
    FNO,
    FNOConfig,
    fno_apply,
    fno_infer,
    init_fno,
    param_count,
    params_from_jax,
    params_from_jax_checkpoint,
)
from .gino import (  # noqa: F401
    GINO,
    GINOConfig,
    gino_apply,
    gino_params_from_jax,
    init_gino,
    latent_coords,
)
from .sfno import (  # noqa: F401
    SFNO,
    SFNOConfig,
    init_sfno,
    sfno_apply,
    sfno_infer,
    sfno_params_from_jax,
)
from .lm import LM, Whisper, lm_params_from_jax, whisper_params_from_jax  # noqa: F401
from .sht import legendre_matrices, sht_forward, sht_inverse  # noqa: F401
from .unet import UNet, UNetConfig, init_unet, unet_apply, unet_params_from_jax  # noqa: F401
