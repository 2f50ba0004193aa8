"""Operator models of the port."""
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
from .sfno import (  # noqa: F401
    SFNO,
    SFNOConfig,
    init_sfno,
    sfno_apply,
    sfno_infer,
    sfno_params_from_jax,
)
from .sht import legendre_matrices, sht_forward, sht_inverse  # noqa: F401
