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
