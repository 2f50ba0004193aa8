"""Optimizer and loss scaling of the port."""
from .adamw import AdamW, AdamWState, all_finite, global_norm  # noqa: F401
from .loss_scale import (  # noqa: F401
    LossScaleState,
    init_loss_scale,
    loss_scaling_required,
    scale_loss,
    unscale_grads,
    update_loss_scale,
)
