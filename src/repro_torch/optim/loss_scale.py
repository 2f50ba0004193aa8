"""Dynamic loss scaling for the fp16 path.

With the tanh stabiliser in place, loss scaling keeps small fp16
gradients from flushing to zero (paper §B.5).  Whether a run needs it is
decided by the resolved precision rules, the ``train/loss_scale`` site
(:func:`loss_scaling_required`): fp16-family rule sets turn it on, bf16
rule sets do not.  The state lives on the device as two scalar tensors;
the update is written with ``torch.where``, as the reference's.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from repro_torch.device import DeviceLike


def loss_scaling_required(policy) -> bool:
    """Resolve the ``train/loss_scale`` site of a precision rule set (scoped
    ``precision_rules`` overrides apply here too)."""
    return bool(policy.at("train/loss_scale").loss_scaling)


class LossScaleState(NamedTuple):
    scale: torch.Tensor       # f32 scalar
    good_steps: torch.Tensor  # int32 scalar


def init_loss_scale(initial: float = 2.0 ** 15,
                    device: DeviceLike = "cpu") -> LossScaleState:
    return LossScaleState(
        scale=torch.tensor(initial, dtype=torch.float32, device=device),
        good_steps=torch.zeros((), dtype=torch.int32, device=device),
    )


def scale_loss(loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
    return loss * state.scale.to(loss.dtype)


def unscale_grads(grads: Mapping[str, torch.Tensor], state: LossScaleState):
    inv = 1.0 / state.scale
    return {k: g.to(torch.float32) * inv for k, g in grads.items()}


def update_loss_scale(
    state: LossScaleState,
    grads_finite,
    growth_interval: int = 200,
    growth_factor: float = 2.0,
    backoff_factor: float = 0.5,
    max_scale: float = 2.0 ** 24,
    min_scale: float = 1.0,
) -> LossScaleState:
    finite = torch.as_tensor(grads_finite, device=state.scale.device)
    good = torch.where(finite, state.good_steps + 1, torch.zeros_like(state.good_steps))
    grow = good >= growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow, torch.clamp(state.scale * growth_factor, max=max_scale),
                    state.scale),
        torch.clamp(state.scale * backoff_factor, min=min_scale),
    )
    return LossScaleState(scale=new_scale,
                          good_steps=torch.where(grow, torch.zeros_like(good), good))
