"""FNO (Li et al. 2021) with the mixed-precision spectral pipeline.

Architecture (as the neuraloperator reference):
  lifting MLP  ->  n_layers x [ SpectralConv + (1x1 conv skip) + GELU ]
               ->  projection MLP

The parameters keep the JAX reference's layout, so a reference parameter
tree loads as it is (:func:`params_from_jax`): linear weights are
``(in, out)``, and the per-layer spectral and skip weights are stacked on
a leading layer axis.

Precision is site-addressed: dense (real) ops resolve ``fno/dense`` /
``fno/layer<i>/dense`` (the AMP set), the spectral pipeline resolves
``fno/layer<i>/spectral/{fft_in,contract,fft_out}``, and the output head
``fno/proj_out``; parameters are f32 masters.  The block loop is a Python
loop, so a ``precision_rules`` override of one layer reaches that layer.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.spectral import (
    init_spectral_weights,
    spectral_conv_apply,
    spectral_weight_shapes,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.precision import FULL, PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class FNOConfig:
    in_channels: int = 3
    out_channels: int = 1
    hidden_channels: int = 64
    lifting_channels: int = 256
    projection_channels: int = 256
    n_layers: int = 4
    modes: Tuple[int, ...] = (16, 16)
    #: "dense" | "cp" | "tucker" (TFNO = cp/tucker)
    factorization: str = "dense"
    rank: float = 0.5
    #: the fused rFFT-contract-irFFT kernels for dense layers: None is on
    #: for CUDA tensors and off for CPU tensors, True/False force it; a
    #: layer they cannot take (shape, budgets, policy) runs staged
    fuse_spectral: Optional[bool] = None
    positional_embedding: bool = True  # append normalised grid coords

    @property
    def ndim(self) -> int:
        return len(self.modes)


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@functools.cache
def _gelu_consts(dtype: torch.dtype):
    """The constants rounded to the activation dtype first, as JAX's weak
    types do; 0-d CPU tensors, which CUDA ops take as scalars (a CUDA
    copy would be a host-device sync at every call)."""
    return tuple(torch.tensor(v, dtype=torch.float32).to(dtype)
                 for v in (_SQRT_2_OVER_PI, 0.044715))


class _Gelu(torch.autograd.Function):
    """The tanh-approximate GELU as ``jax.nn.gelu`` (its default) writes it,
    op by op in ``x``'s dtype, forward and backward.
    ``F.gelu(approximate="tanh")`` is the same function but rounds once:
    on bf16/fp16 activations it differs from the reference in ~40 % of
    elements, as much as the AMP rounding itself.  Autograd through the
    op-by-op forward rounds the derivative's ops in another order than
    JAX's VJP does (58 % of bf16 elements differ), so the backward writes
    out the reference's VJP, op for op."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        c, k = _gelu_consts(x.dtype)
        cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
        return x * cdf

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c, k = _gelu_consts(x.dtype)
        e = 3.0 * (x * x)
        t = torch.tanh(c * (x + k * (x * x * x)))
        p = (0.5 * (x * g)) * (1.0 - t)
        s = c * (p + p * t)
        return (g * (0.5 * (1.0 + t)) + s) + (k * s) * e


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return _Gelu.apply(x)


def _linear(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    # channel-last contraction; x: (..., d_in), w: (d_in, d_out)
    return x.to(dtype) @ w.to(dtype) + b.to(dtype)


def _affine(d_in: int, d_out: int) -> nn.ParameterDict:
    return nn.ParameterDict({"w": nn.Parameter(torch.empty(d_in, d_out)),
                             "b": nn.Parameter(torch.zeros(d_out))})


def linspace01(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in f32, bit for bit: ``i · f32(1/(n-1))``
    for i < n - 1 (XLA multiplies by the reciprocal), then exactly 1.
    ``torch.linspace`` differs from it by an ulp at some points (4 of 128,
    137 of 421), and so does ``i · f32(1/(n-1))`` at i = n - 1 for some n."""
    if n <= 1:
        return torch.zeros(n, dtype=torch.float32, device=device)
    step = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(n - 1.0, dtype=torch.float32)
    head = torch.arange(n - 1, dtype=torch.float32, device=device) * step
    return torch.cat([head, torch.ones(1, dtype=torch.float32, device=device)])


def _positional_grid(spatial: Sequence[int], dtype, device) -> torch.Tensor:
    axes = [linspace01(s, device) for s in spatial]
    grids = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(grids, dim=0).to(dtype)  # (ndim, *spatial)


class FNO(nn.Module):
    """The FNO's parameters and forward.  Build one with :func:`init_fno`
    or :func:`params_from_jax`; the constructor leaves the weights
    uninitialised."""

    def __init__(self, cfg: FNOConfig):
        super().__init__()
        self.cfg = cfg
        in_ch = cfg.in_channels + (cfg.ndim if cfg.positional_embedding else 0)
        H, L = cfg.hidden_channels, cfg.n_layers
        self.lift1 = _affine(in_ch, cfg.lifting_channels)
        self.lift2 = _affine(cfg.lifting_channels, H)
        self.proj1 = _affine(H, cfg.projection_channels)
        self.proj2 = _affine(cfg.projection_channels, cfg.out_channels)
        shapes = spectral_weight_shapes(H, H, cfg.modes, cfg.factorization, cfg.rank)
        self.spectral = nn.ParameterDict({
            name: nn.Parameter(torch.empty(L, *shape)) for name, shape in shapes.items()})
        self.skips = nn.ParameterDict({
            "w": nn.Parameter(torch.empty(L, H, H)),
            "b": nn.Parameter(torch.zeros(L, H)),
        })

    def forward(self, x: torch.Tensor, policy: PrecisionPolicy = FULL) -> torch.Tensor:
        """x: (batch, in_channels, *spatial) -> (batch, out_channels, *spatial)."""
        cfg = self.cfg
        B, spatial = x.shape[0], tuple(x.shape[2:])
        cdt = policy.at("fno/dense").compute_dtype

        if cfg.positional_embedding:
            pos = _positional_grid(spatial, x.dtype, x.device)
            x = torch.cat([x, pos.expand(B, *pos.shape)], dim=1)

        # lifting (channel-last for the MLPs)
        h = x.movedim(1, -1)
        h = _gelu(_linear(self.lift1["w"], self.lift1["b"], h, cdt))
        h = _linear(self.lift2["w"], self.lift2["b"], h, cdt)
        h = h.movedim(-1, 1).to(cdt)  # (B, hidden, *spatial)

        for layer in range(cfg.n_layers):
            ldt = policy.at(f"fno/layer{layer}/dense").compute_dtype
            spect = {name: p[layer] for name, p in self.spectral.items()}
            y = spectral_conv_apply(
                spect, h, cfg.modes, policy, site=f"fno/layer{layer}/spectral",
                fuse_spectral=cfg.fuse_spectral,
            ).to(ldt)
            s = _linear(self.skips["w"][layer], self.skips["b"][layer],
                        h.movedim(1, -1), ldt).movedim(-1, 1)
            h = _gelu(y + s)

        # projection
        h = h.movedim(1, -1)
        h = _gelu(_linear(self.proj1["w"], self.proj1["b"], h, cdt))
        h = _linear(self.proj2["w"], self.proj2["b"], h,
                    policy.at("fno/proj_out").compute_dtype)
        return h.movedim(-1, 1)


@torch.no_grad()
def init_fno(generator: torch.Generator, cfg: FNOConfig,
             device: DeviceLike = None) -> FNO:
    """A randomly initialised FNO on ``device`` (CUDA unless the caller
    names another).  The reference's scaled normals, drawn on the CPU from
    ``generator`` (a CPU generator), so a seed gives the same weights on
    every device.  Biases start at zero."""
    dev = resolve_device(device)
    model = FNO(cfg)
    for name in ("lift1", "lift2", "proj1", "proj2"):
        w = getattr(model, name)["w"]
        w.copy_(w.shape[0] ** -0.5 * torch.randn(w.shape, generator=generator))
    layers = [init_spectral_weights(cfg.hidden_channels, cfg.hidden_channels, cfg.modes,
                                    cfg.factorization, cfg.rank, generator=generator)
              for _ in range(cfg.n_layers)]
    for name, p in model.spectral.items():
        p.copy_(torch.stack([layer[name] for layer in layers]))
    w = model.skips["w"]
    w.copy_(w.shape[1] ** -0.5 * torch.randn(w.shape, generator=generator))
    return model.to(dev)


def params_from_jax(tree: Mapping, cfg: FNOConfig, device: DeviceLike = None) -> FNO:
    """An FNO on ``device`` holding the JAX reference's parameters.

    ``tree``: the reference's parameter pytree as nested dicts of arrays:
    ``lift1/lift2/proj1/proj2: {w (in, out), b}``, ``spectral``: dense
    ``{w_re, w_im}`` of shape (L, corners, I, O, *modes) or the CP factors
    ``{lam_*, U_i_*, U_o_*, U_m<k>_*}`` or the Tucker factors
    ``{core_*, U_*}``, stacked (L, corners, ...),
    ``skips: {w (L, H, H), b (L, H)}``.
    Every entry must be present with the shape ``cfg`` gives it."""
    dev = resolve_device(device)
    model = FNO(cfg)
    state = {f"{group}.{name}": torch.from_numpy(np.array(v, dtype=np.float32))
             for group, sub in tree.items() for name, v in sub.items()}
    model.load_state_dict(state, strict=True)
    return model.to(dev)


def params_from_jax_checkpoint(ckpt_dir: str, cfg: FNOConfig, step: Optional[int] = None,
                               device: DeviceLike = None) -> FNO:
    """An FNO on ``device`` holding the ``params`` subtree of a checkpoint
    written by the JAX reference's ``Trainer`` (or by this port's, which
    keys its checkpoints the same way), at ``step`` (default: the latest).

    The reference stores each leaf of its state in ``arrays.npz`` under
    the ``str()`` of its JAX key path joined by ``|``, so the parameters
    sit under ``['params']|['<group>']|['<name>']``."""
    from repro_torch.train.checkpoint import read_subtree

    tree, _ = read_subtree(ckpt_dir, "params", step)
    return params_from_jax(tree, cfg, device=device)


def fno_apply(model: FNO, x: torch.Tensor, policy: PrecisionPolicy = FULL) -> torch.Tensor:
    """x: (batch, in_channels, *spatial) -> (batch, out_channels, *spatial)."""
    return model(x, policy)


@torch.no_grad()
def fno_infer(model: FNO, x, policy: PrecisionPolicy = FULL,
              device: DeviceLike = None) -> torch.Tensor:
    """Batched-inference entry point for serving, on ``device`` (CUDA
    unless the caller names another), where ``model`` must already live.

    x: (batch, in_channels, *spatial) -> (batch, out_channels, *spatial),
    cast to the ``serve/operator`` site's transport dtype (f32 in the base
    table).  Every op in the forward is per-sample independent, so the
    operator engine's padded micro-batches give each field the answer it
    gets alone."""
    dev = resolve_device(device)
    held = {p.device for p in model.parameters()}
    if held != {dev}:
        raise ValueError(f"model parameters live on {sorted(map(str, held))}, "
                         f"not on {dev}")
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    y = model(x, policy)
    return y.to(policy.at("serve/operator").compute_dtype)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
