"""Spherical FNO (Bonev et al. 2023) on the port's SHT.

Block: SHT -> truncate to (lmax, mmax) -> per-degree channel contraction
``bilm,iol->bolm`` (weights shared over order m, per the spherical
convolution theorem) -> iSHT, plus a pointwise skip, GELU.

The Legendre transforms and the spectral contraction are matrix products,
so the paper's mixed-precision pipeline applies as it is: tanh
pre-activation before the SHT, half-precision storage of the spherical
spectrum (boundary-quantised), contraction at half with f32 sums.  Every
stage resolves its format at the ``sfno/layer<i>/spectral/{fft_in,
contract,fft_out}`` sites; the dense ops at ``sfno/dense`` and
``sfno/layer<i>/dense``, the output head at ``sfno/proj_out``.

The parameters keep the JAX reference's layout (``lift1/lift2/proj1/
proj2``, ``spectral.{w_re,w_im}`` of shape (L, H, H, lmax), ``skips``),
so a reference parameter tree loads as it is
(:func:`sfno_params_from_jax`).  The block loop is a Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.precision import FULL, PrecisionPolicy

from .fno import _affine, _gelu, _linear, fno_infer
from .sht import sht_forward, sht_inverse


@dataclasses.dataclass(frozen=True)
class SFNOConfig:
    in_channels: int = 3
    out_channels: int = 3
    hidden_channels: int = 64
    n_layers: int = 4
    nlat: int = 64
    nlon: int = 128
    lmax: int = 32
    mmax: int = 32
    lifting_channels: int = 128
    projection_channels: int = 128


def _spherical_conv(h: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor,
                    cfg: SFNOConfig, policy: PrecisionPolicy,
                    site: str = "sfno/layer0/spectral") -> torch.Tensor:
    """h: (B, C, nlat, nlon) -> (B, C, nlat, nlon) through the spherical
    spectrum; ``w_re``/``w_im``: one layer's (I, O, lmax) weight."""
    fft_in = policy.at(f"{site}/fft_in")
    ctr = policy.at(f"{site}/contract")
    fft_out = policy.at(f"{site}/fft_out")
    coeffs = sht_forward(fft_in.stabilize(h).float(), cfg.lmax, cfg.mmax,
                         precision=fft_in)                          # (B, C, l, m)
    out = kops.spectral_contract_lshared(coeffs, torch.complex(w_re, w_im), policy=ctr)
    y = sht_inverse(out, cfg.nlat, cfg.nlon)
    if fft_out.spectral_is_half:
        y = y.to(fft_out.compute_dtype)
    return y


class SFNO(nn.Module):
    """The SFNO's parameters and forward.  Build one with
    :func:`init_sfno` or :func:`sfno_params_from_jax`; the constructor
    leaves the weights uninitialised."""

    def __init__(self, cfg: SFNOConfig):
        super().__init__()
        self.cfg = cfg
        H, L = cfg.hidden_channels, cfg.n_layers
        self.lift1 = _affine(cfg.in_channels, cfg.lifting_channels)
        self.lift2 = _affine(cfg.lifting_channels, H)
        self.proj1 = _affine(H, cfg.projection_channels)
        self.proj2 = _affine(cfg.projection_channels, cfg.out_channels)
        self.spectral = nn.ParameterDict({
            name: nn.Parameter(torch.empty(L, H, H, cfg.lmax)) for name in ("w_re", "w_im")})
        self.skips = nn.ParameterDict({
            "w": nn.Parameter(torch.empty(L, H, H)),
            "b": nn.Parameter(torch.zeros(L, H)),
        })

    def forward(self, x: torch.Tensor, policy: PrecisionPolicy = FULL) -> torch.Tensor:
        """x: (B, in_channels, nlat, nlon) -> (B, out_channels, nlat, nlon)."""
        cfg = self.cfg
        cdt = policy.at("sfno/dense").compute_dtype
        h = x.movedim(1, -1)
        h = _gelu(_linear(self.lift1["w"], self.lift1["b"], h, cdt))
        h = _linear(self.lift2["w"], self.lift2["b"], h, cdt)
        h = h.movedim(-1, 1).to(cdt)

        for layer in range(cfg.n_layers):
            ldt = policy.at(f"sfno/layer{layer}/dense").compute_dtype
            y = _spherical_conv(h, self.spectral["w_re"][layer], self.spectral["w_im"][layer],
                                cfg, policy, site=f"sfno/layer{layer}/spectral").to(ldt)
            s = _linear(self.skips["w"][layer], self.skips["b"][layer],
                        h.movedim(1, -1), ldt).movedim(-1, 1)
            h = _gelu(y + s)

        h = h.movedim(1, -1)
        h = _gelu(_linear(self.proj1["w"], self.proj1["b"], h, cdt))
        h = _linear(self.proj2["w"], self.proj2["b"], h,
                    policy.at("sfno/proj_out").compute_dtype)
        return h.movedim(-1, 1)


@torch.no_grad()
def init_sfno(generator: torch.Generator, cfg: SFNOConfig,
              device: DeviceLike = None) -> SFNO:
    """A randomly initialised SFNO on ``device`` (CUDA unless the caller
    names another): the reference's scaled normals (linear weights
    1/√d_in, spectral weights 1/H), drawn on the CPU from ``generator``,
    so a seed gives the same weights on every device.  Biases start at
    zero."""
    dev = resolve_device(device)
    model = SFNO(cfg)
    for name in ("lift1", "lift2", "proj1", "proj2"):
        w = getattr(model, name)["w"]
        w.copy_(w.shape[0] ** -0.5 * torch.randn(w.shape, generator=generator))
    for p in model.spectral.values():
        p.copy_(torch.randn(p.shape, generator=generator) / cfg.hidden_channels)
    w = model.skips["w"]
    w.copy_(w.shape[1] ** -0.5 * torch.randn(w.shape, generator=generator))
    return model.to(dev)


def sfno_params_from_jax(tree: Mapping, cfg: SFNOConfig, device: DeviceLike = None) -> SFNO:
    """An SFNO on ``device`` holding the JAX reference's parameters:
    ``tree`` is its parameter pytree as nested dicts of arrays
    (``lift1/lift2/proj1/proj2: {w (in, out), b}``, ``spectral: {w_re,
    w_im}`` (L, H, H, lmax), ``skips: {w (L, H, H), b (L, H)}``).  Every
    entry must be present with the shape ``cfg`` gives it."""
    dev = resolve_device(device)
    model = SFNO(cfg)
    state = {f"{group}.{name}": torch.from_numpy(np.array(v, dtype=np.float32))
             for group, sub in tree.items() for name, v in sub.items()}
    model.load_state_dict(state, strict=True)
    return model.to(dev)


def sfno_apply(model: SFNO, x: torch.Tensor, policy: PrecisionPolicy = FULL) -> torch.Tensor:
    """x: (B, in_channels, nlat, nlon) -> (B, out_channels, nlat, nlon)."""
    return model(x, policy)


def sfno_infer(model: SFNO, x, policy: PrecisionPolicy = FULL,
               device: DeviceLike = None) -> torch.Tensor:
    """Batched-inference entry point for serving, on ``device`` (CUDA
    unless the caller names another), where ``model`` must already live:
    (B, in_channels, nlat, nlon) -> (B, out_channels, nlat, nlon) at the
    ``serve/operator`` transport dtype.  Every op is per-sample
    independent, as in :func:`~repro_torch.models.fno.fno_infer`, whose
    checks and casts it shares."""
    return fno_infer(model, x, policy, device=device)
