"""U-Net baseline (paper Section 4.5 / Table 2).

A standard 2-D conv U-Net used as the non-operator PDE surrogate
baseline, written as the reference writes it: per level two 3x3 ``SAME``
convolutions with GELU, a 2x2 max pool down, a nearest x2 upsample and a
skip concatenation up, and a 1x1 head.  No TPU kernel lies on its path:
the convolutions are ``F.conv2d``.

Precision: the convolutions and activations resolve ``unet/dense``, the
head ``unet/proj_out``; parameters are f32 masters.  A convolution adds
its bias in the compute dtype after the product, as the reference does
(two roundings, not ``F.conv2d``'s one).  The parameters keep the
reference's layout (``enc``/``dec``: lists of ``{c1, c2}``, ``mid1``,
``mid2``, ``head``; each ``{w (out, in, k, k), b}``), so a reference
parameter tree loads as it is (:func:`unet_params_from_jax`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.precision import FULL, PrecisionPolicy

from .fno import _gelu


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 3
    out_channels: int = 1
    base_width: int = 32
    depth: int = 3


def _conv_params(cin: int, cout: int, k: int = 3) -> nn.ParameterDict:
    return nn.ParameterDict({"w": nn.Parameter(torch.empty(cout, cin, k, k)),
                             "b": nn.Parameter(torch.zeros(cout))})


def _conv(p, x: torch.Tensor, dtype) -> torch.Tensor:
    """A stride-1 ``SAME`` convolution in ``dtype``, its bias added after."""
    w = p["w"]
    y = F.conv2d(x.to(dtype), w.to(dtype), padding=w.shape[-1] // 2)
    return y + p["b"].to(dtype)[None, :, None, None]


def upsample_nearest2(h: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), each row and column repeated twice:
    ``jax.image.resize(..., "nearest")`` at an exact factor of 2."""
    return h.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class UNet(nn.Module):
    """The U-Net's parameters and forward.  Build one with
    :func:`init_unet` or :func:`unet_params_from_jax`; the constructor
    leaves the weights uninitialised."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        cin, width = cfg.in_channels, cfg.base_width
        enc = []
        for _ in range(cfg.depth):
            enc.append(nn.ModuleDict({"c1": _conv_params(cin, width),
                                      "c2": _conv_params(width, width)}))
            cin, width = width, width * 2
        self.enc = nn.ModuleList(enc)
        self.mid1 = _conv_params(cin, width)
        self.mid2 = _conv_params(width, cin)
        dec = []
        for d in range(cfg.depth):
            width = cin // (2 ** d)
            dec.append(nn.ModuleDict({
                "c1": _conv_params(width * 2, width),
                "c2": _conv_params(width, max(width // 2, cfg.base_width))}))
        self.dec = nn.ModuleList(dec)
        self.head = _conv_params(max(width // 2, cfg.base_width), cfg.out_channels, k=1)

    def forward(self, x: torch.Tensor, policy: PrecisionPolicy = FULL) -> torch.Tensor:
        """x: (B, C, H, W) -> (B, out, H, W).  H, W must be divisible by
        2^depth."""
        depth = self.cfg.depth
        if x.shape[-2] % (1 << depth) or x.shape[-1] % (1 << depth):
            raise ValueError(f"spatial dims {tuple(x.shape[-2:])} not divisible by 2^{depth}")
        cdt = policy.at("unet/dense").compute_dtype
        head_dt = policy.at("unet/proj_out").compute_dtype
        h = x.to(cdt)
        skips = []
        for blk in self.enc:
            h = _gelu(_conv(blk["c1"], h, cdt))
            h = _gelu(_conv(blk["c2"], h, cdt))
            skips.append(h)
            h = F.max_pool2d(h, 2)
        h = _gelu(_conv(self.mid1, h, cdt))
        h = _gelu(_conv(self.mid2, h, cdt))
        for blk, skip in zip(self.dec, reversed(skips), strict=True):
            h = torch.cat([upsample_nearest2(h), skip.to(cdt)], dim=1)
            h = _gelu(_conv(blk["c1"], h, cdt))
            h = _gelu(_conv(blk["c2"], h, cdt))
        return _conv(self.head, h.to(head_dt), head_dt)


def _convs(model: UNet) -> Iterator[nn.ParameterDict]:
    """The convolutions in the reference's order of initialisation."""
    for blk in model.enc:
        yield blk["c1"]
        yield blk["c2"]
    yield model.mid1
    yield model.mid2
    for blk in model.dec:
        yield blk["c1"]
        yield blk["c2"]
    yield model.head


@torch.no_grad()
def init_unet(generator: torch.Generator, cfg: UNetConfig,
              device: DeviceLike = None) -> UNet:
    """A randomly initialised U-Net on ``device`` (CUDA unless the caller
    names another): the reference's He normals, std √(2 / (c_in·k²)),
    drawn on the CPU from ``generator`` in the reference's order, so a
    seed gives the same weights on every device.  Biases start at zero."""
    dev = resolve_device(device)
    model = UNet(cfg)
    for p in _convs(model):
        w = p["w"]
        cout, cin, k, _ = w.shape
        w.copy_((2.0 / (cin * k * k)) ** 0.5 * torch.randn(w.shape, generator=generator))
    return model.to(dev)


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted name, array) of every leaf of a tree of dicts and lists."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix[:-1], tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}{k}.")


def unet_params_from_jax(tree: Mapping, cfg: UNetConfig, device: DeviceLike = None) -> UNet:
    """A U-Net on ``device`` holding the JAX reference's parameters:
    ``tree`` is its parameter pytree as nested dicts and lists of arrays
    (``enc``/``dec``: lists of ``{c1, c2}``; ``mid1``, ``mid2``, ``head``;
    each ``{w (out, in, k, k), b}``).  Every entry must be present with the
    shape ``cfg`` gives it."""
    dev = resolve_device(device)
    model = UNet(cfg)
    state = {name: torch.from_numpy(np.array(v, dtype=np.float32))
             for name, v in _leaves(tree)}
    model.load_state_dict(state, strict=True)
    return model.to(dev)


def unet_apply(model: UNet, x: torch.Tensor, policy: PrecisionPolicy = FULL) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, out, H, W)."""
    return model(x, policy)
