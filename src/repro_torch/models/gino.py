"""Geometry-Informed Neural Operator (Li et al. 2023) on the port's FNO.

GNO encoder (irregular mesh -> regular latent grid) -> 3-D FNO on the
latent grid -> GNO decoder (latent grid -> query points) -> pressure head.

The radius graphs are fixed-k neighbour candidate lists with a radius
mask on top, precomputed by the data pipeline
(:func:`repro_torch.data.sample_car_batch`).  The kernel integral
  (K f)(x) = ∫_{B_r(x)} κ(x, y) f(y) dy
is a masked mean over the k candidates, with κ an MLP on [x, y, f(y)].

The latent FNO runs on the whole batch, (B, C, G, G, G), where the
reference vmaps the model over samples and runs it on (1, C, G, G, G):
every op of the FNO is per-sample independent.  Latent node n is
(i, j, k) with n = (i·G + j)·G + k (``meshgrid(..., indexing="ij")``),
the order the data's indices refer to.

Precision: the edge MLPs and the head resolve ``gino/dense``, the output
layer ``gino/proj_out``, the latent FNO its own ``fno/...`` sites.  The
parameters keep the reference's layout (``enc_k1/enc_k2/dec_k1/dec_k2/
head1/head2: {w (in, out), b}``, ``fno``: the FNO's tree), so a
reference parameter tree loads as it is (:func:`gino_params_from_jax`).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.precision import FULL, PrecisionPolicy

from .fno import FNO, FNOConfig, _affine, _gelu, _linear, init_fno, linspace01, params_from_jax

#: the edge MLPs and the head, in the reference's order of initialisation
_GNO_LAYERS = ("enc_k1", "enc_k2", "dec_k1", "dec_k2", "head1", "head2")


@dataclasses.dataclass(frozen=True)
class GINOConfig:
    in_features: int = 1          # per-point input features (e.g. normals dot)
    out_features: int = 1         # predicted field (pressure)
    hidden: int = 32
    latent_grid: int = 16         # latent cube resolution G (G^3 nodes)
    k_neighbors: int = 8
    fno: FNOConfig = dataclasses.field(
        default_factory=lambda: FNOConfig(
            in_channels=32, out_channels=32, hidden_channels=48,
            lifting_channels=48, projection_channels=48,
            n_layers=4, modes=(8, 8, 8), positional_embedding=False,
        )
    )


def latent_coords(G: int, device=None) -> torch.Tensor:
    """The latent nodes' coordinates, (G³, 3) f32: the reference's
    ``jnp.linspace`` grid, bit for bit."""
    t = linspace01(G, device)
    gx, gy, gz = torch.meshgrid(t, t, t, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(G ** 3, 3)


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[b, idx[b]]`` for every sample b: ``t`` (B, N, F), or (N, F)
    shared by the batch; ``idx`` (B, Nt, k) -> (B, Nt, k, F).  One
    advanced index into the flattened rows, whose backward is
    ``index_put_(accumulate=True)`` (sort-based on CUDA, so the same
    inputs give the same gradient)."""
    if t.dim() == 2:
        return t[idx]
    B, N, F = t.shape
    offsets = torch.arange(B, device=idx.device).view(B, 1, 1) * N
    return t.reshape(B * N, F)[idx + offsets]


def _gno_aggregate(p1, p2, x_to, x_from, feats, idx, mask, dtype) -> torch.Tensor:
    """Masked-mean kernel aggregation, batched.

    x_to:   (B, Nt, 3) destination coords.
    x_from: (B, Nf, 3), or (Nf, 3) shared, source coords.
    feats:  (B, Nf, F) source features.
    idx:    (B, Nt, k) candidate source indices.
    mask:   (B, Nt, k) 1.0 where the candidate is inside the radius ball.
    Returns (B, Nt, d_out) in ``dtype``."""
    nbr_x = _gather(x_from, idx)
    nbr_f = _gather(feats, idx)
    dest = x_to[:, :, None, :].expand_as(nbr_x)
    edge_in = torch.cat([dest, nbr_x, nbr_f], dim=-1)
    e = _gelu(_linear(p1["w"], p1["b"], edge_in, dtype))
    e = _linear(p2["w"], p2["b"], e, dtype)
    m = mask[..., None].to(dtype)
    # a half sum over the k candidates: in f32, rounded once (as XLA and
    # the card's reductions sum half operands)
    num = (e * m).float().sum(dim=2).to(dtype)
    return num / torch.clamp(m.sum(dim=2), min=1.0)


class GINO(nn.Module):
    """GINO's parameters and forward.  Build one with :func:`init_gino` or
    :func:`gino_params_from_jax`; the constructor leaves the weights
    uninitialised."""

    def __init__(self, cfg: GINOConfig):
        super().__init__()
        self.cfg = cfg
        h, f = cfg.hidden, cfg.fno
        shapes = {"enc_k1": (6 + cfg.in_features, h), "enc_k2": (h, f.in_channels),
                  "dec_k1": (6 + f.out_channels, h), "dec_k2": (h, h),
                  "head1": (h, h), "head2": (h, cfg.out_features)}
        for name in _GNO_LAYERS:
            setattr(self, name, _affine(*shapes[name]))
        self.fno = FNO(f)

    def forward(self, batch: Mapping[str, torch.Tensor],
                policy: PrecisionPolicy = FULL) -> torch.Tensor:
        """batch (every entry batched on its leading axis):
          points     (B, N, 3)    surface mesh vertices in [0,1]^3
          feats      (B, N, Fin)  per-point input features
          enc_idx    (B, G^3, k)  candidate point indices per latent node
          enc_mask   (B, G^3, k)
          query      (B, Nq, 3)   output query points
          dec_idx    (B, Nq, k)   candidate latent-node indices per query
          dec_mask   (B, Nq, k)
        Returns (B, Nq, out_features)."""
        cfg = self.cfg
        cdt = policy.at("gino/dense").compute_dtype
        head_dt = policy.at("gino/proj_out").compute_dtype
        G = cfg.latent_grid
        points = batch["points"]
        B = points.shape[0]
        lat_xyz = latent_coords(G, points.device)
        lat = _gno_aggregate(self.enc_k1, self.enc_k2, lat_xyz.expand(B, -1, -1), points,
                             batch["feats"], batch["enc_idx"], batch["enc_mask"], cdt)
        lat = lat.transpose(1, 2).reshape(B, cfg.fno.in_channels, G, G, G)
        lat = self.fno(lat, policy)
        lat = lat.reshape(B, cfg.fno.out_channels, G ** 3).transpose(1, 2)  # (B, G^3, C)
        out = _gno_aggregate(self.dec_k1, self.dec_k2, batch["query"], lat_xyz, lat,
                             batch["dec_idx"], batch["dec_mask"], cdt)
        out = _gelu(_linear(self.head1["w"], self.head1["b"], out, cdt))
        return _linear(self.head2["w"], self.head2["b"], out, head_dt)


@torch.no_grad()
def init_gino(generator: torch.Generator, cfg: GINOConfig,
              device: DeviceLike = None) -> GINO:
    """A randomly initialised GINO on ``device`` (CUDA unless the caller
    names another): the reference's scaled normals (1/√d_in) for the edge
    MLPs and the head, then the FNO's (:func:`init_fno`), all drawn on
    the CPU from ``generator``, so a seed gives the same weights on every
    device.  Biases start at zero."""
    dev = resolve_device(device)
    model = GINO(cfg)
    for name in _GNO_LAYERS:
        w = getattr(model, name)["w"]
        w.copy_(w.shape[0] ** -0.5 * torch.randn(w.shape, generator=generator))
    model.fno = init_fno(generator, cfg.fno, device="cpu")
    return model.to(dev)


def gino_params_from_jax(tree: Mapping, cfg: GINOConfig, device: DeviceLike = None) -> GINO:
    """A GINO on ``device`` holding the JAX reference's parameters:
    ``tree`` is its parameter pytree as nested dicts of arrays (the six
    ``{w (in, out), b}`` layers and ``fno``, loaded by
    :func:`~repro_torch.models.fno.params_from_jax`).  Every entry must be
    present with the shape ``cfg`` gives it."""
    dev = resolve_device(device)
    model = GINO(cfg)
    fno = params_from_jax(tree["fno"], cfg.fno, device="cpu")
    state = {f"{group}.{name}": torch.from_numpy(np.array(v, dtype=np.float32))
             for group, sub in tree.items() if group != "fno" for name, v in sub.items()}
    state.update({f"fno.{k}": v for k, v in fno.state_dict().items()})
    model.load_state_dict(state, strict=True)
    return model.to(dev)


def gino_apply(model: GINO, batch: Mapping[str, torch.Tensor],
               policy: PrecisionPolicy = FULL) -> torch.Tensor:
    """``batch`` as :meth:`GINO.forward` takes it -> (B, Nq, out_features)."""
    return model(batch, policy)
