"""Synthetic Shape-Net-Car-like CFD dataset for GINO (paper §B.2).

Each sample is a random superellipsoid "car body" surface point cloud with
a potential-flow surface-pressure label (the classic sphere/ellipsoid
coefficient C_p = 1 - 9/4 sin²θ generalised to the local surface normal
against the inlet direction).  The shapes, normals, features and labels
come from the reference's numpy code and ``np.random.RandomState`` draws,
so a seed gives the same arrays to the bit.  The fixed-k neighbour
candidate lists and radius masks GINO consumes come from a brute-force
KNN on the device (:func:`knn`), chunked over destinations.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

#: (destination, source) pairs of one KNN chunk: 2^24 pairs hold the
#: chunk's differences, distances and sort in ~0.4 GB
KNN_CHUNK_PAIRS = 1 << 24


def _superellipsoid_points(rng: np.random.RandomState, n_points: int):
    """Sample surface points + outward normals of a random superellipsoid
    centred in [0,1]^3."""
    e1 = rng.uniform(0.6, 1.4)
    e2 = rng.uniform(0.6, 1.4)
    ax = np.array([rng.uniform(0.30, 0.42), rng.uniform(0.14, 0.22), rng.uniform(0.10, 0.18)])
    theta = np.arccos(rng.uniform(-1, 1, n_points))
    phi = rng.uniform(0, 2 * np.pi, n_points)

    def sgnpow(x, p):
        return np.sign(x) * np.abs(x) ** p

    x = ax[0] * sgnpow(np.sin(theta), e1) * sgnpow(np.cos(phi), e2)
    y = ax[1] * sgnpow(np.sin(theta), e1) * sgnpow(np.sin(phi), e2)
    z = ax[2] * sgnpow(np.cos(theta), e1)
    pts = np.stack([x, y, z], axis=-1)
    # normals ∝ gradient of the implicit function; approximate by the
    # ellipsoidal normal (adequate for labels/features)
    normals = pts / (ax ** 2)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True) + 1e-9
    pts = pts + 0.5  # centre in unit cube
    return pts.astype(np.float32), normals.astype(np.float32)


def _pressure_label(normals: np.ndarray, inlet=None):
    """Potential-flow-style C_p from the angle between surface normal and
    the inlet direction: C_p = 1 - 9/4 sin²θ (sphere potential flow)."""
    if inlet is None:
        inlet = np.array([1.0, 0.0, 0.0])
    c = normals @ inlet
    s2 = 1.0 - c ** 2
    return (1.0 - 2.25 * s2).astype(np.float32)[:, None]


def latent_grid_coords(G: int) -> np.ndarray:
    """The latent nodes as the data pipeline places them: numpy's f64
    ``linspace`` cast to f32 (the model's own grid is ``jnp.linspace``'s,
    which differs from it at some nodes)."""
    t = np.linspace(0.0, 1.0, G)
    gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


def knn(src: torch.Tensor, dst: torch.Tensor, k: int,
        radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each destination point: the indices of its k nearest source
    points, nearest first, and a radius mask, on the tensors' device.

    src (Ns, 3), dst (Nd, 3) f32 -> idx (Nd, k) int64, mask (Nd, k) f32.
    The squared distance is the reference's, ``(dst - src)²`` summed over
    x, y, z in that order in f32 (not ‖a‖² + ‖b‖² − 2a·b, which reorders
    near ties); the k smallest by a stable sort; the mask is ``sqrt(d²) <=
    radius`` in f32, the nearest candidate always kept.  Destinations go
    in chunks of ``KNN_CHUNK_PAIRS`` pairs."""
    if src.shape[0] < k:
        raise ValueError(f"{src.shape[0]} source points, fewer than k = {k}")
    r = torch.tensor(radius, dtype=torch.float32)
    rows = max(1, KNN_CHUNK_PAIRS // max(src.shape[0], 1))
    idx, mask = [], []
    for s in range(0, dst.shape[0], rows):
        d = dst[s:s + rows]
        d2 = None
        for c in range(3):
            diff = d[:, c, None] - src[None, :, c]
            sq = diff * diff
            d2 = sq if d2 is None else d2 + sq
        order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        dist = torch.sqrt(torch.gather(d2, 1, order))
        m = (dist <= r).to(torch.float32)
        m[:, 0] = 1.0
        idx.append(order)
        mask.append(m)
    return torch.cat(idx), torch.cat(mask)


def sample_car_batch(seed: int, batch: int, n_points: int = 256, latent_grid: int = 8,
                     k: int = 8, radius: float = 0.35,
                     device: DeviceLike = None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (batch_dict, labels) on ``device`` (CUDA unless the caller
    names another), where the KNN runs.  ``batch_dict`` is what
    :func:`~repro_torch.models.gino.gino_apply` takes: ``points``,
    ``feats`` (the inlet-aligned normal component), ``enc_idx``,
    ``enc_mask`` (per latent node: its k nearest points), ``query`` (the
    points again), ``dec_idx``, ``dec_mask`` (per point: its k nearest
    latent nodes); labels (B, N, 1).  Indices are int64, the rest f32."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    lat = torch.from_numpy(latent_grid_coords(latent_grid)).to(dev)
    out = {name: [] for name in ("points", "feats", "enc_idx", "enc_mask",
                                 "query", "dec_idx", "dec_mask")}
    labels = []
    for _ in range(batch):
        pts_np, normals = _superellipsoid_points(rng, n_points)
        pts = torch.from_numpy(pts_np).to(dev)
        enc_idx, enc_mask = knn(pts, lat, k, radius)
        dec_idx, dec_mask = knn(lat, pts, k, radius)
        out["points"].append(pts)
        out["feats"].append(torch.from_numpy(normals[:, :1].copy()).to(dev))
        out["enc_idx"].append(enc_idx)
        out["enc_mask"].append(enc_mask)
        out["query"].append(pts)
        out["dec_idx"].append(dec_idx)
        out["dec_mask"].append(dec_mask)
        labels.append(torch.from_numpy(_pressure_label(normals)).to(dev))
    return {name: torch.stack(v) for name, v in out.items()}, torch.stack(labels)
