"""Row RMSNorm: the CUDA kernel, its plain PyTorch version and the wrapper
that checks and launches it.

    y[n, :] = x[n, :] · rsqrt(mean(x[n, :]²) + eps) · w

with x and w read as f32, the mean and both products in f32, and y rounded
once to x's dtype.  The kernel replaces the TPU kernel ``_rmsnorm_kernel``
of ``repro.kernels.rmsnorm``; its source (``csrc/rmsnorm.cu``) states its
bound and design.  There is no VJP (the reference has none).

Dispatch follows the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise.  ``launches_rmsnorm`` counts the
kernel's launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .build import CSRC, LaunchIO, _bind, _call

#: kernel launches since the count was last set to 0
launches_rmsnorm = 0

SOURCE = CSRC / "rmsnorm.cu"
#: format codes of the C interface
_FMT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


#: packs a lane holds of its row, the kernel's instances (0: the generic
#: instance, which reads the row twice), and the most warps a row takes
_CHUNKS, _MAX_WPR = (2, 4, 8), 8


class RmsPlan(NamedTuple):
    """How ``rmsnorm_fwd`` takes the rows: 16-byte packs or one element a
    lane (``vec``), packs a lane holds (``chunks``, 0 for the generic
    instance), warps a row takes, rows a block of 8 warps takes at once,
    and how many times the blocks resident on the card walk the row groups
    (``waves``; 0: one block a row group)."""
    vec: bool
    chunks: int
    warps_per_row: int
    rows_per_block: int
    waves: int


@functools.lru_cache(maxsize=None)
def rmsnorm_plan(D: int, x_dtype: torch.dtype, w_dtype: torch.dtype,
                 aligned: bool = True) -> RmsPlan:
    """The kernel's instance for rows of ``D`` features: 16-byte packs where
    a row's bytes are a multiple of 16 and ``aligned`` (x, w and y start on
    16 bytes), else one element a lane; then the fewest warps a row (1, 2, 4
    or 8) whose lanes hold the row in at most 4 packs each, or else 8 packs
    at 8 warps, the packs rounded up to an instance (fewer registers a lane
    and more warps a row ran faster than the reverse at 6144 features);
    the generic instance (8 warps a row, the row read twice, one element a
    lane) past what 8 warps hold.  Half rows are walked twice over by the
    blocks resident on the card, f32 rows take a block a row group: each
    ran fastest so at 960 and 6144 features (``tools/kernel_trials.py``)."""
    if x_dtype not in _FMT or w_dtype not in _FMT:
        raise TypeError(f"rmsnorm takes x and w of {list(_FMT)}, got {x_dtype} and {w_dtype}")
    size = x_dtype.itemsize
    vec = aligned and (D * size) % 16 == 0
    units = D // (16 // size) if vec else D
    waves = 0 if size == 4 else 2
    for most in (4, _CHUNKS[-1]):
        wpr = next((w for w in (1, 2, 4, _MAX_WPR) if -(-units // (32 * w)) <= most), None)
        if wpr is not None:
            per = -(-units // (32 * wpr))
            chunks = next(c for c in _CHUNKS if c >= per)
            return RmsPlan(vec, chunks, wpr, _MAX_WPR // wpr, waves)
    return RmsPlan(False, 0, _MAX_WPR, 1, waves)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``_rmsnorm_kernel``'s function op for op: ``(xf * rsqrt(mean(xf*xf) +
    eps)) * wf`` in f32, left to right, one rounding to x's dtype."""
    xf, wf = x.float(), w.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * wf[None, :]
    return y.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, block_rows: int) -> torch.device:
    """The checks every entry makes; returns the operands' device."""
    if x.dtype not in _FMT or w.dtype not in _FMT:
        raise TypeError(f"rmsnorm takes x and w of {list(_FMT)}, got {x.dtype} and {w.dtype}")
    if x.ndim != 2 or w.ndim != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm: expected x (N, D) and w (D,), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if int(block_rows) < 1:
        raise ValueError(f"rmsnorm: block_rows must be positive, got {block_rows}")
    if x.device != w.device:
        raise ValueError(f"rmsnorm: operands on {x.device} and {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rmsnorm: no kernel for {x.device}")
    if x.device.type == "cuda" and not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: operands must be contiguous")
    return x.device


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 256) -> torch.Tensor:
    """x: (N, D) rows to normalise; w: (D,) scale, of f32, bf16 or fp16
    each.  Returns (N, D) at x's dtype.  ``block_rows`` is the reference's
    row tile; rows are independent, so the kernel takes its own
    (``rmsnorm_plan``) and the result does not depend on it."""
    device = _check(x, w, block_rows)
    if device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    return _launch(x, w, eps)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    global launches_rmsnorm
    N, D = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, y))
    plan = rmsnorm_plan(D, x.dtype, w.dtype, aligned)
    _call(_library().rmsnorm_fwd, "rmsnorm_fwd", x.device, x.data_ptr(), w.data_ptr(),
          y.data_ptr(), N, D, _FMT[x.dtype], _FMT[w.dtype], int(plan.vec), plan.chunks,
          plan.warps_per_row, plan.waves, float(eps), io=LaunchIO((x, w), (y,)))
    launches_rmsnorm += 1
    return y


@functools.cache
def _library():
    return _bind(SOURCE, rmsnorm_fwd=(3, 8, 1))
