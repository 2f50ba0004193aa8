"""Host wrappers the model code calls around the kernels.

``spectral_contract`` splits the complex spectrum into split-real f32
operands, flattens the modes, picks the storage rounding from the
contract site's rule and hands the operands to ``DenseContract``, the
autograd Function that launches the CUDA kernels for CUDA tensors and
runs the plain versions for CPU tensors, forward and backward.
"""
from __future__ import annotations

import torch

from repro_torch.precision import FULL, PrecisionPolicy

from .spectral_contract import DenseContract


def _site_of(policy, site: str):
    """Resolve a PrecisionPolicy at ``site``; pass SitePrecision through."""
    if isinstance(policy, PrecisionPolicy):
        return policy.at(site)
    return policy


def spectral_contract(
    x: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor, *,
    policy=FULL, site: str = "model/spectral/contract",
) -> torch.Tensor:
    """Dense spectral contraction ``bi<modes>,io<modes>->bo<modes>``.

    ``x``: complex64 (B, I, *modes).  ``w_re`` / ``w_im``: the layer's
    split-real f32 corner weight, (I, O, *modes), as the parameters hold
    it.  ``policy``: the resolved contract site, or a PrecisionPolicy
    resolved here at ``site``.

    Under a half rule the operands stay f32 and the kernel rounds them
    onto the storage grid as it loads them (the reference's fused cast);
    the product is stored at the storage dtype.  Under full precision the
    operands and the product are f32 with no rounding.  Gradients reach
    ``x``, ``w_re`` and ``w_im`` through the reference's custom VJP
    (f32, never rounded to the half grid).  Returns complex64
    (B, O, *modes).
    """
    policy = _site_of(policy, site)
    if not torch.is_complex(x) or x.ndim < 3 or w_re.ndim != x.ndim:
        raise ValueError(
            f"spectral_contract is dense-only: expected complex x (B, I, *modes) "
            f"and real w (I, O, *modes), got {x.dtype} {tuple(x.shape)} and "
            f"{tuple(w_re.shape)}")
    B, I, *modes = x.shape
    _, O, *wmodes = w_re.shape
    if tuple(modes) != tuple(wmodes) or w_re.shape[0] != I:
        raise ValueError(
            f"spectral_contract: x {tuple(x.shape)} and w {tuple(w_re.shape)} "
            f"disagree on channels or modes")
    M = 1
    for m in modes:
        M *= m
    half = policy.spectral_dtype if policy.spectral_is_half else None
    xr = x.real.reshape(B, I, M).contiguous()
    xi = x.imag.reshape(B, I, M).contiguous()
    out_re, out_im = DenseContract.apply(
        xr, xi, w_re.reshape(I, O, M), w_im.reshape(I, O, M),
        half, half or torch.float32)
    return torch.complex(out_re.float(), out_im.float()).reshape(B, O, *modes)
