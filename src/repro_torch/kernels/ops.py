"""Host wrappers the model code calls around the kernels.

``spectral_contract`` splits the complex spectrum into split-real f32
operands, flattens the modes, picks the storage rounding from the
contract site's rule and hands the operands to ``DenseContract``, the
autograd Function that launches the CUDA kernels for CUDA tensors and
runs the plain versions for CPU tensors, forward and backward.
``spectral_contract_cp`` folds the CP mode factor, rounds every operand
to the site's storage dtype outside the kernels (differentiably, so the
gradients come back to f32 through the casts) and hands them to
``CPContract``.  ``spectral_contract_lshared`` does the same for the
SFNO's order-shared contraction and ``LSharedContract``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.precision import FULL, PrecisionPolicy

from .spectral_contract import CPContract, DenseContract, LSharedContract


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


def cp_mode_factor(lam: torch.Tensor, mode_factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fold λ (R,) and the per-axis CP factors (m_k, R) into the combined
    mode factor ``W[r, m] = λ_r Π_k U_mk[m_k, r]`` over the row-major
    flattened mode index (tiny, differentiable; the kernels never
    materialise the dense (I, O, M) weight this factor replaces)."""
    w = lam[:, None]
    for f in mode_factors:
        w = (w[:, :, None] * f.T[:, None, :]).reshape(w.shape[0], -1)
    return w


def _pair(z: torch.Tensor, dtype: torch.dtype):
    """Split-real parts of ``z`` at ``dtype``, contiguous (differentiable)."""
    return z.real.to(dtype).contiguous(), z.imag.to(dtype).contiguous()


def spectral_contract_cp(
    x: torch.Tensor, lam: torch.Tensor, ui: torch.Tensor, uo: torch.Tensor,
    mode_factors: Sequence[torch.Tensor], *, policy=FULL,
    site: str = "model/spectral/contract",
) -> torch.Tensor:
    """CP-factorised spectral contraction (TFNO, paper §4.6).

    ``x``: complex64 (B, I, *modes); ``lam``: (R,) complex CP weights;
    ``ui``/``uo``: (I, R)/(O, R) complex channel factors;
    ``mode_factors``: one (m_k, R) complex factor per mode axis.
    ``policy``: the resolved contract site, or a PrecisionPolicy resolved
    here at ``site``.

    x, U_i, U_o and the folded W are rounded to the site's storage dtype
    (f32 when it does not quantise) before the kernels, which take no
    cast; t and u stay f32 inside them and the product is stored at the
    storage dtype.  Returns complex64 (B, O, *modes).
    """
    policy = _site_of(policy, site)
    half = policy.spectral_dtype if policy.spectral_is_half else torch.float32
    B, I, *modes = x.shape
    if len(mode_factors) != len(modes):
        raise ValueError(
            f"spectral_contract_cp: {len(mode_factors)} mode factors for "
            f"{len(modes)}-d modes {tuple(modes)}")
    M = 1
    for m in modes:
        M *= m
    w = cp_mode_factor(lam, mode_factors)  # (R, M) complex

    out_re, out_im = CPContract.apply(*_pair(x.reshape(B, I, M), half), *_pair(ui, half),
                                      *_pair(uo, half), *_pair(w, half))
    O = uo.shape[0]
    return torch.complex(out_re.float(), out_im.float()).reshape(B, O, *modes)


def spectral_contract_lshared(
    x: torch.Tensor, w: torch.Tensor, *, policy=FULL,
    site: str = "model/spectral/contract",
) -> torch.Tensor:
    """Order-shared spherical contraction ``bilm,iol->bolm`` (SFNO).

    ``x``: complex64 (B, I, L, M), the (degree, order) spherical spectrum;
    ``w``: complex (I, O, L), shared across orders m by the spherical
    convolution theorem, so the dense (I, O, L, M) weight and its gradient
    are never formed.  ``policy``: the resolved contract site, or a
    PrecisionPolicy resolved here at ``site``.

    x and w are rounded to the site's storage dtype (f32 when it does not
    quantise) before the kernels, which sum in f32 and store the product
    at that dtype.  Returns complex64 (B, O, L, M).
    """
    policy = _site_of(policy, site)
    if x.ndim != 4 or w.ndim != 3:
        raise ValueError(
            f"spectral_contract_lshared: expected x (B, I, L, M) and w (I, O, L), "
            f"got {tuple(x.shape)} and {tuple(w.shape)}")
    half = policy.spectral_dtype if policy.spectral_is_half else torch.float32
    out_re, out_im = LSharedContract.apply(*_pair(x, half), *_pair(w, half))
    return torch.complex(out_re.float(), out_im.float())
