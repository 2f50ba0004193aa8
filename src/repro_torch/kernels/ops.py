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
``spectral_conv_fused`` runs a dense Fourier layer's whole rFFT ->
contract -> irFFT pipeline through ``FusedSpectral``, on the weight that
``gather_corner_weights`` lays out; ``resolve_fuse_spectral`` and
``fused_spectral_viable`` decide, from the device, shapes and policy
alone, when ``core.spectral`` takes it.  ``flash_attention`` and
``rmsnorm`` are the LM pool's substrate kernels behind the reference's
entry points; no model calls them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.precision import FULL, PrecisionPolicy

from . import flash_attention as _flash
from . import rmsnorm as _rmsnorm
from .spectral_contract import (
    L2_BUDGET,
    SMEM_LIMIT,
    CPContract,
    DenseContract,
    FusedSpectral,
    LSharedContract,
    fused_rows,
    fused_scratch_bytes,
    fused_smem_bytes,
    fused_supported,
)


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


# -- the fused spectral layer ------------------------------------------------------

def resolve_fuse_spectral(flag: Optional[bool], device) -> bool:
    """Resolve the tri-state ``fuse_spectral`` setting.  An explicit
    True/False wins; ``None`` is on for a CUDA tensor and off for a CPU
    tensor, as the reference's auto is on where its kernels compile (the
    TPU) and off on the CPU.  The reference's ``REPRO_FUSE_SPECTRAL``
    switch has no counterpart: ``FNOConfig.fuse_spectral`` carries the
    choice."""
    if flag is not None:
        return bool(flag)
    return torch.device(device).type == "cuda"


def fused_spectral_viable(fft_in, ctr, I: int, O: int, spatial: Sequence[int],
                          modes: Sequence[int]) -> bool:
    """Can this dense layer run the fused kernels?  The reference's vetoes
    (``repro.kernels.ops.fused_spectral_viable``) with the H100's budgets:
    the shape must suit the truncated-DFT factor layout on at most 3 axes,
    the floor tile's truncated spectra (``fused_scratch_bytes(1, ...)``)
    must fit in the L2 and a slab's partial transform in a block's shared
    memory, and ``fft_in`` and ``contract`` must quantise to one format
    (and one compute dtype when they quantise).  Decided from shapes and
    policy alone, before any launch; the batch does not enter (the kernels
    tile it)."""
    spatial, modes = tuple(spatial), tuple(modes)
    if not fused_supported(spatial, modes) or len(modes) > 3:
        return False
    if fused_scratch_bytes(1, I, O, spatial, modes) > L2_BUDGET:
        return False
    if fused_smem_bytes(spatial, modes) > SMEM_LIMIT:
        return False
    if fft_in.quantize_fmt != ctr.quantize_fmt:
        return False
    if fft_in.quantize_fmt is not None and fft_in.compute != ctr.compute:
        return False
    return True


def _fused_qspec(ctr):
    """``(cast_to, sim_fmt)`` of a contract-site rule: ``half`` rounds the
    spectrum and the weight onto the compute dtype; a simulated fp8 format
    rounds the spectrum onto the fp8 grid, then both onto the compute
    dtype, as the staged ``fft_in.quantize`` then half contraction do."""
    fmt = ctr.quantize_fmt
    if fmt is None:
        return None, None
    return ctr.compute, None if fmt == "half" else fmt


def gather_corner_weights(w_re: torch.Tensor, w_im: torch.Tensor, modes: Sequence[int]):
    """Fold per-corner dense weights into the fused kernels' layout.

    ``w_re``/``w_im``: (corners, I, O, *modes).  The fused forward DFT
    keeps, per truncated axis, the low block ``[0, m)`` then the high block
    ``[S-m, S)``, so corner ``c``'s weight lands at axis-``k`` rows
    ``[m, 2m)`` when bit ``k`` of ``c`` is set and at ``[0, m)`` otherwise
    (the last axis: always ``[0, m)``).  Returns ``(wgr, wgi)`` of shape
    (I, O, Mh), flattened row-major.  A permutation of the corners, so
    gradients scatter back to them exactly."""
    nd = len(modes)
    nc, I, O = w_re.shape[:3]
    if nc != 2 ** (nd - 1) or tuple(w_re.shape[3:]) != tuple(modes):
        raise ValueError(f"gather_corner_weights: weight {tuple(w_re.shape)}, expected "
                         f"({2 ** (nd - 1)} corners, I, O, *{tuple(modes)})")
    Mh = math.prod(fused_rows(None, modes))
    # the corner index, bit k for axis k, as (bit_{nd-2}, ..., bit_0) row-major
    # axes; each bit goes in front of its axis' modes
    perm = [nd - 1, nd]
    for k in range(nd - 1):
        perm += [nd - 2 - k, nd + 1 + k]
    perm.append(2 * nd)

    def gather(w):
        w = w.reshape(*([2] * (nd - 1)), I, O, *modes).permute(*perm)
        return w.reshape(I, O, Mh)

    return gather(w_re), gather(w_im)


def spectral_conv_fused(x: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor,
                        modes: Sequence[int], *, policy=FULL,
                        site: str = "model/spectral") -> torch.Tensor:
    """The dense Fourier convolution as one fused launch per batch tile.

    Semantically ``spectral_conv_apply`` for a dense layer: the stabiliser
    (outside the kernels, on the input the caller owns), the ``fft_in``
    quantisation of the truncated spectrum, the per-corner contraction as
    row blocks of the gathered weight, the inverse transform.  The kernels'
    output is f32 with no store rounding; it is cast at ``fft_out`` when
    that site is half, then to ``x``'s dtype.  ``x``: real (B, I,
    *spatial); ``w_re``/``w_im``: (corners, I, O, *modes); ``policy``: a
    PrecisionPolicy, resolved here at ``{site}/fft_in|contract|fft_out``.
    """
    if not isinstance(policy, PrecisionPolicy):
        raise ValueError("spectral_conv_fused resolves fft_in/contract/fft_out sites "
                         "itself: pass the PrecisionPolicy, not a SitePrecision")
    fft_in = policy.at(f"{site}/fft_in")
    ctr = policy.at(f"{site}/contract")
    fft_out = policy.at(f"{site}/fft_out")
    modes = tuple(int(m) for m in modes)
    in_dtype = x.dtype
    x = fft_in.stabilize(x)
    wgr, wgi = gather_corner_weights(w_re, w_im, modes)
    cast_to, sim_fmt = _fused_qspec(ctr)
    y = FusedSpectral.apply(x.float().contiguous(), wgr.contiguous(), wgi.contiguous(),
                            modes, cast_to, sim_fmt)
    if fft_out.spectral_is_half:
        y = y.to(fft_out.compute_dtype)
    return y.to(in_dtype)


# -- the LM pool's substrate kernels ------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """(B, H, S, D) attention; folds (B, H) into the kernel's batch axis.
    k and v are (B, H, Sk, D)."""
    B, H, S, D = q.shape
    Sk = k.shape[2]
    out = _flash.flash_attention(
        q.reshape(B * H, S, D), k.reshape(B * H, Sk, D), v.reshape(B * H, Sk, D),
        causal=causal, block_q=block_q, block_k=block_k)
    return out.reshape(B, H, S, D)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 256) -> torch.Tensor:
    """Rank-agnostic RMSNorm over the last axis."""
    shape = x.shape
    out = _rmsnorm.rmsnorm(x.reshape(-1, shape[-1]), w, eps=eps, block_rows=block_rows)
    return out.reshape(shape)
