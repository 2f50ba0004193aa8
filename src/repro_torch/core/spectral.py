"""Mixed-precision Fourier convolution (paper Section 4.2, Fig. 2), dense
weights, staged path.

The layer computes ``(K v)(x) = iFFT( R · T_K( FFT v ) )(x)``: stabilise
→ f32 ``rfftn`` → boundary quantisation → per-corner contraction through
the dense kernel → complex64 scatter → ``irfftn`` → ``fft_out`` storage
cast → input dtype.  Each stage resolves its precision through the rule
table at ``{site}/fft_in``, ``{site}/contract`` and ``{site}/fft_out``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.precision import FULL, PrecisionPolicy


def _n_corners(ndim: int) -> int:
    # rfftn halves the last axis only; every other truncated axis keeps the
    # low and high mode blocks => 2^(ndim-1) corner blocks.
    return 2 ** (ndim - 1)


def init_spectral_weights(
    in_channels: int,
    out_channels: int,
    modes: Sequence[int],
    factorization: str = "dense",
    *,
    generator: Optional[torch.Generator] = None,
) -> dict:
    """Spectral weights R for one layer: complex (corners, in, out, *modes)
    stored split-real f32 as ``{"w_re", "w_im"}``, scaled normals as in the
    reference, drawn on the CPU from ``generator``.  Only the dense
    factorisation is ported."""
    if factorization != "dense":
        raise NotImplementedError(
            f"{factorization!r} spectral weights are not ported yet "
            f"(ROADMAP: TFNO/CP kernels)")
    shape = (_n_corners(len(modes)), in_channels, out_channels, *modes)
    scale = 1.0 / (in_channels * out_channels)
    return {name: scale * torch.randn(shape, generator=generator)
            for name in ("w_re", "w_im")}


def _corner_slices(modes: Sequence[int], spectrum_shape: Sequence[int]):
    """Slices selecting each retained corner of the (r)fft spectrum.

    For every axis but the last we keep [:m] and [-m:]; the last (rfft) axis
    keeps [:m] only.  Corner index bits map to axes (bit k set => high
    block on axis k).
    """
    ndim = len(modes)
    out = []
    for c in range(_n_corners(ndim)):
        sl = []
        for ax in range(ndim - 1):
            m = modes[ax]
            if (c >> ax) & 1:
                sl.append(slice(spectrum_shape[ax] - m, spectrum_shape[ax]))
            else:
                sl.append(slice(0, m))
        sl.append(slice(0, modes[-1]))
        out.append(tuple(sl))
    return out


def spectral_conv_apply(
    params: dict,
    x: torch.Tensor,
    modes: Sequence[int],
    policy: PrecisionPolicy = FULL,
    site: str = "model/spectral",
    fuse_spectral: Optional[bool] = None,
) -> torch.Tensor:
    """Apply the Fourier convolution to ``x`` of shape (batch, ch, *spatial).

    ``params``: ``{"w_re", "w_im"}`` of shape (corners, I, O, *modes).
    ``fuse_spectral``: ``None``/``False`` take the staged path; the fused
    megakernel is not ported yet.
    """
    if fuse_spectral:
        raise NotImplementedError(
            "fuse_spectral=True: the fused rFFT-contract-irFFT kernel is not "
            "ported yet (ROADMAP: fused dispatch, kernels 9-10)")
    if "w_re" not in params:
        raise NotImplementedError(
            f"spectral params {sorted(params)}: only dense weights are ported "
            f"(ROADMAP: TFNO/CP kernels)")
    from repro_torch.kernels import ops as kops

    ndim = len(modes)
    spatial = tuple(x.shape[2:])
    if len(spatial) != ndim:
        raise ValueError(f"x {tuple(x.shape)} does not match modes {tuple(modes)}")
    in_dtype = x.dtype
    dims = tuple(range(2, 2 + ndim))
    fft_in = policy.at(f"{site}/fft_in")
    ctr = policy.at(f"{site}/contract")
    fft_out = policy.at(f"{site}/fft_out")

    # 1. stabiliser before the forward FFT (only active for half spectral)
    x = fft_in.stabilize(x)
    # 2. forward FFT in f32; boundary quantisation models the half (or
    #    simulated fp8) representation per Thm 3.2
    xf = fft_in.quantize(torch.fft.rfftn(x.float(), dim=dims))

    spectrum_shape = xf.shape[2:]
    w_re, w_im = params["w_re"], params["w_im"]
    out_f = torch.zeros((x.shape[0], w_re.shape[2], *spectrum_shape),
                        dtype=torch.complex64, device=x.device)
    for c, sl in enumerate(_corner_slices(modes, spectrum_shape)):
        idx = (slice(None), slice(None), *sl)
        out_f[idx] = kops.spectral_contract(xf[idx], w_re[c], w_im[c], policy=ctr)

    # 3. inverse FFT back to physical space.  The contraction leaves the
    #    spectrum non-Hermitian along the last axis' zero (and Nyquist)
    #    bins, where a C2R transform is defined only for real values and
    #    FFT libraries disagree: pocketfft (the CPU, and the reference)
    #    reads their real part, cuFFT does not.  Invert the other axes,
    #    keep those bins' real part, then run the C2R on the last axis, so
    #    every device computes what the reference does.
    y = torch.fft.ifftn(out_f, dim=dims[:-1]) if ndim > 1 else out_f
    n = spatial[-1]
    edge = [0, n // 2] if n % 2 == 0 else [0]
    y.imag[..., edge] = 0.0
    y = torch.fft.irfft(y, n=n, dim=-1)
    if fft_out.spectral_is_half:
        # the iFFT output also lives at half precision in the paper's pipeline
        y = y.to(fft_out.compute_dtype)
    return y.to(in_dtype)
