"""Mixed-precision Fourier convolution (paper Section 4.2, Fig. 2), for
dense, CP-factorised (TFNO, §4.6) and Tucker weights.

A dense layer whose ``fuse_spectral`` resolves on (by default: on a CUDA
tensor) and which ``kernels.ops.fused_spectral_viable`` admits runs the
whole pipeline as the fused kernels (``kernels.ops.spectral_conv_fused``);
every other layer takes the staged path.  The staged layer computes
``(K v)(x) = iFFT( R · T_K( FFT v ) )(x)``: stabilise → f32 ``rfftn`` →
boundary quantisation → per-corner contraction through the dense or the
CP kernel (Tucker: the memory-greedy einsum path of ``core.contraction``)
→ complex64 scatter → ``irfftn`` → ``fft_out`` storage cast → input
dtype.  Each stage resolves its precision through
the rule table at ``{site}/fft_in``, ``{site}/contract`` and
``{site}/fft_out``, and the autoprec taps read ``fft_in`` (through its
quantiser), ``contract`` (in the contraction wrappers) and ``fft_out``
(before its storage cast); a collector keeps a layer off the fused path.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.autoprec.telemetry import fmt_of, tap
from repro_torch.dist import channels
from repro_torch.precision import FULL, PrecisionPolicy, site_scope


def _n_corners(ndim: int) -> int:
    # rfftn halves the last axis only; every other truncated axis keeps the
    # low and high mode blocks => 2^(ndim-1) corner blocks.
    return 2 ** (ndim - 1)


def cp_rank(in_channels: int, out_channels: int, rank: float) -> int:
    """The CP rank a ``rank`` fraction resolves to."""
    return max(1, int(rank * min(in_channels, out_channels) * 2))


def _factor_names(ndim: int):
    return ["i", "o"] + [f"m{k}" for k in range(ndim)]


def spectral_weight_shapes(
    in_channels: int, out_channels: int, modes: Sequence[int],
    factorization: str = "dense", rank: float = 0.5,
) -> Dict[str, Tuple[int, ...]]:
    """The name and shape of every spectral weight of one layer, in the
    order :func:`init_spectral_weights` draws them (split-real pairs)."""
    nc = _n_corners(len(modes))
    if factorization == "dense":
        shape = (nc, in_channels, out_channels, *modes)
        return {"w_re": shape, "w_im": shape}
    dims = [in_channels, out_channels, *modes]
    if factorization == "cp":
        r = cp_rank(in_channels, out_channels, rank)
        out = {"lam_re": (nc, r), "lam_im": (nc, r)}
        for nm, d in zip(_factor_names(len(modes)), dims, strict=True):
            out[f"U_{nm}_re"] = out[f"U_{nm}_im"] = (nc, d, r)
        return out
    if factorization == "tucker":
        # ranks proportional to each dim
        ranks = [max(1, int(rank * d)) for d in dims]
        out = {"core_re": (nc, *ranks), "core_im": (nc, *ranks)}
        for nm, d, r in zip(_factor_names(len(modes)), dims, ranks, strict=True):
            out[f"U_{nm}_re"] = out[f"U_{nm}_im"] = (nc, d, r)
        return out
    raise ValueError(f"unknown factorization {factorization!r}")


def init_spectral_weights(
    in_channels: int,
    out_channels: int,
    modes: Sequence[int],
    factorization: str = "dense",
    rank: float = 0.5,
    *,
    generator: Optional[torch.Generator] = None,
) -> dict:
    """Spectral weights R for one layer, split-real f32, drawn on the CPU
    from ``generator`` with the reference's scales.

    dense:  ``w_re``/``w_im`` (corners, in, out, *modes), normals / (I·O).
    cp:     Canonical-Polyadic factors,
            ``weight[i,o,m1..md] = Σ_r λ_r A_i[i,r] A_o[o,r] Π_k A_mk[m_k,r]``:
            ``lam_*`` (corners, R) normals / (I·O), ``U_{i,o,m<k>}_*``
            (corners, dim, R) normals / √R.
    tucker: ``core_*`` (corners, r_i, r_o, r_m1..r_md) normals / (I·O)
            with ranks ``rank·dim``, and factors ``U_*`` (corners, dim,
            r) normals / √r.
    """
    shapes = spectral_weight_shapes(in_channels, out_channels, modes,
                                     factorization, rank)

    def scale(name, shape):
        if name.startswith("U_"):
            return 1.0 / math.sqrt(shape[-1])
        return 1.0 / (in_channels * out_channels)

    return {name: scale(name, shape) * torch.randn(shape, generator=generator)
            for name, shape in shapes.items()}


def _kind(params: dict) -> str:
    """The factorisation, read from the parameter keys."""
    if "w_re" in params:
        return "dense"
    if "lam_re" in params:
        return "cp"
    if "core_re" in params:
        return "tucker"
    raise ValueError(f"unrecognised spectral params: {sorted(params)}")


def _out_channels(params: dict) -> int:
    if _kind(params) == "dense":
        return params["w_re"].shape[2]
    return params["U_o_re"].shape[1]


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


_EINSUM_SPATIAL = "xyzuvw"


def _tucker_expr(ndim: int) -> str:
    sp = _EINSUM_SPATIAL[:ndim]
    caps = "RSABCD"  # rank index letters: R=in-rank, S=out-rank, then modes
    core = "RS" + caps[2: 2 + ndim]
    mode_terms = ",".join(f"{ch}{caps[2 + k]}" for k, ch in enumerate(sp))
    return f"bi{sp},{core},iR,oS,{mode_terms}->bo{sp}"


def check_grid(spatial: Sequence[int], modes: Sequence[int]) -> None:
    """Raise ``ValueError`` unless a grid of shape ``spatial`` holds the
    layer's corners without overlap: ``2·m`` points on every axis but the
    last, and ``m`` rfft bins (``n//2 + 1 >= m``) on the last."""
    small = [n < 2 * m for n, m in zip(spatial[:-1], modes[:-1], strict=True)]
    if any(small) or spatial[-1] // 2 + 1 < modes[-1]:
        least = tuple(2 * m for m in modes[:-1]) + (2 * modes[-1] - 2,)
        raise ValueError(
            f"a {tuple(spatial)} grid cannot retain modes {tuple(modes)}: "
            f"the corners need a grid of at least {least}")


def _complex(params: dict, name: str, corner: int) -> torch.Tensor:
    return torch.complex(params[f"{name}_re"][corner], params[f"{name}_im"][corner])


def spectral_conv_apply(
    params: dict,
    x: torch.Tensor,
    modes: Sequence[int],
    policy: PrecisionPolicy = FULL,
    site: str = "model/spectral",
    fuse_spectral: Optional[bool] = None,
) -> torch.Tensor:
    """Apply the Fourier convolution to ``x`` of shape (batch, ch, *spatial).

    ``params``: dense ``{"w_re", "w_im"}`` (corners, I, O, *modes), or the
    CP or Tucker factors of :func:`init_spectral_weights`.  Inside a
    ``dist.channels`` scope ``x`` holds this rank's block of the input
    channels and ``params`` this rank's block of the output channels (the
    dense weight's O, the CP and Tucker ``U_o`` rows): the transform runs
    on the rank's own channels, the truncated spectrum is gathered over tp
    for the contraction, and the result is the output block.  ``fuse_spectral``:
    tri-state (``kernels.ops.resolve_fuse_spectral``: ``None`` is on for a
    CUDA tensor, off for a CPU tensor).  Where it resolves on, the layer is
    dense and ``fused_spectral_viable`` admits its shapes and policy, the
    whole pipeline runs as the fused kernels; a fused launch that fails
    raises and is never retried on the staged path.
    """
    kind = _kind(params)
    from repro_torch.core.contraction import ComplexPair
    from repro_torch.kernels import ops as kops

    ndim = len(modes)
    spatial = tuple(x.shape[2:])
    if len(spatial) != ndim:
        raise ValueError(f"x {tuple(x.shape)} does not match modes {tuple(modes)}")
    check_grid(spatial, modes)
    in_dtype = x.dtype
    dims = tuple(range(2, 2 + ndim))
    fft_in = policy.at(f"{site}/fft_in")
    ctr = policy.at(f"{site}/contract")
    fft_out = policy.at(f"{site}/fft_out")

    if kind == "dense" and kops.resolve_fuse_spectral(fuse_spectral, x.device) and \
            kops.fused_spectral_viable(fft_in, ctr, x.shape[1], _out_channels(params),
                                       spatial, modes):
        return kops.spectral_conv_fused(x, params["w_re"], params["w_im"], modes,
                                        policy=policy, site=site)

    # 1. stabiliser before the forward FFT (only active for half spectral)
    x = fft_in.stabilize(x)
    # 2. forward FFT in f32; boundary quantisation models the half (or
    #    simulated fp8) representation per Thm 3.2
    xf = fft_in.quantize(torch.fft.rfftn(x.float(), dim=dims))

    spectrum_shape = xf.shape[2:]
    out_f = torch.zeros((x.shape[0], _out_channels(params), *spectrum_shape),
                        dtype=torch.complex64, device=x.device)
    for c, sl in enumerate(_corner_slices(modes, spectrum_shape)):
        idx = (slice(None), slice(None), *sl)
        # with the channels split over tp, x is this rank's input block and
        # the weight its output block: every input channel's corner is
        # gathered, so each output is the one-device sum over all of them
        xc = channels.gather(xf[idx])
        if kind == "dense":
            out_f[idx] = kops.spectral_contract(
                xc, params["w_re"][c], params["w_im"][c], policy=ctr)
        elif kind == "cp":
            factors = [_complex(params, f"U_m{k}", c) for k in range(ndim)]
            out_f[idx] = kops.spectral_contract_cp(
                xc, _complex(params, "lam", c), _complex(params, "U_i", c),
                _complex(params, "U_o", c), factors, policy=ctr)
        else:
            # Tucker has no kernel layout: the memory-greedy einsum path,
            # as in the reference
            ops = [_complex(params, "core", c)] + [
                _complex(params, f"U_{nm}", c) for nm in _factor_names(ndim)]
            yc = ctr.contract(_tucker_expr(ndim), xc, *ops)
            if isinstance(yc, ComplexPair):
                yc = yc.to_complex()
            out_f[idx] = yc.to(torch.complex64)

    # 3. inverse FFT back to physical space.  The contraction leaves the
    #    spectrum non-Hermitian along the last axis' zero (and Nyquist)
    #    bins, where a C2R transform is defined only for real values and
    #    FFT libraries disagree: pocketfft (the CPU, and the reference)
    #    reads their real part, cuFFT does not.  Invert the other axes,
    #    keep those bins' real part, then run the C2R on the last axis, so
    #    every device computes what the reference does.
    #    The block runs in the ``fft_out`` site's scope.
    with site_scope(f"{site}/fft_out"):
        y = torch.fft.ifftn(out_f, dim=dims[:-1]) if ndim > 1 else out_f
        n = spatial[-1]
        edge = [0, n // 2] if n % 2 == 0 else [0]
        y.imag[..., edge] = 0.0
        y = torch.fft.irfft(y, n=n, dim=-1)
        tap(f"{site}/fft_out", y, fmt=fmt_of(fft_out))
        if fft_out.spectral_is_half:
            # the iFFT output also lives at half precision in the paper's pipeline
            y = y.to(fft_out.compute_dtype)
        return y.to(in_dtype)
