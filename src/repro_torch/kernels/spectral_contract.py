"""Spectral contractions: the CUDA kernels, their plain PyTorch versions,
and the autograd Functions that check and launch them.

Dense (FNO):

    out[b,o,m] = Σ_i x[b,i,m] · w[i,o,m]          (complex, per mode m)
    dx[b,i,m]  = Σ_o g[b,o,m] · conj(w[i,o,m])    (backward, dense_bwd_x)
    dw[i,o,m]  = Σ_b conj(x[b,i,m]) · g[b,o,m]    (backward, dense_bwd_w)

in split-real f32 operands ``xr/xi`` (B, I, M) and ``wr/wi`` (I, O, M),
with an optional rounding of every operand onto the bf16/fp16 grid
(``cast_to``, the reference's fused storage cast), f32 sums, and the
forward's result stored at ``out_dtype``.  The gradients are f32 sums of
the rounded operands stored at f32, as the reference's custom VJP
(``_dense_op_bwd``) computes them: never rounded to the half grid.

CP-factorised (TFNO, paper §4.6), with the mode factor
``W[r,m] = λ_r Π_k U_mk[m_k,r]`` folded outside the kernels:

    t[b,m,r]   = Σ_i x[b,i,m] · U_i[i,r]          (rank-project)
    u[b,m,r]   = t[b,m,r] · W[r,m]                (mode-scale)
    out[b,o,m] = Σ_r u[b,m,r] · U_o[o,r]          (rank-expand, cp_fwd)

and ``cp_bwd``, which recomputes t and u and returns dx, dU_i, dU_o and
dW.  The operands arrive already rounded to one dtype (f32, bf16 or
fp16); t, u and every sum are f32; the output and all four gradients are
stored at the operands' dtype, as ``_cp_op_bwd`` stores them.

Order-shared (SFNO), the weight shared over the order m:

    out[b,o,l,m] = Σ_i x[b,i,l,m] · w[i,o,l]            (ls_fwd)
    dx[b,i,l,m]  = Σ_o g[b,o,l,m] · conj(w[i,o,l])      (ls_bwd_x)
    dw[i,o,l]    = Σ_{b,m} conj(x[b,i,l,m]) · g[b,o,l,m] (ls_bwd_w)

with every operand at one dtype (f32, bf16 or fp16), f32 sums, and every
result stored at that dtype, as ``_lshared_op_bwd`` stores them.

Fused (the dense FNO layer's whole rFFT -> contract -> irFFT pipeline):

    x̂ = q(F x)    ŷ[b,o,k] = Σ_i x̂[b,i,k] · c(w[i,o,k])    y = G ŷ   (fused_fwd)

with F the truncated forward DFT (per axis, the retained rows of
``fused_factors``), q the ``fft_in`` quantisation (the simulated fp8 grid,
then the bf16/fp16 round trip), c the storage rounding of the gathered
weight and G the inverse DFT with the hermitian real-output fold on the
last axis; the output is f32 with no store rounding.  ``fused_bwd``
recomputes x̂, rounds ĝ = Gᴴ g onto the storage grid, and returns
dx = Re Fᴴ(ĝ · conj(w)) and dw = Σ_b conj(x̂) · ĝ at f32.

The kernels replace the TPU kernels ``_dense_fwd_kernel``,
``_dense_bwd_x_kernel``, ``_dense_bwd_w_kernel``, ``_cp_fwd_kernel``,
``_cp_bwd_kernel``, ``_lshared_fwd_kernel``, ``_lshared_bwd_x_kernel``,
``_lshared_bwd_w_kernel``, ``_fused_fwd_kernel`` and ``_fused_bwd_kernel``
of ``repro.kernels.spectral_contract``; their sources
(``csrc/spectral_contract.cu``, ``csrc/spectral_contract_bwd.cu``,
``csrc/spectral_contract_cp.cu``, ``csrc/spectral_contract_lshared.cu``,
``csrc/spectral_fused.cu``, and ``csrc/dense_stream.cuh``, the streaming
design ``dense_fwd`` and ``dense_bwd_x`` share) state their bounds and
designs.

Dispatch follows the tensors' device: CPU tensors take the plain
versions, CUDA tensors launch the kernels or raise.  Each source is
compiled with ``nvcc`` for ``sm_90a`` at first use by ``kernels.build``,
into ``build/repro_torch_kernels/`` at the repository root, and loaded
with ``ctypes``.  ``launches``, ``launches_bwd_x``, ``launches_bwd_w``,
``launches_cp_fwd``, ``launches_cp_bwd``, ``launches_ls_fwd``,
``launches_ls_bwd_x``, ``launches_ls_bwd_w``, ``launches_fused_fwd`` and
``launches_fused_bwd`` count the kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .build import BUILD_DIR, CSRC, NVCC_FLAGS, _bind, _call, build, digest  # noqa: F401

#: kernel launches since the counts were last set to 0
launches = 0
launches_bwd_x = 0
launches_bwd_w = 0
launches_cp_fwd = 0
launches_cp_bwd = 0
launches_ls_fwd = 0
launches_ls_bwd_x = 0
launches_ls_bwd_w = 0
launches_fused_fwd = 0
launches_fused_bwd = 0

SOURCE = CSRC / "spectral_contract.cu"
SOURCE_BWD = CSRC / "spectral_contract_bwd.cu"
SOURCE_CP = CSRC / "spectral_contract_cp.cu"
SOURCE_LS = CSRC / "spectral_contract_lshared.cu"
SOURCE_FUSED = CSRC / "spectral_fused.cu"
SOURCES = (SOURCE, SOURCE_BWD, SOURCE_CP, SOURCE_LS, SOURCE_FUSED)
#: the version of the kernels ``repro_torch.tune`` tunes (the fused and the
#: order-shared ones): the leading 48 bits of ``build.digest`` over their
#: sources, the shared headers and the flags, as an int (the calibration
#: file's field is an int, as the reference's is).  An edit to either source,
#: a header or the flags changes it and stales their calibration entries.
KERNEL_VERSION = int(digest(SOURCE_FUSED, SOURCE_LS)[:12], 16)

#: format codes of the C interface
_FMT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulator dtype: f32, f64 in a gradcheck."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _round(ts, cast_to, dtype):
    """Round each tensor onto the ``cast_to`` grid and back to ``dtype``."""
    if cast_to is None:
        return tuple(t.to(dtype) for t in ts)
    return tuple(t.to(cast_to).to(dtype) for t in ts)


def spectral_contract_plain(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
    *, cast_to: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch: round the operands
    to ``cast_to`` and back, four real contractions at the operands'
    dtype (f32; f64 in a gradcheck), cast to ``out_dtype``."""
    xr, xi, wr, wi = _round((xr, xi, wr, wi), cast_to, xr.dtype)

    def bmm(a, b):
        return torch.einsum("bim,iom->bom", a, b)

    rr, ii = bmm(xr, wr), bmm(xi, wi)
    ri, ir = bmm(xr, wi), bmm(xi, wr)
    return (rr - ii).to(out_dtype), (ri + ir).to(out_dtype)


def spectral_contract_bwd_x_plain(
    gr: torch.Tensor, gi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
    *, cast_to: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dx = Σ_o g·conj(w)`` in plain PyTorch: ``g`` (B, O, M) at any
    float dtype and ``w`` (I, O, M) rounded onto ``cast_to``, sums and the
    result at ``w``'s dtype (f32; f64 in a gradcheck).  Returns
    ``(dxr, dxi)`` of shape (B, I, M)."""
    gr, gi, wr, wi = _round((gr, gi, wr, wi), cast_to, wr.dtype)

    def bmm(a, b):
        return torch.einsum("bom,iom->bim", a, b)

    return bmm(gr, wr) + bmm(gi, wi), bmm(gi, wr) - bmm(gr, wi)


def spectral_contract_bwd_w_plain(
    xr: torch.Tensor, xi: torch.Tensor, gr: torch.Tensor, gi: torch.Tensor,
    *, cast_to: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dw = Σ_b conj(x)·g`` in plain PyTorch: ``x`` (B, I, M) and ``g``
    (B, O, M) rounded onto ``cast_to``, sums and the result at ``x``'s
    dtype.  Returns ``(dwr, dwi)`` of shape (I, O, M)."""
    xr, xi, gr, gi = _round((xr, xi, gr, gi), cast_to, xr.dtype)

    def bmm(a, b):
        return torch.einsum("bim,bom->iom", a, b)

    return bmm(xr, gr) + bmm(xi, gi), bmm(xr, gi) - bmm(xi, gr)


def _check(xr, xi, wr, wi, cast_to, out_dtype) -> torch.device:
    """The checks every entry makes; returns the operands' device."""
    ops = (xr, xi, wr, wi)
    devices = {t.device for t in ops}
    dtypes = {t.dtype for t in ops}
    on_cpu = devices == {torch.device("cpu")}
    allowed = (torch.float32, torch.float64) if on_cpu else (torch.float32,)
    if len(dtypes) != 1 or xr.dtype not in allowed:
        raise TypeError(
            f"spectral_contract_dense takes float32 operands of one dtype "
            f"(float64 too on the CPU), got {[t.dtype for t in ops]}")
    if xr.ndim != 3 or wr.ndim != 3 or xi.shape != xr.shape or wi.shape != wr.shape:
        raise ValueError(
            f"spectral_contract_dense: expected x (B, I, M) and w (I, O, M), got "
            f"{tuple(xr.shape)}/{tuple(xi.shape)} and {tuple(wr.shape)}/{tuple(wi.shape)}")
    if wr.shape[0] != xr.shape[1] or wr.shape[2] != xr.shape[2]:
        raise ValueError(
            f"spectral_contract_dense: x {tuple(xr.shape)} and w {tuple(wr.shape)} "
            f"disagree on channels or modes")
    if cast_to is not None and cast_to not in _FMT:
        raise TypeError(f"cast_to must be one of {list(_FMT)}, got {cast_to}")
    out_allowed = list(_FMT) + ([torch.float64] if on_cpu else [])
    if out_dtype not in out_allowed:
        raise TypeError(f"out_dtype must be one of {out_allowed}, got {out_dtype}")
    if len(devices) != 1:
        raise ValueError(f"spectral_contract_dense: operands on {devices}")
    device = xr.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"spectral_contract_dense: no kernel for {device}")
    if device.type == "cuda" and not all(t.is_contiguous() for t in ops):
        raise ValueError("spectral_contract_dense: operands must be contiguous")
    return device


class DenseContract(torch.autograd.Function):
    """Split-real ``bim,iom->bom`` with the reference's custom VJP.

    Forward: the plain version on the CPU, the forward kernel on CUDA; it
    saves the unrounded operands.  Backward: ``dx = Σ_o g·conj(w)`` and
    ``dw = Σ_b conj(x)·g`` with every operand rounded onto ``cast_to``,
    f32 sums, stored at the operands' dtype: the plain versions on the
    CPU, the two backward kernels on CUDA, each only where its gradient is
    needed."""

    @staticmethod
    def forward(ctx, xr, xi, wr, wi, cast_to=None, out_dtype=torch.float32):
        device = _check(xr, xi, wr, wi, cast_to, out_dtype)
        ctx.cast_to = cast_to
        ctx.save_for_backward(xr, xi, wr, wi)
        if device.type == "cpu":
            return spectral_contract_plain(xr, xi, wr, wi, cast_to=cast_to,
                                           out_dtype=out_dtype)
        return _launch_fwd(xr, xi, wr, wi, cast_to, out_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        xr, xi, wr, wi = ctx.saved_tensors
        cast_to = ctx.cast_to
        # an output nobody used comes back as None: its cotangent is zero
        like = gr if gr is not None else gi
        gr = torch.zeros_like(like) if gr is None else gr
        gi = torch.zeros_like(like) if gi is None else gi
        need_x = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        need_w = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        dxr = dxi = dwr = dwi = None
        if xr.device.type == "cpu":
            if need_x:
                dxr, dxi = spectral_contract_bwd_x_plain(gr, gi, wr, wi, cast_to=cast_to)
            if need_w:
                dwr, dwi = spectral_contract_bwd_w_plain(xr, xi, gr, gi, cast_to=cast_to)
        else:
            gr, gi = gr.contiguous(), gi.contiguous()
            if gr.dtype not in _FMT or gi.dtype != gr.dtype:
                raise TypeError(f"spectral_contract_dense backward: cotangents "
                                f"of {gr.dtype}/{gi.dtype}")
            if need_x:
                dxr, dxi = _launch_bwd_x(gr, gi, wr, wi, cast_to)
            if need_w:
                dwr, dwi = _launch_bwd_w(xr, xi, gr, gi, cast_to)
        return dxr, dxi, dwr, dwi, None, None


def spectral_contract_dense(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
    *, cast_to: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-real ``bim,iom->bom``, differentiable.  Returns
    ``(out_re, out_im)`` of shape (B, O, M) at ``out_dtype``.  CPU tensors
    take the plain versions, CUDA tensors the kernels; anything the
    kernels do not take raises."""
    return DenseContract.apply(xr, xi, wr, wi, cast_to, out_dtype)


def contract_magnitude(xr, xi, wr, wi) -> torch.Tensor:
    """``M[b,o,m] = Σ_i |x[b,i,m]|·|w[i,o,m]|`` in f32: the per-output
    magnitude that the tolerance of a comparison between two evaluations
    of the contraction scales with (``core.theory.contract_budget``).
    The backward's magnitudes are the same contraction over O or B:
    ``Σ_o |g||w|`` and ``Σ_b |x||g|``."""
    return torch.einsum("bim,iom->bom", torch.hypot(xr, xi), torch.hypot(wr, wi))


def _launch_fwd(xr, xi, wr, wi, cast_to, out_dtype):
    global launches
    B, I, M = xr.shape
    O = wr.shape[1]
    outr = torch.empty((B, O, M), dtype=out_dtype, device=xr.device)
    outi = torch.empty_like(outr)
    if outr.numel() == 0:
        return outr, outi
    _call(_library().spectral_contract_dense_fwd, "spectral_contract_dense_fwd",
          xr.device, xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
          outr.data_ptr(), outi.data_ptr(), B, I, O, M,
          _FMT[cast_to or torch.float32], _FMT[out_dtype])
    launches += 1
    return outr, outi


def _launch_bwd_x(gr, gi, wr, wi, cast_to):
    global launches_bwd_x
    B, O, M = gr.shape
    I = wr.shape[0]
    dxr = torch.empty((B, I, M), dtype=torch.float32, device=wr.device)
    dxi = torch.empty_like(dxr)
    if dxr.numel() == 0:
        return dxr, dxi
    _call(_library_bwd().spectral_contract_dense_bwd_x, "spectral_contract_dense_bwd_x",
          wr.device, gr.data_ptr(), gi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
          dxr.data_ptr(), dxi.data_ptr(), B, I, O, M,
          _FMT[cast_to or torch.float32], _FMT[gr.dtype])
    launches_bwd_x += 1
    return dxr, dxi


def _launch_bwd_w(xr, xi, gr, gi, cast_to):
    global launches_bwd_w
    B, I, M = xr.shape
    O = gr.shape[1]
    dwr = torch.empty((I, O, M), dtype=torch.float32, device=xr.device)
    dwi = torch.empty_like(dwr)
    if dwr.numel() == 0:
        return dwr, dwi
    _call(_library_bwd().spectral_contract_dense_bwd_w, "spectral_contract_dense_bwd_w",
          xr.device, xr.data_ptr(), xi.data_ptr(), gr.data_ptr(), gi.data_ptr(),
          dwr.data_ptr(), dwi.data_ptr(), B, I, O, M,
          _FMT[cast_to or torch.float32], _FMT[gr.dtype])
    launches_bwd_w += 1
    return dwr, dwi


# -- CP-factorised contraction (TFNO) --------------------------------------------

#: operand dtypes of the CP kernels (one dtype for every operand)
_CP_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: shared memory a block of the CP kernels may use (Hopper: 227 KB)
SMEM_LIMIT = 232448


def _cp_stages(xr, xi, uir, uii, uor, uoi, wr, wi):
    """The rank-project and mode-scale stages at the accumulator dtype
    (f32; f64 in a gradcheck): ``(tr, ti, ur, ui)`` of shape (B, M, R),
    and the factors at that dtype."""
    acc = _acc(xr.dtype)
    xr, xi, uir, uii, uor, uoi, wr, wi = (
        t.to(acc) for t in (xr, xi, uir, uii, uor, uoi, wr, wi))

    def project(a, b):
        return torch.einsum("bim,ir->bmr", a, b)

    tr = project(xr, uir) - project(xi, uii)
    ti = project(xr, uii) + project(xi, uir)
    wrT, wiT = wr.T[None], wi.T[None]
    ur = tr * wrT - ti * wiT
    ui = tr * wiT + ti * wrT
    return (tr, ti, ur, ui), (xr, xi, uir, uii, uor, uoi, wrT, wiT)


def spectral_contract_cp_plain(xr, xi, uir, uii, uor, uoi, wr, wi):
    """``cp_fwd``'s function in plain PyTorch: the three stages with f32
    sums of the operands as given (f64 in a gradcheck), the result stored
    at the operands' dtype.  Returns ``(out_re, out_im)`` (B, O, M)."""
    (_, _, ur, ui), (_, _, _, _, uor_, uoi_, _, _) = _cp_stages(
        xr, xi, uir, uii, uor, uoi, wr, wi)

    def expand(a, b):
        return torch.einsum("bmr,or->bom", a, b)

    our = expand(ur, uor_) - expand(ui, uoi_)
    oui = expand(ur, uoi_) + expand(ui, uor_)
    return our.to(xr.dtype), oui.to(xr.dtype)


def spectral_contract_cp_bwd_plain(xr, xi, uir, uii, uor, uoi, wr, wi, gr, gi):
    """``cp_bwd``'s function in plain PyTorch, the reference's
    ``_cp_bwd_kernel``: recompute t and u, then

        du = g·conj(U_o)    dU_o = Σ_{b,m} g·conj(u)    dt = du·conj(W)
        dW = Σ_b du·conj(t)    dx = dt·conj(U_i)    dU_i = Σ_{b,m} conj(x)·dt

    with f32 sums, every gradient stored at the operands' dtype.  Returns
    ``(dxr, dxi, duir, duii, duor, duoi, dwr, dwi)``."""
    dtype = xr.dtype
    (tr, ti, ur, ui), (xr, xi, uir, uii, uor, uoi, wrT, wiT) = _cp_stages(
        xr, xi, uir, uii, uor, uoi, wr, wi)
    gr, gi = gr.to(tr.dtype), gi.to(tr.dtype)

    def e(spec, a, b):
        return torch.einsum(spec, a, b)

    dur = e("bom,or->bmr", gr, uor) + e("bom,or->bmr", gi, uoi)
    dui = e("bom,or->bmr", gi, uor) - e("bom,or->bmr", gr, uoi)
    duor = e("bom,bmr->or", gr, ur) + e("bom,bmr->or", gi, ui)
    duoi = e("bom,bmr->or", gi, ur) - e("bom,bmr->or", gr, ui)
    dtr = dur * wrT + dui * wiT
    dti = dui * wrT - dur * wiT
    dwr = (dur * tr + dui * ti).sum(0).T
    dwi = (dui * tr - dur * ti).sum(0).T
    dxr = e("bmr,ir->bim", dtr, uir) + e("bmr,ir->bim", dti, uii)
    dxi = e("bmr,ir->bim", dti, uir) - e("bmr,ir->bim", dtr, uii)
    duir = e("bim,bmr->ir", xr, dtr) + e("bim,bmr->ir", xi, dti)
    duii = e("bim,bmr->ir", xr, dti) - e("bim,bmr->ir", xi, dtr)
    return tuple(t.to(dtype) for t in (dxr, dxi, duir, duii, duor, duoi, dwr, dwi))


def cp_magnitudes(xr, xi, uir, uii, uor, uoi, wr, wi, gr=None, gi=None):
    """The contraction of |operands| each output of the CP contraction
    sums, per element, in f32 (f64 for f64 operands): what the tolerance
    of a comparison between two evaluations scales with
    (``core.theory.contract_budget``).  ``"out"``: Σ_{i,r} |x||U_i||W||U_o|;
    given the cotangent g, also the gradients' ``"dx"``, ``"dU_i"``,
    ``"dU_o"`` and ``"dW"``."""
    acc = _acc(xr.dtype)

    def mag(re, im):
        return torch.hypot(re.to(acc), im.to(acc))

    ax, aui, auo, aw = mag(xr, xi), mag(uir, uii), mag(uor, uoi), mag(wr, wi).T[None]
    at = torch.einsum("bim,ir->bmr", ax, aui)
    au = at * aw
    out = {"out": torch.einsum("bmr,or->bom", au, auo)}
    if gr is not None:
        ag = mag(gr, gi)
        adu = torch.einsum("bom,or->bmr", ag, auo)
        adt = adu * aw
        out.update(dx=torch.einsum("bmr,ir->bim", adt, aui),
                   dU_i=torch.einsum("bim,bmr->ir", ax, adt),
                   dU_o=torch.einsum("bom,bmr->or", ag, au),
                   dW=torch.einsum("bmr,bmr->rm", adu, at))
    return out


def _check_cp(xr, xi, uir, uii, uor, uoi, wr, wi) -> torch.device:
    """The checks every CP entry makes; returns the operands' device."""
    ops = (xr, xi, uir, uii, uor, uoi, wr, wi)
    devices = {t.device for t in ops}
    dtypes = {t.dtype for t in ops}
    on_cpu = devices == {torch.device("cpu")}
    allowed = _CP_DTYPES + ((torch.float64,) if on_cpu else ())
    if len(dtypes) != 1 or xr.dtype not in allowed:
        raise TypeError(
            f"spectral_contract_cp takes operands of one dtype of {list(allowed)}, "
            f"got {[t.dtype for t in ops]}")
    shapes = [tuple(t.shape) for t in ops]
    if xr.ndim != 3 or uir.ndim != 2 or uor.ndim != 2 or wr.ndim != 2 or \
            shapes[0::2] != shapes[1::2]:
        raise ValueError(
            f"spectral_contract_cp: expected x (B, I, M), U_i (I, R), U_o (O, R) "
            f"and W (R, M) as re/im pairs, got {shapes}")
    (_, I, M), (R,) = xr.shape, uir.shape[1:]
    if uir.shape[0] != I or uor.shape[1] != R or tuple(wr.shape) != (R, M):
        raise ValueError(
            f"spectral_contract_cp: x {tuple(xr.shape)}, U_i {tuple(uir.shape)}, "
            f"U_o {tuple(uor.shape)} and W {tuple(wr.shape)} disagree on I, R or M")
    if len(devices) != 1:
        raise ValueError(f"spectral_contract_cp: operands on {devices}")
    device = xr.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"spectral_contract_cp: no kernel for {device}")
    if device.type == "cuda" and not all(t.is_contiguous() for t in ops):
        raise ValueError("spectral_contract_cp: operands must be contiguous")
    return device


class CPContract(torch.autograd.Function):
    """The CP-factorised contraction with the reference's custom VJP.

    Inputs: ``xr, xi`` (B, I, M), ``uir, uii`` (I, R), ``uor, uoi``
    (O, R), ``wr, wi`` (R, M), all of one dtype (the site's storage dtype,
    rounded by the caller).  Forward: the plain version on the CPU,
    ``cp_fwd`` on CUDA.  Backward: all eight gradients at the operands'
    dtype, the plain version on the CPU, ``cp_bwd`` on CUDA."""

    @staticmethod
    def forward(ctx, xr, xi, uir, uii, uor, uoi, wr, wi):
        ops = (xr, xi, uir, uii, uor, uoi, wr, wi)
        device = _check_cp(*ops)
        ctx.save_for_backward(*ops)
        if device.type == "cpu":
            return spectral_contract_cp_plain(*ops)
        return _launch_cp_fwd(*ops)

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        ops = ctx.saved_tensors
        like = gr if gr is not None else gi
        gr = torch.zeros_like(like) if gr is None else gr
        gi = torch.zeros_like(like) if gi is None else gi
        if ops[0].device.type == "cpu":
            return spectral_contract_cp_bwd_plain(*ops, gr, gi)
        dtype = ops[0].dtype
        if gr.dtype != dtype or gi.dtype != dtype:
            raise TypeError(f"spectral_contract_cp backward: cotangents of "
                            f"{gr.dtype}/{gi.dtype}, operands of {dtype}")
        return _launch_cp_bwd(*ops, gr.contiguous(), gi.contiguous())


def _pad(n: int, k: int) -> int:
    return -(-n // k) * k


class CPFwdPlan(NamedTuple):
    """``cp_fwd``'s launch plan: the factors resident in shared memory
    (copied once a block) or streamed a chunk an item, and the bytes of
    shared memory a block takes."""
    resident: bool
    smem: int


#: ``cp_fwd``'s tile (``FwdTile`` in ``csrc/spectral_contract_cp.cu``): modes
#: a tile, input channels an item (halves, f32), ranks and output channels a
#: chunk, the widest I, R and O whose factors stay resident, ring slots
_CPF_MT, _CPF_IC, _CPF_RC, _CPF_OC, _CPF_RES, _CPF_STAGES = 64, (64, 32), 64, 64, 64, 2


def _cp_fwd_smem(size: int, resident: bool) -> int:
    """Bytes of shared memory a ``cp_fwd`` block takes at operand ``size``
    (``FwdTile::smem``)."""
    half = size == 2
    pad = 16 // size
    ic = _CPF_IC[0] if half else _CPF_IC[1]
    xp, up, otp = _CPF_MT + pad, _CPF_RC + pad, _CPF_OC + pad
    xw = 2 * (ic * xp + _CPF_RC * xp)
    uo = _CPF_OC * up if half else _CPF_RC * otp
    slot = xw + (0 if resident else 2 * (ic * up + uo))
    # halves with streamed factors: out's f32 partial sums over rank chunks
    part = 0 if resident or not half else 2 * _CPF_OC * (_CPF_MT + 4) * 4
    return (_CPF_STAGES * slot + (2 * (_CPF_RES * up + uo) if resident else 0)) * size + part


def cp_fwd_plan(I: int, O: int, R: int, dtype: torch.dtype) -> CPFwdPlan:
    """``cp_fwd``'s plan at operands of ``dtype``: the factors U_i and U_o
    stay resident in a block's shared memory where I, R and O are at most
    64 (the TFNO path's widths); wider factors come a chunk at a time with
    the items that use them.  The kernel walks ranks, input and output
    channels in chunks whose sums carry over, so every width fits: there is
    no limit to refuse."""
    resident = max(I, O, R) <= _CPF_RES
    size = torch.empty((), dtype=dtype).element_size()
    return CPFwdPlan(resident, _cp_fwd_smem(size, resident))


class CPBwdPlan(NamedTuple):
    """``cp_bwd``'s launch plan: the input and output channels its 64-wide
    chunks cover, whether dU_i and dU_o stay on chip across a block's items
    (every width within one chunk: the factors resident too) or go to its
    slice of the workspace, and the bytes of shared memory a block takes."""
    IC: int
    OC: int
    acc_smem: bool
    smem: int


#: ``cp_bwd``'s tile (``BwdTile`` in ``csrc/spectral_contract_cp.cu``): modes
#: a tile (halves, f32), channels and ranks a chunk, ring slots
_CPB_MT, _CPB_CH, _CPB_STAGES = (64, 32), 64, 2


def _cp_bwd_smem(size: int) -> int:
    """Bytes of shared memory a ``cp_bwd`` block takes at operand ``size``
    (``BwdTile::SMEM``): the ring's x and g tiles, the U_i and U_o chunks,
    and u and dt as three bf16 pieces each."""
    mt = _CPB_MT[0] if size == 2 else _CPB_MT[1]
    pad = 16 // size
    tile = _CPB_CH * (mt + pad)
    factors = 4 * _CPB_CH * (_CPB_CH + pad)
    return (_CPB_STAGES * 4 * tile + factors) * size + 12 * mt * (_CPB_CH + 8) * 2


def cp_bwd_plan(I: int, O: int, R: int, dtype: torch.dtype) -> CPBwdPlan:
    """``cp_bwd``'s plan at operands of ``dtype``.  The kernel walks input
    and output channels and ranks in 64-wide chunks whose sums carry over,
    so its shared memory does not grow with any width: there is no limit
    to refuse.  Where every width fits one chunk (the TFNO path's 64) the
    factors stay resident and dU_i/dU_o on chip across a block's items."""
    size = torch.empty((), dtype=dtype).element_size()
    return CPBwdPlan(min(max(I, 1), _CPB_CH), min(max(O, 1), _CPB_CH),
                     max(I, O, R) <= _CPB_CH, _cp_bwd_smem(size))


def _launch_cp_fwd(xr, xi, uir, uii, uor, uoi, wr, wi):
    global launches_cp_fwd
    B, I, M = xr.shape
    O, R = uor.shape
    outr = torch.empty((B, O, M), dtype=xr.dtype, device=xr.device)
    outi = torch.empty_like(outr)
    if outr.numel() == 0:
        return outr, outi
    plan = cp_fwd_plan(I, O, R, xr.dtype)
    ptrs = [t.data_ptr() for t in (xr, xi, uir, uii, uor, uoi, wr, wi, outr, outi)]
    _call(_library_cp().spectral_contract_cp_fwd, "spectral_contract_cp_fwd",
          xr.device, *ptrs, B, I, O, R, M, int(plan.resident), _FMT[xr.dtype])
    launches_cp_fwd += 1
    return outr, outi


def _launch_cp_bwd(xr, xi, uir, uii, uor, uoi, wr, wi, gr, gi):
    """``cp_bwd`` and its reduction of the per-tile factor gradients."""
    global launches_cp_bwd
    B, I, M = xr.shape
    O, R = uor.shape
    grads = [torch.empty_like(t) for t in (xr, xi, uir, uii, uor, uoi, wr, wi)]
    if xr.numel() == 0 or gr.numel() == 0:
        return tuple(g.zero_() for g in grads)
    plan = cp_bwd_plan(I, O, R, xr.dtype)
    lib = _library_cp()
    with torch.cuda.device(xr.device):
        floats = int(lib.spectral_contract_cp_bwd_workspace(B, I, O, R, M, _FMT[xr.dtype]))
    if floats < 0:
        raise RuntimeError("spectral_contract_cp_bwd: the device query for its grid failed")
    work = torch.empty(floats, dtype=torch.float32, device=xr.device)
    ptrs = [t.data_ptr() for t in (xr, xi, uir, uii, uor, uoi, wr, wi, gr, gi, *grads, work)]
    _call(lib.spectral_contract_cp_bwd, "spectral_contract_cp_bwd", xr.device,
          *ptrs, B, I, O, R, M, plan.IC, plan.OC, int(plan.acc_smem), _FMT[xr.dtype])
    launches_cp_bwd += 1
    return tuple(grads)


# -- order-shared contraction (SFNO) ---------------------------------------------

def spectral_contract_lshared_plain(xr, xi, wr, wi):
    """``ls_fwd``'s function in plain PyTorch: ``x`` (B, I, L, M) and ``w``
    (I, O, L) at one dtype, f32 sums (f64 in a gradcheck), the result
    stored at that dtype.  Returns ``(out_re, out_im)`` (B, O, L, M)."""
    dtype, acc = xr.dtype, _acc(xr.dtype)
    xr, xi, wr, wi = (t.to(acc) for t in (xr, xi, wr, wi))

    def bmm(a, b):
        return torch.einsum("bilm,iol->bolm", a, b)

    return (bmm(xr, wr) - bmm(xi, wi)).to(dtype), (bmm(xr, wi) + bmm(xi, wr)).to(dtype)


def spectral_contract_lshared_bwd_x_plain(gr, gi, wr, wi):
    """``ls_bwd_x``'s function: ``dx = Σ_o g·conj(w)`` from ``g`` (B, O, L,
    M) and ``w`` (I, O, L), f32 sums, stored at ``w``'s dtype.  Returns
    ``(dxr, dxi)`` (B, I, L, M)."""
    dtype, acc = wr.dtype, _acc(wr.dtype)
    gr, gi, wr, wi = (t.to(acc) for t in (gr, gi, wr, wi))

    def bmm(a, b):
        return torch.einsum("bolm,iol->bilm", a, b)

    return (bmm(gr, wr) + bmm(gi, wi)).to(dtype), (bmm(gi, wr) - bmm(gr, wi)).to(dtype)


def spectral_contract_lshared_bwd_w_plain(xr, xi, gr, gi):
    """``ls_bwd_w``'s function: ``dw = Σ_{b,m} conj(x)·g`` from ``x`` (B, I,
    L, M) and ``g`` (B, O, L, M), f32 sums, stored at ``x``'s dtype.
    Returns ``(dwr, dwi)`` (I, O, L)."""
    dtype, acc = xr.dtype, _acc(xr.dtype)
    xr, xi, gr, gi = (t.to(acc) for t in (xr, xi, gr, gi))

    def bmm(a, b):
        return torch.einsum("bilm,bolm->iol", a, b)

    return (bmm(xr, gr) + bmm(xi, gi)).to(dtype), (bmm(xr, gi) - bmm(xi, gr)).to(dtype)


def lshared_magnitudes(xr, xi, wr, wi, gr=None, gi=None):
    """The contraction of |operands| each output of the order-shared
    contraction sums, in f32 (f64 for f64 operands): what the tolerance of
    a comparison between two evaluations scales with.  ``"out"``:
    Σ_i |x||w|; given the cotangent g, also ``"dx"``: Σ_o |g||w| and
    ``"dw"``: Σ_{b,m} |x||g|."""
    acc = _acc(xr.dtype)

    def mag(re, im):
        return torch.hypot(re.to(acc), im.to(acc))

    ax, aw = mag(xr, xi), mag(wr, wi)
    out = {"out": torch.einsum("bilm,iol->bolm", ax, aw)}
    if gr is not None:
        ag = mag(gr, gi)
        out.update(dx=torch.einsum("bolm,iol->bilm", ag, aw),
                   dw=torch.einsum("bilm,bolm->iol", ax, ag))
    return out


def _check_ls(xr, xi, wr, wi) -> torch.device:
    """The checks every order-shared entry makes; returns the device."""
    ops = (xr, xi, wr, wi)
    devices = {t.device for t in ops}
    dtypes = {t.dtype for t in ops}
    on_cpu = devices == {torch.device("cpu")}
    allowed = _CP_DTYPES + ((torch.float64,) if on_cpu else ())
    if len(dtypes) != 1 or xr.dtype not in allowed:
        raise TypeError(
            f"spectral_contract_lshared takes operands of one dtype of {list(allowed)}, "
            f"got {[t.dtype for t in ops]}")
    if xr.ndim != 4 or wr.ndim != 3 or xi.shape != xr.shape or wi.shape != wr.shape:
        raise ValueError(
            f"spectral_contract_lshared: expected x (B, I, L, M) and w (I, O, L) as "
            f"re/im pairs, got {tuple(xr.shape)}/{tuple(xi.shape)} and "
            f"{tuple(wr.shape)}/{tuple(wi.shape)}")
    if wr.shape[0] != xr.shape[1] or wr.shape[2] != xr.shape[2]:
        raise ValueError(
            f"spectral_contract_lshared: x {tuple(xr.shape)} and w {tuple(wr.shape)} "
            f"disagree on channels or degrees")
    if len(devices) != 1:
        raise ValueError(f"spectral_contract_lshared: operands on {devices}")
    device = xr.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"spectral_contract_lshared: no kernel for {device}")
    if device.type == "cuda" and not all(t.is_contiguous() for t in ops):
        raise ValueError("spectral_contract_lshared: operands must be contiguous")
    return device


class LSharedContract(torch.autograd.Function):
    """The order-shared contraction ``bilm,iol->bolm`` with the reference's
    custom VJP.

    Inputs: ``xr, xi`` (B, I, L, M) and ``wr, wi`` (I, O, L), all of one
    dtype (the site's storage dtype, rounded by the caller); the constants
    ``splits_fwd`` and ``splits_bwd`` pin ``ls_fwd``'s and ``ls_bwd_x``'s
    splits (None: ``ls_plan``'s).  Forward: the plain version on the CPU,
    ``ls_fwd`` on CUDA.  Backward: dx and dw at the operands' dtype, each
    only where it is needed: the plain versions on the CPU, ``ls_bwd_x``
    and ``ls_bwd_w`` on CUDA.  The splits partition outputs, so no result
    depends on them."""

    @staticmethod
    def forward(ctx, xr, xi, wr, wi, splits_fwd=None, splits_bwd=None):
        device = _check_ls(xr, xi, wr, wi)
        ctx.save_for_backward(xr, xi, wr, wi)
        ctx.splits_bwd = splits_bwd
        if device.type == "cpu":
            return spectral_contract_lshared_plain(xr, xi, wr, wi)
        return _launch_ls_fwd(xr, xi, wr, wi, splits_fwd)

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        xr, xi, wr, wi = ctx.saved_tensors
        like = gr if gr is not None else gi
        gr = torch.zeros_like(like) if gr is None else gr
        gi = torch.zeros_like(like) if gi is None else gi
        need_x = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        need_w = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        dxr = dxi = dwr = dwi = None
        if xr.device.type == "cpu":
            if need_x:
                dxr, dxi = spectral_contract_lshared_bwd_x_plain(gr, gi, wr, wi)
            if need_w:
                dwr, dwi = spectral_contract_lshared_bwd_w_plain(xr, xi, gr, gi)
            return dxr, dxi, dwr, dwi, None, None
        if gr.dtype != xr.dtype or gi.dtype != xr.dtype:
            raise TypeError(f"spectral_contract_lshared backward: cotangents of "
                            f"{gr.dtype}/{gi.dtype}, operands of {xr.dtype}")
        gr, gi = gr.contiguous(), gi.contiguous()
        if need_x:
            dxr, dxi = _launch_ls_bwd_x(gr, gi, wr, wi, ctx.splits_bwd)
        if need_w:
            dwr, dwi = _launch_ls_bwd_w(xr, xi, gr, gi)
        return dxr, dxi, dwr, dwi, None, None


class LsPlan(NamedTuple):
    """How ``ls_mix`` takes one launch: the weight's degree slice resident
    in shared memory (``resident``) or streamed a chunk a stage, the blocks
    a (degree, channel tile) shares its outputs among (``splits``), and the
    block's shared memory in bytes."""
    resident: bool
    splits: int
    smem: int


#: ``ls_mix``'s tiles per element size (``MixTile`` in
#: ``csrc/spectral_contract_lshared.cu``): input channels a stage (KC), the
#: stages of the ring, orders a stage (MC), output channels a block (NC)
_LS_KC = {2: 64, 4: 32}
_LS_STAGES, _LS_MC, _LS_NC = 2, 128, 64
#: streaming multiprocessors of an H100 SXM: the grid ``ls_plan`` fills
H100_SMS = 132


def _ls_smem(K: int, size: int, resident: bool) -> int:
    """``MixTile<T>::smem``: the ring of a tiles [KC][MC + 16 bytes] (re,
    im), with the stage's chunk of W where it is not resident; the resident
    W (halves [NC][K pad + 8], f32 [K pad][NC]); the output tile of the
    half modes [NC][MC + 8]."""
    half, KC = size == 2, _LS_KC[size]
    kpad = _pad(max(K, 1), KC)
    a_plane = KC * (_LS_MC + 16 // size)
    w_stage = _LS_NC * (KC + 8) if half else KC * _LS_NC
    stage = 2 * a_plane + (0 if resident else 2 * w_stage)
    w = 2 * (_LS_NC * (kpad + 8) if half else kpad * _LS_NC) if resident else 0
    out = 2 * _LS_NC * (_LS_MC + 8) if half else 0
    return (_LS_STAGES * stage + w + out) * size


def ls_plan(K: int, N: int, dtype: torch.dtype, *, B: int = 1, L: int = 1, M: int = 1,
            sms: int = H100_SMS) -> LsPlan:
    """``ls_mix``'s plan for ``ls_fwd`` (K = I, N = O) or ``ls_bwd_x`` (K = O,
    N = I) at ``dtype``: the weight's degree slice resident wherever it fits
    a block's 227 KB beside the ring (K <= 448 in half modes, <= 320 in f32
    mode), else streamed with the a tiles; and as many splits of each
    (degree, 64-channel tile)'s B * ceil(M / 128) outputs as keep the grid
    within one block per SM, at least one.  Every width fits.  The splits
    partition outputs, never a sum: the results do not depend on them."""
    size = dtype.itemsize
    if size not in _LS_KC:
        raise TypeError(f"ls_mix takes f32, bf16 or fp16, got {dtype}")
    resident = _ls_smem(K, size, True) <= SMEM_LIMIT
    smem = _ls_smem(K, size, resident)
    blocks = max(L, 1) * -(-max(N, 1) // _LS_NC)
    outputs = ls_splits_max(B, M)
    return LsPlan(resident, max(1, min(outputs, sms // blocks)), smem)


def ls_splits_max(B: int, M: int) -> int:
    """The outputs a (degree, channel tile) of ``ls_mix`` shares among its
    blocks, B * ceil(M / 128): more splits than that leave blocks idle."""
    return max(B, 1) * -(-max(M, 1) // _LS_MC)


def _launch_mix(name, a_r, a_i, wr, wi, B, I, O, L, M, K, N, splits=None):
    """One ``ls_mix`` launch: ``ls_fwd`` (K = I, N = O) or ``ls_bwd_x`` (K =
    O, N = I) at ``splits`` (None: ``ls_plan``'s); returns the (B, N, L, M)
    pair at the operands' dtype."""
    outr = torch.empty((B, N, L, M), dtype=wr.dtype, device=wr.device)
    outi = torch.empty_like(outr)
    if outr.numel() == 0:
        return outr, outi
    plan = ls_plan(K, N, wr.dtype, B=B, L=L, M=M,
                   sms=torch.cuda.get_device_properties(wr.device).multi_processor_count)
    if splits is None:
        splits = plan.splits
    elif not 1 <= int(splits) <= ls_splits_max(B, M):
        raise ValueError(f"{name}: {splits} splits, the launch takes 1 to "
                         f"{ls_splits_max(B, M)} at B = {B}, M = {M}")
    _call(getattr(_library_ls(), name), name, wr.device,
          *(t.data_ptr() for t in (a_r, a_i, wr, wi, outr, outi)),
          B, I, O, L, M, int(plan.resident), int(splits), _FMT[wr.dtype])
    return outr, outi


def _launch_ls_fwd(xr, xi, wr, wi, splits=None):
    global launches_ls_fwd
    B, I, L, M = xr.shape
    O = wr.shape[1]
    out = _launch_mix("spectral_contract_ls_fwd", xr, xi, wr, wi, B, I, O, L, M, I, O, splits)
    if out[0].numel():
        launches_ls_fwd += 1
    return out


def _launch_ls_bwd_x(gr, gi, wr, wi, splits=None):
    global launches_ls_bwd_x
    B, O, L, M = gr.shape
    I = wr.shape[0]
    dx = _launch_mix("spectral_contract_ls_bwd_x", gr, gi, wr, wi, B, I, O, L, M, O, I, splits)
    if dx[0].numel():
        launches_ls_bwd_x += 1
    return dx


def _launch_ls_bwd_w(xr, xi, gr, gi):
    global launches_ls_bwd_w
    B, I, L, M = xr.shape
    O = gr.shape[1]
    dwr = torch.empty((I, O, L), dtype=xr.dtype, device=xr.device)
    dwi = torch.empty_like(dwr)
    if dwr.numel() == 0:
        return dwr, dwi
    _call(_library_ls().spectral_contract_ls_bwd_w, "spectral_contract_ls_bwd_w",
          xr.device, *(t.data_ptr() for t in (xr, xi, gr, gi, dwr, dwi)),
          B, I, O, L, M, _FMT[xr.dtype])
    launches_ls_bwd_w += 1
    return dwr, dwi


# -- fused rFFT -> contract -> irFFT (dense FNO layer) ------------------------------

#: the H100's L2 cache, which holds the fused kernels' truncated spectra
#: between their stages: the counterpart of the TPU kernels' VMEM budget
L2_BUDGET = 50 * 2 ** 20
#: codes of the C interface for the simulated fp8 grids
_SIM = {None: 0, "fp8_e4m3": 1, "fp8_e5m2": 2}


def fused_rows(_spatial, modes) -> Tuple[int, ...]:
    """Retained spectrum rows per axis: 2m for truncated full-FFT axes
    (low and high corner blocks), m for the last (rfft) axis; the grid
    does not enter (the reference's signature)."""
    return tuple(2 * int(m) for m in modes[:-1]) + (int(modes[-1]),)


def fused_supported(spatial, modes) -> bool:
    """Whether the truncated-DFT factorisation is exact for this shape:
    corner blocks must not overlap (2m_k <= S_k) and the last axis must
    retain no more than the rfft spectrum holds."""
    if len(spatial) != len(modes) or not modes:
        return False
    if any(2 * m > s for m, s in zip(modes[:-1], spatial[:-1], strict=True)):
        return False
    return modes[-1] <= spatial[-1] // 2 + 1


def fused_factors(spatial, modes):
    """The DFT and inverse-DFT factor matrices (numpy, float64), the
    reference's: per axis k the forward pair (re, im) of
    ``F_k[mu, t] = exp(-2πi f_mu t / S_k)`` over the retained rows, then per
    axis the inverse pair, ``G_k[mu, t] = exp(+2πi f_mu t / S_k) / S_k`` for
    full-FFT axes and, for the last axis, the real-output pair
    ``C_re = w_mu cos(2π mu t / S) / S``, ``C_im = -w_mu sin(...) / S`` with
    hermitian weights w (1 at DC and at an even-S Nyquist row, 2
    elsewhere), so ``y = yh_re @ C_re + yh_im @ C_im`` is ``irfftn`` of the
    zero-scattered truncated spectrum."""
    ndim = len(modes)
    fwd, inv = [], []
    for k in range(ndim):
        S, m = int(spatial[k]), int(modes[k])
        last = k == ndim - 1
        freqs = np.arange(m) if last else np.concatenate([np.arange(m), np.arange(S - m, S)])
        ang = 2.0 * np.pi * np.outer(freqs, np.arange(S)) / S
        fwd.append((np.cos(ang), -np.sin(ang)))
        if not last:
            inv.append((np.cos(ang) / S, np.sin(ang) / S))
        else:
            w = np.full(m, 2.0)
            w[0] = 1.0
            if S % 2 == 0 and m - 1 == S // 2:
                w[m - 1] = 1.0  # the Nyquist row is its own conjugate
            inv.append((w[:, None] * np.cos(ang) / S, -w[:, None] * np.sin(ang) / S))
    return tuple(x for pair in fwd + inv for x in pair)


@functools.cache
def _factors(spatial, modes, dtype, device):
    """``fused_factors`` at ``dtype`` on ``device``, cast from float64 as
    the reference casts them: ``(fwd, inv)``, lists of (re, im) pairs."""
    f = [torch.from_numpy(a).to(dtype).to(device) for a in fused_factors(spatial, modes)]
    nd = len(modes)
    return ([(f[2 * k], f[2 * k + 1]) for k in range(nd)],
            [(f[2 * nd + 2 * k], f[2 * nd + 2 * k + 1]) for k in range(nd)])


def _cplx_apply(ar, ai, fr, fi, axis, f_axis, conj=False):
    """Apply one split-real complex factor along ``axis``: contract it with
    axis ``f_axis`` of the factor, the factor's other axis taking its place.
    ``ai=None`` is a real operand; ``conj`` multiplies by the conjugate."""

    def td(a, f):
        return torch.movedim(torch.tensordot(a, f, dims=([axis], [f_axis])), -1, axis)

    if ai is None:
        br, bi = td(ar, fr), td(ar, fi)
        if conj:
            bi = -bi
    elif conj:
        br = td(ar, fr) + td(ai, fi)
        bi = td(ai, fr) - td(ar, fi)
    else:
        br = td(ar, fr) - td(ai, fi)
        bi = td(ar, fi) + td(ai, fr)
    return br, bi


def _fused_spectrum(x, fwd, cast_to, sim_fmt):
    """x -> the quantised, mode-flattened split-real spectrum: the
    simulated fp8 grid (on f32 values), then the ``cast_to`` round trip."""
    from repro_torch.core.precision import simulate_fp8

    acc = _acc(x.dtype)
    ar, ai = x.to(acc), None
    for k, (fr, fi) in enumerate(fwd):
        ar, ai = _cplx_apply(ar, ai, fr, fi, 2 + k, 1)
    B, I = ar.shape[:2]
    xh = (ar.reshape(B, I, -1), ai.reshape(B, I, -1))
    if sim_fmt is not None:
        xh = tuple(simulate_fp8(t.float(), sim_fmt).to(acc) for t in xh)
    return (*_round(xh, cast_to, acc), tuple(ar.shape[2:]))


def spectral_fused_plain(x, wgr, wgi, modes, *, cast_to=None, sim_fmt=None):
    """``fused_fwd``'s function in plain PyTorch, the reference's
    ``_fused_fwd_kernel`` in tensordots: the truncated DFT axis by axis
    (axis 0 first), the ``fft_in`` quantisation, the contraction against
    the gathered weight rounded onto ``cast_to``, the inverse DFT and the
    hermitian fold.  Sums at f32 (f64 in a gradcheck).  ``x`` (B, I,
    *spatial), ``wgr``/``wgi`` (I, O, Mh); returns y (B, O, *spatial) at
    ``x``'s dtype."""
    nd = len(modes)
    acc = _acc(x.dtype)
    fwd, inv = _factors(tuple(x.shape[2:]), tuple(modes), acc, x.device)
    xhr, xhi, mode_shape = _fused_spectrum(x, fwd, cast_to, sim_fmt)
    wr, wi = _round((wgr, wgi), cast_to, acc)

    def bmm(a, b):
        return torch.einsum("bim,iom->bom", a, b)

    yhr, yhi = bmm(xhr, wr) - bmm(xhi, wi), bmm(xhr, wi) + bmm(xhi, wr)
    B, O = yhr.shape[:2]
    br, bi = yhr.reshape(B, O, *mode_shape), yhi.reshape(B, O, *mode_shape)
    for k in range(nd - 1):
        br, bi = _cplx_apply(br, bi, *inv[k], 2 + k, 0)
    (cr, ci), ax = inv[nd - 1], 1 + nd
    y = (torch.tensordot(br, cr, dims=([ax], [0]))
         + torch.tensordot(bi, ci, dims=([ax], [0])))
    return torch.movedim(y, -1, ax).to(x.dtype)


def spectral_fused_bwd_plain(x, wgr, wgi, g, modes, *, cast_to=None, sim_fmt=None):
    """``fused_bwd``'s function in plain PyTorch, the reference's
    ``_fused_bwd_kernel``: recompute the quantised x̂, take the cotangent
    through the adjoint of the inverse transform and round ĝ onto
    ``cast_to``, then ``dx̂ = Σ_o ĝ·conj(w)``, ``dw = Σ_b conj(x̂)·ĝ`` and
    ``dx = Re Fᴴ dx̂``.  Returns ``(dx, dwr, dwi)`` at the operands' dtype
    (f32; f64 in a gradcheck)."""
    nd = len(modes)
    acc = _acc(x.dtype)
    fwd, inv = _factors(tuple(x.shape[2:]), tuple(modes), acc, x.device)
    xhr, xhi, mode_shape = _fused_spectrum(x, fwd, cast_to, sim_fmt)
    wr, wi = _round((wgr, wgi), cast_to, acc)
    g = g.to(acc)
    (cr, ci), ax = inv[nd - 1], 1 + nd
    ghr = torch.movedim(torch.tensordot(g, cr, dims=([ax], [1])), -1, ax)
    ghi = torch.movedim(torch.tensordot(g, ci, dims=([ax], [1])), -1, ax)
    for k in reversed(range(nd - 1)):
        ghr, ghi = _cplx_apply(ghr, ghi, *inv[k], 2 + k, 1, conj=True)
    B, O = ghr.shape[:2]
    ghr, ghi = _round((ghr.reshape(B, O, -1), ghi.reshape(B, O, -1)), cast_to, acc)

    def e(spec, a, b):
        return torch.einsum(spec, a, b)

    dxhr = e("bom,iom->bim", ghr, wr) + e("bom,iom->bim", ghi, wi)
    dxhi = e("bom,iom->bim", ghi, wr) - e("bom,iom->bim", ghr, wi)
    dwr = e("bim,bom->iom", xhr, ghr) + e("bim,bom->iom", xhi, ghi)
    dwi = e("bim,bom->iom", xhr, ghi) - e("bim,bom->iom", xhi, ghr)
    I = dxhr.shape[1]
    dar, dai = dxhr.reshape(B, I, *mode_shape), dxhi.reshape(B, I, *mode_shape)
    for k in reversed(range(nd)):
        dar, dai = _cplx_apply(dar, dai, *fwd[k], 2 + k, 0, conj=True)
    return dar.to(x.dtype), dwr.to(wgr.dtype), dwi.to(wgi.dtype)


def fused_magnitude(x, wgr, wgi, modes, g=None):
    """The composed magnitude envelope of the fused pipeline, in f64: |x|
    through the absolute forward factors, the absolute gathered weight and
    the absolute inverse factors (``"out"``, what every rounding stage of
    either the fused or the staged path lives under, the reference's
    ``fused_mag``).  Given the cotangent g, also ``"dx"`` (|g| through the
    adjoints back to the input) and ``"dw"`` (Σ_b of the two spectra's
    envelopes)."""
    nd = len(modes)
    spatial = tuple(x.shape[2:])
    fwd, inv = _factors(spatial, tuple(modes), torch.float64, x.device)
    rows = fused_rows(spatial, modes)
    fwd = [torch.hypot(fr, fi) for fr, fi in fwd]
    lead = [torch.hypot(fr, fi) for fr, fi in inv[:-1]]
    last = inv[-1][0].abs() + inv[-1][1].abs()

    def apply(a, f, axis, f_axis):
        return torch.movedim(torch.tensordot(a, f, dims=([axis], [f_axis])), -1, axis)

    B, I = x.shape[:2]
    ax = x.double().abs()
    for k in range(nd):
        ax = apply(ax, fwd[k], 2 + k, 1)
    ax = ax.reshape(B, I, -1)
    aw = torch.hypot(wgr.double(), wgi.double())
    ay = torch.einsum("bim,iom->bom", ax, aw)
    O = ay.shape[1]
    ay = ay.reshape(B, O, *rows)
    for k in range(nd - 1):
        ay = apply(ay, lead[k], 2 + k, 0)
    out = {"out": apply(ay, last, 1 + nd, 0)}
    if g is not None:
        ag = apply(g.double().abs(), last, 1 + nd, 1)
        for k in reversed(range(nd - 1)):
            ag = apply(ag, lead[k], 2 + k, 1)
        ag = ag.reshape(B, O, -1)
        adx = torch.einsum("bom,iom->bim", ag, aw).reshape(B, I, *rows)
        for k in reversed(range(nd)):
            adx = apply(adx, fwd[k], 2 + k, 0)
        out.update(dx=adx, dw=torch.einsum("bim,bom->iom", ax, ag))
    return out


#: the fused kernels' contraction tile: 8 modes of 64 channels of 8 batch
#: rows, complex f32 (``CT_BYTES`` in the source); a block takes at least it
FUSED_TILE_BYTES = 8 * 64 * 8 * 8
def fused_smem_bytes(spatial, modes) -> int:
    """Shared memory one block of the fused kernels holds for these axes:
    the slab after its last axis (S0·R1 complex f32 for 2 axes; S0·S1·R2
    and S0·R1·R2 for 3), and at least the contraction's tile
    (``FUSED_TILE_BYTES``); mirrored by ``spectral_fused_smem`` in the
    source."""
    S, R = tuple(int(s) for s in spatial), fused_rows(spatial, modes)
    slab = 0
    if len(S) == 2:
        slab = 8 * S[0] * R[1]
    if len(S) == 3:
        slab = 8 * (S[0] * S[1] * R[2] + S[0] * R[1] * R[2])
    return max(slab, FUSED_TILE_BYTES)


def fused_scratch_bytes(block_b: int, I: int, O: int, spatial, modes) -> int:
    """The bytes the fused backward keeps between its stages for a batch
    tile of ``block_b`` rows: the truncated spectra x̂, ĝ and dx̂, complex
    f32 of Mh modes each.  The larger of the two directions' scratch, so
    the viability rule and the batch tile are decided by it."""
    return 8 * block_b * (2 * I + O) * math.prod(fused_rows(spatial, modes))


def fused_fwd_scratch_bytes(block_b: int, I: int, O: int, spatial, modes) -> int:
    """The bytes the fused forward keeps between its stages: x̂ and ŷ."""
    return 8 * block_b * (I + O) * math.prod(fused_rows(spatial, modes))


def pick_block_b(B: int, I: int, O: int, spatial, modes) -> int:
    """The largest power-of-two batch tile, at most 8 (the kernels keep a
    mode's rows of a tile in registers), whose fused scratch fits in half
    the L2 (1 is the last resort: callers deciding fused against staged
    check ``fused_scratch_bytes(1, ...)`` themselves)."""
    for bb in (8, 4, 2, 1):
        if bb <= max(B, 1) and fused_scratch_bytes(bb, I, O, spatial, modes) <= L2_BUDGET // 2:
            return bb
    return 1


def fused_products(spatial, modes):
    """The fused kernels' product matrices B, f32 on the CPU, in the
    pack's order (per axis, axis 0 first: the forward DFT, the inverse,
    the inverse's adjoint, the forward's adjoint): each factor cast from
    ``fused_factors`` as the reference casts it, transposed or negated
    (exact) into ``(B_re + i B_im)[l][j]`` (index l of the axis in, j
    out), padded with zeros to Lp = L rounded up to 16 rows and Jp = J to
    8 columns, then laid out as the source states: ``[B_re | B_im]`` on
    real data (the analysis' last axis), ``[[B_re, B_im], [-B_im, B_re]]``
    on a complex axis, ``[B_re ; B_im]`` back to real (the synthesis'
    last axis)."""
    nd = len(modes)
    f = [torch.from_numpy(a).float() for a in fused_factors(spatial, modes)]
    out = []
    for k in range(nd):
        fr, fi = f[2 * k], f[2 * k + 1]
        gr, gi = f[2 * nd + 2 * k], f[2 * nd + 2 * k + 1]
        last = k == nd - 1
        pairs = ((fr.T, fi.T), (gr, gi), (gr.T, gi.T if last else -gi.T),
                 (fr, fi if last else -fi))
        for q, (bre, bim) in enumerate(pairs):
            L, J = bre.shape
            pad = (0, -J % 8, 0, -L % 16)
            bre, bim = torch.nn.functional.pad(bre, pad), torch.nn.functional.pad(bim, pad)
            analysis = q in (0, 2)
            if analysis and last:
                out.append(torch.cat([bre, bim], 1))
            elif last:
                out.append(torch.cat([bre, bim], 0))
            else:
                out.append(torch.cat([torch.cat([bre, bim], 1), torch.cat([-bim, bre], 1)], 0))
    return out


def bf16_split(b: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Three bf16 pieces of f32 ``b`` whose sum is ``b`` exactly: each the
    bf16 rounding (to nearest even) of what the earlier pieces leave (the
    source's ``split3``)."""
    rest, pieces = b.float(), []
    for _ in range(3):
        piece = rest.to(torch.bfloat16)
        pieces.append(piece)
        rest = rest - piece.float()
    return tuple(pieces)


def fragment_order(p: torch.Tensor) -> torch.Tensor:
    """A (Kp, Np) bf16 piece as the kernels load it: [k step of 16 rows]
    [n tile of 8 columns][lane (g, t) = 4g + t][rows 2t, 2t+1, 2t+8, 2t+9
    of column g], flat."""
    Kp, Np = p.shape
    return p.reshape(Kp // 16, 2, 4, 2, Np // 8, 8).permute(0, 4, 5, 2, 1, 3).reshape(-1)


@functools.cache
def _fused_pack(spatial, modes, device) -> torch.Tensor:
    """The kernels' factor pack on ``device``: every ``fused_products``
    matrix as its three ``bf16_split`` pieces, piece after piece, each in
    ``fragment_order`` (bf16 bits, the layout ``spectral_fused.cu``
    states)."""
    parts = [fragment_order(p) for b in fused_products(spatial, modes) for p in bf16_split(b)]
    return torch.cat(parts).view(torch.int16).to(device)


def _check_fused(x, wgr, wgi, modes, cast_to, sim_fmt) -> torch.device:
    """The checks every fused entry makes; returns the operands' device."""
    ops = (x, wgr, wgi)
    devices = {t.device for t in ops}
    dtypes = {t.dtype for t in ops}
    on_cpu = devices == {torch.device("cpu")}
    allowed = (torch.float32, torch.float64) if on_cpu else (torch.float32,)
    if len(dtypes) != 1 or x.dtype not in allowed:
        raise TypeError(
            f"spectral_fused takes float32 operands of one dtype (float64 too on the "
            f"CPU), got {[t.dtype for t in ops]}")
    spatial = tuple(x.shape[2:])
    if x.ndim != 2 + len(modes) or not fused_supported(spatial, modes):
        raise ValueError(
            f"spectral_fused: x {tuple(x.shape)} cannot retain modes {tuple(modes)} "
            f"(need (B, I, *spatial), 2m <= S per truncated axis and m <= S//2+1 on "
            f"the last)")
    Mh = math.prod(fused_rows(spatial, modes))
    if wgr.ndim != 3 or wgr.shape != wgi.shape or wgr.shape[0] != x.shape[1] \
            or wgr.shape[2] != Mh:
        raise ValueError(
            f"spectral_fused: weight {tuple(wgr.shape)}/{tuple(wgi.shape)}, expected "
            f"({x.shape[1]}, O, {Mh}) corner-gathered rows for modes {tuple(modes)}")
    if cast_to not in (None, torch.bfloat16, torch.float16):
        raise TypeError(f"cast_to must be None, bfloat16 or float16, got {cast_to}")
    if sim_fmt not in _SIM:
        raise ValueError(f"sim_fmt must be one of {list(_SIM)}, got {sim_fmt!r}")
    if len(devices) != 1:
        raise ValueError(f"spectral_fused: operands on {devices}")
    device = x.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"spectral_fused: no kernel for {device}")
    if device.type == "cuda":
        if not all(t.is_contiguous() for t in ops):
            raise ValueError("spectral_fused: operands must be contiguous")
        if len(modes) > 3:
            raise ValueError(f"spectral_fused: the kernels take 1 to 3 spatial axes, "
                             f"not {len(modes)}")
    return device


class FusedSpectral(torch.autograd.Function):
    """The fused spectral layer with the reference's custom VJP
    (``_fused_op_bwd``) on both devices.

    Inputs: ``x`` (B, I, *spatial) and the gathered weight ``wgr``/``wgi``
    (I, O, Mh), f32 (f64 too on the CPU); ``modes``, ``cast_to``,
    ``sim_fmt`` and the batch tiles ``block_fwd`` / ``block_bwd`` (None:
    ``pick_block_b``'s) are constants.  Forward: the plain version on the CPU,
    ``fused_fwd`` on CUDA, y at f32.  Backward: recompute x̂, round ĝ onto
    ``cast_to``, dx and dw at f32: the plain version on the CPU,
    ``fused_bwd`` on CUDA.  No gradient passes through a rounding."""

    @staticmethod
    def forward(ctx, x, wgr, wgi, modes, cast_to=None, sim_fmt=None, block_fwd=None,
                block_bwd=None):
        modes = tuple(int(m) for m in modes)
        device = _check_fused(x, wgr, wgi, modes, cast_to, sim_fmt)
        ctx.cfg = (modes, cast_to, sim_fmt, block_bwd)
        ctx.save_for_backward(x, wgr, wgi)
        if device.type == "cpu":
            return spectral_fused_plain(x, wgr, wgi, modes, cast_to=cast_to, sim_fmt=sim_fmt)
        return _launch_fused_fwd(x, wgr, wgi, modes, cast_to, sim_fmt, block_fwd)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, wgr, wgi = ctx.saved_tensors
        modes, cast_to, sim_fmt, block_bwd = ctx.cfg
        if x.device.type == "cpu":
            dx, dwr, dwi = spectral_fused_bwd_plain(x, wgr, wgi, g, modes, cast_to=cast_to,
                                                    sim_fmt=sim_fmt)
        else:
            dx, dwr, dwi = _launch_fused_bwd(x, wgr, wgi, g.float().contiguous(), modes,
                                             cast_to, sim_fmt, block_bwd)
        return dx, dwr, dwi, None, None, None, None, None


def _fused_args(x, modes):
    """The C interface's axes: ``(nd, S0, S1, S2, m0, m1, m2)``, unused
    axes 1."""
    nd = len(modes)
    pad = [1] * (3 - nd)
    return (nd, *(int(s) for s in x.shape[2:]), *pad, *(int(m) for m in modes), *pad)


def _fused_setup(x, modes, I, O, bb, backward):
    """The library, its axes, the factor pack and the scratch of a launch
    (``fused_scratch_bytes`` for the backward, ``fused_fwd_scratch_bytes``
    for the forward).  A shape whose slab does not fit a block's shared
    memory is refused by the launcher."""
    size = (fused_scratch_bytes if backward else fused_fwd_scratch_bytes)(
        bb, I, O, x.shape[2:], modes)
    scratch = torch.empty(size // 4, dtype=torch.float32, device=x.device)
    return (_library_fused(), _fused_args(x, modes),
            _fused_pack(tuple(x.shape[2:]), tuple(modes), x.device), scratch)


def _batch_tile(block_b, B, I, O, spatial, modes) -> int:
    """``block_b``, checked (1 to 8 rows: the kernels keep a mode's rows of
    a tile in registers), or ``pick_block_b``'s tile where it is None."""
    if block_b is None:
        return pick_block_b(B, I, O, spatial, modes)
    if not 1 <= int(block_b) <= 8:
        raise ValueError(f"spectral_fused: batch tile {block_b}, the kernels take 1 to 8 rows")
    return int(block_b)


def _launch_fused_fwd(x, wgr, wgi, modes, cast_to, sim_fmt, block_b=None):
    """``fused_fwd``, one launch per batch tile of ``block_b`` rows
    (None: ``pick_block_b``'s)."""
    global launches_fused_fwd
    B, I, *spatial = x.shape
    O = wgr.shape[1]
    y = torch.empty((B, O, *spatial), dtype=torch.float32, device=x.device)
    if y.numel() == 0 or x.numel() == 0:
        return y.zero_()
    bb = _batch_tile(block_b, B, I, O, spatial, modes)
    lib, axes, fac, scratch = _fused_setup(x, modes, I, O, bb, backward=False)
    for b0 in range(0, B, bb):
        n = min(bb, B - b0)
        _call(lib.spectral_fused_fwd, "spectral_fused_fwd", x.device,
              x[b0:b0 + n].data_ptr(), wgr.data_ptr(), wgi.data_ptr(), fac.data_ptr(),
              y[b0:b0 + n].data_ptr(), scratch.data_ptr(), n, I, O, *axes,
              _FMT[cast_to or torch.float32], _SIM[sim_fmt])
        launches_fused_fwd += 1
    return y


def _launch_fused_bwd(x, wgr, wgi, g, modes, cast_to, sim_fmt, block_b=None):
    """``fused_bwd``, one launch per batch tile of ``block_b`` rows (None:
    ``pick_block_b``'s); each tile after the first adds its dw to the
    earlier tiles' sum, in tile order, so the tile decides dw's f32 sum
    order."""
    global launches_fused_bwd
    B, I, *spatial = x.shape
    O = wgr.shape[1]
    dx = torch.empty_like(x)
    dwr, dwi = torch.empty_like(wgr), torch.empty_like(wgi)
    if x.numel() == 0 or g.numel() == 0 or dwr.numel() == 0:
        return dx.zero_(), dwr.zero_(), dwi.zero_()
    if g.shape != (B, O, *spatial):
        raise ValueError(f"spectral_fused backward: cotangent {tuple(g.shape)}, "
                         f"expected {(B, O, *spatial)}")
    bb = _batch_tile(block_b, B, I, O, spatial, modes)
    lib, axes, fac, scratch = _fused_setup(x, modes, I, O, bb, backward=True)
    for b0 in range(0, B, bb):
        n = min(bb, B - b0)
        _call(lib.spectral_fused_bwd, "spectral_fused_bwd", x.device,
              x[b0:b0 + n].data_ptr(), wgr.data_ptr(), wgi.data_ptr(), fac.data_ptr(),
              g[b0:b0 + n].data_ptr(), dx[b0:b0 + n].data_ptr(), dwr.data_ptr(),
              dwi.data_ptr(), scratch.data_ptr(), n, I, O, *axes,
              _FMT[cast_to or torch.float32], _SIM[sim_fmt], int(b0 > 0))
        launches_fused_bwd += 1
    return dx, dwr, dwi


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(SOURCE, spectral_contract_dense_fwd=(6, 6))


@functools.cache
def _library_bwd() -> ctypes.CDLL:
    return _bind(SOURCE_BWD, spectral_contract_dense_bwd_x=(6, 6),
                 spectral_contract_dense_bwd_w=(6, 6))


@functools.cache
def _library_cp() -> ctypes.CDLL:
    lib = _bind(SOURCE_CP, spectral_contract_cp_fwd=(10, 7),
                spectral_contract_cp_bwd=(19, 9))
    for name, n_int in (("spectral_contract_cp_fwd_smem", 2),
                        ("spectral_contract_cp_bwd_smem", 1),
                        ("spectral_contract_cp_bwd_workspace", 6)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * n_int
        fn.restype = ctypes.c_longlong
    return lib


@functools.cache
def _library_ls() -> ctypes.CDLL:
    lib = _bind(SOURCE_LS, spectral_contract_ls_fwd=(6, 8),
                spectral_contract_ls_bwd_x=(6, 8), spectral_contract_ls_bwd_w=(6, 6))
    lib.spectral_contract_ls_smem.argtypes = [ctypes.c_int] * 3
    lib.spectral_contract_ls_smem.restype = ctypes.c_longlong
    return lib


@functools.cache
def _library_fused() -> ctypes.CDLL:
    lib = _bind(SOURCE_FUSED, spectral_fused_fwd=(6, 12), spectral_fused_bwd=(9, 13))
    for name in ("spectral_fused_smem", "spectral_fused_pack_words"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 7
        getattr(lib, name).restype = ctypes.c_longlong
    return lib
