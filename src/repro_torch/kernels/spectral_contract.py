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

The kernels replace the TPU kernels ``_dense_fwd_kernel``,
``_dense_bwd_x_kernel``, ``_dense_bwd_w_kernel``, ``_cp_fwd_kernel``,
``_cp_bwd_kernel``, ``_lshared_fwd_kernel``, ``_lshared_bwd_x_kernel`` and
``_lshared_bwd_w_kernel`` of ``repro.kernels.spectral_contract``; their
sources (``csrc/spectral_contract.cu``, ``csrc/spectral_contract_bwd.cu``,
``csrc/spectral_contract_cp.cu``, ``csrc/spectral_contract_lshared.cu``)
state their bounds and designs.

Dispatch follows the tensors' device: CPU tensors take the plain
versions, CUDA tensors launch the kernels or raise.  Each source is
compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/repro_torch_kernels/`` at the repository root, and loaded with
``ctypes``.  ``launches``, ``launches_bwd_x``, ``launches_bwd_w``,
``launches_cp_fwd``, ``launches_cp_bwd``, ``launches_ls_fwd``,
``launches_ls_bwd_x`` and ``launches_ls_bwd_w`` count the kernels'
launches.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

#: kernel launches since the counts were last set to 0
launches = 0
launches_bwd_x = 0
launches_bwd_w = 0
launches_cp_fwd = 0
launches_cp_bwd = 0
launches_ls_fwd = 0
launches_ls_bwd_x = 0
launches_ls_bwd_w = 0

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "spectral_contract.cu"
SOURCE_BWD = CSRC / "spectral_contract_bwd.cu"
SOURCE_CP = CSRC / "spectral_contract_cp.cu"
SOURCE_LS = CSRC / "spectral_contract_lshared.cu"
SOURCES = (SOURCE, SOURCE_BWD, SOURCE_CP, SOURCE_LS)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _call(fn, name, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")


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


def _cp_smem(name: str, I: int, O: int, R: int) -> int:
    """Shared memory a block of ``cp_fwd``/``cp_bwd`` needs at these
    widths; raises where it exceeds what a block may have."""
    need = int(getattr(_library_cp(), f"spectral_contract_cp_{name}_smem")(I, O, R, 0))
    if need > SMEM_LIMIT:
        raise ValueError(
            f"spectral_contract_cp: cp_{name} holds its working set in shared "
            f"memory, and I={I}, O={O}, R={R} need {need} bytes, more than a "
            f"block's {SMEM_LIMIT}")
    return need


def _launch_cp_fwd(xr, xi, uir, uii, uor, uoi, wr, wi):
    global launches_cp_fwd
    B, I, M = xr.shape
    O, R = uor.shape
    outr = torch.empty((B, O, M), dtype=xr.dtype, device=xr.device)
    outi = torch.empty_like(outr)
    if outr.numel() == 0:
        return outr, outi
    _cp_smem("fwd", I, O, R)
    ptrs = [t.data_ptr() for t in (xr, xi, uir, uii, uor, uoi, wr, wi, outr, outi)]
    _call(_library_cp().spectral_contract_cp_fwd, "spectral_contract_cp_fwd",
          xr.device, *ptrs, B, I, O, R, M, _FMT[xr.dtype])
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
    _cp_smem("bwd", I, O, R)
    lib = _library_cp()
    work = torch.empty(int(lib.spectral_contract_cp_bwd_workspace(I, O, R, M)),
                       dtype=torch.float32, device=xr.device)
    ptrs = [t.data_ptr() for t in (xr, xi, uir, uii, uor, uoi, wr, wi, gr, gi, *grads, work)]
    _call(lib.spectral_contract_cp_bwd, "spectral_contract_cp_bwd", xr.device,
          *ptrs, B, I, O, R, M, _FMT[xr.dtype])
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
    dtype (the site's storage dtype, rounded by the caller).  Forward: the
    plain version on the CPU, ``ls_fwd`` on CUDA.  Backward: dx and dw at
    the operands' dtype, each only where it is needed: the plain versions
    on the CPU, ``ls_bwd_x`` and ``ls_bwd_w`` on CUDA."""

    @staticmethod
    def forward(ctx, xr, xi, wr, wi):
        device = _check_ls(xr, xi, wr, wi)
        ctx.save_for_backward(xr, xi, wr, wi)
        if device.type == "cpu":
            return spectral_contract_lshared_plain(xr, xi, wr, wi)
        return _launch_ls_fwd(xr, xi, wr, wi)

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
            return dxr, dxi, dwr, dwi
        if gr.dtype != xr.dtype or gi.dtype != xr.dtype:
            raise TypeError(f"spectral_contract_lshared backward: cotangents of "
                            f"{gr.dtype}/{gi.dtype}, operands of {xr.dtype}")
        gr, gi = gr.contiguous(), gi.contiguous()
        if need_x:
            dxr, dxi = _launch_ls_bwd_x(gr, gi, wr, wi)
        if need_w:
            dwr, dwi = _launch_ls_bwd_w(xr, xi, gr, gi)
        return dxr, dxi, dwr, dwi


def _ls_workspace(K: int, N: int, L: int, device) -> torch.Tensor:
    """The f32 workspace of ``ls_fwd`` (K = I, N = O) or ``ls_bwd_x``
    (K = O, N = I): the weight restaged in (L, K, N) order; raises where a
    block's working set exceeds its shared memory."""
    lib = _library_ls()
    need = int(lib.spectral_contract_ls_smem(K, N))
    if need > SMEM_LIMIT:
        raise ValueError(
            f"spectral_contract_lshared: a block holds the weight's degree slice in "
            f"shared memory, and {K} x {N} channels need {need} bytes, more than a "
            f"block's {SMEM_LIMIT}")
    return torch.empty(int(lib.spectral_contract_ls_workspace(K, N, L)),
                       dtype=torch.float32, device=device)


def _launch_ls_fwd(xr, xi, wr, wi):
    global launches_ls_fwd
    B, I, L, M = xr.shape
    O = wr.shape[1]
    outr = torch.empty((B, O, L, M), dtype=xr.dtype, device=xr.device)
    outi = torch.empty_like(outr)
    if outr.numel() == 0:
        return outr, outi
    work = _ls_workspace(I, O, L, xr.device)
    _call(_library_ls().spectral_contract_ls_fwd, "spectral_contract_ls_fwd", xr.device,
          *(t.data_ptr() for t in (xr, xi, wr, wi, outr, outi, work)),
          B, I, O, L, M, _FMT[xr.dtype])
    launches_ls_fwd += 1
    return outr, outi


def _launch_ls_bwd_x(gr, gi, wr, wi):
    global launches_ls_bwd_x
    B, O, L, M = gr.shape
    I = wr.shape[0]
    dxr = torch.empty((B, I, L, M), dtype=wr.dtype, device=wr.device)
    dxi = torch.empty_like(dxr)
    if dxr.numel() == 0:
        return dxr, dxi
    work = _ls_workspace(O, I, L, wr.device)
    _call(_library_ls().spectral_contract_ls_bwd_x, "spectral_contract_ls_bwd_x",
          wr.device, *(t.data_ptr() for t in (gr, gi, wr, wi, dxr, dxi, work)),
          B, I, O, L, M, _FMT[wr.dtype])
    launches_ls_bwd_x += 1
    return dxr, dxi


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


def build(source: Path = SOURCE) -> Tuple[Path, str]:
    """Compile ``source`` unless its library is already built.  Returns
    the library's path and the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills)."""
    from torch.utils.cpp_extension import CUDA_HOME

    digest = hashlib.sha1(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    stem = f"{source.stem}_{digest.hexdigest()[:12]}"
    lib, log = BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"
    if lib.exists() and log.exists():
        return lib, log.read_text()
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [str(Path(CUDA_HOME) / "bin" / "nvcc"), *NVCC_FLAGS, "-o", str(tmp),
           str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    report = res.stdout + res.stderr
    # rename into place last: a concurrent builder sees a whole library or none
    log.write_text(report)
    os.replace(tmp, lib)
    return lib, report


def _bind(source: Path, **signatures: Tuple[int, int]) -> ctypes.CDLL:
    """Load ``source``'s library; each launcher ``name=(pointers, ints)``
    takes that many pointers, then ints, then the stream."""
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    for name, (n_ptr, n_int) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(SOURCE, spectral_contract_dense_fwd=(6, 6))


@functools.cache
def _library_bwd() -> ctypes.CDLL:
    return _bind(SOURCE_BWD, spectral_contract_dense_bwd_x=(6, 6),
                 spectral_contract_dense_bwd_w=(6, 6))


@functools.cache
def _library_cp() -> ctypes.CDLL:
    lib = _bind(SOURCE_CP, spectral_contract_cp_fwd=(10, 6),
                spectral_contract_cp_bwd=(19, 6))
    for name in ("spectral_contract_cp_fwd_smem", "spectral_contract_cp_bwd_smem",
                 "spectral_contract_cp_bwd_workspace"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    return lib


@functools.cache
def _library_ls() -> ctypes.CDLL:
    lib = _bind(SOURCE_LS, spectral_contract_ls_fwd=(7, 6),
                spectral_contract_ls_bwd_x=(7, 6), spectral_contract_ls_bwd_w=(6, 6))
    lib.spectral_contract_ls_smem.argtypes = [ctypes.c_int] * 2
    lib.spectral_contract_ls_smem.restype = ctypes.c_longlong
    lib.spectral_contract_ls_workspace.argtypes = [ctypes.c_int] * 3
    lib.spectral_contract_ls_workspace.restype = ctypes.c_longlong
    return lib
