"""Dense spectral contraction: the CUDA kernels, their plain PyTorch
versions, and the autograd Function that checks and launches them.

    out[b,o,m] = Σ_i x[b,i,m] · w[i,o,m]          (complex, per mode m)
    dx[b,i,m]  = Σ_o g[b,o,m] · conj(w[i,o,m])    (backward, dense_bwd_x)
    dw[i,o,m]  = Σ_b conj(x[b,i,m]) · g[b,o,m]    (backward, dense_bwd_w)

in split-real f32 operands ``xr/xi`` (B, I, M) and ``wr/wi`` (I, O, M),
with an optional rounding of every operand onto the bf16/fp16 grid
(``cast_to``, the reference's fused storage cast), f32 sums, and the
forward's result stored at ``out_dtype``.  The gradients are f32 sums of
the rounded operands stored at f32, as the reference's custom VJP
(``_dense_op_bwd``) computes them: never rounded to the half grid.  The
kernels replace the TPU kernels ``_dense_fwd_kernel``,
``_dense_bwd_x_kernel`` and ``_dense_bwd_w_kernel`` of
``repro.kernels.spectral_contract``; their sources
(``csrc/spectral_contract.cu``, ``csrc/spectral_contract_bwd.cu``) state
their bounds and designs.

Dispatch follows the tensors' device: CPU tensors take the plain
versions, CUDA tensors launch the kernels or raise.  Each source is
compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/repro_torch_kernels/`` at the repository root, and loaded with
``ctypes``.  ``launches``, ``launches_bwd_x`` and ``launches_bwd_w``
count the kernels' launches.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "spectral_contract.cu"
SOURCE_BWD = CSRC / "spectral_contract_bwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: format codes of the C interface
_FMT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def _bind(source: Path, *names: str) -> ctypes.CDLL:
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind(SOURCE, "spectral_contract_dense_fwd")


@functools.cache
def _library_bwd() -> ctypes.CDLL:
    return _bind(SOURCE_BWD, "spectral_contract_dense_bwd_x",
                 "spectral_contract_dense_bwd_w")
