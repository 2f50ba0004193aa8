"""Dense spectral contraction, forward: the CUDA kernel, its plain
PyTorch version, and the wrapper that checks and launches.

    out[b,o,m] = Σ_i x[b,i,m] · w[i,o,m]          (complex, per mode m)

in split-real f32 operands ``xr/xi`` (B, I, M) and ``wr/wi`` (I, O, M),
with an optional rounding of every operand onto the bf16/fp16 grid
(``cast_to``, the reference's fused storage cast), f32 sums, and the
result stored at ``out_dtype``.  The kernel replaces the TPU kernel
``_dense_fwd_kernel`` of ``repro.kernels.spectral_contract``; its source
(``csrc/spectral_contract.cu``) states its bound and design.

Dispatch follows the tensors' device: CPU tensors take
:func:`spectral_contract_plain`, CUDA tensors launch the kernel or raise.
The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/repro_torch_kernels/`` at the repository root, and loaded with
``ctypes``.  ``launches`` counts the kernel's launches.
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

#: kernel launches since the count was last set to 0
launches = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "spectral_contract.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: format codes of the C interface
_FMT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def spectral_contract_plain(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
    *, cast_to: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: round the operands to
    ``cast_to`` and back, four f32 real contractions, cast to
    ``out_dtype``."""
    if cast_to is not None:
        xr, xi, wr, wi = (t.to(cast_to).float() for t in (xr, xi, wr, wi))

    def bmm(a, b):
        return torch.einsum("bim,iom->bom", a, b)

    rr, ii = bmm(xr, wr), bmm(xi, wi)
    ri, ir = bmm(xr, wi), bmm(xi, wr)
    return (rr - ii).to(out_dtype), (ri + ir).to(out_dtype)


def spectral_contract_dense(
    xr: torch.Tensor, xi: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
    *, cast_to: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-real ``bim,iom->bom``.  Returns ``(out_re, out_im)`` of shape
    (B, O, M) at ``out_dtype``.  CPU tensors take the plain version, CUDA
    tensors the kernel; anything the kernel does not take raises."""
    ops = (xr, xi, wr, wi)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError(
            f"spectral_contract_dense takes float32 operands, got "
            f"{[t.dtype for t in ops]}")
    if xr.ndim != 3 or wr.ndim != 3 or xi.shape != xr.shape or wi.shape != wr.shape:
        raise ValueError(
            f"spectral_contract_dense: expected x (B, I, M) and w (I, O, M), got "
            f"{tuple(xr.shape)}/{tuple(xi.shape)} and {tuple(wr.shape)}/{tuple(wi.shape)}")
    B, I, M = xr.shape
    if wr.shape[0] != I or wr.shape[2] != M:
        raise ValueError(
            f"spectral_contract_dense: x {tuple(xr.shape)} and w {tuple(wr.shape)} "
            f"disagree on channels or modes")
    for name, dt in (("cast_to", cast_to), ("out_dtype", out_dtype)):
        if dt is not None and dt not in _FMT:
            raise TypeError(f"{name} must be one of {list(_FMT)}, got {dt}")
    devices = {t.device for t in ops}
    if len(devices) != 1:
        raise ValueError(f"spectral_contract_dense: operands on {devices}")
    device = xr.device
    if device.type == "cpu":
        return spectral_contract_plain(xr, xi, wr, wi, cast_to=cast_to,
                                       out_dtype=out_dtype)
    if device.type != "cuda":
        raise ValueError(f"spectral_contract_dense: no kernel for {device}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("spectral_contract_dense: operands must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise NotImplementedError(
            "spectral_contract_dense has no backward kernels yet (ROADMAP: "
            "training slice); run inference under torch.no_grad()")
    return _launch(xr, xi, wr, wi, cast_to, out_dtype)


def contract_magnitude(xr, xi, wr, wi) -> torch.Tensor:
    """``M[b,o,m] = Σ_i |x[b,i,m]|·|w[i,o,m]|`` in f32: the per-output
    magnitude that the tolerance of a comparison between two evaluations
    of the contraction scales with (``core.theory.contract_budget``)."""
    return torch.einsum("bim,iom->bom", torch.hypot(xr, xi), torch.hypot(wr, wi))


def _launch(xr, xi, wr, wi, cast_to, out_dtype):
    global launches
    B, I, M = xr.shape
    O = wr.shape[1]
    outr = torch.empty((B, O, M), dtype=out_dtype, device=xr.device)
    outi = torch.empty_like(outr)
    if outr.numel() == 0:
        return outr, outi
    fn = _library().spectral_contract_dense_fwd
    with torch.cuda.device(xr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                outr.data_ptr(), outi.data_ptr(), B, I, O, M,
                _FMT[cast_to or torch.float32], _FMT[out_dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"spectral_contract_dense_fwd failed to launch: CUDA error {rc}")
    launches += 1
    return outr, outi


def build() -> Tuple[Path, str]:
    """Compile the kernel from ``SOURCE`` unless this source's library is
    already built.  Returns the library's path and the compiler's report
    (``-Xptxas -v``: registers, shared memory, spills)."""
    from torch.utils.cpp_extension import CUDA_HOME

    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    stem = f"spectral_contract_{digest.hexdigest()[:12]}"
    lib, log = BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.log"
    if lib.exists() and log.exists():
        return lib, log.read_text()
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [str(Path(CUDA_HOME) / "bin" / "nvcc"), *NVCC_FLAGS, "-o", str(tmp),
           str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    report = res.stdout + res.stderr
    # rename into place last: a concurrent builder sees a whole library or none
    log.write_text(report)
    os.replace(tmp, lib)
    return lib, report


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.spectral_contract_dense_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.spectral_contract_dense_fwd.restype = ctypes.c_int
    return lib
