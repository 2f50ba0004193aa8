"""The one nvcc path of the port's hand-written kernels.

Each CUDA source under ``csrc/`` exposes a plain C interface.  ``build``
compiles it with ``nvcc`` for ``sm_90a`` at first use, into
``build/repro_torch_kernels/`` at the repository root; ``_bind`` loads the
library with ``ctypes`` and declares each launcher's arguments; ``_call``
launches on PyTorch's current stream and raises on a launch error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: every source the kernel modules build, in the order the smoke script builds them
SOURCES = tuple(CSRC / f"{stem}.cu" for stem in (
    "spectral_contract", "spectral_contract_bwd", "spectral_contract_cp",
    "spectral_contract_lshared", "spectral_fused", "rmsnorm", "flash_attention"))
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def digest(*sources: Path) -> str:
    """sha1 (hex) of ``sources``, the headers under ``csrc/`` (part of
    every source's build) and the flags: a source's build key, and over
    the tuned families' sources the kernels' version
    (``spectral_contract.KERNEL_VERSION``)."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    body = b"".join(src.read_bytes() for src in sources)
    return hashlib.sha1(body + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()


def build(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` unless its library is already built.  Returns
    the library's path and the compiler's report (``-Xptxas -v``:
    registers, shared memory, spills)."""
    from torch.utils.cpp_extension import CUDA_HOME

    stem = f"{source.stem}_{digest(source)[:12]}"
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
    # rename into place last: a concurrent build sees a whole library or none
    log.write_text(report)
    os.replace(tmp, lib)
    return lib, report


def _bind(source: Path, **signatures: Tuple[int, ...]) -> ctypes.CDLL:
    """Load ``source``'s library; each launcher ``name=(pointers, ints)``
    or ``name=(pointers, ints, floats)`` takes that many pointers, then
    ints, then floats, then the stream."""
    path, _ = build(source)
    lib = ctypes.CDLL(str(path))
    for name, (n_ptr, n_int, *n_float) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * sum(n_float) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _call(fn, name, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")
