"""The admission gate: every candidate vs its float64 oracle, under the
paper's own tolerance.

Thm 3.2 bounds the precision error of a half-stored contraction by
``4·ε·M`` per requantising stage, where ``ε`` is the storage grid
spacing and ``M`` the contraction of operand magnitudes.  This module
applies the reference's gate (``repro.tune.oracle``) at tuning time:

    budget = stages · 4εM + 32·ε_f32·M + atol      (elementwise)

and a candidate tile whose kernel output strays outside that envelope is
*refused* — a mistuned-but-wrong kernel is unrepresentable in the
calibration cache.  The oracle runs in float64 numpy from the same
storage-rounded operands the kernel consumes; ``check`` runs the port's
forward at the candidate's tiles: the kernels on a CUDA device, the
plain versions on the CPU.

``perturb`` injects a scaled multiple of the budget into the output
before the comparison.  It exists so the gate itself is testable:
``python -m repro_torch.tune validate --perturb 2`` must reject every
entry, proving the oracle is live, not vacuously green.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.precision import FORMAT_EPS
from repro_torch.core.theory import prec_upper_bound
from repro_torch.kernels.spectral_contract import (
    CPContract,
    DenseContract,
    fused_factors,
    fused_rows,
)

from .measure import forward, make_operands
from .space import Candidate, fused_axes

F32_EPS = float(np.finfo(np.float32).eps)
ATOL = 1e-5

#: requantising stages per family — one 4εM term each, the reference's
#: counts.  spectral_fused composes four: the forward-DFT boundary
#: quantisation, the two contraction operand grids, and the half output
#: store.
STAGES = {"dense": 2, "dense-fused": 2, "cp": 6, "lshared": 2,
          "spectral_fused": 4}

#: the fused pipeline's f32 transform stages (truncated DFT + inverse)
#: accumulate over prod(spatial) elements; 32·ε_f32 per magnitude unit
#: covers them at every shape the suite and tuner exercise
FUSED_F32_C = 32


def storage_eps(dtype: str) -> float:
    """Grid spacing ε of the storage dtype ("bfloat16", "float16", ...)."""
    return FORMAT_EPS[dtype]


def _c(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _rounded(arr, dtype: str):
    """Round an operand onto the storage grid the kernel will use, through
    f32 as the reference rounds it (identity when it already lives
    there); returns f32 numpy."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.float32)))
    return t.to(getattr(torch, dtype)).float().numpy()


def _numpy(ops):
    """The operands as f32 numpy (half values are exact in f32)."""
    return [t.detach().float().cpu().numpy() for t in ops]


def reference(cand: Candidate, ops) -> tuple:
    """(exact complex reference, magnitude contraction M) for the
    candidate's operands (numpy) — computed at complex128 from the same
    storage-rounded values the kernel consumes, so the elementwise budget
    charges only the kernel's own stages."""
    family, dtype = cand.family, cand.dtype
    if family in ("dense", "dense-fused"):
        xr, xi, wr, wi = ops
        if family == "dense-fused":
            xr, xi, wr, wi = (_rounded(a, dtype) for a in (xr, xi, wr, wi))
        x, w = _c(xr, xi), _c(wr, wi)
        ref = np.einsum("bim,iom->bom", x, w, optimize=True)
        mag = np.einsum("bim,iom->bom", np.abs(x), np.abs(w), optimize=True)
    elif family == "cp":
        xr, xi, uir, uii, uor, uoi, wr, wi = ops
        x, ui, uo, w = _c(xr, xi), _c(uir, uii), _c(uor, uoi), _c(wr, wi)
        t = np.einsum("bim,ir->bmr", x, ui, optimize=True)
        u = t * np.transpose(w)[None]
        ref = np.einsum("bmr,or->bom", u, uo, optimize=True)
        tm = np.einsum("bim,ir->bmr", np.abs(x), np.abs(ui), optimize=True)
        mag = np.einsum("bmr,or->bom",
                        tm * np.abs(np.transpose(w))[None], np.abs(uo), optimize=True)
    elif family == "lshared":
        xr, xi, wr, wi = ops
        x, w = _c(xr, xi), _c(wr, wi)
        ref = np.einsum("bilm,iol->bolm", x, w, optimize=True)
        mag = np.einsum("bilm,iol->bolm", np.abs(x), np.abs(w), optimize=True)
    elif family == "spectral_fused":
        return _fused_reference(cand, ops)
    else:
        raise ValueError(f"unknown kernel family {family!r}")
    return ref, mag


def _apply_factor(a, f, axis, f_axis):
    return np.moveaxis(np.tensordot(a, f, axes=[[axis], [f_axis]]), -1, axis)


def _fused_reference(cand: Candidate, ops) -> tuple:
    """Composed f64 reference for the fused pipeline, from the same
    storage-rounded spectrum/weights the kernel contracts, with the
    magnitude ``M`` composed through the absolute factor matrices — the
    per-element Thm 3.2 envelope of the whole rFFT→contract→irFFT chain,
    not of one stage."""
    x, wgr, wgi = (np.asarray(a, np.float64) for a in ops)
    B, I, O, spatial, modes = fused_axes(cand.shape)
    ndim = len(modes)
    facs = fused_factors(spatial, modes)
    fwd = [(facs[2 * k], facs[2 * k + 1]) for k in range(ndim)]
    inv = [(facs[2 * ndim + 2 * k], facs[2 * ndim + 2 * k + 1])
           for k in range(ndim)]

    a = x.astype(np.complex128)
    mag_a = np.abs(x)
    for k, (fr, fi) in enumerate(fwd):
        F = fr + 1j * fi
        a = _apply_factor(a, F, 2 + k, 1)
        mag_a = _apply_factor(mag_a, np.abs(F), 2 + k, 1)
    ah = a.reshape(B, I, -1)
    mag_ah = mag_a.reshape(B, I, -1)
    if cand.dtype != "float32":
        ah = (_rounded(ah.real, cand.dtype)
              + 1j * _rounded(ah.imag, cand.dtype))
        wgr = _rounded(wgr, cand.dtype)
        wgi = _rounded(wgi, cand.dtype)
    w = wgr + 1j * wgi
    yh = np.einsum("bim,iom->bom", ah, w, optimize=True)
    mag_yh = np.einsum("bim,iom->bom", mag_ah, np.abs(w), optimize=True)
    rows = fused_rows(spatial, modes)
    yh = yh.reshape(B, O, *rows)
    mag_yh = mag_yh.reshape(B, O, *rows)
    for k in range(ndim - 1):
        G = inv[k][0] + 1j * inv[k][1]
        yh = _apply_factor(yh, G, 2 + k, 0)
        mag_yh = _apply_factor(mag_yh, np.abs(G), 2 + k, 0)
    cr, ci = inv[-1]
    ax = 2 + ndim - 1
    ref = (_apply_factor(yh.real, cr, ax, 0)
           + _apply_factor(yh.imag, ci, ax, 0))
    mag = _apply_factor(mag_yh, np.abs(cr) + np.abs(ci), ax, 0)
    return ref, mag


def run_forward(cand: Candidate, ops, device) -> np.ndarray:
    """The port's forward of the candidate on ``device`` at its tiles
    (the kernels on a card, the plain versions on the CPU), as float64
    numpy: real for the fused layer, complex for the contractions."""
    ops = [t.to(device) for t in ops]
    with torch.no_grad():
        if cand.family in ("spectral_fused", "lshared"):
            out = forward(cand, ops)
        elif cand.family in ("dense", "dense-fused"):
            # the kernels take f32 operands and round them as they load
            # them; "dense" operands already lie on the grid, so rounding
            # them again is exact
            half = None if cand.dtype == "float32" else getattr(torch, cand.dtype)
            out = DenseContract.apply(*(t.float().contiguous() for t in ops), half,
                                      half or torch.float32)
        elif cand.family == "cp":
            out = CPContract.apply(*ops)
        else:
            raise ValueError(f"unknown kernel family {cand.family!r}")
    if isinstance(out, tuple):
        return _c(out[0].float().cpu().numpy(), out[1].float().cpu().numpy())
    return out.double().cpu().numpy()


def check(cand: Candidate, *, device=None, seed: int = 0,
          perturb: float = 0.0) -> dict:
    """Run the candidate's forward and gate it against the float64 oracle.
    Returns {passed, max_err, budget_min, worst_excess}."""
    from repro_torch.device import resolve_device

    ops = make_operands(cand.family, cand.shape, cand.dtype, seed=seed)
    got = run_forward(cand, ops, resolve_device(device))
    ref, mag = reference(cand, _numpy(ops))
    eps = storage_eps(cand.dtype)
    f32_c = FUSED_F32_C if cand.family == "spectral_fused" else 32
    budget = (STAGES[cand.family] * prec_upper_bound(eps, mag)
              + f32_c * F32_EPS * mag + ATOL)
    if perturb:
        # seeded violation: shift the output by perturb×budget so any
        # |perturb| > 1 must trip the gate everywhere
        got = got + perturb * budget
    diff = np.abs(got - ref)
    excess = float((diff - budget).max())
    result = {
        "passed": bool(np.all(diff <= budget)),
        "max_err": float(diff.max()),
        "budget_min": float(budget.min()),
        "worst_excess": excess,
    }
    if not result["passed"]:
        from repro_torch.obs import oracle_reject

        from .cache import entry_key

        oracle_reject(
            f"{entry_key(cand.family, cand.shape, cand.dtype)}"
            f"|b{cand.block_fwd}x{cand.block_bwd}",
            max_err=result["max_err"], budget_min=result["budget_min"],
            worst_excess=excess)
    return result
