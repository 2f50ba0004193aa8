"""Empirical certification of the paper's precision bounds.

Runs a mixed-precision FNO forward on GRF or Darcy inputs with the
telemetry taps live, then checks site by site that the *measured*
quantisation error stays under its Theorem 3.2 budget ``4 ε M``, with
``M`` the *observed* amax at that site, and that the end-to-end precision
error is a small fraction of the Theorem 3.1 discretisation bound at the
input grid.  The output is a JSON report, ``{"reports": [...]}``.

Also holds the closed-form-versus-measured helpers of the paper's Fig. 7:
:func:`random_fourier_field` builds Darcy-like smooth random fields with
analytic sup-norm and Lipschitz bounds, and :func:`theory_rows` tabulates
measured discretisation and precision errors against the Thm 3.1/3.2
bounds.

Entry points run on the GPU unless given a device::

    PYTHONPATH=src python -m repro_torch.autoprec.certify \\
        --policies mixed_fno_bf16 mixed_fno_fp16 --auto \\
        --resolution 24 --batch 2 [--device cpu] [--out build/autoprec_certify.json]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import theory
from repro_torch.core.precision import FORMAT_EPS, precision_system_for
from repro_torch.device import DeviceLike, resolve_device

from .controller import AutoPrecisionController
from .telemetry import SiteWindow, TelemetryAggregator, TraceCollector, collecting, fmt_of

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "autoprec_certify.json"


# ---------------------------------------------------------------------------
# Inputs and instrumented runs
# ---------------------------------------------------------------------------


def tiny_fno(n_layers: int = 2, hidden: int = 16, modes: Tuple[int, ...] = (8, 8),
             device: DeviceLike = None):
    """A small FNO whose spectral sites are representative but cheap, on
    ``device`` (CUDA unless the caller names another).  Returns
    ``(cfg, model)``."""
    from repro_torch.models import FNOConfig, init_fno

    cfg = FNOConfig(in_channels=1, out_channels=1, hidden_channels=hidden,
                    lifting_channels=hidden, projection_channels=hidden,
                    n_layers=n_layers, modes=modes)
    return cfg, init_fno(torch.Generator().manual_seed(7), cfg, device=device)


def sample_inputs(source: str, resolution: int, batch: int, seed: int = 0,
                  device: DeviceLike = None) -> np.ndarray:
    """Unit-normalised input fields (B, 1, n, n), f32 host arrays, from a
    GRF or the Darcy sampler (whose CG solve runs on ``device``)."""
    gen = torch.Generator().manual_seed(seed)
    if source == "grf":
        from repro_torch.data import grf_2d

        g = grf_2d(gen, resolution, alpha=2.5, tau=3.0, batch=batch).numpy()
        g = g / (np.abs(g).max() + 1e-12)
        return g[:, None].astype(np.float32)
    if source == "darcy":
        from repro_torch.data import sample_darcy_batch

        a, _ = sample_darcy_batch(gen, resolution, batch, maxiter=200, device=device)
        return a.cpu().numpy().astype(np.float32)
    raise ValueError(f"unknown source {source!r}; have grf | darcy")


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def instrumented_apply(policy, model, x):
    """One forward of ``model`` on ``x`` (array-like, moved to the model's
    device) with telemetry live.  Returns ``(y, totals)``: the output as
    an f32 host array and the tap sites' host :class:`SiteWindow`
    aggregates."""
    from repro_torch.models import fno_apply

    col = TraceCollector()
    with collecting(col):
        y = fno_apply(model, torch.as_tensor(x, dtype=torch.float32).to(_device_of(model)),
                      policy)
    agg = TelemetryAggregator()
    agg.update(col.snapshot())
    return y.float().cpu().numpy(), agg.totals


# ---------------------------------------------------------------------------
# Certification
# ---------------------------------------------------------------------------


def _site_row(site: str, w: SiteWindow, policy) -> dict:
    sp = policy.at(site)
    fmt = fmt_of(sp)
    eps = FORMAT_EPS[fmt]
    budget = theory.prec_upper_bound(eps, M=w.amax)
    row = {
        "fmt": fmt,
        "demoted": fmt != "float32",
        "eps": eps,
        "amax": w.amax,
        "overflow": w.overflow,
        "underflow": w.underflow,
        "qerr_measured": w.qerr,
        "prec_budget": budget,  # Thm 3.2: 4 ε M with M the observed amax
    }
    # only quantising taps measure a qerr; pass-through taps (contract
    # inputs, fft_out storage) certify on their range counters alone
    row["checked"] = w.qerr > 0.0 or not row["demoted"]
    row["within"] = bool(w.qerr <= budget) and w.overflow == 0
    return row


@torch.no_grad()
def certify_policy(policy, cfg=None, model=None, x=None, *, resolution: int = 32,
                   batch: int = 4, source: str = "grf", seed: int = 0, omega: float = 1.0,
                   device: DeviceLike = None) -> dict:
    """Certify one policy: measured per-site precision error against the
    Thm 3.2 budgets, end-to-end precision error against the Thm 3.1 bound.
    ``model`` defaults to :func:`tiny_fno` on ``device``; ``x`` to
    :func:`sample_inputs`."""
    from repro_torch.models import fno_apply
    from repro_torch.precision import FULL

    if cfg is None or model is None:
        cfg, model = tiny_fno(device=device)
    if x is None:
        x = sample_inputs(source, resolution, batch, seed, device=_device_of(model))
    x = np.asarray(x, np.float32)
    y_ref = fno_apply(model, torch.from_numpy(x).to(_device_of(model)),
                      FULL).float().cpu().numpy()
    y_pol, totals = instrumented_apply(policy, model, x)

    sites = {s: _site_row(s, w, policy) for s, w in sorted(totals.items())}
    demoted = [s for s, r in sites.items() if r["demoted"]]

    diff = y_pol - y_ref
    ref_norm = float(np.sqrt((y_ref ** 2).sum()) + 1e-12)
    L, M = theory.estimate_lipschitz_and_bound(x[0, 0])
    n = int(np.prod(x.shape[2:]))
    d = x.ndim - 2
    disc_bound = theory.disc_upper_bound(n, d, omega, L, M)
    end_to_end = {
        "prec_rel_l2": float(np.sqrt((diff ** 2).sum()) / ref_norm),
        "prec_abs_max": float(np.abs(diff).max()),
        "disc_upper_bound": disc_bound,
        "prec_fraction_of_disc": float(np.abs(diff).max() / disc_bound)
        if disc_bound > 0 else None,
        "field_L": L,
        "field_M": M,
        "grid_points": n,
    }
    return {
        "policy": policy.name,
        "source": source,
        "resolution": resolution,
        "batch": int(x.shape[0]),
        "sites": sites,
        "demoted_sites": demoted,
        "all_within": all(r["within"] for r in sites.values()),
        "end_to_end": end_to_end,
    }


def certify_controller(controller: AutoPrecisionController, *, rounds: int = 4,
                       resolution: int = 32, batch: int = 4, source: str = "grf",
                       seed: int = 0, cfg=None, model=None, x=None,
                       device: DeviceLike = None) -> dict:
    """Drive a controller with live telemetry for a few rounds, then
    certify the policy it converged to; the report carries its decisions.
    ``model`` and ``x`` default as in :func:`certify_policy`."""
    if cfg is None or model is None:
        cfg, model = tiny_fno(device=device)
    if x is None:
        x = sample_inputs(source, resolution, batch, seed, device=_device_of(model))
    for r in range(rounds):
        _, totals = instrumented_apply(controller.policy(), model, x)
        # each instrumented run is one telemetry window for the controller
        controller.update(totals, grid_points=resolution ** 2, step=r)
    report = certify_policy(controller.policy(), cfg, model, x, resolution=resolution,
                            source=source, seed=seed)
    report["controller"] = controller.describe()
    return report


# ---------------------------------------------------------------------------
# Closed-form-versus-measured helpers (the paper's Fig. 7)
# ---------------------------------------------------------------------------


def random_fourier_field(seed: int, d: int = 2, max_wavenumber: float = 3.0,
                         n_modes: int = 24, decay: float = 2.0):
    """A Darcy-like smooth random field as a callable on arbitrary points
    (what ``theory.disc_error`` needs), with analytic bounds.

    ``v(x) = Σ_k a_k cos(2π k·x + φ_k)`` over continuous random wavevectors
    ``|k|_∞ <= max_wavenumber`` with GRF-style power-law amplitudes.
    Non-integer frequencies keep the field non-periodic on the unit cell,
    so the lattice Riemann sum carries the Thm 3.1 ``n^{-1/d}`` error.
    Returns ``(v, L_bound, M_bound)``: ``M_bound = Σ|a_k|`` bounds the sup
    norm and ``L_bound = Σ|a_k|·2π|k|_2`` the Lipschitz constant.
    """
    rng = np.random.RandomState(seed)
    K = rng.uniform(-max_wavenumber, max_wavenumber, size=(n_modes, d))
    amps = rng.randn(n_modes) * (1.0 + np.linalg.norm(K, axis=-1)) ** (-decay)
    phases = rng.uniform(0, 2 * np.pi, size=n_modes)

    def v(xi: np.ndarray) -> np.ndarray:
        # xi: (N, d) points in [0,1]^d
        phase = 2.0 * np.pi * xi @ K.T + phases[None, :]
        return (np.cos(phase) * amps[None, :]).sum(axis=-1)

    M_bound = float(np.abs(amps).sum())
    L_bound = float((np.abs(amps) * 2.0 * np.pi * np.linalg.norm(K, axis=-1)).sum())
    return v, L_bound, M_bound


def measured_prec_error(v, m: int, d: int, omega: float, fmt: str) -> float:
    """Eq. (2) measured for a named format: numpy's cast where one exists
    (fp16), the paper's (a0, ε, T)-system quantiser otherwise."""
    if fmt == "float16":
        return theory.prec_error(v, m, d, omega, dtype="float16")
    return theory.prec_error(v, m, d, omega, q=precision_system_for(fmt))


def theory_rows(seed: int = 0, d: int = 2, m_values: Tuple[int, ...] = (6, 10, 16, 24),
                formats: Tuple[str, ...] = ("float16", "bfloat16", "fp8_e4m3", "fp8_e5m2"),
                omega: float = 1.0) -> List[dict]:
    """Fig. 7's data: measured discretisation and precision errors against
    the closed-form bounds on a Darcy-like random field, per mesh size and
    format."""
    v, L, M = random_fourier_field(seed, d=d)
    rows = []
    for m in m_values:
        n = m ** d
        row = {
            "m": m, "n": n, "d": d, "omega": omega,
            "disc_measured": theory.disc_error(v, m, d, omega),
            "disc_upper": theory.disc_upper_bound(n, d, omega, L, M),
            "disc_lower": theory.disc_lower_bound(n, d, M),
            "prec": {},
        }
        for fmt in formats:
            row["prec"][fmt] = {
                "measured": measured_prec_error(v, m, d, omega, fmt),
                "upper": theory.prec_upper_bound(FORMAT_EPS[fmt], M),
            }
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def write_report(reports: List[dict], path, device=None) -> None:
    """``{"reports": reports}`` at ``path`` with the shared result header
    under ``"meta"`` (``repro_torch.obs.write_result``: atomic, its
    directory made); ``device``: the one the reports ran on."""
    from repro_torch.obs import write_result

    write_result(path, {"reports": reports},
                 **({} if device is None else {"device": str(device)}))


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.precision import get_policy

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--policies", nargs="*", default=["mixed_fno_bf16", "mixed_fno_fp16"])
    ap.add_argument("--auto", action="store_true",
                    help="also certify an AutoPrecisionController-derived policy "
                         "(base=full, telemetry-driven)")
    ap.add_argument("--resolution", type=int, default=24)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--source", default="grf", choices=["grf", "darcy"])
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    reports = []
    for name in args.policies:
        reports.append(certify_policy(get_policy(name), resolution=args.resolution,
                                      batch=args.batch, source=args.source, device=dev))
    if args.auto:
        ctl = AutoPrecisionController(base="full", grid_points=args.resolution ** 2,
                                      demote_patience=1, cooldown=0)
        reports.append(certify_controller(ctl, resolution=args.resolution, batch=args.batch,
                                          source=args.source, device=dev))

    write_report(reports, args.out, dev)
    bad = 0
    for rep in reports:
        ok = rep["all_within"]
        bad += not ok
        print(f"{rep['policy']:<24s} demoted={len(rep['demoted_sites']):2d} "
              f"prec/disc={rep['end_to_end']['prec_fraction_of_disc']} "
              f"{'CERTIFIED' if ok else 'VIOLATION'}")
    print(f"report -> {args.out}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
