"""Site-addressed runtime numerics taps (the measurement half of autoprec).

The paper bounds precision error by ``4 ε M`` (Thm 3.2), ``M`` the
sup-norm of what actually flows through a site: a *runtime* quantity the
static rule tables never see.  This module measures it:

* ``tap(site, x, fmt=..., quantized=...)``: called from the precision
  helpers (``SitePrecision.quantize`` / ``.contract``), the contraction
  wrappers of ``kernels.ops`` and the FFT outputs.  Without an active
  collector it returns before touching ``x``.  With one, it records a
  :class:`SiteStats` of device tensors: amax, an exponent-bucket
  histogram, overflow / underflow counts against the site's format and
  the measured quantisation error ``max|q(x) − x|`` (the empirical Thm
  3.2 quantity).  It runs under ``torch.no_grad()`` on detached tensors:
  nothing joins the autograd graph and nothing is kept alive but the
  stats.  Only forwards tap; no autograd Function's backward reaches it.
* ``TraceCollector`` + ``collecting(col)``: a thread-local, scoped
  registry.  The pattern every consumer uses::

      col = TraceCollector()
      with collecting(col):
          loss = loss_fn(model, batch, policy)
      snapshot = col.snapshot()      # {site: SiteStats} on the device

* ``TelemetryAggregator``: host-side accumulation of step snapshots,
  moved to the host in one transfer a step, with a *window* view (stats
  since the controller last looked) feeding
  :mod:`repro_torch.autoprec.controller` and JSON ``counters`` for engine
  ``stats()`` and reports.

The arithmetic is the reference's (``repro.autoprec.telemetry``): each
real part of a complex tensor reduces separately; the distributional
counters read the strided C-order subsample ``p.reshape(-1)[::stride]``
and scale their f32 sums by ``size / subsample size`` rounded to f32;
the histogram bucket is ``floor(log2(x))`` in f32.  Sites are the rule
tables' strings (``fno/layer2/spectral/fft_in``, ...), so telemetry,
control and certification speak one address space.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.precision import FORMAT_MAX, FORMAT_TINY, dtype_name

#: Exponent-bucket histogram range: bucket ``i`` counts magnitudes in
#: ``[2^(EXP_MIN+i), 2^(EXP_MIN+i+1))``; the first and last buckets clamp.
EXP_MIN = -24
EXP_MAX = 16
N_BUCKETS = EXP_MAX - EXP_MIN

#: The distributional counters (histogram, overflow / underflow counts)
#: read a strided subsample of at least ``HIST_STRIDE`` and at most
#: ``HIST_MAX_SAMPLES`` elements a part: they are consumed as fractions.
#: amax and qerr read every element, and overflow *detection* is exact
#: whatever the stride: an out-of-range value drives amax out of range.
HIST_STRIDE = 16
HIST_MAX_SAMPLES = 1 << 16


class SiteStats(NamedTuple):
    """One site's numerics for one step: 0-d f32 device tensors, a
    (N_BUCKETS,) f32 histogram, and the component count ``n`` as a host
    f32 (the shapes are known on the host).

    ``overflow`` counts values whose magnitude exceeds the format's largest
    finite value (or is not finite); ``underflow`` non-zero values below
    its smallest normal.  Both are subsample estimates, but any overflow
    makes the counter non-zero through the exact amax.  ``qerr`` is
    ``max|q(x) − x|`` where a quantiser ran, else 0.
    """

    amax: torch.Tensor
    qerr: torch.Tensor
    n: np.float32
    overflow: torch.Tensor
    underflow: torch.Tensor
    hist: torch.Tensor


def _parts(x) -> tuple:
    """The real components of ``x``, detached, as separate tensors: a
    complex tensor's (or a ``ComplexPair``'s) real and imaginary parts,
    each in its own C-order layout."""
    if hasattr(x, "re") and hasattr(x, "im"):
        return (x.re.detach(), x.im.detach())
    x = x.detach()
    if torch.is_complex(x):
        return (x.real, x.imag)
    return (x,)


def fmt_of(sp) -> str:
    """The format name a :class:`~repro_torch.precision.SitePrecision`
    quantises onto (what its overflow / underflow thresholds are)."""
    if sp.quantize_fmt is not None and sp.quantize_fmt != "half":
        return sp.quantize_fmt
    if sp.compute is None:
        return "float32"
    return dtype_name(sp.compute)


def _f32(v: float) -> float:
    """``v`` rounded to f32: the reference's weak-typed Python scalars
    multiply f32 arrays at f32."""
    return float(np.float32(v))


@torch.no_grad()
def site_stats(x, fmt: Optional[str] = None, quantized=None,
               with_hist: bool = True, hist_stride: int = HIST_STRIDE) -> SiteStats:
    """Measure one tensor against a format's thresholds."""
    fmt = fmt or "float32"
    fmax = FORMAT_MAX.get(fmt, float("inf"))
    tiny = FORMAT_TINY.get(fmt, 0.0)
    parts = _parts(x)
    dev = parts[0].device
    amax = torch.zeros((), dtype=torch.float32, device=dev)
    overflow = torch.zeros((), dtype=torch.float32, device=dev)
    underflow = torch.zeros((), dtype=torch.float32, device=dev)
    hist = torch.zeros(N_BUCKETS, dtype=torch.float32, device=dev)
    n = 0
    for p in parts:
        size = p.numel()
        mag = p.float().abs()
        n += size
        if size:
            amax = torch.maximum(amax, mag.amax())
        stride = max(1, hist_stride, -(-size // HIST_MAX_SAMPLES))
        sub = mag.reshape(-1)[::stride]
        scale = _f32(size / max(sub.numel(), 1))
        # NaN and inf fail `sub <= fmax` too, so non-finite values count once
        overflow = overflow + (~(sub <= fmax)).sum(dtype=torch.float32) * scale
        underflow = underflow + ((sub > 0) & (sub < tiny)).sum(dtype=torch.float32) * scale
        if with_hist:
            nz = sub > 0
            e = torch.floor(torch.log2(torch.where(nz, sub, 1.0)))
            idx = torch.clamp(e - EXP_MIN, 0, N_BUCKETS - 1).to(torch.int64)
            # zero and NaN magnitudes go to a spare bucket that is dropped
            idx = torch.where(nz, idx, N_BUCKETS)
            counts = torch.zeros(N_BUCKETS + 1, dtype=torch.float32, device=dev)
            counts.index_add_(0, idx, torch.ones_like(sub))
            hist = hist + counts[:N_BUCKETS] * scale
    overflow = torch.maximum(overflow, (~(amax <= fmax)).float())
    qerr = torch.zeros((), dtype=torch.float32, device=dev)
    if quantized is not None:
        for p, q in zip(parts, _parts(quantized), strict=True):
            if p.numel():
                qerr = torch.maximum(qerr, (q.float() - p.float()).abs().amax())
    return SiteStats(amax=amax, qerr=qerr, n=np.float32(n), overflow=overflow,
                     underflow=underflow, hist=hist)


def merge_stats(a: SiteStats, b: SiteStats) -> SiteStats:
    return SiteStats(
        amax=torch.maximum(a.amax, b.amax),
        qerr=torch.maximum(a.qerr, b.qerr),
        n=np.float32(a.n + b.n),
        overflow=a.overflow + b.overflow,
        underflow=a.underflow + b.underflow,
        hist=a.hist + b.hist,
    )


def stack_snapshots(snapshots: List[Dict[str, SiteStats]]) -> Dict[str, SiteStats]:
    """Per-microbatch snapshots (one site set) stacked on a leading axis,
    the layout :func:`merge_stacked` reduces."""
    return {site: SiteStats(*(np.stack(f) if i == 2 else torch.stack(f)
                              for i, f in enumerate(zip(*(s[site] for s in snapshots)))))
            for site in snapshots[0]}


def merge_stacked(snapshot: Dict[str, SiteStats]) -> Dict[str, SiteStats]:
    """Reduce a snapshot whose leaves carry a leading stacking axis (one
    row per microbatch) to per-site totals."""
    return {
        site: SiteStats(
            amax=s.amax.amax(0), qerr=s.qerr.amax(0),
            n=np.sum(s.n, axis=0, dtype=np.float32),
            overflow=s.overflow.sum(0), underflow=s.underflow.sum(0),
            hist=s.hist.sum(0),
        )
        for site, s in snapshot.items()
    }


# ---------------------------------------------------------------------------
# Scoped collection
# ---------------------------------------------------------------------------


class TraceCollector:
    """Accumulates per-site stats for one step.  Repeated taps at one site
    (the corner blocks of a layer) merge in place."""

    def __init__(self, with_hist: bool = True, hist_stride: int = HIST_STRIDE):
        self.with_hist = with_hist
        self.hist_stride = hist_stride
        self._sites: Dict[str, SiteStats] = {}

    def record(self, site: str, stats: SiteStats) -> None:
        prev = self._sites.get(site)
        self._sites[site] = stats if prev is None else merge_stats(prev, stats)

    def snapshot(self) -> Dict[str, SiteStats]:
        """The collected stats, sorted by site."""
        return dict(sorted(self._sites.items()))


_local = threading.local()


def current_collector() -> Optional[TraceCollector]:
    return getattr(_local, "collector", None)


def telemetry_active() -> bool:
    """True while a collector is in scope.  The fused spectral dispatch
    consults it: the fused kernels never write the spectrum the per-stage
    taps read, so a layer runs staged while telemetry is on."""
    return current_collector() is not None


@contextmanager
def collecting(col: TraceCollector):
    """Scope ``col`` as the active collector (thread-local, re-entrant: an
    inner scope shadows the outer one)."""
    prev = current_collector()
    _local.collector = col
    try:
        yield col
    finally:
        _local.collector = prev


def tap(site: str, x, fmt: Optional[str] = None, quantized=None) -> None:
    """Record numerics for ``site`` if a collector is active.

    ``x`` is the *pre-quantisation* tensor (so overflow counters see the
    values a narrowing cast would destroy); ``quantized`` optionally gives
    the post-quantisation tensor for the measured ``qerr``.  Without a
    collector it does nothing at all.
    """
    col = current_collector()
    if col is None:
        return
    col.record(site, site_stats(x, fmt=fmt, quantized=quantized, with_hist=col.with_hist,
                                hist_stride=col.hist_stride))


# ---------------------------------------------------------------------------
# Host-side aggregation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SiteWindow:
    """Host-side accumulation of one site's stats over some steps."""

    updates: int = 0             # snapshots merged
    amax: float = 0.0            # max over the window
    qerr: float = 0.0            # max over the window
    n: float = 0.0               # component count (sum)
    overflow: float = 0.0        # count (sum)
    underflow: float = 0.0       # count (sum)
    overflow_updates: int = 0    # snapshots containing >= 1 overflow
    hist: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(N_BUCKETS))

    def merge(self, s: "SiteWindow") -> None:
        self.updates += s.updates
        self.amax = max(self.amax, s.amax)
        self.qerr = max(self.qerr, s.qerr)
        self.n += s.n
        self.overflow += s.overflow
        self.underflow += s.underflow
        self.overflow_updates += s.overflow_updates
        self.hist = self.hist + s.hist

    def fraction_below(self, threshold: float) -> float:
        """Fraction of the observed non-zero magnitudes below ``threshold``
        (from the exponent histogram; the candidate formats' underflow
        check)."""
        total = float(self.hist.sum())
        if total <= 0 or threshold <= 0:
            return 0.0
        cut = int(np.floor(np.log2(threshold))) - EXP_MIN
        cut = min(max(cut, 0), N_BUCKETS)
        return float(self.hist[:cut].sum()) / total

    def to_dict(self) -> dict:
        return {
            "updates": self.updates,
            "amax": self.amax,
            "qerr": self.qerr,
            "values": self.n,
            "overflow": self.overflow,
            "underflow": self.underflow,
            "overflow_updates": self.overflow_updates,
        }


def _windows_of(snapshot: Dict[str, SiteStats]) -> Dict[str, SiteWindow]:
    """One :class:`SiteWindow` per site, from one device-to-host transfer:
    every site's scalars and histogram are stacked into one tensor first."""
    sites = list(snapshot)
    rows = torch.stack([torch.cat([torch.stack([s.amax, s.qerr, s.overflow, s.underflow]),
                                   s.hist]) for s in snapshot.values()])
    host = rows.cpu().numpy()
    out = {}
    for site, row in zip(sites, host, strict=True):
        overflow = float(row[2])
        out[site] = SiteWindow(
            updates=1, amax=float(row[0]), qerr=float(row[1]), n=float(snapshot[site].n),
            overflow=overflow, underflow=float(row[3]), overflow_updates=int(overflow > 0),
            hist=row[4:].astype(np.float64))
    return out


class TelemetryAggregator:
    """Accumulates step snapshots on the host.

    Keeps run ``totals`` (for reports and engine ``stats()``) and a
    ``window`` that resets each time the controller consumes it through
    :meth:`take_window`.
    """

    def __init__(self):
        self.totals: Dict[str, SiteWindow] = {}
        self._window: Dict[str, SiteWindow] = {}
        self.steps = 0

    def update(self, snapshot: Dict[str, SiteStats]) -> None:
        if not snapshot:
            return
        self.steps += 1
        for site, w in _windows_of(snapshot).items():
            for store in (self.totals, self._window):
                if site in store:
                    store[site].merge(w)
                else:
                    store[site] = dataclasses.replace(w, hist=w.hist.copy())

    def window(self) -> Dict[str, SiteWindow]:
        return self._window

    def take_window(self) -> Dict[str, SiteWindow]:
        """The accumulated window, resetting it (the controller's cadence)."""
        out = self._window
        self._window = {}
        return out

    def counters(self) -> Dict[str, Any]:
        """JSON-friendly per-site counters and run-level totals."""
        sites = {s: w.to_dict() for s, w in sorted(self.totals.items())}
        return {
            "steps": self.steps,
            "overflow_total": sum(w.overflow for w in self.totals.values()),
            "underflow_total": sum(w.underflow for w in self.totals.values()),
            "sites": sites,
        }
