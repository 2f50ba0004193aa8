"""The persistent calibration cache: versioned JSON, atomic writes,
stale/corrupt detection, graceful fallback.

A calibration-state file is the durable output of ``python -m
repro_torch.tune tune`` and the input to every kernel-tile resolution in
``repro_torch.kernels.ops``.  The reference's schema (format version 1)::

    {
      "format_version": 1,
      "kernel_version": 91816677383177,  # KERNEL_VERSION at tune time
      "backend": "NVIDIA H100 80GB HBM3",  # the device's name, or "cpu"
      "entries": {
        "spectral_fused|8x64x64x128x128x32x32|bfloat16": {
          "family": "spectral_fused",    # lshared | spectral_fused
          "shape": [8, 64, 64, 128, 128, 32, 32],
          "dtype": "bfloat16",
          "backend": "NVIDIA H100 80GB HBM3",
          "kernel_version": 91816677383177,
          "block_fwd": 4,
          "block_bwd": 8,
          "wall_us": 560.1,         # median forward + backward of the winner
          "gbps": 190.2,            # bytes_moved / wall
          "roofline_fraction": 0.057,
          "interpret": false,       # true => timed on the CPU's plain versions
          "validated": true,        # passed the oracle's Thm 3.2 gate
          "max_err": 1.1e-3,        # worst |kernel - oracle| at admission
          "budget_min": 4.9e-3,     # the smallest elementwise budget
          "heuristic_fwd": 8, "heuristic_bwd": 8, "heuristic_wall_us": 570.3
        }, ...
      }
    }

Two fields mean the port's own things: ``backend`` is the device's name
(``torch.cuda.get_device_name()``, or ``"cpu"``), and ``kernel_version``
is ``repro_torch.kernels.spectral_contract.KERNEL_VERSION``, a digest of
the tuned kernels' sources, so a kernel PR stales the entries of the
families it touches by itself, a reference state read by the port is
stale, and a port state read by the reference is stale.

Consumers never read the file directly — they go through ``lookup``,
which enforces per-entry staleness (kernel-version bump, backend
mismatch) and structural sanity (power-of-two blocks) and falls back to
``None`` (→ static heuristic) on any defect; ``kernels.ops`` also
re-checks the tiles' legality at the running shape.  A bad calibration
file can therefore cost performance but never correctness or
availability: it changes a tile, never the device or the kernel.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from typing import Optional, Union

import torch

from repro_torch.kernels.spectral_contract import KERNEL_VERSION

#: schema version of the calibration-state file itself (distinct from
#: KERNEL_VERSION, which tracks the kernels being calibrated)
FORMAT_VERSION = 1

#: kernel families a calibration entry may address
FAMILIES = ("dense", "dense-fused", "cp", "lshared", "spectral_fused")

#: env var consulted by ``active_cache`` when nothing was activated
#: explicitly — the zero-plumbing way to point a whole process (trainer,
#: serve engines) at a calibration-state file.
ENV_VAR = "REPRO_CALIBRATION_STATE"


def backend_of(device=None) -> str:
    """The ``backend`` an entry is keyed by: the name of ``device``'s card,
    ``"cpu"`` for the CPU; ``None`` is the card when there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(device)


class CalibrationError(Exception):
    """A calibration-state file is unreadable or structurally invalid."""


def entry_key(family: str, shape, dtype: str) -> str:
    """The cache key: ``family|BxIxOx...|dtype`` — one entry per
    (kernel family, shape, dtype); backend and kernel version are
    checked per entry at lookup time."""
    return f"{family}|{'x'.join(str(int(s)) for s in shape)}|{dtype}"


def _is_pow2(n) -> bool:
    return isinstance(n, int) and n >= 1 and (n & (n - 1)) == 0


def _entry_ok(ent) -> bool:
    """Structural sanity of one entry — defensive against hand-edited or
    truncated files; anything off means 'treat as absent'."""
    return (
        isinstance(ent, dict)
        and ent.get("family") in FAMILIES
        and _is_pow2(ent.get("block_fwd"))
        and _is_pow2(ent.get("block_bwd"))
    )


@dataclasses.dataclass
class CalibrationCache:
    """An in-memory calibration state plus its lookup counters."""

    entries: dict
    kernel_version: int = KERNEL_VERSION
    backend: str = ""
    path: Optional[str] = None
    counters: dict = dataclasses.field(
        default_factory=lambda: {"hits": 0, "misses": 0, "stale": 0})

    def lookup(self, family: str, shape, dtype: str,
               backend: Optional[str] = None) -> Optional[dict]:
        """Return the validated entry for this key, or None.

        ``None`` means: no entry, a stale entry (tuned against a
        different kernel version or backend), a corrupt entry, or one
        that never passed oracle validation — in every case the caller
        falls back to the static heuristic.  ``backend``: the running
        device's (``backend_of``; None: the card when there is one).

        Each outcome lands in the numerics-event stream
        (``tile_cache_hit``/``miss``/``stale``) so a run timeline shows
        which resolutions got tuned tiles and which fell back.
        """
        from repro_torch.obs import tile_cache_event

        key = entry_key(family, shape, dtype)
        ent = self.entries.get(key)
        if ent is None:
            self.counters["misses"] += 1
            tile_cache_event("miss", family, key)
            return None
        if not _entry_ok(ent) or not ent.get("validated", False):
            self.counters["stale"] += 1
            tile_cache_event("stale", family, key)
            return None
        if ent.get("kernel_version") != KERNEL_VERSION:
            self.counters["stale"] += 1
            tile_cache_event("stale", family, key)
            return None
        if ent.get("backend") != (backend_of() if backend is None else backend):
            self.counters["stale"] += 1
            tile_cache_event("stale", family, key)
            return None
        self.counters["hits"] += 1
        tile_cache_event("hit", family, key)
        return ent

    def put(self, ent: dict) -> None:
        self.entries[entry_key(ent["family"], ent["shape"], ent["dtype"])] = ent

    def to_json(self) -> dict:
        return {
            "format_version": FORMAT_VERSION,
            "kernel_version": self.kernel_version,
            "backend": self.backend,
            "entries": self.entries,
        }


def load(path: Union[str, os.PathLike]) -> CalibrationCache:
    """Load a calibration-state file, raising ``CalibrationError`` on
    missing/corrupt/incompatible files (callers wanting silence use
    ``safe_load``)."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError as e:
        raise CalibrationError(f"calibration state not found: {path}") from e
    except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
        raise CalibrationError(
            f"calibration state {path} is unreadable/corrupt: {e}") from e
    if not isinstance(raw, dict) or not isinstance(raw.get("entries"), dict):
        raise CalibrationError(
            f"calibration state {path} has no 'entries' table")
    if raw.get("format_version") != FORMAT_VERSION:
        raise CalibrationError(
            f"calibration state {path} has format_version "
            f"{raw.get('format_version')!r}, expected {FORMAT_VERSION}")
    try:
        kernel_version = int(raw.get("kernel_version", -1))
    except (TypeError, ValueError):
        kernel_version = -1  # the header is informative; entries decide
    return CalibrationCache(
        entries=dict(raw["entries"]),
        kernel_version=kernel_version,
        backend=str(raw.get("backend", "")),
        path=os.fspath(path),
    )


def safe_load(path: Union[str, os.PathLike]) -> Optional[CalibrationCache]:
    """``load`` that degrades to a warning + None — the form every hot
    path uses, so a bad file can never take a trainer or engine down."""
    try:
        return load(path)
    except CalibrationError as e:
        warnings.warn(
            f"ignoring calibration state ({e}); kernel tiles fall back to "
            f"the static heuristics", stacklevel=2)
        return None


def save(cache: CalibrationCache, path: Union[str, os.PathLike]) -> str:
    """Atomic write: serialise to a temp file in the target directory,
    fsync, then ``os.replace`` — a crashed tune run leaves either the
    old state or the new one, never a torn file."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".calibration-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    cache.path = path
    return path


# ---------------------------------------------------------------------------
# Process-global activation
# ---------------------------------------------------------------------------
#
# Tile resolution happens on every call of a tuned wrapper deep inside
# model code, far from anything holding a cache handle — so the active
# cache is process state: either explicitly activated (trainer/engine
# construction, the CLI flag) or resolved lazily from
# $REPRO_CALIBRATION_STATE.

_ACTIVE: Optional[CalibrationCache] = None
_ACTIVE_EXPLICIT = False
#: (path, mtime) -> CalibrationCache memo for the env-var path, so the
#: per-call lookup never re-reads an unchanged file
_ENV_MEMO: dict = {}


def activate(target: Union[CalibrationCache, str, os.PathLike, None]):
    """Make ``target`` the process's calibration source.

    ``target`` may be a loaded ``CalibrationCache``, a path (loaded via
    ``safe_load`` — a bad file warns and deactivates), or ``None`` to
    deactivate explicit state (the env var takes over again).  Returns
    the previously active cache.
    """
    global _ACTIVE, _ACTIVE_EXPLICIT
    prev = _ACTIVE
    if target is None:
        _ACTIVE, _ACTIVE_EXPLICIT = None, False
    elif isinstance(target, CalibrationCache):
        _ACTIVE, _ACTIVE_EXPLICIT = target, True
    else:
        _ACTIVE, _ACTIVE_EXPLICIT = safe_load(target), True
    return prev


def active_cache() -> Optional[CalibrationCache]:
    """The cache kernel-tile resolution consults: the explicitly
    activated one if any, else the ``REPRO_CALIBRATION_STATE`` env file
    (memoised by path+mtime), else None."""
    if _ACTIVE_EXPLICIT:
        return _ACTIVE
    path = os.environ.get(ENV_VAR)
    if not path:
        return None
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        mtime = None
    key = (path, mtime)
    if key not in _ENV_MEMO:
        _ENV_MEMO.clear()  # hold at most the current file's parse
        _ENV_MEMO[key] = safe_load(path)
    return _ENV_MEMO[key]
