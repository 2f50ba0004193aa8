"""Kernel pass: checks over the launch plans of the port's spectral kernels.

The reference checks Pallas grids, BlockSpecs and VMEM estimators.  The
port's kernels are CUDA C++ launched through ``ctypes``; what Python
decides for a launch is its plan: the fused layer's batch tiles and their
scratch in the L2, ``ls_mix``'s splits, the CP and order-shared kernels'
resident or streamed factors and the shared memory those take.  So each
family's launchers are run under ``record_launches`` at the reference's
padding-exercising shapes and at the paths' shapes, in each operand
dtype, and every recorded launch is checked:

  no-kernel-traced (error)    a family recorded no launch: the recorder or
      the launcher is broken.
  index-oob (error)           a fused launch whose batch tile reaches rows
      outside [0, B) or takes more than 8 rows (the kernels keep a mode's
      rows of a tile in registers); an ``ls_mix`` launch whose splits are
      outside [1, ``ls_splits_max``].
  output-not-covered (error)  the fused launches of one call do not cover
      rows [0, B) exactly once.
  accum-discipline (error)    ``fused_bwd`` must take ``accumulate`` 0 on
      its first tile and 1 after: dw is summed across the tiles in the
      output itself.
  smem-over-limit (error)     a plan's shared memory (``_cp_fwd_smem``,
      ``_cp_bwd_smem``, ``_ls_smem``, ``fused_smem_bytes``) over
      ``SMEM_LIMIT``.
  l2-over-budget (error)      the fused scratch at the chosen batch tile
      over half the L2 (``L2_BUDGET // 2``, the room ``pick_block_b``
      leaves).
  smem-underestimate (error)  on the card only: a plan that reports fewer
      bytes than the library's own export (``spectral_contract_cp_fwd_smem``,
      ``_cp_bwd_smem``, ``spectral_contract_ls_smem``,
      ``spectral_fused_smem``), or ``SMEM_LIMIT`` above the card's opt-in
      shared memory per block (where its PyTorch reports it).

The dense kernels (``dense_fwd``, ``dense_bwd_x``, ``dense_bwd_w``) have
tiles fixed in their sources and grids from the SM count: Python plans
nothing for them, so they are checked for being traced only.

``calibration_pass`` (calibration-coverage) lints a ``repro_torch.tune``
calibration state the same way: every entry must be a tile the family's
rule admits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

from .findings import ERROR, Finding

#: pointer arguments of each launcher, before its int arguments (the
#: ``_bind`` signatures)
_POINTERS = {
    "spectral_contract_dense_fwd": 6, "spectral_contract_dense_bwd_x": 6,
    "spectral_contract_dense_bwd_w": 6, "spectral_contract_cp_fwd": 10,
    "spectral_contract_cp_bwd": 19, "spectral_contract_ls_fwd": 6,
    "spectral_contract_ls_bwd_x": 6, "spectral_contract_ls_bwd_w": 6,
    "spectral_fused_fwd": 6, "spectral_fused_bwd": 9, "rmsnorm_fwd": 3,
    "flash_attention_fwd": 4,
}
#: the C interface's format codes -> bytes per element
_SIZE = {0: 4, 1: 2, 2: 2}
_LOADERS = ("_library", "_library_bwd", "_library_cp", "_library_ls", "_library_fused")


@dataclasses.dataclass
class KernelLaunch:
    """One recorded launch: the kernel, its int arguments (after its
    pointers; floats too, for the LM kernels), what it reads and writes."""

    name: str
    ints: Tuple
    io: object


class _NoLibrary:
    """Stands in for a kernel library on the CPU: a launcher's queries (the
    CP backward's workspace size) answer 0, and nothing launches."""

    def __getattr__(self, _name):
        return _answer_zero


def _answer_zero(*_args) -> int:
    return 0


@contextlib.contextmanager
def record_launches(device) -> Iterator[List[KernelLaunch]]:
    """Record every launch of ``kernels.spectral_contract``'s launchers.

    The launchers resolve ``_call`` and the ``_library*`` loaders as module
    globals when they run, so swapping those reaches them all.  On the CPU
    the recorder only records and the loaders hand out a library that
    launches nothing, so the launchers plan their launches on CPU tensors
    with no card; on a card it records and delegates to the real launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels import spectral_contract as sc

    on_card = torch.device(device).type == "cuda"
    records: List[KernelLaunch] = []
    orig_call = sc._call
    orig_loaders = {name: getattr(sc, name) for name in _LOADERS}

    def recording(fn, name, dev, *args, io=None):
        records.append(KernelLaunch(name, tuple(args[_POINTERS[name]:]), io))
        if on_card:
            build._call(fn, name, dev, *args, io=io)

    sc._call = recording
    if not on_card:
        nolib = _NoLibrary()
        for name in _LOADERS:
            setattr(sc, name, lambda nolib=nolib: nolib)
    try:
        yield records
    finally:
        sc._call = orig_call
        for name, fn in orig_loaders.items():
            setattr(sc, name, fn)


# ---------------------------------------------------------------------------
# The families and their traces
# ---------------------------------------------------------------------------

#: the reference's padding-exercising shapes (``repro.analyze.kernels``):
#: dense (B, I, O, M), CP (B, I, O, R, M), order-shared (B, I, O, L, M),
#: fused (B, I, O, spatial, modes): 3 rows in tiles of 2, odd modes
REFERENCE_SHAPES = {
    "dense": (2, 8, 8, 40), "cp": (2, 8, 8, 4, 40), "lshared": (2, 8, 8, 12, 9),
    "spectral_fused": ((3, 4, 4, (8, 8), (3, 3)),),
}
#: the paths' shapes (``chip_smoke.py``'s ``PATH_SHAPE``, ``CP_PATH_SHAPE``,
#: ``LS_PATH_SHAPE`` and ``FUSED_SHAPES``): every dense, CP and order-shared
#: launch on the FNO_DARCY, TFNO_NS and SFNO_SWE paths, and the fused layer at
#: 128², 421², GINO_CAR's latent FNO and a 1-d shape that keeps its Nyquist row
PATH_SHAPES = {
    "dense": (8, 64, 64, 1024), "cp": (8, 64, 64, 64, 42 * 42),
    "lshared": (8, 64, 64, 128, 128),
    "spectral_fused": ((8, 64, 64, (128, 128), (32, 32)), (8, 64, 64, (421, 421), (32, 32)),
                       (2, 64, 64, (32, 32, 32), (12, 12, 12)), (3, 5, 7, (30,), (16,))),
}
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: the fused kernels' (cast_to, sim_fmt) modes on the paths
_FUSED_MODES = ((None, None), (torch.bfloat16, None), (torch.float16, None),
                (torch.float16, "fp8_e4m3"))


@dataclasses.dataclass
class FamilyTrace:
    """The launches of one family's call at one shape and dtype."""

    family: str
    shape: Tuple
    dtype: str
    launches: List[KernelLaunch]

    @property
    def where(self) -> str:
        flat = []
        for s in self.shape:
            flat.extend(s if isinstance(s, tuple) else (s,))
        return f"{self.family}@{'x'.join(map(str, flat))}/{self.dtype}"


def _operands(device, gen):
    """Operands on ``device``: random on a card (the launches run), empty on
    the CPU (nothing reads them)."""
    on_card = torch.device(device).type == "cuda"

    def make(shape, dtype=torch.float32):
        if on_card:
            return torch.randn(shape, generator=gen, device=device).to(dtype)
        return torch.empty(shape, dtype=dtype, device=device)

    return make


def _name(dtype) -> str:
    return "float32" if dtype is None else str(dtype).removeprefix("torch.")


def trace_families(device: DeviceLike = None,
                   shapes: Sequence[Dict] = (REFERENCE_SHAPES, PATH_SHAPES)) -> List[FamilyTrace]:
    """Every family's launchers at ``shapes`` in each of its modes, one
    ``FamilyTrace`` per call (a forward, or one backward direction), on
    ``device`` (CUDA unless the caller names another)."""
    from repro_torch.kernels import spectral_contract as sc

    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    make = _operands(device, gen)
    traces: List[FamilyTrace] = []

    def run(family, shape, dtype, fn):
        with record_launches(device) as launches:
            fn()
        traces.append(FamilyTrace(family, shape, dtype, launches))

    for table in shapes:
        B, I, O, M = table["dense"]
        x, w = [make((B, I, M)) for _ in range(2)], [make((I, O, M)) for _ in range(2)]
        for cast_to, family in ((None, "dense"), (torch.bfloat16, "dense-fused"),
                                (torch.float16, "dense-fused")):
            out = cast_to or torch.float32
            g = [make((B, O, M), out) for _ in range(2)]
            run(f"{family}/fwd", table["dense"], _name(cast_to),
                lambda cast_to=cast_to, out=out: sc._launch_fwd(*x, *w, cast_to, out))
            run(f"{family}/bwd", table["dense"], _name(cast_to),
                lambda cast_to=cast_to, g=g: (sc._launch_bwd_x(*g, *w, cast_to),
                                              sc._launch_bwd_w(*x, *g, cast_to)))
        B, I, O, R, M = table["cp"]
        for dt in _DTYPES:
            ops = [make(s, dt) for s in ((B, I, M),) * 2 + ((I, R),) * 2 + ((O, R),) * 2
                   + ((R, M),) * 2]
            g = [make((B, O, M), dt) for _ in range(2)]
            run("cp/fwd", table["cp"], _name(dt), lambda ops=ops: sc._launch_cp_fwd(*ops))
            run("cp/bwd", table["cp"], _name(dt),
                lambda ops=ops, g=g: sc._launch_cp_bwd(*ops, *g))
        B, I, O, L, M = table["lshared"]
        for dt in _DTYPES:
            x = [make((B, I, L, M), dt) for _ in range(2)]
            w = [make((I, O, L), dt) for _ in range(2)]
            g = [make((B, O, L, M), dt) for _ in range(2)]
            run("lshared/fwd", table["lshared"], _name(dt),
                lambda x=x, w=w: sc._launch_ls_fwd(*x, *w))
            run("lshared/bwd", table["lshared"], _name(dt),
                lambda x=x, w=w, g=g: (sc._launch_ls_bwd_x(*g, *w),
                                       sc._launch_ls_bwd_w(*x, *g)))
        for shape in table["spectral_fused"]:
            B, I, O, spatial, modes = shape
            mh = math.prod(sc.fused_rows(spatial, modes))
            x, g = make((B, I, *spatial)), make((B, O, *spatial))
            wg = [make((I, O, mh)) for _ in range(2)]
            for cast_to, sim in _FUSED_MODES:
                tag = _name(cast_to) + (f"+{sim}" if sim else "")
                run("spectral_fused/fwd", shape, tag,
                    lambda cast_to=cast_to, sim=sim: sc._launch_fused_fwd(
                        x, *wg, modes, cast_to, sim))
                run("spectral_fused/bwd", shape, tag,
                    lambda cast_to=cast_to, sim=sim: sc._launch_fused_bwd(
                        x, *wg, g, modes, cast_to, sim))
    return traces


# ---------------------------------------------------------------------------
# Per-launch plans and the checks
# ---------------------------------------------------------------------------


def plan_bytes(launch: KernelLaunch) -> Optional[int]:
    """The shared memory a block of ``launch`` takes by its Python plan;
    None for a kernel Python plans nothing for."""
    from repro_torch.kernels import spectral_contract as sc

    n, a = launch.name, launch.ints
    if n == "spectral_contract_cp_fwd":
        return sc._cp_fwd_smem(_SIZE[a[6]], bool(a[5]))
    if n == "spectral_contract_cp_bwd":
        return sc._cp_bwd_smem(_SIZE[a[8]])
    if n in ("spectral_contract_ls_fwd", "spectral_contract_ls_bwd_x"):
        K = a[1] if n.endswith("fwd") else a[2]
        return sc._ls_smem(K, _SIZE[a[7]], bool(a[5]))
    if n in ("spectral_fused_fwd", "spectral_fused_bwd"):
        nd = a[3]
        return sc.fused_smem_bytes(a[4:4 + nd], a[7:7 + nd])
    return None


def library_bytes(launch: KernelLaunch) -> Optional[int]:
    """The same bytes by the library's own export (on the card: it builds
    and loads the libraries); None where there is no plan."""
    from repro_torch.kernels import spectral_contract as sc

    n, a = launch.name, launch.ints
    if n == "spectral_contract_cp_fwd":
        return int(sc._library_cp().spectral_contract_cp_fwd_smem(a[6], a[5]))
    if n == "spectral_contract_cp_bwd":
        return int(sc._library_cp().spectral_contract_cp_bwd_smem(a[8]))
    if n in ("spectral_contract_ls_fwd", "spectral_contract_ls_bwd_x"):
        K = a[1] if n.endswith("fwd") else a[2]
        return int(sc._library_ls().spectral_contract_ls_smem(K, a[7], a[5]))
    if n in ("spectral_fused_fwd", "spectral_fused_bwd"):
        return int(sc._library_fused().spectral_fused_smem(*a[3:10]))
    return None


def _row0(t: torch.Tensor) -> int:
    """The first batch row of a tile ``t`` sliced from a tensor whose
    storage starts at row 0."""
    return t.storage_offset() // t.stride(0)


def check_trace(tr: FamilyTrace) -> List[Finding]:
    """The checks of one family call's launches."""
    from repro_torch.kernels import spectral_contract as sc

    findings: List[Finding] = []

    def emit(check, detail):
        findings.append(Finding(pass_name="kernels", check=check, severity=ERROR,
                                site=None, where=tr.where, detail=detail))

    if not tr.launches:
        emit("no-kernel-traced", "tracing the family recorded no launch: the recorder or "
                                 "the launcher is broken")
        return findings
    for launch in tr.launches:
        need = plan_bytes(launch)
        if need is not None and need > sc.SMEM_LIMIT:
            emit("smem-over-limit", f"{launch.name}: the plan takes {need} B of shared "
                                    f"memory a block, over SMEM_LIMIT {sc.SMEM_LIMIT} B")
        if launch.name in ("spectral_contract_ls_fwd", "spectral_contract_ls_bwd_x"):
            B, M, splits = launch.ints[0], launch.ints[4], launch.ints[6]
            top = sc.ls_splits_max(B, M)
            if not 1 <= splits <= top:
                emit("index-oob", f"{launch.name}: {splits} splits, the outputs of a "
                                  f"(degree, channel tile) take 1 to {top}")
    fused = [la for la in tr.launches if la.name.startswith("spectral_fused")]
    if fused:
        B, I, O, spatial, modes = tr.shape
        rows = [0] * B
        for k, la in enumerate(fused):
            n = la.ints[0]
            start = _row0(la.io.outputs[0])
            if n < 1 or n > 8 or start < 0 or start + n > B:
                emit("index-oob", f"{la.name} launch {k}: rows [{start}, {start + n}) of "
                                  f"a batch of {B} (a tile takes 1 to 8 rows)")
                continue
            for b in range(start, start + n):
                rows[b] += 1
            if la.name == "spectral_fused_bwd" and la.ints[-1] != int(k > 0):
                emit("accum-discipline", f"fused_bwd launch {k} takes accumulate "
                                         f"{la.ints[-1]}: dw must start on the first tile "
                                         f"and add on every later one")
        bad = [b for b, c in enumerate(rows) if c != 1]
        if bad:
            emit("output-not-covered", f"{len(bad)}/{B} batch rows written "
                                       f"{[rows[b] for b in bad[:4]]} times (e.g. row "
                                       f"{bad[0]}): each must be written once")
        tile = fused[0].ints[0]
        scratch = (sc.fused_scratch_bytes if fused[0].name.endswith("bwd")
                   else sc.fused_fwd_scratch_bytes)(tile, I, O, spatial, modes)
        if scratch > sc.L2_BUDGET // 2:
            emit("l2-over-budget", f"a batch tile of {tile} keeps {scratch} B between the "
                                   f"stages, over half the L2 ({sc.L2_BUDGET // 2} B)")
    return findings


def card_findings(traces: Sequence[FamilyTrace], device) -> List[Finding]:
    """smem-underestimate: each plan against the library's export, and
    ``SMEM_LIMIT`` against the card's opt-in shared memory per block."""
    from repro_torch.kernels import spectral_contract as sc

    findings = []
    for tr in traces:
        for la in tr.launches:
            need = plan_bytes(la)
            if need is None:
                continue
            lib = library_bytes(la)
            if need < lib:
                findings.append(Finding(
                    pass_name="kernels", check="smem-underestimate", severity=ERROR,
                    site=None, where=tr.where,
                    detail=f"{la.name}: the plan reports {need} B of shared memory, the "
                           f"library's export {lib} B"))
    optin = getattr(torch.cuda.get_device_properties(torch.device(device)),
                    "shared_memory_per_block_optin", None)
    if optin is not None and sc.SMEM_LIMIT > optin:
        findings.append(Finding(
            pass_name="kernels", check="smem-underestimate", severity=ERROR, site=None,
            where="SMEM_LIMIT",
            detail=f"SMEM_LIMIT {sc.SMEM_LIMIT} B is above the card's opt-in shared "
                   f"memory per block ({optin} B)"))
    return findings


def kernels_pass(device: DeviceLike = None, traces: Optional[Sequence[FamilyTrace]] = None
                 ) -> List[Finding]:
    """Every check above over ``traces`` (default: ``trace_families(device)``)
    on ``device`` (CUDA unless the caller names another); on a card also
    the library's exports."""
    device = resolve_device(device)
    traces = trace_families(device) if traces is None else traces
    findings: List[Finding] = []
    for tr in traces:
        findings.extend(check_trace(tr))
    if torch.device(device).type == "cuda":
        findings.extend(card_findings(traces, device))
    return findings


# ---------------------------------------------------------------------------
# Calibration states
# ---------------------------------------------------------------------------


def _tile_problem(family: str, shape, block: int, direction: str) -> Optional[str]:
    """Why ``block`` is not a tile the family's rule admits at ``shape``
    (None: it is)."""
    from repro_torch.kernels.spectral_contract import (
        L2_BUDGET,
        SMEM_LIMIT,
        fused_smem_bytes,
        ls_splits_max,
    )
    from repro_torch.tune.space import fused_axes, tile_scratch_bytes

    if family == "spectral_fused":
        _B, _I, _O, spatial, modes = fused_axes(shape)
        if block > 8:
            return f"{direction} batch tile {block}: the kernels take at most 8 rows"
        if fused_smem_bytes(spatial, modes) > SMEM_LIMIT:
            return (f"the slab takes {fused_smem_bytes(spatial, modes)} B of shared memory, "
                    f"over {SMEM_LIMIT} B")
        need = tile_scratch_bytes(family, shape, block, direction)
        if need > L2_BUDGET // 2:
            return (f"{direction} tile {block} keeps {need} B between the stages, over half "
                    f"the L2 ({L2_BUDGET // 2} B)")
        return None
    B, _I, _O, _L, M = (int(s) for s in shape)
    if block > ls_splits_max(B, M):
        return f"{direction} splits {block}: the launch takes 1 to {ls_splits_max(B, M)}"
    return None


def calibration_pass(path: Optional[str] = None) -> List[Finding]:
    """calibration-coverage: every entry of a calibration-state file must
    be a tile its family's rule admits (``tune.space``: the fused batch
    tile within 8 rows and half the L2, ``ls_mix``'s splits within
    ``ls_splits_max``).  An entry no rule covers is corrupt or was tuned
    against another memory model, and must not steer a launch.

    ``path`` defaults to ``$REPRO_CALIBRATION_STATE``; no path means no
    findings (the check gates only states that would be used)."""
    from repro_torch.tune import cache as tcache
    from repro_torch.tune.space import TUNED

    findings: List[Finding] = []
    path = path or os.environ.get(tcache.ENV_VAR)
    if not path:
        return findings

    def emit(where, detail):
        findings.append(Finding(pass_name="kernels", check="calibration-coverage",
                                severity=ERROR, site=None, where=where, detail=detail))

    try:
        state = tcache.load(path)
    except tcache.CalibrationError as e:
        emit(str(path), str(e))
        return findings
    for key, ent in sorted(state.entries.items()):
        where = f"calibration:{key}"
        if not tcache._entry_ok(ent):
            emit(where, "corrupt entry: unknown family or non-power-of-two block (lookup "
                        "would skip it; the tuner must not have written it)")
            continue
        if ent["family"] not in TUNED:
            emit(where, f"the {ent['family']} kernels take no launch tile: no wrapper "
                        f"reads this entry and the port's tuner never writes one")
            continue
        for direction, field in (("fwd", "block_fwd"), ("bwd", "block_bwd")):
            try:
                why = _tile_problem(ent["family"], ent["shape"], int(ent[field]), direction)
            except (KeyError, TypeError, ValueError) as e:
                why = f"{direction} tile not priceable by the family's rule: {e}"
            if why is not None:
                emit(where, why)
    return findings

