"""Measurement of tile candidates on the device.

Each candidate is timed as the unit its wrapper pins: one forward plus
backward of the family's autograd Function (``FusedSpectral`` or
``LSharedContract``) at the candidate's forward and backward tiles.  The
Function's own ``forward`` and ``backward`` run, with the same launches,
but not through the autograd engine: on a card the engine hands each
backward to its device thread, and that hand-off costs the host a few
hundred µs a call that no tile changes (0.8–1.0 ms a step against
0.15–0.45 ms of kernels for the SFNO's order-shared layer on an H100),
so the walls would rank the host, not the tiles.

On a card: the median of ``iters`` samples after one warm run per
operand set, the runs cycling through operand sets that together exceed
the 50 MB L2 (as the paths find their operands).  The fused kernels are
cooperative launches, so their samples are CUDA events around
back-to-back runs spanning at least ``SAMPLE_MS``, no CUDA graph; the
order-shared ones are replays of a CUDA graph of ``GRAPH_RUNS`` runs a
set, so the host's launch time does not enter.  A candidate launches its
kernels or raises.

On the CPU the Functions run their plain versions, so every candidate of
a key is the same computation: the walls rank nothing, and the cache
marks such entries ``interpret: true`` (the reference's name for its CI
mode).  That is enough for the tune → validate → cache → resolve cycle
to run on the CPU.

Alongside the wall every measurement reports GB/s (``bytes_moved``, a
traffic model, over the wall) and the fraction of the H100's HBM rate it
represents.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.spectral_contract import (
    L2_BUDGET,
    FusedSpectral,
    LSharedContract,
    fused_rows,
)

from .space import Candidate, family_itemsize, fused_axes

#: the H100 SXM's HBM3 rate, bytes/s (the roofline ``roofline_fraction``
#: divides by)
HBM_BW = 3.35e12


def bytes_moved(family: str, shape, dtype: str) -> int:
    """HBM traffic model for one train step (fwd + both backward
    kernels): every operand read and every output written once, re+im
    planes, at the family's streaming itemsize (the reference's model,
    number for number).  A model, not a measurement — good enough to rank
    candidates and to normalise walls into GB/s."""
    itemsize = family_itemsize(family, dtype)
    if family in ("spectral_fused", "spectral_staged"):
        # real-valued physical tensors + split-real gathered weight; no
        # re+im doubling of x/y.  ``spectral_staged`` adds the HBM
        # round-trips of the staged pipeline's intermediate spectra.
        B, I, O, spatial, modes = fused_axes(shape)
        S = int(np.prod(spatial))
        Mh = int(np.prod(fused_rows(spatial, modes)))
        x_el, w_el, y_el = B * I * S, 2 * I * O * Mh, B * O * S
        fwd = x_el + w_el + y_el
        bwd = y_el + x_el + w_el + x_el + w_el  # g in, x/w re-read, dx/dw out
        elems = fwd + bwd
        if family == "spectral_staged":
            Sh = int(np.prod(spatial[:-1])) * (spatial[-1] // 2 + 1)
            spec_in = 2 * B * I * Sh
            spec_out = 2 * B * O * Sh
            elems += 2 * (spec_in + spec_out)
            elems += 4 * (spec_in + spec_out)
        return int(elems) * itemsize
    if family in ("dense", "dense-fused"):
        B, I, O, M = shape
        fwd = (B * I + I * O + B * O) * M
        bwd = 2 * (B * I + I * O + B * O) * M
        elems = fwd + bwd
    elif family == "cp":
        B, I, O, R, M = shape
        factors = (I + O) * R + R * M
        fwd = (B * I + B * O) * M + factors
        bwd = (2 * B * I + 2 * B * O) * M + 2 * factors
        elems = fwd + bwd
    elif family == "lshared":
        B, I, O, L, Mm = shape
        fwd = (B * I + B * O) * L * Mm + I * O * L
        bwd = (2 * B * I + 2 * B * O) * L * Mm + 2 * I * O * L
        elems = fwd + bwd
    else:
        raise ValueError(f"unknown kernel family {family!r}")
    return int(elems) * 2 * itemsize


def make_operands(family: str, shape, dtype: str, seed: int = 0):
    """Seeded split-real operands for one family, CPU tensors — the
    reference's arrays, value for value (f32 from ``0.5·randn``, then the
    storage dtype except for the cast-fusing families) — and the ones the
    oracle check rebuilds, so a validated entry was validated on the data
    it was timed on."""
    rng = np.random.RandomState(seed)
    op_dtype = (torch.float32 if family in ("dense-fused", "spectral_fused")
                else getattr(torch, dtype))

    def arr(*s):
        return torch.from_numpy(
            np.asarray(0.5 * rng.randn(*s), np.float32)).to(op_dtype)

    if family == "spectral_fused":
        B, I, O, spatial, modes = fused_axes(shape)
        Mh = int(np.prod(fused_rows(spatial, modes)))
        return (arr(B, I, *spatial), arr(I, O, Mh), arr(I, O, Mh))
    if family in ("dense", "dense-fused"):
        B, I, O, M = shape
        return (arr(B, I, M), arr(B, I, M), arr(I, O, M), arr(I, O, M))
    if family == "cp":
        B, I, O, R, M = shape
        return (arr(B, I, M), arr(B, I, M), arr(I, R), arr(I, R),
                arr(O, R), arr(O, R), arr(R, M), arr(R, M))
    if family == "lshared":
        B, I, O, L, Mm = shape
        return (arr(B, I, L, Mm), arr(B, I, L, Mm),
                arr(I, O, L), arr(I, O, L))
    raise ValueError(f"unknown kernel family {family!r}")


def _cast_to(dtype: str) -> Optional[torch.dtype]:
    return None if dtype == "float32" else getattr(torch, dtype)


def forward(cand: Candidate, ops):
    """The candidate's forward through its Function at its tiles: the
    fused layer's y, or the order-shared pair (out_re, out_im)."""
    if cand.family == "spectral_fused":
        _B, _I, _O, _spatial, modes = fused_axes(cand.shape)
        return FusedSpectral.apply(*ops, modes, _cast_to(cand.dtype), None,
                                   cand.block_fwd, cand.block_bwd)
    if cand.family == "lshared":
        return LSharedContract.apply(*ops, cand.block_fwd, cand.block_bwd)
    raise ValueError(f"{cand.family!r} has no launch tile to time")


def _outputs(cand: Candidate):
    """(shape, dtype) of each output of the candidate's forward."""
    if cand.family == "spectral_fused":
        B, _I, O, spatial, _modes = fused_axes(cand.shape)
        return [((B, O, *spatial), torch.float32)]
    B, _I, O, L, M = cand.shape
    return [((B, O, L, M), getattr(torch, cand.dtype))] * 2


class _Ctx:
    """What the Functions' ``forward`` and ``backward`` use of an autograd
    context: the saved tensors, which inputs want gradients (all), and the
    attributes they set themselves."""

    def __init__(self, n_inputs: int):
        self.needs_input_grad = (True,) * n_inputs
        self.saved_tensors = ()

    def save_for_backward(self, *tensors):
        self.saved_tensors = tensors


def build_step(cand: Candidate):
    """``step(*ops, *cotangents)``: the candidate's Function, forward then
    backward, at its tiles; returns the gradients."""
    n_cot = len(_outputs(cand))
    if cand.family == "spectral_fused":
        fn = FusedSpectral
        consts = (fused_axes(cand.shape)[4], _cast_to(cand.dtype), None,
                  cand.block_fwd, cand.block_bwd)
    elif cand.family == "lshared":
        fn, consts = LSharedContract, (cand.block_fwd, cand.block_bwd)
    else:
        raise ValueError(f"{cand.family!r} has no launch tile to time")

    def step(*args):
        ops, cot = args[:-n_cot], args[-n_cot:]
        ctx = _Ctx(len(ops) + len(consts))
        with torch.no_grad():
            fn.forward(ctx, *ops, *consts)
            return fn.backward(ctx, *cot)[:len(ops)]

    return step


def operand_sets(cand: Candidate, device, seed: int = 0):
    """Operand sets on ``device``, each the seeded operands and a seeded
    cotangent: on a card enough of them (2 to 16) to exceed twice the L2
    together, on the CPU 2."""
    def one(k):
        ops = [t.to(device) for t in
               make_operands(cand.family, cand.shape, cand.dtype, seed + k)]
        gen = torch.Generator(device="cpu").manual_seed(seed + 1000 + k)
        cot = [(0.5 * torch.randn(shape, generator=gen)).to(dtype).to(device)
               for shape, dtype in _outputs(cand)]
        return (*ops, *cot)

    first = one(0)
    size = sum(t.numel() * t.element_size() for t in first)
    n = 2 if torch.device(device).type != "cuda" else \
        min(16, max(2, math.ceil(2 * L2_BUDGET / max(size, 1))))
    return [first] + [one(k) for k in range(1, n)]


#: the device time one timed sample of the fused kernels spans at least
SAMPLE_MS = 5.0
#: runs a set in one CUDA graph of the order-shared kernels
GRAPH_RUNS = 10


def _wall_us(step, sets, iters: int, warmup: int, device, graph: bool = False) -> float:
    """Median µs a run of ``iters`` samples, after ``warmup`` runs of each
    set.  On a card a sample is either a CUDA-event interval around enough
    back-to-back runs (cycling through ``sets``) to span ``SAMPLE_MS``, or
    with ``graph`` one replay of a CUDA graph of ``GRAPH_RUNS`` runs a set;
    on the CPU one run on the host clock."""
    for _ in range(warmup):
        for args in sets:
            step(*args)
    if torch.device(device).type != "cuda":
        samples = []
        for k in range(iters):
            t0 = time.perf_counter()
            step(*sets[k % len(sets)])
            samples.append((time.perf_counter() - t0) * 1e6)
        return float(np.median(samples))

    def timed(run, reps: int) -> float:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / reps

    def runs(reps):
        def run():
            for k in range(reps):
                step(*sets[k % len(sets)])
        return run

    torch.cuda.synchronize(device)
    if graph:
        reps = GRAPH_RUNS * len(sets)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            runs(reps)()
        g.replay()
        return float(np.median([timed(g.replay, reps) for _ in range(iters)]))
    reps = max(len(sets), min(200, math.ceil(
        SAMPLE_MS * 1e3 / max(timed(runs(len(sets)), len(sets)), 1.0))))
    return float(np.median([timed(runs(reps), reps) for _ in range(iters)]))


def measure(cand: Candidate, *, device=None, iters: int = 5, warmup: int = 1,
            seed: int = 0, sets=None) -> dict:
    """Time one candidate on ``device`` (None: the card); returns the perf
    fields of a cache entry.  ``sets``: operand sets from
    ``operand_sets`` to reuse across a key's candidates."""
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    if sets is None:
        sets = operand_sets(cand, device, seed)
    wall = _wall_us(build_step(cand), sets, iters, warmup, device,
                    graph=cand.family == "lshared")
    moved = bytes_moved(cand.family, cand.shape, cand.dtype)
    gbps = moved / (wall * 1e-6) / 1e9 if wall > 0 else 0.0
    return {
        "wall_us": wall,
        "bytes_moved": moved,
        "gbps": round(gbps, 3),
        "roofline_fraction": round(gbps / (HBM_BW / 1e9), 6),
        "interpret": device.type != "cuda",
    }
