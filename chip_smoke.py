#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Device: require CUDA; print the card's name and power limit; turn TF32
   and reduced-precision half reductions off (the ``full`` policy means
   real f32, and the reference accumulates half products in f32).
2. Build: compile the hand-written spectral-contraction kernel for
   ``sm_90a`` from the sources in this checkout; print ptxas's report.
3. Kernel vs plain: the CUDA kernel against its plain PyTorch version on
   the card, at the serving path's shape and a ragged one, in the path's
   three modes, within ``4ε_out·M + 32·ε_f32·M + 1e-5`` elementwise.
4. The slice: serve the full-width Darcy FNO (``FNO_DARCY``) through
   ``OperatorEngine(max_batch=8)`` under ``mixed_fno_bf16`` and ``full``:
   16 GRF fields at 128x128 and 8 at 421x421, two rounds (the first warms
   cuFFT plans and cuBLAS).  Outputs finite and shaped; 8 kernel launches
   per micro-batch; a re-served field through a fresh engine bit-identical
   to its batched answer; one 128x128 field against the same weights run
   on the CPU.
5. Numbers: the kernel's time (CUDA graph of many launches, operands
   cycled through more than L2 holds) beside its bound, its plain
   version's and ``torch.einsum``'s on complex64; engine fields/s and ms
   per micro-batch per resolution; a profiler breakdown of one micro-batch
   per resolution and policy; peak device memory.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
POLICIES = ("mixed_fno_bf16", "full")
RESOLUTIONS = ((128, 16), (421, 8))      # (grid, fields)
MAX_BATCH = 8
PATH_SHAPE = (8, 64, 64, 1024)           # (B, I, O, M) of every launch on the path
RAGGED_SHAPE = (3, 24, 40, 300)
#: H100 SXM data sheet: HBM rate and f32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def emit(tag, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# -- phase 1 ------------------------------------------------------------------
def device_phase():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    emit("device", name=torch.cuda.get_device_name(0), smi=card,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         bf16_reduced_reduction=torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
         fp16_reduced_reduction=torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction)
    return card


# -- phase 2 ------------------------------------------------------------------
def build_phase(sc):
    t0 = time.perf_counter()
    lib, report = sc.build()
    print(report.strip(), flush=True)
    emit("build", library=str(lib.relative_to(ROOT)), seconds=time.perf_counter() - t0)


# -- phase 3 ------------------------------------------------------------------
def operands(shape, seed):
    B, I, O, M = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = [0.5 * torch.randn(B, I, M, generator=g, device="cuda") for _ in range(2)]
    w = [0.5 * torch.randn(I, O, M, generator=g, device="cuda") for _ in range(2)]
    return x + w


def kernel_phase(sc):
    from repro_torch.core.precision import FORMAT_EPS, dtype_name
    from repro_torch.core.theory import contract_budget

    modes = [(None, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float16, torch.float16)]
    worst = 0.0
    for k, shape in enumerate((PATH_SHAPE, RAGGED_SHAPE)):
        ops = operands(shape, SEED + k)
        mag = sc.contract_magnitude(*ops)
        for cast_to, out_dtype in modes:
            kr, ki = sc.spectral_contract_dense(*ops, cast_to=cast_to, out_dtype=out_dtype)
            torch.cuda.synchronize()
            pr, pi = sc.spectral_contract_plain(*ops, cast_to=cast_to, out_dtype=out_dtype)
            torch.cuda.synchronize()
            diff = torch.hypot(kr.float() - pr.float(), ki.float() - pi.float())
            budget = contract_budget(FORMAT_EPS[dtype_name(out_dtype)], mag)
            err, excess = diff.max().item(), (diff - budget).max().item()
            emit("kernel_vs_plain", shape=list(shape), cast_to=str(cast_to),
                 out_dtype=str(out_dtype), max_abs_err=err,
                 max_excess_over_budget=excess, ok=excess <= 0)
            if excess > 0:
                fail(f"kernel disagrees with its plain version at {shape} "
                     f"{cast_to}->{out_dtype}: exceeds the budget by {excess:.3e}")
            if shape == PATH_SHAPE:
                worst = max(worst, err)
    return worst


# -- phase 4 ------------------------------------------------------------------
def serve(engine, fields, uid0, times):
    """Submit ``fields`` and tick the engine dry, recording per tick the
    resolution, wall ms and peak device memory into ``times``."""
    from repro_torch.serve import FieldRequest

    reqs = [FieldRequest(uid=uid0 + i, x=x) for i, x in enumerate(fields)]
    for r in reqs:
        if not engine.submit(r):
            fail(f"request {r.uid} rejected: {r.error}")
    while engine.scheduler.depth:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = engine.tick()
        ms = (time.perf_counter() - t0) * 1e3
        times.append((done[0].resolution[0], len(done), ms,
                      torch.cuda.max_memory_allocated()))
    return reqs


def check_outputs(reqs, cfg):
    for r in reqs:
        want = (cfg.out_channels, *r.resolution)
        if r.status != "done" or r.y is None or r.y.shape != want:
            fail(f"request {r.uid}: status {r.status}, output "
                 f"{None if r.y is None else r.y.shape}, want {want}")
        if not np.isfinite(r.y).all():
            fail(f"request {r.uid}: non-finite output")


def profile_tick(engine, fields):
    """One micro-batch under the profiler: wall ms, device-busy ms and the
    kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import FieldRequest

    for i, x in enumerate(fields):
        engine.submit(FieldRequest(uid=10_000 + i, x=x))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.tick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name
        if any(s in name for s in ("Activity Buffer", "Module Loading", "Function Loading")):
            continue
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    spectral = sum(v for k, v in by_name.items() if "dense_fwd_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "spectral_kernel_ms": spectral,
            "top": [[name[:90], ms] for name, ms in top]}


def slice_phase(sc):
    from repro_torch.configs.fno_paper import FNO_DARCY
    from repro_torch.data import grf_2d
    from repro_torch.models import fno_infer, init_fno, param_count
    from repro_torch.precision import get_policy
    from repro_torch.serve import OperatorEngine

    cfg = FNO_DARCY
    per_batch = cfg.n_layers * 2 ** (cfg.ndim - 1)
    if per_batch != 8:
        fail(f"FNO_DARCY should launch 8 kernels per micro-batch, config gives {per_batch}")
    t0 = time.perf_counter()
    net = init_fno(torch.Generator().manual_seed(SEED), cfg)
    net_cpu = init_fno(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    fields = {n: list(grf_2d(torch.Generator().manual_seed(n), n, batch=count)
                      .numpy()[:, None])
              for n, count in RESOLUTIONS}
    emit("setup", params=param_count(net), seconds=time.perf_counter() - t0)

    sc.launches = 0          # the main path's run starts here
    ticks = 0
    served, stats, profiles = {}, {}, {}
    for pname in POLICIES:
        policy = get_policy(pname)
        engine = OperatorEngine(net, policy=policy, max_batch=MAX_BATCH)
        for rnd in range(2):
            times = []
            reqs = []
            for n, _ in RESOLUTIONS:
                reqs += serve(engine, fields[n], 1000 * rnd + n, times)
            ticks += len(times)
            check_outputs(reqs, cfg)
        served[pname] = {n: [r.y for r in reqs if r.resolution[0] == n]
                         for n, _ in RESOLUTIONS}
        for n, _ in RESOLUTIONS:
            rows = [t for t in times if t[0] == n]
            ms = [t[2] for t in rows]
            stats[(pname, n)] = {
                "policy": pname, "grid": n, "micro_batches": len(rows),
                "fields": sum(t[1] for t in rows),
                "ms_per_micro_batch": ms,
                "fields_per_s": sum(t[1] for t in rows) / (sum(ms) / 1e3),
                "peak_mem_bytes": max(t[3] for t in rows)}
            prof = profile_tick(engine, fields[n][:MAX_BATCH])
            prof["idle_share_unprofiled"] = max(
                0.0, 1.0 - prof["device_busy_ms"] / float(np.median(ms)))
            profiles[(pname, n)] = prof
            ticks += 1
        # a re-served field through a fresh engine gives its batched answer
        for n, idx in ((128, 5), (421, 3)):
            solo = OperatorEngine(net, policy=policy, max_batch=MAX_BATCH)
            times = []
            (sr,) = serve(solo, [fields[n][idx]], 0, times)
            ticks += len(times)
            if not np.array_equal(sr.y, served[pname][n][idx]):
                fail(f"{pname} {n}x{n}: re-served field differs from its batched answer")
    launches = sc.launches   # the main path's run ends here
    emit("launches", launches=launches, micro_batches=ticks,
         per_micro_batch=launches / ticks)
    if launches != per_batch * ticks:
        fail(f"{launches} kernel launches for {ticks} micro-batches, want {per_batch} each")

    # the card against the CPU plain path, same weights, one 128x128 field
    x = fields[128][5][None]
    parity = {}
    for pname in POLICIES:
        y_cpu = fno_infer(net_cpu, x, get_policy(pname), device="cpu").numpy()[0]
        parity[pname] = rel_l2(served[pname][128][5], y_cpu)
    precision_err = rel_l2(served["mixed_fno_bf16"][128][5], served["full"][128][5])
    limits = {"full": 1e-5, "mixed_fno_bf16": 0.25 * precision_err}
    emit("card_vs_cpu", rel_l2=parity, limits=limits,
         mixed_vs_full_rel_l2=precision_err)
    for pname in POLICIES:
        if not parity[pname] <= limits[pname]:
            fail(f"{pname}: card vs CPU relative L2 {parity[pname]:.3e} "
                 f"> {limits[pname]:.3e}")
    for key in stats:
        emit("engine", **stats[key])
    for (pname, n), prof in profiles.items():
        emit("profile", policy=pname, grid=n, **prof)
    return launches


# -- phase 5 ------------------------------------------------------------------
def graph_ms(fn, sets, iters=40):
    """Device ms per call of ``fn``: ``iters`` calls cycling through
    ``sets`` captured as one CUDA graph (no host overhead between
    launches), replayed between CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for args in sets:     # warm-up outside the capture
            fn(*args)
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(iters):
            fn(*sets[k % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def timing_phase(sc, max_err, launches):
    B, I, O, M = PATH_SHAPE
    # 4 operand sets of 37.7 MB each: consecutive calls find their operands
    # outside the 50 MB L2, as the serving path does
    sets = [operands(PATH_SHAPE, 100 + k) for k in range(4)]
    times = {}
    for cast_to, out_dtype in ((torch.bfloat16, torch.bfloat16), (None, torch.float32)):
        def kernel(xr, xi, wr, wi, c=cast_to, o=out_dtype):
            return sc.spectral_contract_dense(xr, xi, wr, wi, cast_to=c, out_dtype=o)

        def plain(xr, xi, wr, wi, c=cast_to, o=out_dtype):
            return sc.spectral_contract_plain(xr, xi, wr, wi, cast_to=c, out_dtype=o)

        out_bytes = torch.empty((), dtype=out_dtype).element_size()
        nbytes = 4 * (2 * B * I * M + 2 * I * O * M) + out_bytes * 2 * B * O * M
        flops = 8 * B * I * O * M
        times[str(out_dtype)] = {
            "ms": graph_ms(kernel, sets), "plain_ms": graph_ms(plain, sets),
            "bytes": nbytes, "flops": flops,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "flops_ms": flops / F32_FLOP_PER_S * 1e3}
    csets = [(torch.complex(xr, xi), torch.complex(wr, wi)) for xr, xi, wr, wi in sets]
    library_ms = graph_ms(lambda x, w: torch.einsum("bim,iom->bom", x, w), csets)
    for mode, t in times.items():
        emit("kernel_time", shape=list(PATH_SHAPE), out_dtype=mode,
             library_ms=library_ms, **t)
    t = times[str(torch.bfloat16)]
    bound_ms = max(t["bytes_ms"], t["flops_ms"])
    return {"name": "spectral_contract_dense_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spectral_contract.cu",
            "replaces": "src/repro/kernels/spectral_contract.py:104",
            "launches": launches, "max_abs_err": max_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes" if t["bytes_ms"] >= t["flops_ms"] else "operations",
            "library_ms": library_ms}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    # the port comes from this checkout's src/; without it, fail before any output
    from repro_torch.kernels import spectral_contract as sc

    card = device_phase()
    build_phase(sc)
    max_err = kernel_phase(sc)
    launches = slice_phase(sc)
    entry = timing_phase(sc, max_err, launches)
    print(card, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
