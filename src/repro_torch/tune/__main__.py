"""``python -m repro_torch.tune`` — tune / validate / report.

  tune      enumerate legal tiles per (family, shape, dtype) key, time
            each candidate and the heuristics' own tiles on the device,
            gate the fastest through the float64 oracle, persist winners
            to the calibration state (atomic write).  Keys of a family
            with no launch tile (dense, dense-fused, cp) are listed and
            get no entry.  ``--smoke`` takes the reference's tiny keys and
            caps the candidates.
  validate  re-run the oracle gate over every entry of an existing
            state file; exit 1 if any entry fails (``--prune`` rewrites
            the file without the failures).  ``--perturb X`` injects a
            scaled violation first — the self-check proving the gate
            rejects wrong kernels rather than passing vacuously.
  report    human-readable table: tiles, walls, GB/s, roofline
            fraction, validation + staleness per entry.

``--device`` picks the device (default: the card; ``cpu`` times and
checks the plain versions, where every candidate of a key is the same
computation).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from repro_torch.kernels.spectral_contract import KERNEL_VERSION

from . import cache as cache_mod
from . import oracle, space
from .cache import CalibrationCache, CalibrationError, backend_of
from .measure import measure, operand_sets

DEFAULT_STATE = str(Path(__file__).resolve().parents[3] / "build"
                    / "calibration_state.json")

#: the keys the port's paths look up at full width, as the wrappers build
#: them: FNO_DARCY's fused layer at 128² (bf16 under mixed_fno_bf16, f32
#: under amp_bf16 and full: the contract site's dtype) and 421², batch 8;
#: GINO_CAR's latent layer (batch 4, 32³, modes 12³); SFNO_SWE's
#: order-shared layer (B, I, O, L, M) in both dtypes
DEFAULT_KEYS = (
    ("spectral_fused", (8, 64, 64, 128, 128, 32, 32), "bfloat16"),
    ("spectral_fused", (8, 64, 64, 128, 128, 32, 32), "float32"),
    ("spectral_fused", (8, 64, 64, 421, 421, 32, 32), "bfloat16"),
    ("spectral_fused", (4, 64, 64, 32, 32, 32, 12, 12, 12), "bfloat16"),
    ("lshared", (8, 64, 64, 128, 128), "bfloat16"),
    ("lshared", (8, 64, 64, 128, 128), "float32"),
)

#: smoke keys: the reference's tiny shapes, every family still covered
SMOKE_KEYS = (
    ("dense", (2, 8, 8, 40), "bfloat16"),
    ("dense-fused", (2, 8, 8, 40), "bfloat16"),
    ("cp", (2, 8, 8, 4, 40), "bfloat16"),
    ("lshared", (2, 8, 8, 12, 9), "bfloat16"),
    ("spectral_fused", (2, 4, 4, 12, 9, 3, 3), "bfloat16"),
)


def _state_path(args) -> str:
    return (args.state or os.environ.get(cache_mod.ENV_VAR)
            or DEFAULT_STATE)


def _entry_from(cand: space.Candidate, perf: dict, verdict: dict,
                backend: str, heuristic: tuple) -> dict:
    (hf, hb), hperf = heuristic
    return {
        "family": cand.family,
        "shape": list(cand.shape),
        "dtype": cand.dtype,
        "backend": backend,
        "kernel_version": KERNEL_VERSION,
        "block_fwd": cand.block_fwd,
        "block_bwd": cand.block_bwd,
        "wall_us": round(perf["wall_us"], 2),
        "bytes_moved": perf["bytes_moved"],
        "gbps": perf["gbps"],
        "roofline_fraction": perf["roofline_fraction"],
        "interpret": perf["interpret"],
        "validated": True,
        "max_err": verdict["max_err"],
        "budget_min": verdict["budget_min"],
        "heuristic_fwd": hf,
        "heuristic_bwd": hb,
        "heuristic_wall_us": round(hperf["wall_us"], 2),
    }


def _device(args):
    from repro_torch.device import resolve_device

    return resolve_device(args.device)


def cmd_tune(args) -> int:
    import torch

    from repro_torch.kernels.ops import heuristic_blocks

    device = _device(args)
    backend = backend_of(device)
    keys = SMOKE_KEYS if args.smoke else DEFAULT_KEYS
    limit = args.limit if args.limit is not None else (4 if args.smoke
                                                      else None)
    iters = args.iters if args.iters is not None else (1 if args.smoke
                                                      else 5)
    path = _state_path(args)
    try:
        state = cache_mod.load(path)
    except CalibrationError:
        state = CalibrationCache(entries={}, backend=backend)
    state.kernel_version = KERNEL_VERSION
    state.backend = backend

    n_admitted = 0
    for family, shape, dtype in keys:
        cands = space.candidates(family, shape, dtype, limit=limit)
        if not cands:
            print(f"  {family} {tuple(shape)} {dtype}: no launch tile "
                  f"(compile-time tiles, grid from the SM count); no entry")
            continue
        sets = operand_sets(cands[0], device, args.seed)
        timed = {}
        for c in cands:
            perf = measure(c, device=device, iters=iters, warmup=args.warmup,
                           sets=sets)
            timed[(c.block_fwd, c.block_bwd)] = (c, perf)
            print(f"  {family} {tuple(shape)} {dtype} "
                  f"fwd={c.block_fwd} bwd={c.block_bwd}: "
                  f"{perf['wall_us']:.1f} us  {perf['gbps']:.2f} GB/s")
        hblocks = heuristic_blocks(family, shape, dtype, device)
        if hblocks in timed:
            hperf = timed[hblocks][1]
        else:
            hperf = measure(space.Candidate(family, tuple(shape), dtype, *hblocks),
                            device=device, iters=iters, warmup=args.warmup,
                            sets=sets)
        print(f"  HEURISTIC fwd={hblocks[0]} bwd={hblocks[1]}: "
              f"{hperf['wall_us']:.1f} us  {hperf['gbps']:.2f} GB/s")
        del sets
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # admission: fastest candidate that survives the oracle gate.
        # A candidate failing the Thm 3.2 budget is never written — a
        # mistuned-but-wrong kernel is unrepresentable in the cache.
        admitted = None
        for c, perf in sorted(timed.values(), key=lambda t: t[1]["wall_us"]):
            verdict = oracle.check(c, device=device, seed=args.seed)
            if verdict["passed"]:
                admitted = (c, perf, verdict)
                break
            print(f"  REFUSED fwd={c.block_fwd} bwd={c.block_bwd}: "
                  f"max_err {verdict['max_err']:.3e} exceeds budget "
                  f"(worst excess {verdict['worst_excess']:.3e})")
        if admitted is None:
            print(f"  {family} {tuple(shape)} {dtype}: no candidate "
                  f"passed the oracle — key left uncalibrated",
                  file=sys.stderr)
            continue
        c, perf, verdict = admitted
        state.put(_entry_from(c, perf, verdict, backend, (hblocks, hperf)))
        n_admitted += 1
        print(f"  ADMIT {family} {tuple(shape)} {dtype}: "
              f"fwd={c.block_fwd} bwd={c.block_bwd} "
              f"({perf['wall_us']:.1f} us, max_err "
              f"{verdict['max_err']:.3e} <= budget)")
    out = cache_mod.save(state, path)
    print(f"wrote {n_admitted} calibrated entr"
          f"{'y' if n_admitted == 1 else 'ies'} -> {out}")
    return 0 if n_admitted else 1


def _cand_of(ent: dict) -> space.Candidate:
    return space.Candidate(
        family=ent["family"], shape=tuple(ent["shape"]),
        dtype=ent["dtype"], block_fwd=int(ent["block_fwd"]),
        block_bwd=int(ent["block_bwd"]))


def cmd_validate(args) -> int:
    path = _state_path(args)
    try:
        state = cache_mod.load(path)
    except CalibrationError as e:
        print(f"validate: {e}", file=sys.stderr)
        return 2
    device = _device(args)
    failures, stale, checked = [], [], 0
    for key, ent in sorted(state.entries.items()):
        if not cache_mod._entry_ok(ent):
            failures.append((key, "corrupt entry (structural)"))
            continue
        if ent.get("kernel_version") != KERNEL_VERSION:
            stale.append((key, f"kernel_version {ent.get('kernel_version')}"
                               f" != {KERNEL_VERSION}"))
            continue
        verdict = oracle.check(_cand_of(ent), device=device,
                               seed=args.seed, perturb=args.perturb)
        checked += 1
        if not verdict["passed"]:
            failures.append(
                (key, f"max_err {verdict['max_err']:.3e} exceeds the "
                      f"Thm 3.2 budget (worst excess "
                      f"{verdict['worst_excess']:.3e})"))
    for key, why in stale:
        print(f"STALE  {key}: {why} (entry is never served)")
    for key, why in failures:
        print(f"REJECT {key}: {why}")
    print(f"validate: {checked} checked, {len(failures)} rejected, "
          f"{len(stale)} stale")
    if failures and args.prune:
        for key, _ in failures:
            state.entries.pop(key, None)
        cache_mod.save(state, path)
        print(f"pruned {len(failures)} entries -> {path}")
    return 1 if failures else 0


def cmd_report(args) -> int:
    path = _state_path(args)
    try:
        state = cache_mod.load(path)
    except CalibrationError as e:
        print(f"report: {e}", file=sys.stderr)
        return 2
    backend = backend_of(args.device)
    print(f"calibration state: {path}")
    print(f"  format {cache_mod.FORMAT_VERSION}, tuned at kernel_version "
          f"{state.kernel_version} on backend {state.backend!r} "
          f"(current: {KERNEL_VERSION} on {backend!r})")
    hdr = (f"{'key':<48} {'fwd':>4} {'bwd':>4} {'wall_us':>9} "
           f"{'heur':>9} {'GB/s':>8} {'roof%':>6} {'ok':>3}")
    print(hdr)
    print("-" * len(hdr))
    for key, ent in sorted(state.entries.items()):
        live = (cache_mod._entry_ok(ent)
                and ent.get("validated", False)
                and ent.get("kernel_version") == KERNEL_VERSION
                and ent.get("backend") == backend)
        flag = "ok" if live else "--"
        print(f"{key:<48} {ent.get('block_fwd', '?'):>4} "
              f"{ent.get('block_bwd', '?'):>4} "
              f"{ent.get('wall_us', float('nan')):>9.1f} "
              f"{ent.get('heuristic_wall_us', float('nan')):>9.1f} "
              f"{ent.get('gbps', float('nan')):>8.2f} "
              f"{100 * ent.get('roofline_fraction', 0):>5.1f}% "
              f"{flag:>3}")
    if args.json:
        print(json.dumps(state.to_json(), indent=2, sort_keys=True))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--state", default=None,
                        help=f"calibration-state path (default: "
                             f"${cache_mod.ENV_VAR} or {DEFAULT_STATE})")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default=None,
                        help="torch device (default: the card)")

    t = sub.add_parser("tune", help="search, time, gate, persist")
    common(t)
    t.add_argument("--smoke", action="store_true",
                   help="the reference's tiny keys + capped candidates")
    t.add_argument("--iters", type=int, default=None,
                   help="timed runs per candidate (median)")
    t.add_argument("--warmup", type=int, default=1,
                   help="warm runs of each operand set per candidate")
    t.add_argument("--limit", type=int, default=None,
                   help="cap candidates per key")
    t.set_defaults(fn=cmd_tune)

    v = sub.add_parser("validate", help="re-run the oracle over a state")
    common(v)
    v.add_argument("--perturb", type=float, default=0.0,
                   help="inject a scaled budget violation (self-check; "
                        ">1 must reject every entry)")
    v.add_argument("--prune", action="store_true",
                   help="rewrite the state without rejected entries")
    v.set_defaults(fn=cmd_validate)

    r = sub.add_parser("report", help="print the state as a table")
    common(r)
    r.add_argument("--json", action="store_true")
    r.set_defaults(fn=cmd_report)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
