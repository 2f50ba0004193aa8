#!/usr/bin/env python3
"""What sets a dry-run cell's peak: the largest tensors a rank holds then.

Runs ``repro_torch.launch.dryrun.run_cell`` with an observer around
``roofline._CountMode``'s dispatch.  For every tensor the count holds live
the observer keeps the op that made it, its local shape and dtype, and the
innermost line of the port that ran the op; at each new peak it copies the
largest of them.  It changes no count: the cell's record is the CLI's.
One JSON line a cell: arch, shape, mesh, status, seconds, peak, argument
and temp bytes a device, collective bytes by kind, and the ``--top``
largest tensors live at the peak.  Each cell runs in a process of its own
(one thread), ``--jobs`` at a time, on the CPU.

    PYTHONPATH=src python3 tools/dryrun_peak.py --shape train_4k --all --mesh both --jobs 8 \\
        --out build/peaks.jsonl
    PYTHONPATH=src python3 tools/dryrun_peak.py --arch smollm-360m --shape train_4k --mesh single
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

#: tensors at least this large record the port's line that made them
WHERE_BYTES = 1 << 26


def _where() -> str:
    """The innermost frame of the port's source on the stack, file:line."""
    for fr in reversed(traceback.extract_stack(limit=40)):
        if "repro_torch" in fr.filename:
            return f"{fr.filename.split('src/')[-1]}:{fr.lineno} {fr.name}"
    return ""


def observe(top: int):
    """Wrap the counting mode's dispatch; returns the peak's snapshot holder."""
    from repro_torch.launch import roofline

    live, snap = {}, {"peak": -1, "tensors": []}
    count = roofline._CountMode.__torch_dispatch__

    def dispatch(self, func, types, args=(), kwargs=None):
        n = self.c.n_ops
        out = count(self, func, types, args, kwargs)
        if self.c.n_ops > n and roofline._alias(func) == "":
            for t in roofline._tensors(out):
                nb = roofline._nbytes(t)
                live[id(t)] = (func._overloadpacket.__name__, list(t.shape),
                               str(t.dtype).replace("torch.", ""), nb,
                               _where() if nb >= WHERE_BYTES else "")
                weakref.finalize(t, live.pop, id(t), None)
            if self.peak > snap["peak"]:
                snap["peak"] = self.peak
                snap["tensors"] = sorted(live.values(), key=lambda v: -v[3])[:top]
        return out

    roofline._CountMode.__torch_dispatch__ = dispatch
    return snap


def one_cell(arch: str, shape: str, multi: bool, top: int) -> dict:
    from repro_torch.launch import dryrun

    snap = observe(top)
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, multi, verbose=False)
    out = {"arch": arch, "shape": shape, "mesh": rec["mesh"], "status": rec["status"],
           "seconds": round(time.perf_counter() - t0, 1)}
    if rec["status"] == "ok":
        mem = rec["memory_analysis"]
        out.update(peak_gb=mem["peak_bytes"] / 1e9, argument_gb=mem["argument_size_bytes"] / 1e9,
                   temp_gb=mem["temp_size_bytes"] / 1e9, fits_hbm=mem["fits_hbm"],
                   collective_bytes_by_kind=rec["collective_bytes_by_kind"],
                   at_peak=[{"op": op, "shape": s, "dtype": dt, "gb": nb / 1e9, "at": where}
                            for op, s, dt, nb, where in snap["tensors"]])
    return out


def main(argv=None) -> None:
    from repro_torch.configs import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--all", action="store_true", help="every arch")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--out", default=None, help="append the lines to this file too")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = [(a, m) for a in archs for m in meshes]
    if len(cells) == 1:
        lines = [json.dumps(one_cell(cells[0][0], args.shape, cells[0][1], args.top))]
    else:
        env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join([str(SRC)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))

        def run(cell):
            arch, multi = cell
            proc = subprocess.run([sys.executable, __file__, "--arch", arch, "--shape", args.shape,
                                   "--mesh", "multi" if multi else "single", "--top",
                                   str(args.top)], env=env, capture_output=True, text=True)
            got = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
            return got[-1] if got else json.dumps(
                {"arch": arch, "shape": args.shape, "multi": multi, "status": "FAILED",
                 "error": proc.stderr[-600:]})

        lines = []
        with ThreadPoolExecutor(args.jobs) as pool:
            for f in as_completed([pool.submit(run, c) for c in cells]):
                lines.append(f.result())
                print(lines[-1], flush=True)
    if len(cells) == 1:
        print(lines[0], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(ln + "\n" for ln in lines)


if __name__ == "__main__":
    main()
