#!/usr/bin/env python3
"""Time phases of ``chip_smoke.py`` from two checkouts in turns on one GPU.

    python3 tools/ab_phases.py OTHER_DIR [--phases dense,cp,bits,...]

OTHER_DIR is another checkout of this repository, labelled "parent" (for
example the parent commit, ``git archive``d into a directory that
``.gitignore`` lists); this checkout is labelled "change".  The phases run
four times, parent, change, change, parent, each turn in a child process
whose imports come from one checkout alone (its ``chip_smoke.py`` and its
``src/``), so the two builds of the kernels never share a process.  Every
JSON line a child prints is printed again with ``"turn"`` and
``"checkout"`` added; other lines (ptxas reports) are dropped.

Phases, each a function of the checkout's own ``chip_smoke.py``:

- ``flash``: ``lm_kernel_phase``, RMSNorm and flash attention at the LM
  pool's shapes, checked against their plain versions and timed;
- ``ls``: ``ls_timing_phase``, ``ls_fwd``, ``ls_bwd_x`` and ``ls_bwd_w``
  at the SFNO path's shape;
- ``sfno_serve``: ``swe_data``, then ``sfno_serve_phase``, the SFNO
  served on 16 fields under ``mixed_fno_bf16`` and ``full`` with its
  checks and a profiled tick each;
- ``sfno_train``: ``swe_data`` (once for both SFNO phases), then
  ``sfno_train_phase``, the SFNO's 12 training steps with their checks
  and profiles;
- ``dense``: ``timing_phase``, ``dense_fwd``, ``dense_bwd_x`` and
  ``dense_bwd_w`` at the Darcy path's shape;
- ``cp``: ``cp_timing_phase``, ``cp_fwd`` and ``cp_bwd`` at the TFNO
  path's shape;
- ``tfno_serve``: ``tfno_serve_phase``, the TFNO served at 128² and 256²
  under ``mixed_fno_bf16`` and ``full`` with its checks and profiled ticks;
- ``tfno_train``: ``tfno_train_phase``, its Navier-Stokes pairs and 12
  training steps with their checks and profiles;
- ``darcy_staged_train``: ``train_phase``, the staged Darcy FNO's pairs and
  12 training steps with their checks and profiles;
- ``darcy_staged_serve``: ``serve_phase``, the staged Darcy FNO served at
  128² and 421² under ``mixed_fno_bf16`` and ``full`` with its checks and
  profiled ticks;
- ``fused``: ``fused_timing_phase``, ``fused_fwd`` and ``fused_bwd`` at the
  Darcy path's shape at 128² and 421² in their five modes, beside the fused
  and the staged layer;
- ``darcy_fused_serve``: ``serve_phase(fused=True)``, the fused Darcy FNO
  served as the staged one is;
- ``darcy_fused_train``: ``darcy_data``, then ``fused_train_phase``, the
  fused Darcy FNO's 12 training steps with their checks and profiles;
- ``bits``: a digest of each dense, CP and fused kernel's outputs at its
  path's shape in each mode (the dense ones also at ``RAGGED_SHAPE`` and at
  the path's shape with B = 17; the fused ones in their five modes, with
  one batch tile and with two), from the same seeded operands in every turn;
  after the turns a ``bits_compare`` line names the kernels and modes whose
  digests agree between the two checkouts and those that differ.

Exits non-zero if a child fails.  Needs one card.
"""
import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PHASES = ("flash", "ls", "sfno_serve", "sfno_train", "dense", "cp", "tfno_serve", "tfno_train",
          "darcy_staged_train", "darcy_staged_serve", "fused", "darcy_fused_serve",
          "darcy_fused_train", "bits")


def bits(cs, sc):
    """Digests of the dense, CP and fused kernels' outputs, from seeded
    operands."""
    import hashlib

    import torch

    def digest(ts):
        h = hashlib.sha1()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    # the path's shape, the ragged one (staged element by element where a
    # half g's rows are off 16 bytes) and the path's with three batch tiles
    B, I, O, M = cs.PATH_SHAPE
    for shape in (cs.PATH_SHAPE, cs.RAGGED_SHAPE, (17, I, O, M)):
        ops = cs.operands(shape, 500)
        at = "" if shape == cs.PATH_SHAPE else "/" + "x".join(map(str, shape))
        for cast_to, dt in cs.MODES:
            g = cs.cotangent(shape, dt, 501)
            out[f"dense_fwd/{dt}{at}"] = digest(
                sc.spectral_contract_dense(*ops, cast_to=cast_to, out_dtype=dt))
            out[f"dense_bwd_x/{dt}{at}"] = digest(sc._launch_bwd_x(*g, ops[2], ops[3], cast_to))
            out[f"dense_bwd_w/{dt}{at}"] = digest(sc._launch_bwd_w(ops[0], ops[1], *g, cast_to))
    for dtype in cs.CP_DTYPES:
        cops = cs.cp_operands(cs.CP_PATH_SHAPE, dtype, 502)
        out[f"cp_fwd/{dtype}"] = digest(sc._launch_cp_fwd(*cops[:8]))
        out[f"cp_bwd/{dtype}"] = digest(sc._launch_cp_bwd(*cops))
    # the Darcy path's shape (one batch tile) and a shape of two tiles
    for shape in (cs.FUSED_SHAPES[0], (11, 3, 4, (16, 16), (4, 5))):
        x, wgr, wgi, g = cs.fused_operands(shape, 503)
        tiles = -(-shape[0] // sc.pick_block_b(*shape))
        for cast_to, sim_fmt in cs.FUSED_MODES:
            key = f"{cs.mode_name(cast_to, sim_fmt)}/{tiles}_tiles"
            modes = shape[-1]
            out[f"fused_fwd/{key}"] = digest(
                [sc._launch_fused_fwd(x, wgr, wgi, modes, cast_to, sim_fmt)])
            out[f"fused_bwd/{key}"] = digest(
                sc._launch_fused_bwd(x, wgr, wgi, g, modes, cast_to, sim_fmt))
    cs.emit("bits", digests=out)


def turn(checkout: Path, phases):
    """Run ``phases`` from ``checkout``'s chip_smoke.py in this process."""
    sys.path[:0] = [str(checkout / "src"), str(checkout)]
    import chip_smoke as cs
    from repro_torch.kernels import spectral_contract as sc

    cs.device_phase()
    cs.build_phase()
    swe = darcy = None
    for phase in phases:
        if phase == "flash":
            cs.lm_kernel_phase()
        elif phase == "ls":
            cs.ls_timing_phase(sc, defaultdict(float), defaultdict(int))
        elif phase == "dense":
            cs.timing_phase(sc, defaultdict(float), defaultdict(int))
        elif phase == "cp":
            cs.cp_timing_phase(sc, defaultdict(float), defaultdict(int))
        elif phase == "tfno_serve":
            cs.tfno_serve_phase(sc)
        elif phase == "tfno_train":
            cs.tfno_train_phase(sc)
        elif phase == "darcy_staged_train":
            cs.train_phase(sc)
        elif phase == "darcy_staged_serve":
            cs.serve_phase(sc)
        elif phase == "fused":
            cs.fused_timing_phase(sc, defaultdict(float), defaultdict(int))
        elif phase == "darcy_fused_serve":
            cs.serve_phase(sc, fused=True)
        elif phase == "darcy_fused_train":
            darcy = cs.darcy_data() if darcy is None else darcy
            cs.fused_train_phase(sc, darcy)
        elif phase == "bits":
            bits(cs, sc)
        else:
            swe = cs.swe_data() if swe is None else swe
            (cs.sfno_serve_phase if phase == "sfno_serve" else cs.sfno_train_phase)(sc, swe)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="the other checkout (labelled parent)")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if any(p not in PHASES for p in phases):
        ap.error(f"phases are {PHASES}, got {phases}")
    if args.turn:          # a child: `other` is the checkout to run
        turn(args.other.resolve(), phases)
        return 0
    checkouts = {"parent": args.other.resolve(), "change": HERE}
    digests = defaultdict(dict)      # kernel/mode -> {checkout: {digests of its turns}}
    for k, label in enumerate(("parent", "change", "change", "parent")):
        child = subprocess.run(
            [sys.executable, __file__, str(checkouts[label]), "--phases", args.phases,
             "--turn"], capture_output=True, text=True, check=False)
        for line in child.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                print(json.dumps({"turn": k, "checkout": label, **row}), flush=True)
                for key, d in row.get("digests", {}).items():
                    digests[key].setdefault(label, set()).add(d)
        if child.returncode != 0:
            print(child.stderr[-4000:], file=sys.stderr)
            print(f"ab_phases: turn {k} ({label}) failed with {child.returncode}",
                  file=sys.stderr)
            return 1
    if digests:
        same = sorted(k for k, d in digests.items()
                      if len(d.get("parent", ())) == 1 and d.get("parent") == d.get("change"))
        print(json.dumps({"phase": "bits_compare", "same": same,
                          "differ": sorted(set(digests) - set(same))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
