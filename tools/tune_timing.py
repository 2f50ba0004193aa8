#!/usr/bin/env python3
"""Time the tuner's unit three ways on one GPU, to show what its walls rank.

    python3 tools/tune_timing.py

For the order-shared keys of ``repro_torch.tune``'s ``DEFAULT_KEYS`` (bf16
and f32) at several ``ls_mix`` splits, and the fused layer's 128² bf16
key at its batch tiles, prints one JSON line per candidate:

- ``engine_us``: a forward plus backward through the autograd engine
  (``Function.apply`` and ``torch.autograd.grad``), CUDA events around 50
  back-to-back runs; ``engine_host_us``: the host's time per run;
- ``unit_us``: ``tune.measure``'s unit, the Function's own forward and
  backward without the engine, timed as ``measure`` times it (CUDA events
  around back-to-back runs for the fused kernels, a CUDA graph for the
  order-shared ones); ``unit_host_us``: the host's time per run of it;
- ``kernels_us``: each kernel launched alone, CUDA events around 50
  launches (order-shared: ``ls_fwd``, ``ls_bwd_x``, ``ls_bwd_w``).

The card's name and power limit come first.  Needs one card.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def events_us(fn, reps=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def host_us(fn, reps=50):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("tune_timing: needs an NVIDIA GPU")
    from repro_torch.kernels import spectral_contract as sc
    from repro_torch.tune import measure, space

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    cases = [(("lshared", (8, 64, 64, 128, 128), dt), tiles)
             for dt in ("bfloat16", "float32")
             for tiles in ((1, 1), (2, 2), (4, 4), (8, 8))]
    cases += [(("spectral_fused", (8, 64, 64, 128, 128, 32, 32), "bfloat16"), tiles)
              for tiles in ((8, 8), (4, 4), (2, 2))]
    for key, (bf, bb) in cases:
        cand = space.Candidate(*key, bf, bb)
        sets = measure.operand_sets(cand, dev)
        args = sets[0]
        n_cot = 2 if key[0] == "lshared" else 1
        leaves = [t.clone().requires_grad_() for t in args[:-n_cot]]

        def engine(leaves=leaves, cand=cand, cot=args[-n_cot:]):
            out = measure.forward(cand, leaves)
            return torch.autograd.grad(out if isinstance(out, tuple) else (out,), leaves, cot)

        unit = measure.build_step(cand)
        row = {"family": key[0], "shape": list(key[1]), "dtype": key[2], "tiles": [bf, bb],
               "engine_us": events_us(engine), "engine_host_us": host_us(engine),
               "unit_us": measure.measure(cand, device=dev, sets=sets)["wall_us"],
               "unit_host_us": host_us(lambda unit=unit, args=args: unit(*args))}
        if key[0] == "lshared":
            xr, xi, wr, wi, gr, gi = args
            row["kernels_us"] = {
                "ls_fwd": events_us(lambda a=(xr, xi, wr, wi, bf): sc._launch_ls_fwd(*a)),
                "ls_bwd_x": events_us(lambda a=(gr, gi, wr, wi, bb): sc._launch_ls_bwd_x(*a)),
                "ls_bwd_w": events_us(lambda a=(xr, xi, gr, gi): sc._launch_ls_bwd_w(*a))}
        print(json.dumps(row), flush=True)
        del sets, args, leaves
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
