"""Quickstart: the paper's mixed-precision FNO in a few lines, in the port.

Builds a small FNO, runs it under the full-precision and mixed-precision
policies, shows the memory-greedy contraction order, and checks
Theorems 3.1/3.2 empirically.  On the card unless told otherwise:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import theory
from repro_torch.core.contraction import greedy_path, path_intermediate_bytes
from repro_torch.models import FNOConfig, fno_apply, init_fno
from repro_torch.precision import FULL, get_policy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # 1. a small FNO
    cfg = FNOConfig(in_channels=1, out_channels=1, hidden_channels=32,
                    lifting_channels=32, projection_channels=32, n_layers=4, modes=(12, 12))
    model = init_fno(torch.Generator().manual_seed(0), cfg, device=args.device)
    dev = next(model.parameters()).device
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 1, 64, 64).astype(np.float32)).to(dev)

    # 2. full vs mixed precision forward
    with torch.no_grad():
        y_full = fno_apply(model, x, FULL)
        y_mixed = fno_apply(model, x, get_policy("mixed_fno_bf16"))
    rel = float(torch.linalg.vector_norm(y_mixed.float() - y_full)
                / torch.linalg.vector_norm(y_full))
    print(f"mixed-vs-full relative error: {rel:.4f}  (paper: <1%)")

    # 3. the memory-greedy contraction order (paper §4.2 / Table 10)
    expr = "bixy,r,ir,or,xr,yr->boxy"   # TFNO CP contraction
    shapes = [(4, 32, 12, 12), (16,), (32, 16), (32, 16), (12, 16), (12, 16)]
    p_mem, p_flop = greedy_path(expr, shapes, "memory"), greedy_path(expr, shapes, "flops")
    peak_mem = path_intermediate_bytes(expr, shapes, p_mem)
    peak_flop = path_intermediate_bytes(expr, shapes, p_flop)
    print(f"greedy-memory path {p_mem}: peak intermediate {peak_mem} B vs "
          f"FLOP-optimal {peak_flop} B")

    # 4. theory: precision error is dominated by discretisation error
    def v(xs):
        return np.sin(2 * np.pi * xs[..., 0]) + 0.5 * np.prod(xs, axis=-1)

    disc = theory.disc_error(v, m=64, d=2, omega=1.0)
    prec = theory.prec_error(v, m=64, d=2, omega=1.0, dtype="float16")
    print(f"disc error {disc:.2e} vs fp16 precision error {prec:.2e} "
          f"-> half precision is 'free' (Thm 3.1/3.2)")
    crossover = theory.crossover_mesh_size(1e-4, 3)
    print(f"3-D crossover mesh size for fp16: {crossover:.2e} points (paper: ~1e6)")
    return {"mixed_vs_full": rel, "path_memory": p_mem, "path_flops": p_flop,
            "peak_memory_path": peak_mem, "peak_flops_path": peak_flop,
            "disc": disc, "prec": prec, "crossover": crossover}


if __name__ == "__main__":
    main()
