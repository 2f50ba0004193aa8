"""PDE-inference-as-a-service demo: micro-batched mixed-precision FNO
serving on the GPU.

Submits Darcy-style coefficient fields at two resolutions; the
``OperatorEngine`` buckets them by grid, pads each micro-batch to a fixed
width, and runs the batched ``fno_infer`` under the requested precision
rule set.  Batched outputs are checked bit-identical against a solo run:
micro-batching is a pure throughput knob.

    PYTHONPATH=src python -m repro_torch.examples.serve_darcy --policy mixed_fno_bf16
    PYTHONPATH=src python -m repro_torch.examples.serve_darcy --device cpu
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE
from repro_torch.data import grf_2d
from repro_torch.models import init_fno
from repro_torch.precision import get_policy
from repro_torch.serve import FieldRequest, OperatorEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="mixed_fno_bf16")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--scheduler", default="fcfs", choices=["fcfs", "spf"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()

    cfg = FNO_DARCY_SMOKE
    policy = get_policy(args.policy)
    net = init_fno(torch.Generator().manual_seed(0), cfg, device=args.device)
    engine = OperatorEngine(net, model="fno", policy=policy,
                            max_batch=args.max_batch,
                            scheduler=args.scheduler, device=args.device)

    gen = torch.Generator().manual_seed(1)
    reqs = []
    for i in range(args.requests):
        n = 16 if i % 2 else 32   # two resolution buckets
        a = grf_2d(gen, n, batch=1).numpy()          # (1, n, n) coeff field
        reqs.append(FieldRequest(uid=i, x=a))
    for r in reqs:
        engine.submit(r)
    done, ticks = engine.drain()
    stats = engine.stats()
    print(f"policy={args.policy} max_batch={args.max_batch}: served "
          f"{stats['fields_served']} fields in {ticks} ticks "
          f"({stats['fields_per_s']} fields/s on {stats['device']}); "
          f"buckets={stats['buckets']}")

    # micro-batching is bit-exact: replay one request through a fresh engine
    probe = done[0]
    solo = OperatorEngine(net, model="fno", policy=policy,
                          max_batch=args.max_batch, device=args.device)
    sr = FieldRequest(uid=0, x=probe.x)
    solo.submit(sr)
    solo.drain()
    if not np.array_equal(sr.y, probe.y):
        raise SystemExit("batched != solo")
    print("batched == solo: bit-identical")
    print("stats:", json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
