"""Batched LM serving demo: the Engine API over the slot engine.

Builds the reduced config of one architecture of the pool (``--arch``,
any decoder-only id), submits a stream of requests through the scheduler
(FCFS or shortest-prompt-first) and drives chunked-prefill decoding with
per-request sampling, on the GPU unless ``--device`` names another:

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --scheduler spf \\
        --temperature 0.8 --top-p 0.9 --prefill-chunk 16
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

Paged serving (``--paged``, ``--block-size``) and the deadline frontend
(``--slo-deadline-ms``) wait for the paged serving slice.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.lm import init_lm
from repro_torch.serve import LMEngine, Request, SamplingParams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--scheduler", default="fcfs", choices=["fcfs", "spf"])
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens consumed per tick (default: 8 dense, 1 MoE)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    if cfg.encoder_decoder:
        raise SystemExit("enc-dec serving demo: use whisper_decode_step directly")
    params = init_lm(torch.Generator().manual_seed(0), cfg, device=args.device)
    engine = LMEngine(params, cfg, n_slots=args.slots, max_len=64, scheduler=args.scheduler,
                      prefill_chunk=args.prefill_chunk, seed=args.seed, device=args.device)

    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p)
    rng = np.random.RandomState(0)
    reqs = [Request(uid=i, prompt=[int(t) for t in rng.randint(1, cfg.vocab, rng.randint(3, 8))],
                    max_new_tokens=8, sampling=sampling)
            for i in range(args.requests)]
    for r in reqs:
        engine.submit(r)
    done, ticks = engine.drain()
    stats = engine.stats()
    print(f"arch={args.arch} slots={args.slots} scheduler={args.scheduler} "
          f"chunk={engine.prefill_chunk}: served {stats['completed']} requests "
          f"in {ticks} ticks ({stats['wall_s']:.2f}s; "
          f"{stats['tokens_per_s']} tok/s on {stats['device']})")
    for r in done[:3]:
        print(f"  req {r.uid}: prompt={r.prompt} -> generated={r.generated}")
    print("stats:", json.dumps(stats, indent=1))
    return stats


if __name__ == "__main__":
    main()
