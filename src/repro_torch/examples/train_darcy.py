"""End-to-end driver: train a mixed-precision FNO on Darcy flow.

Generates the dataset with the port's CG solver, trains with the paper's
precision schedule (25 % mixed / 50 % AMP / 25 % full), dynamic loss
scaling where fp16 is involved, checkpoints and restarts, and evaluates
zero-shot super-resolution: the paper's Table 1 protocol at a small size.
``--auto-precision`` replaces the schedule with the telemetry-driven
controller and prints its decisions and the telemetry counters.
``--calibration-state`` serves the tuned kernels' tiles from a
``repro_torch.tune`` state; ``--obs-trace OUT_JSONL`` records the run's
timeline and metrics (``python -m repro_torch.obs summary OUT_JSONL``),
with a Chrome trace and a Prometheus snapshot beside it.

    PYTHONPATH=src python -m repro_torch.examples.train_darcy [--steps 60] [--n 32]
    PYTHONPATH=src python -m repro_torch.examples.train_darcy --device cpu --steps 8 --n 16
    PYTHONPATH=src python -m repro_torch.examples.train_darcy --auto-precision [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_darcy --device cpu --obs-trace build/run.jsonl
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.autoprec import AutoPrecisionController
from repro_torch.core.schedule import PrecisionSchedule
from repro_torch.data import sample_darcy_batch
from repro_torch.models import FNOConfig, fno_apply, init_fno
from repro_torch.optim import AdamW
from repro_torch.precision import FULL, FULL_PRECISION, get_policy, precision_rules
from repro_torch.train import Trainer, TrainerConfig, relative_l2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--half", default="bf16", choices=["bf16", "fp16"])
    ap.add_argument("--auto-precision", action="store_true",
                    help="replace the static 25/50/25 schedule with the telemetry-driven "
                         "controller: per-site formats follow runtime amax/overflow "
                         "counters and the Thm 3.1/3.2 budgets")
    ap.add_argument("--calibration-state", default=None,
                    help="repro_torch.tune calibration-state JSON: the tuned kernels "
                         "take its validated tiles instead of the heuristics' "
                         "(default: $REPRO_CALIBRATION_STATE if set)")
    ap.add_argument("--obs-trace", default=None, metavar="OUT_JSONL",
                    help="enable repro_torch.obs and write the run timeline + metrics "
                         "snapshot as JSONL, plus a Perfetto-loadable <stem>.trace.json "
                         "and a Prometheus <stem>.prom next to it; inspect with "
                         "`python -m repro_torch.obs summary OUT_JSONL`")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = args.device

    print("generating Darcy data (CG solver)...")
    a_tr, u_tr = sample_darcy_batch(torch.Generator().manual_seed(0), args.n, 64,
                                    maxiter=400, device=dev)
    a_te, u_te = sample_darcy_batch(torch.Generator().manual_seed(1), args.n, 16,
                                    maxiter=400, device=dev)
    a_hi, u_hi = sample_darcy_batch(torch.Generator().manual_seed(2), args.n * 2, 8,
                                    maxiter=800, device=dev)
    a_np, u_np = a_tr.cpu().numpy(), u_tr.cpu().numpy()

    cfg = FNOConfig(in_channels=1, out_channels=1, hidden_channels=24,
                    lifting_channels=24, projection_channels=24,
                    n_layers=3, modes=(8, 8))
    model = init_fno(torch.Generator().manual_seed(3), cfg, device=dev)

    def loss_fn(m, batch, policy):
        return relative_l2(fno_apply(m, batch["a"], policy), batch["u"])

    def batch_fn(step):
        idx = np.random.RandomState(step).randint(0, a_np.shape[0], 16)
        return {"a": a_np[idx], "u": u_np[idx]}

    with tempfile.TemporaryDirectory() as ckpt_dir:
        if args.auto_precision:
            # the taps measure per-site numerics in each forward; the
            # controller demotes spectral sites only while the Thm 3.2
            # budget stays inside the discretisation error at this grid,
            # and promotes them back on overflow streaks
            autoprec = AutoPrecisionController(base="full", grid_points=args.n ** 2,
                                               interval=5)
            schedule = PrecisionSchedule.auto("full", grid_points=args.n ** 2)
        else:
            autoprec = None
            schedule = PrecisionSchedule.paper_default(args.half)
        tcfg = TrainerConfig(
            total_steps=args.steps,
            schedule=schedule, autoprec=autoprec,
            optimizer=AdamW(lr=2e-3, weight_decay=1e-5),
            ckpt_dir=ckpt_dir, ckpt_every=20,
            calibration_state=args.calibration_state,
            obs=args.obs_trace is not None,
        )
        trainer = Trainer(loss_fn, model, tcfg, device=dev)
        trainer.install_preemption_handler()
        if args.auto_precision:
            print(f"training {args.steps} steps with bound-guided auto-precision "
                  f"(base=full) on {trainer.device}...")
        else:
            print(f"training {args.steps} steps with the paper schedule "
                  f"(25% mixed / 50% AMP / 25% full, half={args.half}) on {trainer.device}...")
        hist = trainer.run(batch_fn)
        for h in hist[:: max(1, len(hist) // 8)]:
            print(f"  step {h['step']:4d} policy={h['policy']:<16s} loss={h['loss']:.4f}")
        decisions = None
        if trainer.controller is not None:
            decisions = {g: s["fmt"] for g, s in trainer.controller.describe()["sites"].items()}
            print("auto-precision decisions:", decisions)
            counters = trainer.telemetry.counters()
            print(f"telemetry: {counters['steps']} steps, "
                  f"overflows={counters['overflow_total']:.0f}")

        # restart check from a checkpoint of the last step
        trainer.save(wait=True)
        t2 = Trainer(loss_fn, model, tcfg, device=dev)
        assert t2.restore(), "checkpoint restore failed"
        for k, p in trainer.params.items():
            assert torch.equal(p, t2.params[k]), f"restored {k} differs"
        print(f"restart OK from step {t2.step} (stats: {trainer.stats})")

        net = trainer.model
        with torch.no_grad():
            e_test = float(relative_l2(fno_apply(net, a_te, FULL), u_te))
            e_super = float(relative_l2(fno_apply(net, a_hi, FULL), u_hi))
            print(f"test rel-L2 @ {args.n}x{args.n}:      {e_test:.4f}")
            print(f"zero-shot super-res @ {2 * args.n}x{2 * args.n}: {e_super:.4f}")

            # the paper's mixed pipeline with the LAST FNO layer pinned to
            # full precision by a scoped per-site override
            mixed = get_policy(f"mixed_fno_{args.half}")
            e_mixed = float(relative_l2(fno_apply(net, a_te, mixed), u_te))
            with precision_rules((f"fno/layer{cfg.n_layers - 1}/*", FULL_PRECISION)):
                e_lastfull = float(relative_l2(fno_apply(net, a_te, mixed), u_te))
            print(f"mixed eval rel-L2:                 {e_mixed:.4f}")
            print(f"mixed, last layer full (override): {e_lastfull:.4f}")

    if args.obs_trace:
        from repro_torch.obs import (registry, run_records, trace, write_chrome_trace,
                                     write_jsonl, write_prometheus)

        recs = trace.snapshot()
        snap = registry().snapshot()
        write_jsonl(args.obs_trace,
                    run_records(recs, snapshot=snap, device=str(trainer.device),
                                run="train_darcy", steps=args.steps,
                                auto_precision=args.auto_precision))
        stem = os.path.splitext(args.obs_trace)[0]
        write_chrome_trace(stem + ".trace.json", recs)
        write_prometheus(stem + ".prom", snap)
        print(f"obs: {len(recs)} trace records -> {args.obs_trace} "
              f"(+ {stem}.trace.json, {stem}.prom); "
              f"render with `python -m repro_torch.obs summary {args.obs_trace}`")
    return {"history": hist, "test": e_test, "super": e_super,
            "mixed": e_mixed, "mixed_last_full": e_lastfull, "decisions": decisions}


if __name__ == "__main__":
    main()
