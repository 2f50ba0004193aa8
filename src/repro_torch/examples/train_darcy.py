"""End-to-end driver: train a mixed-precision FNO on Darcy flow.

Generates the dataset with the port's CG solver, trains with the paper's
precision schedule (25 % mixed / 50 % AMP / 25 % full), dynamic loss
scaling where fp16 is involved, checkpoints and restarts, and evaluates
zero-shot super-resolution: the paper's Table 1 protocol at a small size.

    PYTHONPATH=src python -m repro_torch.examples.train_darcy [--steps 60] [--n 32]
    PYTHONPATH=src python -m repro_torch.examples.train_darcy --device cpu --steps 8 --n 16
"""
import argparse
import tempfile

import numpy as np
import torch

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
        tcfg = TrainerConfig(
            total_steps=args.steps,
            schedule=PrecisionSchedule.paper_default(args.half),
            optimizer=AdamW(lr=2e-3, weight_decay=1e-5),
            ckpt_dir=ckpt_dir, ckpt_every=20,
        )
        trainer = Trainer(loss_fn, model, tcfg, device=dev)
        trainer.install_preemption_handler()
        print(f"training {args.steps} steps with the paper schedule "
              f"(25% mixed / 50% AMP / 25% full, half={args.half}) on {trainer.device}...")
        hist = trainer.run(batch_fn)
        for h in hist[:: max(1, len(hist) // 8)]:
            print(f"  step {h['step']:4d} policy={h['policy']:<16s} loss={h['loss']:.4f}")

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
    return {"history": hist, "test": e_test, "super": e_super,
            "mixed": e_mixed, "mixed_last_full": e_lastfull}


if __name__ == "__main__":
    main()
