"""SFNO on the spherical shallow-water equations (the paper's SWE
protocol): data generated on the fly each step by the port's spherical
solver, trained under the mixed-precision policy with tanh stabilisation.

    PYTHONPATH=src python -m repro_torch.examples.spherical_swe [--steps 20]
    PYTHONPATH=src python -m repro_torch.examples.spherical_swe --device cpu --steps 4
"""
import argparse

import torch

from repro_torch.core.schedule import PrecisionSchedule
from repro_torch.data import sample_swe_batch
from repro_torch.models import SFNOConfig, init_sfno, sfno_apply
from repro_torch.optim import AdamW
from repro_torch.precision import FULL
from repro_torch.train import Trainer, TrainerConfig, relative_l2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = args.device

    cfg = SFNOConfig(in_channels=3, out_channels=3, hidden_channels=16,
                     n_layers=2, nlat=32, nlon=64, lmax=16, mmax=16,
                     lifting_channels=16, projection_channels=16)
    model = init_sfno(torch.Generator().manual_seed(0), cfg, device=dev)

    def loss_fn(m, batch, policy):
        return relative_l2(sfno_apply(m, batch["x"], policy), batch["y"])

    def batch_fn(step):
        # on-the-fly data generation, as in the paper's SWE setup
        x, y = sample_swe_batch(torch.Generator().manual_seed(100 + step), 32, 64, 4,
                                steps=40, device=dev)
        return {"x": x, "y": y}

    trainer = Trainer(loss_fn, model, TrainerConfig(
        total_steps=args.steps, schedule=PrecisionSchedule.constant("mixed_fno_bf16"),
        optimizer=AdamW(lr=2e-3)), device=dev)
    hist = trainer.run(batch_fn)
    for h in hist:
        if h["step"] % 5 == 0 or h["step"] == args.steps - 1:
            print(f"step {h['step']:3d}  rel-L2 {h['loss']:.4f}")

    x, y = sample_swe_batch(torch.Generator().manual_seed(999), 32, 64, 4, steps=40,
                            device=dev)
    with torch.no_grad():
        e = float(relative_l2(sfno_apply(trainer.model, x, FULL), y))
    print(f"eval rel-L2 (fresh ICs): {e:.4f}")
    return {"history": hist, "eval": e}


if __name__ == "__main__":
    main()
