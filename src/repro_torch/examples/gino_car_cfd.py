"""GINO on synthetic Shape-Net-Car-like CFD (the paper's irregular-geometry
setting): GNO encoder -> latent 3-D mixed-precision FNO -> GNO decoder,
predicting surface pressure from geometry.  Every step draws fresh car
shapes; the evaluation runs under ``full`` on shapes never seen.

    PYTHONPATH=src python -m repro_torch.examples.gino_car_cfd [--steps 15]
    PYTHONPATH=src python -m repro_torch.examples.gino_car_cfd --device cpu --steps 4
"""
import argparse

import torch

from repro_torch.core.schedule import PrecisionSchedule
from repro_torch.data import sample_car_batch
from repro_torch.models import FNOConfig, GINOConfig, gino_apply, init_gino
from repro_torch.optim import AdamW
from repro_torch.precision import FULL
from repro_torch.train import Trainer, TrainerConfig, relative_l2

#: the example's GINO: a 6³ latent grid, 3³ modes
EXAMPLE_CFG = GINOConfig(
    hidden=16, latent_grid=6, k_neighbors=6,
    fno=FNOConfig(in_channels=16, out_channels=16, hidden_channels=16,
                  lifting_channels=16, projection_channels=16,
                  n_layers=2, modes=(3, 3, 3), positional_embedding=False),
)
BATCH, N_POINTS = 4, 128


def loss_fn(model, batch, policy):
    return relative_l2(gino_apply(model, batch, policy), batch["labels"])


def car_batch(seed, cfg, n_points=N_POINTS, batch=BATCH, device=None):
    """One batch of ``batch`` fresh car shapes, its labels under ``labels``."""
    b, labels = sample_car_batch(seed, batch, n_points, cfg.latent_grid, cfg.k_neighbors,
                                 device=device)
    return {**b, "labels": labels}


def train(cfg=EXAMPLE_CFG, steps=15, n_points=N_POINTS, batch=BATCH, device=None, model=None):
    """The example's loop: AdamW(lr=2e-3) under ``mixed_fno_bf16``, step i on
    the car shapes of seed i.  ``model`` (default: ``init_gino`` from seed
    0) is left untouched; returns the trainer (its model: the trained one)."""
    if model is None:
        model = init_gino(torch.Generator().manual_seed(0), cfg, device=device)
    trainer = Trainer(loss_fn, model, TrainerConfig(
        total_steps=steps, schedule=PrecisionSchedule.constant("mixed_fno_bf16"),
        optimizer=AdamW(lr=2e-3)), device=device)
    trainer.run(lambda step: car_batch(step, cfg, n_points, batch, device))
    return trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    trainer = train(steps=args.steps, device=args.device)
    hist = trainer.history
    for h in hist:
        if h["step"] % 5 == 0 or h["step"] == args.steps - 1:
            print(f"step {h['step']:3d}  rel-L2 {h['loss']:.4f}")

    ev = car_batch(999, EXAMPLE_CFG, device=args.device)
    with torch.no_grad():
        e = float(relative_l2(gino_apply(trainer.model, ev, FULL), ev["labels"]))
    print(f"eval rel-L2 on fresh geometries: {e:.4f}")
    return {"history": hist, "eval": e}


if __name__ == "__main__":
    main()
