"""One rank of an FNO-family dry-run cell, on the card, at full width.

The dry-run (``launch.dryrun_fno``) derives a production-mesh rank's peak
and collectives from a step traced on fake CPU tensors.  This runs that
rank's step for real: a fake process group of the mesh's size (this
process is rank 0; ``dryrun.cell_world``), the 16x16 production mesh on
``cuda``, the cell's model at its published width (seeded weights) placed
by ``fno_param_specs``, the global batch placed by ``fno_batch_specs``
(each rank keeps its block; nothing is sent), and 3 ``mixed_fno_bf16``
steps of ``build_fno_train_step``, with the hidden channels split over
"model" where the batch does not cover the mesh.  A fake group's
collectives return at once and move nothing, so the values the steps
compute mean nothing: the record holds each step's milliseconds (CUDA
events), ``torch.cuda.max_memory_allocated`` and the launches of every
spectral kernel, beside the cell's channel layout.

    PYTHONPATH=src python -m repro_torch.launch.rank_step --cell tfno-ns-hr --cell sfno-swe

prints one JSON line a cell.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

#: every kernel launch counter of ``kernels.spectral_contract``, by kernel
COUNTERS = {"dense_fwd": "launches", "dense_bwd_x": "launches_bwd_x",
            "dense_bwd_w": "launches_bwd_w", "cp_fwd": "launches_cp_fwd",
            "cp_bwd": "launches_cp_bwd", "ls_fwd": "launches_ls_fwd",
            "ls_bwd_x": "launches_ls_bwd_x", "ls_bwd_w": "launches_ls_bwd_w",
            "fused_fwd": "launches_fused_fwd", "fused_bwd": "launches_fused_bwd"}


#: the policy of the steps, and how many
POLICY, STEPS = "mixed_fno_bf16", 3


def run(name: str, *, steps: int = STEPS, device: str = "cuda", mesh_shape=None,
        cell=None) -> dict:
    """Rank 0's ``steps`` ``POLICY`` steps of the dry-run cell ``name`` on
    the 16x16 mesh on ``device`` (the card unless the caller names the CPU,
    where the kernels' plain versions run and nothing is timed on a
    device).  ``mesh_shape`` replaces that mesh; ``cell`` (a dict
    like ``FNO_CELLS``'s) replaces the named cell, as in
    ``dryrun_fno.run_fno_cell``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import distribute, fno_param_specs
    from repro_torch.kernels import spectral_contract as sc
    from repro_torch.launch.dryrun_fno import FNO_CELLS
    from repro_torch.launch.dryrun import cell_world
    from repro_torch.launch.mesh import production_shape
    from repro_torch.launch.steps import (
        batch_axes,
        build_fno_train_step,
        channel_axis,
        fno_batch_specs,
    )
    from repro_torch.models import init_fno
    from repro_torch.models.sfno import init_sfno
    from repro_torch.optim import AdamW
    from repro_torch.precision import get_policy

    spec = cell or FNO_CELLS[name]
    cfg, B, res = spec["cfg"], spec["batch"], spec["res"]
    shape, names = production_shape(False)
    if mesh_shape is not None:
        shape, names = tuple(mesh_shape), names[-len(mesh_shape):]
    card = torch.device(device).type == "cuda"
    world = 1
    for s in shape:
        world *= s
    init = init_sfno if spec["kind"] == "sfno" else init_fno
    with cell_world(world):
        mesh = init_device_mesh(device, shape, mesh_dim_names=names)
        model = init(torch.Generator().manual_seed(0), cfg, device=device)
        distribute(model, mesh, fno_param_specs(model, mesh))
        g = torch.Generator(device=device).manual_seed(1)
        batch = {"x": torch.randn(B, cfg.in_channels, *res, generator=g, device=device),
                 "y": torch.randn(B, cfg.out_channels, *res, generator=g, device=device)}
        batch = distribute(batch, mesh, fno_batch_specs(batch, mesh))
        opt = AdamW(lr=1e-3)
        state = opt.init(dict(model.named_parameters()))
        step = build_fno_train_step(get_policy(POLICY), mesh, opt)
        axes = batch_axes(mesh, tuple(batch["x"].shape))
        ch_ax = channel_axis(mesh, tuple(batch["x"].shape), cfg.hidden_channels)
        del g
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before = {k: getattr(sc, c) for k, c in COUNTERS.items()}
        ms = []
        t0 = time.perf_counter()
        for _ in range(steps):
            if card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            model, state, _ = step(model, state, batch)
            if card:
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
        wall = time.perf_counter() - t0
        launches = {k: getattr(sc, c) - before[k] for k, c in COUNTERS.items()}
        peak = torch.cuda.max_memory_allocated() if card else None
        local_batch = tuple(batch["x"].to_local().shape)
    return {"cell": name, "mesh": "x".join(map(str, shape)), "rank": 0, "policy": POLICY,
            "steps": steps, "batch_axes": list(axes), "channels_over": ch_ax,
            "local_batch": list(local_batch), "hidden": cfg.hidden_channels,
            "channels_a_rank": cfg.hidden_channels // (mesh.size(names.index(ch_ax))
                                                         if ch_ax else 1),
            "device": device, "ms_per_step": ms, "seconds": wall,
            "max_memory_allocated_bytes": peak,
            "launches": {k: v for k, v in launches.items() if v},
            "note": "a fake process group moves no data: the values mean nothing; "
                    "time, memory and launches only"}


def main(argv=None) -> None:
    from repro_torch.launch.dryrun_fno import FNO_CELLS

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", choices=list(FNO_CELLS), required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rank_step runs on the card: torch.cuda.is_available() is false")
    for name in args.cell:
        print(json.dumps(run(name)), flush=True)


if __name__ == "__main__":
    main()
