"""Dry-run of the paper's own FNO-family configs at pod scale, on the CPU.

The cells most representative of the paper's technique, traced under the
paper-faithful mixed policy (``mixed_fno_bf16``) by default:

  tfno-ns     train 128x128, global batch 1024 (CP-factorised weights)
  tfno-ns-hr  train 512x512, global batch 64   (the paper's super-res goal)
  fno-darcy   train 128x128, global batch 1024
  sfno-swe    train 256x512, global batch 128

Each on the 16x16 and 2x16x16 meshes of a fake process group, the train
step of ``launch.steps.build_fno_train_step`` under ``fno_param_specs``:
the full-DP layout made explicit (each rank its share of the batch,
sharded weights gathered before the forward, gradients summed in f32 into
each parameter's placement).  No kernel can launch on a fake tensor, so
the trace runs the spectral layers' plain versions on fake CPU tensors;
the record carries the launch plan a rank would run on the card beside
the counts (``spectral_kernel``, from ``roofline.spectral_kernel_smem``).
Where the batch does not cover the mesh the hidden channels split over the
model axis, as the reference's ``constrain_spatial`` lays them out
(``"spectral_channels": "sharded over tp"``): each rank transforms its own
channel block, gathers the truncated spectra over tp and contracts them
against its output-channel block of the weight, so the plan is at (B a
rank, I = H, O = H / tp), staged for a dense layer, and the collectives
gain the spectra's all-gathers and their reduce-scatters.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_fno --cell fno-darcy --mesh both
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Optional, Tuple

import torch

from repro_torch.configs.fno_paper import FNO_DARCY, SFNO_SWE, TFNO_NS
from repro_torch.dist import use_mesh
from repro_torch.dist.sharding import distribute, fno_param_specs, replication_report
from repro_torch.launch.dryrun import (
    RESULTS,
    cell_world,
    make_mesh,
    memory_analysis,
    mesh_name,
    save_result,
    telemetry_overhead,
)
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.roofline import analyze_counts, count_step, link_bw, spectral_kernel_smem
from repro_torch.launch.steps import (
    batch_axes,
    build_fno_train_step,
    channel_axis,
    fno_batch_specs,
)
from repro_torch.optim import AdamW

FNO_CELLS = {
    "tfno-ns": dict(kind="fno", cfg=TFNO_NS, res=(128, 128), batch=1024),
    "tfno-ns-hr": dict(kind="fno", cfg=TFNO_NS, res=(512, 512), batch=64),
    "fno-darcy": dict(kind="fno", cfg=FNO_DARCY, res=(128, 128), batch=1024),
    "sfno-swe": dict(kind="sfno", cfg=SFNO_SWE, res=(256, 512), batch=128),
}


def _model(spec):
    from repro_torch.models.fno import FNO
    from repro_torch.models.sfno import SFNO

    with torch.device("meta"):
        return (FNO if spec["kind"] == "fno" else SFNO)(spec["cfg"])


def spectral_record(spec, B_local: int, policy, tp: int = 1) -> dict:
    """The launch plan of the cell's first spectral layer on one rank of
    the card: every input channel against the rank's block of ``H / tp``
    output channels (``tp`` 1: the channels whole).  Split channels are
    planned in a ``dist.channels`` scope of ``tp`` ranks, as the step runs
    them, so a dense layer plans the staged kernels."""
    from repro_torch.dist import channels

    cfg = spec["cfg"]
    h = cfg.hidden_channels
    o = h // tp
    if spec["kind"] == "sfno":
        return spectral_kernel_smem(B_local, h, o, (cfg.lmax, cfg.mmax), l_shared=True,
                                    policy=policy, site="sfno/layer0/spectral")
    rank = 0
    if getattr(cfg, "factorization", "dense") == "cp":
        from repro_torch.core.spectral import cp_rank

        rank = cp_rank(h, h, cfg.rank)
    # the plan reads the scope only; no collective runs, so no group
    with channels.channel_scope(None, 0, tp):
        return spectral_kernel_smem(B_local, h, o, cfg.modes, spatial=spec["res"],
                                    rank=rank, policy=policy, site="fno/layer0/spectral")


def run_fno_cell(name: str, multi_pod: bool, policy_name: str = "mixed_fno_bf16",
                 verbose: bool = True, telemetry: bool = False, *,
                 mesh_shape: Optional[Tuple[int, ...]] = None, cell: Optional[dict] = None
                 ) -> dict:
    """One FNO cell's record.  ``mesh_shape`` replaces the production mesh;
    ``cell`` (a dict like ``FNO_CELLS``'s) replaces the named cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.precision import describe, get_policy

    spec = cell or FNO_CELLS[name]
    cfg = spec["cfg"]
    policy = get_policy(policy_name)
    if mesh_shape is None:
        mshape, names = production_shape(multi_pod)
    else:
        mshape = tuple(mesh_shape)
        names = ("pod", "data", "model")[-len(mshape):]
    B, res = spec["batch"], spec["res"]
    rec = {"arch": name, "shape": f"train_{res[0]}x{res[1]}_b{B}",
           "mesh": mesh_name(mshape), "kind": "train", "policy": policy_name,
           "policy_sites": describe(policy)}
    n_dev = 1
    for s in mshape:
        n_dev *= s
    link = link_bw(mshape)
    t0 = time.perf_counter()
    with cell_world(n_dev):
        mesh = make_mesh(mshape, names)
        model = _model(spec)
        param_specs = fno_param_specs(model, mesh)
        rep = replication_report(model, param_specs)
        batch_shape = {"x": (B, cfg.in_channels, *res), "y": (B, cfg.out_channels, *res)}
        axes = batch_axes(mesh, batch_shape["x"])
        ch_ax = channel_axis(mesh, batch_shape["x"], cfg.hidden_channels)
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            model.to_empty(device="cpu")
            distribute(model, mesh, param_specs)
            opt = AdamW(lr=1e-3)
            # moments like the parameters: DTensors at their placements
            opt_state = opt.init(dict(model.named_parameters()))
            batch = {k: torch.empty(s) for k, s in batch_shape.items()}
            batch = distribute(batch, mesh, fno_batch_specs(batch, mesh))
        step = build_fno_train_step(policy, mesh, opt)
        args = (model, opt_state, batch)
        with use_mesh(mesh):
            out, counts = count_step(step, *args)
        mem = memory_analysis(args, out, counts)
        if telemetry:
            from repro_torch.autoprec import TraceCollector, collecting

            def telem_step(*a):
                with collecting(TraceCollector()):
                    return step(*a)
            t1 = time.perf_counter()
            with use_mesh(mesh):
                _, t_counts = count_step(telem_step, *args)
            t_s = time.perf_counter() - t1
    roof = analyze_counts(counts, n_dev, link)
    n_batch = 1
    for ax in axes:
        n_batch *= int(mshape[names.index(ax)])
    covered = set(axes) == set(names)
    tp = int(mshape[names.index(ch_ax)]) if ch_ax else 1
    rec["spectral_kernel"] = spectral_record(spec, max(1, B // n_batch), policy, tp)
    rec["spectral_channels"] = ("whole (full-DP: the batch covers the mesh)" if covered
                                else "sharded over tp" if ch_ax else "whole (replicated over tp)")
    rec.update({
        "status": "ok",
        "compile_s": round(time.perf_counter() - t0, 1),
        "n_devices": n_dev,
        "link_bw": link,
        "batch_axes": list(axes),
        "memory_analysis": mem,
        "cost_analysis_raw": {"flops": counts.flops, "bytes accessed": counts.bytes,
                              "ops": counts.n_ops},
        "collective_bytes_by_kind": dict(counts.collective_by_kind),
        "roofline": roof.to_dict(),
        "replication": rep,
    })
    if telemetry:
        t_roof = analyze_counts(t_counts, n_dev, link)
        rec["telemetry"] = {"compile_s": round(t_s, 1), "roofline": t_roof.to_dict(),
                            "overhead": telemetry_overhead(roof, t_roof)}
    if verbose:
        print(f"== {name} ({policy_name}) on {rec['mesh']} ==")
        print("memory:", rec["memory_analysis"])
        print("collectives:", rec["collective_bytes_by_kind"])
        print("roofline:", json.dumps(rec["roofline"], indent=2))
        print("spectral kernel:", json.dumps(rec["spectral_kernel"]))
        if "telemetry" in rec:
            print("telemetry overhead:", rec["telemetry"]["overhead"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, choices=list(FNO_CELLS) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--policy", default="mixed_fno_bf16")
    ap.add_argument("--telemetry", action="store_true",
                    help="also trace the autoprec-instrumented step and record the "
                         "telemetry overhead")
    ap.add_argument("--out", default=RESULTS, help="the results file")
    args = ap.parse_args(argv)
    cells = [args.cell] if args.cell else list(FNO_CELLS)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = []
    for c in cells:
        for mp in meshes:
            try:
                rec = run_fno_cell(c, mp, args.policy, telemetry=args.telemetry)
            except Exception as e:  # a failure here is a bug
                traceback.print_exc()
                rec = {"arch": c, "shape": "train", "mesh": mesh_name(production_shape(mp)[0]),
                       "policy": args.policy, "status": "FAILED",
                       "error": f"{type(e).__name__}: {e}"}
                failures.append(rec)
            save_result(rec, args.out)
    if failures:
        raise SystemExit(1)
    print("fno cells passed")


if __name__ == "__main__":
    main()
