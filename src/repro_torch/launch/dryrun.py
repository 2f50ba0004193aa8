"""Pod-scale dry-run: prove the distribution config is coherent, on the CPU.

For every (architecture x input shape) cell, on the single-pod 16x16 mesh
and the 2x16x16 multi-pod mesh: a fake process group of 256 or 512 ranks
(this process is rank 0), the step's state as fake tensors (made under
``FakeTensorMode``) placed by the ``repro_torch.dist`` rule tables
(``bundle_shardings``), and one step run on them under
``roofline.count_step``.  Nothing is
allocated and no device is needed; what a rank would hold, run, move and
send is counted:

    memory_analysis   argument, output and peak bytes a device, and
                      whether the peak fits an H100's 80 GB
    collectives       bytes a device by kind
    roofline          the three H100 terms (``roofline.analyze_counts``)

These are derived counts, not timings.  Records go to
``build/repro_torch_results/dryrun.json`` (one flat list, a record per
(arch, shape, mesh, policy), each with the shared result header).  A
failure here (a placement DTensor cannot run, a collective with no
strategy) is a bug in the system, not a skip.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from pathlib import Path
from typing import Any, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, cell_is_runnable, get_config
from repro_torch.dist import use_mesh
from repro_torch.dist.sharding import (
    distribute,
    lm_param_specs,
    replication_report,
    tree_leaves,
    tree_map_with_path,
)
from repro_torch.launch.mesh import fake_world, production_shape
from repro_torch.launch.roofline import Counts, analyze_counts, count_step, link_bw, model_flops
from repro_torch.launch.steps import build_step, build_train_step, bundle_shardings

RESULTS = str(Path(__file__).resolve().parents[3] / "build" / "repro_torch_results"
              / "dryrun.json")
#: an H100 SXM's HBM3, bytes (data sheet: 80 GB)
HBM_CAPACITY = 80e9


def mesh_name(shape) -> str:
    return "x".join(str(s) for s in shape)


@contextlib.contextmanager
def cell_world(world: int):
    """The default process group a cell runs in: the caller's when it has
    exactly ``world`` ranks, else a fake one for the scope."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"the cell needs a world of {world} ranks, the default "
                               f"process group has {dist.get_world_size()}")
        yield
        return
    with fake_world(world):
        yield


def make_mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def fake_like(tree: Any) -> Any:
    """Meta placeholders -> fake CPU tensors (call under FakeTensorMode);
    an ``nn.Module`` is converted in place.  Host tensors (a chunk step's
    ``n_valid``) stay as they are."""
    if isinstance(tree, torch.nn.Module):
        return tree.to_empty(device="cpu")

    def one(_, t):
        if torch.is_tensor(t) and t.is_meta:
            return torch.empty(t.shape, dtype=t.dtype, device="cpu")
        return t
    return tree_map_with_path(one, tree)


def place(tree: Any, mesh, specs: Any) -> Any:
    """Fake state placed by ``specs`` (None: left as it is)."""
    if specs is None:
        return tree
    return distribute(tree, mesh, specs)


def local_bytes(tree: Any) -> int:
    """Bytes a rank holds of a tree (the local shards of its DTensors)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if torch.is_tensor(t):
            total += t.numel() * t.element_size()
    return total


def trace(step_fn, args, mesh) -> Tuple[Any, Counts]:
    """One step on fake placed state under the counting mode: (result,
    counts).  The fake mode is not entered: the fake tensors carry it into
    every op on them, while DTensor's own bookkeeping (its shape
    propagation's index arithmetic) runs on real host tensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    with use_mesh(mesh), implicit_replication():
        return count_step(step_fn, *args)


def memory_analysis(args, out, counts: Counts) -> dict:
    arg = local_bytes(args)
    peak = arg + counts.temp_peak_bytes
    return {
        "argument_size_bytes": arg,
        "output_size_bytes": local_bytes(out),
        "temp_size_bytes": counts.temp_peak_bytes,
        "peak_bytes": peak,
        "fits_hbm": peak <= HBM_CAPACITY,
    }


def _resolve_shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def placed_args(bundle, cfg, mesh, param_specs):
    """The step's arguments as fake tensors placed on ``mesh`` by
    ``bundle_shardings`` (call under FakeTensorMode)."""
    in_specs, _ = bundle_shardings(bundle, cfg, mesh, param_specs)
    params = place(fake_like(bundle.params_shape), mesh, in_specs[0])
    if "opt_state" in bundle.extra_state_shape:
        rest = (fake_like(bundle.extra_state_shape["opt_state"]), fake_like(bundle.inputs["batch"]))
    elif "cache" in bundle.inputs:
        rest = (fake_like(bundle.inputs["cache"]), fake_like(bundle.inputs["tokens"]))
        if "n_valid" in bundle.inputs:
            rest = rest + (bundle.inputs["n_valid"],)
    else:
        rest = (fake_like(bundle.inputs["batch"]),)
    rest = tuple(place(t, mesh, s) for t, s in zip(rest, in_specs[1:], strict=True))
    return (params,) + rest


def run_cell(arch: str, shape: Union[str, ShapeConfig], multi_pod: bool,
             policy_name: str = "amp_bf16", verbose: bool = True,
             prefill_chunk: int = 0, telemetry: bool = False, *,
             mesh_shape: Optional[Tuple[int, ...]] = None, smoke: bool = False) -> dict:
    """One cell's record.  ``mesh_shape`` replaces the production mesh
    (a ("data", "model") or ("pod", "data", "model") mesh of that shape);
    ``smoke`` takes the arch's SMOKE config; ``shape`` may be a
    ``ShapeConfig`` of its own."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.precision import describe, get_policy

    cfg = get_config(arch, smoke=smoke)
    shape = _resolve_shape(shape)
    if mesh_shape is None:
        mshape, names = production_shape(multi_pod)
    else:
        mshape = tuple(mesh_shape)
        names = ("pod", "data", "model")[-len(mshape):]
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name(mshape),
           "kind": shape.kind, "policy": policy_name,
           # the resolved site table: which sites this cell ran at which formats
           "policy_sites": describe(get_policy(policy_name))}

    ok, reason = cell_is_runnable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    policy = get_policy(policy_name)
    n_dev = 1
    for s in mshape:
        n_dev *= s
    link = link_bw(mshape)
    t0 = time.perf_counter()
    with cell_world(n_dev):
        mesh = make_mesh(mshape, names)
        bundle = build_step(cfg, shape, policy)
        param_specs = lm_param_specs(bundle.params_shape, mesh)
        rep = replication_report(bundle.params_shape, param_specs)
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            args = placed_args(bundle, cfg, mesh, param_specs)
        out, counts = trace(bundle.step_fn, args, mesh)
        mem = memory_analysis(args, out, counts)
        del args, out
        if shape.kind == "train" and telemetry:
            t1 = time.perf_counter()
            tb = build_train_step(cfg, shape, policy, telemetry=True)
            with fake:
                t_args = placed_args(tb, cfg, mesh, param_specs)
            _, t_counts = trace(tb.step_fn, t_args, mesh)
            del t_args
            t_s = time.perf_counter() - t1
        if shape.kind == "decode" and prefill_chunk > 0 and not cfg.encoder_decoder:
            from repro_torch.launch.steps import build_prefill_chunk_step

            t1 = time.perf_counter()
            cb = build_prefill_chunk_step(cfg, shape, policy, chunk=prefill_chunk)
            with fake:
                c_args = placed_args(cb, cfg, mesh, param_specs)
            _, c_counts = trace(cb.step_fn, c_args, mesh)
            del c_args
            c_s = time.perf_counter() - t1
    roof = analyze_counts(counts, n_dev, link)

    # MODEL_FLOPS (6·N·D) vs the traced step's useful-compute ratio
    if shape.kind == "train":
        tokens = shape.global_batch * (cfg.max_dec_len if cfg.encoder_decoder
                                       else shape.seq_len)
        mf = model_flops(cfg.active_params_approx(), tokens)  # 6ND = fwd+bwd
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mf = 2.0 * cfg.active_params_approx() * tokens
    else:
        tokens = shape.global_batch  # one token per slot
        mf = 2.0 * cfg.active_params_approx() * tokens

    global_flops = roof.flops_per_device * n_dev
    rec.update({
        "status": "ok",
        "compile_s": round(time.perf_counter() - t0, 1),
        "n_devices": n_dev,
        "link_bw": link,
        "memory_analysis": mem,
        "cost_analysis_raw": {"flops": counts.flops, "bytes accessed": counts.bytes,
                              "ops": counts.n_ops},
        "flops_by_op": dict(counts.flops_by_op),
        "collective_bytes_by_kind": dict(counts.collective_by_kind),
        "roofline": roof.to_dict(),
        "model_flops_6nd": mf,
        "useful_flops_ratio": (mf / global_flops) if global_flops else None,
        "replication": rep,
    })
    if shape.kind == "train" and telemetry:
        t_roof = analyze_counts(t_counts, n_dev, link)
        rec["telemetry"] = {
            "compile_s": round(t_s, 1),
            "roofline": t_roof.to_dict(),
            "overhead": telemetry_overhead(roof, t_roof),
        }
    if shape.kind == "decode" and prefill_chunk > 0 and not cfg.encoder_decoder:
        rec["prefill_chunk"] = {
            "chunk": prefill_chunk,
            "compile_s": round(c_s, 1),
            "roofline": analyze_counts(c_counts, n_dev, link).to_dict(),
            "collective_bytes_by_kind": dict(c_counts.collective_by_kind),
        }

    if verbose:
        print(f"== {bundle.description} on {rec['mesh']} ==")
        print("memory_analysis:", rec["memory_analysis"])
        print("cost_analysis (raw):", rec["cost_analysis_raw"])
        print("collectives:", rec["collective_bytes_by_kind"])
        print("roofline:", json.dumps(rec["roofline"], indent=2))
        if "telemetry" in rec:
            print("telemetry overhead:", rec["telemetry"]["overhead"])
        if "prefill_chunk" in rec:
            print("prefill_chunk roofline:",
                  json.dumps(rec["prefill_chunk"]["roofline"], indent=2))
    return rec


def telemetry_overhead(plain, instrumented) -> dict:
    """Relative cost of a telemetry-instrumented step against its plain
    twin (per-device flops and bytes of the traced rooflines)."""

    def rel(a, b):
        return round(b / a - 1.0, 6) if a else None

    return {
        "flops_overhead": rel(plain.flops_per_device, instrumented.flops_per_device),
        "bytes_overhead": rel(plain.bytes_per_device, instrumented.bytes_per_device),
    }


def load_results(path=RESULTS):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def save_result(rec: dict, path=RESULTS):
    from repro_torch.obs import result_header, write_json_atomic

    results = load_results(path)
    results = [r for r in results
               if not (r["arch"] == rec["arch"] and r["shape"] == rec["shape"]
                       and r["mesh"] == rec["mesh"] and r.get("policy") == rec.get("policy"))]
    # the file stays a flat record list; the shared metadata header rides
    # on each record instead
    rec = {**rec, "meta": result_header(device="cpu")}
    results.append(rec)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_json_atomic(path, results)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--policy", default="amp_bf16")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="also trace the chunked-prefill serve step for decode "
                         "cells at this chunk size (0 = off)")
    ap.add_argument("--telemetry", action="store_true",
                    help="also trace the autoprec-instrumented train step for "
                         "train cells and record the telemetry overhead")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=RESULTS, help="the results file")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    done = {(r["arch"], r["shape"], r["mesh"], r.get("policy"))
            for r in load_results(args.out)
            if r.get("status") in ("ok", "skipped")} if args.skip_done else set()

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mname = mesh_name(production_shape(mp)[0])
                if (arch, shape, mname, args.policy) in done:
                    print(f"-- {arch} {shape} {mname}: already done")
                    continue
                try:
                    rec = run_cell(arch, shape, mp, args.policy,
                                   prefill_chunk=args.prefill_chunk,
                                   telemetry=args.telemetry)
                except Exception as e:  # a failure here is a bug
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mname,
                           "policy": args.policy,
                           "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
                    failures.append(rec)
                save_result(rec, args.out)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f["arch"], f["shape"], f["mesh"], f["error"][:120])
        raise SystemExit(1)
    print("\nall requested cells passed")


if __name__ == "__main__":
    main()
