"""Four-rank parity of the LM train step on a 2x2 mesh (CPU, gloo).

Four processes form a ("data", "model") = (2, 2) mesh over gloo.  Each
runs one ``build_train_step`` step of an arch's smoke config with its
parameters, optimizer state and batch placed by the rule tables, and,
against it, the same step on plain tensors in the same process (one
device).  An MoE arch runs the one-device step with the mesh ambient, so
both dispatch in the mesh's dp = 2 groups.  ``cross_entropy`` is also
held on logits whose vocabulary is sharded over "model".  Rank 0 prints
one JSON line a check; any rank whose numbers miss the limits fails the
run (exit 1).

Like the dry-runs this is a check of the distribution layer, and it runs
on the CPU whatever the machine has:

    PYTHONPATH=src python -m repro_torch.launch.parity --arch granite-moe-3b-a800m --arch whisper-large-v3
"""
from __future__ import annotations

import argparse
import json
import os
import socket
from typing import Dict

import torch

#: loss: relative difference; parameters: relative L2 of each leaf after the step
TOL = 1e-5


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    n = float(b.norm())
    return float((a - b).norm()) / n if n else float((a - b).norm())


def train_batch(cfg, B: int, S: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A train batch of the step's inputs: token ids (and labels) from the
    token stream; Whisper's frames standard normals in bf16."""
    from repro_torch.data.tokens import lm_inputs

    if cfg.encoder_decoder:
        dec = lm_inputs(seed, 0, B, cfg.max_dec_len + 1, cfg.vocab)
        g = torch.Generator().manual_seed(seed)
        return {"frames": torch.randn(B, S, cfg.d_model, generator=g).to(torch.bfloat16),
                "dec_tokens": dec["tokens"].to(torch.int32),
                "dec_labels": dec["labels"].to(torch.int32)}
    return {k: v.to(torch.int32) for k, v in lm_inputs(seed, 0, B, S, cfg.vocab).items()}


def init_params(cfg, seed: int = 0) -> torch.nn.Module:
    """The arch's model on the CPU, drawn from ``seed``."""
    from repro_torch.models.lm import init_lm, init_whisper

    gen = torch.Generator().manual_seed(seed)
    return (init_whisper if cfg.encoder_decoder else init_lm)(gen, cfg, device="cpu")


def train_parity(mesh, arch: str, policy: str = "full", B: int = 4, S: int = 16) -> dict:
    """One train step of ``arch``'s smoke config on ``mesh`` against one
    device: the losses, their relative difference, and the largest
    relative L2 of a parameter after the step (and its name)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.dist import distribute, lm_param_specs, use_mesh
    from repro_torch.dist.sharding import batch_specs
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamW
    from repro_torch.precision import get_policy

    cfg = get_config(arch, smoke=True)
    bundle = build_train_step(cfg, ShapeConfig("parity", S, B, "train"), get_policy(policy),
                              AdamW(lr=1e-3))
    batch = train_batch(cfg, B, S)
    p0 = init_params(cfg)
    s0 = AdamW(lr=1e-3).init(dict(p0.named_parameters()))
    with use_mesh(mesh if cfg.moe_experts else None):
        p0, s0, loss0 = bundle.step_fn(p0, s0, batch)
    p1 = init_params(cfg)
    distribute(p1, mesh, lm_param_specs(p1, mesh))
    with use_mesh(mesh), implicit_replication():
        s1 = AdamW(lr=1e-3).init(dict(p1.named_parameters()))
        p1, s1, loss1 = bundle.step_fn(p1, s1, distribute(batch, mesh, batch_specs(batch, mesh)))
        loss1 = loss1.full_tensor()
    n0 = dict(p0.named_parameters())
    errs = {k: _rel(p.full_tensor(), n0[k]) for k, p in p1.named_parameters()}
    worst = max(errs, key=errs.get)
    loss_rel = abs(float(loss1) - float(loss0)) / abs(float(loss0))
    return {"check": "train_step", "arch": arch, "policy": policy, "loss": float(loss0),
            "loss_mesh": float(loss1), "loss_rel": loss_rel, "param_rel_max": errs[worst],
            "worst": worst, "ok": loss_rel <= TOL and errs[worst] <= TOL}


def cross_entropy_parity(mesh, B: int = 4, S: int = 8, V: int = 96) -> dict:
    """``cross_entropy`` and its gradient on logits sharded (batch over
    "data", vocabulary over "model") against plain logits."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.train.losses import cross_entropy

    g = torch.Generator().manual_seed(1)
    logits = torch.randn(B, S, V, generator=g)
    labels = torch.randint(0, V, (B, S), generator=g)
    x0 = logits.clone().requires_grad_()
    l0 = cross_entropy(x0, labels)
    (g0,) = torch.autograd.grad(l0, x0)
    x1 = distribute_tensor(logits, mesh, [Shard(0), Shard(2)]).requires_grad_()
    lab = distribute_tensor(labels, mesh, [Shard(0), Replicate()])
    l1 = cross_entropy(x1, lab)
    (g1,) = torch.autograd.grad(l1, x1)
    loss_rel = abs(float(l1.detach().full_tensor()) - float(l0.detach())) / abs(float(l0.detach()))
    grad_rel = _rel(g1.full_tensor(), g0)
    return {"check": "cross_entropy", "loss_rel": loss_rel, "grad_rel": grad_rel,
            "ok": loss_rel <= 1e-6 and grad_rel <= 1e-6}


def _rank(rank: int, port: int, archs, policy: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        recs = [cross_entropy_parity(mesh)] + [train_parity(mesh, a, policy) for a in archs]
        if rank == 0:
            for rec in recs:
                print(json.dumps(rec), flush=True)
        bad = [r for r in recs if not r["ok"]]
        if bad:
            raise SystemExit(f"rank {rank}: parity missed: {bad}")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    import torch.multiprocessing as mp

    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=ARCH_IDS,
                    help="an arch whose train step to check (repeatable)")
    ap.add_argument("--policy", default="full")
    args = ap.parse_args(argv)
    port = int(os.environ.get("PORT") or _free_port())
    mp.spawn(_rank, args=(port, args.arch or [], args.policy), nprocs=4, join=True)


if __name__ == "__main__":
    main()
