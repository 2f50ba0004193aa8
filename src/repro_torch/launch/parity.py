"""Four-rank parity of the LM and FNO-family train steps on a 2x2 mesh
(CPU, gloo).

Four processes form a ("data", "model") = (2, 2) mesh over gloo.  Each
runs one ``build_train_step`` step of an arch's smoke config with its
parameters, optimizer state and batch placed by the rule tables, and,
against it, the same step on plain tensors in the same process (one
device).  An MoE arch runs the one-device step with the mesh ambient, so
both dispatch in the mesh's dp = 2 groups.  ``cross_entropy`` is also
held on logits whose vocabulary is sharded over "model".  ``--blocked
ARCH`` runs the train step at ``BLOCKED_SEQ`` = 1024 tokens, where
attention is ``blocked_attention``'s; ``--attention`` holds
``blocked_attention`` and its q/k/v gradients in each of
``ATTENTION_CASES`` within 1e-6 relative L2 of plain tensors.  ``--rows``
runs, on each of ``ROWS_MESHES`` ((2, 2, 1) and (1, 2, 2) over ("pod",
"data", "model")), ``embed_rows`` in each of ``LOOKUP_CASES`` (the rows
bit-equal to ``table[ids]``, the table's gradient within 1e-6), ``dense``
in each of ``DENSE_CASES`` and ``plain_attention`` in each of
``PLAIN_CASES`` (within 1e-6 of plain tensors, forward and every
gradient), and the smoke train steps of ``ROWS_ARCHS`` against one device.

``--fno NAME`` (``fno-darcy``, ``tfno-ns``, ``sfno-swe``) runs 3 steps of
``build_fno_train_step`` at the config's smoke size with a batch of 2,
which does not cover the mesh, so the hidden channels split over "model"
(``dist.channels``), under each of ``FNO_POLICIES``: ``full``,
``mixed_fno_bf16`` and ``mixed_fno_bf16`` with the 2σ-clip stabiliser
(whose per-sample statistics span every channel, so they are summed over
tp).  Under ``full`` the losses within 1e-5 relative and
every leaf after the steps within 1e-5 relative L2 of one device; under a
mixed policy each of those errors within a quarter of the one-device
policy's own gap to ``full``.  AdamW's update hardly moves when every
gradient is scaled alike, so the first step's gradients are also held to
one device's, leaf by leaf (a gradient summed over tp where it should not
be is tp times too large).  Rank 0 prints one JSON line a check; any rank
whose numbers miss the limits fails the run (exit 1).

Like the dry-runs this is a check of the distribution layer, and it runs
on the CPU whatever the machine has:

    PYTHONPATH=src python -m repro_torch.launch.parity --arch granite-moe-3b-a800m --arch whisper-large-v3
    PYTHONPATH=src python -m repro_torch.launch.parity --attention --blocked granite-34b --blocked smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.parity --fno fno-darcy --fno tfno-ns --fno sfno-swe
    PYTHONPATH=src python -m repro_torch.launch.parity --rows
"""
from __future__ import annotations

import argparse
import json
import math
import os
import socket
from typing import Dict, NamedTuple

import numpy as np
import torch

#: loss: relative difference; parameters: relative L2 of each leaf after the step
TOL = 1e-5


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double(), b.detach().double()
    n = float(b.norm())
    return float((a - b).norm()) / n if n else float((a - b).norm())


def train_batch(cfg, B: int, S: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A train batch of the step's inputs: token ids (and labels) from the
    token stream; Whisper's frames and the vision stub's patch embeddings
    standard normals in bf16."""
    from repro_torch.data.tokens import lm_inputs

    if cfg.encoder_decoder:
        dec = lm_inputs(seed, 0, B, cfg.max_dec_len + 1, cfg.vocab)
        g = torch.Generator().manual_seed(seed)
        return {"frames": torch.randn(B, S, cfg.d_model, generator=g).to(torch.bfloat16),
                "dec_tokens": dec["tokens"].to(torch.int32),
                "dec_labels": dec["labels"].to(torch.int32)}
    if cfg.frontend == "vision_stub":
        g = torch.Generator().manual_seed(seed)
        return {**{k: v.to(torch.int32) for k, v in
                   lm_inputs(seed, 0, B, S - cfg.n_patches, cfg.vocab).items()},
                "patch_embeds": torch.randn(B, cfg.n_patches, cfg.d_model,
                                            generator=g).to(torch.bfloat16)}
    return {k: v.to(torch.int32) for k, v in lm_inputs(seed, 0, B, S, cfg.vocab).items()}


def init_params(cfg, seed: int = 0) -> torch.nn.Module:
    """The arch's model on the CPU, drawn from ``seed``."""
    from repro_torch.models.lm import init_lm, init_whisper

    gen = torch.Generator().manual_seed(seed)
    return (init_whisper if cfg.encoder_decoder else init_lm)(gen, cfg, device="cpu")


def train_parity(mesh, arch: str, policy: str = "full", B: int = 4, S: int = 16) -> dict:
    """One train step of ``arch``'s smoke config on ``mesh`` against one
    device: the losses, their relative difference, the largest relative L2
    of a parameter after the step and of a gradient of the step (and their
    names), and whether each gradient on the mesh has its parameter's
    placements.  AdamW's first step moves each element by about lr times
    its gradient's sign, so the gradients are held apart from it."""
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
    probe = GradCapture()
    grad_step = build_train_step(cfg, ShapeConfig("parity", S, B, "train"), get_policy(policy),
                                 probe).step_fn
    p0 = init_params(cfg)
    s0 = AdamW(lr=1e-3).init(dict(p0.named_parameters()))
    with use_mesh(mesh if cfg.moe_experts else None):
        grad_step(p0, (), batch)
        g0 = probe.grads
        p0, s0, loss0 = bundle.step_fn(p0, s0, batch)
    p1 = init_params(cfg)
    distribute(p1, mesh, lm_param_specs(p1, mesh))
    with use_mesh(mesh), implicit_replication():
        dbatch = distribute(batch, mesh, batch_specs(batch, mesh))
        grad_step(p1, (), dbatch)
        n1 = dict(p1.named_parameters())
        placed = all(tuple(g.placements) == tuple(n1[k].placements)
                     for k, g in probe.grads.items())
        gerrs = {k: _rel(g.full_tensor(), g0[k]) for k, g in probe.grads.items()}
        s1 = AdamW(lr=1e-3).init(n1)
        p1, s1, loss1 = bundle.step_fn(p1, s1, dbatch)
        loss1 = loss1.full_tensor()
    n0 = dict(p0.named_parameters())
    errs = {k: _rel(p.full_tensor(), n0[k]) for k, p in p1.named_parameters()}
    worst = max(errs, key=errs.get)
    gworst = max(gerrs, key=gerrs.get)
    loss_rel = abs(float(loss1) - float(loss0)) / abs(float(loss0))
    return {"check": "train_step", "arch": arch, "policy": policy, "seq": S, "loss": float(loss0),
            "loss_mesh": float(loss1), "loss_rel": loss_rel, "param_rel_max": errs[worst],
            "worst": worst, "grad_rel_max": gerrs[gworst], "grad_worst": gworst,
            "grads_placed": placed,
            "ok": loss_rel <= TOL and errs[worst] <= TOL and gerrs[gworst] <= TOL and placed}


#: the FNO-family smoke cells of ``--fno``: (model kind, config name)
FNO_SMOKE = {"fno-darcy": ("fno", "FNO_DARCY_SMOKE"), "tfno-ns": ("fno", "TFNO_NS_SMOKE"),
             "sfno-swe": ("sfno", "SFNO_SWE_SMOKE")}
FNO_STEPS = 3
#: the policies of each ``--fno`` check; the last is ``mixed_fno_bf16`` with
#: the 2σ-clip stabiliser before each forward transform
SIGMA_CLIP = "mixed_fno_bf16+sigma_clip"
FNO_POLICIES = ("full", "mixed_fno_bf16", SIGMA_CLIP)
#: a mixed policy's error against one device, as a share of its own gap to full
MIXED_SHARE = 0.25


#: ``--blocked``'s sequence length: attention runs ``blocked_attention``
BLOCKED_SEQ = 1024


class GradCapture:
    """An optimizer with AdamW's interface that keeps the gradients the step
    hands it and leaves the parameters as they are."""

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        self.grads = grads
        return params, state

    def update_(self, grads, state, params):
        self.grads = grads
        return state


def fno_model(name: str, seed: int = 0):
    """A cell's smoke model on the CPU, drawn from ``seed``."""
    from repro_torch.configs import fno_paper
    from repro_torch.models import init_fno
    from repro_torch.models.sfno import init_sfno

    kind, cfg_name = FNO_SMOKE[name]
    cfg = getattr(fno_paper, cfg_name)
    init = init_sfno if kind == "sfno" else init_fno
    return init(torch.Generator().manual_seed(seed), cfg, device="cpu")


def fno_policy(name: str):
    """A policy of ``FNO_POLICIES`` by name."""
    from repro_torch.precision import SiteRule, get_policy

    if name == SIGMA_CLIP:
        return get_policy("mixed_fno_bf16").with_rules(
            ("*/spectral/fft_in", SiteRule(stabilize="sigma_clip")), name=SIGMA_CLIP)
    return get_policy(name)


def fno_batch(cfg, B: int, seed: int = 1) -> Dict[str, torch.Tensor]:
    """Standard normal inputs and targets at a smoke config's grid."""
    spatial = (cfg.nlat, cfg.nlon) if hasattr(cfg, "nlat") else (16, 16)
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(B, cfg.in_channels, *spatial, generator=g),
            "y": torch.randn(B, cfg.out_channels, *spatial, generator=g)}


def _fno_run(mesh, name: str, policy: str, B: int, steps: int, optimizer):
    """(losses, leaves after the steps, first step's gradients) of the FNO
    step on ``mesh`` (None: one device), every value whole."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import distribute, fno_param_specs
    from repro_torch.launch.steps import build_fno_train_step, fno_batch_specs

    model = fno_model(name)
    batch = fno_batch(model.cfg, B)
    probe = GradCapture()
    if mesh is not None:
        distribute(model, mesh, fno_param_specs(model, mesh))
        batch = distribute(batch, mesh, fno_batch_specs(batch, mesh))
    step = build_fno_train_step(fno_policy(policy), mesh, optimizer)
    whole = (lambda t: t.full_tensor()) if mesh is not None else (lambda t: t)
    with implicit_replication():
        state = optimizer.init(dict(model.named_parameters()))
        build_fno_train_step(fno_policy(policy), mesh, probe)(model, (), batch)
        grads = {k: whole(g).detach().clone() for k, g in probe.grads.items()}
        losses = []
        for _ in range(steps):
            model, state, loss = step(model, state, batch)
            losses.append(float(loss))
        leaves = {k: whole(p).detach().clone() for k, p in model.named_parameters()}
    return losses, leaves, grads


def fno_parity(mesh, name: str, policy: str = "full", B: int = 2,
               steps: int = FNO_STEPS) -> dict:
    """``steps`` steps of ``name``'s FNO-family smoke cell on ``mesh`` with a
    batch of ``B`` against one device: under ``full`` each loss, each leaf
    after the steps and each first-step gradient within ``TOL``; under a
    mixed policy each loss and the whole trees of leaves and of gradients
    within ``MIXED_SHARE`` of the one-device policy's own difference to
    ``full``.  ``worst``: of each kind, the check nearest its limit."""
    from repro_torch.launch.steps import channel_axis
    from repro_torch.optim import AdamW

    l0, p0, g0 = _fno_run(None, name, policy, B, steps, AdamW(lr=1e-3))
    l1, p1, g1 = _fno_run(mesh, name, policy, B, steps, AdamW(lr=1e-3))
    cfg = fno_model(name).cfg
    split = channel_axis(mesh, tuple(fno_batch(cfg, B)["x"].shape), cfg.hidden_channels)
    losses = {f"loss{i}": (a, b) for i, (a, b) in enumerate(zip(l1, l0, strict=True))}
    if policy == "full":    # each loss and leaf: (error, limit)
        pairs = {k: (abs(a - b) / abs(b), TOL) for k, (a, b) in losses.items()}
        pairs.update({f"param:{k}": (_rel(p1[k], p0[k]), TOL) for k in p0})
        pairs.update({f"grad:{k}": (_rel(g1[k], g0[k]), TOL) for k in g0})
    else:
        # each loss, and the whole tree (its leaves concatenated): a bias's
        # gradient, summed at the half dtype by each batch share before the
        # f32 sum over them, is off by up to half its own small gap with the
        # channels whole too (the data-parallel split, not the channels')
        lf, pf, gf = _fno_run(None, name, "full", B, steps, AdamW(lr=1e-3))

        def tree(d):
            return torch.cat([v.detach().double().flatten() for v in d.values()])

        pairs = {k: (abs(a - b) / abs(b), MIXED_SHARE * abs(b - lf[int(k[4:])]) / abs(lf[int(k[4:])]))
                 for k, (a, b) in losses.items()}
        pairs["param:tree"] = (_rel(tree(p1), tree(p0)), MIXED_SHARE * _rel(tree(p0), tree(pf)))
        pairs["grad:tree"] = (_rel(tree(g1), tree(g0)), MIXED_SHARE * _rel(tree(g0), tree(gf)))
    # the worst of each kind, as its share of its own limit
    worst = {}
    for kind in ("loss", "param", "grad"):
        key = max((k for k in pairs if k.startswith(kind)),
                  key=lambda k: pairs[k][0] / pairs[k][1] if pairs[k][1] else math.inf)
        worst[kind] = {"at": key, "rel": pairs[key][0], "limit": pairs[key][1]}
    return {"check": "fno_step", "cell": name, "policy": policy, "batch": B, "steps": steps,
            "channels_over": split, "losses": l0, "losses_mesh": l1, "worst": worst,
            "ok": split is not None and all(e <= lim for e, lim in pairs.values())}


#: ``cross_entropy_parity``'s cases: (logits' placements by tensor dim a mesh
#: dim shards, None for Replicate; V; first scored position; labels on the
#: vocabulary shards' first and last columns)
CE_CASES = {
    "seq_sharded": ((0, 1), 96, 0, False),          # the model's layout
    "vocab_sharded": ((0, 2), 96, 0, False),        # as the reference's V-sharded CE
    "vocab_uneven": ((0, 2), 97, 0, False),
    "vocab_shard_edges": ((0, 2), 97, 0, True),
    "vision_offset": ((0, 1), 96, 5, False),        # one rank's sequence block all patches
}


def cross_entropy_parity(mesh, B: int = 4, S: int = 8) -> dict:
    """``cross_entropy`` and its gradient on DTensor logits against plain
    logits, in each of ``CE_CASES``: the loss's and the gradient's relative
    errors (``loss_rel:<case>``, ``grad_rel:<case>`` and the largest of
    each), each within 1e-6."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.train.losses import cross_entropy

    rec = {"check": "cross_entropy"}
    for name, (dims, V, start, edges) in CE_CASES.items():
        g = torch.Generator().manual_seed(1)
        logits = 3 * torch.randn(B, S, V, generator=g)
        labels = torch.randint(0, V, (B, S - start), generator=g)
        place = [Replicate() if d is None else Shard(d) for d in dims]
        if edges:       # every label on the first or last column of a vocabulary shard
            n = -(-V // mesh.size(1))                    # DTensor's chunks: ceil-sized
            cols = sorted({c for i in range(0, V, n) for c in (i, min(i + n, V) - 1)})
            labels = torch.tensor(cols)[torch.arange(labels.numel()) % len(cols)].view_as(labels)
        x0 = logits.clone().requires_grad_()
        l0 = cross_entropy(x0, labels, start=start)
        (g0,) = torch.autograd.grad(l0, x0)
        x1 = distribute_tensor(logits, mesh, place).requires_grad_()
        lab = distribute_tensor(labels, mesh, [Shard(0), Replicate()])
        l1 = cross_entropy(x1, lab, start=start)
        (g1,) = torch.autograd.grad(l1, x1)
        rec[f"loss_rel:{name}"] = (abs(float(l1.detach().full_tensor()) - float(l0.detach()))
                                   / abs(float(l0.detach())))
        rec[f"grad_rel:{name}"] = _rel(g1.full_tensor(), g0)
    rec["loss_rel"] = max(v for k, v in rec.items() if k.startswith("loss_rel:"))
    rec["grad_rel"] = max(v for k, v in rec.items() if k.startswith("grad_rel:"))
    rec["ok"] = rec["loss_rel"] <= 1e-6 and rec["grad_rel"] <= 1e-6
    return rec


class AttentionCase(NamedTuple):
    """One ``blocked_attention`` call: batch, query and KV heads, sequence,
    q/k and v head dims, window and query chunk (0: the mesh's default)."""
    B: int
    H: int
    Hk: int
    S: int
    D: int
    Dv: int
    window: int
    q_chunk: int = 0


#: ``attention_parity``'s cases on a (2, 2) mesh: the heads layout (H % 2 == 0)
#: with one KV head, KV heads sharded as the queries' (Hk = H, and GQA), and
#: one KV head a query head (Hk = 3); the chunk layout with one KV head and a
#: window, Hk = H with Dv != D, padded queries, chunks that do not split over
#: the mesh (the queries replicated, as the constraint leaves them) and a
#: batch of one
ATTENTION_CASES = {
    "heads_mqa": AttentionCase(2, 4, 1, 1000, 16, 16, 2 ** 30),
    "heads_kv_sharded": AttentionCase(2, 4, 4, 1000, 16, 16, 2 ** 30),
    "heads_gqa_sharded": AttentionCase(2, 4, 2, 1000, 16, 16, 300),
    "heads_repeat": AttentionCase(2, 6, 3, 1000, 16, 16, 2 ** 30),
    "chunks_mqa_window": AttentionCase(2, 3, 1, 1000, 16, 16, 300),
    "chunks_mha_dv": AttentionCase(2, 3, 3, 1000, 24, 16, 2 ** 30),
    "chunks_padded": AttentionCase(2, 5, 1, 1000, 16, 16, 2 ** 30, 84),
    "chunks_replicated": AttentionCase(2, 3, 1, 1000, 16, 16, 300, 120),
    "batch_of_one": AttentionCase(1, 4, 1, 1000, 16, 16, 2 ** 30),
}


def attention_inputs(case: AttentionCase, seed: int = 0) -> Dict[str, np.ndarray]:
    """Standard normal q (B, H, S, D), k (B, Hk, S, D), v (B, Hk, S, Dv) and
    the output's cotangent (B, H, S, Dv), f32."""
    rng = np.random.default_rng(seed)
    B, H, Hk, S = case.B, case.H, case.Hk, case.S
    return {name: rng.standard_normal(shape).astype(np.float32) for name, shape in
            (("q", (B, H, S, case.D)), ("k", (B, Hk, S, case.D)), ("v", (B, Hk, S, case.Dv)),
             ("ct", (B, H, S, case.Dv)))}


def attention_parity(mesh, out_dir=None) -> dict:
    """``blocked_attention`` on the mesh's DTensors, placed as the model
    places them (``constrain_bhsd``), against plain tensors in each of
    ``ATTENTION_CASES``: the output's and the q/k/v gradients' relative L2
    (``out_rel:<case>``, ``grad_rel:<case>`` and the largest of each),
    each within 1e-6, and the output's placements.  ``out_dir``: rank 0
    writes each case's output there (``attention_<case>.npy``)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.dist import use_mesh
    from repro_torch.dist.constrain import constrain_bhsd
    from repro_torch.models.lm.common import blocked_attention

    rec = {"check": "attention"}
    for name, c in ATTENTION_CASES.items():
        x = {k: torch.from_numpy(a) for k, a in attention_inputs(c).items()}
        pos = torch.arange(c.S)
        plain = [x[n].clone().requires_grad_() for n in ("q", "k", "v")]
        out0 = blocked_attention(*plain, pos, pos, c.window, c.q_chunk)
        grads0 = torch.autograd.grad(out0, plain, x["ct"])
        whole = [distribute_tensor(x[n], mesh, [Replicate()] * mesh.ndim).requires_grad_()
                 for n in ("q", "k", "v")]
        with use_mesh(mesh):
            out1 = blocked_attention(*(constrain_bhsd(t) for t in whole), pos, pos, c.window,
                                     c.q_chunk)
            grads1 = torch.autograd.grad(
                out1, whole, distribute_tensor(x["ct"], mesh, out1.placements))
        full = out1.detach().full_tensor()
        rec[f"out_rel:{name}"] = _rel(full, out0)
        rec[f"grad_rel:{name}"] = max(_rel(g1.full_tensor(), g0)
                                      for g1, g0 in zip(grads1, grads0, strict=True))
        rec[f"placements:{name}"] = str(tuple(out1.placements))
        if out_dir is not None and mesh.get_rank() == 0:
            np.save(os.path.join(out_dir, f"attention_{name}.npy"), full.numpy())
    rec["out_rel"] = max(v for k, v in rec.items() if k.startswith("out_rel:"))
    rec["grad_rel"] = max(v for k, v in rec.items() if k.startswith("grad_rel:"))
    rec["ok"] = rec["out_rel"] <= 1e-6 and rec["grad_rel"] <= 1e-6
    return rec


#: ``rows_parity``'s meshes of the four ranks, ("pod", "data", "model"): the
#: batch over two mesh dims ("pod" and "data"), and the batch over "data"
#: with the vocabulary, the sequence and the heads over "model"
ROWS_MESHES = ((2, 2, 1), (1, 2, 2))
ROWS_NAMES = ("pod", "data", "model")

#: ``lookup_parity``'s cases: (V, d, B, S (None: ids of one dim, a decode
#: step's), the table dim sharded over "model", split_seq, the ids placed
#: over the batch's mesh dims or a plain tensor)
LOOKUP_CASES = {
    "vocab_split_seq": (97, 8, 4, 8, 0, True, True),       # uneven V blocks
    "vocab_rows_whole": (96, 8, 4, 8, 0, False, True),
    "features_sharded": (40, 16, 4, 8, 1, True, True),     # the table gathered on d
    "ids_whole": (97, 8, 4, 8, 0, True, False),
    "decode_ids": (97, 8, 4, None, 0, False, True),
}

#: ``dense_parity``'s cases: (B, S, K, N, the activation's features split
#: over "model"); the weight's larger dim over "model" (the rule table's),
#: the activation placed by ``constrain_bsd`` or, with its features split,
#: as attention's output is where the heads split (``split_k_matmul``)
DENSE_CASES = {
    "columns_d_to_4d": (4, 8, 16, 64, False),    # granite-34b's d : d_ff, w sharded on N
    "rows_4d_to_d": (4, 8, 64, 16, False),       # w sharded on K
    "square": (4, 8, 24, 24, False),
    "seq_not_split": (4, 5, 16, 64, False),      # S does not split: the DTensor product
    "features_split": (4, 8, 24, 24, True),      # the attention output's projection
    "features_split_n_uneven": (4, 8, 24, 10, True),
}


class PlainCase(NamedTuple):
    """One ``plain_attention`` call: batch, query and KV heads, query and
    key lengths, q/k and v head dims, window, whether the queries follow
    the keys (cross-attention: every key visible) and whether the queries'
    positions are split over "model" by hand, unevenly."""
    B: int
    H: int
    Hk: int
    Sq: int
    Sk: int
    D: int
    Dv: int
    window: int
    cross: bool = False
    uneven: bool = False


#: ``plain_parity``'s cases: heads split over "model" (with their KV heads,
#: and one KV head a query head), positions split where the heads do not
#: divide (Whisper's 20 heads over 16), its cross-attention (K/V gathered),
#: a window with GQA, Dv != D and positions that do not split evenly
PLAIN_CASES = {
    "heads_kv_split": PlainCase(2, 4, 2, 12, 12, 8, 8, 2 ** 30),
    "heads_repeat": PlainCase(2, 6, 3, 12, 12, 8, 8, 2 ** 30),
    "positions": PlainCase(2, 5, 5, 12, 12, 8, 8, 2 ** 30),
    "cross": PlainCase(2, 5, 5, 12, 20, 8, 8, 2 ** 30, cross=True),
    "window_gqa": PlainCase(2, 6, 2, 12, 12, 8, 8, 5),
    "dv_differs": PlainCase(2, 3, 1, 12, 12, 12, 8, 2 ** 30),
    "positions_uneven": PlainCase(2, 5, 1, 7, 7, 8, 8, 2 ** 30, uneven=True),
}

#: ``rows_parity``'s train steps, on each of ``ROWS_MESHES``
ROWS_ARCHS = ("whisper-large-v3", "smollm-360m")


def mesh_label(mesh) -> str:
    return "x".join(str(int(s)) for s in mesh.shape)


def lookup_parity(mesh) -> dict:
    """``embed_rows`` (``dist.local.lookup_rows``) on the mesh against
    ``table[ids]`` in each of ``LOOKUP_CASES``: whether the rows are equal
    bit for bit (``rows_equal:<case>``) and the table's gradient's relative
    L2 to one device's (``grad_rel:<case>``, within 1e-6), and that it has
    the table's placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import use_mesh
    from repro_torch.models.lm.common import embed_rows

    rec = {"check": "lookup", "mesh": mesh_label(mesh)}
    placed = True
    for name, (V, d, B, S, tdim, split_seq, ids_placed) in LOOKUP_CASES.items():
        g = torch.Generator().manual_seed(2)
        table = torch.randn(V, d, generator=g)
        ids = torch.randint(0, V, (B,) if S is None else (B, S), generator=g)
        ct = torch.randn(*ids.shape, d, generator=g)
        t0 = table.clone().requires_grad_()
        rows0 = t0[ids]
        (g0,) = torch.autograd.grad(rows0, t0, ct)
        t1 = distribute_tensor(table, mesh, [Replicate(), Replicate(), Shard(tdim)]).requires_grad_()
        i1 = distribute_tensor(ids, mesh, [Shard(0), Shard(0), Replicate()]) if ids_placed else ids
        with use_mesh(mesh):
            rows1 = embed_rows(t1, i1, split_seq)
            (g1,) = torch.autograd.grad(rows1, t1, distribute_tensor(ct, mesh, rows1.placements))
        rec[f"rows_equal:{name}"] = bool(torch.equal(rows1.detach().full_tensor(), rows0.detach()))
        rec[f"grad_rel:{name}"] = _rel(g1.full_tensor(), g0)
        placed = placed and tuple(g1.placements) == tuple(t1.placements)
    rec["grad_rel"] = max(v for k, v in rec.items() if k.startswith("grad_rel:"))
    rec["grads_placed"] = placed
    rec["ok"] = (all(v for k, v in rec.items() if k.startswith("rows_equal:"))
                 and rec["grad_rel"] <= 1e-6 and placed)
    return rec


def dense_parity(mesh) -> dict:
    """``models.lm.common.dense`` (f32) on the mesh against plain tensors in
    each of ``DENSE_CASES``: the output's and the activation's and the
    weight's gradients' relative L2 (``out_rel:<case>``, ``grad_rel:<case>``),
    each within 1e-6, and, where the rank multiplies its own block, the
    weight's gradient in the weight's placements (elsewhere the DTensor
    product's, which the train step's gradient hooks place)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import use_mesh
    from repro_torch.dist.constrain import constrain_bsd
    from repro_torch.dist.local import own_rows, split_k_dim
    from repro_torch.models.lm.common import dense

    rec = {"check": "dense", "mesh": mesh_label(mesh)}
    placed = True
    for name, (B, S, K, N, features) in DENSE_CASES.items():
        g = torch.Generator().manual_seed(3)
        x, w = torch.randn(B, S, K, generator=g), torch.randn(K, N, generator=g) / K ** 0.5
        ct = torch.randn(B, S, N, generator=g)
        plain = [x.clone().requires_grad_(), w.clone().requires_grad_()]
        y0 = dense(*plain, torch.float32)
        g0 = torch.autograd.grad(y0, plain, ct)
        whole = distribute_tensor(x, mesh, [Replicate()] * 3).requires_grad_()
        wd = distribute_tensor(w, mesh, [Replicate(), Replicate(), Shard(0 if K > N else 1)])
        wd.requires_grad_()
        with use_mesh(mesh):
            x1 = (whole.redistribute(mesh, [Shard(0), Shard(0), Shard(2)]) if features
                  else constrain_bsd(whole))
            own = own_rows(x1, wd) or split_k_dim(x1, wd) is not None
            y1 = dense(x1, wd, torch.float32)
            g1 = torch.autograd.grad(y1, (whole, wd), distribute_tensor(ct, mesh, y1.placements))
        rec[f"out_rel:{name}"] = _rel(y1.detach().full_tensor(), y0)
        rec[f"grad_rel:{name}"] = max(_rel(a.full_tensor(), b)
                                      for a, b in zip(g1, g0, strict=True))
        rec[f"w_grad_placements:{name}"] = str(tuple(g1[1].placements))
        if own:
            placed = placed and tuple(g1[1].placements) == tuple(wd.placements)
    rec["out_rel"] = max(v for k, v in rec.items() if k.startswith("out_rel:"))
    rec["grad_rel"] = max(v for k, v in rec.items() if k.startswith("grad_rel:"))
    rec["grads_placed"] = placed
    rec["ok"] = rec["out_rel"] <= 1e-6 and rec["grad_rel"] <= 1e-6 and placed
    return rec


def plain_inputs(case: PlainCase, seed: int = 0) -> Dict[str, np.ndarray]:
    """Standard normal q (B, H, Sq, D), k (B, Hk, Sk, D), v (B, Hk, Sk, Dv),
    the output's cotangent (B, H, Sq, Dv), f32, and the positions: causal
    (Sq = Sk), or every query after every key (``cross``)."""
    rng = np.random.default_rng(seed)
    c = case
    out = {name: rng.standard_normal(shape).astype(np.float32) for name, shape in
           (("q", (c.B, c.H, c.Sq, c.D)), ("k", (c.B, c.Hk, c.Sk, c.D)),
            ("v", (c.B, c.Hk, c.Sk, c.Dv)), ("ct", (c.B, c.H, c.Sq, c.Dv)))}
    out["q_pos"] = np.arange(c.Sq) + (c.Sk if c.cross else 0)
    out["k_pos"] = np.arange(c.Sk)
    return out


def plain_parity(mesh, out_dir=None) -> dict:
    """``plain_attention`` on the mesh's DTensors, placed as the model places
    them (``constrain_bhsd``; the uneven case by hand), against plain
    tensors in each of ``PLAIN_CASES``: the output's and the q/k/v
    gradients' relative L2 (``out_rel:<case>``, ``grad_rel:<case>``), each
    within 1e-6, and the output's placements.  ``out_dir``: rank 0 writes
    each case's output there (``plain_<mesh>_<case>.npy``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist import use_mesh
    from repro_torch.dist.constrain import constrain_bhsd
    from repro_torch.models.lm.common import plain_attention

    rec = {"check": "plain_attention", "mesh": mesh_label(mesh)}
    for name, c in PLAIN_CASES.items():
        x = {k: torch.from_numpy(a) for k, a in plain_inputs(c).items()}
        args = (x["q_pos"], x["k_pos"], c.window)
        plain = [x[n].clone().requires_grad_() for n in ("q", "k", "v")]
        out0 = plain_attention(*plain, *args)
        grads0 = torch.autograd.grad(out0, plain, x["ct"])
        whole = [distribute_tensor(x[n], mesh, [Replicate()] * mesh.ndim).requires_grad_()
                 for n in ("q", "k", "v")]
        with use_mesh(mesh):
            if c.uneven:
                q = whole[0].redistribute(mesh, [Replicate(), Shard(0), Shard(2)])
                qkv = (q, *whole[1:])
            else:
                qkv = [constrain_bhsd(t) for t in whole]
            out1 = plain_attention(*qkv, *args)
            grads1 = torch.autograd.grad(
                out1, whole, distribute_tensor(x["ct"], mesh, out1.placements))
        full = out1.detach().full_tensor()
        rec[f"out_rel:{name}"] = _rel(full, out0)
        rec[f"grad_rel:{name}"] = max(_rel(g1.full_tensor(), g0)
                                      for g1, g0 in zip(grads1, grads0, strict=True))
        rec[f"placements:{name}"] = str(tuple(out1.placements))
        if out_dir is not None and mesh.get_rank() == 0:
            np.save(os.path.join(out_dir, f"plain_{rec['mesh']}_{name}.npy"), full.numpy())
    rec["out_rel"] = max(v for k, v in rec.items() if k.startswith("out_rel:"))
    rec["grad_rel"] = max(v for k, v in rec.items() if k.startswith("grad_rel:"))
    rec["ok"] = rec["out_rel"] <= 1e-6 and rec["grad_rel"] <= 1e-6
    return rec


def rows_parity(out_dir=None) -> list:
    """On each of ``ROWS_MESHES`` over the four ranks: ``lookup_parity``,
    ``dense_parity``, ``plain_parity`` and the smoke train steps of
    ``ROWS_ARCHS`` against one device (``train_parity``), each record with
    its mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    recs = []
    for shape in ROWS_MESHES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=ROWS_NAMES)
        recs += [lookup_parity(mesh), dense_parity(mesh), plain_parity(mesh, out_dir)]
        recs += [dict(train_parity(mesh, a), mesh=mesh_label(mesh)) for a in ROWS_ARCHS]
    return recs


def _rank(rank: int, port: int, archs, policy: str, fnos=(), blocked=(),
          attention: bool = False, rows: bool = False) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        recs = [cross_entropy_parity(mesh)] + [train_parity(mesh, a, policy) for a in archs]
        recs += [attention_parity(mesh)] if attention else []
        recs += [train_parity(mesh, a, policy, S=BLOCKED_SEQ) for a in blocked]
        recs += [fno_parity(mesh, n, p) for n in fnos for p in FNO_POLICIES]
        recs += rows_parity() if rows else []
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
    ap.add_argument("--fno", action="append", choices=list(FNO_SMOKE),
                    help="an FNO-family cell whose channel-split step to check (repeatable)")
    ap.add_argument("--blocked", action="append", choices=ARCH_IDS,
                    help=f"an arch whose train step to check at {BLOCKED_SEQ} tokens (repeatable)")
    ap.add_argument("--attention", action="store_true",
                    help="check blocked_attention in each of ATTENTION_CASES")
    ap.add_argument("--rows", action="store_true",
                    help="check embed_rows, dense, plain_attention and the train steps of "
                    "ROWS_ARCHS on each of ROWS_MESHES")
    ap.add_argument("--policy", default="full")
    args = ap.parse_args(argv)
    port = int(os.environ.get("PORT") or _free_port())
    mp.spawn(_rank, args=(port, args.arch or [], args.policy, args.fno or [],
                          args.blocked or [], args.attention, args.rows), nprocs=4, join=True)


if __name__ == "__main__":
    main()
