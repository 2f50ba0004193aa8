"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Index-based dispatch, as the reference: the (token, expert) assignments
are sorted by expert (a stable sort, as ``jnp.argsort``), each one's
position inside its expert's segment comes from a cumulative count, the
assignments beyond capacity ``C = max(1, int(k·T·cf/E))`` are dropped,
and the experts read and write through an (E, C) index table whose
sentinel ``T`` is a zero row.

Writes that collide keep the reference's outcome: every dropped
assignment of an expert targets slot ``C - 1`` after the one that sits
there, so the last write in sorted order wins (the sentinel, when the
expert overflows); the port gathers that writer instead of scattering.
The combine adds each token's expert outputs in the
reference's scatter-add order, ascending flat slot, starting from 0.0,
and does so without atomics, so it is deterministic on the card too.

The router runs at the ``lm/router`` site's dtype (f32 in every rule
set); top-k keeps ``lax.top_k``'s order, the lower index first on ties.
Expert products follow ``lm/dense`` with f32 sums.  On a mesh, dispatch
runs in G = ``logical_axis_size("dp")`` groups of T/G tokens when G
divides T (the data-parallel degree, as the reference's grouped vmap),
each group routed and capacity-limited on its own and the aux loss the
groups' mean; off a mesh G = 1.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.dist.constrain import constrain, constrain_tokens, logical_axis_size, pin
from repro_torch.dist.local import take_rows

from .common import init_swiglu, randn, silu, swiglu


def init_moe(generator: Optional[torch.Generator], d_model: int, n_experts: int,
             moe_ff: int, n_shared: int, shared_ff: int) -> dict:
    s_in = math.sqrt(1.0 / d_model)
    s_out = math.sqrt(1.0 / moe_ff)
    params = {
        "router": randn(generator, (d_model, n_experts), s_in),
        "wg": randn(generator, (n_experts, d_model, moe_ff), s_in),
        "wu": randn(generator, (n_experts, d_model, moe_ff), s_in),
        "wd": randn(generator, (n_experts, moe_ff, d_model), s_out),
    }
    if n_shared > 0:
        params["shared"] = init_swiglu(generator, d_model, n_shared * shared_ff)
    return params


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(idx, minlength=n)`` for idx < n, with a static output
    shape (a sharded or fake tensor has no data-dependent sizes)."""
    return torch.zeros((n,), dtype=torch.long, device=idx.device).scatter_add(
        0, idx, torch.ones_like(idx))


def lax_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: descending, the lower index first
    among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, x: torch.Tensor, top_k: int, capacity_factor: float,
          router_dtype=torch.float32):
    """The routing half of ``moe_apply``: (expert_ids (T, k), table (E, C)
    int64 with sentinel T, gates (E, C) f32, aux loss)."""
    T = x.shape[0]
    E = params["router"].shape[1]
    C = max(1, int(top_k * T * capacity_factor / E))
    dev = x.device

    logits = torch.matmul(x.to(router_dtype), params["router"].to(router_dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = lax_top_k(probs, top_k)                  # (T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    # Switch-style load-balancing loss
    me = probs.mean(dim=0)                                        # (E,)
    ce = _counts(expert_ids.reshape(-1), E).float() / (T * top_k)
    aux = E * torch.sum(me * ce)

    flat_expert = expert_ids.reshape(-1)                          # (T*k,)
    flat_token = torch.arange(T, device=dev).repeat_interleave(top_k)
    flat_gate = gate_vals.reshape(-1)
    se, order = torch.sort(flat_expert, stable=True)
    stok, sg = flat_token[order], flat_gate[order]
    counts = _counts(se, E)
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_seg = torch.arange(T * top_k, device=dev) - seg_start[se]
    valid = pos_in_seg < C

    # (E, C) tables: the last write in sorted order wins each slot.  Slot c <
    # C - 1 of expert e has one writer, the segment's c-th assignment; every
    # assignment from position C - 1 on writes slot C - 1, so the segment's
    # last one wins it (a gather, not a scatter: no write order to keep)
    c = torch.arange(C, device=dev)
    last = torch.where(c == C - 1, counts[:, None] - 1, c)        # (E, C)
    hit = (counts[:, None] > c).reshape(-1)
    w = torch.clamp(seg_start[:, None] + last, 0, T * top_k - 1).reshape(-1)
    table = torch.where(hit & valid[w], stok[w], T).reshape(E, C)
    # the gates' cotangent in the gather's own layout: an expert-sharded one
    # is a layout torch 2.11's index_put refuses
    gates = torch.where(hit & valid[w], pin(sg[w]), 0.0).reshape(E, C)
    return expert_ids, table, gates, aux


def _combine_slots(table: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """(T, k) flat slots of each token's rows, ascending; ``E*C`` (a zero
    row) where a token has fewer than k."""
    tf = table.reshape(-1)
    n = tf.numel()
    _, f_order = torch.sort(tf, stable=True)
    cnt = _counts(tf, T + 1)[:T]
    start = torch.cumsum(cnt, 0) - cnt
    # token t's j-th row is the j-th entry of its segment of the sorted table
    j = torch.arange(k, device=tf.device)
    return torch.where(j < cnt[:, None], f_order[torch.clamp_max(start[:, None] + j, n - 1)], n)


def moe_apply(params, x: torch.Tensor, top_k: int, capacity_factor: float,
              dtype: torch.dtype, router_dtype=torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flattened tokens -> (out (T, d) at ``dtype``, aux loss)."""
    T, d = x.shape
    G = logical_axis_size("dp")   # data-parallel degree = dispatch groups
    if T % G:
        G = 1
    if G > 1:
        # tokens over dp alone first: the flattened (batch, sequence) rows
        # may be sharded over the sequence's axis too, which no reshape keeps
        xg = constrain(constrain(x, "dp", None).reshape(G, T // G, d), "dp", None, None)
        outs, auxes = zip(*(_moe_one_group(params, xg[g], top_k, capacity_factor, dtype,
                                           router_dtype, use_constraints=False)
                            for g in range(G)), strict=True)
        out = pin(constrain(torch.stack(outs), "dp", None, None).reshape(T, d))
        return out, torch.stack(auxes).mean()
    return _moe_one_group(params, x, top_k, capacity_factor, dtype, router_dtype)


def _moe_one_group(params, x: torch.Tensor, top_k: int, capacity_factor: float,
                   dtype: torch.dtype, router_dtype=torch.float32,
                   use_constraints: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dispatch group's tokens x (T, d) -> (out (T, d), aux loss).  The
    grouped caller constrains the grouped tensors itself."""
    if use_constraints:
        x = constrain_tokens(x)
    T, d = x.shape
    _, table, gates, aux = route(params, x, top_k, capacity_factor, router_dtype)
    E, C = table.shape

    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    expert_in = take_rows(x_pad, table).to(dtype)                 # (E, C, d)
    if use_constraints:
        expert_in = constrain(expert_in, "expert", None, None)   # EP when E divides

    def bmm(a, b):
        return torch.bmm(a.float(), b.to(dtype).float())

    g = bmm(expert_in, params["wg"]).to(dtype)
    u = bmm(expert_in, params["wu"]).to(dtype)
    y = bmm(silu(g) * u, params["wd"])                            # (E, C, d) f32
    y = y * gates[..., None]

    rows = torch.cat([y.reshape(E * C, d), y.new_zeros((1, d))], dim=0)
    slots = _combine_slots(table, T, top_k)
    out = x.new_zeros((T, d), dtype=torch.float32)
    for j in range(top_k):
        out = out + take_rows(rows, slots[:, j])
    if "shared" in params:
        out = out + swiglu(params["shared"], x, dtype).float()
    return out.to(dtype), aux
