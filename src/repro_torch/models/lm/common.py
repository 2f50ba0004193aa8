"""Shared LM machinery: RMSNorm, RoPE, SwiGLU, the attention forms.

Attention comes in three forms, as in the reference:

  * plain (short sequences; the exact softmax),
  * blocked (S >= 1024): online softmax over (query chunk x 512-key)
    tiles in the reference's block order,
  * cache attention (``chunk_attention`` / ``decode_attention``): K
    queries against a KV cache, masked per query position, optionally a
    sliding-window ring.

Every product takes the reference's ``preferred_element_type=f32``: the
operands are rounded to the compute dtype the caller resolved from the
``lm/dense`` site, multiplied and summed in f32, and the result rounded
once to that dtype.  Elementwise half code rounds op by op as JAX does
(``silu`` is ``x * sigmoid(x)`` with ``sigmoid = 1 / (1 + exp(-x))``,
each op rounded).  Masked scores are
``NEG_INF = -1e30``, not ``-inf``: a padding query whose every key is
masked gets a finite uniform row instead of a NaN.

These helpers sit below the rule table; only ``blocked_attention`` reads
the ambient mesh (its default query chunk and the chunked queries'
layout, as the reference's does).  GQA folds
the query heads of one KV head into the row dimension of one product
instead of repeating the KV heads: the same dot products, no copy.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.constrain import constrain, logical_axis_size, pin, to_layout
from repro_torch.dist.local import (_contiguous, lookup_rows, matmul, own_rows, rows_matmul,
                                    split_k_dim, split_k_matmul, take_rows)
from repro_torch.dist.sharding import local_block

NEG_INF = -1e30

Window = Union[int, torch.Tensor]


def dense(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum("...d,de->...e", x.astype(dtype), w.astype(dtype),
    preferred_element_type=f32).astype(dtype)``.  On a mesh of more than one
    rank, where each rank holds its own rows of x whole
    (:func:`~repro_torch.dist.local.own_rows`), the rank multiplies them by
    w made whole at ``dtype`` (:func:`~repro_torch.dist.local.rows_matmul`):
    the product comes out in x's row layout, every column.  Where a mesh dim
    splits x's features instead (the attention output, heads over tp), the
    rank's partial products are reduce-scattered onto S a column block at a
    time (:func:`~repro_torch.dist.local.split_k_matmul`)."""
    if own_rows(x, w):
        return rows_matmul(x.to(dtype), w.t(), dtype, compute=torch.float32).to(dtype)
    m = split_k_dim(x, w)
    if m is not None:
        return split_k_matmul(x.to(dtype), w, dtype, m, torch.float32).to(dtype)
    return matmul(x.to(dtype).float(), w.to(dtype).float()).to(dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA lowers it: ``1 / (1 + exp(-x))``, each op
    rounded to x's dtype (``torch.sigmoid`` rounds once and differs in a
    third of bf16 elements)."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``, each op rounded to x's dtype."""
    return x * sigmoid(x)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The LM's RMSNorm: normalise in f32, round to x's dtype, then
    multiply by ``w`` rounded to that dtype."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * w.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-halves layout)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def rope_cs(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """(cos, sin) of the RoPE angles at ``positions`` (any shape; a trailing
    axis of head_dim / 2 frequencies is added).  A model computes them once
    a call and rotates every layer's queries and keys with them."""
    ang = positions.float()[..., None] * rope_freqs(head_dim, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cs) -> torch.Tensor:
    """Rotate the split halves of x (..., D) by ``cs`` from :func:`rope_cs`,
    in f32, and round back to x's dtype."""
    cos, sin = cs
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D) with positions (..., S) or (S,)."""
    return rotate(x, rope_cs(positions, x.shape[-1], theta))


def apply_rope_one(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """RoPE for one decode token: x (B, H, D), pos (B,)."""
    return rotate(x, rope_cs(pos[:, None], x.shape[-1], theta))


def apply_rope_chunk(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """RoPE for a prefill chunk: x (B, H, K, D), pos (B, K) per-slot
    absolute positions."""
    return rotate(x, rope_cs(pos[:, None, :], x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def embed_rows(table: torch.Tensor, tokens: torch.Tensor, split_seq: bool = False
               ) -> torch.Tensor:
    """``table[tokens]``.  On a mesh of more than one rank each rank looks up
    its own token ids in its block of the vocabulary
    (:func:`~repro_torch.dist.local.lookup_rows`): the ids keep every mesh
    dim that shards them (the multi-pod batch over ("pod", "data") too),
    and the rows, summed over the ranks that split the vocabulary, come out
    with the batch as the ids have it and, with ``split_seq``, the
    sequence split as ``constrain_bsd`` splits it.  No rank makes a row of
    another rank's ids.  Elsewhere
    :func:`~repro_torch.dist.local.take_rows`."""
    if isinstance(table, DTensor) and table.device_mesh.size() > 1:
        return lookup_rows(table, tokens, split_seq)
    # the rows' cotangent in the gather's own layout, the ids' (the layout
    # the gather's backward takes them in)
    return pin(take_rows(table, tokens))


def _whole_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with everything but its batch dim whole on the ambient mesh's tp
    axis unless that axis divides n heads: a DTensor cannot split a dim
    sharded into uneven head blocks (GSPMD reshards such a reshape by
    itself).  Where no dp axis divides the batch (one sequence), every dim
    is made whole.  Off-mesh, and on a plain tensor, the identity."""
    if not n % logical_axis_size("heads") or not isinstance(x, DTensor):
        return x
    x = constrain(x, "dp", *([None] * (x.ndim - 1)))
    whole = [p if isinstance(p, Shard) and p.dim % x.ndim == 0 else Replicate()
             for p in x.placements]
    return x if whole == list(x.placements) else to_layout(x, whole)


def split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n * d) -> (..., n, d), the features whole on tp first where it
    does not divide the n heads."""
    return _whole_heads(x, n).reshape(*x.shape[:-1], n, d)


def _unfolded(x: torch.Tensor, Hk: int) -> torch.Tensor:
    """The fold's twin: where :func:`_whole_heads` made the heads whole, the
    gradient that comes back to the unfolded (B, H, ...) result must be
    whole on them too before it is folded again."""
    return pin(x) if Hk % logical_axis_size("heads") else x


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, Q, D) x (B, Hk, S, D) -> (B, H, Q, S) f32, H = g * Hk, query
    head h reading KV head h // g (``jnp.repeat(k, g, axis=1)``)."""
    B, H, Q, D = q.shape
    Hk = k.shape[1]
    # GQA folds H = g * Hk heads into (Hk, g)
    q, k = _whole_heads(q, Hk), _whole_heads(k, Hk)
    qg = q.float().reshape(B, Hk, (H // Hk) * Q, D)
    return _unfolded(matmul(qg, k.float().transpose(-1, -2)).reshape(B, H, Q, k.shape[2]),
                     Hk)


def _mix(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, Q, S) x (B, Hk, S, Dv) -> (B, H, Q, Dv) f32, p rounded to
    v's dtype first."""
    B, H, Q, S = p.shape
    Hk = v.shape[1]
    p, v = _whole_heads(p, Hk), _whole_heads(v, Hk)
    pg = p.to(v.dtype).float().reshape(B, Hk, (H // Hk) * Q, S)
    return _unfolded(matmul(pg, v.float()).reshape(B, H, Q, v.shape[-1]), Hk)


def _mask_scores(s, q_pos, k_pos, window):
    """Causal + sliding-window mask; window >= seq acts as full attention."""
    causal = q_pos[:, None] >= k_pos[None, :]
    inwin = (q_pos[:, None] - k_pos[None, :]) < window
    return torch.where(causal & inwin, s, NEG_INF)


def plain_attention(q, k, v, q_pos, k_pos, window: Window) -> torch.Tensor:
    """q: (B, H, S, D), k/v: (B, Hk, Sk, D).  The exact path (small S).  On
    a DTensor of a mesh of more than one rank, these ops run on the rank's
    own block of the queries (:func:`_local_plain`)."""
    if isinstance(q, DTensor) and q.device_mesh.size() > 1:
        return _local_plain(q, k, v, q_pos, k_pos, window)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, k) * scale
    s = _mask_scores(s, q_pos, k_pos, window)
    p = torch.softmax(s, dim=-1)
    del s       # the softmax keeps its output, not the masked scores
    return _mix(p, v).to(q.dtype)


def _local_plain(q, k, v, q_pos, k_pos, window: Window) -> torch.Tensor:
    """:func:`plain_attention` on this rank's block of the queries q (B, H,
    S, D), a DTensor whose mesh dims shard its batch, its heads or its
    positions, or replicate it; any other layout raises.  K and V are
    placed as :func:`_local_kv` places them, the scores, the mask, the
    softmax and the mix run on the local tensors (the rank's query rows by
    every key), and the output is placed as the queries are (a dim that
    does not split evenly over its ranks made whole)."""
    B, H, S, _ = q.shape
    kl, vl, (_, _, sl), s0, ranks = _local_kv(q, k, v, "(B, H, S, D)")
    out = plain_attention(q.to_local(), kl, vl, q_pos[s0:s0 + sl], k_pos, window)
    return _place_like(out, q, (B, H, S, v.shape[-1]), ranks)


def blocked_attention(q, k, v, q_pos, k_pos, window: Window, q_chunk: int = 0,
                      k_chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over (query chunk x ``k_chunk``-key) tiles,
    the key blocks in order (the reference's ``lax.scan``).  ``q_chunk``
    defaults to ``max(64, min(512, S // m))``, m the ambient mesh's size
    of the "heads" axis (1 off-mesh), so the chunk grid aligns with the
    sequence sharding; the chunked queries are constrained heads over tp
    when the heads divide, else the chunk axis (context parallelism).
    Blocks outside the causal or window band still run (masked), as in
    the reference.  On a mesh of more than one rank each rank runs the
    loop on its own block of the queries (:func:`_local_blocks`)."""
    B, H, S, D = q.shape
    Sk = k.shape[2]
    msize = logical_axis_size("heads")
    if q_chunk <= 0:
        q_chunk = max(64, min(512, S // max(msize, 1)))
    pad_q = (-S) % q_chunk
    pad_k = (-Sk) % k_chunk
    if pad_q:
        q = _resize_seq(q, pad_q)
        q_pos = torch.cat([q_pos, q_pos.new_full((pad_q,), -1)])
    if pad_k:
        k, v = _resize_seq(k, pad_k), _resize_seq(v, pad_k)
        k_pos = torch.cat([k_pos, k_pos.new_full((pad_k,), 2 ** 30)])
    nq = q.shape[2] // q_chunk
    qb = q.reshape(B, H, nq, q_chunk, D)
    if H % max(msize, 1) == 0:
        qb = constrain(qb, "dp", "heads", None, None, None)
    else:
        qb = constrain(qb, "dp", None, "seq", None, None)
    qpb = q_pos.reshape(nq, q_chunk)
    if isinstance(qb, DTensor) and qb.device_mesh.size() > 1:
        out = _local_blocks(qb, k, v, qpb, k_pos, window, k_chunk)
    else:
        out = _kv_loop(qb, k, v, qpb, k_pos, window, k_chunk)
    return _resize_seq(out, -pad_q) if pad_q else out


def _resize_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B, H, S, D) with its sequence padded by n zero rows (n > 0) or
    cut by -n rows (n < 0).  On a DTensor of a mesh of more than one rank
    the sequence is made whole first and the rows are padded or cut on the
    local block (torch 2.11's DTensor fails to pad a sharded dim)."""
    def resize(t):
        return torch.nn.functional.pad(t, (0, 0, 0, n)) if n > 0 else t[:, :, :t.shape[2] + n, :]

    if not (isinstance(x, DTensor) and x.device_mesh.size() > 1):
        return resize(x)
    mesh = x.device_mesh
    place = [Replicate() if type(p) is Shard and p.dim % x.ndim == 2 else p for p in x.placements]
    if place != list(x.placements):
        x = x.redistribute(mesh, place)
    shape = (*x.shape[:2], x.shape[2] + n, x.shape[3])
    return DTensor.from_local(resize(x.to_local()), mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous(shape))


def _kv_loop(qb, k, v, qpb, k_pos, window: Window, k_chunk: int) -> torch.Tensor:
    """The key-block loop of :func:`blocked_attention` over chunked queries
    qb (B, H, nq, q_chunk, D) at positions qpb (nq, q_chunk), the (padded)
    keys and values (B, Hk, Sk, D / Dv) at k_pos (Sk,): (B, H, nq *
    q_chunk, Dv) in q's dtype.  The carry is made at qb's shape by the first
    key block, which the empty carry (zeros, and a max of ``NEG_INF``) would
    leave as it is: ``0 * alpha + x`` is x."""
    B, H, nq, q_chunk, D = qb.shape
    Dv = v.shape[-1]
    nk = k.shape[2] // k_chunk
    scale = 1.0 / (D ** 0.5)
    q = qb.reshape(B, H, nq * q_chunk, D)

    def kv_step(acc, m, l, ki, vi, kp):  # noqa: E741
        s = _scores(q, ki).reshape(B, H, nq, q_chunk, k_chunk) * scale
        causal = qpb[:, :, None] >= kp[None, None, :]
        inwin = (qpb[:, :, None] - kp[None, None, :]) < window
        s = torch.where((causal & inwin)[None, None], s, NEG_INF)
        if acc is None:     # the first block: no carry to rescale or add to
            m_new = s.amax(dim=-1)
            p = torch.exp(s - m_new[..., None])
            pv = _mix(p.reshape(B, H, nq * q_chunk, k_chunk), vi)
            return pv.reshape(B, H, nq, q_chunk, Dv), m_new, p.sum(dim=-1)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)  # noqa: E741
        pv = _mix(p.reshape(B, H, nq * q_chunk, k_chunk), vi)
        return acc * alpha[..., None] + pv.reshape(B, H, nq, q_chunk, Dv), m_new, l

    # the flash backward: each key block's step recomputed in the backward
    # (the reference's jax.checkpoint), so no block's scores, probabilities
    # or masks are kept for it, only its carry and inputs
    recompute = torch.is_grad_enabled() and any(t.requires_grad for t in (qb, k, v))
    acc = m = l = None  # noqa: E741
    for i in range(nk):
        blk = (k[:, :, i * k_chunk:(i + 1) * k_chunk], v[:, :, i * k_chunk:(i + 1) * k_chunk],
               k_pos[i * k_chunk:(i + 1) * k_chunk])
        if recompute:
            acc, m, l = checkpoint(kv_step, acc, m, l, *blk, use_reentrant=False)  # noqa: E741
        else:
            acc, m, l = kv_step(acc, m, l, *blk)  # noqa: E741
    out = (acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)
    return out.reshape(B, H, nq * q_chunk, Dv)


def _local_kv(q, k, v, layout: str):
    """This rank's K and V for its block of the queries q, a DTensor whose
    first three dims are (batch, heads, positions or position chunks) and
    whose mesh dims shard one of those or replicate it; any other layout
    raises.  Returns (K, V, q's local block's first three sizes, its first
    position, the ranks over each of those three dims).

    K and V are brought to the queries' batch layout, whole over the mesh
    dims that shard the positions or the heads, except where they are
    sharded on heads that are exactly the KV heads of the rank's query
    heads.  The rank's query heads h read KV head h // g in whole GQA
    groups, inside one group, or else one KV head a query head
    (``jnp.repeat`` on the rank's block): the local K and V are cut or
    gathered so that the local product folds them as the whole one does.
    A rank's dK and dV are its queries' share of the sum (Partial over
    those mesh dims)."""
    mesh = q.device_mesh
    H, Hk = q.shape[1], k.shape[1]
    if any(not (isinstance(p, Replicate) or (type(p) is Shard and p.dim in (0, 1, 2)))
           for p in q.placements):
        raise ValueError(f"attention: queries {layout} placed {tuple(q.placements)}: only "
                         "Shard(0), Shard(1), Shard(2) and Replicate are supported")
    lb, off = local_block(q.shape, mesh, q.placements)
    ranks = [math.prod(int(mesh.size(i)) for i, p in enumerate(q.placements)
                       if type(p) is Shard and p.dim == d) for d in range(3)]
    g = H // Hk
    # K and V sharded on heads where those are the rank's query heads' own
    aligned = Hk % ranks[1] == 0
    kv_place = [p if type(p) is Shard and (p.dim == 0 or p.dim == 1 and aligned) else Replicate()
                for p in q.placements]
    # a mesh dim that shards the queries but not K and V sums their gradients
    grad_place = [Partial() if isinstance(kp, Replicate) and not isinstance(qp, Replicate)
                  else kp for qp, kp in zip(q.placements, kv_place, strict=True)]

    def local(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        if tuple(t.placements) != tuple(kv_place):
            t = t.redistribute(mesh, kv_place)
        return t.to_local(grad_placements=grad_place)

    kl, vl = local(k), local(v)
    hl, h0 = lb[1], off[1]
    if not aligned:
        lo, hi = h0 // g, (h0 + hl - 1) // g + 1
        if hi - lo == 1 or (h0 % g == 0 and hl % g == 0):
            # the rank's heads inside one GQA group, or whole groups: the fold
            kl, vl = kl[:, lo:hi], vl[:, lo:hi]
        else:
            # one KV head a query head
            kl, vl = (torch.cat([t[:, h // g:h // g + 1] for h in range(h0, h0 + hl)], dim=1)
                      for t in (kl, vl))
    return kl, vl, lb[:3], off[2], ranks


def _place_like(out: torch.Tensor, q, shape, ranks) -> torch.Tensor:
    """The rank's output block ``out`` as a DTensor of ``shape`` placed as
    the queries q are, a dim of the first three that does not split evenly
    over its ranks made whole."""
    mesh = q.device_mesh
    out = DTensor.from_local(out, mesh, q.placements, run_check=False,
                             shape=torch.Size(shape), stride=_contiguous(shape))
    if not any(q.shape[d] % ranks[d] for d in range(3)):
        return out
    whole = [Replicate() if type(p) is Shard and q.shape[p.dim] % ranks[p.dim] else p
             for p in q.placements]
    return out.redistribute(mesh, whole)


def _local_blocks(qb, k, v, qpb, k_pos, window: Window, k_chunk: int) -> torch.Tensor:
    """:func:`_kv_loop` on this rank's block of the chunked queries qb, a
    DTensor whose mesh dims shard its batch (dim 0), its heads (dim 1) or
    its query chunks (dim 2), or replicate it; any other layout raises.

    K and V are placed as :func:`_local_kv` places them; the loop then runs
    on the local tensors (its carry at the rank's shape).  The output is
    placed as the queries are (the chunk axis made whole where the chunks
    do not split evenly over the ranks)."""
    B, H, nq, q_chunk, _ = qb.shape
    Dv = v.shape[-1]
    kl, vl, (_, _, nql), c0, ranks = _local_kv(qb, k, v, "(B, H, nq, q_chunk, D)")
    out = _kv_loop(qb.to_local(), kl, vl, qpb[c0:c0 + nql], k_pos, window, k_chunk)
    shape = (B, H, nq * q_chunk, Dv)
    if not any(qb.shape[d] % ranks[d] for d in range(3)):
        return DTensor.from_local(out, qb.device_mesh, qb.placements, run_check=False,
                                  shape=torch.Size(shape), stride=_contiguous(shape))
    # chunks that do not split evenly: placed on the 5-D chunk axis, which
    # is made whole before the flatten (DTensor flattens no uneven shards)
    b, hl = out.shape[:2]
    out = _place_like(out.reshape(b, hl, nql, q_chunk, Dv), qb, (B, H, nq, q_chunk, Dv), ranks)
    return out.reshape(shape)


def gqa_attention(q, k, v, q_pos, k_pos, window: Window, *,
                  blocked_threshold: int = 1024) -> torch.Tensor:
    """GQA: q (B, Hq, S, D); k/v (B, Hkv, Sk, D) with Hq = g * Hkv."""
    fn = blocked_attention if q.shape[2] >= blocked_threshold else plain_attention
    return fn(q, k, v, q_pos, k_pos, window)


def chunk_attention(q, k_cache, v_cache, k_pos, q_pos, window: Window) -> torch.Tensor:
    """K-query cache attention: q (B, H, K, D) against the cache (B, Hkv, S,
    D).  k_pos: (B, S) per-slot cache positions (-1 => empty); q_pos: (B,
    K) per-query absolute positions.  A masked column contributes an exact
    0.0 after ``exp``, so a chunk's rows equal the one-token rows."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, k_cache) * scale
    qp = q_pos[:, :, None]                                     # (B, K, 1)
    kp = k_pos[:, None, :]                                     # (B, 1, S)
    valid = (kp >= 0) & (kp <= qp) & ((qp - kp) < window)      # (B, K, S)
    s = torch.where(valid[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _mix(p, v_cache).to(q.dtype)


def decode_attention(q, k_cache, v_cache, k_pos, q_pos, window: Window) -> torch.Tensor:
    """One-token decode: q (B, H, 1, D) against the cache; q_pos (B,)."""
    return chunk_attention(q, k_cache, v_cache, k_pos, q_pos[:, None], window)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def gen_device(generator: Optional[torch.Generator]) -> torch.device:
    """Where a parameter tree drawn from ``generator`` lives: its own
    device, or the meta device for ``None`` (shapes only)."""
    return torch.device("meta") if generator is None else generator.device


def randn(generator: Optional[torch.Generator], shape, scale: float = 1.0) -> torch.Tensor:
    """``scale`` times standard normals drawn from ``generator`` on its
    device; a meta tensor of that shape for ``None``."""
    if generator is None:
        return torch.empty(shape, device="meta")
    return scale * torch.randn(shape, generator=generator, device=generator.device)


def init_swiglu(generator: Optional[torch.Generator], d_model: int, d_ff: int
                ) -> Dict[str, torch.Tensor]:
    """The reference's scaled normals."""
    s_in = math.sqrt(1.0 / d_model)
    s_out = math.sqrt(1.0 / d_ff)
    return {
        "wg": randn(generator, (d_model, d_ff), s_in),
        "wu": randn(generator, (d_model, d_ff), s_in),
        "wd": randn(generator, (d_ff, d_model), s_out),
    }


def swiglu(p, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    g = dense(x, p["wg"], dtype)
    u = dense(x, p["wu"], dtype)
    return dense(silu(g) * u, p["wd"], dtype)
