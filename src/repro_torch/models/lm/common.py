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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.constrain import constrain, logical_axis_size, pin, to_layout
from repro_torch.dist.local import matmul, take_rows

NEG_INF = -1e30

Window = Union[int, torch.Tensor]


def dense(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum("...d,de->...e", x.astype(dtype), w.astype(dtype),
    preferred_element_type=f32).astype(dtype)``."""
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


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` (:func:`~repro_torch.dist.local.take_rows`).  Token
    ids sharded on one dim over several mesh dims (the multi-pod batch over
    ("pod", "data")) keep only the first of them: torch 2.11's DTensor
    gathers no rows by such ids (the ids are a few ints a rank; the next
    constraint reshards the rows)."""
    if isinstance(tokens, DTensor):
        from torch.distributed.tensor import Replicate, Shard

        seen, pl = set(), []
        for p in tokens.placements:
            hybrid = isinstance(p, Shard) and p.dim in seen
            pl.append(Replicate() if hybrid else p)
            if isinstance(p, Shard):
                seen.add(p.dim)
        if pl != list(tokens.placements):
            tokens = tokens.redistribute(tokens.device_mesh, pl)
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
    """q: (B, H, S, D), k/v: (B, Hk, Sk, D).  The exact path (small S)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, k) * scale
    s = _mask_scores(s, q_pos, k_pos, window)
    p = torch.softmax(s, dim=-1)
    return _mix(p, v).to(q.dtype)


def blocked_attention(q, k, v, q_pos, k_pos, window: Window, q_chunk: int = 0,
                      k_chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over (query chunk x ``k_chunk``-key) tiles,
    the key blocks in order (the reference's ``lax.scan``).  ``q_chunk``
    defaults to ``max(64, min(512, S // m))``, m the ambient mesh's size
    of the "heads" axis (1 off-mesh), so the chunk grid aligns with the
    sequence sharding; the chunked queries are constrained heads over tp
    when the heads divide, else the chunk axis (context parallelism).
    Blocks outside the causal or window band still run (masked), as in
    the reference."""
    B, H, S, D = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[2]
    msize = logical_axis_size("heads")
    if q_chunk <= 0:
        q_chunk = max(64, min(512, S // max(msize, 1)))
    pad_q = (-S) % q_chunk
    pad_k = (-Sk) % k_chunk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad_q))
        q_pos = torch.cat([q_pos, q_pos.new_full((pad_q,), -1)])
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad_k))
        k_pos = torch.cat([k_pos, k_pos.new_full((pad_k,), 2 ** 30)])
    nq, nk = q.shape[2] // q_chunk, k.shape[2] // k_chunk
    scale = 1.0 / (D ** 0.5)
    qb = q.reshape(B, H, nq, q_chunk, D)
    if H % max(msize, 1) == 0:
        qb = constrain(qb, "dp", "heads", None, None, None)
    else:
        qb = constrain(qb, "dp", None, "seq", None, None)
    qb = qb.reshape(B, H, nq * q_chunk, D)
    qpb = q_pos.reshape(nq, q_chunk)

    acc = q.new_zeros((B, H, nq, q_chunk, Dv), dtype=torch.float32)
    m = q.new_full((B, H, nq, q_chunk), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, H, nq, q_chunk), dtype=torch.float32)  # noqa: E741
    for i in range(nk):
        ki = k[:, :, i * k_chunk:(i + 1) * k_chunk]
        vi = v[:, :, i * k_chunk:(i + 1) * k_chunk]
        kp = k_pos[i * k_chunk:(i + 1) * k_chunk]
        s = _scores(qb, ki).reshape(B, H, nq, q_chunk, k_chunk) * scale
        causal = qpb[:, :, None] >= kp[None, None, :]
        inwin = (qpb[:, :, None] - kp[None, None, :]) < window
        s = torch.where((causal & inwin)[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)  # noqa: E741
        pv = _mix(p.reshape(B, H, nq * q_chunk, k_chunk), vi)
        acc = acc * alpha[..., None] + pv.reshape(B, H, nq, q_chunk, Dv)
        m = m_new
    out = (acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)
    return out.reshape(B, H, nq * q_chunk, Dv)[:, :, :S, :]


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
