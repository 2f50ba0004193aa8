"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060).

Chunked algorithm: within a chunk the recurrence is a masked,
attention-like contraction; across chunks a small recurrent state (B, H,
P, N) is carried, chunk after chunk.  The intra-chunk scores go through
the memory-greedy contraction (``repro_torch.core.contraction``) at the
``lm/ssd/spectral/contract`` site, which is where the mixed spectral rule
sets reach the SSM family: the operands stored at the site's half dtype,
products and sums in f32.

Decode is the O(1) recurrent update, and a prefill chunk runs it token
by token.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.dist.constrain import constrain_bsd
from repro_torch.precision import FULL

from .common import dense, gen_device, randn, silu


def init_ssd(generator: Optional[torch.Generator], d_model: int, d_inner: int,
             n_heads: int, d_state: int) -> dict:
    dev = gen_device(generator)
    return {
        # fused input projection: [x (d_inner), z (d_inner), B (N), C (N), dt (H)]
        "w_in": randn(generator, (d_model, 2 * d_inner + 2 * d_state + n_heads),
                      math.sqrt(1.0 / d_model)),
        "w_out": randn(generator, (d_inner, d_model), math.sqrt(1.0 / d_inner)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev)),
        "D": torch.ones((n_heads,), device=dev),
        "dt_bias": torch.zeros((n_heads,), device=dev),
        "norm_w": torch.ones((d_inner,), device=dev),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(params, u, d_inner, d_state, dtype):
    proj = dense(u, params["w_in"], dtype)
    x, z, Bc, Cc, dt = torch.split(proj, [d_inner, d_inner, d_state, d_state,
                                          proj.shape[-1] - 2 * d_inner - 2 * d_state], dim=-1)
    dt = softplus(dt.float() + params["dt_bias"])
    return x, z, Bc.float(), Cc.float(), dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, norm_w: torch.Tensor) -> torch.Tensor:
    """mamba2's gated RMSNorm in f32 (eps 1e-6)."""
    y = y * silu(z.float())
    ms = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(ms + 1e-6) * norm_w


def ssd_forward(params, u: torch.Tensor, cfg, policy=FULL) -> torch.Tensor:
    """u: (B, S, d_model) -> (B, S, d_model); chunked SSD over S.

    Dense projections resolve ``lm/dense``; the intra-chunk score
    contraction resolves ``lm/ssd/spectral/contract``."""
    dtype = policy.at("lm/dense").compute_dtype
    ctr = policy.at("lm/ssd/spectral/contract")
    B, S, _ = u.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = cfg.ssm_chunk
    d_inner = cfg.d_inner

    u = constrain_bsd(u)
    x, z, Bc, Cc, dt = _split_proj(params, u, d_inner, N, dtype)
    x = constrain_bsd(x)
    A = -torch.exp(params["A_log"])                    # (H,) negative

    pad = (-S) % Q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        Bc = torch.nn.functional.pad(Bc, (0, 0, 0, pad))
        Cc = torch.nn.functional.pad(Cc, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q

    xh = x.reshape(B, nc, Q, H, P).float()
    dtc = dt.reshape(B, nc, Q, H)
    Bcc = Bc.reshape(B, nc, Q, N)
    Ccc = Cc.reshape(B, nc, Q, N)

    dA = dtc * A[None, None, None, :]                  # (B, nc, Q, H) negative
    cum = torch.cumsum(dA, dim=2)                      # a_t = sum_{s<=t} dA_s
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))

    state = u.new_zeros((B, H, P, N), dtype=torch.float32)
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq, aq = xh[:, c], dtc[:, c], Bcc[:, c], Ccc[:, c], cum[:, c]
        # intra-chunk "attention": L[t, s] = exp(a_t - a_s) for s <= t; the
        # exponent is masked, not the result
        delta = aq[:, :, None, :] - aq[:, None, :, :]            # (B, Q, Qs, H)
        delta = torch.where(tri[None, :, :, None], delta, -math.inf)
        L = torch.exp(delta)
        scores = ctr.contract("bqn,bsn->bqs", cq, bq)            # (B, Q, Qs)
        xdt = xq * dtq[..., None]                                # (B, Q, H, P)
        y_intra = torch.einsum("bqs,bqsh,bshp->bqhp", scores, L, xdt)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", cq, state, torch.exp(aq))
        # S' = exp(a_Q) S + sum_t exp(a_Q - a_t) B_t (dt_t x_t)
        decay_to_end = torch.exp(aq[:, -1, None, :] - aq)        # (B, Q, H)
        ds = torch.einsum("bqn,bqhp,bqh->bhpn", bq, xdt, decay_to_end)
        state = state * torch.exp(aq[:, -1])[:, :, None, None] + ds
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, Sp, H, P)[:, :S]
    y = y + xh.reshape(B, Sp, H, P)[:, :S] * params["D"][None, None, :, None]

    y = _gated_norm(y.reshape(B, S, d_inner), z[:, :S], params["norm_w"])
    return dense(y, params["w_out"], dtype)


def ssd_decode_step(params, u: torch.Tensor, state: torch.Tensor, cfg, policy=FULL
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrent update.  u: (B, d_model); state (B, H, P, N)."""
    dtype = policy.at("lm/dense").compute_dtype
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, z, Bc, Cc, dt = _split_proj(params, u, cfg.d_inner, N, dtype)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])                                # (B, H)
    xh = x.reshape(-1, H, P).float()
    xdt = xh * dt[..., None]
    new_state = state * dA[:, :, None, None] + Bc[:, None, None, :] * xdt[..., None]
    y = torch.einsum("bn,bhpn->bhp", Cc, new_state)
    y = y + xh * params["D"][None, :, None]
    y = _gated_norm(y.reshape(-1, cfg.d_inner), z, params["norm_w"])
    return dense(y, params["w_out"], dtype), new_state
