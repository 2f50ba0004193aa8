"""Plain oracles for the kernels (the correctness contract)."""
from __future__ import annotations

import torch


def spectral_contract_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle for the spectral contraction.

    x: (B, I, M) complex64; w: (I, O, M) complex64 -> (B, O, M) complex64.
    """
    return torch.einsum("bim,iom->bom", x, w)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Oracle softmax attention. q/k/v: (BH, S, D)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if causal:
        S, Sk = q.shape[1], k.shape[1]
        pos = torch.arange(max(S, Sk), device=q.device)
        mask = pos[:S, None] >= pos[None, :Sk]
        s = torch.where(mask[None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)
