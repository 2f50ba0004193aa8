"""Forward flash attention (online softmax over kv blocks): the CUDA kernel,
its plain PyTorch version and the wrapper that checks and launches it.

For q (BH, S, D) and k, v (BH, Sk, D), with scale 1/√D and the kv axis in
blocks of ``block_k`` keys:

    s   = (q·kᵀ in f32) · scale      keys ≥ Sk, and with ``causal`` keys
                                     after the query, masked to -1e30
    m'  = max(m, max_block s)        p = exp(s - m')     α = exp(m - m')
    l   = l·α + Σ p                  acc = acc·α + round_v(p)·v (f32 sums)
    out = acc / max(l, 1e-30), rounded to q's dtype

with m, l and acc in f32 and p rounded to v's dtype before p·v.  p is
rounded relative to the running max of its whole kv block, so the block
size is part of the function: the kernel's kv tile is ``block_k``.  The
kernel replaces the TPU kernel ``_flash_kernel`` of
``repro.kernels.flash_attention``; its source (``csrc/flash_attention.cu``)
states its bound and design.  There is no VJP (the reference has none).

Dispatch follows the tensors' device: CPU tensors take the plain version,
CUDA tensors launch the kernel or raise.  ``launches_flash`` counts the
kernel's launches.
"""
from __future__ import annotations

import functools

import torch

from .build import CSRC, _bind, _call

#: kernel launches since the count was last set to 0
launches_flash = 0

SOURCE = CSRC / "flash_attention.cu"
NEG_INF = -1e30
#: format codes of the C interface
_FMT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: head dims the kernel is built for, and its largest kv tile
HEAD_DIMS = (32, 64, 128)
MAX_BLOCK_K = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, block_k: int = 128) -> torch.Tensor:
    """``_flash_kernel``'s function op for op, one kv block of ``block_k``
    keys at a time over the whole q axis (rows are independent): memory
    O(BH·S·block_k).  The last block's padded keys, which the reference
    masks to -1e30, add exact zeros and are left out; under ``causal`` a
    block updates only the rows it does not mask entirely (for the others
    p is exactly 0 and α exactly 1).  p is rounded to v's dtype for p·v,
    so a caller that passes v as f32 gets the same function with that
    rounding skipped."""
    BH, S, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    dev = q.device
    qf = q.float()
    m = torch.full((BH, S), NEG_INF, device=dev)
    l = torch.zeros((BH, S), device=dev)
    acc = torch.zeros((BH, S, D), device=dev)
    q_pos = torch.arange(S, device=dev)
    neg = torch.tensor(NEG_INF, device=dev)
    for k0 in range(0, Sk, block_k):
        r0 = min(k0, S) if causal else 0
        if r0 == S:
            break
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k]
        s = torch.matmul(qf[:, r0:], kb.transpose(1, 2)) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[1], device=dev)
            s = torch.where(q_pos[r0:, None] >= k_pos[None, :], s, neg)
        m_prev = m[:, r0:]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l[:, r0:] = l[:, r0:] * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).float(), vb.float())
        acc[:, r0:] = acc[:, r0:] * alpha[..., None] + pv
        m[:, r0:] = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def _check(q, k, v, block_q, block_k) -> torch.device:
    """The checks every entry makes; returns the operands' device."""
    ops = (q, k, v)
    if len({t.dtype for t in ops}) != 1 or q.dtype not in _FMT:
        raise TypeError(f"flash_attention takes q, k and v of one dtype of {list(_FMT)}, "
                        f"got {[t.dtype for t in ops]}")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: expected q (BH, S, D) and k, v (BH, Sk, D), "
                         f"got {[tuple(t.shape) for t in ops]}")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if int(block_q) < 1 or int(block_k) < 1:
        raise ValueError(f"flash_attention: blocks must be positive, got {block_q}, {block_k}")
    devices = {t.device for t in ops}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: operands on {devices}")
    device = q.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for {device}")
    if device.type == "cuda":
        if not all(t.is_contiguous() for t in ops):
            raise ValueError("flash_attention: operands must be contiguous")
        if q.shape[2] not in HEAD_DIMS:
            raise ValueError(f"flash_attention: the kernel takes head dims {HEAD_DIMS}, "
                             f"got {q.shape[2]}")
        if block_k % 8 or block_k > MAX_BLOCK_K:
            raise ValueError(f"flash_attention: the kernel takes block_k a multiple of 8 "
                             f"up to {MAX_BLOCK_K}, got {block_k}")
        if q.dtype != torch.float32 and any(t.data_ptr() % 16 for t in ops):
            raise ValueError("flash_attention: the half-mode kernel takes 16-byte aligned "
                             "operands")
        if q.shape[0] > 65535:
            raise ValueError(f"flash_attention: at most 65535 batch-heads, got {q.shape[0]}")
    return device


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: (BH, S, D), k/v: (BH, Sk, D), one dtype of f32, bf16 and fp16;
    batch and heads pre-flattened.  Returns (BH, S, D) at q's dtype.
    ``block_q`` is the reference's query tile; rows are independent, so
    the result does not depend on it.  ``block_k`` is the kv block that p
    is rounded against (the kernel takes a multiple of 8 up to 128)."""
    device = _check(q, k, v, block_q, block_k)
    if device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, block_k=block_k)
    return _launch(q, k, v, causal, block_k)


def _launch(q, k, v, causal, block_k):
    global launches_flash
    BH, S, D = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _call(_library().flash_attention_fwd, "flash_attention_fwd", q.device, q.data_ptr(),
          k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, S, k.shape[1], D, int(block_k),
          int(causal), _FMT[q.dtype], 1.0 / (D ** 0.5))
    launches_flash += 1
    return out


@functools.cache
def _library():
    return _bind(SOURCE, flash_attention_fwd=(4, 7, 1))
