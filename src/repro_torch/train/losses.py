"""Losses: relative L² and Sobolev H¹ (the paper trains with H¹ on NS).

H¹ uses spectral derivatives (exact for periodic fields), as the
reference and the neuraloperator implementation it builds on do.
"""
from __future__ import annotations

import math

import torch


def relative_l2(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean over batch of ||pred - target||₂ / ||target||₂."""
    dims = tuple(range(1, pred.ndim))
    num = torch.sqrt(torch.sum((pred - target) ** 2, dim=dims))
    den = torch.sqrt(torch.sum(target ** 2, dim=dims)) + eps
    return torch.mean(num / den)


def _spectral_grad_sq(f: torch.Tensor) -> torch.Tensor:
    """Σ_d ||∂f/∂x_d||² per sample, via FFT (periodic). f: (B, C, *spatial)."""
    dims = tuple(range(1, f.ndim))
    total = 0.0
    for ax in range(2, f.ndim):
        n = f.shape[ax]
        k = torch.fft.fftfreq(n, d=1.0 / n, device=f.device) * 2.0 * math.pi
        shape = [1] * f.ndim
        shape[ax] = n
        fk = torch.fft.fft(f, dim=ax)
        df = torch.fft.ifft(1j * k.reshape(shape) * fk, dim=ax).real
        total = total + torch.sum(df ** 2, dim=dims)
    return total


def relative_h1(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Relative H¹ = sqrt(||e||² + ||∇e||²) / sqrt(||t||² + ||∇t||²)."""
    dims = tuple(range(1, pred.ndim))
    e = pred - target
    num = torch.sum(e ** 2, dim=dims) + _spectral_grad_sq(e)
    den = torch.sum(target ** 2, dim=dims) + _spectral_grad_sq(target)
    return torch.mean(torch.sqrt(num) / (torch.sqrt(den) + eps))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Token-mean CE for the LM pool. logits (B, S, V) f32, labels
    (B, S - start): position s is scored against ``labels[:, s - start]``
    and the first ``start`` positions (a vision stub's patches) not at all.

    On a DTensor over a mesh of more than one rank, each rank computes on
    its own block of the logits (:class:`_ShardedCE`); elsewhere these are
    the reference's ops."""
    if _on_mesh(logits):
        return _sharded_cross_entropy(logits, labels, start)
    if start:
        logits = logits[:, start:]
    logits = logits.to(torch.float32)
    m = logits.amax(-1, keepdim=True)
    logz = torch.log(torch.sum(torch.exp(logits - m), -1))
    logz = logz + logits.amax(-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return torch.mean(logz - gold)


def _on_mesh(x: torch.Tensor) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor) and x.device_mesh.size() > 1


def _all_reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    """x reduced by ``op`` over each process group of ``groups`` in turn."""
    import torch.distributed._functional_collectives as funcol

    for group in groups:
        x = funcol.all_reduce(x.contiguous(), op, group)
        if isinstance(x, funcol.AsyncCollectiveTensor):
            x = funcol.wait_tensor(x)
    return x


class _ShardedCE(torch.autograd.Function):
    """The loss's sum over a rank's block of the logits, divided by the
    global token count, summed over the ranks that hold other tokens: the
    token mean, the same on every rank.

    ``x`` is the rank's (b, n, v) block in f32, at global offsets ``s_off``
    (sequence) and ``v_off`` (vocabulary); ``labels`` the rank's batch rows
    with the sequence whole.  Positions before ``start`` take no part.  The
    row max and the sum of exponentials are all-reduced over ``v_groups``
    (the mesh dims sharding V), and so is the gold logit, a masked local
    lookup; the sum of the rows' losses over ``row_groups`` (those sharding
    the batch or the sequence).  The backward makes one tensor of the
    block's size, ``(exp(x - lse) - onehot) · g / n_tokens``, and sends
    nothing."""

    @staticmethod
    def forward(ctx, x, labels, start, s_off, v_off, v_groups, row_groups, n_tokens):
        n, v = x.shape[1:]
        k = min(max(start - s_off, 0), n)                 # this block's first scored row
        lab = labels[:, s_off + k - start:s_off + n - start].long() - v_off
        m = _all_reduce(x.amax(-1, keepdim=True), "max", v_groups)
        lse = torch.log(_all_reduce(torch.sum(torch.exp(x - m), -1), "sum", v_groups))
        lse = lse + m[..., 0]
        inside = (lab >= 0) & (lab < v)
        idx = torch.clamp(lab, 0, v - 1)
        gold = torch.gather(x[:, k:], -1, idx[..., None])[..., 0]
        if v_groups:
            gold = _all_reduce(torch.where(inside, gold, 0.0), "sum", v_groups)
        loss = _all_reduce(torch.sum(lse[:, k:] - gold), "sum", row_groups) / n_tokens
        ctx.save_for_backward(x, lse, idx, inside)
        ctx.k, ctx.n_tokens = k, n_tokens
        return loss

    @staticmethod
    def backward(ctx, g):
        x, lse, idx, inside = ctx.saved_tensors
        k = ctx.k
        p = torch.exp(x - lse[..., None])
        if k:
            p[:, :k].zero_()
        p[:, k:].scatter_add_(-1, idx[..., None], -inside[..., None].to(p.dtype))
        p.mul_(g / ctx.n_tokens)
        return p, None, None, None, None, None, None, None


def _sharded_cross_entropy(logits, labels, start: int) -> torch.Tensor:
    """:func:`cross_entropy` of a DTensor ``logits`` on the rank's own block
    (:class:`_ShardedCE`): the batch and the sequence may be sharded, and
    the vocabulary (evenly or not); any other layout raises.  ``labels``
    (a DTensor or a whole tensor) are brought to the logits' batch layout
    with the sequence whole.  A replicated scalar DTensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.sharding import local_block

    mesh, nd = logits.device_mesh, logits.ndim
    v_groups, row_groups, lab_place = [], [], []
    for i, p in enumerate(logits.placements):
        d = p.dim % nd if type(p) is Shard else None
        if d is None and not isinstance(p, Replicate):
            raise ValueError(f"cross_entropy: logits placed {tuple(logits.placements)}: "
                             "only Shard(0), Shard(1), Shard(2) and Replicate are supported")
        if d == nd - 1:
            v_groups.append(mesh.get_group(i))
        elif d is not None:
            row_groups.append(mesh.get_group(i))
        lab_place.append(Shard(0) if d == 0 else Replicate())
    if isinstance(labels, DTensor):
        if tuple(labels.placements) != tuple(lab_place):
            labels = labels.redistribute(mesh, lab_place)
        labels = labels.to_local()
    else:
        (b, _), (b_off, _) = local_block(labels.shape, mesh, lab_place)
        labels = labels[b_off:b_off + b]
    _, off = local_block(logits.shape, mesh, logits.placements)
    B, S, _ = logits.shape
    loss = _ShardedCE.apply(logits.to_local().to(torch.float32), labels, start, off[1], off[2],
                            v_groups, row_groups, B * (S - start))
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim, run_check=False)
