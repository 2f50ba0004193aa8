"""Channel-parallel collectives over the model axis, on plain tensors.

The reference's ``constrain_spatial`` lays a (B, C, *spatial) activation
out as "batch over dp, channels over tp" where the global batch does not
cover the mesh, and GSPMD then partitions the FNO block around it.  The
port's FNO step runs its forward and backward on plain local tensors (so
the spectral kernels launch as they do off a mesh), so it writes that
partition out: a thread-local :func:`channel_scope`, entered by the step,
names the tp group, this rank's index in it and the group's size; inside
it the models hold this rank's block of the hidden channels and call the
functions below where a consumer needs more than the block.  Off the
scope every function is the identity.

Each collective comes with its transpose as its backward:

============================  ==================  ==============================
function                      forward             backward
============================  ==================  ==============================
:func:`split`                 keep this block     all-gather
:func:`gather`                all-gather          reduce-scatter, summed in f32
:func:`gather` ``repeated``   all-gather          keep this block
:func:`reduce_scatter`        reduce-scatter      all-gather
:func:`all_reduce`            all-reduce          all-reduce
============================  ==================  ==============================

:func:`gather` serves a consumer whose work differs by rank (a product
with this rank's output-channel block of a weight): each rank's cotangent
is a partial sum over output channels, so the backward sums it over tp.
``repeated=True`` serves a consumer that every rank runs whole (the
projection): the cotangent is already the same on every rank, and summing
it would make it tp times too large.  :func:`all_reduce` sums a
statistic over the channels (the 2σ-clip stabiliser's per-sample sums)
that each rank then applies to its own block.  The collectives are the
``_c10d_functional`` ops (``torch.distributed._functional_collectives``)
both supported torches have, so ``launch.roofline`` counts their bytes;
complex tensors travel as their real view.  The scope is read only in the
forward: a Function keeps the scope it ran under for its backward, which
the autograd engine may run on another thread.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Any, Iterator, Optional

import torch

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class ChannelScope:
    """The tp group the hidden channels are split over."""
    group: Any     # a ProcessGroup
    rank: int      # this rank's index in ``group``: its channel block
    size: int      # the group's size: the number of blocks


def active() -> Optional[ChannelScope]:
    """The enclosing :func:`channel_scope` on this thread, or None."""
    return getattr(_local, "scope", None)


@contextmanager
def channel_scope(group, rank: int, size: int) -> Iterator[Optional[ChannelScope]]:
    """Split the hidden channels over ``group`` (``size`` ranks, this one
    ``rank``) for the scope.  A group of one rank splits nothing: the scope
    is then a no-op."""
    if size <= 1:
        yield None
        return
    prev = active()
    _local.scope = ChannelScope(group, int(rank), int(size))
    try:
        yield _local.scope
    finally:
        _local.scope = prev


def block_of(x: torch.Tensor, dim: int, scope: ChannelScope) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a view; no collective)."""
    n = x.shape[dim]
    if n % scope.size:
        raise ValueError(f"{n} channels on dim {dim} do not split over {scope.size} ranks")
    k = n // scope.size
    return x.narrow(dim, scope.rank * k, k)


def _wait(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    return funcol.wait_tensor(t) if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_gather(x: torch.Tensor, dim: int, scope: ChannelScope) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol

    dim %= x.ndim      # before a complex tensor's real view adds a dim
    if x.is_complex():
        return torch.view_as_complex(_all_gather(torch.view_as_real(x), dim, scope))
    return _wait(funcol.all_gather_tensor(x.contiguous(), dim, scope.group))


def _reduce_scatter(x: torch.Tensor, dim: int, scope: ChannelScope,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The f32 sum over the group of ``x``, this rank's block of it along
    ``dim``, at ``dtype`` (default: ``x``'s)."""
    import torch.distributed._functional_collectives as funcol

    dtype, dim = dtype or x.dtype, dim % x.ndim
    if x.shape[dim] % scope.size:
        raise ValueError(f"{x.shape[dim]} channels on dim {dim} do not split over "
                         f"{scope.size} ranks")
    if x.is_complex():
        part = torch.view_as_real(x.to(torch.complex64))
        out = _wait(funcol.reduce_scatter_tensor(part.contiguous(), "sum", dim, scope.group))
        return torch.view_as_complex(out.contiguous()).to(dtype)
    out = _wait(funcol.reduce_scatter_tensor(x.float().contiguous(), "sum", dim, scope.group))
    return out.to(dtype)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, scope):
        ctx.dim, ctx.scope = dim, scope
        return block_of(x, dim, scope).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.scope), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, scope, repeated):
        ctx.dim, ctx.scope, ctx.repeated = dim, scope, repeated
        return _all_gather(x, dim, scope)

    @staticmethod
    def backward(ctx, g):
        if ctx.repeated:
            return block_of(g, ctx.dim, ctx.scope).contiguous(), None, None, None
        return _reduce_scatter(g, ctx.dim, ctx.scope), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, scope, dtype):
        ctx.dim, ctx.scope, ctx.dtype = dim, scope, x.dtype
        return _reduce_scatter(x, dim, scope, dtype)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.scope).to(ctx.dtype), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scope):
        import torch.distributed._functional_collectives as funcol

        ctx.scope = scope
        return _wait(funcol.all_reduce(x.contiguous(), "sum", scope.group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol

        return _wait(funcol.all_reduce(g.contiguous(), "sum", ctx.scope.group)), None


def split(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's channel block of ``x``, which every rank of the group
    holds whole; the backward all-gathers the cotangent."""
    scope = active()
    return x if scope is None else _Split.apply(x, dim, scope)


def gather(x: torch.Tensor, dim: int = 1, *, repeated: bool = False) -> torch.Tensor:
    """Every rank's channel block of ``x`` along ``dim``, concatenated in
    rank order.  The backward reduce-scatters the cotangent, summed in f32,
    for a consumer that differs by rank; with ``repeated=True``, for a
    consumer every rank runs whole, it keeps this rank's block."""
    scope = active()
    return x if scope is None else _Gather.apply(x, dim, scope, repeated)


def reduce_scatter(x: torch.Tensor, dim: int = 1, *,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum over the group of every rank's partial ``x``, summed in f32,
    this rank's block of it along ``dim``, rounded once to ``dtype``
    (default: ``x``'s); the backward all-gathers the cotangent at
    ``dtype`` (half the bytes of f32 where ``dtype`` is a half type) and
    returns it at ``x``'s."""
    scope = active()
    if scope is None:
        return x if dtype is None else x.to(dtype)
    return _ReduceScatter.apply(x, dim, scope, dtype)


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum over the group of every rank's partial ``x`` (a sum over its
    channel block), on every rank; each rank uses the sum on its own
    block, so the backward sums the cotangent over the group too."""
    scope = active()
    return x if scope is None else _AllReduce.apply(x, scope)
