"""Products and row gathers on DTensors in layouts every supported torch
runs.

``torch.matmul`` folds the leading dims of a (B, S, d) activation into
the rows of one GEMM, and those of (B, H, M, K) attention operands into
the batch of one ``bmm``.  DTensor runs that fold as a view, and a view
that merges a dim sharded over the mesh into a preceding dim is refused
by torch 2.11 ("Attempted to flatten multiple dimensions, with dimension
1 being sharded"); later versions turn it into a strided shard.  GSPMD
reshards such a fold by itself.

:func:`matmul` folds on the local shards instead.  A GEMM's rows (a
batched product's batch entries) are independent of one another, so
their order in the folded dim does not matter: the folded dim is laid
out rank by rank, each rank's block its local rows in their local order,
and sharded over every mesh dim that shards one of the folded dims.
DTensor then places the 2-D (3-D) product as it would any other, and the
result is unfolded on the local shards the same way.  Where no mesh dim
shards a folded dim other than the first, and off a mesh, this is
``torch.matmul`` itself.

:func:`rows_matmul` is the LM head's product: each rank multiplies its own
rows by the weight made whole, so the logits come out in the rows' layout
with every column, and the weight's gradient is summed back to the
weight's own layout in f32 (the reference's head, whose logits GSPMD
constrains to the rows' layout).

:func:`take_rows` is ``table[idx]``.  Its backward is ``index_put``, whose
rule in torch 2.11 maps a cotangent sharded on an index dim to a negative
dim and fails; on a mesh of more than one rank the gather runs as
``F.embedding``, whose backward DTensor shards by the index's placements
(the same rows: a gather has no arithmetic).  :func:`ensure_rules` gives a
torch without a sharding rule for ``aten.flip`` (``cumsum``'s backward
flips) the obvious one.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .constrain import pin


def _shard_dim(p, ndim: int):
    """The tensor dim a ``Shard`` placement shards (normalised), else None."""
    from torch.distributed.tensor.placement_types import Shard

    return p.dim % ndim if isinstance(p, Shard) else None


def _needs_local_fold(x, k: int) -> bool:
    """True when a mesh dim of more than one rank shards one of x's first
    ``k`` dims other than dim 0 (the fold DTensor's view cannot make)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or k < 2:
        return False
    mesh = x.device_mesh
    return any(0 < (_shard_dim(p, x.ndim) or 0) < k and mesh.size(m) > 1
               for m, p in enumerate(x.placements))


def _fold(x, k: int):
    """x's first k dims folded into one on the local shards: a DTensor of
    ``(prod(x.shape[:k]), *x.shape[k:])``, the folded dim ``Shard(0)`` on
    each mesh dim that shards one of the k dims.  None where a folded dim
    is unevenly sharded (or strided): the fold would not be a layout."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import Shard

    mesh = x.device_mesh
    ranks = [1] * k
    placements = []
    for m, p in enumerate(x.placements):
        d = _shard_dim(p, x.ndim)
        if d is None:
            placements.append(p)
        elif type(p) is not Shard:
            return None
        elif d < k:
            ranks[d] *= mesh.size(m)
            placements.append(Shard(0))
        else:
            placements.append(Shard(d - k + 1))
    if any(x.shape[d] % r for d, r in enumerate(ranks)):
        return None
    local = x.to_local()
    shape = (math.prod(x.shape[:k]),) + tuple(x.shape[k:])
    return DTensor.from_local(local.reshape(-1, *local.shape[k:]), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous(shape))


def _unfold(y, like, k: int):
    """The inverse of :func:`_fold` for a product ``y`` of ``_fold(like, k)``:
    y's dim 0 brought to the folded layout (a local slice where the
    product gathered it), then split back into like's first k dims on the
    local shards, with like's placements on them."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.placement_types import Shard

    mesh = like.device_mesh
    target, out = [], []
    for p, q in zip(like.placements, y.placements, strict=True):
        d, e = _shard_dim(p, like.ndim), _shard_dim(q, y.ndim)
        if d is not None and d < k:
            target.append(Shard(0))
            out.append(Shard(d))
        elif e == 0:
            target.append(Replicate())
            out.append(Replicate())
        else:
            target.append(q)
            out.append(q if e is None else Shard(e + k - 1))
    if list(y.placements) != target:
        y = y.redistribute(mesh, target)
    lead = like.to_local().shape[:k]
    local = y.to_local()
    shape = tuple(like.shape[:k]) + tuple(y.shape[1:])
    return DTensor.from_local(local.reshape(*lead, *local.shape[1:]), mesh, out,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous(shape))


def _contiguous(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(stride))


def _batch_like(b, a, k: int):
    """b with a's placements on the first k (batch) dims: each mesh dim
    that shards a batch dim of a shards the same dim of b, and no other
    mesh dim shards a batch dim of b."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.placement_types import Shard

    target = []
    for p, q in zip(a.placements, b.placements, strict=True):
        d, e = _shard_dim(p, a.ndim), _shard_dim(q, b.ndim)
        if d is not None and d < k:
            target.append(Shard(d))
        elif e is not None and e < k:
            target.append(Replicate())
        else:
            target.append(q)
    return b if list(b.placements) == target else b.redistribute(b.device_mesh, target)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` for a (..., M, K) or (..., K) against a 2-D
    b (a GEMM over a's folded rows) or a b of a's rank and batch shape (a
    batched product), folding a's leading dims on the local shards where
    DTensor's view would merge a sharded dim into a preceding one.  Where
    DTensor folds them itself, the product's cotangent is pinned to the
    product's layout (:func:`~repro_torch.dist.constrain.pin`): the unfold
    view's backward folds it again."""
    from torch.distributed.tensor import DTensor

    if not isinstance(a, DTensor) or a.ndim < 3:
        return torch.matmul(a, b)
    if b.ndim == 2:
        k = a.ndim - 1                                   # rows
        if _needs_local_fold(a, k):
            fa = _fold(a, k)
            if fa is not None:
                return _unfold(torch.matmul(fa, b), a, k)
        return pin(torch.matmul(a, b))
    k = a.ndim - 2                                       # batch dims
    if b.ndim != a.ndim or tuple(b.shape[:k]) != tuple(a.shape[:k]):
        return pin(torch.matmul(a, b))
    if isinstance(b, DTensor) and (_needs_local_fold(a, k) or _needs_local_fold(b, k)):
        b = _batch_like(b, a, k)
        fa, fb = _fold(a, k), _fold(b, k)
        if fa is not None and fb is not None:
            return _unfold(torch.matmul(fa, fb), a, k)
    return pin(torch.matmul(a, b))


def rows_matmul(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``matmul(a, w.to(dtype).t())`` for a (..., K) activation and a (N, K)
    weight, with the product in a's row layout: on a mesh of more than one
    rank where no mesh dim shards a's last dim, each rank multiplies its
    own rows by ``w`` made whole (:class:`_RowsMatmul`).  Elsewhere it is
    that expression itself."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def rows_only(p):
        return isinstance(p, Replicate) or (type(p) is Shard and p.dim % a.ndim < a.ndim - 1)

    if (isinstance(a, DTensor) and isinstance(w, DTensor) and a.device_mesh.size() > 1
            and all(rows_only(p) for p in a.placements)):
        return _RowsMatmul.apply(a, w, dtype)
    return matmul(a, w.to(dtype).t())


class _RowsMatmul(torch.autograd.Function):
    """The forward all-gathers ``w`` at ``dtype`` and multiplies the rank's
    rows by it: the product is a's rows by all N columns, placed as a.  The
    backward keeps the rows' cotangent on the rank and sums w's, in f32,
    over the mesh dims that shard a's rows, into w's own layout (a
    reduce-scatter where w is sharded, an all-reduce where it is
    replicated)."""

    @staticmethod
    def forward(ctx, a, w, dtype):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = a.device_mesh
        whole = w.to(dtype).redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        rows = a.to_local()
        ctx.save_for_backward(rows, whole)
        ctx.a_meta = (tuple(a.placements), a.shape, a.stride())
        ctx.w_meta = (tuple(w.placements), w.shape, w.dtype)
        shape = tuple(a.shape[:-1]) + (w.shape[0],)
        return DTensor.from_local(torch.matmul(rows, whole.t()), mesh, a.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        rows, whole = ctx.saved_tensors
        a_place, a_shape, a_stride = ctx.a_meta
        w_place, w_shape, w_dtype = ctx.w_meta
        mesh = g.device_mesh
        if tuple(g.placements) != a_place:
            g = g.redistribute(mesh, a_place)
        gl = g.to_local().to(whole.dtype)
        da = DTensor.from_local(torch.matmul(gl, whole), mesh, a_place, run_check=False,
                                shape=a_shape, stride=a_stride)
        dw = torch.matmul(gl.reshape(-1, gl.shape[-1]).t(), rows.reshape(-1, rows.shape[-1]))
        partial = [Replicate() if isinstance(p, Replicate) else Partial() for p in a_place]
        dw = DTensor.from_local(dw.to(torch.float32), mesh, partial, run_check=False,
                                shape=w_shape, stride=_contiguous(w_shape))
        return da, dw.redistribute(mesh, w_place).to(w_dtype), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an integer index into table's dim 0; on a mesh of
    more than one rank ``F.embedding(idx, table)`` (see the module
    docstring)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(table, DTensor) and table.device_mesh.size() > 1:
        rows = torch.nn.functional.embedding(idx, table)
        # rows of a table sharded on dim 0 come back as a masked partial sum,
        # which DTensor can reduce only once (a recomputed layer would reduce
        # it again): reduce it here
        if any(p.is_partial() for p in rows.placements):
            rows = rows.redistribute(rows.device_mesh, [Replicate() if p.is_partial() else p
                                                        for p in rows.placements])
        return rows
    return table[idx]


def ensure_rules() -> None:
    """Register a DTensor sharding rule for ``aten.flip`` where this torch
    has none: any dim but the flipped ones may stay sharded.  A torch that
    has its own rule keeps it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    op = torch.ops.aten.flip.default
    prop = DTensor._op_dispatcher.sharding_propagator
    if any(op in getattr(prop, name, {}) for name in
           ("op_strategy_funcs", "op_to_rules", "op_single_dim_strategy_funcs")):
        return
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(op)
    def _flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(x.ndim) if d not in flipped]

    # the flipped dims decide the rule: hash them with the input's spec
    info = getattr(prop, "op_to_schema_info", None)
    if info is not None and op in info:
        info[op].static_argnum = 1
