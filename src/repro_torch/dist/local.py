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

:func:`rows_matmul` is the LM head's product and, on a mesh of more than
one rank, each projection's (``models.lm.common.dense``, where
:func:`own_rows` holds): each rank multiplies its own rows by the weight
made whole (:class:`_RowsMatmul`), so the product comes out in the rows'
layout with every column, and the weight's gradient is summed back to the
weight's own layout in f32 (the reference's products, whose rows GSPMD
keeps where the activation has them).

:func:`split_k_matmul` is a projection whose input's features a mesh dim
splits (the attention output, heads over tp): each rank's partial product
over its features is reduce-scattered onto the sequence a block of
columns at a time, so the product comes out as ``constrain_bsd`` places
it and no partial block is larger than the rank's share.

:func:`lookup_rows` is the LM's embedding gather on a mesh of more than
one rank (:class:`_Lookup`): each rank looks up its own ids in its block
of the vocabulary and the rows are summed over the ranks that split the
vocabulary, scattered onto the sequence where asked.

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
from typing import Optional, Tuple

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


def _rows_only(a) -> bool:
    """True when no mesh dim shards a's last dim or holds a partial sum: each
    rank holds whole rows of a."""
    from torch.distributed.tensor import Replicate, Shard

    return all(isinstance(p, Replicate) or (type(p) is Shard and p.dim % a.ndim < a.ndim - 1)
               for p in a.placements)


def own_rows(a, w) -> bool:
    """True when each rank multiplying its own rows of ``a`` by the weight
    ``w`` made whole does only its share of the product: a DTensor ``a`` of
    three or more dims and of whole rows on a mesh of more than one rank,
    ``w`` a DTensor on that mesh, and no mesh dim of more than one rank
    that shards ``w`` and replicates a's rows (its ranks would all multiply
    the same rows by every column).  A (B, S, d) activation sharded on its
    batch and its sequence, against a weight sharded over tp."""
    from torch.distributed.tensor import DTensor, Replicate

    if not (isinstance(a, DTensor) and isinstance(w, DTensor) and a.ndim >= 3):
        return False
    mesh = a.device_mesh
    return (w.device_mesh == mesh and mesh.size() > 1 and _rows_only(a)
            and not any(mesh.size(m) > 1 and isinstance(p, Replicate)
                        and not isinstance(q, Replicate)
                        for m, (p, q) in enumerate(zip(a.placements, w.placements, strict=True))))


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


def rows_matmul(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype,
                compute: Optional[torch.dtype] = None) -> torch.Tensor:
    """``matmul(a.to(compute), w.to(dtype).to(compute).t())`` for a (..., K)
    activation and a (N, K) weight, ``compute`` a's dtype by default, with
    the product in a's row layout: on a mesh of more than one rank where no
    mesh dim shards a's last dim, each rank multiplies its own rows by
    ``w`` made whole at ``dtype`` (:class:`_RowsMatmul`).  Elsewhere it is
    that expression itself."""
    from torch.distributed.tensor import DTensor

    compute = compute or a.dtype
    if (isinstance(a, DTensor) and isinstance(w, DTensor) and a.device_mesh.size() > 1
            and _rows_only(a)):
        # gathered on its dim 0 (the ranks' blocks stacked, not set side by side)
        if any(_shard_dim(p, 2) == 1 for p in w.placements):
            return _RowsMatmul.apply(a, w.t(), dtype, False, compute)
        return _RowsMatmul.apply(a, w, dtype, True, compute)
    return matmul(a.to(compute), w.to(dtype).to(compute).t())


class _RowsMatmul(torch.autograd.Function):
    """The forward all-gathers ``w`` at ``dtype`` and multiplies the rank's
    rows by it at ``compute``: the product is a's rows by all N columns,
    placed as a.  ``w`` is (N, K) where ``nk``, else (K, N).  Neither the
    whole weight nor the rows at ``compute`` are kept: the backward gathers
    the weight again, keeps the rows' cotangent on the rank (rounded to a's
    dtype), rounds the rank's share of w's gradient to ``dtype`` (the
    casts' transposes) and sums it in f32 over the mesh dims that shard
    a's rows, into w's own layout (a reduce-scatter where w is sharded, an
    all-reduce where it is replicated)."""

    @staticmethod
    def forward(ctx, a, w, dtype, nk, compute):
        from torch.distributed.tensor import DTensor

        rows = a.to_local()
        ctx.save_for_backward(rows, w)
        ctx.dtype, ctx.nk, ctx.compute = dtype, nk, compute
        ctx.a_meta = (tuple(a.placements), a.shape, a.stride())
        whole = _whole(w, dtype).to(compute)
        shape = tuple(a.shape[:-1]) + (w.shape[0] if nk else w.shape[1],)
        out = torch.matmul(rows.to(compute), whole.t() if nk else whole)
        return DTensor.from_local(out, a.device_mesh, a.placements, run_check=False,
                                  shape=torch.Size(shape), stride=_contiguous(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        rows, w = ctx.saved_tensors
        a_place, a_shape, a_stride = ctx.a_meta
        mesh, compute = g.device_mesh, ctx.compute
        if tuple(g.placements) != a_place:
            g = g.redistribute(mesh, a_place)
        gl = g.to_local().to(compute)
        g2, r2 = gl.reshape(-1, gl.shape[-1]), rows.reshape(-1, rows.shape[-1]).to(compute)
        dw = _rounded(torch.matmul(g2.t(), r2) if ctx.nk else torch.matmul(r2.t(), g2),
                      ctx.dtype)
        del r2
        partial = [Replicate() if isinstance(p, Replicate) else Partial() for p in a_place]
        dw = DTensor.from_local(dw, mesh, partial, run_check=False, shape=w.shape,
                                stride=_contiguous(w.shape)).redistribute(mesh, w.placements)
        whole = _whole(w, ctx.dtype).to(compute)
        da = torch.matmul(gl, whole if ctx.nk else whole.t())
        del whole
        da = DTensor.from_local(da.to(rows.dtype), mesh, a_place, run_check=False, shape=a_shape,
                                stride=a_stride)
        return da, dw.to(w.dtype), None, None, None


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 ``x`` rounded to ``dtype`` and back, in place (a cast's transpose
    before an f32 sum)."""
    x = x.to(torch.float32)
    return x if dtype == torch.float32 else x.copy_(x.to(dtype))


def _whole(w, dtype) -> torch.Tensor:
    """The local tensor of DTensor ``w`` at ``dtype`` made whole over its mesh."""
    from torch.distributed.tensor import Replicate

    return w.to(dtype).redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim).to_local()


def split_k_dim(a, w) -> Optional[int]:
    """The mesh dim that splits a's features where :func:`split_k_matmul`
    applies, else None: a (B, S, K) DTensor ``a`` whose mesh dims of more
    than one rank shard its batch (dim 0) or its features (dim 2), one of
    them the features, whose S that dim's ranks divide, and ``w`` a DTensor
    on a's mesh (the attention output's projection, the heads over tp)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not (isinstance(a, DTensor) and isinstance(w, DTensor) and a.ndim == 3
            and w.device_mesh == a.device_mesh):
        return None
    mesh = a.device_mesh
    ks = [m for m, p in enumerate(a.placements) if _shard_dim(p, 3) == 2 and mesh.size(m) > 1]
    if len(ks) != 1 or a.shape[1] % mesh.size(ks[0]):
        return None
    ok = all(isinstance(p, Replicate) or (type(p) is Shard and _shard_dim(p, 3) in (0, 2))
             for p in a.placements)
    return ks[0] if ok else None


def split_k_matmul(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype, m: int,
                   compute: torch.dtype) -> torch.Tensor:
    """``matmul(a.to(compute), w.to(dtype).to(compute))`` for a (B, S, K)
    activation whose features mesh dim ``m`` splits (:func:`split_k_dim`)
    and a (K, N) weight, with the product's S split over ``m`` (the layout
    ``constrain_bsd`` gives it) (:class:`_SplitKMatmul`)."""
    return _SplitKMatmul.apply(a, w, dtype, m, compute)


class _SplitKMatmul(torch.autograd.Function):
    """Each rank multiplies its block of a's features (all S rows) by those
    rows of ``w`` (gathered whole at ``dtype``): a partial sum over the
    features of the whole product.  It does so a block of N / n columns at
    a time (n the ranks of mesh dim m), and reduce-scatters each onto S
    over m, so no partial block is larger than the rank's share of the
    product.  The rows are taken in S-block-major order, so each
    collective splits its input's dim 0.  The backward all-gathers the
    cotangent's column blocks the same way, sums a's gradient over them
    and makes the rank's rows of w's, rounded to ``dtype``; those rows, in
    a zero (K, N), are summed in f32 over m and the batch's mesh dims into
    w's own layout (the rank's rows of w are not w's blocks: no all-to-all
    moves them)."""

    @staticmethod
    def forward(ctx, a, w, dtype, m, compute):
        from torch.distributed.tensor import DTensor, Shard

        from .channels import _reduce_scatter
        from .sharding import local_block

        mesh = a.device_mesh
        scope = _over(mesh, m)
        al = a.to_local()
        (_, _, kl), (_, _, k0) = local_block(a.shape, mesh, a.placements)
        ws = _whole(w, dtype)[k0:k0 + kl].to(compute, copy=True)       # the rank's rows of w
        abm = _block_major(al, scope.size).to(compute)
        out = torch.cat([_reduce_scatter(abm @ wc, 0, scope)
                         for wc in torch.tensor_split(ws, scope.size, dim=1)], dim=1)
        ctx.save_for_backward(al, w)
        ctx.m, ctx.dtype, ctx.compute, ctx.k = m, dtype, compute, (k0, kl)
        ctx.a_meta = (tuple(a.placements), a.shape, a.stride())
        place = [Shard(1) if i == m else p for i, p in enumerate(a.placements)]
        ctx.out_place = tuple(place)
        shape = (a.shape[0], a.shape[1], w.shape[1])
        b, S = al.shape[:2]
        return DTensor.from_local(out.reshape(b, S // scope.size, -1), mesh, place,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        from .channels import _all_gather

        al, w = ctx.saved_tensors
        a_place, a_shape, a_stride = ctx.a_meta
        mesh, compute, (k0, kl) = g.device_mesh, ctx.compute, ctx.k
        scope = _over(mesh, ctx.m)
        if tuple(g.placements) != ctx.out_place:
            g = g.redistribute(mesh, ctx.out_place)
        gl = g.to_local().to(compute)
        gl = gl.reshape(-1, gl.shape[-1])
        ws = _whole(w, ctx.dtype)[k0:k0 + kl].to(compute, copy=True)
        abm = _block_major(al, scope.size).to(compute)
        da = torch.zeros_like(abm)
        dws = []
        for gc, wc in zip(torch.tensor_split(gl, scope.size, dim=1),
                          torch.tensor_split(ws, scope.size, dim=1), strict=True):
            gc = _all_gather(gc, 0, scope)
            da.addmm_(gc, wc.t())
            dws.append(abm.t() @ gc)
        del ws, abm
        b, S = al.shape[:2]
        da = da.reshape(scope.size, b, S // scope.size, kl).transpose(0, 1).reshape(b, S, kl)
        da = DTensor.from_local(da.to(al.dtype), mesh, a_place, run_check=False, shape=a_shape,
                                stride=a_stride)
        # the rank's rows of w's gradient, in a zero (K, N): a partial sum over
        # m and over the ranks holding other batch rows, reduced into w's layout
        dw = torch.zeros(w.shape, dtype=torch.float32, device=gl.device)
        dw[k0:k0 + kl] = _rounded(torch.cat(dws, dim=1), ctx.dtype)
        del dws
        place = [Partial() if type(p) is Shard else Replicate() for p in a_place]
        dw = DTensor.from_local(dw, mesh, place, run_check=False, shape=w.shape,
                                stride=_contiguous(w.shape))
        return da, dw.redistribute(mesh, w.placements).to(w.dtype), None, None, None


def _block_major(x: torch.Tensor, n: int) -> torch.Tensor:
    """(b, S, k) -> (n * b * S / n, k): x's rows in S-block-major order, the
    S blocks an n-way reduce-scatter hands out first."""
    b, S, k = x.shape
    return x.reshape(b, n, S // n, k).transpose(0, 1).reshape(-1, k)


def lookup_rows(table: torch.Tensor, ids: torch.Tensor, split_seq: bool = False) -> torch.Tensor:
    """``table[ids]`` for a DTensor ``table`` (V, d) on a mesh of more than
    one rank, each rank looking up its own ids (:class:`_Lookup`): the ids
    keep every mesh dim that shards them, and a rank makes no row of ids
    another rank holds.  The rows (..., d) come out sharded as the ids are,
    d whole; over a mesh dim that splits the vocabulary, the ranks' rows
    are summed, and with ``split_seq`` scattered onto the ids' last dim
    (the sequence) where it splits evenly (the layout ``constrain_bsd``
    gives them), else replicated.  ``ids`` may be a plain tensor (whole on
    every rank).  The values are ``table[ids]``'s bit for bit: each row is
    the one rank's copy plus zeros."""
    return _Lookup.apply(table, ids, split_seq)


def _over(mesh, m):
    """Mesh dim ``m``'s process group as a :class:`~.channels.ChannelScope`
    (its group, this rank's index in it, its size)."""
    from .channels import ChannelScope

    return ChannelScope(mesh.get_group(m), int(mesh.get_coordinate()[m]), int(mesh.size(m)))


class _Lookup(torch.autograd.Function):
    """:func:`lookup_rows`.  A mesh dim of more than one rank that shards the
    table but not the ids on the vocabulary (dim 0) splits it: each rank
    looks up the ids inside its block of V (the others' rows zero, a masked
    lookup) and the rows are reduce-scattered onto the sequence or
    all-reduced over that dim.  Over any other mesh dim that shards the
    table, the table is made whole in its own dtype first.  The ids are
    looked up in the order of the sequence blocks the reduce-scatters hand
    out (block-major), so each collective splits its input's dim 0 and no
    rows are copied to line them up.  The backward all-gathers the rows'
    cotangent where the forward scattered it, adds it into the rank's block
    of V in f32 (``index_add_``; ids outside the block land in a spare
    row), and sums that over the mesh dims that shard the ids, into the
    table's own layout (an all-reduce over the batch's dims)."""

    @staticmethod
    def forward(ctx, table, ids, split_seq):
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        from .channels import _reduce_scatter, _wait
        from .sharding import local_block

        mesh, n = table.device_mesh, ids.ndim
        id_place = tuple(ids.placements) if isinstance(ids, DTensor) else (Replicate(),) * mesh.ndim
        for p in (*table.placements, *id_place):
            if not (isinstance(p, Replicate) or type(p) is Shard):
                raise ValueError(f"lookup_rows: table placed {tuple(table.placements)}, ids "
                                 f"{id_place}: only Shard and Replicate are supported")
        split = [type(p) is Shard and p.dim % 2 == 0 and isinstance(q, Replicate)
                 and mesh.size(m) > 1
                 for m, (p, q) in enumerate(zip(table.placements, id_place, strict=True))]
        tab_place = [Shard(0) if s else Replicate() for s in split]
        # the table's gradient: whole on its block of V, a partial sum over
        # the ranks holding other ids
        ctx.grad_place = [Partial() if type(q) is Shard else p
                          for p, q in zip(tab_place, id_place, strict=True)]
        ctx.table_meta = (tuple(table.placements), table.shape, table.dtype)
        if tuple(tab_place) != tuple(table.placements):
            table = table.redistribute(mesh, tab_place)
        (vl, _), (v0, _) = local_block(table.shape, mesh, tab_place)
        idl = ids.to_local() if isinstance(ids, DTensor) else ids
        # the split dims that scatter the rows onto the sequence, in mesh order
        scatter, blocks = [], 1
        if split_seq and n >= 2 and not any(type(q) is Shard and q.dim % n == n - 1
                                            for q in id_place):
            for m, s in enumerate(split):
                if s and idl.shape[-1] % (blocks * mesh.size(m)) == 0:
                    scatter.append(m)
                    blocks *= mesh.size(m)
        lead = idl.shape[:-1]
        ctx.block = (blocks, v0, vl, any(split))
        idx, outside = _block_ids(idl, *ctx.block)
        if outside is None:
            rows = torch.nn.functional.embedding(idx, table.to_local())
        else:
            rows = torch.nn.functional.embedding(torch.clamp_max(idx, vl - 1), table.to_local())
            rows.masked_fill_(outside[..., None], 0)
        del idx, outside
        out_place = list(id_place)
        for m, s in enumerate(split):
            if m in scatter:
                rows = _reduce_scatter(rows, 0, _over(mesh, m))
                out_place[m] = Shard(n - 1)
            elif s:
                rows = _wait(funcol.all_reduce(rows.contiguous(), "sum", mesh.get_group(m)))
                out_place[m] = Replicate()
        if blocks > 1:
            rows = rows.reshape(*lead, -1, rows.shape[-1])
        ctx.save_for_backward(idl)          # the ids, not a copy: the backward redoes idx
        ctx.mesh, ctx.vl, ctx.spare = mesh, vl, any(split)
        ctx.out_place, ctx.scatter = tuple(out_place), scatter
        shape = tuple(ids.shape) + (table.shape[1],)
        return DTensor.from_local(rows, mesh, out_place, run_check=False,
                                  shape=torch.Size(shape), stride=_contiguous(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        from .channels import _all_gather

        (idl,) = ctx.saved_tensors
        idx, _ = _block_ids(idl, *ctx.block)
        mesh, vl = ctx.mesh, ctx.vl
        place, shape, dtype = ctx.table_meta
        if tuple(g.placements) != ctx.out_place:
            g = g.redistribute(mesh, ctx.out_place)
        gl = g.to_local()
        d = gl.shape[-1]
        if ctx.scatter:     # the blocks back, block-major as the ids are
            gl = gl.reshape(1, -1, d)
            for m in reversed(ctx.scatter):
                gl = _all_gather(gl, 0, _over(mesh, m))
        dt = gl.new_zeros((vl + ctx.spare, d), dtype=torch.float32)
        dt.index_add_(0, idx.reshape(-1), gl.reshape(-1, d).to(torch.float32))
        dt = DTensor.from_local(dt[:vl], mesh, ctx.grad_place, run_check=False,
                                shape=torch.Size((shape[0], d)), stride=(d, 1))
        return dt.redistribute(mesh, place).to(dtype), None, None


def _block_ids(ids: torch.Tensor, blocks: int, v0: int, vl: int, split: bool):
    """(the rank's ids as rows of its V block, in S-block-major order for
    ``blocks`` sequence blocks; the ids outside the block, or None where no
    mesh dim splits V).  An id outside the block points at row ``vl``, the
    backward's spare row."""
    idx = ids.long()
    if blocks > 1:      # (..., S) -> (blocks, ..., S / blocks)
        idx = idx.reshape(*ids.shape[:-1], blocks, -1).movedim(-2, 0)
    if not split:
        return idx, None
    idx = idx - v0
    outside = (idx < 0) | (idx >= vl)
    return torch.where(outside, vl, idx), outside


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
