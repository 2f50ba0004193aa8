"""Gradient communication: compressed data-parallel all-reduce.

The DP gradient all-reduce is the dominant collective for dense models,
so gradients are cast to bf16 *before* the all-reduce and back to f32
after: half the link traffic, for an error on the summed gradient of
about bf16's unit roundoff (2^-8 relative; bf16 has f32's exponent range,
so there is no loss-scale interaction).  The counterpart of the
reference's ``psum_compressed`` under ``shard_map``: here one
``torch.distributed.all_reduce`` a leaf over each data axis's process
group of the mesh.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch
import torch.distributed as dist

Tree = Mapping[str, torch.Tensor]


def compress_tree(grads: Tree, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    return {k: g.to(dtype) for k, g in grads.items()}


def decompress_tree(grads: Tree, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {k: g.to(dtype) for k, g in grads.items()}


def all_reduce_compressed(grads: Tree, group=None, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Cast -> SUM all-reduce over ``group`` -> upcast to f32 (the
    reference's ``psum_compressed``).  ``dtype=torch.float32`` reduces
    uncompressed."""
    small = compress_tree(grads, dtype)
    for k in sorted(small):
        dist.all_reduce(small[k], op=dist.ReduceOp.SUM, group=group)
    return decompress_tree(small)


def make_dp_allreduce(mesh, axis_names: Sequence[str] = ("pod", "data"),
                      dtype=torch.bfloat16) -> Callable[[Tree], Dict[str, torch.Tensor]]:
    """Returns f(grads) -> grads: the compressed all-reduce over each data
    axis of ``mesh`` present (its process group), then the mean (divided
    by the product of those axes' sizes); the model axis is untouched.
    The caller supplies each rank's partial gradients."""
    names = tuple(n for n in axis_names if n in (mesh.mesh_dim_names or ()))
    groups = [mesh.get_group(n) for n in names]
    scale = 1.0
    for n in names:
        scale *= mesh.size(mesh.mesh_dim_names.index(n))

    def reduce_fn(grads: Tree) -> Dict[str, torch.Tensor]:
        out = dict(grads)
        for g in groups:
            out = all_reduce_compressed(out, g, dtype)
        return {k: v / scale for k, v in out.items()}

    return reduce_fn
