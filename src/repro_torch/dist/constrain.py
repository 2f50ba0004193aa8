"""Ambient-mesh sharding constraints with logical axis names.

``constrain(x, *spec)`` is the reference's ``with_sharding_constraint``
for DTensors:

* it reads the mesh from the ambient scope (:func:`use_mesh`, a
  thread-local: PyTorch has no ambient mesh of its own) instead of a
  threaded argument,
* it accepts *logical* axis names ("dp", "tp", "seq", ...) or tuples of
  them per dimension, resolved through :mod:`repro_torch.dist.rules`,
* it is the identity when there is no mesh, the mesh is trivial, the
  tensor is a plain tensor, or nothing ends up sharded; a requested axis
  that does not divide its dimension is dropped (the longest divisible
  prefix of the resolved axes is kept).

On a DTensor it ``redistribute``s to the placements the resolved spec
gives.  Models never name a physical mesh axis; the shape helpers
(:func:`constrain_bsd`, :func:`constrain_bhsd`, :func:`constrain_tokens`,
:func:`constrain_spatial`) own the standard layout decisions for their
tensor shapes so call sites stay one line.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional, Union

import torch

from .rules import Entry, mesh_axis_size, normalize_entry, resolve_axes

_local = threading.local()


def ambient_mesh():
    """The mesh of the enclosing :func:`use_mesh` scope on this thread, or
    None."""
    return getattr(_local, "mesh", None)


@contextmanager
def use_mesh(mesh) -> Iterator[Optional[object]]:
    """Make ``mesh`` (a named ``DeviceMesh``) ambient on this thread for the
    scope.  ``use_mesh(None)`` is a no-op scope, so launch code can be
    written unconditionally: ``with use_mesh(maybe_mesh): ...``."""
    if mesh is None:
        yield None
        return
    prev = ambient_mesh()
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def _mesh_size(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= int(s)
    return n


def logical_axis_size(names: Union[str, tuple], mesh=None) -> int:
    """Product of the mesh sizes of the resolved physical axes (1 off-mesh)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        return 1
    size = 1
    for ax in resolve_axes(names, mesh):
        size *= mesh_axis_size(mesh, ax)
    return size


def _resolve_spec(shape, spec, mesh) -> Optional[tuple]:
    """Per-dim logical entries -> a spec of physical axes.

    Divisibility is enforced per dimension: the longest prefix of the
    resolved axes whose size product divides the dim is kept.  Returns
    None when nothing ends up sharded (caller no-ops).
    """
    used: set = set()
    entries = []
    for dim, entry in zip(shape, spec, strict=False):
        axes = resolve_axes(entry, mesh, used)
        while axes:
            prod = 1
            for ax in axes:
                prod *= mesh_axis_size(mesh, ax)
            if dim % prod == 0:
                break
            axes = axes[:-1]
        used.update(axes)
        entries.append(normalize_entry(axes))
    if all(e is None for e in entries):
        return None
    return tuple(entries)


def _trivial(mesh) -> bool:
    return mesh is None or _mesh_size(mesh) <= 1


def constrain(x: torch.Tensor, *spec: Entry) -> torch.Tensor:
    """Redistribute a DTensor to the placements of a logical spec on the
    ambient mesh.  Trailing dims not covered by ``spec`` are replicated.
    Off-mesh, on a single-device mesh, or on a plain tensor this is the
    identity."""
    mesh = ambient_mesh()
    if _trivial(mesh):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    p = _resolve_spec(x.shape, spec, mesh)
    if p is None:
        return x
    from .sharding import to_placements

    target = tuple(to_placements(mesh, p))
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def constrain_bsd(x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) activations: batch over dp, sequence over the tp axis
    (sequence parallelism), features replicated."""
    return constrain(x, "dp", "seq", None)


def constrain_bhsd(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) attention tensors: heads over tp when they divide,
    else sequence (context parallelism)."""
    mesh = ambient_mesh()
    if _trivial(mesh):
        return x
    tp = logical_axis_size("heads", mesh)
    if tp > 1 and x.shape[1] % tp == 0:
        return constrain(x, "dp", "heads", None, None)
    return constrain(x, "dp", None, "seq", None)


def constrain_tokens(x: torch.Tensor) -> torch.Tensor:
    """(T, d) flattened token tables (MoE dispatch): tokens over dp."""
    return constrain(x, "dp", None)


def constrain_spatial(x: torch.Tensor) -> torch.Tensor:
    """(B, C, *spatial) neural-operator activations.

    Full-DP layout: FNO-family weights are tiny, so when the global batch
    covers the whole mesh the batch dim is sharded over EVERY axis and
    weights replicate: FFTs and contractions become embarrassingly
    parallel and the only collective left is the gradient all-reduce.
    Fallback when the batch doesn't cover the mesh: batch over dp,
    channels over tp.
    """
    mesh = ambient_mesh()
    if _trivial(mesh):
        return x
    total = logical_axis_size("all", mesh)
    if total > 1 and x.shape[0] % total == 0:
        return constrain(x, ("dp", "tp"), *([None] * (x.ndim - 1)))
    return constrain(x, "dp", "tp", *([None] * (x.ndim - 2)))
