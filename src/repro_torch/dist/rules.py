"""Logical-axis rule table: the single place where logical tensor axes
map onto physical mesh axes.

Models and step builders talk only in *logical* names ("dp", "tp",
"seq", "heads", "expert", ...); the production meshes expose *physical*
names ("pod", "data", "model").  A rule maps one logical name to an
ordered tuple of physical axes; resolution keeps only the axes present in
the target mesh, so the same model code runs unchanged on the single-pod
16x16 mesh, the 2x16x16 multi-pod mesh, a debug 1xN mesh, or no mesh at
all.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dimensions (or any object with ``mesh_dim_names`` and ``shape``).

``axis_rules(...)`` overrides the table for a scope (thread-local), so a
launch script can retarget e.g. sequence parallelism onto another axis
without touching a model file.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

AxisName = str
Entry = Union[None, AxisName, Tuple[AxisName, ...]]

#: logical name -> ordered physical axes it may occupy.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # batch-like parallelism: every pod/data axis the mesh has
    "dp": ("pod", "data"),
    "batch": ("pod", "data"),
    # every axis (full-DP layouts for small-weight models, e.g. FNO)
    "all": ("pod", "data", "model"),
    # tensor-parallel family: these all live on the physical model axis
    "tp": ("model",),
    "seq": ("model",),     # sequence parallelism shares the tp axis
    "heads": ("model",),
    "embed": ("model",),
    "vocab": ("model",),
    "expert": ("model",),  # expert parallelism for MoE
}

_local = threading.local()


def current_rules() -> Dict[str, Tuple[str, ...]]:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextmanager
def axis_rules(**overrides: Sequence[str]) -> Iterator[None]:
    """Scope-local overrides of the logical->physical table.

    >>> with axis_rules(seq=("data",)):
    ...     ...  # sequence parallelism over the data axis in this scope
    """
    prev = current_rules()
    merged = dict(prev)
    for name, axes in overrides.items():
        merged[name] = (axes,) if isinstance(axes, str) else tuple(axes)
    _local.rules = merged
    try:
        yield
    finally:
        _local.rules = prev


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's dimension names, () for no mesh."""
    if mesh is None:
        return ()
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs named dimensions (mesh_dim_names)")
    return tuple(names)


def mesh_axis_size(mesh, name: str) -> int:
    """The size of the mesh dimension called ``name``."""
    return int(mesh.shape[mesh_axis_names(mesh).index(name)])


def resolve_axes(entry: Entry, mesh, used: Optional[set] = None) -> Tuple[str, ...]:
    """Resolve one per-dimension spec entry to physical mesh axes.

    ``entry`` is None, a single name, or a tuple of names; each name may
    be logical (looked up in the rule table) or already physical.  Axes
    absent from ``mesh`` are dropped silently (mesh-shape adaptation);
    axes in ``used`` are dropped (an axis shards at most one dim).
    """
    if entry is None:
        return ()
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    rules = current_rules()
    mesh_axes = mesh_axis_names(mesh)
    out = []
    for name in names:
        for phys in rules.get(name, (name,)):
            if phys in mesh_axes and phys not in out and (
                used is None or phys not in used
            ):
                out.append(phys)
    return tuple(out)


def normalize_entry(axes: Tuple[str, ...]) -> Entry:
    """Physical axes tuple -> canonical per-dimension spec entry."""
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return axes
