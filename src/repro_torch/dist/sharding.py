"""Rule-table spec derivation: trees of shapes -> trees of specs, with
divisibility-checked fallback chains, and their placement on a mesh.

A *spec* is a tuple of per-dimension entries (None, a physical axis
name, or a tuple of them), the entries of the reference's
``PartitionSpec``; trailing dims it does not cover are replicated.
:func:`to_placements` turns one into DTensor placements on a
:class:`~torch.distributed.device_mesh.DeviceMesh`, :func:`distribute`
places a whole tree.

Everything routes through :func:`pick_spec`: a candidate chain is tried
in order and the first candidate whose every sharded dimension divides
cleanly wins (axes absent from the mesh are adapted away, indivisible
axes fail the candidate).  The derivations (:func:`lm_param_specs`,
:func:`fno_param_specs`, :func:`batch_specs`, :func:`cache_specs`) encode
the layout policy once, so launch, dry-run and serving derive identical
placements from the same tables.

Trees are dicts, NamedTuples, lists and tuples of tensors (real, meta or
fake), or an ``nn.Module``, read as the flat dict of its named
parameters.  The port keeps LM layers unstacked (one submodule a layer,
``layers.<i>.<path>``) where the reference stacks them on a leading L
axis; a per-layer leaf gets the reference's spec of the stacked leaf
without its first entry, so the two packages shard every weight alike.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .rules import Entry, mesh_axis_names, mesh_axis_size, normalize_entry, resolve_axes

Spec = Tuple[Entry, ...]
Candidate = Tuple[Entry, ...]

#: per-layer groups of the port's LM trees -> the reference's stacked
#: group of the same leaves ("layers" is never sharded on L there; the
#: Whisper groups are stacked under "enc" and "dec")
_LAYER_GROUP = re.compile(r"^(layers|enc|dec)\.(\d+)\.(.*)$")


def dp_axes(mesh) -> Tuple[str, ...]:
    """The physical data-parallel axes present in ``mesh``."""
    return resolve_axes("dp", mesh)


def _try_candidate(shape, mesh, cand: Candidate) -> Optional[Spec]:
    """Resolve one candidate; None when a sharded dim doesn't divide."""
    if len(cand) > len(shape):
        return None
    used: set = set()
    entries = []
    for dim, entry in zip(shape, cand, strict=False):
        axes = resolve_axes(entry, mesh, used)
        prod = 1
        for ax in axes:
            prod *= mesh_axis_size(mesh, ax)
        if axes and dim % prod != 0:
            return None  # indivisible -> candidate fails, chain continues
        used.update(axes)
        entries.append(normalize_entry(axes))
    return tuple(entries)


def pick_spec(shape, mesh, chain: Sequence[Candidate]) -> Spec:
    """First candidate in ``chain`` that shards ``shape`` cleanly.

    Candidate entries are per-dimension: None, an axis name (logical or
    physical), or a tuple of names.  Names missing from the mesh are
    dropped silently; a name present but indivisible fails the whole
    candidate so the chain's fallback ordering is respected.  An empty
    candidate ``()`` always succeeds (full replication), as does an
    exhausted chain.
    """
    for cand in chain:
        spec = _try_candidate(tuple(shape), mesh, cand)
        if spec is not None:
            return spec
    return ()


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    if isinstance(node, nn.Module):
        return list(dict(node.named_parameters()).items())
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def tree_map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                       path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over every leaf; the result has the tree's
    structure (an ``nn.Module`` gives a dict keyed by parameter name, whose
    path is the name's dotted parts)."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    if isinstance(tree, nn.Module):
        return {k: fn(path + tuple(k.split(".")), v) for k, v in kids}
    out = [(k, tree_map_with_path(fn, v, path + (k,))) for k, v in kids]
    if isinstance(tree, dict):
        return dict(out)
    if hasattr(tree, "_fields"):
        return type(tree)(*(v for _, v in out))
    return type(tree)(v for _, v in out)


def tree_leaves(tree: Any) -> List[Any]:
    leaves: List[Any] = []
    tree_map_with_path(lambda _, v: leaves.append(v), tree)
    return leaves


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def spec_leaves(spec_tree: Any) -> List[Spec]:
    """The specs of a spec tree, in the order :func:`tree_leaves` walks
    the matching shape tree."""
    if _is_spec(spec_tree):
        return [spec_tree]
    kids = _children(spec_tree)
    out: List[Spec] = []
    for _, v in kids:
        out.extend(spec_leaves(v))
    return out


def _nbytes(leaf) -> int:
    return int(leaf.numel()) * leaf.element_size()


# ---------------------------------------------------------------------------
# Parameter rule tables
# ---------------------------------------------------------------------------


def _weight_chain(shape) -> Tuple[Candidate, ...]:
    """Fallback chain for a (possibly layer-stripped) weight shape."""
    r = len(shape)
    if r < 2:
        return ((),)
    if r == 2:
        # shard the larger dim over tp (column-parallel for (d, ff),
        # row-parallel for (ff, d)); fall back to the other, then replicate
        big = 0 if shape[0] > shape[1] else 1
        first = [None, None]
        first[big] = "tp"
        second = [None, None]
        second[1 - big] = "tp"
        return (tuple(first), tuple(second), ())
    if r == 3:
        # (E, d, ff) expert stacks: expert parallelism over tp when E
        # divides, else shard the expert ff dim, else the middle dim
        return (
            ("expert", None, None),
            (None, None, "tp"),
            (None, "tp", None),
            (),
        )
    # higher-rank (spectral-style) weights: try the channel dims
    tail = (None,) * (r - 3)
    return (
        (None, None, "tp") + tail,
        (None, "tp", None) + tail,
        (),
    )


def _stacked_lm_spec(names: Tuple[str, ...], shape, mesh) -> Spec:
    """The reference's rule for one leaf of its (stacked) LM tree."""
    stacked = "layers" in names
    inner_shape = shape[1:] if stacked else shape
    inner = pick_spec(inner_shape, mesh, _weight_chain(inner_shape))
    if stacked:
        return (None, *inner) if len(inner) else ()
    return inner


def _layer_counts(tree) -> Dict[str, int]:
    """Layers a group of an unstacked LM tree: {"layers": L, ...}."""
    counts: Dict[str, int] = {}
    for path in tree_leaf_paths(tree):
        m = _LAYER_GROUP.match(".".join(path))
        if m:
            counts[m.group(1)] = max(counts.get(m.group(1), 0), int(m.group(2)) + 1)
    return counts


def tree_leaf_paths(tree) -> List[Tuple[str, ...]]:
    paths: List[Tuple[str, ...]] = []
    tree_map_with_path(lambda p, _: paths.append(p), tree)
    return paths


def lm_param_specs(params_shape: Any, mesh) -> Any:
    """Spec tree for an LM parameter tree (an ``LM``/``Whisper`` module, on
    any device, or a dict of its named parameters).

    2D weights shard their larger dim over tp with divisibility fallback;
    vectors/norms replicate; expert stacks prefer expert parallelism.  A
    per-layer leaf (``layers.<i>.…``, Whisper's ``enc.<i>.…`` and
    ``dec.<i>.…``) is judged as the reference judges the stacked leaf of
    its group, (L, *shape), and gets that spec without its L entry.  The
    reference never shards L under ``layers``; where it does under
    Whisper's ``enc``/``dec`` (its rank-3 chain takes L as the expert
    axis), the port replicates instead: a per-layer weight has no L.
    """
    counts = _layer_counts(params_shape)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        m = _LAYER_GROUP.match(".".join(path))
        if m is None:
            return _stacked_lm_spec(path, shape, mesh)
        group, rest = m.group(1), tuple(m.group(3).split("."))
        stacked = _stacked_lm_spec((group,) + rest, (counts[group],) + shape, mesh)
        return tuple(stacked[1:])

    return tree_map_with_path(spec, params_shape)


def fno_param_specs(params_shape: Any, mesh, *, shard_threshold: int = 1 << 24) -> Any:
    """Spec tree for FNO/SFNO parameter trees.

    Default layout is full-DP: the weights are tiny relative to the
    activations, so everything replicates and the batch shards over the
    whole mesh (see ``constrain_spatial``).  Spectral leaves above
    ``shard_threshold`` elements (high-resolution dense factorizations)
    shard a channel dim over tp so the hr cells still fit.  The port's
    FNO trees stack their layers as the reference's do (``spectral`` and
    ``skips`` carry a leading L), so the threshold applies to the same
    stacked leaf and L is never sharded.
    """

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if int(leaf.numel()) < shard_threshold or len(shape) < 3:
            return ()
        stacked = bool(path) and path[0] in ("spectral", "skips")
        inner_shape = shape[1:] if stacked else shape
        inner = pick_spec(inner_shape, mesh, _weight_chain(inner_shape))
        if stacked:
            return (None, *inner) if len(inner) else ()
        return inner

    return tree_map_with_path(spec, params_shape)


# ---------------------------------------------------------------------------
# Batch / cache rule tables
# ---------------------------------------------------------------------------


def batch_specs(batch: Any, mesh) -> Any:
    """Leading-dim data parallelism for input batches, replicate fallback."""
    dp = dp_axes(mesh)

    def spec(_, leaf):
        r = len(leaf.shape)
        return pick_spec(leaf.shape, mesh, [(dp,) + (None,) * (r - 1), ()])

    return tree_map_with_path(spec, batch)


def cache_specs(cache: Any, mesh, cfg: Any) -> Any:
    """Decode-cache layout: slots over dp, heads over tp when they divide.

    Layer-stacked leaves (leading dim equal to the config's layer count)
    keep the layer axis replicated and shard the slot dim that follows
    it; per-slot leaves (the ``step`` clocks) shard dim 0.
    """
    dp = dp_axes(mesh)
    layer_counts = {
        n for n in (getattr(cfg, "n_layers", None), getattr(cfg, "dec_layers", None))
        if n
    }
    head_keys = ("k", "v", "ssd_state")

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        r = len(shape)
        stacked = r >= 2 and shape[0] in layer_counts
        if not stacked:
            return pick_spec(shape, mesh, [(dp,) + (None,) * (r - 1), ()])
        base = [None, dp] + [None] * (r - 2)
        chain = []
        if path and path[-1] in head_keys and r > 2:
            with_heads = list(base)
            with_heads[2] = "heads"
            chain.append(tuple(with_heads))
        chain += [tuple(base), ()]
        return pick_spec(shape, mesh, chain)

    return tree_map_with_path(spec, cache)


# ---------------------------------------------------------------------------
# Placement + accounting
# ---------------------------------------------------------------------------


def to_placements(mesh, spec: Spec) -> list:
    """A spec -> DTensor placements on ``mesh``: ``Shard(d)`` on every mesh
    dim named in tensor dim d's entry (a dim over several axes is sharded
    on each, in mesh-dim order), ``Replicate()`` on the others.  A mesh dim
    of size 1 is ``Replicate()`` either way: sharding over one rank is
    replication, and DTensor refuses some views of a dim "sharded" so."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else entry):
            if mesh_axis_size(mesh, ax) > 1:
                out[names.index(ax)] = Shard(d)
    return out


def _distribute_leaf(t: torch.Tensor, mesh, spec: Spec):
    """One tensor on ``mesh`` at ``spec``: each rank keeps its own block
    of the (identical on every rank) global tensor, without a collective.
    A meta or fake tensor becomes a DTensor over a local tensor of the
    block's shape."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = to_placements(mesh, spec)
    if t.is_meta or _is_fake(t):
        local_shape, _ = local_block(t.shape, mesh, placements)
        local = t.new_empty(local_shape)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t.detach(), mesh, placements, src_data_rank=None)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def distribute(tree: Any, mesh, specs: Any) -> Any:
    """Place ``tree`` on ``mesh`` by ``specs`` (the counterpart of the
    reference's ``device_put(tree, to_named(mesh, specs))``).

    An ``nn.Module`` is placed in place, each parameter replaced by an
    ``nn.Parameter`` over a DTensor, and returned; any other tree comes
    back with DTensor leaves.  Every rank must hold the same global
    values (the seeded weights do): each keeps its block, nothing is
    sent."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner_name, _, leaf = name.rpartition(".")
            owner = tree.get_submodule(owner_name) if owner_name else tree
            dt = _distribute_leaf(p.data, mesh, specs[name])
            owner.register_parameter(leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
        return tree
    leaves = iter(spec_leaves(specs))
    return tree_map_with_path(lambda _, t: _distribute_leaf(t, mesh, next(leaves)), tree)


def replication_report(shape_tree: Any, spec_tree: Any) -> Dict[str, Any]:
    """Byte accounting of a (shapes, specs) pair: how much parameter
    memory is sharded vs fully replicated per device."""
    stats = {"total_bytes": 0, "sharded_bytes": 0, "replicated_bytes": 0,
             "n_leaves": 0, "n_sharded": 0}
    leaves = tree_leaves(shape_tree)
    specs = spec_leaves(spec_tree)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves but {len(specs)} specs")
    for leaf, spec in zip(leaves, specs, strict=True):
        nbytes = _nbytes(leaf)
        sharded = any(e is not None for e in spec)
        stats["total_bytes"] += nbytes
        stats["n_leaves"] += 1
        if sharded:
            stats["sharded_bytes"] += nbytes
            stats["n_sharded"] += 1
        else:
            stats["replicated_bytes"] += nbytes
    total = stats["total_bytes"]
    stats["replicated_fraction"] = stats["replicated_bytes"] / total if total else 0.0
    return stats


# ---------------------------------------------------------------------------
# Slot-row writes into a (possibly sharded) serving cache
# ---------------------------------------------------------------------------
#
# A cache leaf holds one slot a row of dim 0 (slots over dp), and may shard
# a head dim over tp.  A write touches a few (slot, row) cells; DTensor has
# no in-place ``index_put_`` strategy for a sharded tensor, and gathering
# the cache to write it would move the whole cache a tick.  Each rank
# writes the cells of its own block instead: the written values are
# redistributed to the cache's head sharding (slots replicated: they are
# tiny), the global slot indices are translated to the rank's block, and
# the local tensor is written in place.  On a plain tensor the helpers are
# the plain indexed assignment.


def local_block(shape, mesh, placements) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(local shape, global offset) of this rank's block of a tensor of
    ``shape`` at ``placements``: DTensor's even chunking (ceil-sized
    chunks, mesh dims in order), computed in Python so it also holds under
    ``FakeTensorMode``."""
    from torch.distributed.tensor import Shard

    local, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d, n, c = p.dim, int(mesh.shape[i]), int(coord[i])
        chunk = -(-local[d] // n)
        start = min(c * chunk, local[d])
        size = max(0, min(local[d], start + chunk) - start)
        off[d] += start
        local[d] = size
    return tuple(local), tuple(off)


def _local_block(dst):
    """(local shape, global offset) of this rank's block of DTensor ``dst``."""
    return local_block(dst.shape, dst.device_mesh, dst.placements)


def _plain(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _values_local(val, dst, dim_map: Dict[int, int]):
    """``val`` as this rank's local tensor: every dst dim d sharded over a
    mesh dim maps to val dim ``dim_map[d]`` (sharded alike), the slot dim
    (absent from ``dim_map``) stays whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    mesh = dst.device_mesh
    target = []
    for p in dst.placements:
        if isinstance(p, Shard) and p.dim != 0:
            if p.dim not in dim_map:
                raise NotImplementedError(
                    f"a write indexes dim {p.dim} of a cache leaf sharded on it")
            target.append(Shard(dim_map[p.dim]))
        else:
            target.append(Replicate())
    if isinstance(val, DTensor):
        return val.redistribute(mesh, target).to_local()
    if not torch.is_tensor(val) or val.ndim == 0:
        return val
    return distribute_tensor(val, mesh, target, src_data_rank=None).to_local()


def write_rows(dst, b, r, val, row_dim: int = 1) -> None:
    """``dst[b, …, r] = val`` in place: slot ``b[i]`` (dim 0) at row ``r[i]``
    (dim ``row_dim``; the dims between are whole), ``val`` (n, *the other
    dims of dst).  ``b=None`` means every slot in order (``r`` (B,)).

    On a DTensor each rank writes its own slots' cells (see above)."""
    from torch.distributed.tensor import DTensor

    mid = (slice(None),) * (row_dim - 1)
    if not isinstance(dst, DTensor):
        if b is None:
            b = torch.arange(dst.shape[0], device=dst.device)
        dst[(b,) + mid + (r,)] = val
        return
    # val dims: (n, dst dims other than 0 and row_dim, in order)
    others = [d for d in range(1, dst.ndim) if d != row_dim]
    local_val = _values_local(val, dst, {d: 1 + i for i, d in enumerate(others)})
    shape, off = _local_block(dst)
    n0, o0 = shape[0], off[0]
    r = _plain(r)
    local = dst.to_local()
    if b is None:
        rows = r[o0:o0 + n0]
        sel = torch.arange(n0, device=local.device)
        local[(sel,) + mid + (rows.to(local.device),)] = (
            local_val[o0:o0 + n0] if torch.is_tensor(local_val) else local_val)
        return
    b = _plain(b)
    # integer positions of this rank's writes (a static shape for fake values)
    keep = ((b >= o0) & (b < o0 + n0)).nonzero().flatten()
    vals = local_val[keep.to(local_val.device)] if torch.is_tensor(local_val) and \
        local_val.ndim else local_val
    local[((b[keep] - o0).to(local.device),) + mid + (r[keep].to(local.device),)] = vals


def fill_slots(dst, ids, value, slot_dim: int = 0) -> None:
    """``dst[:, …, ids] = value`` in place on dim ``slot_dim`` (the slot
    dim: 0 for per-slot leaves, 1 for layer-stacked ones); ``value`` a
    scalar or one value a slot of ``ids``.  On a DTensor each rank writes
    its own slots."""
    from torch.distributed.tensor import DTensor, Shard

    lead = (slice(None),) * slot_dim
    if not isinstance(dst, DTensor):
        dst[lead + (ids,)] = value
        return
    shape, off = _local_block(dst)
    for p in dst.placements:
        if isinstance(p, Shard) and p.dim < slot_dim:
            raise NotImplementedError(f"slot writes into a leaf sharded on dim {p.dim}")
    n0, o0 = shape[slot_dim], off[slot_dim]
    ids = _plain(ids)
    keep = ((ids >= o0) & (ids < o0 + n0)).nonzero().flatten()
    local = dst.to_local()
    if torch.is_tensor(value) and value.ndim:
        value = _plain(value)[keep].to(local.device)
    local[lead + ((ids[keep] - o0).to(local.device),)] = value
