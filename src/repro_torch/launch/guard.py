"""A version-independent check for the DTensor views torch 2.11 refuses.

Torch 2.11's DTensor refuses to flatten a dim sharded over the mesh into a
preceding one ("Attempted to flatten multiple dimensions, with dimension 1
being sharded"); later versions run it.  :class:`FlattenGuard` is a
dispatch mode that sees every ATen op issued on DTensor arguments, forward
and backward, and records each ``view`` / ``_unsafe_view`` / ``reshape``
whose merged group of input dims holds a sharded dim that is not the
group's first, or that splits a sharded dim into parts whose first the
sharding ranks do not divide ("Attempted to split the sharded dimension").
It also records each ``index_put`` (the backward of a row gather) whose
values are sharded on an index dim, which torch 2.11's rule maps to a
negative dim and fails on.  A dry-run cell that records none runs on
either torch.

The CLI runs the dry-run's smoke cells on a fake (2, 4) mesh under the
guard and prints, a JSON line a cell, whether it ran and what the guard
saw (arch, kind, status, seconds, the hits and the port lines they came
from).  CPU only:

    PYTHONPATH=src python -m repro_torch.launch.guard [--kinds train,prefill,decode]

Run by its path, it holds another checkout's port (the one on
``PYTHONPATH``) to this checkout's guard:

    PYTHONPATH=<checkout>/src python src/repro_torch/launch/guard.py
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_VIEWS = ("view", "_unsafe_view", "reshape")
_INDEX_PUTS = ("index_put", "index_put_", "_index_put_impl_")


def view_groups(src, dst):
    """The groups ``(input dims, output dims)`` of a view from shape ``src``
    to ``dst`` whose products agree, size-1 dims left out."""
    groups, i, j = [], 0, 0
    while True:
        while i < len(src) and src[i] == 1:
            i += 1
        while j < len(dst) and dst[j] == 1:
            j += 1
        if i >= len(src) or j >= len(dst):
            return groups
        ins, outs, a, b = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                ins.append(i)
                a *= src[i]
                i += 1
            else:
                outs.append(j)
                b *= dst[j]
                j += 1
        groups.append((ins, outs))


class FlattenGuard(TorchDispatchMode):
    """Records the views that merge a sharded dim into a preceding one or
    split one unevenly, and the ``index_put``s with values sharded on an index dim (see the module
    docstring).  ``hits``: (op, shape, target or values shape, placements,
    the innermost port frames)."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.placement_types import Shard

        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **(kwargs or {}))
        name, x = func._overloadpacket.__name__, args[0]

        def sharded(t):
            return {p.dim % t.ndim for m, p in enumerate(t.placements)
                    if isinstance(p, Shard) and t.device_mesh.size(m) > 1}

        hit = None
        if (name in _VIEWS and isinstance(x, DTensor) and len(args) > 1
                and isinstance(args[1], (list, tuple)) and x.numel()):
            dst = [int(d) for d in args[1]]
            if -1 in dst:
                known = 1
                for d in dst:
                    known *= d if d != -1 else 1
                dst = [x.numel() // known if d == -1 else d for d in dst]
            ranks = {}
            for m, p in enumerate(x.placements):
                if isinstance(p, Shard) and x.device_mesh.size(m) > 1:
                    d = p.dim % x.ndim
                    ranks[d] = ranks.get(d, 1) * x.device_mesh.size(m)
            for ins, outs in view_groups(list(x.shape), dst):
                # a merge that takes a sharded dim after the group's first, or
                # a split of a sharded dim whose first part the ranks do not divide
                if (len(ins) > 1 and set(ranks) & set(ins[1:])) or (
                        len(ins) == 1 and len(outs) > 1 and ins[0] in ranks
                        and dst[outs[0]] % ranks[ins[0]]):
                    hit = (tuple(x.shape), tuple(dst), tuple(x.placements))
        elif name in _INDEX_PUTS and isinstance(args[2], DTensor):
            values, n_idx = args[2], sum(i is not None for i in args[1])
            lead = values.ndim - (x.ndim - n_idx)        # the index dims of values
            if any(d < lead for d in sharded(values)):
                hit = (tuple(x.shape), tuple(values.shape), tuple(values.placements))
        if hit is not None:
            where = [f"{f.filename.split('src/')[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()
                     if "repro_torch" in f.filename and f.filename != __file__]
            self.hits.append((name, *hit, where[-3:]))
        return NotImplemented


@contextlib.contextmanager
def guarding(guard: FlattenGuard):
    """The dry-run's steps run with ``guard`` around them for the scope
    (inside the counting mode, whose counts it leaves as they are)."""
    from repro_torch.launch import dryrun

    count_step = dryrun.count_step

    def counted(fn, *args, **kwargs):
        def step(*a, **k):
            with guard:
                return fn(*a, **k)
        return count_step(step, *args, **kwargs)

    dryrun.count_step = counted
    try:
        yield guard
    finally:
        dryrun.count_step = count_step


def guarded_cell(arch, kind, mesh_shape=(2, 4), guard=None):
    """The dry-run cell of the arch's smoke config under ``guard`` (a new
    :class:`FlattenGuard` by default): (record, guard).  ``kind``: "train",
    "prefill" or "decode" (64 tokens, batch 4), or a ``ShapeConfig``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun

    shape = kind if isinstance(kind, ShapeConfig) else ShapeConfig(f"{kind}_smoke", 64, 4, kind)
    with guarding(guard or FlattenGuard()) as guard:
        rec = dryrun.run_cell(arch, shape, False, mesh_shape=mesh_shape, smoke=True,
                              verbose=False)
    return rec, guard


def main(argv=None):
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ARCH_IDS))
    ap.add_argument("--kinds", default="train,prefill,decode")
    args = ap.parse_args(argv)
    print(json.dumps({"torch": torch.__version__}), flush=True)
    for arch in args.archs.split(","):
        for kind in args.kinds.split(","):
            t0 = time.perf_counter()
            guard = FlattenGuard()
            try:
                status = guarded_cell(arch, kind, guard=guard)[0]["status"]
            except Exception as e:  # the refusal under test
                status = f"FAILED {type(e).__name__}: {(str(e).splitlines() or [''])[0][:200]}"
            print(json.dumps({"arch": arch, "kind": kind, "status": status,
                              "seconds": round(time.perf_counter() - t0, 2),
                              "hits": len(guard.hits),
                              "sites": sorted({h[4][-1] for h in guard.hits if h[4]})}),
                  flush=True)


if __name__ == "__main__":
    main()
