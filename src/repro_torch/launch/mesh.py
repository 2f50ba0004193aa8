"""Production and debug meshes.

Functions, not module-level constants: importing this module touches no
process-group state.  The production meshes need a default process group
of exactly their size (256 or 512 ranks); the dry-runs get one from a fake
process group (:func:`fake_world`), the counterpart of the reference's
forced host devices.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_shape(multi_pod: bool = False):
    """((2, 16, 16), ("pod", "data", "model")) or ((16, 16), ("data", "model"))."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu") -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks ("data", "model").  Multi-pod:
    2x16x16 = 512 ranks ("pod", "data", "model").  The default process
    group must have exactly that many ranks."""
    shape, names = production_shape(multi_pod)
    need = 1
    for s in shape:
        need *= s
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh(multi_pod={multi_pod}) needs a default "
                           f"process group of world size {need}; none is initialised")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"make_production_mesh(multi_pod={multi_pod}) needs a default "
                           f"process group of world size {need}, not {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_debug_mesh(n_devices: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A (1, n) ("data", "model") mesh over the first n ranks of the
    default process group (tests, the card's one-rank world)."""
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs a default process group")
    if n_devices > dist.get_world_size():
        raise RuntimeError(f"make_debug_mesh({n_devices}) needs {n_devices} ranks, "
                           f"the world has {dist.get_world_size()}")
    import torch

    return DeviceMesh(device_type, torch.arange(n_devices).reshape(1, n_devices),
                      mesh_dim_names=("data", "model"))


@contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` fake ranks for the scope
    (this process is rank 0; collectives return at once and move
    nothing).  The counterpart of the reference's forced host devices: a
    step traced under it and ``FakeTensorMode`` shows each rank's shapes
    and collectives without a device.  Torn down on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs no default process group to be initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
