"""Training every LM arch on a mesh, on the CPU (fake process groups).

* ``constrain``'s transpose: on a fake (2, 4) mesh the cotangent leaves
  ``constrain`` in the target placements, not the input's; ``pin`` brings
  it back to its tensor's own; off a mesh, and on a 1x1 mesh, both are the
  identity and the gradient is the one that came in.
* The smoke train cells of the dry-run on a fake (2, 4) mesh end ``ok``
  (this file: five archs; ``test_torch_dist_cells.py`` the other five and
  the prefill and decode cells), and ``repro_torch.launch.guard``'s
  ``FlattenGuard`` (a version-independent stand-in for torch 2.11's refusal
  to flatten a dim sharded over the mesh into a preceding one) records no
  view or ``index_put`` that torch would refuse.
"""
import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch.guard import FlattenGuard, guarded_cell


def assert_cell_clean(arch, kind, mesh_shape=(2, 4)):
    rec, guard = guarded_cell(arch, kind, mesh_shape)
    assert rec["status"] == "ok", rec
    assert rec["roofline"]["flops_per_device"] > 0
    assert not guard.hits, guard.hits[:5]


# ---------------------------------------------------------------------------
# constrain's transpose
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh24():
    from repro_torch.launch.mesh import fake_world

    with fake_world(8):
        yield dryrun.make_mesh((2, 4), ("data", "model"))


def _dtensor(mesh, placements, shape=(8, 4), seed=0):
    from torch.distributed.tensor import DTensor
    from repro_torch.dist.sharding import local_block

    local_shape, _ = local_block(shape, mesh, placements)
    local = torch.randn(local_shape, generator=torch.Generator().manual_seed(seed))
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=(shape[1], 1))


def test_constrain_transposes_to_the_target(mesh24):
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.dist import constrain, pin, use_mesh

    x = _dtensor(mesh24, [Replicate(), Shard(0)]).requires_grad_()
    g = _dtensor(mesh24, [Replicate(), Replicate()], seed=1)
    with use_mesh(mesh24):
        y = constrain(x, "dp", None)
        assert tuple(y.placements) == (Shard(0), Replicate())
        (gx,) = torch.autograd.grad(y, x, g)
        # the reference's transpose: the cotangent at the target's placements
        assert tuple(gx.placements) == (Shard(0), Replicate())
        # a constraint the tensor already meets still places its cotangent
        z = _dtensor(mesh24, [Shard(0), Replicate()]).requires_grad_()
        (gz,) = torch.autograd.grad(constrain(z, "dp", None), z, g)
        assert tuple(gz.placements) == (Shard(0), Replicate())
        # pin: the cotangent back at the tensor's own placements
        (gp,) = torch.autograd.grad(pin(x), x, g)
        assert tuple(gp.placements) == (Replicate(), Shard(0))
        # a partial sum's cotangent is replicated over its mesh dim
        p = _dtensor(mesh24, [Partial(), Replicate()]).requires_grad_()
        (gq,) = torch.autograd.grad(pin(p), p, g)
        assert tuple(gq.placements) == (Replicate(), Replicate())


def test_constrain_and_pin_are_the_identity_off_mesh(mesh24):
    from repro_torch.dist import constrain, pin, use_mesh

    x = torch.randn(8, 4, requires_grad=True)
    g = torch.randn(8, 4)
    for scope in (use_mesh(None), use_mesh(dryrun.make_mesh((1, 1), ("data", "model")))):
        with scope:
            for y in (constrain(x, "dp", None), pin(x)):
                assert y is x
                (gx,) = torch.autograd.grad(y, x, g)
                assert torch.equal(gx, g)


def test_matmul_folds_on_the_local_shards(mesh24):
    """A (B, S, d) activation sharded on S: the product runs with no view
    that folds S, and its placements are those DTensor's own fold would
    give; a plain tensor or an unsharded S is ``torch.matmul``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist import use_mesh
    from repro_torch.dist.local import matmul

    a = torch.randn(2, 3, 5)
    b = torch.randn(5, 7)
    assert torch.equal(matmul(a, b), torch.matmul(a, b))
    x = DTensor.from_local(torch.randn(2, 4, 16), mesh24, [Shard(0), Shard(1)], run_check=False,
                           shape=torch.Size((4, 16, 16)), stride=(256, 16, 1))
    w = DTensor.from_local(torch.randn(16, 6), mesh24, [Replicate(), Replicate()],
                           run_check=False, shape=torch.Size((16, 6)), stride=(6, 1))
    guard = FlattenGuard()
    with use_mesh(mesh24), guard:
        y = matmul(x.requires_grad_(), w.requires_grad_())
        torch.autograd.grad(y.sum(), (x, w))
    assert tuple(y.shape) == (4, 16, 6) and tuple(y.placements) == (Shard(0), Shard(1))
    assert y.to_local().shape == (2, 4, 6)
    assert not guard.hits, guard.hits


# ---------------------------------------------------------------------------
# Train cells on a fake (2, 4) mesh, under the guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["whisper-large-v3", "deepseek-v2-lite-16b", "hymba-1.5b",
                                  "stablelm-3b", "starcoder2-15b"])
def test_train_cell_runs_with_no_sharded_flatten(arch):
    assert_cell_clean(arch, "train")
