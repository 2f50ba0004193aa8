"""The FNO family's hidden channels split over tp (``repro_torch.dist.channels``).

* Each function of ``dist.channels`` and its transpose on a fake (2, 4)
  world (this process is rank 0 of the model axis' group of 4): the shapes
  and dtypes both ways, complex tensors, a dim named from the end, and the
  identity off the scope.
* ``launch.steps.channel_axis`` and ``channel_blocks``: which steps split,
  over which axis, and which leaves a rank holds a block of.
* On four gloo ranks, a (2, 2) mesh: ``launch.parity.fno_parity`` for the
  ``fno-darcy``, ``tfno-ns`` and ``sfno-swe`` smoke cells with a batch of
  2 (which does not cover the mesh, so the channels split over "model"),
  3 steps against one device under ``full``, ``mixed_fno_bf16`` and
  ``mixed_fno_bf16`` with the 2σ-clip stabiliser (whose statistics span
  every channel: its sums are all-reduced over tp); and
  the hazard the two ``gather``s guard against: the projection's gather
  given a reduce-scatter backward (a repeated consumer summed over tp)
  makes every gradient upstream of it tp = 2 times too large, which
  AdamW's update hides and the gradient check sees.
"""
import pytest
import torch

from repro_torch.dist import channels
from repro_torch.launch import dryrun
from test_torch_dist import _run_ranks


@pytest.fixture(scope="module")
def model_group():
    from repro_torch.launch.mesh import fake_world

    with fake_world(8):
        mesh = dryrun.make_mesh((2, 4), ("data", "model"))
        yield mesh, mesh.get_group("model"), mesh.get_local_rank("model")


def _grad(fn, x, g):
    x = x.detach().requires_grad_()
    y = fn(x)
    (gx,) = torch.autograd.grad(y, x, g)
    return y, gx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.complex64])
def test_channel_functions_and_their_transposes(model_group, dtype):
    _, group, rank = model_group
    assert rank == 0
    x = torch.randn(2, 8, 6, 5).to(dtype)
    with channels.channel_scope(group, rank, 4) as scope:
        assert channels.active() is scope and scope.size == 4
        # split: the block forward, the whole cotangent back
        y, gx = _grad(channels.split, x, torch.ones(2, 2, 6, 5, dtype=dtype))
        assert torch.equal(y, x[:, :2]) and gx.shape == x.shape and gx.dtype == dtype
        # gather for a consumer that differs by rank: reduce-scatter back
        blk = x[:, :2]
        y, gb = _grad(channels.gather, blk, torch.ones(2, 8, 6, 5, dtype=dtype))
        assert y.shape == (2, 8, 6, 5) and y.dtype == dtype
        assert gb.shape == blk.shape and gb.dtype == dtype
        # gather for a repeated consumer: this rank's block of the cotangent
        g = torch.randn(2, 8, 6, 5).to(dtype)
        y, gb = _grad(lambda t: channels.gather(t, repeated=True), blk, g)
        assert y.shape == (2, 8, 6, 5) and torch.equal(gb, g[:, :2])
        # the last dim, named from the end (a complex tensor's real view
        # has one dim more)
        y, gb = _grad(lambda t: channels.gather(t, dim=-1), blk, torch.ones(2, 2, 6, 20,
                                                                           dtype=dtype))
        assert y.shape == (2, 2, 6, 20) and y.dtype == dtype
        assert gb.shape == blk.shape and gb.dtype == dtype
        y, gx = _grad(lambda t: channels.split(t, dim=-3), x, torch.ones(2, 2, 6, 5, dtype=dtype))
        assert torch.equal(y, x[:, :2]) and gx.shape == x.shape
        # all_reduce: the same shape both ways
        y, gb = _grad(channels.all_reduce, blk, torch.ones_like(blk))
        assert y.shape == blk.shape and y.dtype == dtype
        assert gb.shape == blk.shape and gb.dtype == dtype
        # reduce_scatter (on the last dim, rounded to another dtype): the
        # block forward, the whole cotangent back at the input's dtype
        if not dtype.is_complex:
            part = torch.randn(2, 6, 5, 8)
            y, gp = _grad(lambda t: channels.reduce_scatter(t, dim=-1, dtype=dtype), part,
                          torch.ones(2, 6, 5, 2, dtype=dtype))
            assert y.shape == (2, 6, 5, 2) and y.dtype == dtype
            assert gp.shape == part.shape and gp.dtype == torch.float32
        with pytest.raises(ValueError, match="do not split"):
            channels.split(torch.randn(2, 6, 3))
    assert channels.active() is None


def test_channel_functions_are_the_identity_off_the_scope(model_group):
    _, group, rank = model_group
    x = torch.randn(2, 8, 6, requires_grad=True)
    assert channels.active() is None
    assert channels.split(x) is x and channels.gather(x) is x
    assert channels.gather(x, repeated=True) is x and channels.reduce_scatter(x) is x
    assert channels.all_reduce(x) is x
    assert channels.reduce_scatter(x, dtype=torch.bfloat16).dtype == torch.bfloat16
    # a group of one rank splits nothing
    with channels.channel_scope(group, rank, 1) as scope:
        assert scope is None and channels.active() is None and channels.split(x) is x


def test_which_steps_split_and_the_blocks(model_group):
    from repro_torch.configs.fno_paper import SFNO_SWE_SMOKE, TFNO_NS_SMOKE
    from repro_torch.launch.steps import channel_axis, channel_blocks
    from repro_torch.models.fno import FNO, FNOConfig
    from repro_torch.models.sfno import SFNO

    mesh, _, _ = model_group
    assert channel_axis(mesh, (8, 1, 16, 16), 16) is None      # the batch covers 2 x 4
    assert channel_axis(mesh, (4, 1, 16, 16), 16) == "model"   # batch over data, channels over tp
    assert channel_axis(mesh, (1, 1, 16, 16), 16) == "model"   # the batch whole
    assert channel_axis(mesh, (4, 1, 16, 16), 6) is None       # 4 does not divide 6
    with torch.device("meta"):
        dense, cp, tucker, sfno = (FNO(FNOConfig(hidden_channels=8, modes=(4, 4))),
                                   FNO(TFNO_NS_SMOKE),
                                   FNO(FNOConfig(hidden_channels=8, modes=(4, 4),
                                                 factorization="tucker")),
                                   SFNO(SFNO_SWE_SMOKE))
    assert channel_blocks(dense) == {"skips.w": 1, "skips.b": 1, "spectral.w_re": 3,
                                     "spectral.w_im": 3}
    assert channel_blocks(sfno) == {"skips.w": 1, "skips.b": 1, "spectral.w_re": 2,
                                    "spectral.w_im": 2}
    for model in (cp, tucker):
        blocks = channel_blocks(model)
        assert set(blocks) == {"skips.w", "skips.b"} | {f"spectral.{n}" for n in model.spectral}
        assert {k for k, d in blocks.items() if d == 2} == {"spectral.U_o_re", "spectral.U_o_im"}
        # the factors every rank holds whole: their gradients are summed over tp
        assert any(d is None for d in blocks.values())


def test_fno_steps_split_channels_on_four_ranks(tmp_path):
    out = _run_ranks("""
        import json

        def main(rank, mesh):
            from repro_torch.dist import channels
            from repro_torch.launch.parity import FNO_POLICIES, fno_parity

            for name in ("fno-darcy", "tfno-ns", "sfno-swe"):
                for policy in FNO_POLICIES:
                    rec = fno_parity(mesh, name, policy)
                    assert rec["ok"] and rec["channels_over"] == "model", rec
                    if rank == 0:
                        print(json.dumps(rec), flush=True)
            # the hazard: a repeated consumer's cotangent summed over tp
            gather = channels.gather
            channels.gather = lambda x, dim=1, repeated=False: gather(x, dim)
            try:
                rec = fno_parity(mesh, "fno-darcy", "full")
            finally:
                channels.gather = gather
            assert not rec["ok"], rec
            # every gradient upstream of the projection twice its size
            assert abs(rec["worst"]["grad"]["rel"] - 1.0) < 1e-3, rec["worst"]
            assert not rec["worst"]["grad"]["at"].startswith("grad:proj"), rec["worst"]
            if rank == 0:
                print("HAZARD", json.dumps(rec["worst"]), flush=True)

        if __name__ == "__main__":
            run(main)
    """, tmp_path)
    assert out.count('"check": "fno_step"') == 9 and "HAZARD" in out
    assert out.count('"policy": "mixed_fno_bf16+sigma_clip"') == 3


def test_one_rank_of_a_split_cell_rehearses_on_the_cpu():
    """``launch.rank_step`` (phase 13 (g) on the card) at smoke size on the
    CPU: rank 0 of a fake (2, 4) world splits the TFNO's 16 hidden
    channels 4 a rank and runs its steps; the CPU times no device and its
    plain kernels count no launch."""
    from repro_torch.configs.fno_paper import TFNO_NS_SMOKE
    from repro_torch.launch import rank_step

    rec = rank_step.run("tfno-smoke", device="cpu", mesh_shape=(2, 4), steps=2,
                        cell=dict(kind="fno", cfg=TFNO_NS_SMOKE, res=(16, 16), batch=4))
    assert (rec["channels_over"], rec["channels_a_rank"], rec["batch_axes"]) == ("model", 4,
                                                                                ["data"])
    assert rec["local_batch"] == [2, 1, 16, 16] and rec["steps"] == 2
    assert rec["ms_per_step"] == [] and rec["max_memory_allocated_bytes"] is None
    assert rec["launches"] == {}
