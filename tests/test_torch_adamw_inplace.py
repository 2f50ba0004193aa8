"""``AdamW.update_``: the LM train step's optimizer writes the parameters
and the moments in place, a leaf at a time, as the reference's donated
step does, with the bits of the functional ``AdamW.update``.

* Three steps of ``update_`` against ``update`` on the same gradients:
  parameters, ``mu``, ``nu`` and ``count`` bit-equal, with the global-norm
  clip active, inactive and off, on f32 and bf16 gradients; the gradients
  are dropped from the dict as their leaves are updated.
* ``build_train_step`` returns the state object it was given, updated,
  and its step is the parent's (``update``, then the new parameters copied
  in) bit for bit.
* Four gloo ranks (a 2x2 mesh), in a subprocess: the same on DTensor
  leaves sharded on either dim or replicated.
"""
import pytest
import torch

from repro_torch.optim import AdamW
from test_torch_dist import _run_ranks

SHAPES = {"a.w": (24, 16), "b.bias": (16,), "c.emb": (40, 8)}


def _tree(seed, scale=1.0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {k: (scale * torch.randn(s, generator=g)).to(dtype) for k, s in SHAPES.items()}


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("clip,scale", [(1.0, 10.0), (1.0, 0.01), (None, 1.0)],
                         ids=["clip_active", "clip_inactive", "no_clip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_update_in_place_is_update_bit_for_bit(clip, scale, dtype):
    opt = AdamW(lr=1e-2, weight_decay=0.1, grad_clip_norm=clip)
    p0 = _tree(0)
    p1 = {k: v.clone() for k, v in p0.items()}
    s0, s1 = opt.init(p0), opt.init(p1)
    for step in range(3):
        grads = _tree(10 + step, scale, dtype)
        p0, s0 = opt.update(grads, s0, p0)
        given = dict(grads)
        out = opt.update_(given, s1, p1)
        assert out is s1 and not given
        assert _same(p0, p1) and _same(s0.mu, s1.mu) and _same(s0.nu, s1.nu)
        assert torch.equal(s0.count, s1.count)
    assert int(s1.count) == 3


def test_train_step_updates_its_state_in_place_as_the_parent_did():
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.parity import GradCapture, init_params, train_batch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.precision import get_policy

    cfg = get_config("smollm-360m", smoke=True)
    shape = ShapeConfig("t", 16, 2, "train")
    batch = train_batch(cfg, 2, 16)
    opt = AdamW(lr=1e-3)
    probe = GradCapture()
    p0 = init_params(cfg)
    s0 = opt.init(dict(p0.named_parameters()))
    grad_step = build_train_step(cfg, shape, get_policy("full"), probe).step_fn
    step = build_train_step(cfg, shape, get_policy("full"), opt).step_fn
    p1 = init_params(cfg)
    s1 = opt.init(dict(p1.named_parameters()))
    for _ in range(2):
        # the parent's step: the functional update, its parameters copied in
        grad_step(p0, (), batch)
        new, s0 = opt.update(probe.grads, s0, {k: p.detach() for k, p in p0.named_parameters()})
        with torch.no_grad():
            for k, p in p0.named_parameters():
                p.copy_(new[k])
        p1, out, _ = step(p1, s1, batch)
        assert out is s1
    n0 = {k: p.detach() for k, p in p0.named_parameters()}
    n1 = {k: p.detach() for k, p in p1.named_parameters()}
    assert _same(n0, n1) and _same(s0.mu, s1.mu) and _same(s0.nu, s1.nu)
    assert torch.equal(s0.count, s1.count)


def test_update_in_place_on_dtensor_leaves_on_four_ranks(tmp_path):
    out = _run_ranks("""
        def main(rank, mesh):
            from torch.distributed.tensor import Replicate, Shard, distribute_tensor
            from torch.distributed.tensor.experimental import implicit_replication
            from repro_torch.optim import AdamW

            place = {"a.w": [Shard(0), Shard(1)], "b.bias": [Replicate(), Replicate()],
                     "c.emb": [Replicate(), Shard(0)]}
            shapes = {"a.w": (24, 16), "b.bias": (16,), "c.emb": (40, 8)}

            def tree(seed, scale=1.0, dtype=torch.float32):
                g = torch.Generator().manual_seed(seed)
                return {k: distribute_tensor((scale * torch.randn(s, generator=g)).to(dtype),
                                             mesh, place[k]) for k, s in shapes.items()}

            with implicit_replication():
                for clip, scale, dtype in ((1.0, 10.0, torch.float32), (1.0, 0.01, torch.bfloat16),
                                           (None, 1.0, torch.bfloat16)):
                    opt = AdamW(lr=1e-2, weight_decay=0.1, grad_clip_norm=clip)
                    p0 = tree(0)
                    p1 = {k: v.clone() for k, v in p0.items()}
                    s0, s1 = opt.init(p0), opt.init(p1)
                    for step in range(3):
                        grads = tree(10 + step, scale, dtype)
                        p0, s0 = opt.update(grads, s0, p0)
                        assert opt.update_(dict(grads), s1, p1) is s1
                    for a, b in ((p0, p1), (s0.mu, s1.mu), (s0.nu, s1.nu)):
                        for k in a:
                            assert tuple(b[k].placements) == tuple(place[k]), k
                            assert torch.equal(a[k].to_local(), b[k].to_local()), (clip, k)
                    assert torch.equal(s0.count, s1.count) and int(s1.count) == 3
            print("MATCH", rank, flush=True)

        if __name__ == "__main__":
            run(main)
    """, tmp_path)
    assert out.count("MATCH") == 4
