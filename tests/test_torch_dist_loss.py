"""The LM train step holds on a rank what the reference's step holds, on
the CPU.

* On a fake (2, 4) mesh, one smoke ``train`` dry-run cell a arch, traced
  with a probe around ``roofline._CountMode``'s dispatch: no op a rank runs
  makes a tensor whose last dim is the vocabulary with more rows than the
  rank's block of the logits (B/2 · S/4), forward or backward; every
  gradient ``launch.steps._grads`` returns has its parameter's placements
  and local shape.
* ``cross_entropy`` on a DTensor runs no op through DTensor, and off a
  mesh, on a 1x1 mesh and on plain tensors the loss and the head's product
  are the expressions they replace, bit for bit.
* Four gloo ranks (a 2x2 mesh), in a subprocess: the loss and its gradient
  within 1e-6 of plain tensors in each of ``launch.parity.CE_CASES``
  (sequence-sharded, vocabulary-sharded, an uneven vocabulary of 97,
  labels on a shard's first and last columns, the vision stub's offset);
  the loss on two layouts within 1e-6 of ``repro.train.losses.
  cross_entropy`` on the same numpy logits; ``dist.local.rows_matmul``
  and its gradients within 1e-6 of plain tensors for a weight sharded on
  either dim or replicated; smollm-360m's and llava-next's smoke train
  steps within 1e-5 of one device on every leaf and every gradient.
"""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.parity import CE_CASES
from test_torch_dist import _run_ranks

B, S = 4, 64
TRACE_ARCHS = ("smollm-360m", "llava-next-mistral-7b", "whisper-large-v3", "deepseek-v2-lite-16b")


@pytest.fixture(scope="module")
def traced():
    """arch -> (record, [(op, shape)] of the vocabulary-wide tensors made,
    {name: (gradient, parameter)} of ``_grads``)."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for arch in TRACE_ARCHS:
            V = get_config(arch, smoke=True).vocab
            made, grads = [], {}
            count = roofline._CountMode.__torch_dispatch__

            def probe(self, func, types, args=(), kwargs=None, count=count, V=V, made=made):
                n = self.c.n_ops
                res = count(self, func, types, args, kwargs)
                if self.c.n_ops > n and roofline._alias(func) == "":
                    made.extend((func._overloadpacket.__name__, tuple(t.shape))
                                for t in roofline._tensors(res) if t.ndim and t.shape[-1] == V)
                return res

            def capture(loss, named, grads_fn=steps._grads, grads=grads):
                res = grads_fn(loss, named)
                grads.update({k: (g, named[k]) for k, g in res.items()})
                return res

            mp.setattr(roofline._CountMode, "__torch_dispatch__", probe)
            mp.setattr(steps, "_grads", capture)
            rec = dryrun.run_cell(arch, ShapeConfig("t", S, B, "train"), False,
                                  mesh_shape=(2, 4), smoke=True, verbose=False)
            mp.undo()
            out[arch] = (rec, made, grads)
    finally:
        mp.undo()
    return out


def _logit_rows(arch) -> int:
    cfg = get_config(arch, smoke=True)
    return (B // 2) * ((cfg.max_dec_len if cfg.encoder_decoder else S) // 4)


@pytest.mark.parametrize("arch", TRACE_ARCHS)
def test_no_vocabulary_wide_tensor_beyond_the_logits_block(traced, arch):
    rec, made, _ = traced[arch]
    assert rec["status"] == "ok", rec
    assert made, "the probe saw no vocabulary-wide tensor"
    rows = _logit_rows(arch)
    wide = [(op, shape) for op, shape in made if int(np.prod(shape[:-1])) > rows]
    assert not wide, (rows, wide[:8])


@pytest.mark.parametrize("arch", TRACE_ARCHS)
def test_every_gradient_has_its_parameters_layout(traced, arch):
    _, _, grads = traced[arch]
    assert grads
    bad = {k: (tuple(g.placements), tuple(p.placements), tuple(g.to_local().shape),
               tuple(p.to_local().shape))
           for k, (g, p) in grads.items()
           if tuple(g.placements) != tuple(p.placements) or g.to_local().shape != p.to_local().shape}
    assert not bad, bad


# ---------------------------------------------------------------------------
# One process: DTensor dispatch and the ops off a mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh24():
    from repro_torch.launch.mesh import fake_world

    with fake_world(8):
        yield dryrun.make_mesh((2, 4), ("data", "model"))


@pytest.mark.parametrize("dims", [(0, 1), (0, 2)], ids=["seq_sharded", "vocab_sharded"])
def test_sharded_cross_entropy_dispatches_nothing_through_dtensor(mesh24, dims):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.dist.sharding import local_block
    from repro_torch.train.losses import cross_entropy

    shape = (4, 8, 96)
    place = [Shard(d) for d in dims]
    local = torch.randn(local_block(shape, mesh24, place)[0])
    x = DTensor.from_local(local, mesh24, place, run_check=False, shape=torch.Size(shape),
                           stride=(shape[1] * shape[2], shape[2], 1)).requires_grad_()
    labels = DTensor.from_local(torch.randint(0, 96, (2, 8)), mesh24, [Shard(0), Replicate()],
                                run_check=False, shape=torch.Size((4, 8)), stride=(8, 1))
    g = DTensor.from_local(torch.ones(()), mesh24, [Replicate(), Replicate()], run_check=False)
    seen = []

    class Seen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                seen.append(func)
                return NotImplemented
            return func(*args, **(kwargs or {}))

    with Seen():
        loss = cross_entropy(x, labels)
        (gx,) = torch.autograd.grad(loss, x, g)
    assert not seen, seen
    assert tuple(gx.placements) == tuple(place) and gx.to_local().shape == local.shape


def _parent_ce(logits, labels):
    """The loss as the port wrote it before it computed on each rank's block."""
    logits = logits.to(torch.float32)
    m = logits.amax(-1, keepdim=True)
    logz = torch.log(torch.sum(torch.exp(logits - m), -1)) + logits.amax(-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return torch.mean(logz - gold)


@pytest.mark.parametrize("start", [0, 3])
def test_plain_cross_entropy_is_the_parents(start):
    from repro_torch.train.losses import cross_entropy

    g = torch.Generator().manual_seed(3)
    logits = 3 * torch.randn(2, 9, 50, generator=g)
    labels = torch.randint(0, 50, (2, 9 - start), generator=g)
    x0 = logits.clone().requires_grad_()
    x1 = logits.clone().requires_grad_()
    l0 = _parent_ce(x0[:, start:], labels)
    l1 = cross_entropy(x1, labels, start=start)
    assert torch.equal(l0, l1)
    assert torch.equal(torch.autograd.grad(l0, x0)[0], torch.autograd.grad(l1, x1)[0])


def test_rows_matmul_off_a_mesh_and_on_a_one_rank_mesh_is_matmul():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.local import matmul, rows_matmul
    from repro_torch.launch.mesh import fake_world

    g = torch.Generator().manual_seed(4)
    a, w = torch.randn(2, 6, 16, generator=g), torch.randn(40, 16, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(rows_matmul(a.to(dtype), w, dtype), matmul(a.to(dtype), w.to(dtype).t()))
    with fake_world(1):
        mesh = dryrun.make_mesh((1, 1), ("data", "model"))
        da = distribute_tensor(a, mesh, [Shard(0), Shard(1)])
        dw = distribute_tensor(w, mesh, [Replicate(), Shard(0)])
        got = rows_matmul(da, dw, torch.float32)
        assert torch.equal(got.to_local(), torch.matmul(a, w.t()))


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four-rank run's records, with the reference's losses on the same
    numpy logits."""
    tmp = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(7)
    logits = (3 * rng.standard_normal((4, 8, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (4, 8)).astype(np.int32)
    np.savez(tmp / "ce.npz", logits=logits, labels=labels)
    out = _run_ranks(f"""
        def main(rank, mesh):
            import json
            import numpy as np
            from torch.distributed.tensor import Replicate, Shard, distribute_tensor
            from repro_torch.dist.local import rows_matmul
            from repro_torch.launch.parity import _rel, cross_entropy_parity, train_parity
            from repro_torch.train.losses import cross_entropy

            recs = [cross_entropy_parity(mesh)]
            data = np.load({str(tmp / "ce.npz")!r})
            logits, labels = torch.from_numpy(data["logits"]), torch.from_numpy(data["labels"])
            for name, dims, start in (("seq", (0, 1), 0), ("vocab", (0, 2), 0),
                                      ("vision", (0, 1), 3)):
                x = distribute_tensor(logits, mesh, [Shard(d) for d in dims])
                lab = distribute_tensor(labels[:, start:].contiguous(), mesh,
                                        [Shard(0), Replicate()])
                loss = cross_entropy(x, lab, start=start).full_tensor()
                recs.append({{"check": "reference", "case": name, "start": start,
                              "loss": float(loss)}})
            g = torch.Generator().manual_seed(5)
            a, w = torch.randn(4, 8, 16, generator=g), torch.randn(40, 16, generator=g)
            ct = torch.randn(4, 8, 40, generator=g)
            a0, w0 = a.clone().requires_grad_(), w.clone().requires_grad_()
            y0 = torch.matmul(a0, w0.t())
            ga0, gw0 = torch.autograd.grad(y0, (a0, w0), ct)
            for wp in ([Replicate(), Shard(0)], [Replicate(), Shard(1)],
                       [Replicate(), Replicate()], [Shard(0), Shard(1)]):
                a1 = distribute_tensor(a, mesh, [Shard(0), Shard(1)]).requires_grad_()
                w1 = distribute_tensor(w, mesh, wp).requires_grad_()
                y1 = rows_matmul(a1, w1, torch.float32)
                ga1, gw1 = torch.autograd.grad(y1, (a1, w1),
                                               distribute_tensor(ct, mesh, y1.placements))
                recs.append({{"check": "rows_matmul", "w": str(wp),
                              "out_placed": tuple(y1.placements) == tuple(a1.placements),
                              "grad_placed": tuple(gw1.placements) == tuple(w1.placements),
                              "out_rel": _rel(y1.full_tensor(), y0),
                              "grad_a_rel": _rel(ga1.full_tensor(), ga0),
                              "grad_w_rel": _rel(gw1.full_tensor(), gw0)}})
            recs += [train_parity(mesh, a) for a in ("smollm-360m", "llava-next-mistral-7b")]
            if rank == 0:
                for rec in recs:    # one write a line: the ranks share the pipe
                    sys.stdout.write("REC " + json.dumps(rec) + "\\n")
                    sys.stdout.flush()
            print("DONE", rank, flush=True)

        if __name__ == "__main__":
            run(main)
    """, tmp, timeout=400)
    assert out.count("DONE") == 4
    recs = [json.loads(m) for m in re.findall(r"REC (\{[^{}]*\})", out)]
    return recs, logits, labels


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_on_four_ranks_matches_plain(ranks, case):
    (rec,) = [r for r in ranks[0] if r["check"] == "cross_entropy"]
    assert rec[f"loss_rel:{case}"] <= 1e-6 and rec[f"grad_rel:{case}"] <= 1e-6, rec
    assert rec["ok"]


def test_sharded_cross_entropy_matches_reference(ranks):
    from repro.train.losses import cross_entropy as jce

    recs, logits, labels = ranks
    got = [r for r in recs if r["check"] == "reference"]
    assert len(got) == 3
    for r in got:
        s = r["start"]
        want = float(jce(jnp.asarray(logits[:, s:]), jnp.asarray(labels[:, s:])))
        assert abs(r["loss"] - want) <= 1e-6 * abs(want), (r, want)


def test_rows_matmul_on_four_ranks_matches_plain(ranks):
    got = [r for r in ranks[0] if r["check"] == "rows_matmul"]
    assert len(got) == 4
    for r in got:
        assert r["out_placed"] and r["grad_placed"], r
        assert max(r["out_rel"], r["grad_a_rel"], r["grad_w_rel"]) <= 1e-6, r


@pytest.mark.parametrize("arch", ["smollm-360m", "llava-next-mistral-7b"])
def test_train_step_on_four_ranks_matches_one_device(ranks, arch):
    (r,) = [r for r in ranks[0] if r.get("arch") == arch]
    assert r["grads_placed"], r
    assert max(r["loss_rel"], r["param_rel_max"], r["grad_rel_max"]) <= 1e-5, r
