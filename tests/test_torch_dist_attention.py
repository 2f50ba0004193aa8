"""``blocked_attention`` on a mesh holds a rank's block of the queries, the
carry and the scores, as the reference's GSPMD-sharded scan does, on the
CPU.

* On a fake (2, 4) mesh, ``blocked_attention`` at S = 1024, D = Dv = 64,
  128-key blocks, (H, Hk) = (4, 1), (6, 2) and (4, 4), forward and
  backward, traced with a probe around ``roofline._CountMode``'s dispatch:
  no op a rank runs makes a tensor of the carry's global shape, nor one
  larger than the rank's query rows times max(k_chunk, Dv) (the rows are
  (B/2)·(H/4)·S where the heads split over the 4 ranks of "model", else
  (B/2)·H·(S/4)).
* On that mesh, granite-34b's smoke train cell at S = 1024 keeps no second
  copy of its state: while AdamW runs (after the gradients are made), the
  bytes the count holds live stay within the gradients plus four times the
  largest leaf in f32.
* Off a mesh, on a 1x1 mesh and on plain tensors, the output and the q/k/v
  gradients are the parent's loop's bit for bit (f32 and bf16, GQA, a
  window, a padded S).
* Four gloo ranks (a 2x2 mesh), in a subprocess: each of
  ``launch.parity.ATTENTION_CASES`` within 1e-6 relative L2 of plain
  tensors, output and gradients, its output within 1e-5 of
  ``repro.models.lm.common.blocked_attention`` on the same numpy inputs
  with K/V repeated to H heads (the reference's ``gqa_attention``);
  granite-34b's and smollm-360m's smoke train steps at S = 1024 (the
  blocked path) within 1e-5 of one device on every leaf and first-step
  gradient; query chunks that do not split evenly over the ranks (3 over
  2) within 1e-6 of plain tensors.
"""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.parity import ATTENTION_CASES, attention_inputs
from repro_torch.models.lm import common
from test_torch_dist import _run_ranks

B, S, D, K_CHUNK = 4, 1024, 64, 128
TP = 4
FULL = 2 ** 30


def _placed(mesh, shape, heads_dim_ok, seed):
    """A DTensor of ``shape`` in ``constrain_bhsd``'s layout: batch over
    "data", heads over "model" where they divide, else the sequence."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist.local import _contiguous
    from repro_torch.dist.sharding import local_block

    place = [Shard(0), Shard(1) if heads_dim_ok else Shard(2)]
    local = torch.randn(local_block(shape, mesh, place)[0],
                        generator=torch.Generator().manual_seed(seed))
    return DTensor.from_local(local, mesh, place, run_check=False, shape=torch.Size(shape),
                              stride=_contiguous(shape)).requires_grad_()


def _made(mesh, H, Hk):
    """[(op, shape)] of every tensor an op of blocked_attention's forward
    and backward makes on rank 0."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import use_mesh

    q = _placed(mesh, (B, H, S, D), H % TP == 0, 1)
    k = _placed(mesh, (B, Hk, S, D), Hk % TP == 0, 2)
    v = _placed(mesh, (B, Hk, S, D), Hk % TP == 0, 3)
    pos = torch.arange(S)
    made = []
    count = roofline._CountMode.__torch_dispatch__

    def probe(self, func, types, args=(), kwargs=None):
        n = self.c.n_ops
        res = count(self, func, types, args, kwargs)
        if self.c.n_ops > n and roofline._alias(func) == "":
            made.extend((func._overloadpacket.__name__, tuple(t.shape))
                        for t in roofline._tensors(res))
        return res

    def step(q, k, v):
        out = common.blocked_attention(q, k, v, pos, pos, FULL, k_chunk=K_CHUNK)
        ct = DTensor.from_local(torch.ones(out.to_local().shape), mesh, out.placements,
                                run_check=False, shape=out.shape, stride=out.stride())
        return torch.autograd.grad(out, (q, k, v), ct)

    mp = pytest.MonkeyPatch()
    mp.setattr(roofline._CountMode, "__torch_dispatch__", probe)
    try:
        with use_mesh(mesh), implicit_replication():
            roofline.count_step(step, q, k, v)
    finally:
        mp.undo()
    return made


HEADS = [(4, 1), (6, 2), (4, 4)]
HEAD_IDS = [f"{h}q{k}kv" for h, k in HEADS]


@pytest.fixture(scope="module")
def made():
    """(H, Hk) -> what :func:`_made` saw on a fake (2, 4) mesh."""
    from repro_torch.launch.mesh import fake_world

    with fake_world(8):
        mesh = dryrun.make_mesh((2, 4), ("data", "model"))
        return {hk: _made(mesh, *hk) for hk in HEADS}


@pytest.mark.parametrize("H,Hk", HEADS, ids=HEAD_IDS)
def test_no_op_makes_a_tensor_of_the_carrys_global_shape(made, H, Hk):
    assert made[(H, Hk)]
    q_chunk = S // TP
    nq = S // q_chunk
    carry = {(B, H, nq, q_chunk, D), (B, H, nq, q_chunk)}        # acc; m and l
    assert not [m for m in made[(H, Hk)] if m[1] in carry]


@pytest.mark.parametrize("H,Hk", HEADS, ids=HEAD_IDS)
def test_no_op_makes_more_than_the_ranks_rows(made, H, Hk):
    rows = (B // 2) * (H // TP) * S if H % TP == 0 else (B // 2) * H * (S // TP)
    limit = rows * max(K_CHUNK, D)
    big = [m for m in made[(H, Hk)] if int(np.prod(m[1])) > limit]
    assert not big, (limit, big[:8])


def test_granite_train_step_holds_its_state_once():
    """While AdamW runs, the count's live bytes (the step's own tensors; the
    arguments are apart) stay within the gradients plus four times the
    largest leaf in f32."""
    live = {"grads": 0, "peak": 0, "on": False, "leaf": 0}
    count = roofline._CountMode.__torch_dispatch__

    def probe(self, func, types, args=(), kwargs=None):
        res = count(self, func, types, args, kwargs)
        if live["on"]:
            live["peak"] = max(live["peak"], self.live)
        return res

    def grads(loss, named, grads_fn=steps._placed_grads):
        res = grads_fn(loss, named)
        live["grads"] = sum(roofline._nbytes(g.to_local()) for g in res.values())
        live["leaf"] = max(4 * p.to_local().numel() for p in named.values())
        live["on"] = True
        return res

    mp = pytest.MonkeyPatch()
    mp.setattr(roofline._CountMode, "__torch_dispatch__", probe)
    mp.setattr(steps, "_placed_grads", grads)
    try:
        rec = dryrun.run_cell("granite-34b", ShapeConfig("t", S, B, "train"), False,
                              mesh_shape=(2, 4), smoke=True, verbose=False)
    finally:
        mp.undo()
    assert rec["status"] == "ok", rec
    assert live["on"] and live["grads"] > 0
    limit = live["grads"] + 4 * live["leaf"]
    assert live["peak"] <= limit, (live, limit)


# ---------------------------------------------------------------------------
# Off a mesh, a 1x1 mesh, plain tensors: the parent's loop bit for bit
# ---------------------------------------------------------------------------


def _parent_blocked_attention(q, k, v, q_pos, k_pos, window, q_chunk=0, k_chunk=512):
    """``blocked_attention`` as the port wrote it before each rank ran the
    loop on its own block."""
    from repro_torch.dist.constrain import constrain, logical_axis_size

    B, H, S, D = q.shape
    Dv = v.shape[-1]
    Sk = k.shape[2]
    msize = logical_axis_size("heads")
    if q_chunk <= 0:
        q_chunk = max(64, min(512, S // max(msize, 1)))
    pad_q = (-S) % q_chunk
    pad_k = (-Sk) % k_chunk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad_q))
        q_pos = torch.cat([q_pos, q_pos.new_full((pad_q,), -1)])
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad_k))
        k_pos = torch.cat([k_pos, k_pos.new_full((pad_k,), 2 ** 30)])
    nq, nk = q.shape[2] // q_chunk, k.shape[2] // k_chunk
    scale = 1.0 / (D ** 0.5)
    qb = q.reshape(B, H, nq, q_chunk, D)
    if H % max(msize, 1) == 0:
        qb = constrain(qb, "dp", "heads", None, None, None)
    else:
        qb = constrain(qb, "dp", None, "seq", None, None)
    qb = qb.reshape(B, H, nq * q_chunk, D)
    qpb = q_pos.reshape(nq, q_chunk)

    def kv_step(acc, m, l, ki, vi, kp):  # noqa: E741
        s = common._scores(qb, ki).reshape(B, H, nq, q_chunk, k_chunk) * scale
        causal = qpb[:, :, None] >= kp[None, None, :]
        inwin = (qpb[:, :, None] - kp[None, None, :]) < window
        s = torch.where((causal & inwin)[None, None], s, common.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)  # noqa: E741
        pv = common._mix(p.reshape(B, H, nq * q_chunk, k_chunk), vi)
        return acc * alpha[..., None] + pv.reshape(B, H, nq, q_chunk, Dv), m_new, l

    recompute = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    acc = q.new_zeros((B, H, nq, q_chunk, Dv), dtype=torch.float32)
    m = q.new_full((B, H, nq, q_chunk), common.NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, H, nq, q_chunk), dtype=torch.float32)  # noqa: E741
    for i in range(nk):
        blk = (k[:, :, i * k_chunk:(i + 1) * k_chunk], v[:, :, i * k_chunk:(i + 1) * k_chunk],
               k_pos[i * k_chunk:(i + 1) * k_chunk])
        if recompute:
            acc, m, l = common.checkpoint(kv_step, acc, m, l, *blk,  # noqa: E741
                                          use_reentrant=False)
        else:
            acc, m, l = kv_step(acc, m, l, *blk)  # noqa: E741
    out = (acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)
    return out.reshape(B, H, nq * q_chunk, Dv)[:, :, :S, :]


def _both(make, fn_args, unwrap=lambda t: t):
    """(output, q/k/v gradients) of the parent's loop and of the port's on
    the tensors ``make()`` returns."""
    res = []
    for fn in (_parent_blocked_attention, common.blocked_attention):
        q, k, v, ct = make()
        out = fn(q, k, v, *fn_args)
        grads = torch.autograd.grad(out, (q, k, v), ct)
        res.append((unwrap(out.detach()), [unwrap(g) for g in grads]))
    return res


PLAIN = [(torch.float32, FULL, 0), (torch.bfloat16, FULL, 0), (torch.float32, 300, 0),
         (torch.bfloat16, 300, 96)]


@pytest.mark.parametrize("dtype,window,q_chunk", PLAIN,
                         ids=["f32", "bf16", "f32_window", "bf16_window_q96"])
def test_off_a_mesh_the_parents_loop_bit_for_bit(dtype, window, q_chunk):
    Sp = 1000                                     # pads the queries and the keys
    pos = torch.arange(Sp)
    g = torch.Generator().manual_seed(5)
    data = [torch.randn(2, h, Sp, 16, generator=g).to(dtype) for h in (4, 2, 2, 4)]

    def make():
        return [t.clone().requires_grad_() for t in data[:3]] + [data[3]]

    (o0, g0), (o1, g1) = _both(make, (pos, pos, window, q_chunk, 256))
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window", [FULL, 300])
def test_on_a_one_rank_mesh_the_parents_loop_bit_for_bit(window):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import use_mesh
    from repro_torch.dist.constrain import constrain_bhsd
    from repro_torch.launch.mesh import fake_world

    Sp = 1000
    pos = torch.arange(Sp)
    g = torch.Generator().manual_seed(6)
    data = [torch.randn(2, h, Sp, 16, generator=g) for h in (4, 2, 2, 4)]
    with fake_world(1):
        mesh = dryrun.make_mesh((1, 1), ("data", "model"))

        def make():
            ts = [constrain_bhsd(distribute_tensor(t, mesh, [Shard(0), Shard(1)])
                                 .requires_grad_()) for t in data[:3]]
            return ts + [distribute_tensor(data[3], mesh, [Replicate(), Replicate()])]

        with use_mesh(mesh), implicit_replication():
            (o0, g0), (o1, g1) = _both(make, (pos, pos, window, 0, 256),
                                       unwrap=lambda t: t.to_local())
    assert torch.equal(o0, o1)
    for a, b in zip(g0, g1, strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four-rank run's records and the directory of its outputs."""
    tmp = tmp_path_factory.mktemp("attention")
    out = _run_ranks(f"""
        def uneven_chunks(mesh):
            # three query chunks over the two ranks of "model": placed on the
            # 5-D chunk axis, then flattened by DTensor
            from torch.distributed.tensor import Replicate, Shard, distribute_tensor
            from repro_torch.dist import use_mesh
            from repro_torch.launch.parity import _rel
            from repro_torch.models.lm.common import _kv_loop, _local_blocks

            g = torch.Generator().manual_seed(9)
            q, k, v = (torch.randn(2, h, 384, 16, generator=g) for h in (3, 1, 1))
            q = q.reshape(2, 3, 3, 128, 16)
            ct = torch.randn(2, 3, 384, 16, generator=g)
            pos = torch.arange(384)
            plain = [t.clone().requires_grad_() for t in (q, k, v)]
            out0 = _kv_loop(*plain, pos.reshape(3, 128), pos, 300, 128)
            g0 = torch.autograd.grad(out0, plain, ct)
            placed = [distribute_tensor(q, mesh, [Shard(0), Shard(2)]).requires_grad_()]
            placed += [distribute_tensor(t, mesh, [Replicate(), Replicate()]).requires_grad_()
                       for t in (k, v)]
            with use_mesh(mesh):
                out1 = _local_blocks(*placed, pos.reshape(3, 128), pos, 300, 128)
                g1 = torch.autograd.grad(out1, placed, distribute_tensor(ct, mesh, out1.placements))
            return {{"check": "uneven_chunks", "out_rel": _rel(out1.full_tensor(), out0),
                     "grad_rel": max(_rel(a.full_tensor(), b) for a, b in zip(g1, g0))}}

        def main(rank, mesh):
            import json
            from repro_torch.launch.parity import BLOCKED_SEQ, attention_parity, train_parity

            recs = [attention_parity(mesh, {str(tmp)!r})]
            recs.append(uneven_chunks(mesh))
            recs += [train_parity(mesh, a, S=BLOCKED_SEQ) for a in ("granite-34b", "smollm-360m")]
            if rank == 0:
                for rec in recs:    # one write a line: the ranks share the pipe
                    sys.stdout.write("REC " + json.dumps(rec) + "\\n")
                    sys.stdout.flush()
            print("DONE", rank, flush=True)

        if __name__ == "__main__":
            run(main)
    """, tmp, timeout=400)
    assert out.count("DONE") == 4
    return [json.loads(m) for m in re.findall(r"REC (\{.*\})", out)], tmp


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_on_four_ranks_matches_plain(ranks, case):
    (rec,) = [r for r in ranks[0] if r["check"] == "attention"]
    assert rec[f"out_rel:{case}"] <= 1e-6 and rec[f"grad_rel:{case}"] <= 1e-6, rec
    assert rec["ok"]


def test_attention_on_chunks_that_do_not_split_evenly_matches_plain(ranks):
    (rec,) = [r for r in ranks[0] if r["check"] == "uneven_chunks"]
    assert rec["out_rel"] <= 1e-6 and rec["grad_rel"] <= 1e-6, rec


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_on_four_ranks_matches_reference(ranks, case):
    from repro.models.lm.common import blocked_attention as jblocked

    c = ATTENTION_CASES[case]
    x = attention_inputs(c)
    g = c.H // c.Hk
    pos = jnp.arange(c.S)
    want = np.asarray(jblocked(jnp.asarray(x["q"]), jnp.repeat(jnp.asarray(x["k"]), g, axis=1),
                               jnp.repeat(jnp.asarray(x["v"]), g, axis=1), pos, pos, c.window,
                               q_chunk=c.q_chunk))
    got = np.load(ranks[1] / f"attention_{case}.npy")
    err = np.linalg.norm((got - want).astype(np.float64)) / np.linalg.norm(want)
    assert err <= 1e-5, err


@pytest.mark.parametrize("arch", ["granite-34b", "smollm-360m"])
def test_blocked_train_step_on_four_ranks_matches_one_device(ranks, arch):
    (r,) = [r for r in ranks[0] if r.get("arch") == arch]
    assert r["seq"] == 1024 and r["grads_placed"], r
    assert max(r["loss_rel"], r["param_rel_max"], r["grad_rel_max"]) <= 1e-5, r
