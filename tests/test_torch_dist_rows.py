"""The LM train step's embedding gather, projections and plain attention
hold on a rank its own block, as the reference's GSPMD does, on the CPU.

* Fake meshes, traced with a probe around ``roofline._CountMode``'s
  dispatch (forward and backward):
  - on (2, 2, 2) ("pod", "data", "model") and (2, 4), ``embed_rows`` makes
    no tensor of more than the rank's (B / dp, S) x d rows (the parent made
    the pod's rows on (2, 2, 2) and the whole table's gradient on (2, 4)),
    and its rows come out as ``constrain_bsd`` places them;
  - ``dense`` at granite-34b's d : d_ff ratio (its ``wg``) makes no GEMM
    output (other than the weight's gradient) with more rows than the
    rank's (B / dp) x (S / tp), and on an activation whose features (the
    heads) "model" splits, none above the rank's share of the product;
  - ``plain_attention`` with heads that do not split over the 4 ranks of
    "model" (the queries' positions split, Whisper's layout), 18 of them
    in self-attention and 20 in cross-attention, makes no score block
    beyond the rank's query rows x Sk;
  - whisper's and granite-34b's smoke train cells peak lower than at the
    parent commit, with no view torch 2.11 refuses (``FlattenGuard``).
* Off a mesh, on a 1x1 mesh and on plain tensors, the three functions'
  outputs and gradients are a copy of the parent's code's bit for bit.
* Four gloo ranks, in one subprocess, on a (2, 2, 1) and a (1, 2, 2)
  ("pod", "data", "model") mesh (``launch.parity.rows_parity``): the rows
  bit-equal to ``table[ids]`` and the table's gradient within 1e-6 of one
  device in the table's placements; ``dense`` within 1e-6 of plain tensors,
  forward and every gradient; ``plain_attention`` within 1e-6 of plain
  tensors and within 1e-5 of ``repro.models.lm.common.plain_attention`` on
  the same numpy inputs with K/V repeated to H heads; whisper's and
  smollm-360m's smoke train steps within 1e-5 of one device on every leaf
  and first-step gradient.
"""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.parity import (
    DENSE_CASES,
    LOOKUP_CASES,
    PLAIN_CASES,
    ROWS_ARCHS,
    ROWS_MESHES,
    plain_inputs,
)
from repro_torch.models.lm import common
from test_torch_dist import _run_ranks

MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")), "2x4": ((2, 4), ("data", "model"))}
#: each smoke train cell's peak a device (bytes) on the fake (2, 4) mesh at
#: the parent commit (``launch.dryrun.run_cell``, 64 tokens, batch 4, amp_bf16)
PARENT_PEAK = {"whisper-large-v3": 828044, "granite-34b": 999180}


def _placed(mesh, shape, place, seed=0, high=None):
    """A DTensor of ``shape`` at ``place``, its local block drawn from seed
    (integers below ``high`` where given)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.local import _contiguous
    from repro_torch.dist.sharding import local_block

    lb = local_block(shape, mesh, place)[0]
    g = torch.Generator().manual_seed(seed)
    local = torch.randint(0, high, lb, generator=g) if high else torch.randn(lb, generator=g)
    return DTensor.from_local(local, mesh, place, run_check=False, shape=torch.Size(shape),
                              stride=_contiguous(shape))


def _made(mesh, fn, *args):
    """[(op, shape)] of every tensor an op a rank runs in ``fn(*args)`` and
    the gradient of its output with respect to the float arguments makes;
    and the output's placements."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import use_mesh

    made, placements = [], []
    count = roofline._CountMode.__torch_dispatch__

    def probe(self, func, types, args=(), kwargs=None):
        n = self.c.n_ops
        res = count(self, func, types, args, kwargs)
        if self.c.n_ops > n and roofline._alias(func) == "":
            made.extend((func._overloadpacket.__name__, tuple(t.shape))
                        for t in roofline._tensors(res))
        return res

    def step(*a):
        out = fn(*a)
        placements.append(tuple(out.placements))
        ct = DTensor.from_local(torch.ones(out.to_local().shape), mesh, out.placements,
                                run_check=False, shape=out.shape, stride=out.stride())
        return torch.autograd.grad(out, [t for t in a if t.is_floating_point()], ct)

    mp = pytest.MonkeyPatch()
    mp.setattr(roofline._CountMode, "__torch_dispatch__", probe)
    try:
        with use_mesh(mesh), implicit_replication():
            roofline.count_step(step, *args)
    finally:
        mp.undo()
    return made, placements[0]


def _fake_mesh(name):
    from repro_torch.launch.mesh import fake_world

    shape, names = MESHES[name]
    return fake_world(int(np.prod(shape))), shape, names


# ---------------------------------------------------------------------------
# Fake meshes: what a rank makes
# ---------------------------------------------------------------------------

#: (B, S, d); V per mesh: above the rank's B / dp x S ids (the whole table's
#: gradient would be more than the rank's rows) and its block under them
EMBED, EMBED_V = (8, 16, 32), {"2x2x2": 48, "2x4": 160}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_embed_rows_makes_no_more_than_the_ranks_rows(mesh_name):
    from torch.distributed.tensor import Replicate, Shard

    B, S, d = EMBED
    V = EMBED_V[mesh_name]
    world, shape, names = _fake_mesh(mesh_name)
    with world:
        mesh = dryrun.make_mesh(shape, names)
        dp = int(np.prod(shape[:-1]))
        tab = _placed(mesh, (V, d), [Replicate()] * (len(shape) - 1) + [Shard(0)], 1)
        ids = _placed(mesh, (B, S), [Shard(0)] * (len(shape) - 1) + [Replicate()], 2, high=V)
        made, place = _made(mesh, lambda t, i: common.embed_rows(t, i, split_seq=True),
                            tab.requires_grad_(), ids)
    limit = (B // dp) * S * d
    big = [m for m in made if int(np.prod(m[1])) > limit]
    assert made and not big, (limit, big[:6])
    assert place == (Shard(0),) * (len(shape) - 1) + (Shard(1),)


#: (B, S, d, d_ff): granite-34b's d : d_ff = 1 : 4 in its ``wg`` (d, d_ff), the
#: rank's rows fewer than d_ff (the parent's product gathered the rows)
DENSE = (4, 64, 64, 256)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dense_runs_no_gemm_on_more_than_the_ranks_rows(mesh_name):
    from torch.distributed.tensor import Replicate, Shard

    B, S, K, N = DENSE
    world, shape, names = _fake_mesh(mesh_name)
    with world:
        mesh = dryrun.make_mesh(shape, names)
        lead = [Replicate()] * (len(shape) - 1)
        x = _placed(mesh, (B, S, K), [Shard(0)] * (len(shape) - 1) + [Shard(1)], 1)
        w = _placed(mesh, (K, N), lead + [Shard(0 if K > N else 1)], 2)
        made, place = _made(mesh, lambda a, b: common.dense(a, b, torch.bfloat16),
                            x.requires_grad_(), w.requires_grad_())
    rows = (B // int(np.prod(shape[:-1]))) * (S // shape[-1])
    gemms = [m for m in made if m[0] in ("mm", "bmm", "addmm")
             and sorted(m[1][-2:]) != sorted((K, N))]         # not a weight's gradient
    big = [m for m in gemms if int(np.prod(m[1][:-1])) > rows]
    assert gemms and not big, (rows, big[:6])
    assert place == tuple(x.placements)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dense_on_split_features_makes_no_product_above_the_ranks_share(mesh_name):
    """The attention output's projection, its features (the heads) split
    over "model": the parent's product was every row of the batch block by
    every column, a partial sum."""
    from torch.distributed.tensor import Replicate, Shard

    B, S, K = 4, 64, 64
    world, shape, names = _fake_mesh(mesh_name)
    with world:
        mesh = dryrun.make_mesh(shape, names)
        lead = [Replicate()] * (len(shape) - 1)
        x = _placed(mesh, (B, S, K), [Shard(0)] * (len(shape) - 1) + [Shard(2)], 1)
        w = _placed(mesh, (K, K), lead + [Shard(1)], 2)
        made, place = _made(mesh, lambda a, b: common.dense(a, b, torch.bfloat16),
                            x.requires_grad_(), w.requires_grad_())
    share = (B // int(np.prod(shape[:-1]))) * (S // shape[-1]) * K
    gemms = [m for m in made if m[0] in ("mm", "bmm", "addmm", "addmm_")]
    big = [m for m in gemms if int(np.prod(m[1])) > share]
    assert gemms and not big, (share, big[:6])
    assert place == (Shard(0),) * (len(shape) - 1) + (Shard(1),)


#: heads that do not split over the 4 ranks of "model" (Whisper's 20 over 16):
#: (B, H, Sq, Sk, D); the 20 of the cross-attention gathered the queries at
#: the parent, 18 the heads
PLAIN = {"self": (4, 18, 16, 16, 8), "cross": (4, 20, 16, 32, 8)}


@pytest.mark.parametrize("kind", list(PLAIN))
def test_plain_attention_scores_only_the_ranks_queries(kind):
    from torch.distributed.tensor import Shard

    B, H, Sq, Sk, D = PLAIN[kind]
    world, shape, names = _fake_mesh("2x4")
    with world:
        mesh = dryrun.make_mesh(shape, names)
        q = _placed(mesh, (B, H, Sq, D), [Shard(0), Shard(2)], 1)
        k = _placed(mesh, (B, H, Sk, D), [Shard(0), Shard(2)], 2)
        v = _placed(mesh, (B, H, Sk, D), [Shard(0), Shard(2)], 3)
        qp = torch.arange(Sq) + (Sk if kind == "cross" else 0)
        made, place = _made(mesh, lambda a, b, c: common.plain_attention(
            a, b, c, qp, torch.arange(Sk), 2 ** 30), *(t.requires_grad_() for t in (q, k, v)))
    limit = (B // 2) * H * (Sq // 4) * Sk
    scores = [m for m in made if len(m[1]) >= 2 and m[1][-1] == Sk and m[1][-2] != D]
    big = [m for m in scores if int(np.prod(m[1])) > limit]
    assert scores and not big, (limit, big[:6])
    assert place == (Shard(0), Shard(2))


@pytest.mark.parametrize("arch", list(PARENT_PEAK))
def test_smoke_train_cell_peaks_lower_than_the_parent(arch):
    from repro_torch.launch.guard import guarded_cell

    rec, guard = guarded_cell(arch, ShapeConfig("train_smoke", 64, 4, "train"), (2, 4))
    assert rec["status"] == "ok", rec
    assert not guard.hits, guard.hits[:5]
    assert rec["memory_analysis"]["peak_bytes"] < PARENT_PEAK[arch], rec["memory_analysis"]


# ---------------------------------------------------------------------------
# Off a mesh, a 1x1 mesh, plain tensors: the parent's code bit for bit
# ---------------------------------------------------------------------------


def _parent_embed_rows(table, tokens):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.constrain import pin
    from repro_torch.dist.local import take_rows

    if isinstance(tokens, DTensor):
        seen, pl = set(), []
        for p in tokens.placements:
            hybrid = isinstance(p, Shard) and p.dim in seen
            pl.append(Replicate() if hybrid else p)
            if isinstance(p, Shard):
                seen.add(p.dim)
        if pl != list(tokens.placements):
            tokens = tokens.redistribute(tokens.device_mesh, pl)
    return pin(take_rows(table, tokens))


def _parent_dense(x, w, dtype):
    from repro_torch.dist.local import matmul

    return matmul(x.to(dtype).float(), w.to(dtype).float()).to(dtype)


def _parent_plain_attention(q, k, v, q_pos, k_pos, window):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = common._scores(q, k) * scale
    s = common._mask_scores(s, q_pos, k_pos, window)
    p = torch.softmax(s, dim=-1)
    return common._mix(p, v).to(q.dtype)


def _tensors(seed, dtype):
    g = torch.Generator().manual_seed(seed)
    pos = torch.arange(12)
    return {"table": torch.randn(40, 16, generator=g),
            "ids": torch.randint(0, 40, (2, 12), generator=g),
            "x": torch.randn(2, 12, 16, generator=g).to(dtype),
            "w": torch.randn(16, 24, generator=g),
            "q": torch.randn(2, 4, 12, 8, generator=g).to(dtype),
            "k": torch.randn(2, 2, 12, 8, generator=g).to(dtype),
            "v": torch.randn(2, 2, 12, 8, generator=g).to(dtype),
            "pos": pos}


def _calls(t, dtype):
    """(name, parent fn, port fn, args, float args) of the three functions."""
    return [("embed_rows", _parent_embed_rows, common.embed_rows, (t["table"], t["ids"]),
             (0,)),
            ("dense", _parent_dense, common.dense, (t["x"], t["w"], dtype), (0, 1)),
            ("plain_attention", _parent_plain_attention, common.plain_attention,
             (t["q"], t["k"], t["v"], t["pos"], t["pos"], 5), (0, 1, 2))]


def _run(fn, args, floats, unwrap):
    args = [a.detach().clone().requires_grad_() if i in floats else a
            for i, a in enumerate(args)]
    out = fn(*args)
    ct = torch.ones_like(out)
    grads = torch.autograd.grad(out, [args[i] for i in floats], ct)
    return unwrap(out.detach()), [unwrap(g) for g in grads]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_off_a_mesh_the_parents_code_bit_for_bit(dtype):
    t = _tensors(5, dtype)
    for name, parent, port, args, floats in _calls(t, dtype):
        (o0, g0), (o1, g1) = (_run(f, args, floats, lambda x: x) for f in (parent, port))
        assert torch.equal(o0, o1), name
        assert all(torch.equal(a, b) for a, b in zip(g0, g1, strict=True)), name


def test_on_a_one_rank_mesh_the_parents_code_bit_for_bit():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import use_mesh
    from repro_torch.launch.mesh import fake_world

    t = _tensors(6, torch.float32)
    place = {"table": [Replicate(), Shard(0)], "ids": [Shard(0), Replicate()],
             "x": [Shard(0), Shard(1)], "w": [Replicate(), Shard(1)],
             "q": [Shard(0), Shard(1)], "k": [Shard(0), Shard(1)], "v": [Shard(0), Shard(1)],
             "pos": None}
    with fake_world(1):
        mesh = dryrun.make_mesh((1, 1), ("data", "model"))
        d = {k: v if place[k] is None else distribute_tensor(v, mesh, place[k])
             for k, v in t.items()}
        with use_mesh(mesh), implicit_replication():
            for name, parent, port, args, floats in _calls(d, torch.float32):
                (o0, g0), (o1, g1) = (_run(f, args, floats, lambda x: x.to_local())
                                      for f in (parent, port))
                assert torch.equal(o0, o1), name
                assert all(torch.equal(a, b) for a, b in zip(g0, g1, strict=True)), name


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four-rank run's records and the directory of its outputs."""
    tmp = tmp_path_factory.mktemp("rows")
    out = _run_ranks(f"""
        def main(rank, mesh):
            import json
            from repro_torch.launch.parity import rows_parity

            recs = rows_parity({str(tmp)!r})
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


MESH_IDS = ["x".join(map(str, m)) for m in ROWS_MESHES]


def _rec(ranks, check, mesh, **kw):
    (rec,) = [r for r in ranks[0] if r["check"] == check and r["mesh"] == mesh
              and all(r.get(k) == v for k, v in kw.items())]
    return rec


@pytest.mark.parametrize("case", list(LOOKUP_CASES))
@pytest.mark.parametrize("mesh", MESH_IDS)
def test_lookup_on_four_ranks_is_the_gather(ranks, mesh, case):
    rec = _rec(ranks, "lookup", mesh)
    assert rec[f"rows_equal:{case}"] and rec[f"grad_rel:{case}"] <= 1e-6, rec
    assert rec["grads_placed"]


@pytest.mark.parametrize("case", list(DENSE_CASES))
@pytest.mark.parametrize("mesh", MESH_IDS)
def test_dense_on_four_ranks_matches_plain(ranks, mesh, case):
    rec = _rec(ranks, "dense", mesh)
    assert rec[f"out_rel:{case}"] <= 1e-6 and rec[f"grad_rel:{case}"] <= 1e-6, rec
    assert rec["grads_placed"]


@pytest.mark.parametrize("case", list(PLAIN_CASES))
@pytest.mark.parametrize("mesh", MESH_IDS)
def test_plain_attention_on_four_ranks_matches_plain(ranks, mesh, case):
    rec = _rec(ranks, "plain_attention", mesh)
    assert rec[f"out_rel:{case}"] <= 1e-6 and rec[f"grad_rel:{case}"] <= 1e-6, rec


@pytest.mark.parametrize("case", list(PLAIN_CASES))
@pytest.mark.parametrize("mesh", MESH_IDS)
def test_plain_attention_on_four_ranks_matches_reference(ranks, mesh, case):
    from repro.models.lm.common import plain_attention as jplain

    c = PLAIN_CASES[case]
    x = plain_inputs(c)
    g = c.H // c.Hk
    want = np.asarray(jplain(jnp.asarray(x["q"]), jnp.repeat(jnp.asarray(x["k"]), g, axis=1),
                             jnp.repeat(jnp.asarray(x["v"]), g, axis=1),
                             jnp.asarray(x["q_pos"]), jnp.asarray(x["k_pos"]), c.window))
    got = np.load(ranks[1] / f"plain_{mesh}_{case}.npy")
    err = np.linalg.norm((got - want).astype(np.float64)) / np.linalg.norm(want)
    assert err <= 1e-5, err


@pytest.mark.parametrize("arch", list(ROWS_ARCHS))
@pytest.mark.parametrize("mesh", MESH_IDS)
def test_train_step_on_four_ranks_matches_one_device(ranks, mesh, arch):
    r = _rec(ranks, "train_step", mesh, arch=arch)
    assert r["grads_placed"], r
    assert max(r["loss_rel"], r["param_rel_max"], r["grad_rel_max"]) <= 1e-5, r
