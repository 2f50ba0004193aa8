"""The port's distribution layer (``repro_torch.dist``, ``optim.grad_comm``,
``train.losses.cross_entropy``, the elastic ``checkpoint.restore``) against
``repro.dist`` on the CPU.

* Specs: ``pick_spec``'s fallback order, ``lm_param_specs`` for the ten
  configs at full size (the port's model on the meta device, the
  reference's tree by ``jax.eval_shape``; a per-layer leaf against the
  reference's stacked spec without its L entry), ``fno_param_specs`` for
  ``FNO_DARCY``, ``TFNO_NS`` and ``SFNO_SWE``, ``cache_specs``,
  ``batch_specs`` and ``replication_report``, on (2, 4), (2, 2, 4) and
  (16, 16) meshes: the port's from a fake process group of 256 ranks, the
  reference's from its ``_fake_mesh``.
* ``constrain`` is the identity off-mesh, on a 1x1 mesh and on plain
  tensors; the two mesh-dependent semantics (``blocked_attention``'s
  default query chunk and the MoE dispatch groups) against the reference
  run with its query chunk passed and its ``_moe_one_group`` vmapped over
  G = 2 groups.
* ``cross_entropy`` against the reference's.
* Four gloo ranks (a 2x2 mesh), each test its own process group in a
  subprocess: ``LMEngine(mesh=...)`` generates ``mesh=None``'s greedy
  tokens (an MoE arch those of one device dispatching in the mesh's dp
  groups); ``make_dp_allreduce`` returns the mean (bf16 within 2^-8
  relative L2, f32 within 1e-6); a one-rank checkpoint restored onto the
  2x2 mesh.
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.dist as jdist
from repro.configs import get_config as jget_config
from repro.configs.fno_paper import FNO_DARCY as J_FNO_DARCY
from repro.configs.fno_paper import SFNO_SWE as J_SFNO_SWE
from repro.configs.fno_paper import TFNO_NS as J_TFNO_NS
from repro.models.fno import init_fno as jinit_fno
from repro.models.lm import init_cache as jinit_cache
from repro.models.lm import init_lm as jinit_lm
from repro.models.lm import init_whisper as jinit_whisper
from repro.models.sfno import init_sfno as jinit_sfno
from repro_torch import dist as tdist
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.fno_paper import FNO_DARCY, SFNO_SWE, TFNO_NS
from repro_torch.models.fno import FNO
from repro_torch.models.lm import LM, Whisper, init_cache
from repro_torch.models.sfno import SFNO

from test_dist import _fake_mesh

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = [((2, 4), ("data", "model")), ((2, 2, 4), ("pod", "data", "model")),
          ((16, 16), ("data", "model"))]


@pytest.fixture(scope="module")
def world():
    """A fake default process group of 256 ranks for the module."""
    from repro_torch.launch.mesh import fake_world

    with fake_world(256):
        yield


def _port_mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


def _spec(p) -> tuple:
    return tuple(p)


def _jflat(tree):
    """{("a", "b"): leaf} of a reference pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out[tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in path)] = leaf
    return out


def _layer_key(name: str):
    """Port leaf name -> (reference path, per-layer?)."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc", "dec") and parts[1].isdigit():
        return (parts[0],) + tuple(parts[2:]), True
    return tuple(parts), False


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def test_pick_spec_fallback_order(world):
    mesh = _port_mesh((2, 4), ("data", "model"))
    jmesh = _fake_mesh((2, 4), ("data", "model"))
    chain = [(("model",), None), (("data",), None), ()]
    for shape in ((16, 64), (15, 64), (6, 64)):
        assert tdist.pick_spec(shape, mesh, chain) == _spec(jdist.pick_spec(shape, jmesh, chain))
    assert tdist.pick_spec((16, 64), mesh, chain) == ("model", None)
    assert tdist.pick_spec((8, 8), mesh, [("dp", "tp"), ()]) == ("data", "model")
    assert tdist.pick_spec((8,), mesh, [(("pod", "data"),), ()]) == ("data",)
    m3 = _port_mesh((2, 2, 4), ("pod", "data", "model"))
    assert tdist.dp_axes(m3) == ("pod", "data")
    assert tdist.pick_spec((8, 4), m3, [("dp", None), ()]) == (("pod", "data"), None)
    with tdist.axis_rules(seq=("data",)):
        assert tdist.pick_spec((8, 8), mesh, [(None, "seq"), ()]) == (None, "data")
    assert tdist.pick_spec((8, 8), mesh, [(None, "seq"), ()]) == (None, "model")


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_param_specs_equal_reference(world, arch, mesh_i):
    shape, names = MESHES[mesh_i]
    mesh, jmesh = _port_mesh(shape, names), _fake_mesh(shape, names)
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = Whisper(cfg) if cfg.encoder_decoder else LM(cfg)
    jinit = jinit_whisper if jcfg.encoder_decoder else jinit_lm
    jshape = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    jspecs = _jflat(jdist.lm_param_specs(jshape, jmesh))
    specs = tdist.lm_param_specs(model, mesh)
    assert len(specs) == sum(p.numel() > 0 for p in model.parameters())
    seen = set()
    for name, spec in specs.items():
        key, per_layer = _layer_key(name)
        ref = _spec(jspecs[key])
        seen.add(key)
        assert spec == (ref[1:] if per_layer else ref), (name, spec, ref)
    assert seen == set(jspecs)
    if not cfg.encoder_decoder:
        # the byte accounting agrees too (leaf counts differ: the port has a
        # leaf a layer; Whisper's enc/dec differ by decision: the reference
        # shards their stacked L axis, a per-layer leaf has none)
        rep = tdist.replication_report(model, specs)
        jrep = jdist.replication_report(jshape, jdist.lm_param_specs(jshape, jmesh))
        for k in ("total_bytes", "sharded_bytes", "replicated_bytes", "replicated_fraction"):
            assert rep[k] == jrep[k], k


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
@pytest.mark.parametrize("which", ["FNO_DARCY", "TFNO_NS", "SFNO_SWE"])
def test_fno_param_specs_equal_reference(world, which, mesh_i):
    shape, names = MESHES[mesh_i]
    mesh, jmesh = _port_mesh(shape, names), _fake_mesh(shape, names)
    cfg, jcfg, cls, jinit = {
        "FNO_DARCY": (FNO_DARCY, J_FNO_DARCY, FNO, jinit_fno),
        "TFNO_NS": (TFNO_NS, J_TFNO_NS, FNO, jinit_fno),
        "SFNO_SWE": (SFNO_SWE, J_SFNO_SWE, SFNO, jinit_sfno)}[which]
    with torch.device("meta"):
        model = cls(cfg)
    jshape = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    jspecs = jdist.fno_param_specs(jshape, jmesh)
    specs = tdist.fno_param_specs(model, mesh)
    jflat = _jflat(jspecs)
    assert {tuple(k.split(".")) for k in specs} == set(jflat)
    for name, spec in specs.items():
        assert spec == _spec(jflat[tuple(name.split("."))]), name
    assert tdist.replication_report(model, specs) == jdist.replication_report(jshape, jspecs)
    if which == "FNO_DARCY":
        # the 33.5 M-element stacked (L, corners, I, O, m1, m2) spectral
        # leaves shard their out channels, judged on the stacked leaf
        assert specs["spectral.w_re"] == (None, None, None, "model", None, None)


@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
def test_cache_and_batch_specs_equal_reference(world, mesh_i):
    shape, names = MESHES[mesh_i]
    mesh, jmesh = _port_mesh(shape, names), _fake_mesh(shape, names)
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        if cfg.encoder_decoder:
            continue
        cache = init_cache(cfg, 32, 64, device="meta")
        jc = jax.eval_shape(lambda c=jcfg: jinit_cache(c, 32, 64))
        specs = tdist.cache_specs(cache, mesh, cfg)
        jspecs = jdist.cache_specs(jc, jmesh, jcfg)
        assert set(specs) == set(jspecs), arch
        for k in specs:
            assert specs[k] == _spec(jspecs[k]), (arch, k)
    batch = {"tokens": torch.empty((64, 16), dtype=torch.int32, device="meta"),
             "odd": torch.empty((7, 3), device="meta"), "vec": torch.empty((32,), device="meta")}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32) for k, v in batch.items()}
    specs, jspecs = tdist.batch_specs(batch, mesh), jdist.batch_specs(jbatch, jmesh)
    assert {k: v for k, v in specs.items()} == {k: _spec(v) for k, v in jspecs.items()}


def test_to_placements(world):
    from torch.distributed.tensor import Replicate, Shard

    m3 = _port_mesh((2, 2, 4), ("pod", "data", "model"))
    assert tdist.to_placements(m3, (("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert tdist.to_placements(m3, ()) == [Replicate()] * 3
    assert tdist.to_placements(m3, (None, "data")) == [Replicate(), Shard(1), Replicate()]


# ---------------------------------------------------------------------------
# constrain and the mesh-dependent semantics
# ---------------------------------------------------------------------------


def test_constrain_identity_off_mesh_and_trivial(world):
    from torch.distributed.tensor import Replicate, distribute_tensor

    x = torch.ones(4, 8)
    assert tdist.constrain(x, "dp", "tp") is x
    assert tdist.constrain_bsd(torch.ones(2, 4, 8)).shape == (2, 4, 8)
    assert tdist.constrain_spatial(x[None, None]) is not None
    assert tdist.logical_axis_size("dp") == 1 and tdist.logical_axis_size("heads") == 1
    assert tdist.ambient_mesh() is None
    with tdist.use_mesh(None):
        assert tdist.ambient_mesh() is None
    one = _port_mesh((1, 1), ("data", "model"))
    dx = distribute_tensor(x, one, [Replicate(), Replicate()], src_data_rank=None)
    with tdist.use_mesh(one):
        assert tdist.ambient_mesh() is one
        assert tdist.constrain(dx, "dp", "tp") is dx
        assert tdist.constrain(x, "dp", "tp") is x
        assert tdist.constrain_bhsd(x[None, None]) is not None
    big = _port_mesh((2, 4), ("data", "model"))
    with tdist.use_mesh(big):
        # a plain tensor on a real mesh is left alone; sizes follow the mesh
        assert tdist.constrain(x, "dp", "tp") is x
        assert tdist.logical_axis_size("dp") == 2 and tdist.logical_axis_size("all") == 8
    assert tdist.ambient_mesh() is None


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_blocked_attention_q_chunk_follows_the_mesh(world):
    from repro.models.lm.common import blocked_attention as jblocked
    from repro_torch.models.lm.common import blocked_attention

    rng = np.random.default_rng(0)
    B, H, S, D = 1, 4, 1024, 16
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3))
    pos = np.arange(S)
    mesh = _port_mesh((2, 4), ("data", "model"))
    with tdist.use_mesh(mesh):
        out = blocked_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(pos),
                                torch.from_numpy(pos), 2 ** 30)
    # S // heads-axis size = 256, not off-mesh's 512
    explicit = blocked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 torch.from_numpy(pos), torch.from_numpy(pos), 2 ** 30,
                                 q_chunk=256)
    assert torch.equal(out, explicit)
    ref = jblocked(q, k, v, pos, pos, 2 ** 30, q_chunk=256)
    assert _rel(out.numpy(), ref) < 1e-5


def test_moe_dispatch_groups_follow_the_mesh(world):
    from repro.models.lm.moe import _moe_one_group
    from repro_torch.models.lm.moe import moe_apply

    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    d, E, ff = cfg.d_model, cfg.moe_experts, cfg.moe_ff
    rng = np.random.default_rng(1)
    params = {"router": rng.standard_normal((d, E)).astype(np.float32) / d ** 0.5,
              "wg": rng.standard_normal((E, d, ff)).astype(np.float32) / d ** 0.5,
              "wu": rng.standard_normal((E, d, ff)).astype(np.float32) / d ** 0.5,
              "wd": rng.standard_normal((E, ff, d)).astype(np.float32) / ff ** 0.5}
    T = 24
    x = rng.standard_normal((T, d)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = _port_mesh((2, 4), ("data", "model"))
    with tdist.use_mesh(mesh):
        out, aux = moe_apply(tp, torch.from_numpy(x), cfg.moe_top_k, 0.5, torch.float32)
    outs, auxes = jax.vmap(lambda xi: _moe_one_group(
        params, xi, cfg.moe_top_k, 0.5, np.float32, use_constraints=False))(x.reshape(2, T // 2, d))
    assert _rel(out.numpy(), np.asarray(outs).reshape(T, d)) < 1e-5
    assert abs(float(aux) - float(np.mean(auxes))) < 1e-5 * abs(float(np.mean(auxes)))
    # two groups route differently from one (capacity is per group)
    one, _ = moe_apply(tp, torch.from_numpy(x), cfg.moe_top_k, 0.5, torch.float32)
    assert not torch.equal(one, out)


def test_cross_entropy_matches_reference():
    from repro.train.losses import cross_entropy as jce
    from repro_torch.train import cross_entropy

    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    want = float(jce(logits, labels))
    assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# Four gloo ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_PRELUDE = """
import os, sys
import torch, torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

def run(fn):
    mp.spawn(_rank, args=(fn,), nprocs=4, join=True)

def _rank(rank, fn):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{os.environ['PORT']}",
                            rank=rank, world_size=4)
    try:
        fn(rank, init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()
"""


def _run_ranks(body: str, tmp_path, timeout: int = 240) -> str:
    script = tmp_path / "ranks.py"
    script.write_text(_PRELUDE + textwrap.dedent(body))
    env = dict(os.environ, PORT=str(_free_port()),
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src")]
                                          + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run([sys.executable, str(script)], env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_sharded_lm_engine_matches_unsharded(tmp_path):
    out = _run_ranks("""
        def main(rank, mesh):
            from repro_torch.configs import get_config
            from repro_torch.models.lm import init_lm
            from repro_torch.serve import LMEngine, Request
            cfg = get_config("smollm-360m", smoke=True)
            params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
            reqs = lambda: [Request(uid=i, prompt=list(range(1 + i, 4 + 2 * i)), max_new_tokens=4)
                            for i in range(6)]
            d1, _ = LMEngine(params, cfg, n_slots=4, max_len=32, device="cpu").run_until_done(reqs())
            eng = LMEngine(params, cfg, n_slots=4, max_len=32, mesh=mesh, device="cpu")
            d2, _ = eng.run_until_done(reqs())
            from torch.distributed.tensor import DTensor
            assert isinstance(eng.cache["k"], DTensor) and isinstance(eng.params.embed, DTensor)
            # the caller's model is untouched
            assert not any(isinstance(p, DTensor) for p in params.parameters())
            g1 = {r.uid: r.generated for r in d1}
            g2 = {r.uid: r.generated for r in d2}
            assert g1 == g2, (g1, g2)
            # MoE: on the mesh dispatch runs in dp = 2 groups, as one device
            # runs it with the mesh ambient
            from repro_torch.dist import use_mesh
            cfg = get_config("granite-moe-3b-a800m", smoke=True)
            params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
            with use_mesh(mesh):
                d1, _ = LMEngine(params, cfg, n_slots=4, max_len=32,
                                 device="cpu").run_until_done(reqs())
            d2, _ = LMEngine(params, cfg, n_slots=4, max_len=32, mesh=mesh,
                             device="cpu").run_until_done(reqs())
            assert {r.uid: r.generated for r in d1} == {r.uid: r.generated for r in d2}
            print("MATCH", rank, flush=True)

        if __name__ == "__main__":
            run(main)
    """, tmp_path)
    assert out.count("MATCH") == 4


def test_dp_allreduce_mean_within_bf16_budget(tmp_path):
    out = _run_ranks("""
        def main(rank, mesh):
            import numpy as np
            from repro_torch.optim.grad_comm import make_dp_allreduce
            # each rank's partial gradients; data axis = 2 ranks a group
            parts = [{"a": torch.randn(64, 33, generator=torch.Generator().manual_seed(10 * r + 1)),
                      "b": torch.randn(17, generator=torch.Generator().manual_seed(10 * r + 2))}
                     for r in range(4)]
            coord = mesh.get_coordinate()
            # ranks sharing a model coordinate form a data group
            group = [r for r in range(4) if r % 2 == coord[1]]
            want = {k: sum(parts[r][k] for r in group) / 2 for k in ("a", "b")}
            for dtype, tol in ((torch.bfloat16, 2.0 ** -8), (torch.float32, 1e-6)):
                got = make_dp_allreduce(mesh, dtype=dtype)(parts[rank])
                for k in want:
                    err = float((got[k] - want[k]).norm() / want[k].norm())
                    assert got[k].dtype == torch.float32 and err <= tol, (dtype, k, err)
                    print("ERR", dtype, k, err, flush=True)
            print("OK", rank, flush=True)

        if __name__ == "__main__":
            run(main)
    """, tmp_path)
    assert out.count("OK") == 4


def test_checkpoint_restores_onto_a_mesh(tmp_path):
    from repro_torch.train import checkpoint

    rng = np.random.default_rng(3)
    state = {"params": {"w": torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32)),
                        "b": torch.from_numpy(rng.standard_normal((6,)).astype(np.float32))},
             "step": torch.tensor(5)}
    ckpt = checkpoint.AsyncCheckpointer(str(tmp_path / "ckpt"))
    ckpt.save(7, state)
    ckpt.wait()
    out = _run_ranks(f"""
        def main(rank, mesh):
            from torch.distributed.tensor import DTensor, Replicate, Shard
            from repro_torch.train import checkpoint
            target = {{"params": {{"w": torch.zeros(8, 6), "b": torch.zeros(6)}},
                      "step": torch.tensor(0)}}
            place = {{"params": {{"w": (mesh, [Shard(0), Shard(1)]), "b": (mesh, [Replicate(), Shard(0)])}},
                     "step": None}}
            tree, step = checkpoint.restore({str(tmp_path / "ckpt")!r}, target, placements=place)
            assert step == 7 and int(tree["step"]) == 5
            w, b = tree["params"]["w"], tree["params"]["b"]
            assert isinstance(w, DTensor) and w.to_local().shape == (4, 3)
            assert isinstance(b, DTensor) and b.to_local().shape == (3,)
            full = w.full_tensor()
            torch.save({{"w": full, "b": b.full_tensor()}}, os.path.join({str(tmp_path)!r}, f"r{{rank}}.pt"))
            print("OK", rank, flush=True)

        if __name__ == "__main__":
            run(main)
    """, tmp_path)
    assert out.count("OK") == 4
    for r in range(4):
        got = torch.load(tmp_path / f"r{r}.pt")
        assert torch.equal(got["w"], state["params"]["w"])
        assert torch.equal(got["b"], state["params"]["b"])
