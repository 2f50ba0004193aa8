"""The port's launch layer (``repro_torch.launch.{mesh,steps,roofline,
dryrun,dryrun_fno}``) against ``repro.launch`` on the CPU.

* ``make_production_mesh`` needs a world of 256 or 512 and says so;
  importing the mesh module touches no process-group state.
* The dry-runs at smoke size on fake (1, 1) and (2, 4) meshes: the records
  carry the reference's keys (the telemetry and prefill-chunk twins too),
  collective bytes are 0 on 1x1 and above 0 on (2, 4); the prefill cell's
  FLOPs on 1x1 equal ``repro.launch.hlo_parse.parse_hlo``'s count of the
  reference's jitted step; ``analyze_counts`` and ``model_flops`` do the
  reference's arithmetic with the port's H100 constants; the FNO cells'
  records and launch plans; ``dryrun_fno``'s CLI at ``fno-darcy``.
* The LM train step (``build_train_step``) under ``full`` against the
  reference's jitted one, for a dense, an MoE and the encoder-decoder arch,
  every leaf after the step; its loss falls on a repeated batch.
* The FNO data-parallel step on one gloo rank bit-equal to ``mesh=None``;
  on four gloo ranks (2x2) the FNO step and the LM train step within f32
  sum order of one device.
"""
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ShapeConfig as JShape
from repro.configs import get_config as jget_config
from repro.core import get_policy as jget_policy
from repro.launch import roofline as jroof
from repro.launch.hlo_parse import HLOCounts, parse_hlo
from repro_torch.configs import ShapeConfig
from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE, SFNO_SWE_SMOKE, TFNO_NS_SMOKE
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.dryrun_fno import run_fno_cell

from test_torch_dist import _rel, _run_ranks

jax.config.update("jax_platform_name", "cpu")

#: the keys of the reference's dry-run records (repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "mesh", "kind", "policy", "policy_sites", "status", "compile_s",
            "n_devices", "memory_analysis", "cost_analysis_raw", "collective_bytes_by_kind",
            "roofline", "model_flops_6nd", "useful_flops_ratio", "replication"}
REF_FNO_KEYS = {"arch", "shape", "mesh", "kind", "policy", "policy_sites", "status", "compile_s",
                "n_devices", "memory_analysis", "collective_bytes_by_kind", "roofline",
                "spectral_kernel"}
REF_MEMORY_KEYS = {"argument_size_bytes", "output_size_bytes", "temp_size_bytes"}


def _ref_roofline_keys():
    return set(jroof.analyze_counts(HLOCounts(flops=1.0, bytes=1.0, collective_by_kind={}), 1)
               .to_dict())


def _smoke(kind, S=64, B=8):
    return ShapeConfig(f"{kind}_smoke", S, B, kind)


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def test_production_mesh_needs_its_world():
    from repro_torch.launch import mesh as lmesh

    assert not dist.is_initialized()   # importing the module made no group
    with pytest.raises(RuntimeError, match="world size 256"):
        lmesh.make_production_mesh()
    with lmesh.fake_world(8):
        with pytest.raises(RuntimeError, match="world size 512, not 8"):
            lmesh.make_production_mesh(multi_pod=True)
        m = lmesh.make_debug_mesh(4, "cpu")
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 4)
    with lmesh.fake_world(256):
        m = lmesh.make_production_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (16, 16)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The LM dry-run at smoke size
# ---------------------------------------------------------------------------


def test_records_carry_the_reference_keys():
    rec = run_cell("smollm-360m", _smoke("decode"), False, mesh_shape=(2, 4), smoke=True,
                   verbose=False, prefill_chunk=4)
    assert REF_KEYS <= set(rec) and rec["status"] == "ok"
    assert REF_MEMORY_KEYS <= set(rec["memory_analysis"])
    assert set(rec["roofline"]) == _ref_roofline_keys()
    assert set(rec["prefill_chunk"]) == {"chunk", "compile_s", "roofline",
                                         "collective_bytes_by_kind"}
    assert rec["prefill_chunk"]["roofline"]["flops_per_device"] > 0
    rec = run_cell("smollm-360m", _smoke("train", S=32, B=4), False, mesh_shape=(2, 4),
                   smoke=True, verbose=False, telemetry=True)
    assert REF_KEYS <= set(rec)
    assert set(rec["telemetry"]) == {"compile_s", "roofline", "overhead"}
    assert set(rec["telemetry"]["overhead"]) == {"flops_overhead", "bytes_overhead"}
    assert rec["memory_analysis"]["peak_bytes"] >= rec["memory_analysis"]["argument_size_bytes"]
    skipped = run_cell("smollm-360m", "long_500k", False, mesh_shape=(2, 4), smoke=True,
                       verbose=False)
    assert skipped["status"] == "skipped" and skipped["reason"]


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_collective_bytes_zero_on_one_device_positive_on_a_mesh(kind):
    one = run_cell("smollm-360m", _smoke(kind), False, mesh_shape=(1, 1), smoke=True,
                   verbose=False)
    two = run_cell("smollm-360m", _smoke(kind), False, mesh_shape=(2, 4), smoke=True,
                   verbose=False)
    assert one["roofline"]["collective_bytes_per_device"] == 0
    assert one["collective_bytes_by_kind"] == {}
    assert two["roofline"]["collective_bytes_per_device"] > 0
    # each rank computes a share: fewer FLOPs a device on the mesh
    assert two["roofline"]["flops_per_device"] < one["roofline"]["flops_per_device"]
    assert one["replication"]["sharded_bytes"] > 0   # the specs shard, the mesh is trivial


@pytest.mark.parametrize("arch,S", [("smollm-360m", 1024), ("granite-34b", 64),
                                    ("mamba2-370m", 64)])
def test_prefill_flops_equal_the_reference_hlo_count(arch, S):
    jcfg = jget_config(arch, smoke=True)
    jb = __import__("repro.launch.steps", fromlist=["build_prefill_step"]).build_prefill_step(
        jcfg, JShape("p", S, 2, "prefill"), jget_policy("amp_bf16"))
    compiled = jax.jit(jb.step_fn).lower(jb.params_shape, jb.inputs["batch"]).compile()
    want = parse_hlo(compiled.as_text()).flops
    rec = run_cell(arch, ShapeConfig("p", S, 2, "prefill"), False, mesh_shape=(1, 1),
                   smoke=True, verbose=False)
    got = rec["roofline"]["flops_per_device"]
    assert abs(got / want - 1) <= 0.02, (got, want, rec["flops_by_op"])


def test_roofline_arithmetic_matches_the_reference(monkeypatch):
    counts = HLOCounts(flops=3.0e12, bytes=2.5e10,
                       collective_by_kind={"all-gather": 4e8, "all-reduce": 1e8})
    mine = roofline.Counts(flops=3.0e12, bytes=2.5e10,
                           collective_by_kind={"all-gather": 4e8, "all-reduce": 1e8})
    for link in (roofline.NVLINK_BW, roofline.IB_BW):
        monkeypatch.setattr(jroof, "PEAK_FLOPS", roofline.PEAK_FLOPS)
        monkeypatch.setattr(jroof, "HBM_BW", roofline.HBM_BW)
        monkeypatch.setattr(jroof, "ICI_BW", link)
        assert roofline.analyze_counts(mine, 256, link).to_dict() == \
            jroof.analyze_counts(counts, 256).to_dict()
    assert roofline.model_flops(3.6e8, 1e6) == jroof.model_flops(3.6e8, 1e6)
    assert roofline.link_bw((16, 16)) == roofline.IB_BW
    assert roofline.link_bw((2, 4)) == roofline.NVLINK_BW
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12


def test_count_step_hand_counts():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(1000)
        w = torch.empty(16, 32)
        v = torch.empty(32, 8)

        def step(x, w, v):
            a = x * 2            # +4000 live
            b = a + 1            # +4000 -> 8000
            del a                # -4000
            c = b * 3            # +4000 -> 8000
            return c, w @ v      # +512
        _, counts = roofline.count_step(step, x, w, v)
    assert counts.temp_peak_bytes == 8000 + 512
    assert counts.flops == 2 * 16 * 32 * 8
    # bytes: three 4000-byte elementwise ops read 4000 and write 4000; the mm
    # reads 2048 + 1024 and writes 512
    assert counts.bytes == 3 * 8000 + 2048 + 1024 + 512


# ---------------------------------------------------------------------------
# The FNO dry-run
# ---------------------------------------------------------------------------


def test_fno_records_and_launch_plans():
    cell = dict(kind="fno", cfg=FNO_DARCY_SMOKE, res=(16, 16), batch=8)
    one = run_fno_cell("fno-smoke", False, mesh_shape=(1, 1), cell=cell, verbose=False)
    two = run_fno_cell("fno-smoke", False, mesh_shape=(2, 4), cell=cell, verbose=False)
    for rec in (one, two):
        assert REF_FNO_KEYS <= set(rec) and REF_MEMORY_KEYS <= set(rec["memory_analysis"])
        assert set(rec["roofline"]) == _ref_roofline_keys()
        assert rec["spectral_kernel"]["kind"] == "fused"
        assert rec["spectral_kernel"]["fits_smem"] and rec["spectral_kernel"]["fits_l2"]
    assert one["roofline"]["collective_bytes_per_device"] == 0
    assert two["collective_bytes_by_kind"]["all-reduce"] > 0
    assert two["spectral_channels"].startswith("whole")
    narrow = run_fno_cell("fno-smoke", False, mesh_shape=(2, 4), verbose=False,
                          cell=dict(cell, batch=4))
    assert narrow["spectral_channels"] == "replicated over tp"
    assert narrow["batch_axes"] == ["data"]
    tf = run_fno_cell("tfno-smoke", False, mesh_shape=(2, 4), verbose=False,
                      cell=dict(kind="fno", cfg=TFNO_NS_SMOKE, res=(16, 16), batch=8))
    assert tf["spectral_kernel"]["kind"] == "cp"
    sf = run_fno_cell("sfno-smoke", False, mesh_shape=(2, 4), verbose=False,
                      cell=dict(kind="sfno", cfg=SFNO_SWE_SMOKE,
                                res=(SFNO_SWE_SMOKE.nlat, SFNO_SWE_SMOKE.nlon), batch=8))
    assert sf["spectral_kernel"]["kind"] == "l_shared"


def test_spectral_kernel_plan_at_the_darcy_cell():
    from repro_torch.kernels import spectral_contract as sc
    from repro_torch.precision import get_policy

    rec = roofline.spectral_kernel_smem(4, 64, 64, (32, 32), spatial=(128, 128),
                                        policy=get_policy("mixed_fno_bf16"))
    assert rec["kind"] == "fused" and rec["tile_source"] == "heuristic"
    assert rec["block_b"] == sc.pick_block_b(4, 64, 64, (128, 128), (32, 32))
    assert rec["smem_fwd_bytes"] == sc.fused_smem_bytes((128, 128), (32, 32))
    assert rec["kernel_bytes"] > 0 and rec["kernel_bytes_ms"] == \
        rec["kernel_bytes"] / roofline.HBM_BW * 1e3


def test_dryrun_fno_cli_writes_records(tmp_path):
    from repro_torch.launch import dryrun_fno

    out = tmp_path / "dryrun.json"
    dryrun_fno.main(["--cell", "fno-darcy", "--mesh", "single", "--out", str(out)])
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["16x16"] and recs[0]["status"] == "ok"
    assert REF_FNO_KEYS | {"meta"} <= set(recs[0])
    # the 33.5 M-element spectral leaves are sharded over model, so gathered
    assert recs[0]["collective_bytes_by_kind"]["all-gather"] > 0
    assert recs[0]["memory_analysis"]["fits_hbm"]


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _lm_batch(cfg, B, S, seed=0):
    from repro_torch.data.tokens import lm_inputs

    return {k: v.to(torch.int32) for k, v in lm_inputs(seed, 0, B, S, cfg.vocab).items()}


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m", "whisper-large-v3"])
def test_lm_train_step_matches_the_reference(arch):
    import jax.numpy as jnp

    from repro.launch.steps import build_train_step as jbuild
    from repro.models.lm import init_lm as jinit_lm
    from repro.models.lm import init_whisper as jinit_whisper
    from repro.optim import AdamW as JAdamW
    from repro_torch.configs import get_config
    from repro_torch.launch.parity import train_batch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.lm import lm_params_from_jax, whisper_params_from_jax
    from repro_torch.optim import AdamW
    from repro_torch.precision import get_policy

    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    from_jax = whisper_params_from_jax if cfg.encoder_decoder else lm_params_from_jax
    shape = ShapeConfig("t", 16, 2, "train")
    jparams = (jinit_whisper if cfg.encoder_decoder else jinit_lm)(jax.random.PRNGKey(0), jcfg)
    batch = train_batch(cfg, 2, 16) if cfg.encoder_decoder else _lm_batch(cfg, 2, 16)
    jb = jbuild(jcfg, JShape("t", 16, 2, "train"), jget_policy("full"), JAdamW(lr=1e-3))
    jopt = JAdamW(lr=1e-3).init(jparams)
    jnp_batch = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                 if v.dtype == torch.bfloat16 else v.numpy() for k, v in batch.items()}
    jp, _, jloss = jax.jit(jb.step_fn)(jparams, jopt, jnp_batch)
    params = from_jax(jparams, cfg, device="cpu")
    b = build_train_step(cfg, shape, get_policy("full"), AdamW(lr=1e-3))
    opt = AdamW(lr=1e-3).init(dict(params.named_parameters()))
    params, opt, loss = b.step_fn(params, opt, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = dict(from_jax(jp, cfg, device="cpu").named_parameters())
    for k, p in params.named_parameters():
        assert _rel(p.detach().numpy(), want[k].detach().numpy()) < 1e-5, k
    assert int(opt.count) == 1


def test_lm_train_step_loss_falls_on_a_repeated_batch():
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import AdamW
    from repro_torch.precision import get_policy

    cfg = get_config("smollm-360m", smoke=True)
    params = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = build_train_step(cfg, ShapeConfig("t", 32, 2, "train"), get_policy("amp_bf16"),
                         AdamW(lr=3e-3))
    opt = AdamW(lr=3e-3).init(dict(params.named_parameters()))
    batch = _lm_batch(cfg, 2, 32)
    losses = []
    for _ in range(4):
        params, opt, loss = b.step_fn(params, opt, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    tb = build_train_step(cfg, ShapeConfig("t", 32, 2, "train"), get_policy("amp_bf16"),
                          telemetry=True)
    out = tb.step_fn(params, AdamW(lr=1e-4).init(dict(params.named_parameters())), batch)
    assert len(out) == 4 and isinstance(out[3], dict)


def _darcy_batch(B, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(B, 1, n, n, generator=g), "y": torch.randn(B, 1, n, n, generator=g)}


def test_fno_dp_step_on_one_rank_is_bit_equal(tmp_path):
    from repro_torch.dist import distribute, fno_param_specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_fno_train_step, fno_batch_specs
    from repro_torch.models import init_fno
    from repro_torch.optim import AdamW
    from repro_torch.precision import get_policy

    policy = get_policy("mixed_fno_bf16")
    batch = _darcy_batch(4, 16)
    ref = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE, device="cpu")
    opt = AdamW(lr=1e-3)
    ref_state = opt.init(dict(ref.named_parameters()))
    plain = build_fno_train_step(policy, None, opt)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = make_debug_mesh(1, "cpu")
        model = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE, device="cpu")
        distribute(model, mesh, fno_param_specs(model, mesh))
        state = opt.init(dict(model.named_parameters()))
        dbatch = distribute(batch, mesh, fno_batch_specs(batch, mesh))
        dp = build_fno_train_step(policy, mesh, opt)
        for _ in range(3):
            ref, ref_state, l0 = plain(ref, ref_state, batch)
            model, state, l1 = dp(model, state, dbatch)
            assert torch.equal(l0, l1)
        for k, p in model.named_parameters():
            assert torch.equal(p.full_tensor(), dict(ref.named_parameters())[k]), k
    finally:
        dist.destroy_process_group()


def test_fno_and_lm_steps_on_four_ranks(tmp_path):
    out = _run_ranks("""
        def main(rank, mesh):
            import dataclasses
            from torch.distributed.tensor.experimental import implicit_replication
            from repro_torch.configs import ShapeConfig, get_config
            from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE
            from repro_torch.dist import distribute, fno_param_specs, lm_param_specs, use_mesh
            from repro_torch.dist.sharding import batch_specs
            from repro_torch.launch.steps import build_fno_train_step, build_train_step, fno_batch_specs
            from repro_torch.models import init_fno
            from repro_torch.models.lm import init_lm
            from repro_torch.optim import AdamW
            from repro_torch.precision import get_policy

            def rel(a, b):
                return float((a - b).norm() / b.norm())

            # FNO: full-DP over the 4 ranks, the spectral weights sharded over
            # model by a low threshold (gathered, their gradients reduce-scattered)
            policy = get_policy("full")
            g = torch.Generator().manual_seed(3)
            batch = {"x": torch.randn(8, 1, 16, 16, generator=g), "y": torch.randn(8, 1, 16, 16, generator=g)}
            opt = AdamW(lr=1e-3)
            ref = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE, device="cpu")
            ref_state = opt.init(dict(ref.named_parameters()))
            model = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE, device="cpu")
            specs = fno_param_specs(model, mesh, shard_threshold=1 << 12)
            assert any(s for s in specs.values())
            distribute(model, mesh, specs)
            with implicit_replication():
                state = opt.init(dict(model.named_parameters()))
            dbatch = distribute(batch, mesh, fno_batch_specs(batch, mesh))
            plain, dp = build_fno_train_step(policy, None, opt), build_fno_train_step(policy, mesh, opt)
            for _ in range(3):
                ref, ref_state, l0 = plain(ref, ref_state, batch)
                model, state, l1 = dp(model, state, dbatch)
                assert abs(float(l0) - float(l1)) <= 1e-6 * abs(float(l0)), (float(l0), float(l1))
            named = dict(ref.named_parameters())
            for k, p in model.named_parameters():
                assert rel(p.full_tensor(), named[k].detach()) < 1e-5, k
            print("FNO", rank, flush=True)

            # LM train step: DTensor params over the 2x2 mesh against one device
            cfg = get_config("smollm-360m", smoke=True)
            shape = ShapeConfig("t", 16, 4, "train")
            from repro_torch.data.tokens import lm_inputs
            lb = {k: v.to(torch.int32) for k, v in lm_inputs(0, 0, 4, 16, cfg.vocab).items()}
            bundle = build_train_step(cfg, shape, get_policy("full"), AdamW(lr=1e-3))
            p0 = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
            s0 = AdamW(lr=1e-3).init(dict(p0.named_parameters()))
            p0, s0, loss0 = bundle.step_fn(p0, s0, lb)
            p1 = init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
            distribute(p1, mesh, lm_param_specs(p1, mesh))
            with use_mesh(mesh), implicit_replication():
                s1 = AdamW(lr=1e-3).init(dict(p1.named_parameters()))
                dlb = distribute(lb, mesh, batch_specs(lb, mesh))
                p1, s1, loss1 = bundle.step_fn(p1, s1, dlb)
                loss1 = loss1.full_tensor()
            assert abs(float(loss0) - float(loss1)) <= 1e-5 * abs(float(loss0)), (float(loss0), float(loss1))
            n0 = dict(p0.named_parameters())
            for k, p in p1.named_parameters():
                assert rel(p.full_tensor(), n0[k].detach()) < 1e-5, k
            print("LM", rank, flush=True)

        if __name__ == "__main__":
            run(main)
    """, tmp_path)
    assert out.count("FNO") == 4 and out.count("LM") == 4
