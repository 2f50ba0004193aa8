"""Card-only tests of the PyTorch port: the hand-written CUDA spectral
contraction kernels (the dense forward and its two backward kernels, the
CP kernels ``cp_fwd`` and ``cp_bwd``, the order-shared kernels ``ls_fwd``,
``ls_bwd_x`` and ``ls_bwd_w``, the fused layer's ``fused_fwd`` and
``fused_bwd``) and the LM pool's RMSNorm and flash attention kernels
against their plain PyTorch versions on the card, the wrappers'
checks, the autograd Functions on CUDA against the CPU, the FNO
(staged, pinned with ``fuse_spectral=False``, and fused, its default on
the card), TFNO and SFNO serving and training paths on CUDA against the
CPU, the SHT's synthesis on CUDA against the CPU, the Navier-Stokes
and shallow-water solvers on CUDA against the CPU, and the tuned tiles
(``repro_torch.tune``): every legal forward tile bit-identical, every
legal backward tile within ``store_budget``, a seeded entry's launches, a
stale or oversized entry leaving every launch as it was, ``measure`` and
the oracle on the card, the engine serving calibrated tiles; and the LM
pool (one smoke config a family: forward against the CPU, decode against
the forward, ``LMEngine`` chunk 1 against 8 and rerun bit for bit,
Whisper's decode against the CPU) and ``PagedLMEngine`` (bit-equal to
``LMEngine`` for four archs under ``full`` and ``amp_bf16``, copy-on-write,
a shared prefix, an exhausted pool, the null block untouched), whose path
runs none of these kernels; and the distribution layer on a one-rank NCCL
mesh (``FNO_DARCY_SMOKE``'s data-parallel step bit-equal to ``mesh=None``
with the fused kernels launched, ``LMEngine(mesh=...)``'s tokens and logits
equal to ``mesh=None``'s, the bf16 all-reduce within bf16's unit roundoff).

Imports no JAX (the GPU machine has none).  Every test carries the
``cuda`` marker and skips, from inside a fixture, where no card is
present.  On a machine with an NVIDIA H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE
from repro_torch.core.precision import FORMAT_EPS, dtype_name
from repro_torch.core.theory import contract_budget, store_budget
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import spectral_contract as sc
from repro_torch.models import fno_infer, init_fno
from repro_torch.precision import get_policy
from repro_torch.serve import FieldRequest, OperatorEngine

pytestmark = pytest.mark.cuda

#: (cast_to, out_dtype) of the three modes the serving path uses
MODES = [(None, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.float16, torch.float16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(B, I, O, M, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    xs = [0.5 * torch.randn(B, I, M, generator=g) for _ in range(2)]
    ws = [0.5 * torch.randn(I, O, M, generator=g) for _ in range(2)]
    return [t.to(device) for t in xs + ws]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("shape", [(8, 64, 64, 1024), (3, 24, 40, 300),
                                   (1, 1, 1, 1), (9, 17, 5, 33)])
@pytest.mark.parametrize("cast_to,out_dtype", MODES)
def test_kernel_matches_plain_within_budget(cuda, shape, cast_to, out_dtype):
    ops_ = _operands(*shape, cuda)
    before = sc.launches
    kr, ki = sc.spectral_contract_dense(*ops_, cast_to=cast_to, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    pr, pi = sc.spectral_contract_plain(*ops_, cast_to=cast_to, out_dtype=out_dtype)
    assert kr.dtype == out_dtype and kr.shape == pr.shape
    diff = torch.hypot(kr.float() - pr.float(), ki.float() - pi.float())
    budget = contract_budget(FORMAT_EPS[dtype_name(out_dtype)],
                             sc.contract_magnitude(*ops_))
    assert bool((diff <= budget).all()), float((diff - budget).max())


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    xr, xi, wr, wi = _operands(2, 4, 3, 16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sc.spectral_contract_dense(xr.transpose(0, 1).contiguous().transpose(0, 1),
                                   xi, wr, wi)
    with pytest.raises(TypeError):
        sc.spectral_contract_dense(xr.double(), xi, wr, wi)
    with pytest.raises(ValueError, match="operands on"):
        sc.spectral_contract_dense(xr.cpu(), xi, wr, wi)
    # a gradient is taken through the backward kernels
    wr.requires_grad_()
    before = (sc.launches_bwd_x, sc.launches_bwd_w)
    out_re, out_im = sc.spectral_contract_dense(xr, xi, wr, wi)
    (dwr,) = torch.autograd.grad(out_re.sum() + out_im.sum(), [wr])
    torch.cuda.synchronize()
    assert (sc.launches_bwd_x, sc.launches_bwd_w) == (before[0], before[1] + 1)
    want, _ = sc.spectral_contract_bwd_w_plain(xr, xi, torch.ones_like(out_re),
                                               torch.ones_like(out_im))
    assert torch.allclose(dwr, want, rtol=1e-5, atol=1e-4)


def _cotangent(B, O, M, dtype, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [(0.5 * torch.randn(B, O, M, generator=g)).to(dtype).to(device) for _ in range(2)]


@pytest.mark.parametrize("shape", [(8, 64, 64, 1024), (3, 24, 40, 300),
                                   (1, 1, 1, 1), (9, 17, 5, 33), (19, 6, 11, 70)])
@pytest.mark.parametrize("cast_to,out_dtype", MODES)
def test_backward_kernels_match_plain_within_budget(cuda, shape, cast_to, out_dtype):
    """dense_bwd_x and dense_bwd_w against their plain versions, the
    cotangent at the forward's out_dtype, within contract_budget at ε_f32
    of each gradient's magnitude contraction (Σ_o |g||w|, Σ_b |x||g|);
    B > 8 and ragged M included."""
    B, I, O, M = shape
    xr, xi, wr, wi = _operands(*shape, cuda)
    gr, gi = _cotangent(B, O, M, out_dtype, cuda)
    before = (sc.launches_bwd_x, sc.launches_bwd_w)
    kx = sc._launch_bwd_x(gr, gi, wr, wi, cast_to)
    kw = sc._launch_bwd_w(xr, xi, gr, gi, cast_to)
    torch.cuda.synchronize()
    assert (sc.launches_bwd_x, sc.launches_bwd_w) == (before[0] + 1, before[1] + 1)
    px = sc.spectral_contract_bwd_x_plain(gr, gi, wr, wi, cast_to=cast_to)
    pw = sc.spectral_contract_bwd_w_plain(xr, xi, gr, gi, cast_to=cast_to)
    absg = torch.hypot(gr.float(), gi.float())
    mags = (torch.einsum("bom,iom->bim", absg, torch.hypot(wr, wi)),
            torch.einsum("bim,bom->iom", torch.hypot(xr, xi), absg))
    for (kr, ki), (pr, pi), mag in zip((kx, kw), (px, pw), mags):
        assert kr.dtype == torch.float32 and kr.shape == pr.shape
        diff = torch.hypot(kr - pr, ki - pi)
        budget = contract_budget(FORMAT_EPS["float32"], mag)
        assert bool((diff <= budget).all()), float((diff - budget).max())


@pytest.mark.parametrize("cast_to,out_dtype", MODES)
def test_kernels_rerun_bit_identically(cuda, cast_to, out_dtype):
    B, I, O, M = 8, 64, 64, 1024
    xr, xi, wr, wi = _operands(B, I, O, M, cuda, seed=4)
    gr, gi = _cotangent(B, O, M, out_dtype, cuda, seed=5)
    runs = [(sc._launch_fwd(xr, xi, wr, wi, cast_to, out_dtype),
             sc._launch_bwd_x(gr, gi, wr, wi, cast_to),
             sc._launch_bwd_w(xr, xi, gr, gi, cast_to)) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("cast_to,out_dtype", MODES)
def test_dense_contract_cuda_matches_cpu(cuda, cast_to, out_dtype):
    """The autograd Function on the card (the three kernels) against the
    same Function on the CPU (the plain versions): outputs and all four
    gradients."""
    B, I, O, M = 5, 12, 9, 130
    ops_cpu = _operands(B, I, O, M, "cpu", seed=6)
    g_cpu = _cotangent(B, O, M, out_dtype, "cpu", seed=7)
    results = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in ops_cpu]
        out = sc.spectral_contract_dense(*leaves, cast_to=cast_to, out_dtype=out_dtype)
        grads = torch.autograd.grad(out, leaves, [g.to(dev) for g in g_cpu])
        results[str(dev)] = [t.detach().float().cpu() for t in (*out, *grads)]
    eps_out = FORMAT_EPS[dtype_name(out_dtype)]
    xr, xi, wr, wi = ops_cpu
    absg = torch.hypot(g_cpu[0].float(), g_cpu[1].float())
    mags = [sc.contract_magnitude(*ops_cpu)] * 2 + \
        [torch.einsum("bom,iom->bim", absg, torch.hypot(wr, wi))] * 2 + \
        [torch.einsum("bim,bom->iom", torch.hypot(xr, xi), absg)] * 2
    epss = [eps_out] * 2 + [FORMAT_EPS["float32"]] * 4
    for got, want, mag, eps in zip(results[str(cuda)], results["cpu"], mags, epss):
        assert bool(((got - want).abs() <= contract_budget(eps, mag)).all())


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16", "sim_fp8_e4m3"])
def test_spectral_contract_op_cuda_matches_cpu(cuda, policy_name):
    site = get_policy(policy_name).at("fno/layer0/spectral/contract")
    g = torch.Generator().manual_seed(3)
    x = torch.complex(torch.randn(4, 8, 6, 5, generator=g),
                      torch.randn(4, 8, 6, 5, generator=g))
    w_re, w_im = (0.1 * torch.randn(8, 7, 6, 5, generator=g) for _ in range(2))
    want = ops.spectral_contract(x, w_re, w_im, policy=site)
    got = ops.spectral_contract(x.to(cuda), w_re.to(cuda), w_im.to(cuda),
                                policy=site).cpu()
    eps = FORMAT_EPS[dtype_name(site.spectral_dtype or torch.float32)]
    mag = sc.contract_magnitude(x.real.reshape(4, 8, 30), x.imag.reshape(4, 8, 30),
                                w_re.reshape(8, 7, 30), w_im.reshape(8, 7, 30))
    budget = contract_budget(eps, mag.reshape(4, 7, 6, 5))
    assert bool(((got - want).abs() <= budget).all())


@pytest.mark.parametrize("spatial,modes", [((128, 128), (32, 32)), ((45, 45), (12, 12)),
                                           ((40,), (9,))])
@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_spectral_conv_cuda_matches_cpu(cuda, spatial, modes, policy_name):
    """The whole staged spectral layer, FFTs included, agrees across
    devices: cuFFT must invert the contracted (non-Hermitian) spectrum as
    the CPU does.  Pinned to the staged path on both devices (a CUDA
    tensor would take the fused one by default)."""
    from repro_torch.core.spectral import init_spectral_weights, spectral_conv_apply

    policy = get_policy(policy_name)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 8, *spatial, generator=g)
    params = init_spectral_weights(8, 8, modes, generator=g)
    before = (sc.launches, sc.launches_fused_fwd)
    want = spectral_conv_apply(params, x, modes, policy, fuse_spectral=False).numpy()
    got = spectral_conv_apply({k: v.to(cuda) for k, v in params.items()},
                              x.to(cuda), modes, policy, fuse_spectral=False).cpu().numpy()
    assert (sc.launches - before[0], sc.launches_fused_fwd - before[1]) == \
        (2 ** (len(modes) - 1), 0)
    if policy_name == "full":
        assert _rel_l2(got, want) <= 1e-5
    else:
        full = spectral_conv_apply(params, x, modes, get_policy("full"),
                                   fuse_spectral=False).numpy()
        assert _rel_l2(got, want) <= 0.25 * _rel_l2(want, full)


def _fields(n, count, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, n, n).astype(np.float32) for _ in range(count)]


#: the smoke FNO pinned to the staged path, whose dense kernels these tests
#: hold (on a CUDA tensor the default takes the fused kernels)
STAGED_SMOKE = dataclasses.replace(FNO_DARCY_SMOKE, fuse_spectral=False)


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_engine_launches_kernel_per_corner_and_layer(cuda, policy_name):
    cfg = STAGED_SMOKE
    net = init_fno(torch.Generator().manual_seed(1), cfg, device=cuda)
    engine = OperatorEngine(net, policy=get_policy(policy_name), max_batch=4,
                            device=cuda)
    for i, x in enumerate(_fields(16, 5, 0) + _fields(24, 2, 1)):
        engine.submit(FieldRequest(uid=i, x=x))
    sc.launches = sc.launches_fused_fwd = 0
    done, _ = engine.drain()
    torch.cuda.synchronize()
    corners = 2 ** (cfg.ndim - 1)
    assert engine.stats()["batches"] == 3
    assert sc.launches == 3 * cfg.n_layers * corners
    assert sc.launches_fused_fwd == 0
    assert all(r.status == "done" and np.isfinite(r.y).all() for r in done)


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_engine_batched_matches_solo_bit_identically(cuda, policy_name):
    cfg = STAGED_SMOKE
    policy = get_policy(policy_name)
    net = init_fno(torch.Generator().manual_seed(1), cfg, device=cuda)
    xs = _fields(16, 5, 2)
    engine = OperatorEngine(net, policy=policy, max_batch=4, device=cuda)
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(xs)]
    for r in reqs:
        engine.submit(r)
    engine.drain()
    for i in (0, 3, 4):
        solo = OperatorEngine(net, policy=policy, max_batch=4, device=cuda)
        sr = FieldRequest(uid=0, x=xs[i])
        solo.submit(sr)
        solo.drain()
        assert np.array_equal(sr.y, reqs[i].y)


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16", "mixed_fno_fp16"])
def test_fno_infer_cuda_matches_cpu(cuda, policy_name):
    """The card and the CPU run the same weights to within a quarter of
    the policy's own precision error (1e-5 relative under full)."""
    cfg = STAGED_SMOKE
    policy = get_policy(policy_name)
    x = np.stack(_fields(32, 3, 4))
    nets = {d: init_fno(torch.Generator().manual_seed(5), cfg, device=d)
            for d in ("cpu", cuda)}
    y_cpu = fno_infer(nets["cpu"], x, policy, device="cpu").numpy()
    y_gpu = fno_infer(nets[cuda], x, policy, device=cuda).cpu().numpy()
    if policy_name == "full":
        assert _rel_l2(y_gpu, y_cpu) <= 1e-5
    else:
        y_full = fno_infer(nets["cpu"], x, get_policy("full"), device="cpu").numpy()
        assert _rel_l2(y_gpu, y_cpu) <= 0.25 * _rel_l2(y_cpu, y_full)


def test_trainer_two_steps_cuda_matches_cpu(cuda):
    """Two steps of the port's Trainer on FNO_DARCY_SMOKE, from the same
    weights and batches, on the card and on the CPU: losses within 1e-5
    relative and parameters within 1e-4 relative L2 under ``full``, and
    the forward, bwd_x and bwd_w kernels launched once per layer and
    corner per step."""
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.models import fno_apply
    from repro_torch.train import Trainer, TrainerConfig, relative_l2

    cfg = STAGED_SMOKE
    rng = np.random.RandomState(8)
    batches = [{"a": rng.randn(4, 1, 16, 16).astype(np.float32),
                "u": rng.randn(4, 1, 16, 16).astype(np.float32)} for _ in range(2)]

    def loss_fn(model, batch, policy):
        return relative_l2(fno_apply(model, batch["a"], policy), batch["u"])

    net = init_fno(torch.Generator().manual_seed(2), cfg, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        tt = Trainer(loss_fn, net, TrainerConfig(
            total_steps=2, schedule=PrecisionSchedule.constant("full")), device=dev)
        counts = (sc.launches, sc.launches_bwd_x, sc.launches_bwd_w)
        tt.run(lambda s: batches[s])
        torch.cuda.synchronize()
        runs[str(dev)] = (tt, tuple(c1 - c0 for c0, c1 in zip(
            counts, (sc.launches, sc.launches_bwd_x, sc.launches_bwd_w))))
    cpu, gpu = runs["cpu"][0], runs[str(cuda)][0]
    per_step = cfg.n_layers * 2 ** (cfg.ndim - 1)
    assert runs["cpu"][1] == (0, 0, 0)
    assert runs[str(cuda)][1] == (2 * per_step,) * 3
    for h_cpu, h_gpu in zip(cpu.history, gpu.history, strict=True):
        assert abs(h_gpu["loss"] - h_cpu["loss"]) <= 1e-5 * abs(h_cpu["loss"])
    for k, p in cpu.params.items():
        assert _rel_l2(gpu.params[k].detach().cpu().numpy(), p.detach().numpy()) <= 1e-4, k


# -- the fused spectral layer (kernels fused_fwd and fused_bwd) ------------------------
#: (cast_to, sim_fmt) of the fused kernels' five modes: full/amp,
#: mixed_fno_bf16, the fp16 family, and the two simulated fp8 policies
FUSED_MODES = [(None, None), (torch.bfloat16, None), (torch.float16, None),
               (torch.float16, "fp8_e4m3"), (torch.float16, "fp8_e5m2")]
#: (B, I, O, spatial, modes): the Darcy path's shape, a ragged 2-d, a 3-d, a
#: 1-d whose last axis keeps its Nyquist row, the 421-point (prime) grid of
#: the Darcy path at a few channels, and two batch tiles
FUSED_SHAPES = [(8, 64, 64, (128, 128), (32, 32)), (3, 5, 7, (20, 24), (6, 9)),
                (2, 4, 6, (10, 12, 8), (3, 4, 5)), (3, 5, 7, (30,), (16,)),
                (2, 3, 4, (421, 421), (32, 32)), (11, 3, 4, (16, 16), (4, 5))]


def _fused_operands(B, I, O, spatial, modes, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    Mh = int(np.prod(sc.fused_rows(spatial, modes)))
    x = torch.randn(B, I, *spatial, generator=g)
    w = [torch.randn(I, O, Mh, generator=g) / I for _ in range(2)]
    gy = torch.randn(B, O, *spatial, generator=g)
    return [t.to(device) for t in (x, *w, gy)]


def _eps(cast_to, sim_fmt):
    return FORMAT_EPS[sim_fmt or dtype_name(cast_to or torch.float32)]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("cast_to,sim_fmt", FUSED_MODES)
def test_fused_kernels_match_plain_within_budget(cuda, shape, cast_to, sim_fmt):
    """fused_fwd and fused_bwd against their plain versions on the card:
    y within one 4ε·M term per requantising stage on either side (the
    spectrum: stages=2) plus the f32 order term, dx and dw within stages=4
    (the spectrum and ĝ), M the composed envelopes; in the half modes also
    within a quarter of the plain version's own gap to itself with the
    quantisation skipped (relative L2).  A zeroed output fails one of the
    two: the envelope budget in f32 mode, the quarter-gap limit in the half
    modes (there the envelope, ~100x |y| on random data, admits it)."""
    B, I, O, spatial, modes = shape
    x, wgr, wgi, g = _fused_operands(*shape, cuda)
    before = (sc.launches_fused_fwd, sc.launches_fused_bwd)
    tiles = -(-B // sc.pick_block_b(B, I, O, spatial, modes))
    y = sc._launch_fused_fwd(x, wgr, wgi, modes, cast_to, sim_fmt)
    got = (y, *sc._launch_fused_bwd(x, wgr, wgi, g, modes, cast_to, sim_fmt))
    torch.cuda.synchronize()
    assert (sc.launches_fused_fwd - before[0], sc.launches_fused_bwd - before[1]) == (tiles,) * 2
    q = {"cast_to": cast_to, "sim_fmt": sim_fmt}
    want = (sc.spectral_fused_plain(x, wgr, wgi, modes, **q),
            *sc.spectral_fused_bwd_plain(x, wgr, wgi, g, modes, **q))
    raw = (sc.spectral_fused_plain(x, wgr, wgi, modes),
           *sc.spectral_fused_bwd_plain(x, wgr, wgi, g, modes))
    mags = sc.fused_magnitude(x, wgr, wgi, modes, g=g)
    eps = _eps(cast_to, sim_fmt)
    for name, a, b, r, mag, stages in zip(("y", "dx", "dwr", "dwi"), got, want, raw,
                                          (mags["out"], mags["dx"], mags["dw"], mags["dw"]),
                                          (2, 4, 4, 4), strict=True):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        budget = contract_budget(eps, mag, stages=stages)
        assert bool(((a.double() - b.double()).abs() <= budget).all()), \
            (name, float(((a.double() - b.double()).abs() - budget).max()))
        if cast_to is None:
            assert bool((b.double().abs() > budget).any()), (name, "a zeroed output passes")
        else:
            gap = _rel_l2(b.cpu().numpy(), r.cpu().numpy())
            assert _rel_l2(a.cpu().numpy(), b.cpu().numpy()) <= 0.25 * gap < 1.0, name


def test_fused_sizes_match_the_python_budgets(cuda):
    """The shared memory the library launches with is the formula the CPU
    decides viability with, and its factor pack is the wrapper's."""
    lib = sc._library_fused()
    for B, I, _O, spatial, modes in FUSED_SHAPES + [(8, 64, 64, (421, 421), (32, 32)),
                                                    (2, 64, 64, (32, 32, 32), (12, 12, 12))]:
        x = torch.empty(B, I, *spatial, device="meta")
        assert lib.spectral_fused_smem(*sc._fused_args(x, modes)) == \
            sc.fused_smem_bytes(spatial, modes)
        # the factor pack the wrapper builds is the one the kernels index
        assert lib.spectral_fused_pack_words(*sc._fused_args(x, modes)) * 4 == \
            sc._fused_pack(tuple(spatial), tuple(modes), torch.device("cpu")).numel()


@pytest.mark.parametrize("cast_to,sim_fmt", FUSED_MODES)
def test_fused_kernels_rerun_bit_identically(cuda, cast_to, sim_fmt):
    """Two runs of each kernel, one batch tile and two (dw summed in tile
    order), agree to the bit."""
    for shape in (FUSED_SHAPES[0], FUSED_SHAPES[-1]):
        x, wgr, wgi, g = _fused_operands(*shape, cuda, seed=3)
        modes = shape[-1]
        runs = [(sc._launch_fused_fwd(x, wgr, wgi, modes, cast_to, sim_fmt),
                 *sc._launch_fused_bwd(x, wgr, wgi, g, modes, cast_to, sim_fmt))
                for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs, strict=True))


def test_fused_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    x, wgr, wgi, _ = _fused_operands(2, 3, 4, (16, 16), (4, 5), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sc.FusedSpectral.apply(x.transpose(2, 3), wgr, wgi, (4, 5))
    with pytest.raises(ValueError, match="operands on"):
        sc.FusedSpectral.apply(x.cpu(), wgr, wgi, (4, 5))
    big = torch.empty(1, 1, 2048, 64, device=cuda)
    wb = torch.empty(1, 1, 8 * 32, device=cuda)
    assert sc.fused_smem_bytes((2048, 64), (4, 32)) > sc.SMEM_LIMIT
    with pytest.raises(RuntimeError, match="spectral_fused_fwd failed to launch"):
        sc.FusedSpectral.apply(big, wb, wb, (4, 32))


@pytest.mark.parametrize("spatial,modes", [((128, 128), (32, 32)), ((45, 45), (12, 12)),
                                           ((40,), (9,)), ((12, 10, 16), (4, 3, 5))])
@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16", "sim_fp8_e4m3"])
def test_fused_spectral_conv_cuda_matches_cpu(cuda, spatial, modes, policy_name):
    """The fused layer on the card (its default there) against the same
    fused path on the CPU (``fuse_spectral=True``): within 1e-5 relative L2
    under full, a quarter of the CPU's own precision error otherwise."""
    from repro_torch.core.spectral import init_spectral_weights, spectral_conv_apply

    policy = get_policy(policy_name)
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 8, *spatial, generator=g)
    params = init_spectral_weights(8, 8, modes, generator=g)
    before = (sc.launches, sc.launches_fused_fwd)
    want = spectral_conv_apply(params, x, modes, policy, fuse_spectral=True).numpy()
    got = spectral_conv_apply({k: v.to(cuda) for k, v in params.items()},
                              x.to(cuda), modes, policy).cpu().numpy()
    assert (sc.launches - before[0], sc.launches_fused_fwd - before[1]) == (0, 1)
    if policy_name == "full":
        assert _rel_l2(got, want) <= 1e-5
    else:
        full = spectral_conv_apply(params, x, modes, get_policy("full"),
                                   fuse_spectral=True).numpy()
        assert _rel_l2(got, want) <= 0.25 * _rel_l2(want, full)


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_fused_engine_launches_per_layer_and_batched_matches_solo(cuda, policy_name):
    """FNO_DARCY_SMOKE at its default config on the card serves through the
    fused kernels: one fused_fwd per layer and micro-batch, no dense
    launch; a field served alone gets its batched answer to the bit."""
    cfg, policy = FNO_DARCY_SMOKE, get_policy(policy_name)
    net = init_fno(torch.Generator().manual_seed(1), cfg, device=cuda)
    xs = _fields(16, 5, 0) + _fields(24, 2, 1)
    engine = OperatorEngine(net, policy=policy, max_batch=4, device=cuda)
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(xs)]
    for r in reqs:
        engine.submit(r)
    sc.launches = sc.launches_fused_fwd = 0
    engine.drain()
    torch.cuda.synchronize()
    assert engine.stats()["batches"] == 3
    assert (sc.launches, sc.launches_fused_fwd) == (0, 3 * cfg.n_layers)
    for i in (0, 4, 6):
        solo = OperatorEngine(net, policy=policy, max_batch=4, device=cuda)
        sr = FieldRequest(uid=0, x=xs[i])
        solo.submit(sr)
        solo.drain()
        assert reqs[i].status == "done" and np.isfinite(reqs[i].y).all()
        assert np.array_equal(sr.y, reqs[i].y)


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16", "mixed_fno_fp16"])
def test_fused_fno_infer_cuda_matches_cpu(cuda, policy_name):
    """The fused path on both devices (the CPU told ``fuse_spectral=True``),
    the same weights: 1e-5 relative L2 under full, a quarter of the
    policy's precision error otherwise."""
    policy = get_policy(policy_name)
    x = np.stack(_fields(32, 3, 4))
    cpu_cfg = dataclasses.replace(FNO_DARCY_SMOKE, fuse_spectral=True)
    net_cpu = init_fno(torch.Generator().manual_seed(5), cpu_cfg, device="cpu")
    net_gpu = init_fno(torch.Generator().manual_seed(5), FNO_DARCY_SMOKE, device=cuda)
    y_cpu = fno_infer(net_cpu, x, policy, device="cpu").numpy()
    y_gpu = fno_infer(net_gpu, x, policy, device=cuda).cpu().numpy()
    if policy_name == "full":
        assert _rel_l2(y_gpu, y_cpu) <= 1e-5
    else:
        y_full = fno_infer(net_cpu, x, get_policy("full"), device="cpu").numpy()
        assert _rel_l2(y_gpu, y_cpu) <= 0.25 * _rel_l2(y_cpu, y_full)


def test_fused_trainer_two_steps_cuda_matches_cpu(cuda):
    """Two steps of the Trainer on FNO_DARCY_SMOKE through the fused path on
    both devices: losses within 1e-5 relative and parameters within 1e-4
    relative L2 under full; on the card one fused_fwd and one fused_bwd per
    layer and step and no dense launch."""
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.models import fno_apply
    from repro_torch.train import Trainer, TrainerConfig, relative_l2

    cfg = dataclasses.replace(FNO_DARCY_SMOKE, fuse_spectral=True)
    rng = np.random.RandomState(9)
    batches = [{"a": rng.randn(4, 1, 16, 16).astype(np.float32),
                "u": rng.randn(4, 1, 16, 16).astype(np.float32)} for _ in range(2)]

    def loss_fn(model, batch, policy):
        return relative_l2(fno_apply(model, batch["a"], policy), batch["u"])

    names = ("launches", "launches_bwd_x", "launches_bwd_w", "launches_fused_fwd",
             "launches_fused_bwd")
    net = init_fno(torch.Generator().manual_seed(2), cfg, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        tt = Trainer(loss_fn, net, TrainerConfig(
            total_steps=2, schedule=PrecisionSchedule.constant("full")), device=dev)
        c0 = [getattr(sc, n) for n in names]
        tt.run(lambda s: batches[s])
        torch.cuda.synchronize()
        runs[str(dev)] = (tt, tuple(getattr(sc, n) - c for n, c in zip(names, c0, strict=True)))
    cpu, gpu = runs["cpu"][0], runs[str(cuda)][0]
    assert runs["cpu"][1] == (0,) * 5
    assert runs[str(cuda)][1] == (0, 0, 0, 2 * cfg.n_layers, 2 * cfg.n_layers)
    for h_cpu, h_gpu in zip(cpu.history, gpu.history, strict=True):
        assert abs(h_gpu["loss"] - h_cpu["loss"]) <= 1e-5 * abs(h_cpu["loss"])
    for k, p in cpu.params.items():
        assert _rel_l2(gpu.params[k].detach().cpu().numpy(), p.detach().numpy()) <= 1e-4, k


# -- the CP-factorised contraction (TFNO) --------------------------------------------
#: operand dtypes of the CP kernels on the path
CP_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _cp_operands(B, I, O, R, M, dtype, device, seed=0):
    """x (B, I, M), U_i (I, R), U_o (O, R), W (R, M) and a cotangent
    (B, O, M) as re/im pairs at ``dtype``, scaled so the outputs are O(1)."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(B, I, M), (I, R), (O, R), (R, M), (B, O, M)]
    scale = [1.0, I ** -0.5, R ** -0.5, 1.0, 1.0]
    out = [s * torch.randn(*shape, generator=g) for shape, s in zip(shapes, scale, strict=True)
           for _ in range(2)]
    return [t.to(dtype).to(device) for t in out]


def _cp_budget_ok(got, want, mag, eps):
    budget = store_budget(eps, want.float(), mag.float())
    return bool(((got.float() - want.float()).abs() <= budget).all())


@pytest.mark.parametrize("shape", [(8, 64, 64, 64, 1764), (3, 24, 40, 17, 300),
                                   (11, 16, 16, 16, 64), (1, 1, 1, 1, 1), (9, 5, 7, 3, 33)])
@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_cp_kernels_match_plain_within_budget(cuda, shape, dtype):
    """cp_fwd and cp_bwd against their plain versions, every operand at
    ``dtype``: both sum in f32 from the same operands, so each output and
    gradient is within one rounding at ``dtype`` plus the f32 order of its
    magnitude contraction M (``store_budget``); B > 8 and ragged M
    included."""
    B, I, O, R, M = shape
    ops_ = _cp_operands(*shape, dtype, cuda)
    before = (sc.launches_cp_fwd, sc.launches_cp_bwd)
    out = sc._launch_cp_fwd(*ops_[:8])
    grads = sc._launch_cp_bwd(*ops_)
    torch.cuda.synchronize()
    assert (sc.launches_cp_fwd, sc.launches_cp_bwd) == (before[0] + 1, before[1] + 1)
    want_out = sc.spectral_contract_cp_plain(*ops_[:8])
    want_grads = sc.spectral_contract_cp_bwd_plain(*ops_)
    mags = sc.cp_magnitudes(*ops_)
    eps = FORMAT_EPS[dtype_name(dtype)]
    for got, want, name in zip((*out, *grads), (*want_out, *want_grads),
                               ("out", "out", "dx", "dx", "dU_i", "dU_i", "dU_o", "dU_o",
                                "dW", "dW"), strict=True):
        assert got.dtype == dtype and got.shape == want.shape, name
        assert _cp_budget_ok(got, want, mags[name], eps), name


def _check_cp_kernels(ops_, dtype):
    """cp_fwd and cp_bwd once each against their plain versions within
    ``store_budget``, which a zeroed output must exceed."""
    before = (sc.launches_cp_fwd, sc.launches_cp_bwd)
    got = (*sc._launch_cp_fwd(*ops_[:8]), *sc._launch_cp_bwd(*ops_))
    torch.cuda.synchronize()
    assert (sc.launches_cp_fwd, sc.launches_cp_bwd) == (before[0] + 1, before[1] + 1)
    want = (*sc.spectral_contract_cp_plain(*ops_[:8]), *sc.spectral_contract_cp_bwd_plain(*ops_))
    mags = sc.cp_magnitudes(*ops_)
    eps = FORMAT_EPS[dtype_name(dtype)]
    names = ("out", "out", "dx", "dx", "dU_i", "dU_i", "dU_o", "dU_o", "dW", "dW")
    for g, w, name in zip(got, want, names, strict=True):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _cp_budget_ok(g, w, mags[name], eps), name
        assert not _cp_budget_ok(torch.zeros_like(w), w, mags[name], eps), name


@pytest.mark.parametrize("width", [76, 105, 160])
@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_cp_kernels_match_plain_past_the_old_width_limits(cuda, width, dtype):
    """Just past where cp_bwd (76) and cp_fwd (105) refused before the
    channel tiling, and at 160: I = O = R = width, ragged M."""
    _check_cp_kernels(_cp_operands(3, width, width, width, 300, dtype, cuda, seed=width),
                      dtype)


def test_cp_channel_plans_match_the_kernels_smem(cuda):
    lib = sc._library_cp()
    for dtype in CP_DTYPES:
        size = torch.empty((), dtype=dtype).element_size()
        for resident in (True, False):
            assert lib.spectral_contract_cp_fwd_smem(sc._FMT[dtype], int(resident)) == \
                sc._cp_fwd_smem(size, resident)
    for width in (16, 64, 76, 105, 160, 256):
        for dtype in CP_DTYPES:
            plan = sc.cp_fwd_plan(width, width, width, dtype)
            assert lib.spectral_contract_cp_fwd_smem(sc._FMT[dtype], int(plan.resident)) == \
                plan.smem
    for dtype in CP_DTYPES:
        for R in (16, 64, 76, 160, 559, 784, 2048, 4096):
            plan = sc.cp_bwd_plan(R, R, R, dtype)
            assert lib.spectral_contract_cp_bwd_smem(sc._FMT[dtype]) == plan.smem
    lib = sc._library_ls()
    for dtype in CP_DTYPES:
        for K, N in ((1, 1), (64, 64), (139, 139), (140, 140), (192, 192), (200, 200),
                     (320, 64), (321, 64), (448, 64), (449, 64), (1000, 8), (8, 1000),
                     (3000, 3000)):
            plan = sc.ls_plan(K, N, dtype)
            assert lib.spectral_contract_ls_smem(K, sc._FMT[dtype], int(plan.resident)) == \
                plan.smem
            assert lib.spectral_contract_ls_smem(K, sc._FMT[dtype], int(not plan.resident)) == \
                sc._ls_smem(K, torch.empty((), dtype=dtype).element_size(), not plan.resident)


#: (B, I, O, M) where cp_fwd's design has edges: batch rows past one (1, 3, 9,
#: 17), the last mode tile ragged and rows off 16 bytes (M = 300, 1023 odd,
#: 1764), channels off the 16-wide mma tiles and past one 64-wide chunk
CP_FWD_EDGES = [(1, 24, 40, 1764), (3, 76, 105, 300), (9, 105, 76, 1023), (17, 40, 24, 300)]


@pytest.mark.parametrize("shape", CP_FWD_EDGES)
@pytest.mark.parametrize("R", [17, 64, 200, 784])
@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_cp_fwd_matches_plain_at_its_edges(cuda, shape, R, dtype):
    """cp_fwd (tensor cores and the exact split of u in half modes) against
    its plain version within ``store_budget``, which a zeroed output must
    exceed; the rank in one, four and thirteen 64-wide chunks."""
    B, I, O, M = shape
    ops_ = _cp_operands(B, I, O, R, M, dtype, cuda, seed=R + M)[:8]
    before = sc.launches_cp_fwd
    got = sc._launch_cp_fwd(*ops_)
    torch.cuda.synchronize()
    assert sc.launches_cp_fwd == before + 1
    want = sc.spectral_contract_cp_plain(*ops_)
    mag = sc.cp_magnitudes(*ops_)["out"]
    eps = FORMAT_EPS[dtype_name(dtype)]
    for g, w in zip(got, want, strict=True):
        assert g.dtype == dtype and g.shape == w.shape
        assert _cp_budget_ok(g, w, mag, eps)
        assert not _cp_budget_ok(torch.zeros_like(w), w, mag, eps)
    again = sc._launch_cp_fwd(*ops_)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))


@pytest.mark.parametrize("shape", CP_FWD_EDGES)
@pytest.mark.parametrize("R", [17, 64, 200, 600, 784])
@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_cp_bwd_matches_plain_at_its_edges(cuda, shape, R, dtype):
    """cp_bwd (tensor cores on exact bf16 pieces of its f32 operands) against
    its plain version within ``store_budget``, which a zeroed output must
    exceed: dx, dU_i, dU_o and dW; the rank in one, four, ten and thirteen
    64-wide chunks (600 and 784 past the old limit of 558), channels in one
    and two (the workspace path), ragged mode tiles; a rerun bit-identical."""
    B, I, O, M = shape
    ops_ = _cp_operands(B, I, O, R, M, dtype, cuda, seed=R + M + 1)
    before = sc.launches_cp_bwd
    got = sc._launch_cp_bwd(*ops_)
    torch.cuda.synchronize()
    assert sc.launches_cp_bwd == before + 1
    want = sc.spectral_contract_cp_bwd_plain(*ops_)
    mags = sc.cp_magnitudes(*ops_)
    eps = FORMAT_EPS[dtype_name(dtype)]
    for g, w, name in zip(got, want, ("dx", "dx", "dU_i", "dU_i", "dU_o", "dU_o", "dW", "dW"),
                          strict=True):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _cp_budget_ok(g, w, mags[name], eps), name
        assert not _cp_budget_ok(torch.zeros_like(w), w, mags[name], eps), name
    again = sc._launch_cp_bwd(*ops_)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))


#: (I, O, M) where the dense kernels' designs have edges: channels off
#: dense_bwd_w's 32-wide tiles and off the 8-wide channel tiles and ring
#: slots of dense_fwd and dense_bwd_x, the last mode tile ragged, rows off 16
#: bytes (M = 1023; M = 300 with a half g)
DENSE_BWD_W_EDGES = [(24, 40, 300), (76, 105, 1023), (105, 76, 1764)]


@pytest.mark.parametrize("B", [0, 1, 3, 9, 17])
@pytest.mark.parametrize("shape", DENSE_BWD_W_EDGES)
@pytest.mark.parametrize("cast_to,out_dtype", MODES)
def test_dense_bwd_w_matches_plain_at_its_edges(cuda, B, shape, cast_to, out_dtype):
    """dense_bwd_w against its plain version within ``contract_budget`` at
    ε_f32 of Σ_b |x||g|, which a zeroed output must exceed; B in one and
    several 4-row ring slots, and B = 0, where dw is zeros; a rerun
    bit-identical."""
    I, O, M = shape
    xr, xi, _, _ = _operands(B, I, 1, M, cuda, seed=B + M)
    gr, gi = _cotangent(B, O, M, out_dtype, cuda, seed=B + M + 1)
    before = sc.launches_bwd_w
    kr, ki = sc._launch_bwd_w(xr, xi, gr, gi, cast_to)
    torch.cuda.synchronize()
    assert sc.launches_bwd_w == before + 1
    pr, pi = sc.spectral_contract_bwd_w_plain(xr, xi, gr, gi, cast_to=cast_to)
    mag = torch.einsum("bim,bom->iom", torch.hypot(xr, xi), torch.hypot(gr.float(), gi.float()))
    budget = contract_budget(FORMAT_EPS["float32"], mag)
    assert kr.dtype == torch.float32 and kr.shape == pr.shape
    diff = torch.hypot(kr - pr, ki - pi)
    assert bool((diff <= budget).all()), float((diff - budget).max())
    if B == 0:
        assert not bool(kr.any()) and not bool(ki.any())
    else:
        assert not bool((torch.hypot(pr, pi) <= budget).all())
    again = sc._launch_bwd_w(xr, xi, gr, gi, cast_to)
    torch.cuda.synchronize()
    assert torch.equal(kr, again[0]) and torch.equal(ki, again[1])


@pytest.mark.parametrize("B", [0, 1, 3, 9, 17])
@pytest.mark.parametrize("shape", DENSE_BWD_W_EDGES)
@pytest.mark.parametrize("cast_to,out_dtype", MODES)
def test_dense_fwd_matches_plain_at_its_edges(cuda, B, shape, cast_to, out_dtype):
    """dense_fwd (a cp.async ring of 8-channel slots, 8-row batch tiles,
    16-byte copies where rows allow) against its plain version within
    ``contract_budget``, which a zeroed output must exceed; B in one and
    several batch tiles, and B = 0; channels off its 8-wide output tiles
    and 8-channel input slots, rows off 16 bytes (M = 1023); a rerun
    bit-identical."""
    I, O, M = shape
    xr, xi, wr, wi = _operands(B, I, O, M, cuda, seed=B + M + 2)
    before = sc.launches
    kr, ki = sc.spectral_contract_dense(xr, xi, wr, wi, cast_to=cast_to, out_dtype=out_dtype)
    torch.cuda.synchronize()
    pr, pi = sc.spectral_contract_plain(xr, xi, wr, wi, cast_to=cast_to, out_dtype=out_dtype)
    assert kr.dtype == out_dtype and kr.shape == pr.shape == (B, O, M)
    if B == 0:
        return
    assert sc.launches == before + 1
    budget = contract_budget(FORMAT_EPS[dtype_name(out_dtype)],
                             sc.contract_magnitude(xr, xi, wr, wi))
    diff = torch.hypot(kr.float() - pr.float(), ki.float() - pi.float())
    assert bool((diff <= budget).all()), float((diff - budget).max())
    assert not bool((torch.hypot(pr.float(), pi.float()) <= budget).all())
    again = sc.spectral_contract_dense(xr, xi, wr, wi, cast_to=cast_to, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(kr, again[0]) and torch.equal(ki, again[1])


@pytest.mark.parametrize("B", [0, 1, 3, 9, 17])
@pytest.mark.parametrize("shape", DENSE_BWD_W_EDGES)
@pytest.mark.parametrize("cast_to,out_dtype", MODES)
def test_dense_bwd_x_matches_plain_at_its_edges(cuda, B, shape, cast_to, out_dtype):
    """dense_bwd_x (dense_fwd's streaming design summing over o: a cp.async
    ring of 8-channel slots, g at its own width, 8-row batch tiles) against
    its plain version within ``contract_budget`` at ε_f32 of Σ_o |g||w|,
    which a zeroed output must exceed; B in one and several batch tiles, and
    B = 0; input channels off its 8-wide tiles, output channels off its
    8-channel slots, rows off 16 bytes (M = 1023, and M = 300 with a half
    g); a rerun bit-identical."""
    I, O, M = shape
    _, _, wr, wi = _operands(1, I, O, M, cuda, seed=B + M + 3)
    gr, gi = _cotangent(B, O, M, out_dtype, cuda, seed=B + M + 4)
    before = sc.launches_bwd_x
    kr, ki = sc._launch_bwd_x(gr, gi, wr, wi, cast_to)
    torch.cuda.synchronize()
    pr, pi = sc.spectral_contract_bwd_x_plain(gr, gi, wr, wi, cast_to=cast_to)
    assert kr.dtype == torch.float32 and kr.shape == pr.shape == (B, I, M)
    if B == 0:
        return
    assert sc.launches_bwd_x == before + 1
    mag = torch.einsum("bom,iom->bim", torch.hypot(gr.float(), gi.float()), torch.hypot(wr, wi))
    budget = contract_budget(FORMAT_EPS["float32"], mag)
    diff = torch.hypot(kr - pr, ki - pi)
    assert bool((diff <= budget).all()), float((diff - budget).max())
    assert not bool((torch.hypot(pr, pi) <= budget).all())
    again = sc._launch_bwd_x(gr, gi, wr, wi, cast_to)
    torch.cuda.synchronize()
    assert torch.equal(kr, again[0]) and torch.equal(ki, again[1])


@pytest.mark.parametrize("cast_to,out_dtype", MODES)
def test_dense_kernels_store_zeros_for_an_empty_sum(cuda, cast_to, out_dtype):
    """dense_fwd with I = 0 and dense_bwd_x with O = 0 sum nothing: their
    outputs are zeros, as the plain versions' are."""
    B, M = 3, 300
    xr, xi, wr, wi = _operands(B, 0, 5, M, cuda)
    out = sc.spectral_contract_dense(xr, xi, wr, wi, cast_to=cast_to, out_dtype=out_dtype)
    _, _, wr, wi = _operands(B, 5, 0, M, cuda)
    gr, gi = _cotangent(B, 0, M, out_dtype, cuda)
    dx = sc._launch_bwd_x(gr, gi, wr, wi, cast_to)
    torch.cuda.synchronize()
    assert [tuple(t.shape) for t in (*out, *dx)] == [(B, 5, M)] * 4
    assert not any(bool(t.any()) for t in (*out, *dx))


@pytest.mark.parametrize("kernel", ["bwd_x", "bwd_w"])
@pytest.mark.parametrize("M", [1024, 301])
@pytest.mark.parametrize("cast_to,g_dtype,edge", [
    (torch.bfloat16, torch.float16, [65504.0, -65440.0, 65472.0, 65409.0]),
    (torch.float16, torch.bfloat16, [65280.0, -65024.0, 257.0, 3.0e-5])])
def test_dense_bwd_w_rounds_a_half_g_onto_the_other_half(cuda, kernel, M, cast_to, g_dtype,
                                                          edge):
    """A g stored in one half format, rounded onto the other, in each
    backward kernel: an fp16 g in (65408, 65504] rounds to bf16 65536,
    which the kernel must keep finite, as the plain version does (a bf16 g
    onto fp16: the largest values fp16 holds, and one in its subnormal
    range); staged by cp.async (M = 1024) and element by element (M =
    301)."""
    B, I, O = 9, 24, 40
    xr, xi, wr, wi = _operands(B, I, O, M, cuda, seed=M)
    gr, gi = _cotangent(B, O, M, g_dtype, cuda, seed=M + 1)
    big = torch.tensor(edge).to(g_dtype)
    gr[:, :, :4] = big.to(cuda)
    gi[:, 3:5, 7:11] = big.flip(0).to(cuda)
    absg = torch.hypot(gr.float(), gi.float())
    if kernel == "bwd_x":
        kr, ki = sc._launch_bwd_x(gr, gi, wr, wi, cast_to)
        pr, pi = sc.spectral_contract_bwd_x_plain(gr, gi, wr, wi, cast_to=cast_to)
        mag = torch.einsum("bom,iom->bim", absg, torch.hypot(wr, wi))
    else:
        kr, ki = sc._launch_bwd_w(xr, xi, gr, gi, cast_to)
        pr, pi = sc.spectral_contract_bwd_w_plain(xr, xi, gr, gi, cast_to=cast_to)
        mag = torch.einsum("bim,bom->iom", torch.hypot(xr, xi), absg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(pr).all() and torch.isfinite(pi).all())
    assert bool(torch.isfinite(kr).all() and torch.isfinite(ki).all())
    budget = contract_budget(FORMAT_EPS["float32"], mag)
    diff = torch.hypot(kr - pr, ki - pi)
    assert bool((diff <= budget).all()), float((diff - budget).max())
    assert not bool((torch.hypot(pr, pi) <= budget).all())


@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_cp_kernels_rerun_bit_identically(cuda, dtype):
    ops_ = _cp_operands(8, 64, 64, 64, 1764, dtype, cuda, seed=3)
    runs = [(sc._launch_cp_fwd(*ops_[:8]), sc._launch_cp_bwd(*ops_)) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs, strict=True):
        assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))


@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_cp_contract_cuda_matches_cpu(cuda, dtype):
    """``CPContract`` on the card (cp_fwd, cp_bwd) against the same
    Function on the CPU (the plain versions): the outputs and all eight
    gradients, at ``dtype``."""
    shape = (5, 12, 9, 7, 130)
    ops_cpu = _cp_operands(*shape, dtype, "cpu", seed=6)
    results = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in ops_cpu[:8]]
        out = sc.CPContract.apply(*leaves)
        grads = torch.autograd.grad(out, leaves, [g.to(dev) for g in ops_cpu[8:]])
        results[str(dev)] = [t.detach().cpu() for t in (*out, *grads)]
    mags = sc.cp_magnitudes(*ops_cpu)
    eps = FORMAT_EPS[dtype_name(dtype)]
    names = ("out", "out", "dx", "dx", "dU_i", "dU_i", "dU_o", "dU_o", "dW", "dW")
    for got, want, name in zip(results[str(cuda)], results["cpu"], names, strict=True):
        assert got.dtype == dtype and _cp_budget_ok(got, want, mags[name], eps), name


def test_cp_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    ops_ = _cp_operands(2, 4, 3, 2, 16, torch.float32, cuda)[:8]
    with pytest.raises(ValueError, match="contiguous"):
        sc.CPContract.apply(ops_[0].transpose(0, 1).contiguous().transpose(0, 1),
                                *ops_[1:])
    with pytest.raises(ValueError, match="operands on"):
        sc.CPContract.apply(ops_[0].cpu(), *ops_[1:])
    with pytest.raises(TypeError):
        sc.CPContract.apply(*(t.double() for t in ops_))
    # the kernels tile the channel axes: I = O = R = 160, beyond what a
    # block held before, launches and agrees with the plain versions
    wide = _cp_operands(1, 160, 160, 160, 4, torch.float32, cuda)
    _check_cp_kernels(wide, torch.float32)
    # cp_bwd walks the rank in chunks too: R = 600, past its old limit of
    # 558, launches and agrees with the plain versions
    _check_cp_kernels(_cp_operands(1, 2, 2, 600, 4, torch.float32, cuda), torch.float32)


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_tfno_engine_launches_kernel_per_corner_and_layer(cuda, policy_name):
    """The full-width TFNO served at its smallest grid (84²): 8 cp_fwd
    launches per micro-batch (4 layers x 2 corners) and no dense launch;
    batched == solo bit for bit."""
    from repro_torch.configs.fno_paper import TFNO_NS

    policy = get_policy(policy_name)
    net = init_fno(torch.Generator().manual_seed(1), TFNO_NS, device=cuda)
    xs = _fields(84, 5, 9)
    engine = OperatorEngine(net, policy=policy, max_batch=4, device=cuda)
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(xs)]
    for r in reqs:
        engine.submit(r)
    dense, cp = sc.launches, sc.launches_cp_fwd
    engine.drain()
    torch.cuda.synchronize()
    assert engine.stats()["batches"] == 2
    assert (sc.launches - dense, sc.launches_cp_fwd - cp) == (0, 2 * 8)
    assert all(r.status == "done" and np.isfinite(r.y).all() for r in reqs)
    solo = OperatorEngine(net, policy=policy, max_batch=4, device=cuda)
    alone = FieldRequest(uid=0, x=xs[4])
    solo.submit(alone)
    solo.drain()
    assert np.array_equal(alone.y, reqs[4].y)


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16", "mixed_fno_fp16"])
def test_tfno_infer_cuda_matches_cpu(cuda, policy_name):
    from repro_torch.configs.fno_paper import TFNO_NS_SMOKE

    policy = get_policy(policy_name)
    x = np.stack(_fields(32, 3, 4))
    nets = {d: init_fno(torch.Generator().manual_seed(5), TFNO_NS_SMOKE, device=d)
            for d in ("cpu", cuda)}
    y_cpu = fno_infer(nets["cpu"], x, policy, device="cpu").numpy()
    y_gpu = fno_infer(nets[cuda], x, policy, device=cuda).cpu().numpy()
    if policy_name == "full":
        assert _rel_l2(y_gpu, y_cpu) <= 1e-5
    else:
        y_full = fno_infer(nets["cpu"], x, get_policy("full"), device="cpu").numpy()
        assert _rel_l2(y_gpu, y_cpu) <= 0.25 * _rel_l2(y_cpu, y_full)


def test_tfno_trainer_two_steps_cuda_matches_cpu(cuda):
    """Two steps of the port's Trainer on TFNO_NS_SMOKE with the H¹ loss,
    on the card and on the CPU, under ``full``: losses within 1e-5
    relative, parameters within 1e-4 relative L2, and cp_fwd and cp_bwd
    launched once per layer and corner per step."""
    from repro_torch.configs.fno_paper import TFNO_NS_SMOKE
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.models import fno_apply
    from repro_torch.train import Trainer, TrainerConfig, relative_h1

    cfg = TFNO_NS_SMOKE
    rng = np.random.RandomState(8)
    batches = [{"a": rng.randn(4, 1, 16, 16).astype(np.float32),
                "u": rng.randn(4, 1, 16, 16).astype(np.float32)} for _ in range(2)]

    def loss_fn(model, batch, policy):
        return relative_h1(fno_apply(model, batch["a"], policy), batch["u"])

    net = init_fno(torch.Generator().manual_seed(2), cfg, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        tt = Trainer(loss_fn, net, TrainerConfig(
            total_steps=2, schedule=PrecisionSchedule.constant("full")), device=dev)
        counts = (sc.launches_cp_fwd, sc.launches_cp_bwd)
        tt.run(lambda s: batches[s])
        torch.cuda.synchronize()
        runs[str(dev)] = (tt, (sc.launches_cp_fwd - counts[0], sc.launches_cp_bwd - counts[1]))
    cpu, gpu = runs["cpu"][0], runs[str(cuda)][0]
    per_step = cfg.n_layers * 2 ** (cfg.ndim - 1)
    assert runs["cpu"][1] == (0, 0)
    assert runs[str(cuda)][1] == (2 * per_step,) * 2
    for h_cpu, h_gpu in zip(cpu.history, gpu.history, strict=True):
        assert abs(h_gpu["loss"] - h_cpu["loss"]) <= 1e-5 * abs(h_cpu["loss"])
    for k, p in cpu.params.items():
        assert _rel_l2(gpu.params[k].detach().cpu().numpy(), p.detach().numpy()) <= 1e-4, k


def test_ns_solver_cuda_matches_cpu(cuda):
    """The NS solver on the card against the CPU at the reference test's
    sizes (n = 32, T = 1, 128 steps), cuFFT against pocketfft: within
    1e-5 relative L2."""
    from repro_torch.data import solve_ns_vorticity

    f = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32).astype(np.float32))
    want = solve_ns_vorticity(f, 32, T=1.0, steps=128)
    got = solve_ns_vorticity(f.to(cuda), 32, T=1.0, steps=128).cpu()
    assert _rel_l2(got.numpy(), want.numpy()) <= 1e-5


# -- the order-shared contraction (SFNO) ----------------------------------------------
def _ls_operands(B, I, O, L, M, dtype, device, seed=0):
    """x (B, I, L, M), w (I, O, L) and a cotangent (B, O, L, M) as re/im
    pairs at ``dtype``, scaled so the outputs are O(1)."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(B, I, L, M), (I, O, L), (B, O, L, M)]
    scale = [1.0, I ** -0.5, 1.0]
    out = [s * torch.randn(*shape, generator=g) for shape, s in zip(shapes, scale, strict=True)
           for _ in range(2)]
    return [t.to(dtype).to(device) for t in out]


@pytest.mark.parametrize("shape", [(8, 64, 64, 128, 128), (3, 5, 7, 37, 29),
                                   (1, 1, 1, 1, 1), (9, 17, 5, 33, 70), (2, 80, 70, 5, 40),
                                   (16, 20, 36, 9, 70)])
@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_lshared_kernels_match_plain_within_budget(cuda, shape, dtype):
    """ls_fwd, ls_bwd_x and ls_bwd_w against their plain versions, every
    operand at ``dtype``: each result within one rounding at ``dtype``
    plus the f32 order of its magnitude contraction (``store_budget``);
    B > 8, ragged L and M and more than one 64-channel tile included
    (B = 16 at M = 70: ls_bwd_w's (b, m) chunks, split over two warp
    groups, end on a ragged one)."""
    xr, xi, wr, wi, gr, gi = _ls_operands(*shape, dtype, cuda)
    before = (sc.launches_ls_fwd, sc.launches_ls_bwd_x, sc.launches_ls_bwd_w)
    got = {"out": sc._launch_ls_fwd(xr, xi, wr, wi), "dx": sc._launch_ls_bwd_x(gr, gi, wr, wi),
           "dw": sc._launch_ls_bwd_w(xr, xi, gr, gi)}
    torch.cuda.synchronize()
    assert (sc.launches_ls_fwd, sc.launches_ls_bwd_x, sc.launches_ls_bwd_w) == \
        tuple(b + 1 for b in before)
    want = {"out": sc.spectral_contract_lshared_plain(xr, xi, wr, wi),
            "dx": sc.spectral_contract_lshared_bwd_x_plain(gr, gi, wr, wi),
            "dw": sc.spectral_contract_lshared_bwd_w_plain(xr, xi, gr, gi)}
    mags = sc.lshared_magnitudes(xr, xi, wr, wi, gr, gi)
    eps = FORMAT_EPS[dtype_name(dtype)]
    for name, pair in got.items():
        for g, w in zip(pair, want[name], strict=True):
            assert g.dtype == dtype and g.shape == w.shape, name
            assert _cp_budget_ok(g, w, mags[name], eps), name


def _check_ls_kernels(ops_, dtype):
    """ls_fwd, ls_bwd_x and ls_bwd_w once each against their plain versions
    within ``store_budget``, which a zeroed result must exceed."""
    xr, xi, wr, wi, gr, gi = ops_
    got = {"out": sc._launch_ls_fwd(xr, xi, wr, wi), "dx": sc._launch_ls_bwd_x(gr, gi, wr, wi),
           "dw": sc._launch_ls_bwd_w(xr, xi, gr, gi)}
    torch.cuda.synchronize()
    want = {"out": sc.spectral_contract_lshared_plain(xr, xi, wr, wi),
            "dx": sc.spectral_contract_lshared_bwd_x_plain(gr, gi, wr, wi),
            "dw": sc.spectral_contract_lshared_bwd_w_plain(xr, xi, gr, gi)}
    mags = sc.lshared_magnitudes(xr, xi, wr, wi, gr, gi)
    eps = FORMAT_EPS[dtype_name(dtype)]
    for name, pair in got.items():
        for g, w in zip(pair, want[name], strict=True):
            assert g.dtype == dtype and g.shape == w.shape, name
            assert _cp_budget_ok(g, w, mags[name], eps), name
            assert not _cp_budget_ok(torch.zeros_like(w), w, mags[name], eps), name


@pytest.mark.parametrize("I,O", [(140, 140), (200, 200), (300, 72), (72, 300)])
@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_lshared_kernels_match_plain_past_the_old_width_limit(cuda, I, O, dtype):
    """From I = O = 140, where ls_fwd and ls_bwd_x refused before the
    channel tiling, and with one side wide: ragged L and M."""
    _check_ls_kernels(_ls_operands(2, I, O, 5, 70, dtype, cuda, seed=I + O), dtype)


@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_lshared_kernels_rerun_bit_identically(cuda, dtype):
    xr, xi, wr, wi, gr, gi = _ls_operands(8, 64, 64, 128, 128, dtype, cuda, seed=3)
    runs = [(sc._launch_ls_fwd(xr, xi, wr, wi), sc._launch_ls_bwd_x(gr, gi, wr, wi),
             sc._launch_ls_bwd_w(xr, xi, gr, gi)) for _ in range(2)]
    torch.cuda.synchronize()
    for first, second in zip(*runs, strict=True):
        assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))


@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_lshared_contract_cuda_matches_cpu(cuda, dtype):
    """``LSharedContract`` on the card (ls_fwd, ls_bwd_x, ls_bwd_w) against
    the same Function on the CPU (the plain versions): the outputs and the
    four gradients, at ``dtype``, within ``store_budget``."""
    ops_cpu = _ls_operands(5, 12, 9, 21, 30, dtype, "cpu", seed=6)
    results = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in ops_cpu[:4]]
        out = sc.LSharedContract.apply(*leaves)
        grads = torch.autograd.grad(out, leaves, [g.to(dev) for g in ops_cpu[4:]])
        results[str(dev)] = [t.detach().cpu() for t in (*out, *grads)]
    mags = sc.lshared_magnitudes(*ops_cpu)
    eps = FORMAT_EPS[dtype_name(dtype)]
    names = ("out", "out", "dx", "dx", "dw", "dw")
    for got, want, name in zip(results[str(cuda)], results["cpu"], names, strict=True):
        assert got.dtype == dtype and _cp_budget_ok(got, want, mags[name], eps), name


#: ls_mix's plans: the path, ragged orders and channels, few degrees (the
#: outputs split among blocks), 140 and 200 channels, LS_WIDE_SHAPE, and
#: 1000 input channels (the weight streamed a chunk a stage) or 1000 output
#: channels (16 channel tiles)
LS_MIX_SHAPES = [(8, 64, 64, 128, 128), (3, 5, 7, 37, 29), (16, 20, 36, 9, 70),
                 (2, 140, 140, 5, 70), (2, 200, 200, 5, 64), (8, 192, 192, 64, 64),
                 (2, 1000, 8, 3, 70), (2, 8, 1000, 3, 136)]


@pytest.mark.parametrize("shape", LS_MIX_SHAPES)
@pytest.mark.parametrize("dtype", CP_DTYPES)
def test_ls_mix_matches_plain_at_every_plan(cuda, shape, dtype):
    """ls_fwd and ls_bwd_x (``ls_mix``) against their plain versions within
    ``store_budget``, which a zeroed result must exceed, and a rerun bit for
    bit, for every kind of plan ``ls_plan`` makes."""
    xr, xi, wr, wi, gr, gi = _ls_operands(*shape, dtype, cuda, seed=sum(shape))
    runs = [{"out": sc._launch_ls_fwd(xr, xi, wr, wi),
             "dx": sc._launch_ls_bwd_x(gr, gi, wr, wi)} for _ in range(2)]
    torch.cuda.synchronize()
    want = {"out": sc.spectral_contract_lshared_plain(xr, xi, wr, wi),
            "dx": sc.spectral_contract_lshared_bwd_x_plain(gr, gi, wr, wi)}
    mags = sc.lshared_magnitudes(xr, xi, wr, wi, gr, gi)
    eps = FORMAT_EPS[dtype_name(dtype)]
    for name, pair in runs[0].items():
        for g, again, w in zip(pair, runs[1][name], want[name], strict=True):
            assert g.dtype == dtype and g.shape == w.shape, name
            assert _cp_budget_ok(g, w, mags[name], eps), name
            assert not _cp_budget_ok(torch.zeros_like(w), w, mags[name], eps), name
            assert torch.equal(g, again), name


def test_ls_mix_refuses_a_plan_that_does_not_fit(cuda):
    """The weight of 1000 input channels resident would overflow a block's
    shared memory: the launcher refuses before launch, it does not fall
    back."""
    xr, xi, wr, wi, _, _ = _ls_operands(1, 1000, 8, 2, 16, torch.bfloat16, cuda)
    out = [torch.empty(1, 8, 2, 16, dtype=torch.bfloat16, device=cuda) for _ in range(2)]
    lib = sc._library_ls()
    with torch.cuda.device(cuda):
        rc = lib.spectral_contract_ls_fwd(*(t.data_ptr() for t in (xr, xi, wr, wi, *out)),
                                          1, 1000, 8, 2, 16, 1, 1, sc._FMT[torch.bfloat16],
                                          torch.cuda.current_stream().cuda_stream)
    assert rc == -2


def test_lshared_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    xr, xi, wr, wi, _, _ = _ls_operands(2, 4, 3, 5, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sc.LSharedContract.apply(xr.transpose(2, 3).contiguous().transpose(2, 3), xi, wr, wi)
    with pytest.raises(ValueError, match="operands on"):
        sc.LSharedContract.apply(xr.cpu(), xi, wr, wi)
    with pytest.raises(TypeError, match="one dtype"):
        sc.LSharedContract.apply(xr.half(), xi, wr, wi)
    with pytest.raises(TypeError):
        sc.LSharedContract.apply(*(t.double() for t in (xr, xi, wr, wi)))
    # ls_mix tiles the channel axes: I = O = 200, beyond the weight slice a
    # block held before, launches and agrees with the plain versions
    _check_ls_kernels(_ls_operands(1, 200, 200, 2, 4, torch.float32, cuda), torch.float32)


@pytest.mark.parametrize("nlon,mmax", [(64, 16), (32, 17)])
def test_sht_inverse_cuda_matches_cpu_on_a_complex_zero_order(cuda, nlon, mmax):
    """A spectrum whose m = 0 column (and, at mmax = nlon/2 + 1, Nyquist
    column) is complex, as the contraction leaves it: cuFFT's synthesis on
    the card agrees with pocketfft's on the CPU (1e-5 relative L2), which
    reads only those bins' real parts."""
    from repro_torch.models import sht_inverse

    g = torch.Generator().manual_seed(11)
    c = torch.complex(torch.randn(3, 4, 16, mmax, generator=g),
                      torch.randn(3, 4, 16, mmax, generator=g))
    assert float(c[..., 0].imag.abs().min()) > 0
    want = sht_inverse(c, 32, nlon).numpy()
    got = sht_inverse(c.to(cuda), 32, nlon).cpu().numpy()
    assert _rel_l2(got, want) <= 1e-5


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16", "mixed_fno_fp16"])
def test_sfno_infer_cuda_matches_cpu(cuda, policy_name):
    """SFNO_SWE_SMOKE on the card against the CPU, same weights: 1e-5
    relative L2 under ``full``; under a half policy half the CPU's own gap
    between the AMP policy of the same half dtype and ``full``, which
    leaves the tanh out (the card's other FFT and GEMM last bits carry
    through the half roundings of every layer: chip_smoke.py's SFNO phase
    states why half)."""
    from repro_torch.configs.fno_paper import SFNO_SWE_SMOKE
    from repro_torch.models import init_sfno, sfno_infer

    policy = get_policy(policy_name)
    x = np.random.RandomState(4).randn(3, 3, 16, 32).astype(np.float32)
    nets = {d: init_sfno(torch.Generator().manual_seed(5), SFNO_SWE_SMOKE, device=d)
            for d in ("cpu", cuda)}
    y_cpu = sfno_infer(nets["cpu"], x, policy, device="cpu").numpy()
    y_gpu = sfno_infer(nets[cuda], x, policy, device=cuda).cpu().numpy()
    if policy_name == "full":
        assert _rel_l2(y_gpu, y_cpu) <= 1e-5
    else:
        amp = get_policy("amp_bf16" if "bf16" in policy_name else "amp_fp16")
        gap = _rel_l2(sfno_infer(nets["cpu"], x, amp, device="cpu").numpy(),
                      sfno_infer(nets["cpu"], x, get_policy("full"), device="cpu").numpy())
        assert _rel_l2(y_gpu, y_cpu) <= 0.5 * gap


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_sfno_engine_launches_ls_fwd_per_layer(cuda, policy_name):
    """The full-width SFNO served: one ls_fwd launch per layer and
    micro-batch and no dense or CP launch; batched == solo bit for bit."""
    from repro_torch.configs.fno_paper import SFNO_SWE
    from repro_torch.models import init_sfno

    policy = get_policy(policy_name)
    net = init_sfno(torch.Generator().manual_seed(1), SFNO_SWE, device=cuda)
    rng = np.random.RandomState(9)
    xs = [rng.randn(3, 256, 512).astype(np.float32) for _ in range(5)]
    engine = OperatorEngine(net, model="sfno", policy=policy, max_batch=4, device=cuda)
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(xs)]
    for r in reqs:
        engine.submit(r)
    before = (sc.launches, sc.launches_cp_fwd, sc.launches_ls_fwd)
    engine.drain()
    torch.cuda.synchronize()
    assert engine.stats()["batches"] == 2
    after = (sc.launches, sc.launches_cp_fwd, sc.launches_ls_fwd)
    assert tuple(a - b for a, b in zip(after, before)) == (0, 0, 2 * SFNO_SWE.n_layers)
    assert all(r.status == "done" and r.y.shape == (3, 256, 512) and np.isfinite(r.y).all()
               for r in reqs)
    solo = OperatorEngine(net, model="sfno", policy=policy, max_batch=4, device=cuda)
    alone = FieldRequest(uid=0, x=xs[4])
    solo.submit(alone)
    solo.drain()
    assert np.array_equal(alone.y, reqs[4].y)


def test_sfno_trainer_two_steps_cuda_matches_cpu(cuda):
    """Two steps of the port's Trainer on SFNO_SWE_SMOKE with the relative
    L² loss, on the card and on the CPU, under ``full``: losses within
    1e-5 relative, parameters within 1e-4 relative L2, and ls_fwd,
    ls_bwd_x and ls_bwd_w launched once per layer per step."""
    from repro_torch.configs.fno_paper import SFNO_SWE_SMOKE
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.models import init_sfno, sfno_apply
    from repro_torch.train import Trainer, TrainerConfig, relative_l2

    cfg = SFNO_SWE_SMOKE
    rng = np.random.RandomState(8)
    batches = [{"x": rng.randn(4, 3, 16, 32).astype(np.float32),
                "y": rng.randn(4, 3, 16, 32).astype(np.float32)} for _ in range(2)]

    def loss_fn(model, batch, policy):
        return relative_l2(sfno_apply(model, batch["x"], policy), batch["y"])

    def ls_counts():
        return (sc.launches_ls_fwd, sc.launches_ls_bwd_x, sc.launches_ls_bwd_w)

    net = init_sfno(torch.Generator().manual_seed(2), cfg, device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        tt = Trainer(loss_fn, net, TrainerConfig(
            total_steps=2, schedule=PrecisionSchedule.constant("full")), device=dev)
        counts = ls_counts()
        tt.run(lambda s: batches[s])
        torch.cuda.synchronize()
        runs[str(dev)] = (tt, tuple(b - a for a, b in zip(counts, ls_counts())))
    cpu, gpu = runs["cpu"][0], runs[str(cuda)][0]
    assert runs["cpu"][1] == (0, 0, 0)
    assert runs[str(cuda)][1] == (2 * cfg.n_layers,) * 3
    for h_cpu, h_gpu in zip(cpu.history, gpu.history, strict=True):
        assert abs(h_gpu["loss"] - h_cpu["loss"]) <= 1e-5 * abs(h_cpu["loss"])
    for k, p in cpu.params.items():
        assert _rel_l2(gpu.params[k].detach().cpu().numpy(), p.detach().numpy()) <= 1e-4, k


def test_swe_solver_cuda_matches_cpu(cuda):
    """The shallow-water solver on the card against the CPU at 32x64 for
    40 steps (cuFFT and cuBLAS against pocketfft and the CPU's GEMMs):
    within 1e-5 relative L2 per field."""
    from repro_torch.data import grf_sphere, solve_swe_linear

    phi0 = grf_sphere(torch.Generator().manual_seed(0), 32, 64, batch=2) * 1e2
    want = solve_swe_linear(phi0, 32, 64, steps=40)
    got = solve_swe_linear(phi0.to(cuda), 32, 64, steps=40)
    for g, w in zip(got, want, strict=True):
        assert _rel_l2(g.cpu().numpy(), w.numpy()) <= 1e-5


# -- the LM pool's RMSNorm and flash attention ------------------------------------------
def _ulp(t):
    """The spacing of ``t``'s dtype above |t|, as f32."""
    a = t.abs()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).float()


def _rmsnorm_ok(got, want):
    """f32: 1e-6 relative per element; half: >= 99.9 % bit-equal and every
    element within one ulp of the dtype (the sums' order differs)."""
    g, w = got.float(), want.float()
    if want.dtype == torch.float32:
        return bool(((g - w).abs() <= 1e-6 * w.abs() + 1e-30).all())
    return (g == w).float().mean().item() >= 0.999 and bool(((g - w).abs() <= _ulp(want)).all())


@pytest.mark.parametrize("N,D", [(1, 16), (8, 100), (300, 960), (300, 6144), (257, 4096),
                                 (1, 1), (3, 7), (1, 960), (301, 961), (9, 2048), (1, 6144),
                                 (5, 6145), (301, 6145)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_rmsnorm_kernel_matches_plain(cuda, N, D, dtype):
    g = torch.Generator().manual_seed(N + D)
    x = torch.randn(N, D, generator=g).to(dtype).to(cuda)
    w = (torch.rand(D, generator=g) + 0.5).to(dtype).to(cuda)
    before = rn.launches_rmsnorm
    got = rn.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rn.launches_rmsnorm == before + 1
    want = rn.rmsnorm_plain(x, w)
    assert got.dtype == dtype and got.shape == (N, D)
    assert _rmsnorm_ok(got, want)
    assert not _rmsnorm_ok(torch.zeros_like(want), want)
    assert torch.equal(got, rn.rmsnorm(x, w))


RMS_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("xdtype", RMS_DTYPES)
@pytest.mark.parametrize("wdtype", RMS_DTYPES)
@pytest.mark.parametrize("D", [960, 961, 6144])
def test_rmsnorm_kernel_takes_a_weight_of_another_dtype(cuda, xdtype, wdtype, D):
    """Every x/w dtype pair, through 16-byte packs (960, 6144) and one
    element a lane (961)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(64, D, generator=g).to(xdtype).to(cuda)
    w = (torch.rand(D, generator=g) + 0.5).to(wdtype).to(cuda)
    got = ops.rmsnorm(x.reshape(4, 16, D), w)
    want = rn.rmsnorm_plain(x, w)
    assert got.dtype == xdtype and _rmsnorm_ok(got.reshape(64, D), want)
    assert not _rmsnorm_ok(torch.zeros_like(want), want)
    assert torch.equal(got, ops.rmsnorm(x.reshape(4, 16, D), w))


@pytest.mark.parametrize("dtype", RMS_DTYPES)
@pytest.mark.parametrize("which", ["x", "w"])
def test_rmsnorm_kernel_takes_an_operand_off_16_bytes(cuda, dtype, which):
    """A contiguous view 2 bytes (one half; 4 bytes in f32) into its storage
    takes the one-element path and matches; the launcher refuses 16-byte
    packs on it."""
    g = torch.Generator().manual_seed(5)
    N, D = 37, 960
    x = torch.randn(N, D, generator=g).to(dtype)
    w = (torch.rand(D, generator=g) + 0.5).to(dtype)
    base = (x if which == "x" else w).reshape(-1)
    shifted = torch.empty(base.numel() + 1, dtype=dtype, device=cuda)[1:]
    shifted.copy_(base)
    x, w = x.to(cuda), w.to(cuda)
    if which == "x":
        x = shifted.view(N, D)
    else:
        w = shifted
    assert not rn.rmsnorm_plan(D, x.dtype, w.dtype, False).vec
    got = rn.rmsnorm(x, w)
    want = rn.rmsnorm_plain(x, w)
    assert _rmsnorm_ok(got, want) and not _rmsnorm_ok(torch.zeros_like(want), want)
    assert torch.equal(got, rn.rmsnorm(x, w))
    y = torch.empty_like(x)
    with torch.cuda.device(cuda):
        rc = rn._library().rmsnorm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), N, D,
                                       rn._FMT[dtype], rn._FMT[dtype], 1, 8, 1, 1, 1e-6,
                                       torch.cuda.current_stream().cuda_stream)
    assert rc == -2


def _flash_operands(BH, S, Sk, D, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(BH, n, D, generator=g).to(dtype).to(device) for n in (S, Sk, Sk)]


def _flash_ok(got, plain, oracle):
    """f32: 1e-5 relative L2 to the plain version; half: a quarter of the
    plain version's gap to the oracle.  Returns (ok, error, limit)."""
    err = _rel_l2(got.float().cpu(), plain.float().cpu())
    limit = 1e-5 if plain.dtype == torch.float32 else \
        0.25 * _rel_l2(plain.float().cpu(), oracle.float().cpu())
    return err <= limit, err, limit


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,Sk", [(256, 256), (300, 333), (333, 200), (1, 130), (17, 17),
                                  (100, 700)])
def test_flash_kernel_matches_plain(cuda, D, dtype, causal, S, Sk):
    """The kernel against the plain version at the default kv block of
    128, aligned and unaligned lengths, S != Sk (under ``causal``, Sk > S
    leaves whole kv blocks masked), one and 17 queries (a block's warps
    past S); a rerun is bit-identical and a zeroed output falls outside
    the limit."""
    q, k, v = _flash_operands(3, S, Sk, D, dtype, cuda, seed=S + Sk + D)
    before = fa.launches_flash
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches_flash == before + 1
    assert got.dtype == dtype and got.shape == (3, S, D)
    plain = fa.flash_attention_plain(q, k, v, causal=causal)
    oracle = kref.flash_attention_ref(q, k, v, causal=causal)
    ok, err, limit = _flash_ok(got, plain, oracle)
    assert ok, (err, limit)
    assert not _flash_ok(torch.zeros_like(plain), plain, oracle)[0]
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("block_k", [32, 64, 8, 24, 40, 120])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_kernel_follows_the_kv_block(cuda, block_k, dtype):
    """p is rounded against its kv block's max: the kernel at block_k
    agrees with the plain version at the same block_k, also where the
    block is not a multiple of 16 and its last p.v step is padded."""
    q, k, v = _flash_operands(2, 200, 200, 64, dtype, cuda, seed=block_k)
    got = ops.flash_attention(q[None], k[None], v[None], causal=True, block_k=block_k)[0]
    plain = fa.flash_attention_plain(q, k, v, causal=True, block_k=block_k)
    ok, err, limit = _flash_ok(got, plain, kref.flash_attention_ref(q, k, v, causal=True))
    assert ok, (err, limit)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_half_kernel_at_head_dim_128_over_many_kv_blocks(cuda, dtype):
    """D = 128 (8 warps a block) at S = Sk = 2048: 16 kv blocks, causal
    skips of whole blocks and of warps; within the yardstick, which a
    zeroed output fails, and a rerun is bit-identical."""
    q, k, v = _flash_operands(2, 2048, 2048, 128, dtype, cuda, seed=128)
    got = fa.flash_attention(q, k, v, causal=True)
    plain = fa.flash_attention_plain(q, k, v, causal=True)
    oracle = kref.flash_attention_ref(q, k, v, causal=True)
    ok, err, limit = _flash_ok(got, plain, oracle)
    assert ok, (err, limit)
    assert not _flash_ok(torch.zeros_like(plain), plain, oracle)[0]
    assert torch.equal(got, fa.flash_attention(q, k, v, causal=True))


def test_flash_wrapper_rejects_misaligned_operands(cuda):
    """The half-mode kernel copies K and V 16 bytes at a time: an operand
    that does not start on 16 bytes is refused before launch."""
    q, k, v = _flash_operands(2, 64, 64, 64, torch.bfloat16, cuda)
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)[1:].view_as(k)
    shifted.copy_(k)
    before = fa.launches_flash
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q, shifted, v)
    assert fa.launches_flash == before


def test_lm_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, k, v = _flash_operands(2, 64, 64, 64, torch.float32, cuda)
    x = torch.randn(4, 32, device=cuda)
    w = torch.ones(32, device=cuda)
    before = (fa.launches_flash, rn.launches_rmsnorm)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention(q, k.half(), v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="operands on"):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(*_flash_operands(2, 64, 64, 48, torch.float32, cuda))
    with pytest.raises(ValueError, match="block_k"):
        fa.flash_attention(q, k, v, block_k=256)
    with pytest.raises(TypeError):
        rn.rmsnorm(x.double(), w)
    with pytest.raises(ValueError, match="contiguous"):
        rn.rmsnorm(torch.randn(32, 4, device=cuda).T, w)
    with pytest.raises(ValueError, match="operands on"):
        rn.rmsnorm(x, w.cpu())
    assert (fa.launches_flash, rn.launches_rmsnorm) == before


# -- GINO: the car shapes' KNN, the 3-D latent FNO, the decoder's gather --------------
def _gino_cfgs():
    from repro_torch.configs.fno_paper import GINO_CAR_SMOKE

    fno = GINO_CAR_SMOKE.fno
    return {"staged": (dataclasses.replace(GINO_CAR_SMOKE, fno=dataclasses.replace(
                           fno, fuse_spectral=False)),) * 2,
            "fused": (GINO_CAR_SMOKE, dataclasses.replace(GINO_CAR_SMOKE, fno=dataclasses.replace(
                          fno, fuse_spectral=True)))}


def test_car_knn_cuda_equals_cpu(cuda):
    """The car sampler's brute-force KNN on the card against the same
    function on the CPU: indices and masks equal, every other array too."""
    from repro_torch.data import sample_car_batch

    got, labels = sample_car_batch(3, 2, n_points=700, latent_grid=16, k=8, device=cuda)
    want, want_labels = sample_car_batch(3, 2, n_points=700, latent_grid=16, k=8, device="cpu")
    for name, w in want.items():
        assert got[name].device.type == "cuda" and torch.equal(got[name].cpu(), w), name
    assert torch.equal(labels.cpu(), want_labels)


@pytest.mark.parametrize("path", ["staged", "fused"])
@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_gino_cuda_matches_cpu(cuda, path, policy_name):
    """GINO_CAR_SMOKE on the card against the CPU, the same weights and
    car shapes, staged on both devices or fused on both (the CPU told
    ``fuse_spectral=True``): 1e-5 relative L2 under full, a quarter of the
    CPU's own gap to full under mixed_fno_bf16; the card launches one
    ``fused_fwd`` per layer and batch tile, or one dense forward per corner
    and layer, and nothing else; a sample alone gets its batched answer
    within 1e-6 under full, a quarter of the gap under mixed_fno_bf16 (not
    bit for bit: cuBLAS picks its GEMM by the row count, so the pointwise
    layers sum in another order at batch 1)."""
    from repro_torch.data import sample_car_batch
    from repro_torch.models import gino_apply, init_gino

    gpu_cfg, cpu_cfg = _gino_cfgs()[path]
    policy = get_policy(policy_name)
    batch, _ = sample_car_batch(4, 3, n_points=96, latent_grid=gpu_cfg.latent_grid,
                                k=gpu_cfg.k_neighbors, device="cpu")
    net_gpu = init_gino(torch.Generator().manual_seed(6), gpu_cfg, device=cuda)
    net_cpu = init_gino(torch.Generator().manual_seed(6), cpu_cfg, device="cpu")
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    counters = ("launches", "launches_fused_fwd", "launches_fused_bwd", "launches_bwd_x",
                "launches_bwd_w")
    before = [getattr(sc, n) for n in counters]
    with torch.no_grad():
        y_gpu = gino_apply(net_gpu, on_card, policy)
        torch.cuda.synchronize()
        moved = [getattr(sc, n) - b for n, b in zip(counters, before, strict=True)]
        layers, grid = gpu_cfg.fno.n_layers, (gpu_cfg.latent_grid,) * 3
        C = gpu_cfg.fno.hidden_channels
        tiles = -(-3 // sc.pick_block_b(3, C, C, grid, gpu_cfg.fno.modes))
        assert moved == ([4 * layers, 0, 0, 0, 0] if path == "staged"
                         else [0, tiles * layers, 0, 0, 0])
        y_cpu = gino_apply(net_cpu, batch, policy).numpy()
        err = _rel_l2(y_gpu.cpu().numpy(), y_cpu)
        if policy_name == "full":
            assert err <= 1e-5, err
        else:
            full = gino_apply(net_cpu, batch, get_policy("full")).numpy()
            assert err <= 0.25 * _rel_l2(y_cpu, full), err
        alone = torch.cat([gino_apply(net_gpu, {k: v[b:b + 1] for k, v in on_card.items()},
                                      policy) for b in range(3)])
        gap = _rel_l2(y_gpu.cpu().numpy(),
                      gino_apply(net_gpu, on_card, get_policy("full")).cpu().numpy())
        limit = 1e-6 if policy_name == "full" else 0.25 * gap
        assert _rel_l2(alone.cpu().numpy(), y_gpu.cpu().numpy()) <= limit


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_gino_backward_is_bit_reproducible(cuda, path):
    """Two identical backward passes of GINO on the card give bit-identical
    gradients: the decoder's gather, whose backward accumulates each latent
    node's cotangent from its query points (``index_put_`` with
    ``accumulate=True``, sorted on CUDA), and the spectral kernels' VJPs.
    A 6³ latent grid of 16 channels, 8 neighbours per point, 600 points:
    each latent node gathers from many points."""
    from repro_torch.data import sample_car_batch
    from repro_torch.models import FNOConfig, GINOConfig, gino_apply, init_gino
    from repro_torch.train import relative_l2

    cfg = GINOConfig(hidden=16, latent_grid=6, k_neighbors=8, fno=FNOConfig(
        in_channels=16, out_channels=16, hidden_channels=16, lifting_channels=16,
        projection_channels=16, n_layers=2, modes=(3, 3, 3), positional_embedding=False,
        fuse_spectral=path == "fused"))
    batch, labels = sample_car_batch(8, 2, n_points=600, latent_grid=6, k=8, device=cuda)
    net = init_gino(torch.Generator().manual_seed(7), cfg, device=cuda)
    params = list(net.parameters())
    grads = []
    for _ in range(2):
        loss = relative_l2(gino_apply(net, batch, get_policy("mixed_fno_bf16")), labels)
        grads.append(torch.autograd.grad(loss, params))
    torch.cuda.synchronize()
    for (name, _), a, b in zip(net.named_parameters(), *grads, strict=True):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b), name



@pytest.mark.parametrize("policy_name", ["full", "amp_bf16"])
def test_unet_backward_is_bit_reproducible(cuda, policy_name):
    """Two identical backward passes of ``UNET_BASELINE`` on the card give
    bit-identical gradients (the convolutions' backward runs with cuDNN's
    deterministic algorithms; by default the f32 ones differed), and the
    global ``cudnn.deterministic`` flag is as it was.  4 Darcy-sized
    fields at 128²."""
    from repro_torch.configs.fno_paper import UNET_BASELINE
    from repro_torch.models import init_unet, unet_apply
    from repro_torch.train import relative_l2

    g = torch.Generator().manual_seed(3)
    x = torch.rand(4, 1, 128, 128, generator=g).to(cuda)
    y = torch.randn(4, 1, 128, 128, generator=g).to(cuda)
    net = init_unet(torch.Generator().manual_seed(4), UNET_BASELINE, device=cuda)
    params = list(net.parameters())
    flag = torch.backends.cudnn.deterministic
    grads = []
    for _ in range(2):
        loss = relative_l2(unet_apply(net, x, get_policy(policy_name)), y)
        grads.append(torch.autograd.grad(loss, params))
    torch.cuda.synchronize()
    assert torch.backends.cudnn.deterministic == flag
    for (name, _), a, b in zip(net.named_parameters(), *grads, strict=True):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b), name

# -- auto-precision ----------------------------------------------------------------------
def _counts():
    return {k: getattr(sc, k) for k in ("launches", "launches_bwd_x", "launches_bwd_w",
                                        "launches_fused_fwd", "launches_fused_bwd")}


def _zero_counts():
    for k in _counts():
        setattr(sc, k, 0)


@pytest.mark.parametrize("fuse", [None, True])
def test_collector_vetoes_the_fused_kernels(cuda, fuse):
    """FNO_DARCY_SMOKE on the card with ``fuse_spectral`` None (fused by
    default) or True: a forward and backward under a collector launch no
    fused kernel and the staged dense ones; without it the layer fuses."""
    from repro_torch.autoprec import TraceCollector, collecting
    from repro_torch.models import fno_apply

    cfg = dataclasses.replace(FNO_DARCY_SMOKE, fuse_spectral=fuse)
    net = init_fno(torch.Generator().manual_seed(1), cfg, device=cuda)
    x = torch.from_numpy(np.stack(_fields(24, 2, 9))).to(cuda)
    params = list(net.parameters())
    pol = get_policy("mixed_fno_bf16")
    col = TraceCollector()
    _zero_counts()
    with collecting(col):
        y = fno_apply(net, x, pol)
    torch.autograd.grad(y.square().mean(), params)
    torch.cuda.synchronize()
    under = _counts()
    _zero_counts()
    y = fno_apply(net, x, pol)
    torch.autograd.grad(y.square().mean(), params)
    torch.cuda.synchronize()
    without = _counts()
    per = cfg.n_layers * 2 ** (cfg.ndim - 1)
    assert under == {"launches": per, "launches_bwd_x": per, "launches_bwd_w": per,
                     "launches_fused_fwd": 0, "launches_fused_bwd": 0}
    assert without["launches_fused_fwd"] == without["launches_fused_bwd"] == cfg.n_layers
    assert without["launches"] == 0
    assert {"fno/layer0/spectral/fft_in", "fno/layer0/spectral/contract"} <= set(col.snapshot())


def _card_models():
    from repro_torch.configs.fno_paper import SFNO_SWE_SMOKE, TFNO_NS_SMOKE

    return {"darcy": (FNO_DARCY_SMOKE, (2, 1, 24, 24)), "tfno": (TFNO_NS_SMOKE, (2, 1, 24, 24)),
            "sfno": (SFNO_SWE_SMOKE, (2, 3, 16, 32))}


def _totals(name, device, policy):
    from repro_torch.autoprec import TelemetryAggregator, TraceCollector, collecting
    from repro_torch.models import fno_apply, init_sfno, sfno_apply

    cfg, shape = _card_models()[name]
    sfno = name == "sfno"
    net = (init_sfno if sfno else init_fno)(torch.Generator().manual_seed(3), cfg, device=device)
    x = torch.from_numpy(np.random.RandomState(4).randn(*shape).astype(np.float32)).to(device)
    col = TraceCollector()
    with torch.no_grad(), collecting(col):
        (sfno_apply if sfno else fno_apply)(net, x, get_policy(policy))
    agg = TelemetryAggregator()
    agg.update(col.snapshot())
    return agg.totals


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
@pytest.mark.parametrize("name", ["darcy", "tfno", "sfno"])
def test_card_site_stats_match_cpu(cuda, name, policy_name):
    """Per-site telemetry on the card against the CPU, same weights and
    input: one site set, equal n and overflow; amax within 1e-5 relative
    and qerr within 1e-5 · amax under ``full`` (cuFFT and pocketfft differ
    in the last bits), under ``mixed_fno_bf16`` within 1/4 of the CPU's own
    mixed-vs-full difference of the same quantity, with those floors;
    histograms carry the same mass."""
    got, want = _totals(name, cuda, policy_name), _totals(name, "cpu", policy_name)
    full = _totals(name, "cpu", "full")
    assert set(got) == set(want) and len(got) == 3 * _card_models()[name][0].n_layers
    for site, w in want.items():
        g = got[site]
        assert (g.n, g.overflow, g.updates) == (w.n, w.overflow, w.updates), site
        amax_lim = qerr_lim = 1e-5 * w.amax
        if policy_name != "full":
            amax_lim = max(amax_lim, 0.25 * abs(w.amax - full[site].amax))
            qerr_lim = max(qerr_lim, 0.25 * abs(w.qerr - full[site].qerr))
        assert abs(g.amax - w.amax) <= amax_lim, (site, g.amax, w.amax)
        assert abs(g.qerr - w.qerr) <= qerr_lim, (site, g.qerr, w.qerr)
        assert g.hist.sum() == pytest.approx(w.hist.sum(), rel=1e-3), site


def test_controller_decides_alike_from_card_and_cpu_windows(cuda):
    """The trainer in auto mode on FNO_DARCY_SMOKE (fused by default on the
    card, staged by the collector), 6 steps from the same weights and
    batches on each device: the same per-step policies and decisions, and
    on the card only the staged dense kernels."""
    from repro_torch.autoprec import AutoPrecisionController
    from repro_torch.models import fno_apply
    from repro_torch.train import Trainer, TrainerConfig, relative_l2

    rng = np.random.RandomState(6)
    batch = {"a": rng.randn(4, 1, 24, 24).astype(np.float32),
             "u": (0.1 * rng.randn(4, 1, 24, 24)).astype(np.float32)}

    def loss_fn(model, b, policy):
        return relative_l2(fno_apply(model, b["a"], policy), b["u"])

    out = {}
    for dev in ("cpu", cuda):
        net = init_fno(torch.Generator().manual_seed(2), FNO_DARCY_SMOKE, device="cpu")
        ctl = AutoPrecisionController(base="full", grid_points=24 ** 2, interval=2,
                                      demote_patience=1, cooldown=0)
        tr = Trainer(loss_fn, net, TrainerConfig(total_steps=6, autoprec=ctl), device=dev)
        _zero_counts()
        tr.run(lambda _s: batch)
        if dev != "cpu":
            torch.cuda.synchronize()
        out[str(dev)] = ([h["policy"] for h in tr.history],
                         {g: s["fmt"] for g, s in ctl.describe()["sites"].items()}, _counts())
    (cpu_pol, cpu_fmt, _), (card_pol, card_fmt, card_counts) = out["cpu"], out[str(cuda)]
    assert card_pol == cpu_pol == ["full+auto0"] * 2 + ["full+auto1"] * 4
    assert card_fmt == cpu_fmt == {f"fno/layer{i}/spectral": "bfloat16" for i in range(2)}
    per = FNO_DARCY_SMOKE.n_layers * 2 * 6
    assert card_counts == {"launches": per, "launches_bwd_x": per, "launches_bwd_w": per,
                           "launches_fused_fwd": 0, "launches_fused_bwd": 0}


# -- tuned tiles (repro_torch.tune) -----------------------------------------------------------
TUNE_KEYS = [("spectral_fused", (8, 16, 16, 64, 64, 16, 16), "bfloat16"),
             ("spectral_fused", (8, 16, 16, 64, 64, 16, 16), "float32"),
             ("spectral_fused", (4, 8, 8, 16, 16, 16, 4, 4, 4), "bfloat16"),
             ("lshared", (8, 32, 32, 24, 200), "bfloat16"),
             ("lshared", (8, 32, 32, 24, 200), "float32")]


def _tune_id(key):
    return f"{key[0]}-{'x'.join(map(str, key[1]))}-{key[2]}"


def _tuned_run(cuda, key, block_fwd, block_bwd, seed=0):
    """Forward and the gradients (operands and a seeded cotangent from
    ``tune.measure``) at the given tiles."""
    from repro_torch.tune import measure, space

    family, shape, dtype = key
    cand = space.Candidate(family, shape, dtype, block_fwd, block_bwd)
    args = measure.operand_sets(cand, cuda, seed)[0]
    step = measure.build_step(cand)
    n_cot = 2 if family == "lshared" else 1
    ops_ = args[:-n_cot]
    with torch.no_grad():
        out = measure.forward(cand, [t.detach() for t in ops_])
    grads = step(*args)
    torch.cuda.synchronize()
    return (out if isinstance(out, tuple) else (out,)), grads, args


@pytest.mark.parametrize("key", TUNE_KEYS, ids=_tune_id)
def test_every_legal_forward_tile_gives_a_bit_identical_forward(cuda, key):
    """The fused forward's rows are independent and ``ls_mix``'s splits
    partition outputs: every legal forward tile, and the heuristics' own,
    gives the same forward to the bit."""
    from repro_torch.tune import space

    family, shape, dtype = key
    tiles = space.legal_blocks(family, shape, dtype, "fwd")
    assert len(tiles) >= 2
    heur = ops.heuristic_blocks(family, shape, dtype, cuda)
    ref_out, _, _ = _tuned_run(cuda, key, *heur)
    for b in tiles:
        out, _, _ = _tuned_run(cuda, key, b, heur[1])
        assert all(torch.equal(a, r) for a, r in zip(out, ref_out, strict=True)), b


@pytest.mark.parametrize("key", TUNE_KEYS, ids=_tune_id)
def test_every_legal_backward_tile_stays_within_store_budget(cuda, key):
    """Another backward tile reorders the f32 sum of the fused backward's
    dw over batch tiles (the order-shared splits reorder nothing): every
    legal one gives gradients within ``store_budget`` of the heuristics'
    (stored at f32 for the fused layer, at the operands' dtype for the
    order-shared one), which a zeroed output fails."""
    from repro_torch.tune import space

    family, shape, dtype = key
    heur = ops.heuristic_blocks(family, shape, dtype, cuda)
    _, want, args = _tuned_run(cuda, key, *heur)
    if family == "spectral_fused":
        x, wgr, wgi, g = (t.detach() for t in args)
        mags = sc.fused_magnitude(x, wgr, wgi, space.fused_axes(shape)[4], g=g)
        mag, eps = (mags["dx"], mags["dw"], mags["dw"]), FORMAT_EPS["float32"]
    else:
        xr, xi, wr, wi, gr, gi = (t.detach() for t in args)
        mags = sc.lshared_magnitudes(xr, xi, wr, wi, gr, gi)
        mag, eps = (mags["dx"],) * 2 + (mags["dw"],) * 2, FORMAT_EPS[dtype]
    for b in space.legal_blocks(family, shape, dtype, "bwd"):
        _, got, _ = _tuned_run(cuda, key, heur[0], b)
        for a, w, m in zip(got, want, mag, strict=True):
            budget = store_budget(eps, w.double(), m.double())
            assert bool(((a.double() - w.double()).abs() <= budget).all()), b
            assert not bool((w.double().abs() <= budget).all()), "a zeroed output passes"


def _fused_layer_operands(B, cuda, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, 16, 64, 64, generator=g).to(cuda)
    w = [(torch.randn(2, 16, 16, 16, 16, generator=g) / 16).to(cuda).requires_grad_()
         for _ in range(2)]
    return x.requires_grad_(), w


def _fused_layer_step(cuda, policy="mixed_fno_bf16", B=8):
    x, w = _fused_layer_operands(B, cuda)
    _zero_counts()
    y = ops.spectral_conv_fused(x, *w, (16, 16), policy=get_policy(policy))
    grads = torch.autograd.grad(y, (x, *w), torch.ones_like(y))
    torch.cuda.synchronize()
    return y.detach(), grads, _counts()


def _state(tmp_path, block_fwd, block_bwd, **kw):
    from repro_torch.tune import cache

    st = cache.CalibrationCache(entries={}, backend=cache.backend_of("cuda"))
    ent = {"family": "spectral_fused", "shape": [8, 16, 16, 64, 64, 16, 16],
           "dtype": "bfloat16", "backend": cache.backend_of("cuda"),
           "kernel_version": sc.KERNEL_VERSION, "block_fwd": block_fwd,
           "block_bwd": block_bwd, "validated": True}
    ent.update(kw)
    st.put(ent)
    return str(cache.save(st, tmp_path / "state.json"))


@pytest.fixture
def calibration():
    from repro_torch.tune import cache

    cache.activate(None)
    ops.reset_tile_resolution_stats()
    yield cache
    cache.activate(None)


@pytest.mark.parametrize("tiles", [(2, 1), (4, 2), (1, 8)])
def test_a_seeded_entry_multiplies_the_fused_launches(cuda, calibration, tmp_path, tiles):
    """The entry's tiles reach the launches: B / tile launches a layer each
    way, the forward bit-identical to the heuristics'."""
    y0, _, c0 = _fused_layer_step(cuda)
    heur = sc.pick_block_b(8, 16, 16, (64, 64), (16, 16))
    assert (c0["launches_fused_fwd"], c0["launches_fused_bwd"]) == (8 // heur,) * 2
    calibration.activate(_state(tmp_path, *tiles))
    y1, _, c1 = _fused_layer_step(cuda)
    assert (c1["launches_fused_fwd"], c1["launches_fused_bwd"]) == (8 // tiles[0],
                                                                   8 // tiles[1])
    assert torch.equal(y0, y1)
    assert ops.tile_resolution_stats()["sources"]["calibrated"] == 1


@pytest.mark.parametrize("defect", [{"kernel_version": 1}, {"backend": "another card"},
                                    {"block_fwd": 16}, {"block_bwd": 16},
                                    {"validated": False}])
def test_a_stale_or_oversized_entry_leaves_every_launch_as_it_was(cuda, calibration, tmp_path,
                                                                  defect):
    y0, g0, c0 = _fused_layer_step(cuda)
    calibration.activate(_state(tmp_path, **{"block_fwd": 2, "block_bwd": 2, **defect}))
    y1, g1, c1 = _fused_layer_step(cuda)
    assert c1 == c0
    assert torch.equal(y0, y1) and all(torch.equal(a, b) for a, b in zip(g0, g1, strict=True))
    assert ops.tile_resolution_stats()["sources"] == {"heuristic": 2, "calibrated": 0}


@pytest.mark.parametrize("key", [("spectral_fused", (8, 64, 64, 128, 128, 32, 32), "bfloat16"),
                                 ("lshared", (8, 64, 64, 128, 128), "bfloat16")], ids=_tune_id)
def test_measure_on_the_card(cuda, key):
    from repro_torch.tune import measure, space

    family, shape, dtype = key
    hf, hb = ops.heuristic_blocks(family, shape, dtype, cuda)
    perf = measure.measure(space.Candidate(family, shape, dtype, hf, hb), device=cuda, iters=3)
    assert perf["wall_us"] > 0 and perf["interpret"] is False
    assert 0 < perf["roofline_fraction"] <= 1.05


def test_the_oracle_admits_the_heuristic_and_refuses_a_perturbed_output(cuda):
    from repro_torch.tune import oracle, space

    for family, shape, dtype in (("spectral_fused", (4, 8, 8, 32, 32, 8, 8), "bfloat16"),
                                 ("lshared", (4, 16, 16, 12, 140), "bfloat16")):
        hf, hb = ops.heuristic_blocks(family, shape, dtype, cuda)
        cand = space.Candidate(family, shape, dtype, hf, hb)
        assert oracle.check(cand, device=cuda)["passed"]
        assert not oracle.check(cand, device=cuda, perturb=2.0)["passed"]


def test_engine_serves_calibrated_tiles_bit_identically(cuda, calibration, tmp_path):
    """OperatorEngine(calibration_state=) on the card: a seeded entry at the
    engine's fused key changes its launches, not its answers."""
    from repro_torch.tune import cache

    net = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE)
    fields = [np.random.RandomState(i).randn(1, 32, 32).astype(np.float32) for i in range(4)]
    key = [4, 16, 16, 32, 32, *FNO_DARCY_SMOKE.modes]
    st = cache.CalibrationCache(entries={}, backend=cache.backend_of(cuda))
    st.put({"family": "spectral_fused", "shape": key, "dtype": "float32",
            "backend": cache.backend_of(cuda), "kernel_version": sc.KERNEL_VERSION,
            "block_fwd": 1, "block_bwd": 1, "validated": True})
    path = str(cache.save(st, tmp_path / "engine.json"))
    out = {}
    for state in (None, path):
        calibration.activate(None)
        engine = OperatorEngine(net, max_batch=4, calibration_state=state)
        reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(fields)]
        for r in reqs:
            engine.submit(r)
        _zero_counts()
        engine.drain()
        torch.cuda.synchronize()
        out[state] = ([r.y for r in reqs], _counts()["launches_fused_fwd"],
                      engine.stats()["tiles"])
    (y0, n0, _), (y1, n1, tiles) = out[None], out[path]
    assert all(np.array_equal(a, b) for a, b in zip(y0, y1, strict=True))
    assert (n0, n1) == (FNO_DARCY_SMOKE.n_layers, 4 * FNO_DARCY_SMOKE.n_layers)
    assert tiles["cache"] == {"hits": FNO_DARCY_SMOKE.n_layers, "misses": 0, "stale": 0}


# -- the static analyzer on the card -----------------------------------------------------


def test_launch_recorder_delegating_keeps_outputs_bit_identical(cuda):
    """``analyze.kernels.record_launches`` on the card records each launch
    and runs it: the outputs equal the unrecorded launches' bit for bit."""
    from repro_torch.analyze.kernels import record_launches

    g = torch.Generator(device=cuda).manual_seed(3)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    x, w = [r(3, 24, 300) for _ in range(2)], [r(24, 40, 300) for _ in range(2)]
    cp = [r(*s, dtype=torch.bfloat16) for s in [(3, 24, 300)] * 2 + [(24, 17)] * 2
          + [(40, 17)] * 2 + [(17, 300)] * 2]
    lx = [r(3, 5, 37, 29, dtype=torch.float16) for _ in range(2)]
    lw = [r(5, 7, 37, dtype=torch.float16) for _ in range(2)]
    fx, fg = r(3, 5, 30), r(3, 7, 30)
    fw = [r(5, 7, 16) for _ in range(2)]
    calls = [lambda: sc._launch_fwd(*x, *w, torch.bfloat16, torch.bfloat16),
             lambda: sc._launch_bwd_w(*x, *x, torch.float16),
             lambda: sc._launch_cp_fwd(*cp),
             lambda: sc._launch_ls_fwd(*lx, *lw),
             lambda: sc._launch_fused_fwd(fx, *fw, (16,), torch.bfloat16, None, 2),
             lambda: sc._launch_fused_bwd(fx, *fw, fg, (16,), torch.float16, "fp8_e4m3", 2)]
    for call in calls:
        want = call()
        with record_launches(cuda) as launches:
            got = call()
        torch.cuda.synchronize()
        want, got = (want,) if torch.is_tensor(want) else want, (got,) if torch.is_tensor(got) \
            else got
        assert launches and all(torch.equal(a, b) for a, b in zip(want, got, strict=True))


def test_plans_equal_the_library_exports(cuda):
    """Every plan the launchers make at the paths' shapes, and the CP and
    order-shared plans at every width from 1 to 192, take the shared memory
    the library's own export says."""
    from repro_torch.analyze import kernels as ak

    traces = ak.trace_families(cuda, shapes=(ak.PATH_SHAPES,))
    plans = [(ak.plan_bytes(la), ak.library_bytes(la)) for tr in traces for la in tr.launches
             if ak.plan_bytes(la) is not None]
    assert len(plans) > 20 and all(p == lib for p, lib in plans)
    for width in range(1, 193):
        for fmt in (0, 1, 2):
            for la in (ak.KernelLaunch("spectral_contract_cp_fwd",
                                       (2, width, width, width, 40, int(width <= 64), fmt), None),
                       ak.KernelLaunch("spectral_contract_cp_bwd",
                                       (2, width, width, width, 40, 64, 64, 0, fmt), None),
                       ak.KernelLaunch("spectral_contract_ls_fwd",
                                       (2, width, 7, 12, 9, 1, 1, fmt), None),
                       ak.KernelLaunch("spectral_contract_ls_bwd_x",
                                       (2, 7, width, 12, 9, 0, 1, fmt), None)):
                assert ak.plan_bytes(la) == ak.library_bytes(la), (la.name, width, fmt)
    assert ak.kernels_pass(cuda, traces) == []


def test_a_kernel_record_rounding_to_f32_is_fp32_resident(cuda):
    """A dense launch with no cast inside a ``mixed_fno_bf16`` contract scope:
    the demoted site never touches bf16."""
    from repro_torch.analyze import analyze_records, recording
    from repro_torch.precision import site_scope

    policy = get_policy("mixed_fno_bf16")
    site = "fno/layer0/spectral/contract"
    ops_ = _operands(2, 8, 8, 40, cuda)
    for cast_to, resident in ((None, True), (torch.bfloat16, False)):
        with recording() as rec:
            with site_scope(site):
                sc._launch_fwd(*ops_, cast_to, cast_to or torch.float32)
        checks = [f.check for f in analyze_records(rec.records, policy, "seeded")]
        assert checks == (["fp32-resident"] if resident else [])
        assert [r.op for r in rec.records if r.kernel] == ["spectral_contract_dense_fwd"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_fno_darcy_forward_is_clean_on_the_card(cuda, fused):
    """FNO_DARCY at full width, a batch of 2 at 128² under mixed_fno_bf16:
    no unsuppressed error, one kernel record a layer rounding to bf16 at
    its contract site (four dense ones staged: one a corner), and a step's
    backward launches attributed to the same sites from the autograd
    engine's device thread."""
    import dataclasses

    from repro_torch.analyze import analyze_records, load_suppressions, partition, recording
    from repro_torch.analyze.__main__ import DEFAULT_SUPPRESSIONS
    from repro_torch.configs.fno_paper import FNO_DARCY

    cfg = dataclasses.replace(FNO_DARCY, fuse_spectral=None if fused else False)
    net = init_fno(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 1, 128, 128).astype(np.float32))
    policy = get_policy("mixed_fno_bf16")
    with recording() as rec:
        y = net(x.to(cuda), policy)
        torch.autograd.grad(y.float().square().mean(), list(net.parameters()))
        torch.cuda.synchronize()
    active, _ = partition(analyze_records(rec.records, policy, "FNO_DARCY"),
                          load_suppressions(DEFAULT_SUPPRESSIONS))
    assert [f for f in active if f.severity == "error"] == []
    fwd = "spectral_fused_fwd" if fused else "spectral_contract_dense_fwd"
    bwd = {"spectral_fused_bwd"} if fused else {"spectral_contract_dense_bwd_x",
                                                "spectral_contract_dense_bwd_w"}
    for i in range(cfg.n_layers):
        site = f"fno/layer{i}/spectral/contract"
        at = [r for r in rec.records if r.kernel and r.site == site]
        assert all(r.cast_to == torch.bfloat16 for r in at)
        assert sum(r.op == fwd and not r.backward for r in at) == (1 if fused else 2)
        assert {r.op for r in at if r.backward} == bwd
    assert any(r.backward and not r.kernel for r in rec.records)


# -- the LM pool and LMEngine (no hand-written kernel on their path) -------------------
#: one smoke config a family: dense, MoE, MLA + MoE, SSM, hybrid (SWA ring), VLM
LM_FAMILIES = ["smollm-360m", "granite-moe-3b-a800m", "deepseek-v2-lite-16b", "mamba2-370m",
               "hymba-1.5b", "llava-next-mistral-7b"]


def _lm_pair(arch, seed=0):
    """(cfg, card model, CPU model): the same seeded weights; MoE without
    capacity drops, which depend on the dispatch batch."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm

    cfg = get_config(arch, smoke=True)
    if cfg.moe_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return (cfg, init_lm(torch.Generator().manual_seed(seed), cfg),
            init_lm(torch.Generator().manual_seed(seed), cfg, device="cpu"))


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_forward_on_the_card_matches_cpu(cuda, arch):
    from repro_torch.models.lm import lm_forward

    cfg, net, net_cpu = _lm_pair(arch)
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 24)))
    pe = (torch.from_numpy((0.1 * rng.randn(2, cfg.n_patches, cfg.d_model)).astype(np.float32))
          if cfg.frontend == "vision_stub" else None)
    with torch.no_grad():
        got, aux = lm_forward(net, toks.to(cuda), cfg, patch_embeds=None if pe is None else pe.to(cuda))
        want, aux_cpu = lm_forward(net_cpu, toks, cfg, patch_embeds=pe)
    assert got.device.type == "cuda" and bool(torch.isfinite(got).all())
    assert _rel_l2(got.cpu(), want) <= 1e-5
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5 * max(1.0, abs(float(aux_cpu)))


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_decode_on_the_card_matches_its_forward(cuda, arch):
    from repro_torch.models.lm import init_cache, lm_decode_step, lm_forward

    cfg, net, _ = _lm_pair(arch)
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab, (2, 12))).to(cuda)
    with torch.no_grad():
        full, _ = lm_forward(net, toks, cfg)
    cache = init_cache(cfg, 2, 16)
    assert all(t.device.type == "cuda" for t in cache.values())
    for t in range(12):
        lg, cache = lm_decode_step(net, cache, toks[:, t], cfg)
        assert _rel_l2(lg.cpu(), full[:, t].cpu()) <= 1e-5, t
    assert cache["step"].tolist() == [12, 12]


@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_lm_engine_on_the_card_chunk_1_eq_8_and_reruns_bit_identically(cuda, arch):
    from repro_torch.serve import LMEngine, Request

    cfg, net, _ = _lm_pair(arch)
    rng = np.random.RandomState(3)
    window = cfg.attn_window or 64
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, n)] for n in (5, 11, window + 6, 3)]

    def run(chunk):
        eng = LMEngine(net, cfg, n_slots=2, max_len=window + 16, prefill_chunk=chunk,
                       record_logits=True)
        done, _ = eng.run_until_done([Request(uid=i, prompt=p, max_new_tokens=4)
                                      for i, p in enumerate(prompts)])
        assert all(r.status == "done" for r in done)
        return {r.uid: r.generated for r in done}, eng

    g1, _ = run(1)
    g8, e8 = run(8)
    assert g1 == g8
    g8b, e8b = run(8)
    assert g8b == g8
    for uid in range(len(prompts)):
        assert all(np.array_equal(a, b) for a, b in zip(e8.logits_for(uid), e8b.logits_for(uid),
                                                        strict=True))


def test_whisper_decode_on_the_card_matches_cpu(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import (
        init_whisper,
        init_whisper_cache,
        whisper_decode_step,
        whisper_encode,
        whisper_forward,
    )

    cfg = get_config("whisper-large-v3", smoke=True)
    net = init_whisper(torch.Generator().manual_seed(4), cfg)
    net_cpu = init_whisper(torch.Generator().manual_seed(4), cfg, device="cpu")
    rng = np.random.RandomState(4)
    frames = torch.from_numpy((0.5 * rng.randn(2, 24, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 8)))
    with torch.no_grad():
        mem, mem_cpu = whisper_encode(net, frames.to(cuda), cfg), whisper_encode(net_cpu, frames, cfg)
        fwd = whisper_forward(net, frames.to(cuda), toks.to(cuda), cfg)
    assert _rel_l2(mem.cpu(), mem_cpu) <= 1e-5
    cache, cache_cpu = init_whisper_cache(net, mem, cfg, 2), init_whisper_cache(net_cpu, mem_cpu, cfg, 2)
    for t in range(8):
        lg, cache = whisper_decode_step(net, cache, toks[:, t].to(cuda), cfg)
        lc, cache_cpu = whisper_decode_step(net_cpu, cache_cpu, toks[:, t], cfg)
        assert _rel_l2(lg.cpu(), lc) <= 1e-5, t
        assert _rel_l2(lg.cpu(), fwd[:, t].cpu()) <= 1e-5, t


# -- paged LM serving (no hand-written kernel on its path either) ----------------------------
#: the reference's paged bar: pure attention, the pure-SSD fallback, the
#: hybrid SWA ring and MLA (MoE stripped: capacity routing depends on the batch)
PAGED_ARCHS = ["smollm-360m", "mamba2-370m", "hymba-1.5b", "deepseek-v2-lite-16b"]


def _paged_model(arch, seed=5):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm

    cfg = get_config(arch, smoke=True)
    if cfg.moe_experts:
        cfg = dataclasses.replace(cfg, moe_experts=0, moe_shared=0, d_ff=32)
    return cfg, init_lm(torch.Generator().manual_seed(seed), cfg)


def _null_block_untouched(engine):
    c = engine.cache
    assert bool((c["kv_pos"][:, 0] == -1).all())
    for k in ("k", "v", "c_kv", "k_rope"):
        if k in c:
            assert not bool(c[k][:, 0].any()), k


def _serve_pair(cfg, net, prompts, policy_name="full", new=4, **paged_kw):
    """The same traffic through LMEngine and PagedLMEngine on the card."""
    from repro_torch.serve import LMEngine, PagedLMEngine, Request

    kw = dict(n_slots=2, max_len=2 * cfg.attn_window if cfg.attn_window else 48,
              prefill_chunk=4, record_logits=True, policy=get_policy(policy_name))
    out = []
    for eng in (LMEngine(net, cfg, **kw), PagedLMEngine(net, cfg, block_size=8, **kw, **paged_kw)):
        done, _ = eng.run_until_done([Request(uid=i, prompt=list(p), max_new_tokens=new)
                                      for i, p in enumerate(prompts)])
        assert all(r.status == "done" for r in done)
        out.append(({r.uid: r.generated for r in done}, eng))
    return out


@pytest.mark.parametrize("arch", PAGED_ARCHS)
@pytest.mark.parametrize("policy_name", ["full", "amp_bf16"])
def test_paged_engine_on_the_card_bit_equal_to_dense(cuda, arch, policy_name):
    """Paged against dense on the card: the same tokens and every per-step
    logits row bit for bit (the view has the dense layer slice's layout,
    so every GEMM is the same), block 0 untouched."""
    cfg, net = _paged_model(arch)
    rng = np.random.RandomState(6)
    lens = (5, 11, 3, 20) if not cfg.attn_window else (5, cfg.attn_window + 6, 3, 20)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, n)] for n in lens]
    (dg, dense), (pg, paged) = _serve_pair(cfg, net, prompts, policy_name)
    assert pg == dg
    for uid in range(len(prompts)):
        assert all(np.array_equal(a, b) for a, b in zip(dense.logits_for(uid),
                                                        paged.logits_for(uid), strict=True))
    if cfg.mixer == "ssd":
        assert paged.stats()["paged"]["active"] is False
    else:
        assert paged.cache["kv_pos"].device.type == "cuda"
        _null_block_untouched(paged)


def test_paged_engine_on_the_card_cow_prefix_and_exhaustion(cuda):
    """Copy-on-write of a forked running block bit-equal to dense; a shared
    prefix reused (the same tokens, logits within 1e-5: skipped prefill
    changes which rows share a GEMM); an exhausted pool raises."""
    from repro_torch.serve import LMEngine, PagedLMEngine, Request

    cfg, net = _paged_model("smollm-360m")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    kw = dict(n_slots=1, max_len=32, prefill_chunk=4, record_logits=True)
    dense = LMEngine(net, cfg, **kw)
    d_done, _ = dense.run_until_done([Request(uid=0, prompt=list(prompt), max_new_tokens=4)])
    paged = PagedLMEngine(net, cfg, block_size=8, **kw)
    req = Request(uid=0, prompt=list(prompt), max_new_tokens=4)
    paged.submit(req)
    for _ in range(3):
        paged.tick()
    shared = int(paged._bt[0, 1])
    paged.pool.fork(shared)
    while req.status != "done":
        paged.tick()
    assert int(paged._bt[0, 1]) != shared and paged.pool.cow_copies == 1
    assert req.generated == d_done[0].generated
    assert all(np.array_equal(a, b) for a, b in zip(dense.logits_for(0), paged.logits_for(0),
                                                    strict=True))
    _null_block_untouched(paged)

    shared_prompt = [int(t) for t in np.random.RandomState(7).randint(1, cfg.vocab, 16)]
    prompts = [shared_prompt + [u + 1, u + 2] for u in range(6)]
    (dg, dense), (pg, paged) = _serve_pair(cfg, net, prompts)
    assert pg == dg
    assert paged.stats()["paged"]["prefix"]["hits"] >= 4
    assert paged.stats()["prompt_tokens"] < dense.stats()["prompt_tokens"]
    for uid in range(6):
        for a, b in zip(dense.logits_for(uid), paged.logits_for(uid), strict=True):
            assert _rel_l2(b, a) <= 1e-5
    _null_block_untouched(paged)

    full = PagedLMEngine(net, cfg, n_slots=2, max_len=32, prefill_chunk=4, block_size=8,
                         num_blocks=4, prefix_sharing=False)
    for u in range(2):
        full.submit(Request(uid=u, prompt=list(range(1, 10)), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="pool exhausted"):
        full.drain()
    _null_block_untouched(full)


# ---------------------------------------------------------------------------
# Distribution on a one-rank NCCL mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL world and its 1x1 ("data", "model") mesh for the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield make_debug_mesh(1, "cuda")
    finally:
        dist.destroy_process_group()


def test_dist_fno_step_on_the_card_bit_equal_to_one_device(nccl_mesh):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import distribute, fno_param_specs
    from repro_torch.launch.steps import build_fno_train_step, fno_batch_specs
    from repro_torch.optim import AdamW

    policy = get_policy("mixed_fno_bf16")
    g = torch.Generator().manual_seed(7)
    batch = {"x": torch.randn(4, 1, 32, 32, generator=g).cuda(),
             "y": torch.randn(4, 1, 32, 32, generator=g).cuda()}
    opt = AdamW(lr=1e-3)
    ref = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE)
    ref_state = opt.init(dict(ref.named_parameters()))
    model = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE)
    distribute(model, nccl_mesh, fno_param_specs(model, nccl_mesh))
    with implicit_replication():
        state = opt.init(dict(model.named_parameters()))
    dbatch = distribute(batch, nccl_mesh, fno_batch_specs(batch, nccl_mesh))
    plain, dp = build_fno_train_step(policy, None, opt), build_fno_train_step(policy, nccl_mesh, opt)
    for _ in range(2):
        ref, ref_state, l0 = plain(ref, ref_state, batch)
        before = sc.launches_fused_fwd
        model, state, l1 = dp(model, state, dbatch)
        assert sc.launches_fused_fwd > before
        assert torch.equal(l0, l1)
    named = dict(ref.named_parameters())
    for k, p in model.named_parameters():
        assert torch.equal(p.full_tensor(), named[k]), k


def test_sharded_lm_engine_on_the_card(nccl_mesh):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import LMEngine, Request

    cfg = get_config("smollm-360m", smoke=True)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), cfg)

    def reqs():
        return [Request(uid=i, prompt=list(range(1 + i, 9 + 3 * i)), max_new_tokens=6)
                for i in range(6)]

    plain = LMEngine(params, cfg, n_slots=4, max_len=64, record_logits=True)
    sharded = LMEngine(params, cfg, n_slots=4, max_len=64, mesh=nccl_mesh, record_logits=True)
    d0, _ = plain.run_until_done(reqs())
    d1, _ = sharded.run_until_done(reqs())
    assert {r.uid: r.generated for r in d0} == {r.uid: r.generated for r in d1}
    for u in range(6):
        for a, b in zip(plain.logits_for(u), sharded.logits_for(u), strict=True):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="mesh is on cuda"):
        LMEngine(init_lm(torch.Generator().manual_seed(0), cfg, device="cpu"), cfg,
                 mesh=nccl_mesh, device="cpu")


def test_compressed_allreduce_on_the_card(nccl_mesh):
    from repro_torch.optim.grad_comm import make_dp_allreduce

    g = torch.Generator(device="cuda").manual_seed(3)
    grads = {"a": torch.randn(4096, generator=g, device="cuda"),
             "b": torch.randn(64, 33, generator=g, device="cuda")}
    exact = make_dp_allreduce(nccl_mesh, dtype=torch.float32)(grads)
    small = make_dp_allreduce(nccl_mesh)(grads)
    for k, v in grads.items():
        assert torch.equal(exact[k], v)
        rel = float((small[k] - v).norm() / v.norm())
        assert small[k].dtype == torch.float32 and 0 < rel <= 2.0 ** -8, (k, rel)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-large-v3"])
def test_moe_and_whisper_train_steps_on_the_one_rank_mesh(nccl_mesh, arch):
    """The smoke train step on the 1x1 NCCL mesh bit-equal to ``mesh=None``:
    losses and every parameter after the step."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.dist import distribute, lm_param_specs, use_mesh
    from repro_torch.dist.sharding import batch_specs
    from repro_torch.launch.parity import train_batch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.lm import init_lm, init_whisper
    from repro_torch.optim import AdamW

    cfg = get_config(arch, smoke=True)
    init = init_whisper if cfg.encoder_decoder else init_lm
    bundle = build_train_step(cfg, ShapeConfig("t", 16, 4, "train"), get_policy("full"),
                              AdamW(lr=1e-3))
    batch = {k: v.cuda() for k, v in train_batch(cfg, 4, 16).items()}
    p0 = init(torch.Generator(device="cuda").manual_seed(0), cfg)
    s0 = AdamW(lr=1e-3).init(dict(p0.named_parameters()))
    p0, s0, l0 = bundle.step_fn(p0, s0, batch)
    p1 = init(torch.Generator(device="cuda").manual_seed(0), cfg)
    distribute(p1, nccl_mesh, lm_param_specs(p1, nccl_mesh))
    with use_mesh(nccl_mesh), implicit_replication():
        s1 = AdamW(lr=1e-3).init(dict(p1.named_parameters()))
        p1, s1, l1 = bundle.step_fn(p1, s1, distribute(batch, nccl_mesh,
                                                       batch_specs(batch, nccl_mesh)))
        l1 = l1.full_tensor()
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    n0 = dict(p0.named_parameters())
    for k, p in p1.named_parameters():
        assert torch.equal(p.full_tensor(), n0[k]), k
