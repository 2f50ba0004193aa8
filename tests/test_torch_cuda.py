"""Card-only tests of the PyTorch port: the hand-written CUDA spectral
contraction against its plain PyTorch version on the card, the wrapper's
checks, and the FNO serving path on CUDA against the CPU.

Imports no JAX (the GPU machine has none).  Every test carries the
``cuda`` marker and skips, from inside a fixture, where no card is
present.  On a machine with an NVIDIA H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE
from repro_torch.core.precision import FORMAT_EPS, dtype_name
from repro_torch.core.theory import contract_budget
from repro_torch.kernels import ops
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
    with pytest.raises(NotImplementedError, match="backward"):
        sc.spectral_contract_dense(xr, xi, wr.requires_grad_(), wi)


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
    the CPU does."""
    from repro_torch.core.spectral import init_spectral_weights, spectral_conv_apply

    policy = get_policy(policy_name)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 8, *spatial, generator=g)
    params = init_spectral_weights(8, 8, modes, generator=g)
    want = spectral_conv_apply(params, x, modes, policy).numpy()
    got = spectral_conv_apply({k: v.to(cuda) for k, v in params.items()},
                              x.to(cuda), modes, policy).cpu().numpy()
    if policy_name == "full":
        assert _rel_l2(got, want) <= 1e-5
    else:
        full = spectral_conv_apply(params, x, modes, get_policy("full")).numpy()
        assert _rel_l2(got, want) <= 0.25 * _rel_l2(want, full)


def _fields(n, count, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, n, n).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_engine_launches_kernel_per_corner_and_layer(cuda, policy_name):
    cfg = FNO_DARCY_SMOKE
    net = init_fno(torch.Generator().manual_seed(1), cfg, device=cuda)
    engine = OperatorEngine(net, policy=get_policy(policy_name), max_batch=4,
                            device=cuda)
    for i, x in enumerate(_fields(16, 5, 0) + _fields(24, 2, 1)):
        engine.submit(FieldRequest(uid=i, x=x))
    sc.launches = 0
    done, _ = engine.drain()
    torch.cuda.synchronize()
    corners = 2 ** (cfg.ndim - 1)
    assert engine.stats()["batches"] == 3
    assert sc.launches == 3 * cfg.n_layers * corners
    assert all(r.status == "done" and np.isfinite(r.y).all() for r in done)


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_engine_batched_matches_solo_bit_identically(cuda, policy_name):
    cfg = FNO_DARCY_SMOKE
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
    cfg = FNO_DARCY_SMOKE
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
