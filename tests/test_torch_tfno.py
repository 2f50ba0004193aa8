"""The PyTorch port's CP-factorised TFNO against the JAX reference on the
CPU, at smoke sizes.

The same numpy inputs, and weights bridged with ``params_from_jax``, go
through both packages.  The reference runs its CP Pallas kernels in
interpret mode (``use_pallas=True``): its CPU default, the einsum path,
fails on XLA:CPU for bf16 dots (``core/contraction.py``'s ``_pairwise``),
and the CP kernels are what the port's kernels replace.

* the CP contraction (``ops.spectral_contract_cp``) under every policy on
  1-D, 2-D and 3-D ragged modes, within the reference's own CP budget;
* ``CPContract``'s eight gradients against the reference's custom VJP
  (``_cp_op_bwd``), and an f64 gradcheck of the plain path;
* ``TFNO_NS_SMOKE``: ``fno_infer`` per policy, per-leaf gradients per
  policy, weight layout, and serving through the engine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.fno as jfno
from repro.configs.fno_paper import TFNO_NS as J_TFNO_NS
from repro.configs.fno_paper import TFNO_NS_SMOKE as J_SMOKE
from repro.core import get_policy as jget_policy
from repro.core import init_spectral_weights as jinit_spectral_weights
from repro.core import spectral_conv_apply as jspectral_conv_apply
from repro.core.spectral import _cp_exprs
from repro.kernels import ops as jops
from repro.kernels.spectral_contract import spectral_contract_cp_pallas
from repro_torch.configs.fno_paper import TFNO_NS, TFNO_NS_SMOKE
from repro_torch.core.precision import FORMAT_EPS
from repro_torch.core.spectral import cp_rank, init_spectral_weights, spectral_conv_apply
from repro_torch.core.theory import store_budget
from repro_torch.kernels import ops
from repro_torch.kernels import spectral_contract as sc
from repro_torch.models import fno_infer, init_fno, param_count, params_from_jax
from repro_torch.precision import get_policy
from repro_torch.serve import FieldRequest, OperatorEngine

from helpers import MODES_BY_NDIM, POLICY_NAMES, assert_within_budget, rand_complex, rel_err
from test_torch_train import check_fno_gradients

jax.config.update("jax_platform_name", "cpu")

#: the reference through its CP Pallas kernels (interpret mode), staged path
J_CFG = dataclasses.replace(J_SMOKE, use_pallas=True, fuse_spectral=False)

#: operand dtypes of the CP kernels on the path
DTYPES = ["float32", "bfloat16", "float16"]


def _t(a):
    """A complex jax/numpy array as a torch complex64 tensor."""
    return torch.from_numpy(np.array(a, np.complex64))


# -- the CP contraction ------------------------------------------------------------
def _cp_inputs(seed, B, I, O, R, modes):
    rng = np.random.RandomState(seed)
    x = rand_complex(rng, (B, I, *modes))
    lam = rand_complex(rng, (R,))
    ui = rand_complex(rng, (I, R))
    uo = rand_complex(rng, (O, R))
    factors = [rand_complex(rng, (m, R)) for m in modes]
    return x, lam, ui, uo, factors


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_cp_contract_matches_pallas_kernel(policy_name, ndim):
    """``ops.spectral_contract_cp`` against the reference's, which runs
    ``_cp_fwd_kernel`` in interpret mode at block_m = 8 (M = 7, 15 and 12:
    every case ragged), within the budget the reference holds its CP
    kernel to (``tests/test_kernels_diff.py``, ``_diff_cp``): one 4εM
    term per rounding stage of either evaluation, (ndim + 3) + 3 stages,
    plus 32·ε_f32·M for the f32 summation order."""
    site = "fno/layer0/spectral/contract"
    jsite, tsite = jget_policy(policy_name).at(site), get_policy(policy_name).at(site)
    modes = MODES_BY_NDIM[ndim]
    x, lam, ui, uo, factors = _cp_inputs(10 + ndim, 2, 3, 4, 3, modes)
    want = np.asarray(jops.spectral_contract_cp(x, lam, ui, uo, factors, policy=jsite,
                                                block_m=8))
    got = ops.spectral_contract_cp(_t(x), _t(lam), _t(ui), _t(uo), [_t(f) for f in factors],
                                   policy=tsite)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    expr = _cp_exprs(ndim)
    mag = np.einsum(expr.replace(" ", ""), *(np.abs(np.asarray(a))
                                             for a in (x, lam, ui, uo, *factors)))
    assert_within_budget(got.numpy(), want, jsite.eps, mag, stages=(ndim + 3) + 3,
                         label=f"cp {policy_name} modes{modes}")


def test_cp_mode_factor_matches_reference():
    _, lam, _, _, factors = _cp_inputs(0, 1, 1, 1, 5, (3, 4, 2))
    want = np.asarray(jops.cp_mode_factor(lam, factors))
    got = ops.cp_mode_factor(_t(lam), [_t(f) for f in factors]).numpy()
    assert got.shape == want.shape == (5, 24)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _split_operands(seed, B=3, I=5, O=4, R=6, M=37, dtype="float32"):
    """Split-real operands at one dtype (M = 37 is ragged at block_m = 8),
    and a cotangent at that dtype."""
    rng = np.random.RandomState(seed)
    shapes = [(B, I, M), (I, R), (O, R), (R, M)]
    ops_ = [(0.5 * rng.randn(*s)).astype(np.float32) for s in shapes for _ in range(2)]
    cts = [(0.5 * rng.randn(B, O, M)).astype(np.float32) for _ in range(2)]
    jt = getattr(jnp, dtype)
    ops_ = [np.array(jnp.asarray(a, jt).astype(jnp.float32)) for a in ops_]
    cts = [np.array(jnp.asarray(c, jt).astype(jnp.float32)) for c in cts]
    return ops_, cts


@pytest.mark.parametrize("dtype", DTYPES)
def test_cp_contract_grads_match_pallas_vjp(dtype):
    """The reference's custom VJP (``_cp_bwd_kernel`` in interpret mode,
    block_m = 8) and ``CPContract`` on CPU tensors, every operand and the
    cotangent at ``dtype``: the eight gradients come back at ``dtype`` in
    both.  Both sum in f32 from the same operands, so each part agrees
    within one rounding at ``dtype`` plus the f32 summation order of its
    magnitude contraction M (``store_budget``)."""
    ops_, cts = _split_operands(1, dtype=dtype)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(
        lambda *a: spectral_contract_cp_pallas(*a, block_m=8, interpret=True),
        *(jnp.asarray(a, jt) for a in ops_))
    want = vjp(tuple(jnp.asarray(c, jt) for c in cts))
    leaves = [torch.from_numpy(a).to(tt).requires_grad_() for a in ops_]
    out = sc.CPContract.apply(*leaves)
    assert all(o.dtype == tt for o in out)
    got = torch.autograd.grad(out, leaves, [torch.from_numpy(c).to(tt) for c in cts])
    mags = sc.cp_magnitudes(*(torch.from_numpy(a).double() for a in ops_ + cts))
    for k, name in enumerate(("dx", "dx", "dU_i", "dU_i", "dU_o", "dU_o", "dW", "dW")):
        assert got[k].dtype == tt and want[k].dtype == jt
        part_want = np.asarray(want[k], np.float32)
        budget = store_budget(FORMAT_EPS[dtype], part_want, mags[name].numpy())
        assert np.all(np.abs(got[k].float().numpy() - part_want) <= budget), f"{name} {dtype}"


def _path_operands(dtype, seed=0):
    """x, U_i, U_o, W and a cotangent as split-real pairs at the TFNO_NS
    path's shape (B, I, O, R, M) = (8, 64, 64, 64, 1764), scaled so the
    outputs are O(1), as the card's smoke test draws them."""
    B, I, O, R, M = 8, 64, 64, 64, 42 * 42
    rng = np.random.RandomState(seed)
    shapes = ((B, I, M), (I, R), (O, R), (R, M), (B, O, M))
    scales = (1.0, I ** -0.5, R ** -0.5, 1.0, 1.0)
    return [torch.from_numpy((s * rng.randn(*sh)).astype(np.float32)).to(dtype)
            for sh, s in zip(shapes, scales, strict=True) for _ in range(2)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_cp_store_budget_holds_a_reordering_and_rejects_a_zeroed_output(dtype):
    """The budget the card holds cp_fwd and cp_bwd to (``store_budget``:
    one rounding at ``dtype`` plus the f32 order of each output's
    magnitude contraction), at the path's shape.  A second evaluation of
    the same function (in f64, rounded once to ``dtype``) is inside it;
    every output zeroed in turn (out, dx, dU_i, dU_o, dW) is outside it,
    in each dtype.  dU_i and dU_o sum over B·M = 14,112 terms: a budget
    that scales the half format's ε with that magnitude contraction
    (``contract_budget(ε, M)``) is larger than the outputs themselves."""
    tt = getattr(torch, dtype)
    ops_ = _path_operands(tt)
    want = (*sc.spectral_contract_cp_plain(*ops_[:8]), *sc.spectral_contract_cp_bwd_plain(*ops_))
    f64 = [t.double() for t in ops_]
    other = (*sc.spectral_contract_cp_plain(*f64[:8]), *sc.spectral_contract_cp_bwd_plain(*f64))
    mags = sc.cp_magnitudes(*ops_)
    names = ("out", "out", "dx", "dx", "dU_i", "dU_i", "dU_o", "dU_o", "dW", "dW")
    for name, a, b in zip(names, other, want, strict=True):
        budget = store_budget(FORMAT_EPS[dtype], b.float(), mags[name])
        assert bool(((a.to(tt).float() - b.float()).abs() <= budget).all()), name
        assert not bool((b.float().abs() <= budget).all()), f"zeroed {name} accepted"


def test_cp_plain_is_the_dense_formula():
    """The plain forward against complex numpy on the dense weight
    ``w[i,o,m] = Σ_r U_i[i,r] U_o[o,r] W[r,m]``."""
    ops_, _ = _split_operands(2)
    xr, xi, uir, uii, uor, uoi, wr, wi = (np.asarray(a, np.float64) for a in ops_)
    x, ui, uo, w = xr + 1j * xi, uir + 1j * uii, uor + 1j * uoi, wr + 1j * wi
    dense = np.einsum("ir,or,rm->iom", ui, uo, w)
    want = np.einsum("bim,iom->bom", x, dense)
    out_re, out_im = sc.spectral_contract_cp_plain(*(torch.from_numpy(a) for a in ops_))
    np.testing.assert_allclose(out_re.numpy() + 1j * out_im.numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_cp_contract_gradcheck_f64():
    ops_, _ = _split_operands(3, B=2, I=3, O=2, R=2, M=5)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in ops_]
    assert torch.autograd.gradcheck(sc.CPContract.apply, leaves)


def test_cp_contract_checks_inputs():
    ops_, _ = _split_operands(4)
    t = [torch.from_numpy(a) for a in ops_]
    with pytest.raises(TypeError, match="one dtype"):
        sc.CPContract.apply(t[0].to(torch.bfloat16), *t[1:])
    with pytest.raises(ValueError, match="disagree"):
        sc.CPContract.apply(*t[:6], t[6][:, :5], t[7][:, :5])
    with pytest.raises(ValueError, match="no kernel"):
        sc.CPContract.apply(*(a.to("meta") for a in t))
    before = (sc.launches_cp_fwd, sc.launches_cp_bwd)
    leaves = [a.requires_grad_() for a in t]
    out_re, _ = sc.CPContract.apply(*leaves)
    torch.autograd.grad(out_re.sum(), leaves)
    assert (sc.launches_cp_fwd, sc.launches_cp_bwd) == before  # CPU: plain only


# -- weights and the layer ---------------------------------------------------------------
def test_cp_weights_are_shaped_and_scaled_like_the_reference():
    g = torch.Generator().manual_seed(0)
    p = init_spectral_weights(16, 8, (4, 5), "cp", 0.5, generator=g)
    jp = jinit_spectral_weights(jax.random.PRNGKey(0), 16, 8, (4, 5), "cp", 0.5)
    assert list(p) == list(jp)
    for k, v in jp.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.float32, k
    R = cp_rank(16, 8, 0.5)
    assert R == 8 and p["lam_re"].shape == (2, R)
    # scaled normals: λ std 1/(I·O), factors std 1/√R
    assert abs(float(p["lam_im"].std()) * 16 * 8 - 1.0) < 0.5
    assert abs(float(p["U_i_re"].std()) * R ** 0.5 - 1.0) < 0.15


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16", "mixed_fno_fp16"])
def test_cp_spectral_conv_matches_reference(policy_name):
    """One CP Fourier layer, staged, against the reference's Pallas path:
    relative L2 within 1e-5 under ``full``, else within 1/4 of the
    reference layer's own gap to its ``full`` answer."""
    modes, site = (5, 4), "fno/layer0/spectral"
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 12, 9).astype(np.float32)
    params = init_spectral_weights(6, 5, modes, "cp", generator=torch.Generator().manual_seed(1))
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}

    def ref(name):
        return np.asarray(jspectral_conv_apply(jparams, jnp.asarray(x), modes, jget_policy(name),
                                               use_pallas=True, site=site, fuse_spectral=False))

    want = ref(policy_name)
    got = spectral_conv_apply(params, torch.from_numpy(x), modes, get_policy(policy_name),
                              site=site).numpy()
    assert got.shape == want.shape == (2, 5, 12, 9)
    limit = 1e-5 if policy_name == "full" else 0.25 * rel_err(want, ref("full"))
    assert rel_err(got, want) <= limit


def test_grid_too_small_for_the_modes_is_refused():
    params = init_spectral_weights(2, 2, (4, 4), "cp", generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cannot retain modes"):
        spectral_conv_apply(params, torch.zeros(1, 2, 7, 8), (4, 4))
    with pytest.raises(ValueError, match="cannot retain modes"):
        spectral_conv_apply(params, torch.zeros(1, 2, 8, 5), (4, 4))
    spectral_conv_apply(params, torch.zeros(1, 2, 8, 6), (4, 4))   # the smallest grid


# -- the whole TFNO ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bridged():
    jparams = jfno.init_fno(jax.random.PRNGKey(3), J_CFG)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 1, 24, 24).astype(np.float32)
    y = rng.randn(2, 1, 24, 24).astype(np.float32)
    return jparams, tree, x, y


def _reference_infer(jparams, x, policy_name):
    return np.asarray(jfno.fno_infer(jparams, jnp.asarray(x), J_CFG, jget_policy(policy_name)))


@pytest.fixture(scope="module")
def reference_full(bridged):
    jparams, _, x, _ = bridged
    return _reference_infer(jparams, x, "full")


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_tfno_infer_matches_reference(bridged, reference_full, policy_name):
    """``TFNO_NS_SMOKE`` on 2 fields at 24², eager reference: relative L2
    <= 1e-5 under ``full``; otherwise <= 1/4 of the policy's own
    mixed-vs-full relative L2 in the reference."""
    jparams, tree, x, _ = bridged
    net = params_from_jax(tree, TFNO_NS_SMOKE, device="cpu")
    want = _reference_infer(jparams, x, policy_name)
    got = fno_infer(net, x, get_policy(policy_name), device="cpu").numpy()
    assert got.shape == want.shape == (2, 1, 24, 24) and got.dtype == np.float32
    err = rel_err(got, want)
    limit = 1e-5 if policy_name == "full" else 0.25 * rel_err(want, reference_full)
    print(f"{policy_name}: port vs reference relative L2 {err:.3e} (limit {limit:.3e})")
    assert err <= limit, (err, limit)


@pytest.fixture(scope="module")
def full_grads(bridged):
    from test_torch_train import _jgrads

    jparams, _, x, y = bridged
    return _jgrads(jparams, x, y, "full", unrolled=True, cfg=J_CFG)


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_tfno_gradients_match_reference(bridged, full_grads, policy_name, monkeypatch):
    """Per parameter leaf of ``TFNO_NS_SMOKE`` (the CP factors included),
    the gradient of the relative L² loss against ``jax.grad`` of the
    reference, with the limits, the unrolled block loop, the bias-sum
    emulation and the tanh cotangent order of
    ``test_torch_train.test_fno_gradients_match_reference``: 1e-5 under
    ``full``, else 1/4 of the policy's own gradient gap to ``full`` in the
    reference (0.95x against the unchanged reference).

    Relative L², not the H¹ loss the NS trainer uses: the H¹ gradient's
    Laplacian term has zero spatial mean, so a bias gradient (a sum over
    positions) cancels to a small remainder whose error against the
    policy's gap measures f32 summation order, not precision (FNO_DARCY_SMOKE
    under amp_fp16 reads 3.6x on ``proj2.b``).  ``relative_h1`` and its
    gradient are held to the reference in ``test_torch_ns.py``."""
    jparams, tree, x, y = bridged
    check_fno_gradients(jparams, tree, x, y, full_grads, policy_name, monkeypatch,
                        jcfg=J_CFG, tcfg=TFNO_NS_SMOKE)


def test_tfno_params_round_trip_and_count(bridged):
    _, tree, _, _ = bridged
    net = params_from_jax(tree, TFNO_NS_SMOKE, device="cpu")
    state = net.state_dict()
    assert len(state) == sum(len(v) for v in tree.values())
    for group, sub in tree.items():
        for name, v in sub.items():
            np.testing.assert_array_equal(state[f"{group}.{name}"].numpy(), v)
    assert set(tree["spectral"]) == {"lam_re", "lam_im"} | {
        f"U_{n}_{p}" for n in ("i", "o", "m0", "m1") for p in ("re", "im")}
    with pytest.raises(RuntimeError):   # a missing factor is refused
        params_from_jax({**tree, "spectral": {k: v for k, v in tree["spectral"].items()
                                              if k != "U_m1_im"}},
                        TFNO_NS_SMOKE, device="cpu")


def test_tfno_init_is_seeded_and_shaped_like_the_reference():
    a = init_fno(torch.Generator().manual_seed(0), TFNO_NS_SMOKE, device="cpu")
    b = init_fno(torch.Generator().manual_seed(0), TFNO_NS_SMOKE, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items(), strict=True):
        assert ka == kb and torch.equal(va, vb)
    jshapes = jax.tree_util.tree_map(lambda v: tuple(v.shape),
                                     jfno.init_fno(jax.random.PRNGKey(0), J_CFG))
    for group, sub in jshapes.items():
        for name, shape in sub.items():
            assert tuple(a.state_dict()[f"{group}.{name}"].shape) == shape


def test_full_width_tfno_config_matches_the_reference():
    for f in dataclasses.fields(TFNO_NS):
        assert getattr(TFNO_NS, f.name) == getattr(J_TFNO_NS, f.name), f.name
    for f in dataclasses.fields(TFNO_NS_SMOKE):
        assert getattr(TFNO_NS_SMOKE, f.name) == getattr(J_SMOKE, f.name), f.name
    # the paper's TFNO: R = 64 and 269,121 parameters
    net = init_fno(torch.Generator().manual_seed(0), TFNO_NS, device="cpu")
    assert net.spectral["lam_re"].shape == (4, 2, 64)
    assert param_count(net) == 269_121


def test_tfno_engine_serves_batched_as_solo_and_refuses_small_grids():
    net = init_fno(torch.Generator().manual_seed(0), TFNO_NS_SMOKE, device="cpu")
    policy = get_policy("mixed_fno_bf16")
    rng = np.random.RandomState(1)
    xs = [rng.randn(1, 16, 16).astype(np.float32) for _ in range(3)]
    engine = OperatorEngine(net, policy=policy, max_batch=4, device="cpu")
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(xs)]
    small = FieldRequest(uid=9, x=np.zeros((1, 15, 16), np.float32))
    for r in reqs:
        assert engine.submit(r)
    assert not engine.submit(small)
    done, _ = engine.drain()
    assert small.status == "failed" and "cannot retain modes" in small.error
    assert all(r.status == "done" and r.y.shape == (1, 16, 16) for r in reqs)
    solo = OperatorEngine(net, policy=policy, max_batch=4, device="cpu")
    alone = FieldRequest(uid=0, x=xs[1])
    solo.submit(alone)
    solo.drain()
    assert np.array_equal(alone.y, reqs[1].y)


# -- the CP kernels' channel plans -----------------------------------------------------
@pytest.mark.parametrize("width", [1, 16, 64, 75, 76, 104, 105, 128, 160, 256, 558])
def test_cp_channel_plans_fit_a_block_at_every_width(width):
    """``cp_fwd`` and ``cp_bwd`` tile the channel axes, so every width fits a
    block's shared memory.  cp_fwd keeps its factors resident up to the
    path's widths (I = O = R = 64) and streams them a chunk at a time past
    them, in every operand dtype; cp_bwd walks 64-wide chunks of every axis,
    so its block is one size at any width, and where every width fits one
    chunk it keeps dU_i/dU_o on chip across its items."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        plan = sc.cp_fwd_plan(width, width, width, dtype)
        assert plan.smem <= sc.SMEM_LIMIT and plan.resident == (width <= 64)
        bwd = sc.cp_bwd_plan(width, width, width, dtype)
        assert bwd.smem <= sc.SMEM_LIMIT
        assert bwd.smem == sc.cp_bwd_plan(1, 1, 1, dtype).smem
        assert (bwd.IC, bwd.OC) == (min(width, 64), min(width, 64))
        assert bwd.acc_smem == (width <= 64)


@pytest.mark.parametrize("R", [559, 784, 2048, 4096])
def test_cp_plans_take_any_rank(R):
    """Both CP kernels walk the rank in 64-wide chunks whose sums carry over,
    so neither refuses a rank: past cp_bwd's old limit (R <= 558) and
    cp_fwd's (R <= 784) each plan fits 227 KB, and cp_bwd's bytes are the
    library's (``spectral_contract_cp_bwd_smem``, the formula
    ``_cp_bwd_smem`` restates and the card test holds it to), at any
    channel widths beside the rank."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        size = torch.empty((), dtype=dtype).element_size()
        for I, O in ((1, 1), (64, 64), (3000, 2000)):
            assert sc.cp_fwd_plan(I, O, R, dtype).smem <= sc.SMEM_LIMIT
            plan = sc.cp_bwd_plan(I, O, R, dtype)
            assert plan.smem == sc._cp_bwd_smem(size) <= sc.SMEM_LIMIT
            assert (plan.IC, plan.OC, plan.acc_smem) == (min(I, 64), min(O, 64), False)
