"""The PyTorch port's SFNO against the JAX reference on the CPU, at smoke
sizes.

The same numpy inputs, and weights bridged with ``sfno_params_from_jax``,
go through both packages.  The reference runs its order-shared Pallas
kernels in interpret mode (``use_pallas=True``), as the TPU always does,
with its block loop unrolled: its ``lax.scan`` compiles the block, and
XLA then skips some half roundings.

* the SHT (``legendre_matrices``, ``sht_forward``, ``sht_inverse``) and
  the m = 0 real-part rule of the synthesis;
* the three order-shared contractions (``ls_fwd``, ``ls_bwd_x``,
  ``ls_bwd_w``) against the reference's kernels, within ``store_budget``;
  ``LSharedContract`` against the custom VJP, and an f64 gradcheck;
* ``SFNO_SWE_SMOKE``: the forward and per-leaf gradients under every
  policy, weights, serving and the trainer.

**Yardstick of the half policies.**  Under a policy whose spectral sites
quantise, the tanh stabiliser is on, and it moves the output by ~9e-2
relative L2 from ``full``: a quarter of that gap would pass many wrong
roundings.  The half policies are held instead to the reference's own
*store gap* g(P): the relative L2 between the reference under P and the
reference under P with its contraction storing at f32 (one half rounding
stage, the contraction's store, left out; the tanh in both).  A port that
skips or adds a rounding stage of that size differs from the reference by
about g(P); one whose f32 sums run in another order flips the rounding of
a few elements only.  The limit is g(P)/2, which
``test_store_gap_yardstick_rejects_a_contraction_that_skips_its_store``
shows rejects the contraction without its store under every half policy.
It is tighter than a quarter of the reference's AMP gap in the same half
dtype under every policy (2.9e-4 under fp16, 2.2e-3 under bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.fno as jfno
import repro.models.sfno as jsfno
import repro.models.sht as jsht
from repro.configs.fno_paper import SFNO_SWE as J_SFNO_SWE
from repro.configs.fno_paper import SFNO_SWE_SMOKE as J_SMOKE
from repro.core import PrecisionSchedule as JSchedule
from repro.core import get_policy as jget_policy
from repro.kernels import ops as jops
from repro.kernels.spectral_contract import spectral_contract_lshared_pallas
from repro.optim import AdamW as JAdamW
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import relative_l2 as jrelative_l2
from repro_torch.configs.fno_paper import SFNO_SWE, SFNO_SWE_SMOKE
from repro_torch.core.precision import FORMAT_EPS
from repro_torch.core.schedule import PrecisionSchedule
from repro_torch.core.theory import store_budget
from repro_torch.kernels import ops
from repro_torch.kernels import spectral_contract as sc
from repro_torch.models import (
    SFNO,
    SFNOConfig,
    init_sfno,
    legendre_matrices,
    param_count,
    sfno_apply,
    sfno_infer,
    sfno_params_from_jax,
    sht_forward,
    sht_inverse,
)
from repro_torch.models import sfno as tsfno
from repro_torch.optim import AdamW
from repro_torch.precision import get_policy
from repro_torch.serve import FieldRequest, OperatorEngine
from repro_torch.train import Trainer, TrainerConfig, relative_l2

from helpers import POLICY_NAMES, rel_err
from test_torch_train import check_fno_gradients

jax.config.update("jax_platform_name", "cpu")

#: the reference through its order-shared Pallas kernels (interpret mode)
J_CFG = dataclasses.replace(J_SMOKE, use_pallas=True)

#: operand dtypes of the order-shared kernels on the path
DTYPES = ["float32", "bfloat16", "float16"]

#: policies whose spectral sites quantise (tanh on): held to the store gap
HALF_POLICIES = [n for n in POLICY_NAMES
                 if get_policy(n).at("sfno/layer0/spectral/contract").spectral_is_half]


# -- the SHT ---------------------------------------------------------------------------
def test_legendre_matrices_equal_the_reference():
    for args in ((16, 8, 8), (33, 12, 7)):
        for got, want in zip(legendre_matrices(*args), jsht.legendre_matrices(*args),
                             strict=True):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,lmax,mmax", [((2, 3, 16, 32), 8, 8), ((1, 15, 20), 10, 11)])
def test_sht_matches_reference(shape, lmax, mmax):
    """Forward and inverse against the reference on the same input: both
    are f32 matrix products of the same f32 Legendre matrices, differing
    only in the order of the sums (two real products here, one complex
    einsum there), so within 1e-6 of the output's largest magnitude."""
    rng = np.random.RandomState(0)
    f = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jsht.sht_forward(jnp.asarray(f), lmax, mmax))
    got = sht_forward(torch.from_numpy(f), lmax, mmax)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    c = (rng.randn(*want.shape) + 1j * rng.randn(*want.shape)).astype(np.complex64)
    want = np.asarray(jsht.sht_inverse(jnp.asarray(c), shape[-2], shape[-1]))
    got = sht_inverse(torch.from_numpy(c), shape[-2], shape[-1])
    assert got.dtype == torch.float32 and got.shape == want.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_sht_round_trip_on_a_band_limited_field():
    """Synthesis then analysis returns the coefficients of a band-limited
    real field (lmax <= nlat - 1, real m = 0 column, zero for m > l) to
    f32 accuracy."""
    nlat, nlon, L = 24, 48, 12
    rng = np.random.RandomState(1)
    c = rng.randn(2, L, L) + 1j * rng.randn(2, L, L)
    c *= np.tril(np.ones((L, L)))
    c[..., 0] = c[..., 0].real
    c = torch.from_numpy(c.astype(np.complex64))
    back = sht_forward(sht_inverse(c, nlat, nlon), L, L)
    np.testing.assert_allclose(back.numpy(), c.numpy(), rtol=0, atol=1e-5)


def test_sht_inverse_keeps_the_real_part_of_the_zero_and_nyquist_bins():
    """A spectrum whose m = 0 column (and Nyquist column, when mmax
    reaches nlon/2 + 1) is complex, as the contraction leaves it: the
    synthesis reads only those bins' real parts, as the reference's
    pocketfft does, bit for bit the same as with them made real."""
    rng = np.random.RandomState(2)
    for nlon, mmax in ((32, 8), (32, 17)):
        c = (rng.randn(3, 8, mmax) + 1j * rng.randn(3, 8, mmax)).astype(np.complex64)
        real_edges = c.copy()
        real_edges[..., 0] = c[..., 0].real
        if mmax == nlon // 2 + 1:
            real_edges[..., -1] = c[..., -1].real
        got = sht_inverse(torch.from_numpy(c), 16, nlon).numpy()
        np.testing.assert_array_equal(got, sht_inverse(torch.from_numpy(real_edges), 16,
                                                       nlon).numpy())
        want = np.asarray(jsht.sht_inverse(jnp.asarray(c), 16, nlon))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
        assert not np.allclose(got, sht_inverse(torch.from_numpy(c.real.astype(np.complex64)),
                                                16, nlon).numpy())


def test_sht_refuses_more_orders_than_the_grid_has():
    with pytest.raises(ValueError, match="orders"):
        sht_forward(torch.zeros(1, 8, 16), 8, 10)


# -- the order-shared contraction ---------------------------------------------------------
#: (B, I, O, L, M): SFNO_SWE_SMOKE's shape, and a ragged one (L = 37 is no
#: multiple of the reference's block_l = 8)
SHAPES = [(2, 8, 8, 8, 8), (3, 5, 7, 37, 29)]


def _ls_operands(seed, shape, dtype):
    """x, w and a cotangent g as split-real numpy pairs, rounded to ``dtype``."""
    B, I, O, L, M = shape
    rng = np.random.RandomState(seed)
    shapes = [(B, I, L, M)] * 2 + [(I, O, L)] * 2 + [(B, O, L, M)] * 2
    jt = getattr(jnp, dtype)
    return [np.array(jnp.asarray((0.5 * rng.randn(*s)).astype(np.float32), jt)
                     .astype(jnp.float32)) for s in shapes]


def _within_store_budget(got, want, mag, dtype):
    """Each part within one rounding at ``dtype`` plus the f32 order term
    of its magnitude contraction (``store_budget``): the reference and the
    port multiply the same operands exactly and differ only in the order of
    their f32 sums."""
    want = np.asarray(want, np.float32)
    budget = store_budget(FORMAT_EPS[dtype], want, mag.numpy())
    return bool(np.all(np.abs(got.float().numpy() - want) <= budget))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_lshared_plain_versions_match_pallas_kernels(shape, dtype):
    """``ls_fwd``, ``ls_bwd_x`` and ``ls_bwd_w``'s plain versions against
    the reference's ``_lshared_fwd_kernel``, ``_lshared_bwd_x_kernel`` and
    ``_lshared_bwd_w_kernel`` (interpret mode, block_l = 8), every operand
    and the cotangent at ``dtype``, within ``store_budget``; the results at
    ``dtype`` in both."""
    xr, xi, wr, wi, gr, gi = _ls_operands(3, shape, dtype)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda *a: spectral_contract_lshared_pallas(*a, block_l=8,
                                                                   interpret=True),
                       *(jnp.asarray(a, jt) for a in (xr, xi, wr, wi)))
    dx_r, dx_i, dw_r, dw_i = vjp((jnp.asarray(gr, jt), jnp.asarray(gi, jt)))
    t = [torch.from_numpy(a).to(tt) for a in (xr, xi, wr, wi, gr, gi)]
    mags = sc.lshared_magnitudes(*(a.double() for a in t))
    got_out = sc.spectral_contract_lshared_plain(*t[:4])
    got_dx = sc.spectral_contract_lshared_bwd_x_plain(t[4], t[5], t[2], t[3])
    got_dw = sc.spectral_contract_lshared_bwd_w_plain(t[0], t[1], t[4], t[5])
    for name, got, want in (("out", got_out, out), ("dx", got_dx, (dx_r, dx_i)),
                            ("dw", got_dw, (dw_r, dw_i))):
        for g, w in zip(got, want, strict=True):
            assert g.dtype == tt and w.dtype == jt and tuple(g.shape) == w.shape
            assert _within_store_budget(g, w, mags[name], dtype), f"{name} {dtype} {shape}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_lshared_contract_grads_match_custom_vjp(dtype):
    """``LSharedContract`` under autograd against ``jax.vjp`` of the
    reference's custom VJP at the ragged shape: dx and dw at ``dtype``,
    within ``store_budget``."""
    shape = SHAPES[1]
    xr, xi, wr, wi, gr, gi = _ls_operands(4, shape, dtype)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda *a: spectral_contract_lshared_pallas(*a, block_l=8,
                                                                 interpret=True),
                     *(jnp.asarray(a, jt) for a in (xr, xi, wr, wi)))
    want = vjp((jnp.asarray(gr, jt), jnp.asarray(gi, jt)))
    leaves = [torch.from_numpy(a).to(tt).requires_grad_() for a in (xr, xi, wr, wi)]
    out = sc.LSharedContract.apply(*leaves)
    got = torch.autograd.grad(out, leaves, [torch.from_numpy(a).to(tt) for a in (gr, gi)])
    mags = sc.lshared_magnitudes(*(torch.from_numpy(a).double()
                                   for a in (xr, xi, wr, wi, gr, gi)))
    for k, name in enumerate(("dx", "dx", "dw", "dw")):
        assert got[k].dtype == tt
        assert _within_store_budget(got[k], want[k], mags[name], dtype), f"{name} {dtype}"


def test_lshared_plain_is_the_complex_formula():
    xr, xi, wr, wi, gr, gi = (a.astype(np.float64) for a in _ls_operands(5, SHAPES[1],
                                                                          "float32"))
    x, w, g = xr + 1j * xi, wr + 1j * wi, gr + 1j * gi
    t = [torch.from_numpy(a) for a in (xr, xi, wr, wi, gr, gi)]
    for (re, im), want in (
            (sc.spectral_contract_lshared_plain(*t[:4]), np.einsum("bilm,iol->bolm", x, w)),
            (sc.spectral_contract_lshared_bwd_x_plain(t[4], t[5], t[2], t[3]),
             np.einsum("bolm,iol->bilm", g, np.conj(w))),
            (sc.spectral_contract_lshared_bwd_w_plain(t[0], t[1], t[4], t[5]),
             np.einsum("bilm,bolm->iol", np.conj(x), g))):
        assert re.dtype == torch.float64
        np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), want, rtol=1e-12, atol=1e-12)


def test_lshared_contract_gradcheck_f64():
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in _ls_operands(6, (2, 3, 2, 4, 3), "float32")[:4]]
    assert torch.autograd.gradcheck(sc.LSharedContract.apply, leaves)


def test_lshared_contract_checks_inputs_and_launches_nothing_on_cpu():
    t = [torch.from_numpy(a) for a in _ls_operands(7, SHAPES[0], "float32")[:4]]
    with pytest.raises(TypeError, match="one dtype"):
        sc.LSharedContract.apply(t[0].to(torch.bfloat16), *t[1:])
    with pytest.raises(ValueError, match="disagree"):
        sc.LSharedContract.apply(*t[:2], t[2][:, :, :5], t[3][:, :, :5])
    with pytest.raises(ValueError, match="expected"):
        sc.LSharedContract.apply(t[0][0], t[1][0], *t[2:])
    with pytest.raises(ValueError, match="no kernel"):
        sc.LSharedContract.apply(*(a.to("meta") for a in t))
    before = (sc.launches_ls_fwd, sc.launches_ls_bwd_x, sc.launches_ls_bwd_w)
    leaves = [a.requires_grad_() for a in t]
    out_re, _ = sc.LSharedContract.apply(*leaves)
    torch.autograd.grad(out_re.sum(), leaves)
    assert (sc.launches_ls_fwd, sc.launches_ls_bwd_x, sc.launches_ls_bwd_w) == before


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16", "mixed_fno_fp16"])
def test_ops_lshared_matches_reference_ops(policy_name):
    """``ops.spectral_contract_lshared`` (the rounding of x and w to the
    site's storage dtype, the kernel, complex64 out) against the
    reference's, within ``store_budget`` at the storage dtype."""
    site = "sfno/layer0/spectral/contract"
    jsite, tsite = jget_policy(policy_name).at(site), get_policy(policy_name).at(site)
    xr, xi, wr, wi, _, _ = _ls_operands(8, SHAPES[1], "float32")
    x, w = (xr + 1j * xi).astype(np.complex64), (wr + 1j * wi).astype(np.complex64)
    want = np.asarray(jops.spectral_contract_lshared(x, w, policy=jsite, block_l=8))
    got = ops.spectral_contract_lshared(torch.from_numpy(x), torch.from_numpy(w), policy=tsite)
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    half = tsite.spectral_dtype or torch.float32
    parts = [torch.from_numpy(a).to(half) for a in (xr, xi, wr, wi)]
    mag = sc.lshared_magnitudes(*parts)["out"]
    dtype = str(half).removeprefix("torch.")
    assert _within_store_budget(got.real, want.real, mag, dtype)
    assert _within_store_budget(got.imag, want.imag, mag, dtype)


# -- the whole SFNO ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bridged():
    jparams = jsfno.init_sfno(jax.random.PRNGKey(0), J_CFG)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 16, 32).astype(np.float32)
    y = (0.1 * rng.randn(2, 3, 16, 32)).astype(np.float32)
    return jparams, tree, x, y


def _unrolled(fn, *args):
    """Run ``fn`` with the reference's block loop unrolled (eager)."""
    uniform = jfno.layers_uniform
    jfno.layers_uniform = lambda *a: False
    try:
        return fn(*args)
    finally:
        jfno.layers_uniform = uniform


class _store_at_f32:
    """Within: the reference's order-shared contraction stores its result
    at f32 (the half rounding of its store left out)."""

    def __enter__(self):
        self.orig = jops.spectral_contract_lshared_pallas

        def f32_store(*a, **k):
            return self.orig(*a, **{**k, "out_dtype": jnp.float32})

        jops.spectral_contract_lshared_pallas = f32_store

    def __exit__(self, *exc):
        jops.spectral_contract_lshared_pallas = self.orig


def _reference_infer(jparams, x, policy_name):
    return np.asarray(_unrolled(jsfno.sfno_infer, jparams, jnp.asarray(x), J_CFG,
                                jget_policy(policy_name)))


@pytest.fixture(scope="module")
def reference(bridged):
    """The reference's answers per policy, and without its store under the
    half policies."""
    jparams, _, x, _ = bridged
    out = {p: _reference_infer(jparams, x, p) for p in POLICY_NAMES}
    with _store_at_f32():
        no_store = {p: _reference_infer(jparams, x, p) for p in HALF_POLICIES}
    return out, no_store


def _limit(reference, policy_name):
    """1e-5 under ``full``; under a half policy half the store gap (module
    docstring); under an AMP policy, whose spectral path is f32 and has no
    tanh, a quarter of its own gap to ``full``."""
    out, no_store = reference
    if policy_name == "full":
        return 1e-5
    if policy_name in no_store:
        return 0.5 * rel_err(out[policy_name], no_store[policy_name])
    return 0.25 * rel_err(out[policy_name], out["full"])


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_sfno_infer_matches_reference(bridged, reference, policy_name):
    """``SFNO_SWE_SMOKE`` on 2 fields at 16x32 against the reference's
    eager forward, within ``_limit``."""
    _, tree, x, _ = bridged
    net = sfno_params_from_jax(tree, SFNO_SWE_SMOKE, device="cpu")
    want = reference[0][policy_name]
    got = sfno_infer(net, x, get_policy(policy_name), device="cpu").numpy()
    assert got.shape == want.shape == (2, 3, 16, 32) and got.dtype == np.float32
    err, limit = rel_err(got, want), _limit(reference, policy_name)
    print(f"{policy_name}: port vs reference relative L2 {err:.3e} (limit {limit:.3e})")
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("policy_name", HALF_POLICIES)
def test_store_gap_yardstick_rejects_a_contraction_that_skips_its_store(
        bridged, reference, policy_name, monkeypatch):
    """The port with a contraction that returns its f32 sums instead of
    storing them at the half dtype is outside the half policies' limit,
    and the limit is tighter than a quarter of the reference's AMP gap in
    the same half dtype."""
    _, tree, x, _ = bridged
    plain = sc.spectral_contract_lshared_plain

    def no_store(xr, xi, wr, wi):
        return plain(*(t.float() for t in (xr, xi, wr, wi)))

    monkeypatch.setattr(sc, "spectral_contract_lshared_plain", no_store)
    net = sfno_params_from_jax(tree, SFNO_SWE_SMOKE, device="cpu")
    got = sfno_infer(net, x, get_policy(policy_name), device="cpu").numpy()
    err, limit = rel_err(got, reference[0][policy_name]), _limit(reference, policy_name)
    amp = "amp_bf16" if "bf16" in policy_name else "amp_fp16"
    amp_gap = rel_err(reference[0][amp], reference[0]["full"])
    print(f"{policy_name}: without the store {err:.3e} (limit {limit:.3e}, "
          f"1/4 AMP gap {0.25 * amp_gap:.3e})")
    assert err > limit and limit < 0.25 * amp_gap


#: the gradients are taken of the loss scaled by the trainer's initial loss
#: scale, as the fp16 policies train: unscaled, the relative L² loss's
#: cotangents at this size fall into fp16's subnormal range, where a last-bit
#: difference of the f32 transforms flips the rounding of percents of the
#: elements.  A power of two, so exact in f32 and bf16.
LOSS_SCALE = 2.0 ** 15


def _jscaled(pred, target):
    return LOSS_SCALE * jrelative_l2(pred, target)


def _tscaled(pred, target):
    return LOSS_SCALE * relative_l2(pred, target)


@pytest.fixture(scope="module")
def ref_grads(bridged):
    """The reference's gradients under ``full`` and the two AMP policies."""
    from test_torch_train import _jgrads

    jparams, _, x, y = bridged
    return {p: _jgrads(jparams, x, y, p, unrolled=True, cfg=J_CFG, loss=_jscaled,
                       apply=jsfno.sfno_apply)
            for p in ("full", "amp_bf16", "amp_fp16")}


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_sfno_gradients_match_reference(bridged, ref_grads, policy_name, monkeypatch):
    """Per parameter leaf of ``SFNO_SWE_SMOKE`` (``spectral.w_re``/``w_im``
    included), the gradient of the scaled relative L² loss against
    ``jax.grad`` of the reference, with the unrolled loop, the bias-sum
    emulation and the tanh cotangent order of
    ``test_torch_train.test_fno_gradients_match_reference``: 1e-5 under
    ``full``; under an AMP policy 1/4 of its gradient gap to ``full``; and
    under a half policy 1/4 of the reference's gradient gap between the
    AMP policy of the same half dtype and ``full``, which leaves the tanh
    out.  The forward's store gap is no yardstick here: a leaf's gradient
    also carries the half roundings of its cotangents, whose last-bit
    flips move ``spectral.w_im`` under ``half_fno_only`` by half its store
    gap.  Against the unchanged reference (JAX's tanh cotangent order),
    0.95 of the policy's gap to ``full``, as for the FNO."""
    jparams, tree, x, y = bridged
    gap = None
    if policy_name in HALF_POLICIES:
        gap = ref_grads["amp_bf16" if "bf16" in policy_name else "amp_fp16"]
    check_fno_gradients(
        jparams, tree, x, y, ref_grads["full"], policy_name, monkeypatch, jcfg=J_CFG,
        tcfg=SFNO_SWE_SMOKE, jloss=_jscaled, tloss=_tscaled, japply=jsfno.sfno_apply,
        tmodule=tsfno, tbuild=sfno_params_from_jax, gap_grads=gap)


def test_sfno_params_round_trip_and_strict(bridged):
    _, tree, _, _ = bridged
    net = sfno_params_from_jax(tree, SFNO_SWE_SMOKE, device="cpu")
    state = net.state_dict()
    assert len(state) == sum(len(v) for v in tree.values())
    for group, sub in tree.items():
        for name, v in sub.items():
            np.testing.assert_array_equal(state[f"{group}.{name}"].numpy(), v)
    assert state["spectral.w_re"].shape == (2, 8, 8, 8)
    with pytest.raises(RuntimeError):   # a missing entry is refused
        sfno_params_from_jax({k: v for k, v in tree.items() if k != "skips"},
                             SFNO_SWE_SMOKE, device="cpu")
    with pytest.raises(RuntimeError):   # so is a wrong shape
        sfno_params_from_jax(tree, dataclasses.replace(SFNO_SWE_SMOKE, lmax=6), device="cpu")


def test_init_sfno_is_seeded_and_shaped_like_the_reference():
    a = init_sfno(torch.Generator().manual_seed(0), SFNO_SWE_SMOKE, device="cpu")
    b = init_sfno(torch.Generator().manual_seed(0), SFNO_SWE_SMOKE, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items(), strict=True):
        assert ka == kb and torch.equal(va, vb)
    jshapes = jax.tree_util.tree_map(lambda v: tuple(v.shape),
                                     jsfno.init_sfno(jax.random.PRNGKey(0), J_CFG))
    for group, sub in jshapes.items():
        for name, shape in sub.items():
            assert tuple(a.state_dict()[f"{group}.{name}"].shape) == shape
    # the reference's scales: spectral normals / H, linear weights / √d_in
    H = SFNO_SWE_SMOKE.hidden_channels
    assert abs(float(a.spectral["w_re"].detach().std()) * H - 1.0) < 0.15
    assert abs(float(a.lift2["w"].detach().std()) * SFNO_SWE_SMOKE.lifting_channels ** 0.5 - 1.0) < 0.3


def test_full_width_sfno_config_matches_the_reference():
    for cfg, jcfg in ((SFNO_SWE, J_SFNO_SWE), (SFNO_SWE_SMOKE, J_SMOKE)):
        for f in dataclasses.fields(SFNOConfig):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    with torch.device("meta"):
        net = SFNO(SFNO_SWE)
    assert param_count(net) == 4_228_419
    assert net.spectral["w_re"].numel() + net.spectral["w_im"].numel() == 4_194_304


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    net = init_sfno(torch.Generator().manual_seed(0), SFNO_SWE_SMOKE, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_sfno(torch.Generator().manual_seed(0), SFNO_SWE_SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sfno_infer(net, np.zeros((1, 3, 16, 32), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OperatorEngine(net, model="sfno")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(lambda *a: None, net, TrainerConfig())


# -- serving -------------------------------------------------------------------------------
def test_sfno_engine_serves_batched_as_solo_and_refuses_other_grids():
    net = init_sfno(torch.Generator().manual_seed(0), SFNO_SWE_SMOKE, device="cpu")
    policy = get_policy("mixed_fno_bf16")
    rng = np.random.RandomState(1)
    xs = [rng.randn(3, 16, 32).astype(np.float32) for _ in range(3)]
    engine = OperatorEngine(net, model="sfno", policy=policy, max_batch=4, device="cpu")
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(xs)]
    wrong = [FieldRequest(uid=9, x=np.zeros((3, 32, 64), np.float32)),
             FieldRequest(uid=10, x=np.zeros((1, 16, 32), np.float32))]
    for r in reqs:
        assert engine.submit(r)
    for r in wrong:
        assert not engine.submit(r)
    engine.drain()
    assert wrong[0].status == "failed" and "grid is fixed at (16, 32)" in wrong[0].error
    assert "channels" in wrong[1].error
    assert all(r.status == "done" and r.y.shape == (3, 16, 32) for r in reqs)
    want = sfno_infer(net, np.stack(xs), policy, device="cpu").numpy()
    solo = OperatorEngine(net, model="sfno", policy=policy, max_batch=4, device="cpu")
    alone = FieldRequest(uid=0, x=xs[1])
    solo.submit(alone)
    solo.drain()
    assert np.array_equal(alone.y, reqs[1].y)
    np.testing.assert_allclose(reqs[1].y, want[1], rtol=0, atol=0)
    assert engine.stats()["model"] == "sfno"


def test_sfno_engine_refuses_what_is_not_ported_or_mismatched(tmp_path):
    """``calibration_state`` is ported now (the test keeps its name): the
    engine activates the state and serves the order-shared layer at its
    tiles; the mismatch refusals stay."""
    from repro_torch.kernels import ops
    from repro_torch.tune import cache

    net = init_sfno(torch.Generator().manual_seed(0), SFNO_SWE_SMOKE, device="cpu")
    L, M = net.cfg.lmax, net.cfg.mmax
    key = (2, net.cfg.hidden_channels, net.cfg.hidden_channels, L, M)
    state = cache.CalibrationCache(entries={}, backend="cpu")
    state.put({"family": "lshared", "shape": list(key), "dtype": "float32", "backend": "cpu",
               "kernel_version": cache.KERNEL_VERSION, "block_fwd": 1, "block_bwd": 1,
               "validated": True})
    path = str(cache.save(state, tmp_path / "s.json"))
    try:
        engine = OperatorEngine(net, model="sfno", device="cpu", calibration_state=path,
                                max_batch=2)
        x = np.random.RandomState(0).randn(3, 16, 32).astype(np.float32)
        engine.submit(FieldRequest(uid=0, x=x))
        engine.drain()
        tiles = engine.stats()["tiles"]
        assert tiles["calibration_state"] == path
        assert tiles["cache"] == {"hits": net.cfg.n_layers, "misses": 0, "stale": 0}
        assert tiles["sources"]["calibrated"] >= net.cfg.n_layers
    finally:
        cache.activate(None)
        ops.reset_tile_resolution_stats()
    # telemetry is ported: the engine collects it (tests/test_torch_autoprec.py)
    assert "numerics" in OperatorEngine(net, model="sfno", device="cpu",
                                        telemetry=True).stats()
    with pytest.raises(ValueError, match="needs a FNOConfig network"):
        OperatorEngine(net, model="fno", device="cpu")


# -- training ------------------------------------------------------------------------------
def _swe_batches(n_steps):
    """Inputs and a learnable target at a tenth of the prediction's scale
    (see ``test_torch_train._batches``)."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n_steps):
        x = rng.randn(2, 3, 16, 32).astype(np.float32)
        y = 0.05 * (np.roll(x, 1, axis=-1) + 0.5 * x ** 2)
        out.append({"x": x, "y": y.astype(np.float32)})
    return out


def _jloss(p, batch, policy):
    return jrelative_l2(jsfno.sfno_apply(p, batch["x"], J_CFG, policy), batch["y"])


def _tloss(model, batch, policy):
    return relative_l2(sfno_apply(model, batch["x"], policy), batch["y"])


def test_trainer_matches_reference_trainer(bridged):
    """3 ``full`` steps of the port's ``Trainer`` on an SFNO against the
    reference ``Trainer``: each step's loss within 1e-5 relative, the
    parameters after them within 1e-4 relative L2 per leaf (AdamW's
    division by √ν amplifies the f32 order of the gradients), as in
    ``test_torch_train.test_trainer_full_matches_reference``."""
    jparams, tree, _, _ = bridged
    steps, batches = 3, _swe_batches(3)
    jt = JTrainer(_jloss, jparams, JTrainerConfig(total_steps=steps, optimizer=JAdamW(lr=1e-3),
                                                  schedule=JSchedule.constant("full")))
    jhist = jt.run(lambda s: {k: jnp.asarray(v) for k, v in batches[s].items()})
    net = sfno_params_from_jax(tree, SFNO_SWE_SMOKE, device="cpu")
    tt = Trainer(_tloss, net, TrainerConfig(total_steps=steps, optimizer=AdamW(lr=1e-3),
                                            schedule=PrecisionSchedule.constant("full")),
                 device="cpu")
    thist = tt.run(lambda s: batches[s])
    for j, t in zip(jhist, thist, strict=True):
        assert t["policy"] == j["policy"] == "full"
        assert abs(t["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"]), (t["loss"], j["loss"])
    for k, v in jax.tree_util.tree_map(np.asarray, jt.params).items():
        for n, w in v.items():
            assert rel_err(tt.params[f"{k}.{n}"].detach().numpy(), w) <= 1e-4, f"{k}.{n}"


def test_paper_schedule_trains_an_sfno():
    """``paper_default("bf16")`` over 4 steps on the CPU: the schedule's
    policies in order, finite losses, no skipped step."""
    net = init_sfno(torch.Generator().manual_seed(0), SFNO_SWE_SMOKE, device="cpu")
    batches = _swe_batches(4)
    tt = Trainer(_tloss, net, TrainerConfig(total_steps=4,
                                            schedule=PrecisionSchedule.paper_default("bf16")),
                 device="cpu")
    hist = tt.run(lambda s: batches[s])
    assert [h["policy"] for h in hist] == ["mixed_fno_bf16", "amp_bf16", "amp_bf16", "full"]
    assert all(np.isfinite(h["loss"]) for h in hist) and tt.stats["skipped_steps"] == 0


# -- the order-shared kernels' channel plan ----------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("K,N", [(1, 1), (64, 64), (139, 139), (140, 140), (192, 192),
                                 (200, 200), (1000, 8), (8, 5000), (3000, 3000)])
def test_ls_channel_plan_fits_a_block_at_every_width(K, N, dtype):
    """``ls_fwd``/``ls_bwd_x`` (``ls_mix``) stream the input channels in
    chunks: every width fits a block's shared memory, with the weight's
    degree slice resident wherever it fits beside the ring (K <= 448 in
    half modes, 320 in f32 mode), streamed a chunk a stage beyond."""
    plan = sc.ls_plan(K, N, dtype)
    half = dtype != torch.float32
    assert plan.smem <= sc.SMEM_LIMIT and plan.splits == 1
    assert plan.resident == (K <= (448 if half else 320))
    # the path's block holds its ring of 2 stages, W and (halves) the output tile
    if (K, N) == (64, 64):
        assert plan.smem == (122_880 if half else 100_352)


@pytest.mark.parametrize("shape,splits", [
    ((8, 64, 64, 128, 128), 1),    # the SFNO path: 128 degrees, one block each
    ((8, 192, 192, 64, 64), 1),    # LS_WIDE_SHAPE: 3 channel tiles a degree
    ((3, 5, 7, 37, 29), 3),        # few degrees: the batch rows shared among blocks
    ((16, 20, 36, 9, 70), 14),
    ((2, 140, 140, 5, 70), 2),
    ((1, 1, 1, 1, 1), 1),
    ((9, 17, 5, 33, 300), 4),      # 3 order chunks a batch row: 27 outputs
])
def test_ls_plan_splits_the_outputs_to_fill_the_card(shape, splits):
    B, I, O, L, M = shape
    for K, N in ((I, O), (O, I)):
        plan = sc.ls_plan(K, N, torch.bfloat16, B=B, L=L, M=M)
        blocks = L * -(-N // 64)
        outputs = B * -(-M // 128)
        assert 1 <= plan.splits <= outputs
        assert blocks * plan.splits <= max(sc.H100_SMS, blocks)
        if K == I:
            assert plan.splits == splits
