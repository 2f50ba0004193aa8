"""The PyTorch port's memory-greedy contraction engine, Tucker weights,
theory estimators and quickstart against the JAX reference on the CPU.

The reference's einsum path cannot run bf16 dots on XLA:CPU
(``core/contraction.py``'s ``_pairwise``: "DotThunk BF16 x BF16 = F32"),
so under ``mixed_fno_bf16`` the port's contraction is held to the exact
(f64) answer within the Thm 3.2 budget instead; under every other policy
it is also held to the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.contraction as jc
import repro.models.fno as jfno
from repro.configs.fno_paper import TFNO_NS_SMOKE as J_SMOKE
from repro.core import get_policy as jget_policy
from repro.core import precision as jprecision
from repro.core import spectral_conv_apply as jspectral_conv_apply
from repro.core import theory as jtheory
from repro_torch.configs.fno_paper import TFNO_NS_SMOKE
from repro_torch.core import contraction as tc
from repro_torch.core import precision as tprecision
from repro_torch.core import theory as ttheory
from repro_torch.core.spectral import init_spectral_weights, spectral_conv_apply
from repro_torch.models import fno_infer, params_from_jax
from repro_torch.precision import get_policy

from helpers import POLICY_NAMES, assert_within_budget, rand_complex, rel_err

jax.config.update("jax_platform_name", "cpu")

#: the paper's spectral einsums (dense, CP, Tucker) at 1-3 D, and two more
EXPRS = [
    ("bix,iox->box", [(2, 3, 7), (3, 4, 7)]),
    ("bixy,r,ir,or,xr,yr->boxy", [(4, 32, 12, 12), (16,), (32, 16), (32, 16), (12, 16),
                                  (12, 16)]),
    ("bixyz,r,ir,or,xr,yr,zr->boxyz", [(2, 8, 4, 5, 3), (6,), (8, 6), (8, 6), (4, 6), (5, 6),
                                       (3, 6)]),
    ("bixy,RSAB,iR,oS,xA,yB->boxy", [(4, 16, 8, 8), (8, 8, 4, 4), (16, 8), (16, 8), (8, 4),
                                     (8, 4)]),
    ("ab,bc,cd,de", [(3, 40), (40, 2), (2, 50), (50, 4)]),
    ("ij,jk->ki", [(5, 6), (6, 7)]),
]
#: policies whose reference einsum path runs on XLA:CPU
REFERENCE_RUNS = [p for p in POLICY_NAMES if p != "mixed_fno_bf16"]


@pytest.mark.parametrize("objective", ["memory", "flops"])
@pytest.mark.parametrize("expr,shapes", EXPRS)
def test_greedy_path_is_the_reference_path(expr, shapes, objective):
    want = jc.greedy_path(expr, shapes, objective)
    got = tc.greedy_path(expr, shapes, objective)
    assert got == want
    assert tc.path_intermediate_bytes(expr, shapes, got) == \
        jc.path_intermediate_bytes(expr, shapes, want)
    assert tc.path_flops(expr, shapes, got) == jc.path_flops(expr, shapes, want)


def test_memory_path_keeps_intermediates_small_and_caches():
    expr, shapes = EXPRS[1]
    mem, flops = tc.greedy_path(expr, shapes, "memory"), tc.greedy_path(expr, shapes, "flops")
    assert tc.path_intermediate_bytes(expr, shapes, mem) <= \
        tc.path_intermediate_bytes(expr, shapes, flops)
    cache = tc.PathCache()
    assert cache.get(expr, shapes, "memory") == mem == cache.get(expr, shapes, "memory")
    assert (cache.hits, cache.misses) == (1, 1)
    cache.clear()
    assert (cache.hits, cache.misses) == (0, 0)
    with pytest.raises(ValueError, match="operands"):
        tc.greedy_path("ab,bc->ac", [(2, 3)])
    with pytest.raises(ValueError, match="size"):
        tc.greedy_path("ab,bc->ac", [(2, 3), (4, 5)])


def _operands(expr, shapes, seed):
    """Complex operands of the expression; the CP weight vector is complex
    too, and the Tucker/chain cases mix in real ones."""
    rng = np.random.RandomState(seed)
    return [rand_complex(rng, s) if k % 3 != 2 else
            np.asarray(0.5 * rng.randn(*s), np.float32) for k, s in enumerate(shapes)]


def _to_torch(a):
    a = np.asarray(a)
    return torch.from_numpy(a.copy())


def _out(y):
    if isinstance(y, tc.ComplexPair):
        y = y.to_complex()
    return y.numpy()


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
@pytest.mark.parametrize("case", [1, 3])
def test_contract_holds_to_the_exact_answer_within_budget(policy_name, case):
    """The CP and Tucker spectral einsums under every policy: within
    ``stages·4εM + 32·ε_f32·M`` of the f64 answer, one stage per operand
    (each operand's storage rounding and each pairwise step's
    requantisation contribute at most ε·M each, 2n − 1 ≤ 4n of them)."""
    expr, shapes = EXPRS[case]
    ops = _operands(expr, shapes, case)
    site = get_policy(policy_name).at("fno/layer0/spectral/contract")
    got = _out(site.contract(expr, *map(_to_torch, ops)))
    exact = np.einsum(expr, *(np.asarray(o, np.complex128) for o in ops))
    mag = np.einsum(expr, *(np.abs(np.asarray(o)).astype(np.float64) for o in ops))
    assert_within_budget(got, exact, jget_policy(policy_name).at(site.site).eps, mag,
                         stages=len(ops), label=f"contract {policy_name} {expr}")


@pytest.mark.parametrize("policy_name", REFERENCE_RUNS)
@pytest.mark.parametrize("case", [0, 1, 2, 3, 4, 5])
def test_contract_matches_reference(policy_name, case):
    """Against the reference's ``contract`` on the same operands: both
    round the same operands and intermediates onto the same grids, so
    they agree within one stage per pairwise step plus f32 order."""
    expr, shapes = EXPRS[case]
    ops = _operands(expr, shapes, 20 + case)
    jsite = jget_policy(policy_name).at("fno/layer0/spectral/contract")
    want = jc.contract(expr, *map(jnp.asarray, ops), policy=jsite)
    want = np.asarray(want.to_complex() if isinstance(want, jprecision.ComplexPair) else want)
    got = _out(tc.contract(expr, *map(_to_torch, ops),
                           policy=get_policy(policy_name).at(jsite.site)))
    assert got.shape == want.shape
    mag = np.einsum(expr, *(np.abs(np.asarray(o)).astype(np.float64) for o in ops))
    assert_within_budget(got, want, jsite.eps, mag, stages=len(ops) - 1,
                         label=f"contract vs reference {policy_name} {expr}")


@pytest.mark.parametrize("policy_name", REFERENCE_RUNS)
def test_tucker_spectral_conv_matches_reference(policy_name):
    """A Tucker Fourier layer, staged, against the reference's: relative
    L2 within 1/4 of the reference layer's own gap to its ``full`` answer
    where the policy rounds the spectral sites, else (``full`` and the
    AMP policies, whose spectral sites stay f32) within 1e-5."""
    modes, site = (5, 4), "fno/layer0/spectral"
    x = np.random.RandomState(8).randn(2, 6, 12, 9).astype(np.float32)
    params = init_spectral_weights(6, 5, modes, "tucker",
                                   generator=torch.Generator().manual_seed(2))
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}

    def ref(name):
        return np.asarray(jspectral_conv_apply(jparams, jnp.asarray(x), modes, jget_policy(name),
                                               use_pallas=True, site=site, fuse_spectral=False))

    want = ref(policy_name)
    got = spectral_conv_apply(params, torch.from_numpy(x), modes, get_policy(policy_name),
                              site=site).numpy()
    assert got.shape == want.shape == (2, 5, 12, 9)
    half = get_policy(policy_name).at(f"{site}/contract").spectral_is_half
    limit = 0.25 * rel_err(want, ref("full")) if half else 1e-5
    assert rel_err(got, want) <= limit


@pytest.mark.parametrize("policy_name", ["full", "amp_bf16", "mixed_fno_fp16"])
def test_tucker_tfno_infer_matches_reference(policy_name):
    """``TFNO_NS_SMOKE`` with Tucker weights (the einsum path), bridged
    from the reference, on 2 fields at 24²: 1e-5 under ``full``, else 1/4
    of the reference's own mixed-vs-full relative L2."""
    jcfg = dataclasses.replace(J_SMOKE, factorization="tucker", use_pallas=True,
                               fuse_spectral=False)
    tcfg = dataclasses.replace(TFNO_NS_SMOKE, factorization="tucker")
    jparams = jfno.init_fno(jax.random.PRNGKey(3), jcfg)
    net = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    x = np.random.RandomState(0).randn(2, 1, 24, 24).astype(np.float32)

    def ref(name):
        return np.asarray(jfno.fno_infer(jparams, jnp.asarray(x), jcfg, jget_policy(name)))

    want = ref(policy_name)
    got = fno_infer(net, x, get_policy(policy_name), device="cpu").numpy()
    limit = 1e-5 if policy_name == "full" else 0.25 * rel_err(want, ref("full"))
    assert rel_err(got, want) <= limit


# -- theory ----------------------------------------------------------------------
def _v(xs):
    return np.sin(2 * np.pi * xs[..., 0]) + 0.5 * np.prod(xs, axis=-1)


def test_theory_estimators_match_reference():
    np.testing.assert_array_equal(ttheory.lattice(5, 3), jtheory.lattice(5, 3))
    for m, d in ((16, 1), (32, 2)):
        assert ttheory.disc_error(_v, m, d, 1.0) == pytest.approx(
            jtheory.disc_error(_v, m, d, 1.0), rel=1e-12)
        assert ttheory.prec_error(_v, m, d, 1.0, dtype="float16") == pytest.approx(
            jtheory.prec_error(_v, m, d, 1.0, dtype="float16"), rel=1e-12)
    for fmt in ("float16", "bfloat16", "fp8_e4m3"):
        tq, jq = tprecision.precision_system_for(fmt), jprecision.precision_system_for(fmt)
        assert (tq.a0, tq.eps, tq.T) == (jq.a0, jq.eps, jq.T)
        # the (a0, ε, T) grid is a0·(1+ε)^i in f32 (i ~ 1e5), whose last bit
        # differs between XLA's pow and PyTorch's: a quantised value may
        # move by one f32 ulp (6e-8 relative), the estimate by at most
        # that times the mean |v·φ| (< 1), so 1e-8 absolute
        assert ttheory.prec_error(_v, 16, 2, 1.0, q=tq) == pytest.approx(
            jtheory.prec_error(_v, 16, 2, 1.0, q=jq), rel=0, abs=1e-8)
    x = (np.random.RandomState(1).randn(1000) * 10.0 ** np.arange(-5, 5, 0.01)).astype(np.float32)
    # elementwise: the same grid point, up to the pow's last f32 bit, but
    # for values whose f32 log lands within an ulp of a rounding midpoint,
    # which may take the neighbouring point (one step, ε); 2 of these 1000
    q = tprecision.precision_system_for("float16")
    got = q.quantize(torch.from_numpy(x)).numpy()
    want = np.asarray(jprecision.precision_system_for("float16").quantize(jnp.asarray(x)))
    diff = np.abs(got - want)
    assert np.all(diff <= 1.01 * 2.0 ** -11 * np.abs(want))
    assert np.mean(diff > 1e-6 * np.abs(want)) <= 0.01


def test_theory_bounds_match_reference():
    for fn, args in (("disc_upper_bound", (4096, 2, 1.0, 3.0, 2.0)),
                     ("disc_lower_bound", (4096, 3, 2.0)),
                     ("prec_upper_bound", (2.0 ** -11, 3.0)),
                     ("prec_lower_bound", (2.0 ** -11, 3.0)),
                     ("general_disc_upper_bound", (1000, 3, 2.0)),
                     ("crossover_mesh_size", (1e-4, 3))):
        assert getattr(ttheory, fn)(*args) == pytest.approx(getattr(jtheory, fn)(*args),
                                                            rel=1e-12), fn
    field = np.random.RandomState(2).randn(9, 7)
    assert ttheory.estimate_lipschitz_and_bound(field) == \
        jtheory.estimate_lipschitz_and_bound(field)
    # Thm 3.2 holds on the estimator: the fp16 error is below 4·ε·M
    M = float(np.abs(_v(ttheory.lattice(32, 2))).max())
    assert ttheory.prec_error(_v, 32, 2, 1.0) <= ttheory.prec_upper_bound(2.0 ** -11, M)


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    expr, shapes = EXPRS[1]
    assert out["path_memory"] == jc.greedy_path(expr, shapes, "memory")
    assert out["peak_memory_path"] < out["peak_flops_path"]
    assert out["prec"] < out["disc"] and 0 < out["mixed_vs_full"] < 0.05
    assert "crossover mesh size" in capsys.readouterr().out
