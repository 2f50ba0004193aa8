"""The PyTorch port's precision layer against the JAX reference: rule
resolution, numeric-format grids and stabilisers (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro.core import stabilizer as jstab
from repro.precision import POLICIES as J_POLICIES
from repro.precision import FULL_PRECISION as J_FULL_PRECISION
from repro.precision import get_policy as jget_policy
from repro.precision import precision_rules as jprecision_rules
from repro.precision.policy import CANONICAL_SITES
from repro_torch.core import precision as tprec
from repro_torch.core import stabilizer as tstab
from repro_torch.precision import POLICIES, FULL_PRECISION, get_policy, precision_rules

jax.config.update("jax_platform_name", "cpu")

POLICY_NAMES = sorted(J_POLICIES)
SITES = CANONICAL_SITES + ("fno/dense", "fno/proj_out") + tuple(
    f"fno/layer{i}/{s}" for i in range(4)
    for s in ("dense", "spectral/fft_in", "spectral/contract", "spectral/fft_out"))


def _name(v):
    """A resolved field with dtypes spelled by name, framework-free."""
    if isinstance(v, torch.dtype):
        return tprec.dtype_name(v)
    if v is not None and not isinstance(v, (str, bool)):
        return jnp.dtype(v).name
    return v


def _fields(site):
    return (_name(site.compute), _name(site.accum), site.stabilizer,
            site.quantize_fmt, site.loss_scaling)


def test_registry_names_match():
    assert sorted(POLICIES) == POLICY_NAMES
    with pytest.raises(KeyError, match="unknown precision policy"):
        get_policy("nope")


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_sites_resolve_like_the_reference(policy_name):
    port, ref = get_policy(policy_name), jget_policy(policy_name)
    for site in SITES:
        assert _fields(port.at(site)) == _fields(ref.at(site)), site


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_scoped_layer_override_resolves_like_the_reference(policy_name):
    port, ref = get_policy(policy_name), jget_policy(policy_name)
    with precision_rules(("fno/layer1/*", FULL_PRECISION)), \
            jprecision_rules(("fno/layer1/*", J_FULL_PRECISION)):
        for site in SITES:
            assert _fields(port.at(site)) == _fields(ref.at(site)), site
        assert port.at("fno/layer1/spectral/contract").quantize_fmt is None
    # the scope is gone on exit
    assert _fields(port.at("fno/layer1/spectral/fft_in")) == \
        _fields(ref.at("fno/layer1/spectral/fft_in"))


def _wide_f32(seed, n=4096):
    """f32 values from f32 subnormals to near f32 max, both signs, zeros."""
    rng = np.random.RandomState(seed)
    mag = 10.0 ** rng.uniform(-44, 38, n)
    x = (np.sign(rng.randn(n)) * mag).astype(np.float32)
    return np.concatenate([x, np.float32([0.0, -0.0, 448.0, 57344.0, 1e-40, -3e-39])])


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
def test_simulate_fp8_is_bit_equal(fmt):
    x = _wide_f32(1)
    want = np.asarray(jprec.simulate_fp8(jnp.asarray(x), fmt))
    got = tprec.simulate_fp8(torch.from_numpy(x), fmt).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_quantize_complex_is_bit_equal(dtype):
    re, im = _wide_f32(2), _wide_f32(3)
    c = (re + 1j * im).astype(np.complex64)
    want = np.asarray(jprec.quantize_complex(jnp.asarray(c), getattr(jnp, dtype)))
    got = tprec.quantize_complex(torch.from_numpy(c), getattr(torch, dtype)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_site_quantize_is_bit_equal(policy_name):
    rng = np.random.RandomState(4)
    c = (100 * (rng.randn(3, 4, 5) + 1j * rng.randn(3, 4, 5))).astype(np.complex64)
    site = "fno/layer0/spectral/fft_in"
    want = np.asarray(jget_policy(policy_name).at(site).quantize(jnp.asarray(c)))
    got = get_policy(policy_name).at(site).quantize(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", ["tanh", "hard_clip", "sigma_clip", "fixed_scale", None])
def test_stabilizers_match(name):
    rng = np.random.RandomState(5)
    x = (3 * rng.randn(2, 3, 8, 8)).astype(np.float32)
    want = np.asarray(jstab.get_stabilizer(name)(jnp.asarray(x)))
    got = tstab.get_stabilizer(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_format_tables_match():
    assert tprec.FORMAT_EPS == jprec.FORMAT_EPS
    assert tprec.FORMAT_MAX == jprec.FORMAT_MAX
    assert tprec.FORMAT_TINY == jprec.FORMAT_TINY
