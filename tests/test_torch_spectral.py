"""The PyTorch port's spectral path against the JAX reference on the CPU:
the dense contraction's plain version (what a CPU tensor runs in place of
the CUDA kernel) against the Pallas kernel in interpret mode, the host
wrapper against the reference's, and the staged Fourier layer against
the reference's Pallas staged path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as jget_policy
from repro.core import spectral_conv_apply as jspectral_conv_apply
from repro.kernels import ops as jops
from repro.kernels.spectral_contract import spectral_contract_pallas
from repro_torch.core.precision import FORMAT_EPS, dtype_name
from repro_torch.core.spectral import init_spectral_weights, spectral_conv_apply
from repro_torch.kernels import ops, ref
from repro_torch.kernels import spectral_contract as sc
from repro_torch.precision import get_policy

from helpers import (
    MODES_BY_NDIM,
    POLICY_NAMES,
    SPATIAL_BY_NDIM,
    assert_within_budget,
    fused_mag,
    rand_complex,
)

jax.config.update("jax_platform_name", "cpu")

#: (cast_to, out_dtype) of the kernel's modes on the serving path
MODES = [(None, "float32"), ("bfloat16", "bfloat16"), ("float16", "float16")]


def _split_operands(seed, B=3, I=5, O=4, M=37):
    """Split-real f32 operands at a ragged mode count (M is not a multiple
    of the reference's block_m=8)."""
    rng = np.random.RandomState(seed)
    x = rand_complex(rng, (B, I, M))
    w = rand_complex(rng, (I, O, M))
    parts = [np.real(x), np.imag(x), np.real(w), np.imag(w)]
    return x, w, [np.array(p, np.float32) for p in parts]


@pytest.mark.parametrize("cast_to,out_dtype", MODES)
def test_plain_matches_pallas_kernel(cast_to, out_dtype):
    x, w, parts = _split_operands(0)
    jr, ji = spectral_contract_pallas(
        *map(jnp.asarray, parts), block_m=8, interpret=True,
        out_dtype=getattr(jnp, out_dtype),
        cast_to=None if cast_to is None else getattr(jnp, cast_to))
    tr, ti = sc.spectral_contract_plain(
        *map(torch.from_numpy, parts),
        cast_to=None if cast_to is None else getattr(torch, cast_to),
        out_dtype=getattr(torch, out_dtype))
    assert tr.dtype == getattr(torch, out_dtype)
    want = np.asarray(jr, np.float32) + 1j * np.asarray(ji, np.float32)
    got = tr.float().numpy() + 1j * ti.float().numpy()
    mag = np.einsum("bim,iom->bom", np.abs(np.asarray(x)), np.abs(np.asarray(w)))
    assert_within_budget(got, want, FORMAT_EPS[out_dtype], mag, stages=1,
                         label=f"plain vs pallas {cast_to}->{out_dtype}")


def test_plain_matches_ref_oracle_at_full_precision():
    x, w, parts = _split_operands(1)
    tr, ti = sc.spectral_contract_plain(*map(torch.from_numpy, parts))
    want = ref.spectral_contract_ref(torch.from_numpy(np.array(x)),
                                     torch.from_numpy(np.array(w))).numpy()
    np.testing.assert_allclose(tr.numpy() + 1j * ti.numpy(), want, rtol=1e-5, atol=1e-5)


def test_magnitude_matches_numpy():
    x, w, parts = _split_operands(2)
    mag = sc.contract_magnitude(*map(torch.from_numpy, parts)).numpy()
    want = np.einsum("bim,iom->bom", np.abs(np.asarray(x)), np.abs(np.asarray(w)))
    np.testing.assert_allclose(mag, want, rtol=1e-5)


def test_wrapper_checks_inputs():
    _, _, parts = _split_operands(3)
    xr, xi, wr, wi = map(torch.from_numpy, parts)
    with pytest.raises(TypeError, match="float32"):
        sc.spectral_contract_dense(xr.double(), xi, wr, wi)
    with pytest.raises(ValueError, match="disagree"):
        sc.spectral_contract_dense(xr, xi, wr[:, :, :5], wi[:, :, :5])
    with pytest.raises(TypeError, match="cast_to"):
        sc.spectral_contract_dense(xr, xi, wr, wi, cast_to=torch.float64)
    # a device with no kernel raises rather than falling back to the CPU
    with pytest.raises(ValueError, match="no kernel"):
        sc.spectral_contract_dense(*(t.to("meta") for t in (xr, xi, wr, wi)))
    before = sc.launches
    sc.spectral_contract_dense(xr, xi, wr, wi)
    assert sc.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_host_wrapper_matches_reference(policy_name):
    site = "fno/layer0/spectral/contract"
    jsite, tsite = jget_policy(policy_name).at(site), get_policy(policy_name).at(site)
    rng = np.random.RandomState(4)
    modes = MODES_BY_NDIM[2]
    x = rand_complex(rng, (3, 5, *modes))
    w = rand_complex(rng, (5, 4, *modes))
    want = np.asarray(jops.spectral_contract(x, w, policy=jsite, block_m=8))
    w_np = np.asarray(w)
    got = ops.spectral_contract(
        torch.from_numpy(np.array(x)),
        torch.from_numpy(np.ascontiguousarray(w_np.real, np.float32)),
        torch.from_numpy(np.ascontiguousarray(w_np.imag, np.float32)),
        policy=tsite).numpy()
    mag = np.einsum("bixy,ioxy->boxy", np.abs(np.asarray(x)), np.abs(w_np))
    assert_within_budget(got, want, jsite.eps, mag, stages=1,
                         label=f"spectral_contract {policy_name}")


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_spectral_conv_matches_reference_staged_path(policy_name, ndim):
    modes, spatial = MODES_BY_NDIM[ndim], SPATIAL_BY_NDIM[ndim]
    rng = np.random.RandomState(10 + ndim)
    x = rng.randn(2, 3, *spatial).astype(np.float32)
    params = init_spectral_weights(3, 4, modes, generator=torch.Generator().manual_seed(ndim))
    site = "fno/layer0/spectral"
    want = np.asarray(jspectral_conv_apply(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()}, jnp.asarray(x),
        modes, jget_policy(policy_name), use_pallas=True, site=site,
        fuse_spectral=False))
    got = spectral_conv_apply(params, torch.from_numpy(x), modes,
                              get_policy(policy_name), site=site).numpy()
    assert got.dtype == want.dtype == np.float32
    wgr, wgi = jops.gather_corner_weights(
        jnp.asarray(params["w_re"].numpy()), jnp.asarray(params["w_im"].numpy()), modes)
    mag = fused_mag(x, wgr, wgi, spatial, modes)
    eps = jget_policy(policy_name).at(f"{site}/contract").eps
    assert_within_budget(got, want, eps, mag, stages=2,
                         label=f"spectral_conv {policy_name} {ndim}d")


def test_spectral_conv_refuses_what_is_not_ported():
    params = init_spectral_weights(2, 2, (3, 3), generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 2, 8, 8, generator=torch.Generator().manual_seed(1))
    # fuse_spectral=True is ported: on the CPU it runs the fused kernels'
    # plain versions (tests/test_torch_fused.py holds them to the reference)
    fused = spectral_conv_apply(params, x, (3, 3), fuse_spectral=True)
    assert torch.equal(fused, ops.spectral_conv_fused(x, params["w_re"], params["w_im"], (3, 3)))
    # spectral params of no known kind, and an unknown factorisation, are
    # refused as the reference refuses them
    with pytest.raises(ValueError, match="unrecognised spectral params"):
        spectral_conv_apply({"v_re": params["w_re"]}, x, (3, 3))
    with pytest.raises(ValueError, match="unknown factorization"):
        init_spectral_weights(2, 2, (3, 3), "bogus")


def test_init_spectral_weights_scale():
    p = init_spectral_weights(16, 8, (4, 5), generator=torch.Generator().manual_seed(0))
    assert set(p) == {"w_re", "w_im"}
    assert p["w_re"].shape == (2, 16, 8, 4, 5) and p["w_re"].dtype == torch.float32
    # scaled normals: std 1/(I*O)
    assert abs(float(p["w_im"].std()) * 16 * 8 - 1.0) < 0.1


def test_full_policy_dtype_names():
    assert dtype_name(torch.bfloat16) == "bfloat16"
    assert get_policy("full").at("fno/layer0/spectral/contract").spectral_dtype is None
