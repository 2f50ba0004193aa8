"""The PyTorch port's FNO against the JAX reference on the CPU: the same
weights (bridged with ``params_from_jax``) and the same numpy inputs
through both ``fno_infer``s, for every registry policy.

Tolerance: relative L2 <= 1e-5 under ``full``; otherwise <= 1/4 of the
policy's own mixed-vs-full relative L2 in the reference, i.e. the port
differs from JAX far less than the precision error the paper bounds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fno_paper import FNO_DARCY_SMOKE as J_SMOKE
from repro.core import get_policy as jget_policy
from repro.models import fno_infer as jfno_infer
from repro.models import init_fno as jinit_fno
from repro.models import param_count as jparam_count
from repro.models.fno import _positional_grid as j_positional_grid
from repro.precision import FULL_PRECISION as J_FULL_PRECISION
from repro.precision import precision_rules as jprecision_rules
from repro_torch.configs.fno_paper import FNO_DARCY, FNO_DARCY_SMOKE
from repro_torch.models import FNO, fno_infer, init_fno, param_count, params_from_jax
from repro_torch.models.fno import _positional_grid
from repro_torch.precision import FULL_PRECISION, get_policy, precision_rules

from helpers import POLICY_NAMES, rel_err

jax.config.update("jax_platform_name", "cpu")

#: the reference on its default CPU path (einsum contraction, staged);
#: test_torch_spectral.py holds the port's layer against the Pallas path
J_CFG = dataclasses.replace(J_SMOKE, use_pallas=False, fuse_spectral=False)


@pytest.fixture(scope="module")
def bridged():
    jparams = jinit_fno(jax.random.PRNGKey(3), J_CFG)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    net = params_from_jax(tree, FNO_DARCY_SMOKE, device="cpu")
    x = np.random.RandomState(0).randn(2, 1, 24, 24).astype(np.float32)
    return jparams, net, x, _reference(jparams, x, "full")


def _reference(jparams, x, policy_name):
    # eager, as the function is written: under jit XLA fuses the half
    # elementwise chains and skips some of their roundings, which moves the
    # reference from its own eager run by ~0.2x its precision error
    return np.asarray(jfno_infer(jparams, jnp.asarray(x), J_CFG, jget_policy(policy_name)))


@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_fno_infer_matches_reference(bridged, policy_name):
    jparams, net, x, ref_full = bridged
    want = _reference(jparams, x, policy_name)
    got = fno_infer(net, x, get_policy(policy_name), device="cpu").numpy()
    assert got.shape == want.shape == (2, 1, 24, 24) and got.dtype == np.float32
    err = rel_err(got, want)
    limit = 1e-5 if policy_name == "full" else 0.25 * rel_err(want, ref_full)
    # shown with `pytest -s`: the parity error per policy beside its limit
    print(f"{policy_name}: port vs reference relative L2 {err:.3e} (limit {limit:.3e})")
    assert err <= limit, (err, limit)


def test_layer_override_matches_reference(bridged):
    """A scoped override pinning one layer to full precision reaches that
    layer in both packages."""
    jparams, net, x, ref_full = bridged
    with jprecision_rules(("fno/layer1/*", J_FULL_PRECISION)):
        want = _reference(jparams, x, "mixed_fno_bf16")
    with precision_rules(("fno/layer1/*", FULL_PRECISION)):
        got = fno_infer(net, x, get_policy("mixed_fno_bf16"), device="cpu").numpy()
    plain = fno_infer(net, x, get_policy("mixed_fno_bf16"), device="cpu").numpy()
    assert not np.array_equal(got, plain)
    limit = 0.25 * rel_err(want, ref_full)
    assert rel_err(got, want) <= limit


def test_params_from_jax_round_trip(bridged):
    jparams, net, _, _ = bridged
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    state = net.state_dict()
    assert len(state) == sum(len(v) for v in tree.values())
    for group, sub in tree.items():
        for name, v in sub.items():
            np.testing.assert_array_equal(state[f"{group}.{name}"].numpy(), v)
    assert param_count(net) == jparam_count(jparams)
    with pytest.raises(RuntimeError):   # a missing entry is refused
        params_from_jax({k: v for k, v in tree.items() if k != "skips"},
                        FNO_DARCY_SMOKE, device="cpu")


def test_init_fno_is_seeded_and_shaped_like_the_reference():
    cfg = FNO_DARCY_SMOKE
    a = init_fno(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = init_fno(torch.Generator().manual_seed(0), cfg, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items(), strict=True):
        assert ka == kb and torch.equal(va, vb)
    jshapes = jax.tree_util.tree_map(
        lambda v: tuple(v.shape), jinit_fno(jax.random.PRNGKey(0), J_CFG))
    for group, sub in jshapes.items():
        for name, shape in sub.items():
            assert tuple(a.state_dict()[f"{group}.{name}"].shape) == shape
    # the reference's scaled normals: lift2 std = 1/sqrt(lifting_channels)
    w = a.lift2["w"].detach()
    assert abs(float(w.std()) * cfg.lifting_channels ** 0.5 - 1.0) < 0.2


def test_full_width_config_matches_the_reference():
    from repro.configs.fno_paper import FNO_DARCY as J_DARCY

    for f in dataclasses.fields(FNO_DARCY):
        assert getattr(FNO_DARCY, f.name) == getattr(J_DARCY, f.name), f.name


@pytest.mark.parametrize("spatial", [(7, 5), (128, 128), (421, 421), (32, 32, 32)])
def test_positional_grid_matches_reference(spatial):
    """Bit for bit: the reference's ``jnp.linspace`` grid.  ``torch.linspace``
    differs from it by an ulp at 4 of 128 points and 137 of 421."""
    want = np.asarray(j_positional_grid(spatial, jnp.float32))
    got = _positional_grid(spatial, torch.float32, "cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    net = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE, device="cpu")
    x = np.zeros((1, 1, 8, 8), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fno_infer(net, x)
    with pytest.raises(ValueError, match="live on"):
        fno_infer(net, x, device="meta")


def test_unported_options_raise():
    # an unknown factorisation is refused, as the reference refuses it
    with pytest.raises(ValueError, match="unknown factorization"):
        FNO(dataclasses.replace(FNO_DARCY_SMOKE, factorization="bogus"))
    # fuse_spectral=True is ported: the CPU runs the fused layer's plain
    # versions, which agree with the staged layer under full precision
    x = np.random.RandomState(0).randn(1, 1, 16, 16).astype(np.float32)
    fused = init_fno(torch.Generator().manual_seed(0),
                     dataclasses.replace(FNO_DARCY_SMOKE, fuse_spectral=True), device="cpu")
    staged = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE, device="cpu")
    y = fno_infer(fused, x, device="cpu").numpy()
    assert y.shape == (1, 1, 16, 16) and np.isfinite(y).all()
    assert rel_err(y, fno_infer(staged, x, device="cpu").numpy()) <= 1e-5
