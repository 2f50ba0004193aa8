"""The PyTorch port's spherical shallow-water path against the JAX
reference on the CPU: the random spherical fields, the linearised SWE
solver, the sampler and the example.  The same numpy inputs go through
both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import grf_sphere as jgrf_sphere
from repro.data import sample_swe_batch as jsample_swe_batch
from repro.data import solve_swe_linear as jsolve_swe_linear
from repro_torch.data import grf_sphere, sample_swe_batch, solve_swe_linear, sphere_field
from repro_torch.models import sht_forward

from helpers import rel_err

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("lmax,decay", [(16, 2.0), (8, 1.5)])
def test_sphere_field_matches_reference_on_its_noise(lmax, decay):
    """The reference's ``grf_sphere`` and the port's synthesis fed the
    reference's own unit noise: the same field to f32 accuracy (1e-6 of
    its largest magnitude; the two differ in the order of the Legendre
    sums and the last bit of ``(1 + l)^-decay``)."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(jgrf_sphere(key, 32, 64, lmax=lmax, decay=decay, batch=2))
    kr, ki = jax.random.split(key)
    re = np.array(jax.random.normal(kr, (2, lmax, lmax)))
    im = np.array(jax.random.normal(ki, (2, lmax, lmax)))
    got = sphere_field(torch.from_numpy(re), torch.from_numpy(im), 32, 64, decay).numpy()
    assert got.shape == want.shape == (2, 32, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_grf_sphere_is_real_band_limited_and_seeded():
    """Fields from the generator: seeded, real, and band-limited to
    degree < lmax with real zonal (m = 0) coefficients: the analysis of
    the field returns nothing above its band."""
    a = grf_sphere(torch.Generator().manual_seed(0), 32, 64, lmax=8, batch=3)
    b = grf_sphere(torch.Generator().manual_seed(0), 32, 64, lmax=8, batch=3)
    assert a.shape == (3, 32, 64) and a.dtype == torch.float32 and torch.equal(a, b)
    c = sht_forward(a, 16, 16)
    assert float(c[..., 8:, :].abs().max()) < 1e-5 * float(c.abs().max())
    assert float(c[..., 0].imag.abs().max()) < 1e-5 * float(c.abs().max())


def test_solver_matches_reference():
    """The same initial geopotential through both solvers at 32x64 for 40
    steps (the reference example's data): relative L2 within 1e-5 per
    field of (φ, u, v).  Both run the same f32 scheme; what is left is the
    order of the Legendre sums and the FFT libraries' last bits, carried
    through 40 filtered steps (1e-6–3e-6 here)."""
    key = jax.random.PRNGKey(5)
    phi0 = np.asarray(jgrf_sphere(key, 32, 64, lmax=16, batch=2)) * 1e2
    want = jax.vmap(lambda p: jsolve_swe_linear(p, 32, 64, steps=40))(jnp.asarray(phi0))
    got = solve_swe_linear(torch.from_numpy(phi0), 32, 64, steps=40)
    for name, g, w in zip("phi u v".split(), got, want, strict=True):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (2, 32, 64) and g.dtype == torch.float32
        err = rel_err(g.numpy(), w)
        print(f"SWE solver {name}: port vs reference relative L2 {err:.3e}")
        assert err <= 1e-5, (name, err)


def test_solver_is_batched_per_field_and_checks_its_grid():
    phi0 = grf_sphere(torch.Generator().manual_seed(1), 16, 32, lmax=8, batch=3) * 1e2
    batched = solve_swe_linear(phi0, 16, 32, steps=5)
    for k in range(3):
        alone = solve_swe_linear(phi0[k], 16, 32, steps=5)
        for a, b in zip(batched, alone, strict=True):
            np.testing.assert_allclose(a[k].numpy(), b.numpy(), rtol=0,
                                       atol=1e-6 * float(b.abs().max()))
    rest = solve_swe_linear(torch.zeros(16, 32), 16, 32, steps=3)
    assert all(float(t.abs().max()) == 0 for t in rest)
    with pytest.raises(ValueError, match="not"):
        solve_swe_linear(torch.zeros(16, 30), 16, 32)


def test_sample_swe_batch_shapes_devices_and_normalisation():
    """Inputs (φ0 at unit scale, 0, 0) and targets (φ/1e2, u, v) at T, on
    the requested device, in the reference sampler's layout and scale: the
    same per-channel spread within sampling error (the random fields
    differ: torch and JAX generators)."""
    x, y = sample_swe_batch(torch.Generator().manual_seed(0), 16, 32, 8, steps=20,
                            device="cpu")
    assert x.shape == y.shape == (8, 3, 16, 32)
    assert x.dtype == y.dtype == torch.float32 and x.device.type == y.device.type == "cpu"
    assert float(x[:, 1:].abs().max()) == 0.0
    assert torch.isfinite(y).all()
    # the solver's first channel at T from the unnormalised input
    phi, _, _ = solve_swe_linear(x[:, 0] * 1e2, 16, 32, steps=20)
    np.testing.assert_allclose(y[:, 0].numpy(), (phi / 1e2).numpy(), rtol=1e-5, atol=1e-7)
    jx, jy = jsample_swe_batch(jax.random.PRNGKey(0), 16, 32, 64, steps=20)
    tx, ty = sample_swe_batch(torch.Generator().manual_seed(1), 16, 32, 64, steps=20,
                              device="cpu")
    for ch in range(3):
        j, t = np.asarray(jy)[:, ch].std(), ty[:, ch].std().item()
        assert abs(t / j - 1.0) < 0.3, (ch, t, j)
    assert abs(tx[:, 0].std().item() / np.asarray(jx)[:, 0].std() - 1.0) < 0.3


def test_sample_swe_batch_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_swe_batch(torch.Generator().manual_seed(0), 16, 32, 1)


def test_spherical_swe_example_runs_on_cpu(capsys):
    from repro_torch.examples import spherical_swe

    out = spherical_swe.main(["--steps", "3", "--device", "cpu"])
    assert [h["policy"] for h in out["history"]] == ["mixed_fno_bf16"] * 3
    assert all(np.isfinite(h["loss"]) for h in out["history"]) and np.isfinite(out["eval"])
    assert "eval rel-L2 (fresh ICs)" in capsys.readouterr().out
