"""The PyTorch port's Darcy data and loaders against the JAX reference on
the CPU, on the same numpy coefficient fields; and a check that the port
imports nothing of JAX or of the reference package."""
import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.darcy import darcy_matvec as jdarcy_matvec
from repro.data.darcy import solve_darcy as jsolve_darcy
from repro.data.loader import CachedDataset as JCachedDataset
from repro.data.loader import StatelessLoader as JStatelessLoader
from repro_torch.data import (
    CachedDataset,
    StatelessLoader,
    darcy_matvec,
    sample_darcy_batch,
    solve_darcy,
)

from helpers import rel_err

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]


def _coefficients(n, count, seed):
    """Piecewise {3, 12} fields, as the Darcy sampler makes them."""
    rng = np.random.RandomState(seed)
    return np.where(rng.randn(count, n, n) > 0, 12.0, 3.0).astype(np.float32)


def test_matvec_matches_reference():
    a = _coefficients(13, 1, 0)[0]
    u = np.random.RandomState(1).randn(13, 13).astype(np.float32)
    want = np.asarray(jdarcy_matvec(jnp.asarray(a), jnp.asarray(u)))
    got = darcy_matvec(torch.from_numpy(a), torch.from_numpy(u)).numpy()
    assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("n,maxiter", [(16, 400), (24, 60)])   # converged / cut by maxiter
def test_solve_matches_reference(n, maxiter):
    a = _coefficients(n, 1, 2)[0]
    want = np.asarray(jsolve_darcy(jnp.asarray(a), n, maxiter))
    got = solve_darcy(torch.from_numpy(a), n, maxiter).numpy()
    assert rel_err(got, want) <= 1e-4


def test_solve_at_training_grid_matches_reference_and_stops_on_tol():
    """Two GRF fields at 128², the training grid, with ``maxiter`` 1000:
    the two solvers agree, neither answer changes at 4000 (CG stops on its
    tolerance first), and both leave the same true residual
    ``‖1 − A u‖/‖1‖``, recomputed in f64 from the f32 solution: the f32
    floor of this operator, ~2e-3, not a cut by ``maxiter``."""
    from repro_torch.data.grf import grf_2d

    n = 128
    g = grf_2d(torch.Generator().manual_seed(0), n, alpha=2.0, tau=3.0, batch=2)
    a = torch.where(g > 0, 12.0, 3.0).to(torch.float32)

    def residual(u):
        r = 1.0 - darcy_matvec(a.double(), torch.as_tensor(np.asarray(u)).double())
        return (torch.linalg.vector_norm(r, dim=(-2, -1)) / n).numpy()

    got = solve_darcy(a, n, 1000)
    assert torch.equal(solve_darcy(a, n, 4000), got)
    want = np.stack([np.asarray(jsolve_darcy(jnp.asarray(f.numpy()), n, 1000)) for f in a])
    again = np.stack([np.asarray(jsolve_darcy(jnp.asarray(f.numpy()), n, 4000)) for f in a])
    np.testing.assert_array_equal(again, want)
    assert rel_err(got.numpy(), want) <= 1e-4
    r_port, r_ref = residual(got), residual(want)
    print(f"true relative residual at {n}²: port {r_port}, reference {r_ref}")
    assert np.all((r_ref > 1e-3) & (r_ref < 1e-2))
    assert np.all(np.abs(r_port - r_ref) <= 0.1 * r_ref)


def test_batched_solve_equals_solo():
    """Each field stops on its own rule and is frozen while the others go
    on, so a batch gives every field its solo answer."""
    a = torch.from_numpy(_coefficients(16, 3, 3))
    a[1] = 7.5            # a constant field converges in far fewer iterations
    batched = solve_darcy(a, 16, 400)
    for k in range(3):
        solo = solve_darcy(a[k], 16, 400)
        assert rel_err(batched[k].numpy(), solo.numpy()) <= 1e-6


def test_sample_darcy_batch_is_whitened_and_solved():
    a, u = sample_darcy_batch(torch.Generator().manual_seed(0), 16, 2, maxiter=400,
                              device="cpu")
    assert a.shape == u.shape == (2, 1, 16, 16) and a.dtype == torch.float32
    assert set(np.unique(a.numpy())) <= {-1.0, 1.0}
    raw = a[:, 0].numpy() * 4.5 + 7.5
    for k in range(2):
        want = (np.asarray(jsolve_darcy(jnp.asarray(raw[k]), 16, 400)) - 5e-3) / 5e-3
        assert rel_err(u[k, 0].numpy(), want) <= 1e-4
    again, _ = sample_darcy_batch(torch.Generator().manual_seed(0), 16, 2, maxiter=400,
                                  device="cpu")
    assert torch.equal(a, again)


def test_loaders_give_the_reference_batches():
    rng = np.random.RandomState(4)
    arrays = {"a": rng.randn(11, 2).astype(np.float32), "u": np.arange(11)}
    ours, ref = CachedDataset(arrays, 5, seed=3), JCachedDataset(arrays, 5, seed=3)
    for step in (0, 1, 7, 123456):
        got, want = ours.batch_at(step), ref.batch_at(step)
        for k in arrays:
            np.testing.assert_array_equal(got[k], want[k])

    def sample(seed, index):
        return {"i": np.asarray([seed, index])}

    ours = StatelessLoader(sample, seed=2, host_id=1, num_hosts=3)
    ref = JStatelessLoader(sample, seed=2, host_id=1, num_hosts=3)
    for step in range(4):
        np.testing.assert_array_equal(ours.batch_at(step)["i"], ref.batch_at(step)["i"])
    with pytest.raises(ValueError):
        CachedDataset({"a": np.zeros(3), "b": np.zeros(4)}, 2)


def test_port_imports_no_jax():
    """Every ``repro_torch`` module, imported in a fresh interpreter, loads
    no ``jax*`` module and nothing of the reference package; and
    ``chip_smoke.py`` imports neither."""
    code = (
        "import json, pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: __import__(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')"
        " or m.startswith('jax'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, check=True, timeout=300)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    names = set(result["modules"])
    expected = {m.name for m in pkgutil.walk_packages([str(ROOT / "src" / "repro_torch")],
                                                     "repro_torch.")}
    assert names == expected and "repro_torch.train.trainer" in names

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    roots = {m.split(".")[0] for m in imported}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots
