"""The PyTorch port's GINO and its car-shape data against the JAX reference
on the CPU.

The same numpy inputs (the reference's ``sample_car_batch``), and weights
bridged with ``gino_params_from_jax``, go through both packages:

* ``sample_car_batch``: the same seed gives every array of the reference,
  at latent grids 4, 8 and 32; the KNN's chunks change nothing; the latent
  coordinates equal ``jnp.linspace``'s grid bit for bit;
* the forward at ``GINO_CAR_SMOKE`` and at the example's config under
  every policy, staged (the reference's einsum path) and fused (both
  sides; the reference's fused Pallas kernels in interpret mode);
* per-leaf gradients of ``relative_l2`` under ``full``, ``mixed_fno_bf16``
  and ``amp_bf16``; batched against per-sample; ``GINO_CAR``'s parameter
  count against ``jax.eval_shape``; the entry points and the example.

**The reference's block loop.**  The reference's FNO runs its layers
under ``lax.scan`` when they share their formats; the scan compiles the
block, and XLA then skips some half roundings.  Its eager, unrolled loop
is the reference's own op-by-op path, which the port follows: at
``GINO_CAR_SMOKE`` under ``mixed_fno_bf16`` the port differs from the
scanned reference by 0.30 of the policy's gap to ``full`` and from the
unrolled one by 0.16 of it (one bf16 product of the decoder rounds the
other way: its f32 sum runs in another order).  So the reference runs
eager and unrolled here, as ``tests/test_torch_train.py`` runs it.

Tolerances: relative L2 <= 1e-5 under ``full``, else <= 1/4 of the
reference's own gap to ``full`` (forward); gradients as
``test_gino_gradients_match_reference`` states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.stabilizer as jstabilizer
import repro.models.fno as jfno
import repro.models.gino as jgino
from repro.configs.fno_paper import GINO_CAR as J_CAR
from repro.configs.fno_paper import GINO_CAR_SMOKE as J_SMOKE
from repro.core import get_policy as jget_policy
from repro.data import latent_grid_coords as jlatent_grid_coords
from repro.data import sample_car_batch as jsample_car_batch
from repro.train import relative_l2 as jrelative_l2
from repro_torch.configs.fno_paper import GINO_CAR, GINO_CAR_SMOKE
from repro_torch.core.precision import FORMAT_EPS, dtype_name
from repro_torch.data import carshapes, latent_grid_coords, sample_car_batch
from repro_torch.examples import gino_car_cfd
from repro_torch.models import (
    GINO,
    gino_apply,
    gino_params_from_jax,
    init_gino,
    latent_coords,
    param_count,
)
from repro_torch.precision import get_policy
from repro_torch.train import relative_l2

from helpers import POLICY_NAMES, rel_err
from test_torch_train import _tanh_one_cotangent

jax.config.update("jax_platform_name", "cpu")

#: the example's config in the reference's terms
J_EXAMPLE = dataclasses.replace(
    J_SMOKE, hidden=16, latent_grid=6, k_neighbors=6,
    fno=jfno.FNOConfig(in_channels=16, out_channels=16, hidden_channels=16,
                       lifting_channels=16, projection_channels=16, n_layers=2,
                       modes=(3, 3, 3), positional_embedding=False))

#: (port config, reference config, points per shape) of the forward checks
CONFIGS = {"smoke": (GINO_CAR_SMOKE, J_SMOKE, 64),
           "example": (gino_car_cfd.EXAMPLE_CFG, J_EXAMPLE, 128)}

#: the policies of the per-leaf gradient checks
GRAD_POLICIES = ["full", "mixed_fno_bf16", "amp_bf16"]


def _jpath(jcfg, use_pallas, fuse):
    return dataclasses.replace(jcfg, fno=dataclasses.replace(
        jcfg.fno, use_pallas=use_pallas, fuse_spectral=fuse))


def _tpath(cfg, fuse):
    return dataclasses.replace(cfg, fno=dataclasses.replace(cfg.fno, fuse_spectral=fuse))


def _torch_batch(jb):
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if "idx" in k else np.float32))
            for k, v in jb.items()}


def _flat(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}.", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


class _unrolled:
    """Within: the reference's FNO block loop unrolled (its eager op-by-op
    path); with ``tanh_port_order`` its tanh stabiliser's VJP also sums its
    two terms in the port's order (``test_torch_train._tanh_one_cotangent``)."""

    def __init__(self, tanh_port_order=False):
        self.tanh = tanh_port_order

    def __enter__(self):
        self.uniform, self.stab = jfno.layers_uniform, jstabilizer.STABILIZERS["tanh"]
        jfno.layers_uniform = lambda *a: False
        if self.tanh:
            jstabilizer.STABILIZERS["tanh"] = _tanh_one_cotangent

    def __exit__(self, *exc):
        jfno.layers_uniform = self.uniform
        jstabilizer.STABILIZERS["tanh"] = self.stab


def _jforward(jparams, jb, jcfg, policy_name):
    with _unrolled():
        out = jgino.gino_apply(jparams, {k: jnp.asarray(v) for k, v in jb.items()}, jcfg,
                               jget_policy(policy_name))
    return np.asarray(out, np.float32)


# -- the data --------------------------------------------------------------------------
@pytest.mark.parametrize("G", [4, 8, 32])
def test_sample_car_batch_equals_the_reference(G):
    """Same seed, every array equal to the reference's (indices as int64)."""
    want, want_labels = jsample_car_batch(7, 2, n_points=48, latent_grid=G, k=5, radius=0.3)
    got, labels = sample_car_batch(7, 2, n_points=48, latent_grid=G, k=5, radius=0.3,
                                   device="cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, name
        assert g.dtype == (np.int64 if "idx" in name else np.float32), name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    # the radius mask keeps some candidates and drops others
    assert 0 < float(got["enc_mask"].mean()) < 1


def test_knn_chunks_change_nothing(monkeypatch):
    want = sample_car_batch(3, 1, n_points=40, latent_grid=8, k=4, device="cpu")
    monkeypatch.setattr(carshapes, "KNN_CHUNK_PAIRS", 97)
    got = sample_car_batch(3, 1, n_points=40, latent_grid=8, k=4, device="cpu")
    for name, w in want[0].items():
        assert torch.equal(got[0][name], w), name
    with pytest.raises(ValueError, match="fewer than k"):
        carshapes.knn(torch.zeros(3, 3), torch.zeros(2, 3), 4, 0.3)


@pytest.mark.parametrize("G", [1, 4, 6, 32, 64])
def test_latent_coords_equal_jnp_linspace(G):
    """The model's latent grid is ``jnp.linspace``'s bit for bit; the
    data's is numpy's f64 ``linspace`` cast to f32, as in the reference."""
    np.testing.assert_array_equal(latent_coords(G).numpy(), np.asarray(jgino._latent_coords(G)))
    np.testing.assert_array_equal(latent_grid_coords(G), jlatent_grid_coords(G))


# -- the forward -----------------------------------------------------------------------
@pytest.fixture(scope="module", params=list(CONFIGS))
def bridged(request):
    cfg, jcfg, n_points = CONFIGS[request.param]
    jparams = jgino.init_gino(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jb, labels = jsample_car_batch(11, 2, n_points=n_points, latent_grid=jcfg.latent_grid,
                                   k=jcfg.k_neighbors)
    full = {fuse: _jforward(jparams, jb, _jpath(jcfg, fuse, fuse), "full")
            for fuse in (False, True)}
    return request.param, jparams, tree, jb, full


@pytest.mark.parametrize("fuse", [False, True], ids=["staged", "fused"])
@pytest.mark.parametrize("policy_name", POLICY_NAMES)
def test_gino_forward_matches_reference(bridged, policy_name, fuse):
    """Staged: against the reference's einsum path (``use_pallas=False,
    fuse_spectral=False``); fused: both sides ``fuse_spectral=True`` (the
    reference's ``_fused_fwd_kernel`` in interpret mode).  Within 1e-5
    relative L2 under ``full``, else 1/4 of the reference's gap to ``full``
    on the same path."""
    name, jparams, tree, jb, ref_full = bridged
    cfg, jcfg, _ = CONFIGS[name]
    jcfg = _jpath(jcfg, fuse, fuse)
    want = _jforward(jparams, jb, jcfg, policy_name)
    net = gino_params_from_jax(tree, _tpath(cfg, fuse), device="cpu")
    with torch.no_grad():
        got = gino_apply(net, _torch_batch(jb), get_policy(policy_name))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, jb["query"].shape[1], 1)
    err = rel_err(got.numpy(), want)
    limit = 1e-5 if policy_name == "full" else 0.25 * rel_err(want, ref_full[fuse])
    print(f"{name} {'fused' if fuse else 'staged'} {policy_name}: port vs reference "
          f"{err:.3e} (limit {limit:.3e})")
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16", "amp_bf16"])
def test_batched_matches_per_sample(bridged, policy_name):
    """The port runs the latent FNO on the whole batch where the reference
    vmaps the model over samples: each sample gets the answer it gets
    alone.  Not bit for bit on the CPU: the staged contraction's plain
    version is one einsum, for which the CPU's BLAS picks its product by
    the batch size, and so the order of the f32 sums (7e-8 relative L2 at
    the example's config under ``full``).  Within 1e-6 under ``full``,
    else within 1/4 of the port's own gap to ``full`` (a sample mixed
    with another would move by O(1)); on the card the check is bit for
    bit (``tests/test_torch_cuda.py``)."""
    name, _, tree, jb, _ = bridged
    net = gino_params_from_jax(tree, CONFIGS[name][0], device="cpu")
    batch = _torch_batch(jb)
    with torch.no_grad():
        together = gino_apply(net, batch, get_policy(policy_name)).numpy()
        alone = np.concatenate([
            gino_apply(net, {k: v[b:b + 1] for k, v in batch.items()},
                       get_policy(policy_name)).numpy() for b in range(2)])
        full = gino_apply(net, batch, get_policy("full")).numpy()
    limit = 1e-6 if policy_name == "full" else 0.25 * rel_err(together, full)
    assert rel_err(alone, together) <= limit


# -- gradients -------------------------------------------------------------------------
#: the reference through its custom VJP (the dense Pallas kernels in
#: interpret mode, staged): its einsum path rounds the contraction's
#: gradient onto the half grid (``tests/test_torch_train.py``)
J_GRAD = _jpath(J_SMOKE, True, False)


@pytest.fixture(scope="module")
def grad_case():
    jparams = jgino.init_gino(jax.random.PRNGKey(2), J_GRAD)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jb, labels = jsample_car_batch(5, 2, n_points=64, latent_grid=J_GRAD.latent_grid,
                                   k=J_GRAD.k_neighbors)
    return jparams, tree, jb, labels


def _jgrads(jparams, jb, labels, policy_name, tanh_port_order=False):
    batch = {k: jnp.asarray(v) for k, v in jb.items()}

    def loss(p):
        return jrelative_l2(jgino.gino_apply(p, batch, J_GRAD, jget_policy(policy_name)),
                            jnp.asarray(labels))

    with _unrolled(tanh_port_order):
        return _flat(jax.grad(loss)(jparams))


def _tgrads(tree, jb, labels, policy_name, monkeypatch):
    """The port's gradients, and the cotangent at each bias's broadcast add
    (one row per position; a stacked bias one entry per layer)."""
    import repro_torch.models.fno as tfno
    import repro_torch.models.gino as tgino

    net = gino_params_from_jax(tree, GINO_CAR_SMOKE, device="cpu")
    params = dict(net.named_parameters())
    bias_at = {}
    for n, p in params.items():
        if n.endswith(".b"):
            for row in (p if p.dim() == 2 else [p]):
                bias_at[row.data_ptr()] = n
    pre = []

    def recording(w, b, h, dtype):
        y = h.to(dtype) @ w.to(dtype)
        pre.append((bias_at[b.data_ptr()], y))
        return y + b.to(dtype)

    monkeypatch.setattr(tfno, "_linear", recording)
    monkeypatch.setattr(tgino, "_linear", recording)
    value = relative_l2(gino_apply(net, _torch_batch(jb), get_policy(policy_name)),
                        torch.from_numpy(labels))
    out = torch.autograd.grad(value, list(params.values()) + [y for _, y in pre])
    grads = {n: g.numpy() for n, g in zip(params, out)}
    cots = {}
    for (name, _), c in zip(pre, out[len(params):]):
        cots.setdefault(name, []).append(c)
    return grads, cots


def _xla_sum(c: torch.Tensor) -> np.ndarray:
    """A bias's cotangent (..., d) summed over its rows as the reference's
    CPU backend sums it: one ``lax.reduce`` in the cotangent's dtype."""
    jdt = jnp.bfloat16 if c.dtype == torch.bfloat16 else getattr(jnp, str(c.dtype)[6:])
    a = jnp.asarray(c.float().numpy()).astype(jdt)
    s = jax.lax.reduce(a, np.array(0, jdt), jax.lax.add, tuple(range(a.ndim - 1)))
    return np.asarray(s, np.float32)


@pytest.fixture(scope="module")
def full_grads(grad_case):
    jparams, _, jb, labels = grad_case
    return _jgrads(jparams, jb, labels, "full")


@pytest.mark.parametrize("policy_name", GRAD_POLICIES)
def test_gino_gradients_match_reference(grad_case, full_grads, policy_name, monkeypatch):
    """Per leaf, relative L2 of ``relative_l2``'s gradient at
    ``GINO_CAR_SMOKE`` against ``jax.grad`` of the reference (its block
    loop unrolled): within 1e-4 under ``full``; under ``mixed_fno_bf16``
    and ``amp_bf16`` within 1/4 of the policy's own gradient gap to
    ``full`` in the reference, on every leaf, against the reference with
    the port's order of the tanh VJP's sums, and within 0.95x the gap
    against the unchanged reference (``tests/test_torch_train.py``'s
    ``test_fno_gradients_match_reference`` says why both).

    Bias leaves, as there: the reference's CPU backend sums a broadcast
    bias's half cotangent in the half dtype (one ``lax.reduce`` over its
    rows, whose order for the GNO's (B, N, k, d) cotangents is not one
    row after another); the port sums in f32 and rounds once, as the card
    does.  The limits apply to the port's cotangents summed the
    reference's way, by ``jax.lax.reduce`` itself (``_xla_sum``); the
    port's own bias gradients are checked to be those cotangents summed in
    f32 (to the cotangent dtype's ε)."""
    jparams, tree, jb, labels = grad_case
    ref = _jgrads(jparams, jb, labels, policy_name)
    want = _jgrads(jparams, jb, labels, policy_name, tanh_port_order=True)
    got, cots = _tgrads(tree, jb, labels, policy_name, monkeypatch)
    assert set(got) == set(want)
    worst = 0.0
    for name, w in want.items():
        port = got[name]
        if name in cots:
            rows = [c.reshape(-1, c.shape[-1]) for c in cots[name]]
            f32 = torch.stack([r.float().sum(dim=0) for r in rows]).numpy()
            assert rel_err(port, f32.reshape(port.shape)) <= \
                FORMAT_EPS[dtype_name(rows[0].dtype)], name
            port = np.stack([_xla_sum(c) for c in cots[name]]).reshape(port.shape)
        err, err_ref = rel_err(port, w), rel_err(port, ref[name])
        if policy_name == "full":
            limit = limit_ref = 1e-4
        else:
            gap = rel_err(ref[name], full_grads[name])
            limit, limit_ref = 0.25 * gap, 0.95 * gap
        worst = max(worst, err / limit)
        print(f"{policy_name} {name}: port vs reference {err:.3e} (limit {limit:.3e}); "
              f"vs unchanged reference {err_ref:.3e} (limit {limit_ref:.3e})")
        assert err <= limit, (name, err, limit)
        assert err_ref <= limit_ref, (name, err_ref, limit_ref)
    print(f"{policy_name}: worst error/limit {worst:.3f}")


# -- parameters, entry points, the example -------------------------------------------------
def test_full_width_param_count_matches_the_reference():
    """``GINO_CAR``'s leaves and count against ``jax.eval_shape`` of the
    reference's initialiser; neither side allocates its 906 MB."""
    shapes = _flat(jax.eval_shape(lambda: jgino.init_gino(jax.random.PRNGKey(0), J_CAR)),
                   leaf=lambda v: v)
    with torch.device("meta"):
        net = GINO(GINO_CAR)
    state = net.state_dict()
    assert set(state) == set(shapes)
    for name, s in shapes.items():
        assert tuple(state[name].shape) == tuple(s.shape), name
    assert param_count(net) == sum(int(np.prod(s.shape)) for s in shapes.values())
    assert param_count(net.fno) == 226_521_568
    for f in dataclasses.fields(GINO_CAR):
        if f.name != "fno":
            assert getattr(GINO_CAR, f.name) == getattr(J_CAR, f.name), f.name
    for f in dataclasses.fields(GINO_CAR.fno):
        assert getattr(GINO_CAR.fno, f.name) == getattr(J_CAR.fno, f.name), f.name


def test_params_from_jax_round_trip_and_init(grad_case):
    _, tree, _, _ = grad_case
    net = gino_params_from_jax(tree, GINO_CAR_SMOKE, device="cpu")
    state = net.state_dict()
    flat = _flat(tree)
    assert set(state) == set(flat)
    for name, v in flat.items():
        np.testing.assert_array_equal(state[name].numpy(), v)
    with pytest.raises(RuntimeError):   # a missing entry is refused
        gino_params_from_jax({k: v for k, v in tree.items() if k != "head2"},
                             GINO_CAR_SMOKE, device="cpu")
    a = init_gino(torch.Generator().manual_seed(0), GINO_CAR_SMOKE, device="cpu")
    b = init_gino(torch.Generator().manual_seed(0), GINO_CAR_SMOKE, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items(), strict=True):
        assert ka == kb and torch.equal(va, vb) and va.shape == state[ka].shape
    # the reference's scaled normals: dec_k1 std = 1/sqrt(6 + C), biases 0
    w = a.dec_k1["w"].detach()
    assert abs(float(w.std()) * (6 + GINO_CAR_SMOKE.fno.out_channels) ** 0.5 - 1.0) < 0.3
    assert not a.dec_k1["b"].any()


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_gino(torch.Generator().manual_seed(0), GINO_CAR_SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample_car_batch(0, 1, n_points=16, latent_grid=4, k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gino_car_cfd.main(["--steps", "1"])


def test_example_trains_and_evaluates():
    out = gino_car_cfd.main(["--steps", "4", "--device", "cpu"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert {h["policy"] for h in out["history"]} == {"mixed_fno_bf16"}
    assert losses[-1] < losses[0]
    assert np.isfinite(out["eval"])
