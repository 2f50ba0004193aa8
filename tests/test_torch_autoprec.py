"""The port's auto-precision slice against ``repro.autoprec`` on the CPU.

The same numpy inputs, and weights bridged with ``params_from_jax`` /
``sfno_params_from_jax``, go through both packages:

* ``site_stats`` on the same seeded real and complex tensors (inf, NaN,
  values near fp16's max and below its smallest normal, a tensor of more
  than 2^20 elements, which raises the stride): amax, qerr, n, overflow
  and underflow equal; histograms equal but for the subsampled elements
  within 2 f32 ulps of a power of two, where ``torch.log2`` and
  ``jnp.log2`` may round to different buckets (each counted, and exactly
  that many moves allowed);
* the tap sites and their stats for ``FNO_DARCY_SMOKE``,
  ``TFNO_NS_SMOKE`` and ``SFNO_SWE_SMOKE`` under four policies (the
  reference on its CPU default, the einsum path).  The tapped tensors themselves are recorded on both
  sides, so the histogram and underflow limits count exactly the
  subsampled elements whose port and reference values lie in different
  exponent buckets or on different sides of the format's smallest normal
  (the FFT libraries differ in the last bits), or within 2 ulps of a power
  of two; amax within 1e-5 relative under ``full`` and qerr within
  ``1e-5 · amax``; under the half policies within 1/4 of the reference's
  own policy-vs-``full`` difference of the same quantity, with those
  floors;
* the controller on scripted windows (demotion after patience, the budget
  tightening with the grid, the range check, promotion on an overflow
  streak with cooldown, uncontrolled sites), ``describe``, ``overlay`` and
  the policy names; ``precision.describe`` for every registry policy;
* the trainer and the operator engine in auto mode (the reference's own
  tiny problems), the microbatch merge, the loss-scale state across an
  overlay change; ``certify_policy`` and ``certify_controller``; the fused
  dispatch's telemetry veto; the example's ``--auto-precision``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.autoprec as jap
import repro.autoprec.certify as jcertify
import repro.autoprec.telemetry as jtel
import repro.models.fno as jfno
import repro.models.sfno as jsfno
from repro.configs.fno_paper import FNO_DARCY_SMOKE as J_DARCY
from repro.configs.fno_paper import SFNO_SWE_SMOKE as J_SFNO
from repro.configs.fno_paper import TFNO_NS_SMOKE as J_TFNO
from repro.core import get_policy as jget_policy
from repro.precision import POLICIES as J_POLICIES
from repro.precision import describe as jdescribe
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import relative_l2 as jrelative_l2
from repro_torch import autoprec as tap_
from repro_torch.autoprec import certify as tcertify
from repro_torch.autoprec import telemetry as ttel
from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE, SFNO_SWE_SMOKE, TFNO_NS_SMOKE
from repro_torch.core.precision import FORMAT_EPS, FORMAT_TINY
from repro_torch.core.schedule import PrecisionSchedule
from repro_torch.kernels import ops
from repro_torch.models import (
    FNO,
    FNOConfig,
    fno_apply,
    fno_infer,
    params_from_jax,
    sfno_apply,
    sfno_params_from_jax,
)
from repro_torch.optim import AdamW
from repro_torch.precision import POLICIES, describe, get_policy
from repro_torch.serve import FieldRequest, OperatorEngine
from repro_torch.train import Trainer, TrainerConfig, relative_l2

from helpers import rel_err

jax.config.update("jax_platform_name", "cpu")

TAP_POLICIES = ("full", "mixed_fno_bf16", "mixed_fno_fp16", "sim_fp8_e4m3")


# -- counting the elements a histogram may move ---------------------------------------------
def _bucket(v: np.ndarray) -> np.ndarray:
    """The exact exponent bucket of f32 magnitudes (``frexp``), -1 for 0 and NaN."""
    _, e = np.frexp(v.astype(np.float64))
    b = np.clip(e - 1 - ttel.EXP_MIN, 0, ttel.N_BUCKETS - 1)
    return np.where((v > 0) & ~np.isnan(v), b, -1)


def _near_power_of_two(v: np.ndarray) -> np.ndarray:
    """Finite non-zero f32 magnitudes within 2 ulps of a power of two, where
    two ``floor(log2(x))`` implementations may round differently."""
    v = v.astype(np.float32)
    ok = np.isfinite(v) & (v > 0)
    m, e = np.frexp(np.where(ok, v, 1.0).astype(np.float64))
    p = np.ldexp(np.where(m >= 0.75, 1.0, 0.5), e)
    return ok & (np.abs(v.astype(np.float64) - p) <= 2 * np.spacing(np.float32(p), dtype=np.float32))


def _subsamples(x: np.ndarray, stride_floor=ttel.HIST_STRIDE):
    """(subsample of |part| as f32, scale) per real part, as both packages take them."""
    x = np.asarray(x)
    parts = (x.real, x.imag) if np.iscomplexobj(x) else (x,)
    out = []
    for p in parts:
        mag = np.abs(p.astype(np.float32))
        stride = max(1, stride_floor, -(-p.size // ttel.HIST_MAX_SAMPLES))
        sub = mag.reshape(-1)[::stride]
        out.append((sub, np.float32(p.size / max(sub.size, 1))))
    return out


def _allowed_moves(xt, xj, tiny):
    """(histogram mass, underflow mass) that may differ between the stats of
    ``xt`` (port) and ``xj`` (reference): per subsampled element, its scale
    where the two values lie in different buckets or near a power of two
    (histogram), or on different sides of ``tiny`` (underflow)."""
    hist = under = 0.0
    for (st, scale), (sj, _) in zip(_subsamples(xt), _subsamples(xj), strict=True):
        moved = (_bucket(st) != _bucket(sj)) | _near_power_of_two(st) | _near_power_of_two(sj)
        hist += float(scale) * int(moved.sum())
        ut, uj = (st > 0) & (st < tiny), (sj > 0) & (sj < tiny)
        under += float(scale) * int((ut != uj).sum())
    return hist, under


def _np_stats(s):
    return {k: np.asarray(v.cpu().numpy() if torch.is_tensor(v) else v, np.float64)
            for k, v in s._asdict().items()}


# -- site_stats -------------------------------------------------------------------------------
def _stats_inputs():
    rng = np.random.RandomState(0)
    real = (rng.randn(37, 129) * 3.0).astype(np.float32)
    special = rng.randn(4096).astype(np.float32)
    special[:12] = [np.inf, -np.inf, np.nan, 65504.0, 65520.0, -7e4, 6.1e-5, 5e-5, -1e-7,
                    0.0, 3e38, 1e-40]
    special[12:40] = np.float32(2.0) ** rng.randint(-30, 20, size=28)   # exact powers of two
    cplx = (rng.randn(6, 5, 33) + 1j * rng.randn(6, 5, 33)).astype(np.complex64)
    big = (rng.randn(1100, 1000) * np.exp(rng.randn(1100, 1000) * 4)).astype(np.float32)
    return {"real": real, "special": special, "complex": cplx, "big": big}


STATS_INPUTS = _stats_inputs()


@pytest.mark.parametrize("fmt", ["float32", "float16", "bfloat16", "fp8_e4m3"])
@pytest.mark.parametrize("name", sorted(STATS_INPUTS))
def test_site_stats_matches_reference(name, fmt):
    x = STATS_INPUTS[name]
    xq = (x * np.float32(1 + 2.0 ** -9)).astype(x.dtype) if name != "special" else None
    jx = jnp.asarray(x)
    # eager: under a jit XLA may contract the histogram's scale and sum into
    # one fma, which moves its f32 roundings
    want = _np_stats(jtel.site_stats(jx, fmt=fmt,
                                     quantized=None if xq is None else jnp.asarray(xq)))
    got = _np_stats(ttel.site_stats(torch.from_numpy(x), fmt=fmt,
                                    quantized=None if xq is None else torch.from_numpy(xq)))
    for k in ("amax", "qerr", "n", "overflow", "underflow"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    near = sum(float(scale) * int(_near_power_of_two(sub).sum()) for sub, scale in _subsamples(x))
    moved = np.abs(got["hist"] - want["hist"]).sum()
    assert moved <= 2 * near, (moved, near)
    assert got["hist"].sum() == pytest.approx(want["hist"].sum(), rel=1e-6)
    if name == "big":
        assert x.size > 1 << 20 and near >= 0


def test_collector_scoping_merging_and_aggregation():
    assert not tap_.telemetry_active()
    tap_.tap("s", torch.ones(3))                       # no collector: nothing happens
    col = tap_.TraceCollector(hist_stride=1)
    with tap_.collecting(col):
        assert tap_.telemetry_active()
        inner = tap_.TraceCollector()
        with tap_.collecting(inner):
            tap_.tap("t", torch.tensor([3.0]))
        tap_.tap("s", torch.tensor([1.0]), fmt="float32")
        tap_.tap("s", torch.tensor([5.0]), fmt="float32")
    assert not tap_.telemetry_active() and set(inner.snapshot()) == {"t"}
    snap = col.snapshot()
    assert float(snap["s"].amax) == 5.0 and float(snap["s"].n) == 2.0
    agg = tap_.TelemetryAggregator()
    agg.update(snap)
    agg.update(snap)
    assert agg.totals["s"].updates == 2 and agg.take_window()["s"].updates == 2
    assert agg.window() == {} and agg.counters()["sites"]["s"]["amax"] == 5.0
    stacked = ttel.stack_snapshots([snap, col.snapshot()])
    merged = tap_.merge_stacked(stacked)["s"]
    assert float(merged.n) == 4.0 and float(merged.amax) == 5.0


def test_tap_keeps_no_graph():
    w = torch.randn(5, requires_grad=True)
    col = tap_.TraceCollector()
    with tap_.collecting(col):
        tap_.tap("s", w * 2.0, quantized=(w * 2.0).round())
    s = col.snapshot()["s"]
    assert not any(t.requires_grad for t in (s.amax, s.qerr, s.overflow, s.underflow, s.hist))


# -- the tap sites of the models ------------------------------------------------------------------
#: the reference on its CPU default, the einsum path, which taps the same
#: tensors through ``SitePrecision.contract`` as its kernels' wrappers do
MODELS = {
    "darcy": (dataclasses.replace(J_DARCY, use_pallas=False), FNO_DARCY_SMOKE, (2, 1, 24, 24)),
    "tfno": (dataclasses.replace(J_TFNO, use_pallas=False), TFNO_NS_SMOKE, (2, 1, 24, 24)),
    "sfno": (dataclasses.replace(J_SFNO, use_pallas=False), SFNO_SWE_SMOKE, (2, 3, 16, 32)),
}


class _Recorder:
    """Wraps a package's ``site_stats`` and collector so every tap's raw
    tensor is kept beside its site and format, in call order."""

    def __init__(self, module, monkeypatch):
        self.raw, self._pending = [], []
        real = module.site_stats

        def site_stats(x, fmt=None, quantized=None, **kw):
            self._pending.append((x, fmt))
            return real(x, fmt=fmt, quantized=quantized, **kw)

        monkeypatch.setattr(module, "site_stats", site_stats)
        rec = self

        class Collector(module.TraceCollector):
            def record(self, site, stats):
                x, fmt = rec._pending.pop()
                rec.raw.append((site, fmt, x.detach().clone() if torch.is_tensor(x) else x))
                super().record(site, stats)

        self.Collector = Collector


def _seeded_tree(init, cfg, seed):
    """A parameter tree of numpy arrays in the reference's layout, drawn by
    the port's seeded ``init`` (the JAX initialisers compile for seconds)."""
    tree = {}
    for k, p in init(torch.Generator().manual_seed(seed), cfg, device="cpu").state_dict().items():
        group, leaf = k.split(".")
        tree.setdefault(group, {})[leaf] = p.numpy()
    return tree


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def bridged():
    from repro_torch.models import init_fno, init_sfno

    out = {}
    for name, (_, tcfg, shape) in MODELS.items():
        sfno = name == "sfno"
        tree = _seeded_tree(init_sfno if sfno else init_fno, tcfg, 1)
        net = (sfno_params_from_jax if sfno else params_from_jax)(tree, tcfg, device="cpu")
        x = np.random.RandomState(2).randn(*shape).astype(np.float32)
        out[name] = (_jax_tree(tree), net, x)
    return out


def _ref_run(name, jparams, x, policy_name, monkeypatch):
    """The reference's forward under a collector, jitted as its trainer and
    engine run it; the tapped tensors come out beside the snapshot."""
    jcfg = MODELS[name][0]
    apply = jsfno.sfno_apply if name == "sfno" else jfno.fno_apply
    meta = []

    def run(p, xx):
        rec = _Recorder(jtel, monkeypatch)
        col = rec.Collector()
        with jap.collecting(col):
            apply(p, xx, jcfg, jget_policy(policy_name))
        meta[:] = [(site, fmt) for site, fmt, _ in rec.raw]
        return col.snapshot(), [a for _, _, a in rec.raw]

    snap, raws = jax.jit(run)(jparams, jnp.asarray(x))
    agg = jap.TelemetryAggregator()
    agg.update(snap)
    return agg.totals, [(s, f, np.asarray(a)) for (s, f), a in zip(meta, raws, strict=True)]


def _port_run(name, net, x, policy_name, monkeypatch):
    rec = _Recorder(ttel, monkeypatch)
    col = rec.Collector()
    apply = sfno_apply if name == "sfno" else fno_apply
    with torch.no_grad(), tap_.collecting(col):
        apply(net, torch.from_numpy(x), get_policy(policy_name))
    agg = tap_.TelemetryAggregator()
    agg.update(col.snapshot())
    return agg.totals, [(s, f, a.numpy()) for s, f, a in rec.raw]


@pytest.fixture(scope="module")
def reference_full(bridged):
    mp = pytest.MonkeyPatch()
    try:
        return {name: _ref_run(name, jparams, x, "full", mp)[0]
                for name, (jparams, _, x) in bridged.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("policy_name", TAP_POLICIES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_tap_sites_and_stats_match_reference(bridged, reference_full, name, policy_name,
                                             monkeypatch):
    jparams, net, x = bridged[name]
    want, jraw = _ref_run(name, jparams, x, policy_name, monkeypatch)
    got, traw = _port_run(name, net, x, policy_name, monkeypatch)
    model = "sfno" if name == "sfno" else "fno"
    n_layers = MODELS[name][1].n_layers
    assert set(got) == set(want) == {f"{model}/layer{i}/spectral/{s}" for i in range(n_layers)
                                     for s in ("fft_in", "contract", "fft_out")}
    # the same taps, in the same order, on tensors of the same shapes
    assert [(s, f, a.shape) for s, f, a in traw] == [(s, f, a.shape) for s, f, a in jraw]
    full = reference_full[name]
    for site, w in want.items():
        g = got[site]
        assert (g.n, g.overflow, g.updates) == (w.n, w.overflow, w.updates), site
        amax_lim, qerr_lim = 1e-5 * w.amax, 1e-5 * w.amax
        if policy_name != "full":
            amax_lim = max(amax_lim, 0.25 * abs(w.amax - full[site].amax))
            qerr_lim = max(qerr_lim, 0.25 * abs(w.qerr - full[site].qerr))
        assert abs(g.amax - w.amax) <= amax_lim, (site, g.amax, w.amax, amax_lim)
        assert abs(g.qerr - w.qerr) <= qerr_lim, (site, g.qerr, w.qerr, qerr_lim)
        fmt = {f for s, f, _ in jraw if s == site}.pop()
        hist_ok = under_ok = 0.0
        for (s, _, xt), (_, _, xj) in zip(traw, jraw, strict=True):
            if s == site:
                h, u = _allowed_moves(xt, xj, FORMAT_TINY.get(fmt or "float32", 0.0))
                hist_ok, under_ok = hist_ok + h, under_ok + u
        moved = float(np.abs(g.hist - w.hist).sum())
        assert moved <= 2 * hist_ok * (1 + 1e-6), (site, moved, hist_ok)
        assert abs(g.underflow - w.underflow) <= under_ok * (1 + 1e-6), (site, g.underflow,
                                                                          w.underflow, under_ok)


def test_veto_runs_the_staged_path_under_a_collector(bridged, monkeypatch):
    """``fuse_spectral=True`` under a collector: no fused call, the staged
    output bit for bit, the ``fft_in`` and ``contract`` taps present;
    without a collector the same config takes the fused path."""
    _, net, x = bridged["darcy"]
    fused = FNO(dataclasses.replace(FNO_DARCY_SMOKE, fuse_spectral=True))
    fused.load_state_dict(net.state_dict())
    calls = []
    real = ops.spectral_conv_fused
    monkeypatch.setattr(ops, "spectral_conv_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    xt, pol = torch.from_numpy(x), get_policy("mixed_fno_bf16")
    with torch.no_grad():
        fno_apply(fused, xt, pol)
        assert len(calls) == FNO_DARCY_SMOKE.n_layers
        calls.clear()
        col, col2 = tap_.TraceCollector(), tap_.TraceCollector()
        with tap_.collecting(col):
            y_fused_cfg = fno_apply(fused, xt, pol)
        with tap_.collecting(col2):
            y_staged = fno_apply(net, xt, pol)
    assert calls == []
    assert torch.equal(y_fused_cfg, y_staged)
    assert set(col.snapshot()) == set(col2.snapshot())
    assert {"fno/layer0/spectral/fft_in", "fno/layer0/spectral/contract"} <= set(col.snapshot())


# -- the controller ---------------------------------------------------------------------------------
def _windows(cls, amax=10.0, overflow=0.0, n=1000.0, bucket=30):
    w = cls(updates=1, amax=amax, qerr=0.0, n=n, overflow=overflow, underflow=0.0,
            overflow_updates=int(overflow > 0))
    w.hist[bucket] = n
    return w


def _rules(entries):
    def name(v):
        if v is None or isinstance(v, (str, bool)):
            return v
        try:
            return np.dtype(v).name
        except TypeError:
            return str(v).removeprefix("torch.") if "torch" in str(v) else repr(v)

    return [(p, {f: name(getattr(r, f)) for f in ("compute", "accum", "stabilize", "quantize",
                                                  "loss_scaling")}) for p, r in entries]


SCRIPTS = {
    # (controller kwargs, [(window kwargs per site, grid_points)])
    "demote_after_patience": ({"grid_points": 1024, "demote_patience": 2, "cooldown": 0},
                              [({"fno/layer0/spectral/fft_in": {}}, None)] * 3),
    "budget_bf16_at_128": ({"demote_patience": 1, "cooldown": 0},
                           [({"fno/layer0/spectral/fft_in": {}}, 128 * 128)]),
    "budget_fp16_at_421": ({"demote_patience": 1, "cooldown": 0},
                           [({"fno/layer0/spectral/fft_in": {}}, 421 * 421)]),
    "range_blocks_fp16": ({"demote_patience": 1, "cooldown": 0},
                          [({"fno/layer0/spectral/fft_in": {"amax": 30000.0}}, 421 * 421)]),
    "underflow_blocks_fp8": ({"grid_points": 64, "demote_patience": 1, "cooldown": 0},
                             [({"fno/layer0/spectral/fft_in": {"bucket": 2}}, None)]),
    "promote_on_streak_with_cooldown": (
        {"grid_points": 1024, "demote_patience": 1, "promote_streak": 2, "cooldown": 2},
        [({"fno/layer0/spectral/fft_in": {}}, None),
         ({"fno/layer0/spectral/fft_in": {"overflow": 5.0}}, None),
         ({"fno/layer0/spectral/fft_in": {"overflow": 5.0}}, None),
         ({"fno/layer0/spectral/fft_in": {}}, None),
         ({"fno/layer0/spectral/fft_in": {}}, None),
         ({"fno/layer0/spectral/fft_in": {}}, None)]),
    "uncontrolled_sites": ({"grid_points": 1024, "demote_patience": 1, "cooldown": 0},
                           [({"lm/dense": {}, "serve/operator": {}}, None)]),
    "two_layers_fp16_scaling": (
        {"demote_patience": 1, "cooldown": 0, "formats": ("float16",)},
        [({"sfno/layer0/spectral/contract": {}, "sfno/layer1/spectral/fft_out": {},
           "sfno/layer1/spectral/fft_in": {"amax": 3.0}}, 4096)] * 2),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_controller_decides_as_the_reference(script):
    kw, steps = SCRIPTS[script]
    tctl = tap_.AutoPrecisionController(base="full", **kw)
    jctl = jap.AutoPrecisionController(base="full", **kw)
    for i, (sites, grid) in enumerate(steps):
        tw = {s: _windows(tap_.SiteWindow, **v) for s, v in sites.items()}
        jw = {s: _windows(jap.SiteWindow, **v) for s, v in sites.items()}
        assert tctl.update(tw, grid_points=grid, step=i) == jctl.update(jw, grid_points=grid,
                                                                         step=i)
        assert tctl.describe() == jctl.describe()
        assert _rules(tctl.overlay()) == _rules(jctl.overlay())
        assert tctl.policy().name == jctl.policy().name
        assert describe(tctl.policy()) == jdescribe(jctl.policy())
        for site in sites:
            t, j = tctl.policy().at(site), jctl.policy().at(site)
            assert (ttel.fmt_of(t), t.spectral_is_half, t.stabilizer) == (
                jtel.fmt_of(j), j.spectral_is_half, j.stabilizer)
    fmts = {g: s["fmt"] for g, s in tctl.describe()["sites"].items()}
    expect = {"budget_bf16_at_128": "bfloat16", "budget_fp16_at_421": "float16",
              "range_blocks_fp16": "float32", "demote_after_patience": "bfloat16"}
    if script in expect:
        assert fmts == {"fno/layer0/spectral": expect[script]}
    if script == "uncontrolled_sites":
        assert fmts == {} and tctl.overlay() == ()


def test_eps_budget_and_group_of_match_the_reference():
    t, j = tap_.AutoPrecisionController(), jap.AutoPrecisionController()
    for n in (24 ** 2, 64 ** 2, 128 ** 2, 421 ** 2, None):
        assert t.eps_budget(n) == j.eps_budget(n)
    assert FORMAT_EPS["bfloat16"] <= t.eps_budget(128 ** 2) < FORMAT_EPS["fp8_e4m3"]
    assert FORMAT_EPS["float16"] <= t.eps_budget(421 ** 2) < FORMAT_EPS["bfloat16"]
    for site in ("fno/layer3/spectral/fft_in", "sfno/layer0/spectral/contract",
                 "serve/kv_cache", "a/spectral/b/spectral/c"):
        assert tap_.group_of(site) == jap.group_of(site)


def test_describe_matches_the_reference_for_every_policy():
    assert sorted(POLICIES) == sorted(J_POLICIES)
    for name in POLICIES:
        assert describe(get_policy(name)) == jdescribe(jget_policy(name)), name


# -- the trainer ---------------------------------------------------------------------------------------
_TINY = FNOConfig(in_channels=1, out_channels=1, hidden_channels=8, lifting_channels=8,
                  projection_channels=8, n_layers=2, modes=(4, 4))


def _tiny_problem(n_layers=2):
    """The reference's ``tests/test_autoprec.py`` problem, both packages."""
    jcfg = jfno.FNOConfig(in_channels=1, out_channels=1, hidden_channels=8, lifting_channels=8,
                          projection_channels=8, n_layers=n_layers, modes=(4, 4))
    tcfg = dataclasses.replace(_TINY, n_layers=n_layers)
    from repro_torch.models import init_fno

    tree = _seeded_tree(init_fno, tcfg, 0)
    jparams, net = _jax_tree(tree), params_from_jax(tree, tcfg, device="cpu")
    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(4, 1, 16, 16).astype(np.float32),
             "t": (rng.randn(4, 1, 16, 16) * 0.1).astype(np.float32)}

    def jloss(p, b, policy):
        return jrelative_l2(jfno.fno_apply(p, b["x"], jcfg, policy), b["t"])

    def tloss(m, b, policy):
        return relative_l2(fno_apply(m, b["x"], policy), b["t"])

    return jparams, net, jloss, tloss, batch


def test_auto_mode_trainer_decides_as_the_reference():
    jparams, net, jloss, tloss, batch = _tiny_problem()
    kw = dict(base="full", grid_points=256, interval=3, demote_patience=1, cooldown=0)
    jctl, tctl = jap.AutoPrecisionController(**kw), tap_.AutoPrecisionController(**kw)
    jtr = JTrainer(jloss, jparams, JTrainerConfig(total_steps=9, autoprec=jctl))
    ttr = Trainer(tloss, net, TrainerConfig(total_steps=9, autoprec=tctl), device="cpu")
    jhist = jtr.run(lambda _s: {k: jnp.asarray(v) for k, v in batch.items()})
    thist = ttr.run(lambda _s: batch)
    assert [h["policy"] for h in thist] == [h["policy"] for h in jhist] == \
        ["full+auto0"] * 3 + ["full+auto1"] * 6
    assert ttr.stats["policy_changes"] == jtr.stats["policy_changes"] == 1
    td, jd = tctl.describe(), jctl.describe()
    assert {g: s["fmt"] for g, s in td["sites"].items()} == \
        {g: s["fmt"] for g, s in jd["sites"].items()} == \
        {f"fno/layer{i}/spectral": "bfloat16" for i in range(2)}
    for g, s in td["sites"].items():
        assert s["amax"] == pytest.approx(jd["sites"][g]["amax"], rel=1e-3)
    tc, jc = ttr.telemetry.counters(), jtr.telemetry.counters()
    assert tc["overflow_total"] == jc["overflow_total"] == 0
    assert set(tc["sites"]) == set(jc["sites"]) and len(tc["sites"]) == 6
    for site, s in tc["sites"].items():
        assert (s["updates"], s["values"]) == (jc["sites"][site]["updates"],
                                               jc["sites"][site]["values"])
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist],
                               rtol=2e-2)


def test_microbatches_merge_their_telemetry_as_the_reference():
    jparams, net, jloss, tloss, batch = _tiny_problem(n_layers=1)
    tot = {}
    for nmicro in (1, 2):
        tr = Trainer(tloss, net, TrainerConfig(total_steps=2, microbatches=nmicro,
                                               telemetry=True), device="cpu")
        tr.run(lambda _s: batch)
        tot[nmicro] = tr.telemetry.totals
    jtr = JTrainer(jloss, jparams, JTrainerConfig(total_steps=2, microbatches=2,
                                                  telemetry=True))
    jtr.run(lambda _s: {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(tot[2]) == set(jtr.telemetry.totals)
    for site, w in tot[2].items():
        jw = jtr.telemetry.totals[site]
        assert (w.updates, w.n, w.overflow) == (jw.updates, jw.n, jw.overflow) == (
            2, tot[1][site].n, 0.0)
        assert w.amax == pytest.approx(jw.amax, rel=1e-5)
        assert w.amax == pytest.approx(tot[1][site].amax, rel=1e-5)


def test_overlay_change_carries_the_loss_scale_state():
    _, net, _, tloss, batch = _tiny_problem(n_layers=1)
    ctl = tap_.AutoPrecisionController(base="full", grid_points=256, interval=2,
                                       demote_patience=1, cooldown=0, formats=("float16",))
    tr = Trainer(tloss, net, TrainerConfig(total_steps=8, autoprec=ctl), device="cpu")
    tr.scale_state = tr.scale_state._replace(scale=torch.tensor(256.0))
    hist = tr.run(lambda _s: batch)
    assert ctl.sites["fno/layer0/spectral"].fmt == "float16"
    assert tr.stats["policy_changes"] == 1 and tr.stats["skipped_steps"] == 0
    assert ctl.policy().at("train/loss_scale").loss_scaling
    assert float(tr.scale_state.scale) <= 256.0
    assert np.isfinite([h["loss"] for h in hist]).all()


def test_static_training_collects_nothing():
    _, net, _, tloss, batch = _tiny_problem(n_layers=1)
    tr = Trainer(tloss, net, TrainerConfig(total_steps=3), device="cpu")
    hist = tr.run(lambda _s: batch)
    assert tr.telemetry is None and tr.controller is None
    assert hist[-1]["loss"] < hist[0]["loss"]


# -- the operator engine ----------------------------------------------------------------------------
def _engines(**kw):
    jcfg = jfno.FNOConfig(in_channels=1, out_channels=1, hidden_channels=8,
                          lifting_channels=8, projection_channels=8, n_layers=1, modes=(4, 4))
    from repro_torch.models import init_fno

    tree = _seeded_tree(init_fno, dataclasses.replace(_TINY, n_layers=1), 0)
    jparams = _jax_tree(tree)
    net = params_from_jax(tree, dataclasses.replace(_TINY, n_layers=1), device="cpu")
    from repro.serve import FieldRequest as JFieldRequest
    from repro.serve import OperatorEngine as JOperatorEngine

    jkw = {k: (jap.AutoPrecisionController(**v) if k == "autoprec" else v)
           for k, v in kw.items()}
    tkw = {k: (tap_.AutoPrecisionController(**v) if k == "autoprec" else v)
           for k, v in kw.items()}
    return (JOperatorEngine(jparams, jcfg, max_batch=2, **jkw), JFieldRequest,
            OperatorEngine(net, max_batch=2, device="cpu", **tkw), net, jparams, jcfg)


def _serve(engine, req_cls, fields):
    reqs = [req_cls(uid=i, x=x) for i, x in enumerate(fields)]
    for r in reqs:
        engine.submit(r)
    engine.drain()
    return reqs


def test_engine_numerics_counters_match_the_reference():
    jeng, jreq, teng, *_ = _engines(telemetry=True)
    rng = np.random.RandomState(0)
    fields = [rng.randn(1, 16, 16).astype(np.float32) for _ in range(3)]
    _serve(jeng, jreq, fields)
    _serve(teng, FieldRequest, fields)
    tn, jn = teng.stats()["numerics"], jeng.stats()["numerics"]
    assert tn["steps"] == jn["steps"] == 2
    assert tn["overflow_total"] == jn["overflow_total"] == 0
    assert set(tn["sites"]) == set(jn["sites"]) >= {"fno/layer0/spectral/fft_in"}
    for site, s in tn["sites"].items():
        j = jn["sites"][site]
        assert (s["updates"], s["values"], s["overflow"]) == (j["updates"], j["values"],
                                                               j["overflow"])
        assert s["amax"] == pytest.approx(j["amax"], rel=1e-5)
    assert "autoprec" not in teng.stats()


def test_online_controller_retunes_as_the_reference():
    ctl = {"base": "full", "demote_patience": 1, "cooldown": 0}
    jeng, jreq, teng, net, _, _ = _engines(autoprec=ctl, autoprec_every=2, memo_window=4)
    rng = np.random.RandomState(0)
    fields = [rng.randn(1, 16, 16).astype(np.float32) for _ in range(8)]
    _serve(jeng, jreq, fields)
    treqs = _serve(teng, FieldRequest, fields)
    ts, js = teng.stats(), jeng.stats()
    assert ts["policy"] == js["policy"] == "full+auto1"
    assert ts["autoprec"]["version"] == js["autoprec"]["version"] == 1
    assert {g: s["fmt"] for g, s in ts["autoprec"]["sites"].items()} == \
        {g: s["fmt"] for g, s in js["autoprec"]["sites"].items()} == \
        {"fno/layer0/spectral": "bfloat16"}
    assert ts["autoprec"]["sites"]["fno/layer0/spectral"]["eps_budget"] == \
        js["autoprec"]["sites"]["fno/layer0/spectral"]["eps_budget"]
    assert ts["memo"] == js["memo"]        # cleared at the change, as the reference's
    ref = fno_infer(net, fields[-1][None], get_policy("full"), device="cpu").numpy()[0]
    np.testing.assert_allclose(treqs[-1].y, ref, atol=0.05)
    # one field served alone equals its batched answer under the same policy
    solo = OperatorEngine(net, max_batch=2, device="cpu", autoprec=teng.controller,
                          autoprec_every=100)
    (alone,) = _serve(solo, FieldRequest, [fields[-1]])
    assert np.array_equal(alone.y, treqs[-1].y)


# -- certification -----------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def certify_parts():
    """Both packages' ``tiny_fno`` configs with one set of seeded weights,
    and one unit-normalised input at the tap tests' 24² grid."""
    from repro_torch.models import init_fno

    tcfg, _ = tcertify.tiny_fno(device="cpu")
    jcfg = jfno.FNOConfig(in_channels=1, out_channels=1, hidden_channels=16,
                          lifting_channels=16, projection_channels=16, n_layers=2, modes=(8, 8))
    tree = _seeded_tree(init_fno, tcfg, 7)
    x = np.random.RandomState(5).randn(2, 1, 24, 24).astype(np.float32)
    x /= np.abs(x).max()
    return jcfg, _jax_tree(tree), tcfg, params_from_jax(tree, tcfg, device="cpu"), x


@pytest.fixture
def jitted_reference_fno(monkeypatch):
    """The reference's ``fno_apply`` as its engine runs it, one compiled
    program per config and policy (its certify helpers call it eagerly,
    which compiles every jnp op of a new shape for seconds).  Under an
    outer collector the taps are collected inside the program and recorded
    into it."""
    import functools

    import repro.models as jmodels

    real = jmodels.fno_apply

    @functools.lru_cache(maxsize=None)
    def compiled(cfg, policy, collect):
        def run(p, x):
            if not collect:
                return real(p, x, cfg, policy), {}
            col = jap.TraceCollector()
            with jap.collecting(col):
                y = real(p, x, cfg, policy)
            return y, col.snapshot()

        return jax.jit(run)

    def fno_apply_(p, x, cfg, policy):
        outer = jtel.current_collector()
        y, snap = compiled(cfg, policy, outer is not None)(p, x)
        for site, stats in snap.items():
            outer.record(site, stats)
        return y

    monkeypatch.setattr(jmodels, "fno_apply", fno_apply_)


def _same_report(got, want):
    assert got["policy"] == want["policy"] and got["batch"] == want["batch"]
    assert set(got["sites"]) == set(want["sites"])
    assert got["demoted_sites"] == want["demoted_sites"]
    assert got["all_within"] == want["all_within"]
    for site, w in want["sites"].items():
        g = got["sites"][site]
        for k in ("fmt", "demoted", "eps", "overflow", "checked", "within"):
            assert g[k] == w[k], (site, k)
        assert g["amax"] == pytest.approx(w["amax"], rel=1e-3)
        assert g["qerr_measured"] == pytest.approx(w["qerr_measured"], rel=0.25, abs=1e-7)
    ge, we = got["end_to_end"], want["end_to_end"]
    for k in ("disc_upper_bound", "field_L", "field_M", "grid_points"):
        assert ge[k] == pytest.approx(we[k], rel=1e-6), k
    assert abs(ge["prec_rel_l2"] - we["prec_rel_l2"]) <= 0.25 * we["prec_rel_l2"] + 1e-6


@pytest.mark.parametrize("policy_name", ["mixed_fno_bf16", "mixed_fno_fp16"])
def test_certify_policy_matches_the_reference(certify_parts, jitted_reference_fno, policy_name):
    jcfg, jparams, tcfg, net, x = certify_parts
    want = jcertify.certify_policy(jget_policy(policy_name), jcfg, jparams, x, resolution=24)
    got = tcertify.certify_policy(get_policy(policy_name), tcfg, net, x, resolution=24)
    _same_report(got, want)
    assert got["all_within"] and got["demoted_sites"]
    assert got["end_to_end"]["prec_fraction_of_disc"] < 0.5


def test_certify_controller_matches_the_reference(certify_parts, jitted_reference_fno,
                                                 monkeypatch):
    jcfg, jparams, tcfg, net, x = certify_parts
    monkeypatch.setattr(jcertify, "sample_inputs", lambda *a, **k: x)
    monkeypatch.setattr(jcertify, "tiny_fno", lambda *a, **k: (jcfg, jparams))
    kw = dict(base="full", grid_points=24 ** 2, demote_patience=1, cooldown=0)
    want = jcertify.certify_controller(jap.AutoPrecisionController(**kw), rounds=2,
                                       resolution=24, batch=2)
    got = tcertify.certify_controller(tap_.AutoPrecisionController(**kw), rounds=2,
                                      resolution=24, batch=2, cfg=tcfg, model=net, x=x)
    _same_report(got, want)
    assert {g: s["fmt"] for g, s in got["controller"]["sites"].items()} == \
        {g: s["fmt"] for g, s in want["controller"]["sites"].items()}
    assert got["controller"]["version"] == want["controller"]["version"] >= 1


def test_certify_cli_and_theory_rows(tmp_path):
    out = tmp_path / "certify.json"
    rc = tcertify.main(["--policies", "mixed_fno_bf16", "--auto", "--resolution", "16",
                        "--batch", "1", "--device", "cpu", "--out", str(out)])
    import json

    reports = json.loads(out.read_text())["reports"]
    assert rc == 0 and [r["policy"] for r in reports] == ["mixed_fno_bf16", "full+auto1"]
    assert tcertify.DEFAULT_OUT.parent.name == "build"
    rows, jrows = tcertify.theory_rows(m_values=(6, 10)), jcertify.theory_rows(m_values=(6, 10))
    for r, j in zip(rows, jrows, strict=True):
        for k in ("disc_measured", "disc_upper", "disc_lower"):
            assert r[k] == pytest.approx(j[k], rel=1e-9)
        for fmt, p in r["prec"].items():
            assert p["upper"] == j["prec"][fmt]["upper"]
            assert p["measured"] == pytest.approx(j["prec"][fmt]["measured"], rel=1e-3,
                                                  abs=1e-9)


def test_train_darcy_auto_precision_runs_on_cpu():
    from repro_torch.examples import train_darcy

    out = train_darcy.main(["--steps", "12", "--n", "16", "--device", "cpu",
                            "--auto-precision"])
    # interval 5, patience 2: the second update, after step 9, demotes
    assert [h["policy"] for h in out["history"]] == ["full+auto0"] * 10 + ["full+auto1"] * 2
    assert out["decisions"] == {f"fno/layer{i}/spectral": "bfloat16" for i in range(3)}


def test_schedule_auto_builds_the_controller_over_its_base():
    _, net, _, tloss, batch = _tiny_problem(n_layers=1)
    tr = Trainer(tloss, net, TrainerConfig(
        total_steps=2, schedule=PrecisionSchedule.auto("full", grid_points=256)), device="cpu")
    tr.run(lambda _s: batch)
    assert tr.controller.base.name == "full" and tr.controller.config.grid_points == 256
    assert [h["policy"] for h in tr.history] == ["full+auto0"] * 2


def test_adamw_unaffected_by_collection():
    """A step under telemetry updates the parameters exactly as one without."""
    _, net, _, tloss, batch = _tiny_problem(n_layers=1)
    out = []
    for telemetry in (False, True):
        tr = Trainer(tloss, net, TrainerConfig(total_steps=2, telemetry=telemetry,
                                               optimizer=AdamW(lr=1e-3)), device="cpu")
        tr.run(lambda _s: batch)
        out.append({k: p.detach().clone() for k, p in tr.params.items()})
    assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])


# -- the numerics events and the report header (repro_torch.obs) -------------------------------
@pytest.fixture
def traced():
    """Both packages' trace rings on and empty, their registries cleared."""
    import repro.obs as jobs
    from repro_torch import obs as tobs

    sides = (tobs, jobs)
    for o in sides:
        o.trace.clear()
        o.registry().clear()
        o.trace.enable()
    yield sides
    for o in sides:
        o.trace.disable()
        o.trace.clear()
        o.registry().clear()
    ops._register_obs()
    import repro.kernels.ops as jops

    jops._register_obs()


def _decision_events(obs):
    return [(r["name"], {k: v for k, v in r["attrs"].items()})
            for r in obs.trace.snapshot() if r["name"].startswith("numerics/")]


@pytest.mark.parametrize("script", ["budget_bf16_at_128", "budget_fp16_at_421",
                                    "promote_on_streak_with_cooldown",
                                    "two_layers_fp16_scaling"])
def test_decisions_emit_the_reference_numerics_events(traced, script):
    """A forced demotion emits the reference's ``autoprec_demote`` event
    with the same ε budget, amax and format ε; overflow streaks and
    promotions theirs; the counters agree."""
    tobs, jobs = traced
    kw, steps = SCRIPTS[script]
    tctl = tap_.AutoPrecisionController(base="full", **kw)
    jctl = jap.AutoPrecisionController(base="full", **kw)
    for i, (sites, grid) in enumerate(steps):
        tctl.update({s: _windows(tap_.SiteWindow, **v) for s, v in sites.items()},
                    grid_points=grid, step=i)
        jctl.update({s: _windows(jap.SiteWindow, **v) for s, v in sites.items()},
                    grid_points=grid, step=i)
    got, want = _decision_events(tobs), _decision_events(jobs)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert "numerics/autoprec_demote" in [n for n, _ in got]
    for (_, g), (_, w) in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k, v in g.items():
            assert v == (pytest.approx(w[k], rel=1e-12) if isinstance(v, float) else w[k])
    demote = next(a for n, a in got if n == "numerics/autoprec_demote")
    assert demote["eps_budget"] > 0 and demote["fmt_eps"] == FORMAT_EPS[demote["to_fmt"]]
    assert tobs.registry().snapshot()["counters"] == jobs.registry().snapshot()["counters"]


def test_certify_report_begins_with_the_result_header(tmp_path):
    import json

    from repro_torch.obs import result_header

    out = tmp_path / "r.json"
    tcertify.write_report([{"policy": "x", "all_within": True}], out, device="cpu")
    doc = json.loads(out.read_text())
    assert list(doc) == ["meta", "reports"]
    want = result_header(device="cpu")
    assert set(doc["meta"]) == set(want)
    for k in ("schema_version", "device", "torch_version", "cuda_version", "git_sha", "env"):
        assert doc["meta"][k] == want[k]
    assert doc["reports"] == [{"policy": "x", "all_within": True}]
    assert out.read_text().lstrip().startswith('{\n  "meta"')
