"""The port's autotuner (``repro_torch.tune``) against ``repro.tune`` on
the CPU, in one process.

* ``bytes_moved`` equals the reference's at every smoke and default key,
  and ``make_operands`` gives the reference's arrays value for value at
  every smoke key and every default key but the 421² one (90 M elements a
  tensor), where its shapes and dtypes are held to the reference's
  (``jax.eval_shape``; the other keys show the values are drawn alike).
* ``oracle.check``'s ``budget_min`` and verdict match the reference's
  (its kernels in interpret mode) at the smoke keys, and ``perturb=2`` is
  rejected on both.
* Every robustness case of ``tests/test_tune.py::TestCacheRobustness``,
  each run on both packages with the same outcome; a reference state read
  by the port is stale, and a port state read by the reference is stale.
* The ``tune --smoke → validate → validate --perturb 2 → report`` cycle
  on the CPU; the search space (legal tiles, the families with no launch
  tile, the heuristics' tiles legal); an oversized or illegal entry is
  never served; a seeded entry changes the resolved tiles
  (``tile_resolution_stats``) and reaches the autograd Functions; the
  trainer and the engine activate a state.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.spectral_contract as jsc
import repro.tune.cache as jcache
import repro.tune.measure as jmeasure
import repro.tune.oracle as joracle
import repro.tune.space as jspace
from repro.core import get_policy as jget_policy
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels import spectral_contract as sc
from repro_torch.kernels.build import digest
from repro_torch.precision import FULL, get_policy
from repro_torch.tune import cache as cache_mod
from repro_torch.tune import measure, oracle, space
from repro_torch.tune.__main__ import DEFAULT_KEYS, DEFAULT_STATE, SMOKE_KEYS
from repro_torch.tune.__main__ import main as tune_main

jax.config.update("jax_platform_name", "cpu")

ALL_KEYS = SMOKE_KEYS + DEFAULT_KEYS
BIG = ("spectral_fused", (8, 64, 64, 421, 421, 32, 32), "bfloat16")


@pytest.fixture(autouse=True)
def _pristine_calibration(monkeypatch):
    """No test leaks activation state or the env var into another."""
    monkeypatch.delenv(cache_mod.ENV_VAR, raising=False)
    for c in (cache_mod, jcache):
        c.activate(None)
    ops.reset_tile_resolution_stats()
    yield
    for c in (cache_mod, jcache):
        c.activate(None)


def _key_id(key):
    return f"{key[0]}-{'x'.join(map(str, key[1]))}-{key[2]}"


# -- the traffic model and the operands ------------------------------------------------
@pytest.mark.parametrize("key", ALL_KEYS, ids=_key_id)
def test_bytes_moved_matches_the_reference(key):
    assert measure.bytes_moved(*key) == jmeasure.bytes_moved(*key)
    if key[0] == "spectral_fused":
        assert measure.bytes_moved("spectral_staged", *key[1:]) == \
            jmeasure.bytes_moved("spectral_staged", *key[1:])


@pytest.mark.parametrize("key", ALL_KEYS, ids=_key_id)
def test_make_operands_match_the_reference(key):
    if key == BIG:
        # 90 M elements a tensor: the reference's shapes and dtypes only
        # (``eval_shape`` draws nothing), against the port's layout; the
        # values are drawn by the code the other keys hold value for value
        want = jax.eval_shape(lambda: jmeasure.make_operands(*key, seed=3))
        B, I, O, spatial, modes = space.fused_axes(key[1])
        Mh = int(np.prod(sc.fused_rows(spatial, modes)))
        assert [tuple(w.shape) for w in want] == [(B, I, *spatial), (I, O, Mh), (I, O, Mh)]
        assert [str(w.dtype) for w in want] == ["float32"] * 3
        return
    got = measure.make_operands(*key, seed=3)
    want = jmeasure.make_operands(*key, seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


# -- the oracle ------------------------------------------------------------------------
#: the tiles each smoke key is checked at, on both packages
SMOKE_TILES = {"dense": 8, "dense-fused": 8, "cp": 8, "lshared": 2, "spectral_fused": 2}


@pytest.mark.parametrize("perturb", [0.0, 2.0])
@pytest.mark.parametrize("key", SMOKE_KEYS, ids=_key_id)
def test_oracle_matches_the_reference(key, perturb):
    family, shape, dtype = key
    b = SMOKE_TILES[family]
    got = oracle.check(space.Candidate(family, shape, dtype, b, b), device="cpu",
                       perturb=perturb)
    want = joracle.check(jspace.Candidate(family, shape, dtype, b, b), interpret=True,
                         perturb=perturb)
    assert got["passed"] == want["passed"] == (perturb == 0.0)
    assert got["budget_min"] == pytest.approx(want["budget_min"], rel=1e-12)
    if perturb:
        assert got["worst_excess"] > 0 and got["max_err"] > got["budget_min"]


def test_oracle_reference_matches_at_f32_and_3d():
    """The composed fused oracle in f32 mode and on 3 axes, and the stage
    counts and constants, against the reference's."""
    assert oracle.STAGES == joracle.STAGES and oracle.ATOL == joracle.ATOL
    assert oracle.FUSED_F32_C == joracle.FUSED_F32_C
    for shape, dtype in (((2, 3, 2, 12, 9, 3, 3), "float32"),
                         ((1, 2, 3, 8, 6, 7, 2, 3, 3), "bfloat16")):
        ops_ = measure.make_operands("spectral_fused", shape, dtype, seed=1)
        cand = space.Candidate("spectral_fused", shape, dtype, 1, 1)
        ref, mag = oracle.reference(cand, oracle._numpy(ops_))
        jref, jmag = joracle.reference(jspace.Candidate("spectral_fused", shape, dtype, 1, 1),
                                       jmeasure.make_operands("spectral_fused", shape, dtype,
                                                              seed=1))
        np.testing.assert_allclose(ref, jref, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(mag, jmag, rtol=1e-12, atol=1e-12)
        assert oracle.check(cand, device="cpu")["passed"]


# -- the cache's robustness, case by case on both packages ----------------------------
PACKAGES = {
    "port": (cache_mod, lambda: sc.KERNEL_VERSION, lambda: "cpu"),
    "ref": (jcache, lambda: jsc.KERNEL_VERSION, lambda: jax.default_backend()),
}


def _entry(pkg, family, shape, dtype="bfloat16", block_fwd=8, block_bwd=8, **kw):
    _mod, version, backend = PACKAGES[pkg]
    ent = {"family": family, "shape": list(shape), "dtype": dtype, "backend": backend(),
           "kernel_version": version(), "block_fwd": block_fwd, "block_bwd": block_bwd,
           "validated": True}
    ent.update(kw)
    return ent


def _state_with(pkg, tmp_path, *entries, name="state.json"):
    mod, _version, backend = PACKAGES[pkg]
    state = mod.CalibrationCache(entries={}, backend=backend())
    for ent in entries:
        state.put(ent)
    return mod.save(state, tmp_path / name)


def _lookup(pkg, state, *key):
    if pkg == "port":
        return state.lookup(*key, backend="cpu")
    return state.lookup(*key)


def _case(case, pkg, tmp_path, monkeypatch):
    """One robustness case on one package; returns what it observed."""
    mod, version, _backend = PACKAGES[pkg]
    key = ("dense", (2, 8, 8, 40), "bfloat16")
    if case == "corrupt":
        bad = tmp_path / "corrupt.json"
        bad.write_text("{ this is not json")
        with pytest.raises(mod.CalibrationError):
            mod.load(bad)
        with pytest.warns(UserWarning, match="calibration"):
            assert mod.safe_load(bad) is None
        with pytest.warns(UserWarning):
            mod.activate(str(bad))
        return mod.active_cache()
    if case == "missing_and_bad_structure":
        with pytest.raises(mod.CalibrationError, match="not found"):
            mod.load(tmp_path / "absent.json")
        noent = tmp_path / "noentries.json"
        noent.write_text(json.dumps({"format_version": 1}))
        with pytest.raises(mod.CalibrationError, match="entries"):
            mod.load(noent)
        return "raised"
    if case == "format_version":
        p = _state_with(pkg, tmp_path, _entry(pkg, *key[:2]))
        raw = json.loads(open(p).read())
        raw["format_version"] = 999
        open(p, "w").write(json.dumps(raw))
        with pytest.raises(mod.CalibrationError, match="format_version"):
            mod.load(p)
        return "raised"
    if case == "kernel_version_bump":
        p = _state_with(pkg, tmp_path, _entry(pkg, *key[:2], kernel_version=version() - 1))
        state = mod.load(p)
        return _lookup(pkg, state, *key), state.counters
    if case == "backend_mismatch":
        p = _state_with(pkg, tmp_path, _entry(pkg, *key[:2], backend="not-a-backend"))
        state = mod.load(p)
        return _lookup(pkg, state, *key), state.counters
    if case.startswith("defect_"):
        defect = {"defect_unvalidated": {"validated": False}, "defect_not_pow2": {"block_fwd": 7},
                  "defect_wrong_type": {"block_bwd": "8"},
                  "defect_unknown_family": {"family": "nope"}}[case]
        p = _state_with(pkg, tmp_path, {**_entry(pkg, *key[:2]), **defect})
        state = mod.load(p)
        return _lookup(pkg, state, *key), state.counters
    if case == "counters":
        state = mod.load(_state_with(pkg, tmp_path, _entry(pkg, *key[:2])))
        hit = _lookup(pkg, state, *key) is not None
        miss = _lookup(pkg, state, "dense", (9, 9, 9, 9), "bfloat16")
        return hit, miss, state.counters
    if case == "atomic_roundtrip":
        p = _state_with(pkg, tmp_path, _entry(pkg, "cp", (2, 8, 8, 4, 40)))
        state = mod.load(p)
        return (state.path == str(p),
                _lookup(pkg, state, "cp", (2, 8, 8, 4, 40), "bfloat16") is not None,
                sorted(f.name for f in tmp_path.iterdir()))
    if case == "env_mtime":
        p = _state_with(pkg, tmp_path, _entry(pkg, *key[:2], block_fwd=8))
        monkeypatch.setenv(mod.ENV_VAR, str(p))
        first = _lookup(pkg, mod.active_cache(), *key)["block_fwd"]
        _state_with(pkg, tmp_path, _entry(pkg, *key[:2], block_fwd=16))
        os.utime(p, ns=(0, 0))  # force a visible mtime change
        second = _lookup(pkg, mod.active_cache(), *key)["block_fwd"]
        monkeypatch.delenv(mod.ENV_VAR)
        return first, second
    if case == "explicit_beats_env":
        p_env = _state_with(pkg, tmp_path, _entry(pkg, *key[:2]), name="env.json")
        monkeypatch.setenv(mod.ENV_VAR, str(p_env))
        explicit = mod.CalibrationCache(entries={}, backend="x")
        mod.activate(explicit)
        first = mod.active_cache() is explicit
        mod.activate(None)
        second = mod.active_cache().path == str(p_env)
        monkeypatch.delenv(mod.ENV_VAR)
        return first, second
    raise AssertionError(case)


CASES = ["corrupt", "missing_and_bad_structure", "format_version", "kernel_version_bump",
         "backend_mismatch", "defect_unvalidated", "defect_not_pow2", "defect_wrong_type",
         "defect_unknown_family", "counters", "atomic_roundtrip", "env_mtime",
         "explicit_beats_env"]


@pytest.mark.parametrize("case", CASES)
def test_cache_robustness_matches_the_reference(case, tmp_path, monkeypatch):
    for pkg in PACKAGES:
        (tmp_path / pkg).mkdir()
    got = _case(case, "port", tmp_path / "port", monkeypatch)
    want = _case(case, "ref", tmp_path / "ref", monkeypatch)
    assert got == want
    expect = {"kernel_version_bump": (None, {"hits": 0, "misses": 0, "stale": 1}),
              "backend_mismatch": (None, {"hits": 0, "misses": 0, "stale": 1}),
              "counters": (True, None, {"hits": 1, "misses": 1, "stale": 0}),
              "atomic_roundtrip": (True, True, ["state.json"]), "env_mtime": (8, 16),
              "explicit_beats_env": (True, True), "corrupt": None}
    if case in expect:
        assert got == expect[case]
    if case.startswith("defect_"):
        assert got[0] is None


def test_bad_file_never_crashes_resolution(tmp_path, monkeypatch):
    """A corrupt state behind the env var costs a warning, and the wrappers
    still run on the heuristics."""
    bad = tmp_path / "bad.json"
    bad.write_text("]]garbage")
    monkeypatch.setenv(cache_mod.ENV_VAR, str(bad))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 4, 12, 9).astype(np.float32))
    w = [torch.from_numpy(rng.randn(2, 4, 4, 3, 3).astype(np.float32)) for _ in range(2)]
    with pytest.warns(UserWarning, match="calibration"):
        y = ops.spectral_conv_fused(x, *w, (3, 3), policy=get_policy("mixed_fno_bf16"))
    assert y.shape == (2, 4, 12, 9)
    stats = ops.tile_resolution_stats()
    assert stats["calibration_state"] is None and stats["sources"]["heuristic"] == 1


@pytest.mark.parametrize("reader", ["port", "ref"])
def test_each_package_reads_the_others_state_as_stale(reader, tmp_path):
    """Another kernel version (the port's is a digest of its sources) makes
    every entry of the other package's state stale, on either side."""
    writer = "ref" if reader == "port" else "port"
    key = ("spectral_fused", (2, 4, 4, 12, 9, 3, 3), "bfloat16")
    ent = _entry(writer, *key[:2], block_fwd=2, block_bwd=2)
    ent["backend"] = PACKAGES[reader][2]()  # the same device: only the version differs
    p = _state_with(writer, tmp_path, ent)
    state = PACKAGES[reader][0].load(p)
    assert _lookup(reader, state, *key) is None
    assert state.counters == {"hits": 0, "misses": 0, "stale": 1}


def test_kernel_version_is_the_tuned_sources_digest():
    assert sc.KERNEL_VERSION == int(digest(sc.SOURCE_FUSED, sc.SOURCE_LS)[:12], 16)
    assert sc.KERNEL_VERSION != jsc.KERNEL_VERSION
    # the build key of one source is the same digest over that source alone
    assert digest(sc.SOURCE_FUSED) != digest(sc.SOURCE_FUSED, sc.SOURCE_LS)


# -- the search space --------------------------------------------------------------------
@pytest.mark.parametrize("key", ALL_KEYS, ids=_key_id)
def test_candidates_are_legal_and_cover_the_heuristic(key):
    family, shape, dtype = key
    cands = space.candidates(family, shape, dtype)
    if family not in space.TUNED:
        assert cands == [] and space.legal_blocks(family, shape, dtype, "fwd") == []
        return
    assert cands
    for c in cands:
        for block, direction in ((c.block_fwd, "fwd"), (c.block_bwd, "bwd")):
            assert block & (block - 1) == 0 and block >= 1
            if family == "spectral_fused":
                assert block <= min(8, shape[0])
                assert space.tile_scratch_bytes(family, shape, block, direction) <= \
                    space.DEFAULT_BUDGET
            else:
                assert block <= sc.ls_splits_max(shape[0], shape[4])
    hf, hb = ops.heuristic_blocks(family, shape, dtype)
    if family == "spectral_fused":
        assert (hf, hb) in {(c.block_fwd, c.block_bwd) for c in cands}
    assert space.candidates(family, shape, dtype, limit=3) == cands[:3]


def test_fused_axes_refuses_a_malformed_shape():
    with pytest.raises(ValueError, match="spectral_fused"):
        space.fused_axes((2, 4, 4, 12, 9, 3))


def test_measure_times_the_plain_versions_on_the_cpu():
    for family, b in (("spectral_fused", 2), ("lshared", 2)):
        key = dict(SMOKE_KEYS_BY_FAMILY)[family]
        perf = measure.measure(space.Candidate(family, key, "bfloat16", b, b), device="cpu",
                               iters=2)
        assert perf["wall_us"] > 0 and perf["interpret"] is True
        assert perf["bytes_moved"] == measure.bytes_moved(family, key, "bfloat16")
        assert perf["gbps"] >= 0 and 0 <= perf["roofline_fraction"] <= 1


SMOKE_KEYS_BY_FAMILY = [(f, s) for f, s, _d in SMOKE_KEYS]


# -- the CLI cycle -------------------------------------------------------------------------
def test_tune_smoke_cycle(tmp_path, capsys):
    """tune --smoke admits oracle-validated entries for the tuned families
    and lists the others as having no launch tile; validate re-checks
    them, --perturb 2 rejects every one, report renders."""
    p = tmp_path / "cal.json"
    assert tune_main(["tune", "--smoke", "--device", "cpu", "--state", str(p),
                      "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("no launch tile") == 3 and out.count("ADMIT") == 2
    state = cache_mod.load(p)
    assert sorted(e["family"] for e in state.entries.values()) == ["lshared", "spectral_fused"]
    for ent in state.entries.values():
        assert ent["validated"] and ent["interpret"] and ent["backend"] == "cpu"
        assert ent["kernel_version"] == sc.KERNEL_VERSION
        assert ent["gbps"] >= 0 and 0 <= ent["roofline_fraction"] <= 1
        assert ent["heuristic_wall_us"] > 0
        assert (ent["block_fwd"], ent["block_bwd"]) in {
            (c.block_fwd, c.block_bwd) for c in space.candidates(
                ent["family"], ent["shape"], ent["dtype"], limit=4)}
    assert tune_main(["validate", "--state", str(p), "--device", "cpu"]) == 0
    assert tune_main(["validate", "--state", str(p), "--device", "cpu",
                      "--perturb", "2"]) == 1
    out = capsys.readouterr().out
    assert out.count("REJECT") == 2 and "2 checked, 2 rejected" in out
    assert tune_main(["report", "--state", str(p), "--device", "cpu"]) == 0
    rows = [ln for ln in capsys.readouterr().out.splitlines() if "|" in ln]
    assert len(rows) == 2 and all(ln.endswith(" ok") for ln in rows)
    assert tune_main(["validate", "--state", str(tmp_path / "nope.json"),
                      "--device", "cpu"]) == 2


def test_validate_skips_stale_and_prunes_corrupt(tmp_path):
    key = (2, 4, 4, 12, 9, 3, 3)
    p = _state_with("port", tmp_path,
                    _entry("port", "spectral_fused", key, block_fwd=2, block_bwd=2),
                    _entry("port", "lshared", (2, 8, 8, 12, 9), kernel_version=1,
                           block_fwd=2, block_bwd=2),
                    _entry("port", "lshared", (2, 8, 8, 12, 11), block_fwd=3))
    assert tune_main(["validate", "--state", str(p), "--device", "cpu", "--prune"]) == 1
    state = cache_mod.load(p)
    assert cache_mod.entry_key("lshared", (2, 8, 8, 12, 11), "bfloat16") not in state.entries
    assert cache_mod.entry_key("lshared", (2, 8, 8, 12, 9), "bfloat16") in state.entries
    assert tune_main(["validate", "--state", str(p), "--device", "cpu"]) == 0


def test_default_state_lives_under_build():
    """``build/`` at the repository root, beside ``src/``; the directory
    itself need not exist yet (a fresh checkout has none)."""
    build = os.path.dirname(DEFAULT_STATE)
    assert os.path.basename(build) == "build"
    assert os.path.isdir(os.path.join(os.path.dirname(build), "src", "repro_torch"))


# -- tile resolution -----------------------------------------------------------------------
class _Recorder:
    """Stands in for an autograd Function: records the tiles it is handed
    and runs the real one."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def apply(self, *args):
        self.calls.append(tuple(args[-2:]))
        return self.fn.apply(*args)


def _fused_call(monkeypatch, policy="mixed_fno_bf16", B=2):
    rec = _Recorder(sc.FusedSpectral)
    monkeypatch.setattr(ops, "FusedSpectral", rec)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(B, 4, 12, 9).astype(np.float32))
    w = [torch.from_numpy(rng.randn(2, 4, 4, 3, 3).astype(np.float32)) for _ in range(2)]
    y = ops.spectral_conv_fused(x, *w, (3, 3), policy=get_policy(policy))
    return rec.calls, y


def _ls_call(monkeypatch):
    rec = _Recorder(sc.LSharedContract)
    monkeypatch.setattr(ops, "LSharedContract", rec)
    rng = np.random.RandomState(2)
    x = torch.complex(*(torch.from_numpy(rng.randn(2, 8, 12, 9).astype(np.float32))
                        for _ in range(2)))
    w = torch.complex(*(torch.from_numpy(rng.randn(8, 8, 12).astype(np.float32))
                        for _ in range(2)))
    y = ops.spectral_contract_lshared(x, w, policy=get_policy("mixed_fno_bf16").at(
        "sfno/layer0/spectral/contract"))
    return rec.calls, y


def test_seeded_entry_changes_the_resolved_tiles(tmp_path, monkeypatch):
    heur, y_heur = _fused_call(monkeypatch)
    ls_heur, z_heur = _ls_call(monkeypatch)
    assert heur == [(2, 2)] and ls_heur == [(2, 2)]
    assert ops.tile_resolution_stats()["sources"] == {"heuristic": 2, "calibrated": 0}
    p = _state_with("port", tmp_path,
                    _entry("port", "spectral_fused", (2, 4, 4, 12, 9, 3, 3),
                           block_fwd=1, block_bwd=2),
                    _entry("port", "lshared", (2, 8, 8, 12, 9), block_fwd=1, block_bwd=1))
    cache_mod.activate(str(p))
    cal, y_cal = _fused_call(monkeypatch)
    ls_cal, z_cal = _ls_call(monkeypatch)
    assert cal == [(1, 2)] and ls_cal == [(1, 1)]
    stats = ops.tile_resolution_stats()
    assert stats["sources"] == {"heuristic": 2, "calibrated": 2}
    assert stats["calibration_state"] == str(p)
    assert stats["cache"] == {"hits": 2, "misses": 0, "stale": 0}
    # the CPU runs the plain versions: tiles change nothing there
    assert torch.equal(y_cal, y_heur) and torch.equal(z_cal, z_heur)
    # another dtype is another key: a miss, the heuristic
    f32, _ = _fused_call(monkeypatch, policy="full")
    assert f32 == [(2, 2)] and ops.tile_resolution_stats()["cache"]["misses"] == 1


@pytest.mark.parametrize("entry", ["fused_16", "fused_over_batch", "ls_over_outputs",
                                   "ls_not_pow2"])
def test_oversized_entry_never_served(entry, tmp_path, monkeypatch):
    """A structurally valid, validated entry whose tile is illegal at the
    running shape is never handed to a launch: the heuristic takes its
    place (the reference's ``test_oversized_entry_never_served``)."""
    ents = {"fused_16": _entry("port", "spectral_fused", (2, 4, 4, 12, 9, 3, 3),
                               block_fwd=16, block_bwd=2),
            "fused_over_batch": _entry("port", "spectral_fused", (2, 4, 4, 12, 9, 3, 3),
                                       block_fwd=2, block_bwd=4),
            "ls_over_outputs": _entry("port", "lshared", (2, 8, 8, 12, 9), block_fwd=4,
                                      block_bwd=1),
            "ls_not_pow2": _entry("port", "lshared", (2, 8, 8, 12, 9), block_fwd=3,
                                  block_bwd=1)}
    cache_mod.activate(str(_state_with("port", tmp_path, ents[entry])))
    calls, _ = (_ls_call if entry.startswith("ls") else _fused_call)(monkeypatch)
    assert calls == [(2, 2)]
    assert ops.tile_resolution_stats()["sources"] == {"heuristic": 1, "calibrated": 0}


def test_trainer_and_engine_activate_a_state(tmp_path):
    from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE
    from repro_torch.models import init_fno
    from repro_torch.serve import OperatorEngine
    from repro_torch.train import Trainer, TrainerConfig

    p = str(_state_with("port", tmp_path, _entry("port", "lshared", (2, 8, 8, 12, 9))))
    net = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE, device="cpu")
    Trainer(lambda m, *_: m.lift1.w.sum(), net, TrainerConfig(calibration_state=p),
            device="cpu")
    assert cache_mod.active_cache().path == p
    cache_mod.activate(None)
    stats = OperatorEngine(net, calibration_state=p, device="cpu").stats()
    assert stats["tiles"]["calibration_state"] == p
    assert set(stats["tiles"]["sources"]) == {"heuristic", "calibrated"}
    # the reference's engine reports the same fields
    assert set(stats["tiles"]) == set(jops.tile_resolution_stats())


def test_full_policy_keys_take_f32(monkeypatch):
    """The fused key carries the contract site's dtype (f32 under full), as
    the reference's resolution does."""
    seen = []
    real = ops._resolve_blocks

    def spy(family, shape, dtype, heuristic, device=None):
        seen.append((family, shape, str(dtype)))
        return real(family, shape, dtype, heuristic, device)

    monkeypatch.setattr(ops, "_resolve_blocks", spy)
    _fused_call(monkeypatch, policy="full")
    _fused_call(monkeypatch, policy="mixed_fno_fp16")
    assert seen == [("spectral_fused", (2, 4, 4, 12, 9, 3, 3), "torch.float32"),
                    ("spectral_fused", (2, 4, 4, 12, 9, 3, 3), "torch.float16")]
    assert jget_policy("full").at("x/contract").spectral_dtype is None
    assert FULL.at("x/contract").spectral_dtype is None


@pytest.mark.parametrize("family", ["spectral_fused", "lshared"])
def test_timed_step_is_the_functions_forward_and_backward(family):
    """The timed unit runs the Function's own forward and backward without
    the autograd engine: its gradients are autograd's, bit for bit."""
    key = dict(SMOKE_KEYS_BY_FAMILY)[family]
    cand = space.Candidate(family, key, "bfloat16", 1, 2)
    args = measure.operand_sets(cand, "cpu")[0]
    got = measure.build_step(cand)(*args)
    n = len(got)
    leaves = [t.clone().requires_grad_() for t in args[:n]]
    out = measure.forward(cand, leaves)
    want = torch.autograd.grad(out if isinstance(out, tuple) else (out,), leaves, args[n:])
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
