"""The port's observability layer (``repro_torch.obs``) against
``repro.obs`` on the CPU, in one process.

* The same sequence of trace, metrics and numerics calls, made on both
  packages, gives the same records (timestamps, durations and thread ids
  aside), the same registry snapshot, the same Prometheus text, the same
  Chrome trace and the same JSONL framing; ``summary``, ``chrome`` and
  ``prom`` print and write the same (the summary's first line names torch
  and CUDA where the reference's names JAX).
* Chrome-trace validation catches the reference's seeded defects, with
  the reference's messages.
* The result header carries the device, the torch and CUDA versions, the
  git sha, the time and the ``REPRO_*`` environment.
* Wiring: the trainer's and ``OperatorEngine``'s spans nest as the
  reference's do, and the metric names both publish at smoke size are
  equal, but for two by-decision differences (the port's trainer has no
  ``recompiles`` counter and its engine no ``use_pallas`` flag).  The
  reference's golden also covers paged serving, which the port lacks, so
  the names are compared with the reference run in this process, not with
  ``tests/golden/obs_metrics_keys.json``.
* The kernel-call counters count once per call (the reference counts once
  per traced shape), and ``train_darcy --obs-trace`` writes a run log, a
  valid Chrome trace and a Prometheus snapshot.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
import repro.models.fno as jfno
import repro.obs as jobs
import repro.tune.cache as jcache
from repro.obs.__main__ import main as jobs_main
from repro.serve import FieldRequest as JFieldRequest
from repro.serve import OperatorEngine as JOperatorEngine
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import relative_l2 as jrelative_l2
from repro_torch import obs as tobs
from repro_torch.kernels import ops as tops
from repro_torch.kernels.spectral_contract import KERNEL_VERSION
from repro_torch.models import FNOConfig, fno_apply, params_from_jax
from repro_torch.obs.__main__ import main as tobs_main
from repro_torch.serve import FieldRequest, OperatorEngine
from repro_torch.train import Trainer, TrainerConfig, relative_l2
from repro_torch.tune import cache as tcache

jax.config.update("jax_platform_name", "cpu")

SIDES = {"port": (tobs, tops, tcache), "ref": (jobs, jops, jcache)}
#: series the reference publishes and the port, by decision, does not
BY_DECISION = {"repro_train_recompiles", "repro_serve_operator_use_pallas"}


def _pristine():
    for obs, ops, cache in SIDES.values():
        obs.trace.disable()
        obs.trace.clear()
        obs.registry().clear()
        ops._register_obs()
        cache.activate(None)
        ops.reset_tile_resolution_stats()


@pytest.fixture(autouse=True)
def _obs_clean(monkeypatch):
    """Each test starts from disabled traces, empty registries (the kernels'
    external re-registered) and no calibration state, on both sides."""
    monkeypatch.delenv(tcache.ENV_VAR, raising=False)
    _pristine()
    yield
    _pristine()


def _timeless(records):
    """Records without their clock and thread: what two runs can share."""
    return [{k: v for k, v in r.items() if k not in ("ts_ns", "dur_ns", "tid")}
            for r in records]


def _script(obs, capacity=None):
    """One fixed sequence of trace, metrics and numerics calls."""
    obs.trace.enable(**({} if capacity is None else {"capacity": capacity}))
    with obs.trace.span("outer", step=1):
        with obs.trace.span("inner", k=2):
            obs.trace.event("mark", category="c", n=1)
        obs.numerics_event("oracle_reject", site="s", key="k")
    obs.trace.begin("request", 7, category="request", engine="operator")
    obs.trace.end("request", 7, category="request", ticks=3)
    for kind in obs.KINDS:
        obs.numerics_event(kind)
    obs.autoprec_decision("g", "float32", "bfloat16", eps_budget=1e-3, amax=2.0,
                          fmt_eps=2.0 ** -8, step=4)
    obs.autoprec_decision("g", "bfloat16", "float32", eps_budget=1e-3, amax=2.0)
    obs.loss_scale_event("loss_scale_halved", 16384.0, step=5)
    obs.tile_cache_event("miss", "spectral_fused", "spectral_fused|2x4x4|bfloat16")
    obs.oracle_reject("key|b2x2", max_err=0.5, budget_min=1e-3, worst_excess=0.4)
    reg = obs.registry()
    reg.counter("repro_t_total", kind="a").inc()
    reg.counter("repro_t_total", kind="a").inc(2)
    reg.gauge("repro_t_g").set(3.5)
    h = reg.histogram("repro_t_ms", edges=(1.0, 10.0))
    for v in (0.5, 5.0, 100.0):
        h.observe(v)
    reg.histogram("repro_t_wall_ms").observe(12.0)
    reg.publish("eng", {"ticks": 4, "memo": {"hits": 2}, "name": "skipped", "ok": True,
                        "none": None, "Buckets": {"16x16": 3}})
    for i in range(20):
        obs.trace.event(f"e{i}")
    return obs.trace.snapshot(), reg.snapshot()


@pytest.mark.parametrize("capacity", [None, 8, 31])
def test_records_snapshot_and_exports_match_the_reference(capacity):
    """Same calls, same records (clock aside), same registry snapshot, same
    Prometheus text and Chrome trace (clock aside), ring wrap included."""
    got, want = _script(tobs, capacity), _script(jobs, capacity)
    assert _timeless(got[0]) == _timeless(want[0])
    assert tobs.trace.dropped() == jobs.trace.dropped()
    assert got[1] == want[1]
    assert tobs.prometheus_text(got[1]) == jobs.prometheus_text(want[1])
    assert tobs.metric_names(got[1]) == jobs.metric_names(want[1])

    def chrome(doc):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in doc["traceEvents"]]

    tdoc, jdoc = tobs.chrome_trace(got[0]), jobs.chrome_trace(want[0])
    assert chrome(tdoc) == chrome(jdoc)
    assert tobs.validate_chrome_trace(tdoc) == jobs.validate_chrome_trace(jdoc) == []
    if capacity is None:
        spans = [r for r in got[0] if r["kind"] == "span"]
        assert [(s["name"], s["depth"], s.get("parent")) for s in spans] == \
            [("inner", 1, "outer"), ("outer", 0, None)]


def test_off_is_the_shared_noop_on_both():
    for obs in (tobs, jobs):
        s1, s2 = obs.trace.span("a"), obs.trace.span("b", k=1)
        assert s1 is s2
        with s1:
            obs.trace.event("x")
            obs.numerics_event("oracle_reject", key="k")
        assert obs.trace.snapshot() == []
    assert tobs.registry().snapshot()["counters"] == jobs.registry().snapshot()["counters"] \
        == {'repro_numerics_events_total{kind="oracle_reject"}': 1.0}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the reference's error type and message
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", ["bad_name", "no_subsystem", "label_cap", "edges",
                                  "unknown_kind", "external_reset", "reset"])
def test_registry_rules_match_the_reference(case):
    def run(obs):
        reg = obs.registry()
        if case == "bad_name":
            return _outcome(lambda: reg.counter("Bad-Name"))
        if case == "no_subsystem":
            return _outcome(lambda: reg.gauge("nope"))
        if case == "label_cap":
            for i in range(obs.MAX_LABEL_SETS):
                reg.counter("repro_t_total", k=str(i))
            return _outcome(lambda: reg.counter("repro_t_total", k="one-too-many"))
        if case == "edges":
            reg.histogram("repro_t_ms", edges=(1.0, 2.0))
            return _outcome(lambda: reg.histogram("repro_t_ms", edges=(1.0, 3.0)))
        if case == "unknown_kind":
            return _outcome(lambda: obs.numerics_event("not_a_kind"))
        if case == "external_reset":
            box = {"n": 5}
            reg.register_external("repro_t_ext", lambda: dict(box), lambda: box.update(n=0))
            before = reg.snapshot()["external"]["repro_t_ext"]
            reg.reset()
            return before, box
        reg.counter("repro_t_total").inc(9)
        reg.histogram("repro_t_ms").observe(3.0)
        reg.reset()
        return reg.snapshot()

    got, want = run(tobs), run(jobs)
    if case == "reset":
        # the kernels' external: the port's tile counters and the
        # reference's share their keys, zeroed by the reset
        assert got["external"]["repro_kernels_tiles"]["sources"] == \
            want["external"]["repro_kernels_tiles"]["sources"] == \
            {"heuristic": 0, "calibrated": 0}
        got = {k: v for k, v in got.items() if k != "external"}
        want = {k: v for k, v in want.items() if k != "external"}
    assert got == want


#: the reference's seeded defects, and more
DEFECTS = [
    [{"ph": "X", "name": "a", "ts": 0, "pid": 1, "tid": 1},
     {"ph": "b", "name": "r", "ts": 0, "pid": 1, "tid": 1, "id": "1", "cat": "c"},
     {"ph": "Z", "name": "?", "ts": 0, "pid": 1, "tid": 1}],
    [{"ph": "i", "ts": 0, "pid": 1, "tid": 1}, "not-an-event",
     {"ph": "e", "name": "r", "ts": "x", "pid": 1}],
    [{"ph": "b", "name": "r", "ts": 0, "pid": 1, "tid": 1, "cat": "c"},
     {"ph": "b", "name": "r", "ts": 0, "pid": 1, "tid": 1, "id": 2, "cat": "c"},
     {"ph": "b", "name": "r", "ts": 1, "pid": 1, "tid": 1, "id": 2, "cat": "c"},
     {"ph": "e", "name": "r", "ts": 2, "pid": 1, "tid": 1, "id": 2, "cat": "c"}],
    "not a trace",
]


@pytest.mark.parametrize("defect", range(len(DEFECTS)))
def test_chrome_validation_catches_the_seeded_defects(defect):
    events = DEFECTS[defect]
    doc = {"traceEvents": events} if isinstance(events, list) else events
    got, want = tobs.validate_chrome_trace(doc), jobs.validate_chrome_trace(doc)
    assert got == want and got
    if defect == 0:
        assert any("missing dur" in e for e in got)
        assert any("unmatched begin" in e for e in got)
        assert any("unknown ph" in e for e in got)


def test_result_header_fields():
    hdr, jhdr = tobs.result_header(extra_field=7), jobs.result_header(extra_field=7)
    assert hdr["schema_version"] == jhdr["schema_version"] == 1
    assert hdr["device"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert tobs.result_header(device="cpu")["device"] == "cpu"
    assert hdr["torch_version"] == torch.__version__
    assert hdr["cuda_version"] == torch.version.cuda
    assert "jax_version" not in hdr and "backend" not in hdr
    for k in ("git_sha", "env", "extra_field"):
        assert hdr[k] == jhdr[k]
    assert hdr["timestamp_utc"][:10] == jhdr["timestamp_utc"][:10]
    if hdr["device"] == "cpu":
        assert "device_name" not in hdr
    else:
        assert hdr["device_name"] == torch.cuda.get_device_name()


def test_write_result_is_atomic_and_keeps_prior_meta(tmp_path):
    path = str(tmp_path / "sub" / "r.json")
    tobs.write_result(path, {"x": 1, "meta": {"run": "a"}}, device="cpu")
    doc = json.load(open(path))
    assert doc["x"] == 1 and doc["meta"]["schema_version"] == 1
    assert doc["meta"]["run"] == "a" and doc["meta"]["device"] == "cpu"
    assert list(doc) == ["meta", "x"]  # sorted keys: the header comes first
    assert os.listdir(tmp_path / "sub") == ["r.json"]


def _run_files(tmp_path):
    """The same timeline and snapshot written as a run log by each package
    (each with its own header)."""
    recs, snap = _script(tobs)
    paths = {}
    for name, (obs, _ops, _cache) in SIDES.items():
        paths[name] = str(tmp_path / f"{name}.jsonl")
        obs.write_jsonl(paths[name], obs.run_records(recs, snapshot=snap, run="t"))
    return paths


def test_jsonl_framing_matches_the_reference(tmp_path):
    paths = _run_files(tmp_path)
    got, want = (tobs.read_jsonl(paths[k]) for k in ("port", "ref"))
    assert [r["kind"] for r in got] == [r["kind"] for r in want]
    assert got[0]["kind"] == "meta" and got[-1]["kind"] == "metrics"
    assert got[1:] == want[1:]
    assert got[0]["run"] == want[0]["run"] == "t"
    assert open(paths["port"]).read().endswith("\n")


@pytest.mark.parametrize("cmd", ["summary", "chrome", "prom"])
def test_cli_matches_the_reference(tmp_path, capsys, cmd):
    paths = _run_files(tmp_path)
    outs = {}
    for name, main in (("port", tobs_main), ("ref", jobs_main)):
        argv = [cmd, paths[name]] + ([] if cmd == "summary" else
                                     [str(tmp_path / f"{name}.{cmd}")])
        assert main(argv) == 0
        outs[name] = capsys.readouterr().out.splitlines()
    if cmd == "summary":
        head, jhead = outs["port"][0], outs["ref"][0]
        assert head.startswith("run: device=") and " torch=" in head and " cuda=" in head
        assert jhead.startswith("run: backend=") and " jax=" in jhead
        assert head.split(" sha=")[1][:12] == jhead.split(" sha=")[1][:12]
        assert outs["port"][1:] == outs["ref"][1:]
        assert any("numerics/autoprec_demote" in line for line in outs["port"])
    else:
        got = open(tmp_path / f"port.{cmd}").read()
        want = open(tmp_path / f"ref.{cmd}").read()
        assert got == want
        if cmd == "chrome":
            assert tobs.validate_chrome_trace(json.loads(got)) == []


def test_cli_refuses_an_empty_log(tmp_path):
    path = str(tmp_path / "empty.jsonl")
    tobs.write_jsonl(path, tobs.run_records([]))
    assert tobs_main(["summary", path]) == jobs_main(["summary", path]) == 1
    assert tobs_main(["prom", path, str(tmp_path / "x.prom")]) == 1


# -- wiring: the trainer and OperatorEngine ----------------------------------------------
_JCFG = jfno.FNOConfig(in_channels=1, out_channels=1, hidden_channels=8, lifting_channels=8,
                       projection_channels=8, n_layers=1, modes=(4, 4), use_pallas=True,
                       fuse_spectral=True)
_TCFG = FNOConfig(in_channels=1, out_channels=1, hidden_channels=8, lifting_channels=8,
                  projection_channels=8, n_layers=1, modes=(4, 4), fuse_spectral=True)
_FUSED_KEY = (2, 8, 8, 16, 16, 4, 4)


@pytest.fixture(scope="module")
def tiny():
    from repro_torch.models import init_fno

    tree = {}
    for k, p in init_fno(torch.Generator().manual_seed(0), _TCFG,
                         device="cpu").state_dict().items():
        group, leaf = k.split(".")
        tree.setdefault(group, {})[leaf] = p.numpy()
    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(2, 1, 16, 16).astype(np.float32),
             "t": (rng.randn(2, 1, 16, 16) * 0.1).astype(np.float32)}
    fields = [rng.randn(1, 16, 16).astype(np.float32) for _ in range(3)]
    return jax.tree_util.tree_map(jnp.asarray, tree), tree, batch, fields


def _state(side, tmp_path):
    """A calibration file of each package's own format with an entry for the
    fused layer's key (batch 2, the trainer's and the engine's width)."""
    _obs, _ops, cache = SIDES[side]
    if side == "port":
        version, backend = KERNEL_VERSION, "cpu"
    else:
        from repro.kernels.spectral_contract import KERNEL_VERSION as version

        backend = jax.default_backend()
    st = cache.CalibrationCache(entries={}, backend=backend)
    st.put({"family": "spectral_fused", "shape": list(_FUSED_KEY), "dtype": "float32",
            "backend": backend, "kernel_version": version, "block_fwd": 2, "block_bwd": 1,
            "validated": True})
    return cache.save(st, tmp_path / f"{side}_state.json")


def _run_side(side, tiny, tmp_path, steps=2):
    """A calibrated trainer in obs mode under a caller's span, then a
    calibrated engine and a telemetry engine (no state: the telemetry veto
    takes the staged path, whose dense tiles only the reference looks up),
    all with tracing on; returns the timeline and the registry snapshot."""
    jparams, tree, batch, fields = tiny
    obs, _ops, cache = SIDES[side]
    state = str(_state(side, tmp_path))
    if side == "port":
        net = params_from_jax(tree, _TCFG, device="cpu")
        tr = Trainer(lambda m, b, pol: relative_l2(fno_apply(m, b["x"], pol), b["t"]), net,
                     TrainerConfig(total_steps=steps, obs=True, calibration_state=state),
                     device="cpu")
        feed = batch
    else:
        tr = JTrainer(lambda p, b, pol: jrelative_l2(jfno.fno_apply(p, b["x"], _JCFG, pol),
                                                     b["t"]),
                      jparams, JTrainerConfig(total_steps=steps, obs=True,
                                              calibration_state=state))
        feed = {k: jnp.asarray(v) for k, v in batch.items()}
    with obs.trace.span("test/run"):
        tr.run(lambda _s: feed)
    engines = []
    for kw in ({"calibration_state": state, "memo_window": 2}, {"telemetry": True}):
        if "telemetry" in kw:
            cache.activate(None)
        if side == "port":
            eng = OperatorEngine(params_from_jax(tree, _TCFG, device="cpu"), max_batch=2,
                                 device="cpu", **kw)
            req = FieldRequest
        else:
            eng = JOperatorEngine(jparams, _JCFG, max_batch=2, use_pallas=True, **kw)
            req = JFieldRequest
        for i, x in enumerate(fields + fields[:1]):
            eng.submit(req(uid=10 * len(engines) + i, x=x))
        eng.drain()
        engines.append(eng.stats())
    return obs.trace.snapshot(), obs.registry().snapshot(), engines


@pytest.fixture(scope="module")
def wired(tiny, tmp_path_factory):
    _pristine()
    out = {side: _run_side(side, tiny, tmp_path_factory.mktemp(side)) for side in SIDES}
    _pristine()
    return out


def test_published_metric_names_match_the_reference(wired):
    got = set(tobs.metric_names(wired["port"][1]))
    want = set(jobs.metric_names(wired["ref"][1]))
    assert BY_DECISION <= want and not BY_DECISION & got
    assert got == want - BY_DECISION
    assert 'repro_kernels_calls_total{family="spectral_fused"}' in got
    assert 'repro_numerics_events_total{kind="tile_cache_hit"}' in got


def _span_tree(records):
    return [(r["kind"], r["name"], r.get("depth"), r.get("parent"), r.get("id"),
             {k: v for k, v in (r.get("attrs") or {}).items()})
            for r in records if r["kind"] in ("span", "b", "e")]


def test_spans_nest_as_the_reference(wired):
    """The same spans, async tracks and attributes in the same order and
    nesting: ``train/data`` and ``train/step`` under the caller's span,
    ``serve/operator/batch`` inside ``serve/tick``, one request track per
    accepted field, and the tile-cache hits on the timeline."""
    got, want = wired["port"][0], wired["ref"][0]
    assert _span_tree(got) == _span_tree(want)
    names = [r["name"] for r in got]
    assert names.count("train/step") == names.count("train/data") == 2
    steps = [r for r in got if r["name"] == "train/step"]
    assert all(s["parent"] == "test/run" and s["depth"] == 1 for s in steps)
    assert [s["attrs"] for s in steps] == [{"step": 0, "policy": "full"},
                                           {"step": 1, "policy": "full"}]
    batches = [r for r in got if r["name"] == "serve/operator/batch"]
    assert batches and all(b["parent"] == "serve/tick" for b in batches)
    begins = {r["id"] for r in got if r["kind"] == "b"}
    assert begins == {r["id"] for r in got if r["kind"] == "e"} == {0, 1, 2, 3, 10, 11, 12, 13}
    # the same events; the port looks its tiles up on every call, the
    # reference once per traced shape, so only the port's count is the calls'
    events = [r["name"] for r in got if r["kind"] == "event"]
    assert set(events) == {r["name"] for r in want if r["kind"] == "event"} == \
        {"numerics/tile_cache_hit"}
    calls = wired["port"][1]["counters"]['repro_kernels_calls_total{family="spectral_fused"}']
    assert events.count("numerics/tile_cache_hit") == calls == 4  # 2 steps, 2 batches
    assert tobs.validate_chrome_trace(tobs.chrome_trace(got)) == []


def test_trainer_and_engine_numbers_land_as_the_reference(wired):
    snap, jsnap = wired["port"][1], wired["ref"][1]
    assert snap["counters"]["repro_train_steps_total"] == \
        jsnap["counters"]["repro_train_steps_total"] == 2.0
    assert snap["histograms"]["repro_train_step_wall_ms"]["count"] == 2
    assert snap["gauges"]["repro_train_step"] == jsnap["gauges"]["repro_train_step"] == 2.0
    calibrated, telemetry = wired["port"][2]
    jcalibrated, _ = wired["ref"][2]
    # per call (2 computed micro-batches) against per traced shape
    assert calibrated["tiles"]["cache"] == {"hits": 2, "misses": 0, "stale": 0}
    assert jcalibrated["tiles"]["cache"] == {"hits": 1, "misses": 0, "stale": 0}
    assert set(calibrated["tiles"]) == set(jcalibrated["tiles"])
    assert telemetry["tiles"]["calibration_state"] is None
    for k in ("completed", "batches", "fields_served"):
        assert calibrated[k] == jcalibrated[k]


def test_obs_off_records_nothing(tiny):
    _jparams, tree, batch, _ = tiny
    net = params_from_jax(tree, _TCFG, device="cpu")
    tr = Trainer(lambda m, b, pol: relative_l2(fno_apply(m, b["x"], pol), b["t"]), net,
                 TrainerConfig(total_steps=1), device="cpu")
    tr.run(lambda _s: batch)
    assert tobs.trace.snapshot() == []
    assert "repro_train_steps_total" not in tobs.registry().snapshot()["counters"]


def test_kernel_counters_count_every_call():
    """The port compiles nothing: each call of a wrapper counts, where the
    reference's jitted callers count once per traced shape."""
    from repro_torch.precision import FULL, get_policy

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 2, 6, 8).astype(np.float32))
    w = [torch.from_numpy(rng.randn(2, 2, 2, 2, 3).astype(np.float32)) for _ in range(2)]
    for _ in range(3):
        tops.spectral_conv_fused(x, *w, (2, 3), policy=FULL)
    z = torch.complex(*(torch.from_numpy(rng.randn(2, 3, 4, 5).astype(np.float32))
                        for _ in range(2)))
    wz = [torch.from_numpy(rng.randn(3, 4, 4, 5).astype(np.float32)) for _ in range(2)]
    site = get_policy("mixed_fno_bf16").at("fno/layer0/spectral/contract")
    tops.spectral_contract(z, *wz, policy=site)
    tops.spectral_contract(z, *wz, policy=FULL)
    q = torch.randn(1, 2, 8, 16)
    tops.flash_attention(q, q, q)
    tops.rmsnorm(torch.randn(4, 16), torch.ones(16))
    snap = tobs.registry().snapshot()
    c = snap["counters"]
    assert c['repro_kernels_calls_total{family="spectral_fused"}'] == 3.0
    assert c['repro_kernels_calls_total{family="dense-fused"}'] == 1.0
    assert c['repro_kernels_calls_total{family="dense"}'] == 1.0
    assert c['repro_kernels_calls_total{family="flash_attention"}'] == 1.0
    assert c['repro_kernels_calls_total{family="rmsnorm"}'] == 1.0
    from repro.tune.measure import bytes_moved as jbytes_moved

    assert snap["gauges"]['repro_kernels_bytes_moved{family="spectral_fused"}'] == \
        jbytes_moved("spectral_fused", (1, 2, 2, 6, 8, 2, 3), "float32")
    assert tops.tile_resolution_stats()["sources"] == {"heuristic": 3, "calibrated": 0}


def test_train_darcy_obs_trace_writes_the_run(tmp_path):
    from repro_torch.examples import train_darcy

    out = str(tmp_path / "run.jsonl")
    train_darcy.main(["--device", "cpu", "--steps", "3", "--n", "16", "--obs-trace", out])
    recs = tobs.read_jsonl(out)
    assert recs[0]["kind"] == "meta" and recs[0]["device"] == "cpu"
    assert recs[0]["run"] == "train_darcy" and recs[-1]["kind"] == "metrics"
    assert [r["name"] for r in recs if r.get("kind") == "span"].count("train/step") == 3
    assert recs[-1]["snapshot"]["counters"]["repro_train_steps_total"] == 3.0
    doc = json.load(open(tmp_path / "run.trace.json"))
    assert tobs.validate_chrome_trace(doc) == []
    assert "# TYPE repro_train_steps_total counter" in open(tmp_path / "run.prom").read()
    assert tobs_main(["summary", out]) == 0


def test_engine_publishes_into_the_registry_and_resets(tiny):
    _jparams, tree, _batch, fields = tiny
    eng = OperatorEngine(params_from_jax(tree, dataclasses.replace(_TCFG, fuse_spectral=None),
                                         device="cpu"), max_batch=2, device="cpu")
    for i, x in enumerate(fields):
        eng.submit(FieldRequest(uid=i, x=x))
    eng.drain()
    stats = eng.stats()
    g = tobs.registry().snapshot()["gauges"]
    assert g["repro_serve_operator_completed"] == stats["completed"] == 3
    assert g["repro_serve_operator_tiles_sources_heuristic"] == 0  # staged on the CPU
    eng.reset_counters()
    assert eng.stats()["completed"] == 0
    assert tobs.registry().snapshot()["gauges"]["repro_serve_operator_completed"] == 0
