"""The port's LM serving slice against ``repro.serve`` on the CPU: the
sampler, ``LMEngine`` and ``examples/serve_lm``.

* The sampler: ``apply_top_k`` / ``apply_top_p`` masks bit-equal to the
  reference's on seeded logits with ties; the reference's sampler tests;
  ``sample_token``'s frequencies against softmax(logits / T) on a
  4-token vocabulary; ``request_key`` replaying a draw.
* ``LMEngine``: every LM scenario of ``tests/test_serve_engine.py``
  (capacity at submit, FCFS/SPF order, the MoE default chunk, chunk 1 ==
  4 == 8 at smollm and mamba2, MLA chunk agreement, the hymba ring wrap,
  interleaved batching equal to a straight-line greedy ``lm_forward``,
  batched admission, seeded sampling), run on the port's own weights;
  then the port's greedy generations and per-step logits against the
  reference ``LMEngine``'s on the same bridged weights and prompts under
  ``full``; telemetry, stats, spans and the refusals (``mesh=``, an
  encoder-decoder config, weights on another device).
* The example with ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serve as jserve
import repro.serve.sampler as jsampler
from repro.configs import get_config as jget_config
from repro.models.lm import init_lm as jinit_lm
import repro_torch.obs as tobs
from repro_torch.configs import get_config
from repro_torch.examples import serve_lm
from repro_torch.models.lm import init_lm, lm_forward, lm_params_from_jax
from repro_torch.precision import get_policy
from repro_torch.serve import (
    GREEDY,
    LMEngine,
    Request,
    SamplingParams,
    Scheduler,
    ServeEngine,
    apply_top_k,
    apply_top_p,
    request_key,
    sample_token,
)

jax.config.update("jax_platform_name", "cpu")


def _params(arch, seed=0, **replace):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    return cfg, init_lm(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _engine(params, cfg, **kw):
    return LMEngine(params, cfg, device="cpu", **kw)


def _forward_greedy(params, cfg, prompt, n_new):
    """Straight-line ``lm_forward`` greedy decode: the serving ground truth."""
    toks = list(prompt)
    out = []
    with torch.no_grad():
        for _ in range(n_new):
            logits, _ = lm_forward(params, torch.tensor([toks]), cfg)
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            toks.append(nxt)
    return out


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 64).astype(np.float32)
    x[:, 5] = x[:, 9] = x[:, 20] = x.max(axis=1) + 0.5   # a three-way tie at the top
    x[:, 30:34] = 0.25                                    # ties in the middle
    x[0, :] = 1.0                                         # an all-tied row
    return x


# -- sampler ----------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 5, 17, 64, 100])
def test_top_k_masks_bit_equal_to_reference(k):
    for row in _rows(6, k):
        got = apply_top_k(torch.from_numpy(row), k).numpy()
        want = np.asarray(jsampler.apply_top_k(jnp.asarray(row), k))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [1e-6, 0.3, 0.5, 0.9, 0.95, 0.999])
def test_top_p_masks_bit_equal_to_reference(p):
    for row in _rows(6, 100 + int(p * 1000)):
        for t in (0.5, 1.0, 2.0):
            got = apply_top_p(torch.from_numpy(row / np.float32(t)), p).numpy()
            want = np.asarray(jsampler.apply_top_p(jnp.asarray(row / np.float32(t)), p))
            np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
            np.testing.assert_array_equal(got, want)
    # a batch of rows filters each row on its own
    rows = torch.from_numpy(_rows(4, 7))
    batched = apply_top_p(rows, p)
    for i in range(4):
        assert torch.equal(batched[i], apply_top_p(rows[i], p))


def test_greedy_is_argmax():
    logits = torch.tensor([0.1, 2.0, -1.0, 1.9])
    assert sample_token(logits) == 1
    assert sample_token(logits, SamplingParams(temperature=0.5, top_k=1), request_key(0, 0, 0)) == 1
    assert sample_token(np.array([0.0, 3.0, 3.0])) == 1   # the first of a tie, as np.argmax


def test_top_p_degenerates_to_greedy():
    logits = torch.tensor([0.0, 5.0, 1.0, 2.0])
    assert sample_token(logits, SamplingParams(temperature=1.0, top_p=1e-6),
                        request_key(3, 0, 0)) == 1


def test_top_k_restricts_support():
    logits = torch.tensor([5.0, 4.9, -10.0, -10.0])
    p = SamplingParams(temperature=2.0, top_k=2)
    toks = {sample_token(logits, p, request_key(i, 0, 0)) for i in range(20)}
    assert toks <= {0, 1}


def test_invalid_params_rejected():
    with pytest.raises(ValueError):
        SamplingParams(top_p=0.0)
    with pytest.raises(ValueError):
        SamplingParams(top_k=-1)
    with pytest.raises(ValueError):
        sample_token(torch.zeros(4), SamplingParams(temperature=1.0))
    assert GREEDY == SamplingParams()


def test_sample_token_frequencies_follow_softmax():
    """4000 draws from independent request keys against softmax(logits / T)
    on a 4-token vocabulary, each within 4.5 standard errors; top-k and
    top-p renormalise over what they keep."""
    logits = torch.tensor([1.0, 0.2, -0.5, 1.5])
    n = 4000

    def freqs(params):
        draws = [sample_token(logits, params, request_key(9, uid, 0)) for uid in range(n)]
        return np.bincount(draws, minlength=4) / n

    def check(got, p):
        se = np.sqrt(p * (1 - p) / n)
        assert np.all(np.abs(got - p) <= 4.5 * se + 1e-12), (got, p)

    for temp in (0.8, 1.0):
        check(freqs(SamplingParams(temperature=temp)),
              torch.softmax(logits / temp, 0).numpy())
    p = torch.softmax(logits[[0, 3]] / 0.8, 0).numpy()
    check(freqs(SamplingParams(temperature=0.8, top_k=2)), np.array([p[0], 0, 0, p[1]]))
    # top_p = 0.6 at T = 1: token 3 (0.46) then token 0 (0.28) reach it
    p = torch.softmax(logits[[0, 3]], 0).numpy()
    check(freqs(SamplingParams(temperature=1.0, top_p=0.6)), np.array([p[0], 0, 0, p[1]]))
    # a key replays its draw
    sp = SamplingParams(temperature=1.0)
    assert all(sample_token(logits, sp, request_key(5, u, 3))
               == sample_token(logits, sp, request_key(5, u, 3)) for u in range(50))


# -- LMEngine: the reference's scenarios -------------------------------------------------------
def test_oversized_request_fails_at_submit():
    cfg, params = _params("smollm-360m")
    engine = _engine(params, cfg, n_slots=2, max_len=16)
    bad = Request(uid=0, prompt=[1] * 14, max_new_tokens=4)
    assert not engine.submit(bad)
    assert bad.status == "failed"
    assert "max_len" in bad.error


def test_run_until_done_returns_failed_fast():
    cfg, params = _params("smollm-360m")
    engine = _engine(params, cfg, n_slots=1, max_len=16)
    reqs = [Request(uid=0, prompt=[1] * 20, max_new_tokens=4),
            Request(uid=1, prompt=[1, 2], max_new_tokens=2)]
    done, ticks = engine.run_until_done(reqs, max_ticks=500)
    by_uid = {r.uid: r for r in done}
    assert by_uid[0].status == "failed"
    assert by_uid[1].status == "done"
    assert ticks < 20
    s = engine.stats()
    assert s["failed"] == 1 and s["queue"]["rejected"] == 1


def test_scheduler_orders_fcfs_and_spf():
    sched = Scheduler("spf", cost=lambda r: len(r.prompt))
    a, b, c = (Request(uid=0, prompt=[1] * 8), Request(uid=1, prompt=[1] * 2),
               Request(uid=2, prompt=[1] * 2))
    for r in (a, b, c):
        sched.submit(r, tick=0)
    assert [r.uid for r in sched.take(2, tick=3)] == [1, 2]
    assert sched.stats()["wait_ticks_total"] == 6
    assert sched.take(5)[0].uid == 0
    sched = Scheduler("fcfs", cost=lambda r: len(r.prompt))
    a, b = Request(uid=0, prompt=[1] * 8), Request(uid=1, prompt=[1])
    sched.submit(a), sched.submit(b)
    assert [r.uid for r in sched.take(2)] == [0, 1]
    # identity, not value equality
    x, y = Request(uid=3, prompt=[1]), Request(uid=3, prompt=[1])
    sched.submit(x), sched.submit(y)
    assert sched.take(1) == [x] and sched.take(1) == [y]


def test_moe_archs_default_to_token_by_token_prefill():
    cfg, params = _params("smollm-360m")
    assert _engine(params, cfg, max_len=16).prefill_chunk == 8
    mcfg, mparams = _params("granite-moe-3b-a800m")
    assert _engine(mparams, mcfg, max_len=16).prefill_chunk == 1
    assert _engine(mparams, mcfg, max_len=16, prefill_chunk=4).prefill_chunk == 4
    with pytest.raises(ValueError):
        _engine(params, cfg, max_len=16, prefill_chunk=0)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_chunk_sizes_agree(arch):
    cfg, params = _params(arch)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7], [1] * 12]
    outs, ticks = {}, {}
    for chunk in (1, 4, 8):
        engine = _engine(params, cfg, n_slots=2, max_len=32, prefill_chunk=chunk)
        done, t = engine.run_until_done([Request(uid=i, prompt=list(p), max_new_tokens=3)
                                         for i, p in enumerate(prompts)])
        outs[chunk] = {r.uid: r.generated for r in done}
        ticks[chunk] = t
    assert outs[1] == outs[4] == outs[8]
    assert ticks[8] < ticks[1]


def test_chunk_agrees_for_mla():
    cfg, params = _params("deepseek-v2-lite-16b", seed=3, moe_experts=0, moe_shared=0, d_ff=32)
    outs = {}
    for chunk in (1, 4):
        engine = _engine(params, cfg, n_slots=2, max_len=32, prefill_chunk=chunk)
        done, _ = engine.run_until_done([Request(uid=i, prompt=[5, 3, 8, 2, 9, 1][: 3 + i],
                                                 max_new_tokens=3) for i in range(3)])
        outs[chunk] = {r.uid: r.generated for r in done}
    assert outs[1] == outs[4]


def test_chunk_agrees_for_swa_ring_wrap():
    cfg, params = _params("hymba-1.5b")
    assert cfg.attn_window > 0
    prompt = [int(t) for t in np.random.RandomState(0).randint(1, cfg.vocab, cfg.attn_window + 8)]
    outs = {}
    for chunk in (1, 16):
        engine = _engine(params, cfg, n_slots=1, max_len=cfg.attn_window + 16,
                         prefill_chunk=chunk)
        done, _ = engine.run_until_done([Request(uid=0, prompt=list(prompt), max_new_tokens=3)])
        outs[chunk] = done[0].generated
    assert outs[1] == outs[16]


@pytest.mark.parametrize("scheduler", ["fcfs", "spf"])
def test_interleaved_batching_matches_forward(scheduler):
    cfg, params = _params("smollm-360m", seed=11)
    rng = np.random.RandomState(2)
    reqs = [Request(uid=i, prompt=[int(t) for t in rng.randint(1, cfg.vocab, 2 + 3 * (i % 3))],
                    max_new_tokens=2 + (i % 3)) for i in range(5)]
    ref = {r.uid: _forward_greedy(params, cfg, r.prompt, r.max_new_tokens) for r in reqs}
    engine = _engine(params, cfg, n_slots=2, max_len=32, scheduler=scheduler, prefill_chunk=4)
    done, _ = engine.run_until_done([dataclasses.replace(r) for r in reqs])
    assert len(done) == len(reqs)
    for r in done:
        assert r.generated == ref[r.uid], f"uid {r.uid} ({scheduler})"


def test_multi_admission_single_tick_matches_forward():
    cfg, params = _params("smollm-360m")
    prompts = [[3, 1, 4], [1, 5, 9, 2, 6], [5, 3, 5], [8, 9, 7, 9], [3, 2, 3, 8, 4, 6]]
    lens = [4, 2, 3, 2, 4]
    engine = _engine(params, cfg, n_slots=3, max_len=32, prefill_chunk=4)
    done, _ = engine.run_until_done([Request(uid=u, prompt=p, max_new_tokens=n)
                                     for u, (p, n) in enumerate(zip(prompts, lens, strict=True))])
    assert all(r.status == "done" for r in done)
    for r in done:
        assert r.generated == _forward_greedy(params, cfg, prompts[r.uid], lens[r.uid]), r.uid


def test_admission_does_not_disturb_running_slots():
    cfg, params = _params("smollm-360m")
    engine = _engine(params, cfg, n_slots=2, max_len=32, prefill_chunk=4)
    a = Request(uid=0, prompt=[3, 1, 4, 1, 5], max_new_tokens=6)
    b = Request(uid=1, prompt=[9, 2, 6], max_new_tokens=3)
    engine.submit(a)
    for _ in range(3):
        engine.tick()
    engine.submit(b)
    engine.drain()
    assert a.generated == _forward_greedy(params, cfg, a.prompt, 6)
    assert b.generated == _forward_greedy(params, cfg, b.prompt, 3)


def test_engine_sampling_deterministic_under_fixed_seed():
    cfg, params = _params("smollm-360m")
    sampling = SamplingParams(temperature=0.8, top_k=32, top_p=0.95)

    def run(extra_greedy, seed=123):
        engine = _engine(params, cfg, n_slots=2, max_len=32, seed=seed)
        reqs = [Request(uid=7, prompt=[4, 2, 9], max_new_tokens=5, sampling=sampling)]
        if extra_greedy:
            reqs.append(Request(uid=1, prompt=[1] * 6, max_new_tokens=4))
        done, _ = engine.run_until_done(reqs)
        return [r.generated for r in done if r.uid == 7][0]

    a, b, c = run(False), run(False), run(True)
    assert a == b == c
    assert run(False, seed=124) != a


# -- LMEngine against the reference engine -------------------------------------------------------
@pytest.mark.parametrize("arch,chunk", [("smollm-360m", 4), ("mamba2-370m", 8),
                                        ("hymba-1.5b", 8), ("deepseek-v2-lite-16b", None)])
def test_greedy_generations_equal_reference_engine(arch, chunk):
    jcfg = jget_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jp = jinit_lm(jax.random.PRNGKey(4), jcfg)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, n)] for n in (3, 9, 5, 14)]
    kw = dict(n_slots=2, max_len=48, prefill_chunk=chunk, record_logits=True)
    jeng = jserve.LMEngine(jp, jcfg, **kw)
    teng = _engine(tp, cfg, **kw)
    jdone, jticks = jeng.run_until_done([jserve.Request(uid=i, prompt=p, max_new_tokens=5)
                                         for i, p in enumerate(prompts)])
    tdone, tticks = teng.run_until_done([Request(uid=i, prompt=p, max_new_tokens=5)
                                         for i, p in enumerate(prompts)])
    assert tticks == jticks
    assert {r.uid: r.generated for r in tdone} == {r.uid: r.generated for r in jdone}
    for uid in range(len(prompts)):
        got, want = teng.logits_for(uid), jeng.logits_for(uid)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want, strict=True):
            assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
    ts, js = teng.stats(), jeng.stats()
    for key in ("ticks", "completed", "failed", "prefill_chunk", "prefill_ticks",
                "decode_ticks", "prompt_tokens", "tokens_generated", "slot_occupancy"):
        assert ts[key] == js[key], key
    assert ts["queue"] == js["queue"]


def _span_tree(records):
    return [(r["kind"], r["name"], r.get("parent"), r.get("depth"),
             {k: v for k, v in (r.get("attrs") or {}).items()})
            for r in records if r["kind"] in ("span", "b", "e", "event")]


def test_spans_telemetry_and_stats_as_the_reference():
    """The same spans (``serve/prefill`` and ``serve/decode`` inside
    ``serve/tick``), prefill-complete events and request tracks as the
    reference engine's, the telemetry counters, a ``nonfinite_logits``
    event for a poisoned row, and the stats in the obs registry."""
    jcfg = jget_config("smollm-360m", smoke=True)
    cfg = get_config("smollm-360m", smoke=True)
    jp = jinit_lm(jax.random.PRNGKey(8), jcfg)
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    prompts = [[3, 1, 4, 1, 5, 9], [2, 6], [5, 3, 5, 8, 9, 7, 9, 3, 2]]

    def run(request, obs, engine):
        obs.trace.clear()
        obs.trace.enable()
        try:
            engine.run_until_done([request(uid=i, prompt=p, max_new_tokens=3)
                                   for i, p in enumerate(prompts)])
            return obs.trace.snapshot()
        finally:
            obs.trace.disable()
            obs.trace.clear()

    teng = _engine(tp, cfg, n_slots=2, max_len=32, prefill_chunk=4, telemetry=True)
    jeng = jserve.LMEngine(jp, jcfg, n_slots=2, max_len=32, prefill_chunk=4, telemetry=True)
    got = run(Request, tobs, teng)
    want = run(jserve.Request, jobs, jeng)
    assert _span_tree(got) == _span_tree(want)
    names = {r["name"] for r in got}
    assert {"serve/tick", "serve/prefill", "serve/decode", "serve/prefill_complete"} <= names
    s, js = teng.stats(), jeng.stats()
    assert s["numerics"]["rows_observed"] == js["numerics"]["rows_observed"]
    assert s["numerics"]["logits_nonfinite"] == 0
    assert abs(s["numerics"]["logits_amax"] - js["numerics"]["logits_amax"]) <= \
        1e-5 * js["numerics"]["logits_amax"]
    snap = tobs.registry().snapshot()
    assert snap["gauges"]["repro_serve_lm_prompt_tokens"] == s["prompt_tokens"] == 17
    assert snap["gauges"]["repro_serve_lm_tokens_generated"] == 9
    # a poisoned embedding row gives non-finite logits: counted, and one event a tick
    key = 'repro_numerics_events_total{kind="nonfinite_logits"}'
    before = tobs.registry().snapshot()["counters"].get(key, 0.0)
    with torch.no_grad():
        tp.embed[7] = float("nan")
    bad = _engine(tp, cfg, n_slots=1, max_len=16, telemetry=True)
    bad.run_until_done([Request(uid=0, prompt=[7], max_new_tokens=2)])
    assert bad.stats()["numerics"]["logits_nonfinite"] == 2 * cfg.vocab
    assert tobs.registry().snapshot()["counters"][key] == before + 2


def test_refusals_and_alias():
    cfg, params = _params("smollm-360m")
    with pytest.raises(ValueError, match="named DeviceMesh"):
        _engine(params, cfg, mesh=object())
    wcfg = get_config("whisper-large-v3", smoke=True)
    with pytest.raises(ValueError, match="encoder-decoder"):
        _engine(params, wcfg)
    with pytest.raises(ValueError, match="live on"):
        LMEngine(params, cfg, device="meta")
    assert ServeEngine is LMEngine
    # a half policy keeps its KV cache at the serve/kv_cache site's dtype
    eng = _engine(params, cfg, max_len=16, policy=get_policy("amp_bf16"))
    assert eng.cache["k"].dtype == torch.bfloat16 and eng.cache["kv_pos"].dtype == torch.int32
    done, _ = eng.run_until_done([Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2)])
    assert len(done[0].generated) == 2


def test_example_runs_on_the_cpu(capsys):
    stats = serve_lm.main(["--device", "cpu", "--requests", "3", "--temperature", "0.7",
                           "--top-k", "20"])
    assert stats["completed"] == 3 and stats["device"] == "cpu"
    assert "served 3 requests" in capsys.readouterr().out
    stats = serve_lm.main(["--device", "cpu", "--arch", "mamba2-370m", "--requests", "2"])
    assert stats["completed"] == 2
    with pytest.raises(SystemExit, match="enc-dec"):
        serve_lm.main(["--device", "cpu", "--arch", "whisper-large-v3"])


def test_static_analysis_sees_the_lm_sites_and_counters():
    """The analyzer's sites pass reads the LM's site literals and finds
    none orphaned; its obs-coverage pass accepts ``LMEngine``'s counters
    (the engine publishes them through the obs registry)."""
    import os

    from repro_torch.analyze import obscov, sites

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    lits = {p for _, _, p in sites.scan_site_literals(src)}
    assert {"lm/dense", "lm/router", "lm/proj_out", "lm/ssd/spectral/contract",
            "serve/kv_cache", "serve/sampler"} <= lits
    assert sites.orphan_site_findings(src) == []
    assert [f for f in obscov.obs_coverage_pass(src) if "serve/engine.py" in f.where] == []
