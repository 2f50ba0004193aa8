"""The port's paged LM serving slice against ``repro.serve.paged`` on the
CPU: ``BlockPool``, ``PrefixIndex``, the paged LM steps, ``PagedLMEngine``,
``AsyncServeFrontend``, ``examples/serve_lm --paged`` and
``launch.serve_smoke``.

* Pool and index: seeded random operation sequences through the port's
  and the reference's ``BlockPool`` / ``PrefixIndex`` give the same return
  values, refcounts, ``stats()`` and raised errors; the reference's own
  pool and index cases run on the port.
* ``PagedLMEngine`` against the port's dense ``LMEngine`` (the reference's
  acceptance bar): the same tokens and bit-equal per-step logits for
  smollm, mamba2 (the dense fallback), hymba (SWA ring) and deepseek (MLA,
  MoE stripped) x fcfs/spf x ``full``/``mixed_fno_bf16`` at chunk 4, and
  at chunk 1 and 8; the shared-prefix, prefix-off, copy-on-write and
  eviction scenarios; true exhaustion; block 0 (the null block) untouched
  after each.
* The port against the reference on bridged weights under ``full``: the
  paged steps on a hand-made block table, and the engines tick by tick —
  the host block table after every tick, greedy tokens, per-step logits
  within 1e-5 relative L2, ``stats()["paged"]`` and the paged trace
  events.
* The frontend, ``content_key``, the example and the smoke launcher.
"""
import asyncio
import dataclasses
import json
import random
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.obs as jobs
import repro.serve as jserve
import repro.serve.paged.pool as jpool
import repro.serve.paged.prefix as jprefix
import repro_torch.obs as tobs
from repro.configs import get_config as jget_config
from repro.models.lm import init_lm as jinit_lm
from repro.models.lm import init_paged_cache as jinit_paged_cache
from repro.models.lm import lm_paged_decode_step as jpaged_decode
from repro.models.lm import lm_paged_prefill_chunk as jpaged_chunk
from repro_torch.autoprec import TraceCollector, collecting
from repro_torch.configs import get_config
from repro_torch.examples import serve_lm
from repro_torch.launch import serve_smoke
from repro_torch.models.lm import (
    init_cache,
    init_lm,
    init_paged_cache,
    lm_paged_decode_step,
    lm_paged_prefill_chunk,
    lm_params_from_jax,
)
from repro_torch.models.lm.model import _PagedViews
from repro_torch.precision import get_policy
from repro_torch.serve import (
    NULL_BLOCK,
    AsyncServeFrontend,
    BlockPool,
    LMEngine,
    PagedLMEngine,
    PrefixIndex,
    Request,
    content_key,
)
from repro_torch.serve import operator as toperator

jax.config.update("jax_platform_name", "cpu")

ARCHS = [
    "smollm-360m",           # pure attention (GQA)
    "mamba2-370m",           # pure SSD: the engine runs the dense path
    "hymba-1.5b",            # hybrid attn+SSD with an SWA ring cache
    "deepseek-v2-lite-16b",  # MLA latent cache (MoE stripped)
]
SHARED = [7, 3, 9, 2, 8, 1, 4, 6, 5, 0, 2, 9, 1, 3, 4, 8]


def _strip(cfg):
    # MoE expert-capacity routing depends on the batch composition; the
    # paged contract is pinned on the dense-equivalent archs
    if cfg.moe_experts:
        cfg = dataclasses.replace(cfg, moe_experts=0, moe_shared=0, d_ff=32)
    return cfg


_PARAMS, _DENSE, _BRIDGED = {}, {}, {}


def _params_for(arch):
    if arch not in _PARAMS:
        cfg = _strip(get_config(arch, smoke=True))
        _PARAMS[arch] = (cfg, init_lm(torch.Generator().manual_seed(0), cfg, device="cpu"))
    return _PARAMS[arch]


def _bridged(arch):
    """(reference cfg, reference params, port cfg, port params): the same
    weights in both packages."""
    if arch not in _BRIDGED:
        jcfg, cfg = _strip(jget_config(arch, smoke=True)), _strip(get_config(arch, smoke=True))
        jp = jinit_lm(jax.random.PRNGKey(4), jcfg)
        tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
        _BRIDGED[arch] = (jcfg, jp, cfg, tp)
    return _BRIDGED[arch]


def _dense(params, cfg, **kw):
    return LMEngine(params, cfg, device="cpu", **kw)


def _paged(params, cfg, **kw):
    return PagedLMEngine(params, cfg, device="cpu", **kw)


def _requests():
    return [Request(uid=u, prompt=[3, 1, 4, 1, 5, 9, 2, 6, 5, 3][: 4 + u % 6],
                    max_new_tokens=3 + u % 3) for u in range(5)]


def _dense_run(arch, policy_name, chunk):
    """The dense run, cached per (arch, policy, chunk): a request's logits
    do not depend on the admission order, so it serves both schedulers."""
    key = (arch, policy_name, chunk)
    if key not in _DENSE:
        cfg, params = _params_for(arch)
        eng = _dense(params, cfg, n_slots=2, max_len=32, policy=get_policy(policy_name),
                     prefill_chunk=chunk, record_logits=True)
        done, _ = eng.run_until_done(_requests())
        _DENSE[key] = ({r.uid: list(r.generated) for r in done},
                       {r.uid: eng.logits_for(r.uid) for r in done})
    return _DENSE[key]


def _same_logits(a, b, uids):
    for uid in uids:
        rows_a, rows_b = a.logits_for(uid), b.logits_for(uid)
        assert len(rows_a) == len(rows_b) > 0, uid
        for t, (x, y) in enumerate(zip(rows_a, rows_b, strict=True)):
            assert np.array_equal(x, y), (uid, t)


def _null_block_untouched(engine):
    """Block 0 keeps kv_pos -1 and zero rows in every layer."""
    c = engine.cache
    assert bool((c["kv_pos"][:, NULL_BLOCK] == -1).all())
    for k in ("k", "v", "c_kv", "k_rope"):
        if k in c:
            assert not bool(c[k][:, NULL_BLOCK].any()), k


# -- BlockPool and PrefixIndex against the reference ----------------------------------------
def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_pool_sequences_equal_reference(seed):
    """alloc / fork / release / cow, on live, dead, null and out-of-range
    ids: equal returns, errors, refcounts and stats after every op."""
    rng = random.Random(seed)
    n = rng.randint(2, 10)
    a, b = BlockPool(n, 4), jpool.BlockPool(n, 4)
    for _ in range(120):
        op = rng.choice(["alloc", "alloc", "fork", "release", "release", "cow"])
        live = [i for i in range(1, n) if a.refcount(i) > 0]
        blk = rng.choice(live) if live and rng.random() < 0.85 else rng.randint(-1, n)
        if op == "alloc":
            got, want = _outcome(a.alloc), _outcome(b.alloc)
        else:
            got, want = _outcome(getattr(a, op), blk), _outcome(getattr(b, op), blk)
        assert got == want, (op, blk)
        assert a._ref == b._ref and a._free == b._free and a.stats() == b.stats()
    for bad in (0, -1, n):
        assert _outcome(a.release, bad) == _outcome(b.release, bad)
    for args in ((1, 4), (4, 0)):
        with pytest.raises(ValueError) as got:
            BlockPool(*args)
        with pytest.raises(ValueError) as want:
            jpool.BlockPool(*args)
        assert str(got.value) == str(want.value)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_prefix_sequences_equal_reference(seed):
    """register / lookup / evict_one / evict_until over prompts from a
    two-token alphabet (so chains share prefixes): equal block lists,
    stats and pool state after every op."""
    rng = random.Random(seed)
    bs, n = 2, rng.randint(6, 16)
    pools = (BlockPool(n, bs), jpool.BlockPool(n, bs))
    idx = (PrefixIndex(pools[0]), jprefix.PrefixIndex(pools[1]))
    held = []   # references the caller owns (the same ids in both pools)
    for now in range(80):
        op = rng.choice(["register", "lookup", "lookup", "evict_one", "evict_until", "drop"])
        toks = [rng.randint(0, 1) for _ in range(rng.randint(0, 4 * bs))]
        if op == "register":
            blocks = [p.alloc() for p in pools for _ in range(len(toks) // bs)]
            blocks = blocks[: len(blocks) // 2]
            if any(x is None for x in blocks):
                break
            got = [i.register(toks, blocks, bs, now) for i in idx]
            held.extend(blocks)
        elif op == "lookup":
            cap = rng.randint(0, 4)
            got = [i.lookup(toks, bs, cap, now) for i in idx]
            held.extend(got[0])
        elif op == "evict_one":
            got = [i.evict_one() for i in idx]
        elif op == "evict_until":
            k = rng.randint(0, n)
            got = [i.evict_until(k) for i in idx]
        else:
            got = [None, None]
            if held:
                b = held.pop(rng.randrange(len(held)))
                got = [p.release(b) for p in pools]
        assert got[0] == got[1], op
        assert idx[0].stats() == idx[1].stats() and len(idx[0]) == len(idx[1])
        assert pools[0]._ref == pools[1]._ref and pools[0]._free == pools[1]._free
    assert PrefixIndex._chain([1, 2, 3, 4, 5], 2) == jprefix.PrefixIndex._chain([1, 2, 3, 4, 5], 2)


# -- the reference's pool and index cases, on the port ---------------------------------------
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**32 - 1))
def test_pool_random_workload_invariants(seed):
    """Under any interleaving of alloc/fork/release/cow the pool never
    leaks, never double-frees, and refcounts equal the outstanding owners."""
    rng = random.Random(seed)
    pool = BlockPool(num_blocks=12, block_size=4)
    owners = []
    for _ in range(200):
        op = rng.random()
        if op < 0.4:
            b = pool.alloc()
            if b is not None:
                assert b != NULL_BLOCK
                owners.append(b)
        elif op < 0.6 and owners:
            owners.append(pool.fork(rng.choice(owners)))
        elif op < 0.85 and owners:
            pool.release(owners.pop(rng.randrange(len(owners))))
        elif owners:
            j = rng.randrange(len(owners))
            b = owners[j]
            if pool.refcount(b) > 1 and pool.free_blocks == 0:
                with pytest.raises(RuntimeError):
                    pool.cow(b)
                continue
            dst, copy = pool.cow(b)
            owners[j] = dst
            assert (copy is None) == (dst == b)
        counts = Counter(owners)
        for b, k in counts.items():
            assert pool.refcount(b) == k
        assert pool.refcount(NULL_BLOCK) == 1
        assert pool.live_blocks == len(counts)
        assert pool.free_blocks == 12 - 1 - len(counts)
    for b in owners:
        pool.release(b)
    assert pool.live_blocks == 0


def test_pool_double_free_and_null_block():
    pool = BlockPool(num_blocks=4, block_size=4)
    b = pool.alloc()
    assert pool.release(b)
    with pytest.raises(ValueError, match="not allocated"):
        pool.release(b)
    pool = BlockPool(num_blocks=4, block_size=4)
    got = {pool.alloc() for _ in range(3)}
    assert NULL_BLOCK not in got
    assert pool.alloc() is None


def test_prefix_register_lookup_evict():
    pool = BlockPool(num_blocks=8, block_size=2)
    idx = PrefixIndex(pool)
    toks = [1, 2, 3, 4, 5, 6]
    blocks = [pool.alloc() for _ in range(3)]
    idx.register(toks, blocks, 2, now=0)
    assert all(pool.refcount(b) == 2 for b in blocks)
    hit = idx.lookup(toks, 2, max_blocks=3, now=1)
    assert hit == blocks
    for b in hit:
        pool.release(b)
    assert idx.lookup([9, 9, 9, 9], 2, max_blocks=2, now=2) == []
    assert idx.evict_one() and idx.evict_one() and idx.evict_one()
    assert not idx.evict_one()
    for b in blocks:
        pool.release(b)
    assert pool.live_blocks == 0


def test_content_key_equals_reference_and_is_the_operator_engines():
    rng = np.random.RandomState(3)
    for x in (rng.randn(2, 5, 7).astype(np.float32), rng.randn(3, 4),
              rng.randint(-50, 50, (4, 6)), torch.from_numpy(rng.randn(1, 8, 8).astype(np.float32))):
        assert content_key(x) == jprefix.content_key(np.asarray(x))
    assert toperator.content_key is content_key


# -- the paged steps against the reference on a hand-made block table --------------------------
@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b", "deepseek-v2-lite-16b"])
def test_paged_steps_match_reference(arch):
    """Two chunks then decode ticks through a scrambled block table whose
    unbacked entries read the null block, slot 1 inactive for a decode
    tick: logits within 1e-5 relative L2 of the reference's paged steps,
    the block arrays and kv_pos equal, block 0 untouched; the cache's
    layout, the views' layout and the width check as the reference's."""
    jcfg, jp, cfg, tp = _bridged(arch)
    B, W, bs, nb = 2, 16, 4, 11
    table = np.array([[3, 7, 6, 0], [9, 2, 5, 0]], np.int64)
    jc = jinit_paged_cache(jcfg, B, nb, bs, W)
    tc = init_paged_cache(cfg, B, nb, bs, W, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    rng = np.random.RandomState(9)
    jchunk = jax.jit(lambda p, c, bt, t, n: jpaged_chunk(p, c, bt, t, n, jcfg))
    jdecode = jax.jit(lambda p, c, bt, a, t: jpaged_decode(p, c, bt, a, t, jcfg))

    def check(jl, tl):
        np.testing.assert_array_equal(np.asarray(jc["step"]), tc["step"].numpy())
        for k in tc:
            if k == "kv_pos":
                np.testing.assert_array_equal(np.asarray(jc[k]), tc[k].numpy())
            elif k != "step":
                np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=2e-5, atol=2e-6)
        jl = np.asarray(jl)
        assert np.linalg.norm(tl.numpy() - jl) <= 1e-5 * np.linalg.norm(jl)

    for n_valid in ([4, 3], [2, 4]):
        toks = rng.randint(1, cfg.vocab, (B, 4))
        jl, jc = jchunk(jp, jc, jnp.asarray(table, jnp.int32), jnp.asarray(toks),
                        jnp.asarray(n_valid))
        tl, tc = lm_paged_prefill_chunk(tp, tc, torch.from_numpy(table), torch.from_numpy(toks),
                                        torch.tensor(n_valid), cfg)
        check(jl, tl)
    for active in ([True, True], [True, False], [True, True]):
        toks = rng.randint(1, cfg.vocab, (B,))
        jl, jc = jdecode(jp, jc, jnp.asarray(table, jnp.int32), jnp.asarray(active),
                         jnp.asarray(toks))
        tl, tc = lm_paged_decode_step(tp, tc, torch.from_numpy(table), torch.tensor(active),
                                      torch.from_numpy(toks), cfg)
        check(jl, tl)
    assert bool((tc["kv_pos"][:, 0] == -1).all())
    # each layer's view has the dense cache's layer layout, strides and dtype
    for pol in ("full", "amp_bf16"):
        dt = get_policy(pol).at("serve/paged/kv_blocks").compute_dtype
        assert dt == get_policy(pol).at("serve/kv_cache").compute_dtype
        dense = init_cache(cfg, B, W, dtype=dt, device="cpu")
        pv = _PagedViews(init_paged_cache(cfg, B, nb, bs, W, dtype=dt, device="cpu"),
                         torch.from_numpy(table))
        for k, v in pv.view(1).items():
            want = dense[k][1]
            assert (v.shape, v.stride(), v.dtype) == (want.shape, want.stride(), want.dtype), k
            assert v.is_contiguous()
    with pytest.raises(ValueError, match="block_size"):
        init_paged_cache(cfg, B, nb, 5, W, device="cpu")


# -- PagedLMEngine against the port's dense engine -------------------------------------------
def _check_vs_dense(arch, sched, policy_name, chunk):
    cfg, params = _params_for(arch)
    d_tokens, d_logits = _dense_run(arch, policy_name, chunk)
    paged = _paged(params, cfg, n_slots=2, max_len=32, policy=get_policy(policy_name),
                   scheduler=sched, prefill_chunk=chunk, record_logits=True, block_size=8)
    p_done, _ = paged.run_until_done(_requests())
    assert {r.uid: list(r.generated) for r in p_done} == d_tokens
    for uid, rows in d_logits.items():
        got = paged.logits_for(uid)
        assert len(got) == len(rows)
        for t, (a, b) in enumerate(zip(rows, got, strict=True)):
            assert np.array_equal(a, b), (uid, t)
    if paged._paged:
        _null_block_untouched(paged)
        assert paged.pool.live_blocks == len(paged.prefix or [])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sched", ["fcfs", "spf"])
@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_matches_dense_per_step_logits(arch, sched, policy_name):
    """The acceptance bar: the same tokens AND bit-equal per-step logits
    for every arch x scheduler x policy."""
    _check_vs_dense(arch, sched, policy_name, chunk=4)


@pytest.mark.parametrize("chunk", [1, 8])
def test_matches_dense_across_chunk_sizes(chunk):
    _check_vs_dense("smollm-360m", "fcfs", "full", chunk)


def test_ssd_fallback_width_check_and_mesh_refused():
    cfg, params = _params_for("mamba2-370m")
    eng = _paged(params, cfg, n_slots=2, max_len=32, block_size=8)
    assert eng.pool is None and "kv_pos" not in eng.cache
    assert eng.stats()["paged"] == {"active": False, "reason": "ssd arch has no KV rows"}
    cfg, params = _params_for("smollm-360m")
    with pytest.raises(ValueError, match="block_size"):
        _paged(params, cfg, n_slots=2, max_len=32, block_size=7)
    with pytest.raises(ValueError, match="single-host"):
        _paged(params, cfg, mesh=object())
    with pytest.raises(RuntimeError, match="no CUDA device|live on"):
        PagedLMEngine(params, cfg, max_len=32, block_size=8)
    eng = _paged(params, cfg, max_len=32, block_size=8, policy=get_policy("amp_bf16"))
    assert eng.cache["k"].dtype == torch.bfloat16 and eng.cache["k"].shape[1] == 4 * 4 + 4 + 1


def _shared_requests(n, extra=2, new=4):
    return [Request(uid=u, prompt=SHARED + [u + 1, u + 2][:extra], max_new_tokens=new)
            for u in range(n)]


def test_shared_prefix_skips_prefill_bit_identically():
    cfg, params = _params_for("smollm-360m")
    dense = _dense(params, cfg, n_slots=2, max_len=32, prefill_chunk=4, record_logits=True)
    d_done, _ = dense.run_until_done(_shared_requests(6))
    paged = _paged(params, cfg, n_slots=2, max_len=32, prefill_chunk=4, record_logits=True,
                   block_size=8)
    p_done, _ = paged.run_until_done(_shared_requests(6))
    assert {r.uid: r.generated for r in p_done} == {r.uid: r.generated for r in d_done}
    _same_logits(dense, paged, range(6))
    ps, ds = paged.stats(), dense.stats()
    prefix = ps["paged"]["prefix"]
    assert prefix["hits"] > 0 and prefix["tokens_reused"] > 0
    assert ps["prompt_tokens"] < ds["prompt_tokens"]
    assert ps["paged"]["peak_live_blocks"] < 6 * (32 // 8) + 1
    _null_block_untouched(paged)


def test_prefix_disabled_still_bit_identical():
    cfg, params = _params_for("smollm-360m")
    on = _paged(params, cfg, n_slots=2, max_len=32, prefill_chunk=4, block_size=8,
                record_logits=True)
    off = _paged(params, cfg, n_slots=2, max_len=32, prefill_chunk=4, block_size=8,
                 prefix_sharing=False, record_logits=True)
    a, _ = on.run_until_done(_shared_requests(3, extra=1, new=3))
    b, _ = off.run_until_done(_shared_requests(3, extra=1, new=3))
    assert {r.uid: r.generated for r in a} == {r.uid: r.generated for r in b}
    assert off.stats()["paged"]["prefix"] == {"enabled": False}
    assert off.stats()["prompt_tokens"] == 3 * 17
    _null_block_untouched(on)
    _null_block_untouched(off)


def _cow_run(engine, req, fork_after=3):
    """Prefill 12 tokens at chunk 4, then share logical block 1 out from
    under the engine (as a prefix entry would) before row 12 is written."""
    engine.submit(req)
    for _ in range(fork_after):
        engine.tick()
    shared = int(engine._bt[0, 1])
    engine.pool.fork(shared)
    while req.status != "done":
        engine.tick()
    return shared


def test_cow_on_divergent_write():
    cfg, params = _params_for("smollm-360m")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    dense = _dense(params, cfg, n_slots=1, max_len=32, prefill_chunk=4, record_logits=True)
    d_done, _ = dense.run_until_done([Request(uid=0, prompt=list(prompt), max_new_tokens=4)])
    paged = _paged(params, cfg, n_slots=1, max_len=32, prefill_chunk=4, record_logits=True,
                   block_size=8)
    req = Request(uid=0, prompt=list(prompt), max_new_tokens=4)
    shared = _cow_run(paged, req)
    assert int(paged._bt[0, 1]) != shared
    assert paged.pool.cow_copies == 1 and paged.pool.refcount(shared) == 1
    paged.pool.release(shared)
    assert req.generated == d_done[0].generated
    _same_logits(dense, paged, [0])
    _null_block_untouched(paged)


def _evict_requests():
    return [Request(uid=u, prompt=[u + 1] * 8 + [1, 2], max_new_tokens=3) for u in range(5)]


def test_eviction_keeps_serving_and_exhaustion_raises():
    cfg, params = _params_for("smollm-360m")
    paged = _paged(params, cfg, n_slots=1, max_len=32, prefill_chunk=4, block_size=8,
                   num_blocks=6)
    done, _ = paged.run_until_done(_evict_requests())
    assert all(r.status == "done" for r in done)
    assert paged.stats()["paged"]["prefix"]["evictions"] > 0
    d_done, _ = _dense(params, cfg, n_slots=1, max_len=32, prefill_chunk=4).run_until_done(
        _evict_requests())
    assert {r.uid: r.generated for r in done} == {r.uid: r.generated for r in d_done}
    _null_block_untouched(paged)
    full = _paged(params, cfg, n_slots=2, max_len=32, prefill_chunk=4, block_size=8,
                  num_blocks=4, prefix_sharing=False)
    for u in range(2):
        full.submit(Request(uid=u, prompt=[1, 2, 3, 4, 5, 6, 7, 8, 9], max_new_tokens=4))
    with pytest.raises(RuntimeError, match="pool exhausted"):
        full.drain()
    _null_block_untouched(full)


def test_pool_tap_and_counters_reset():
    cfg, params = _params_for("smollm-360m")
    eng = _paged(params, cfg, n_slots=2, max_len=32, prefill_chunk=4, block_size=8,
                 telemetry=True)
    eng.run_until_done(_shared_requests(3))
    col = TraceCollector()
    with collecting(col):
        s = eng.stats()
    snap = col.snapshot()["serve/paged/pool"]
    assert int(snap.n) == 3 and float(snap.amax) == pytest.approx(
        max(eng.pool.occupancy, s["paged"]["fragmentation"], float(eng.pool.cow_copies)),
        rel=1e-6)
    eng.reset_counters()
    assert eng.stats()["paged"]["peak_live_blocks"] == eng.pool.live_blocks


# -- the port's paged engine against the reference's, tick by tick ---------------------------
def _paged_events(records):
    return [(r["name"], r.get("attrs")) for r in records
            if r["kind"] == "event" and r["name"].startswith("serve/paged/")]


def _lockstep(arch, submit, kw, fork_at=None):
    """Run the reference's and the port's PagedLMEngine on bridged weights
    tick by tick: equal host block tables after every tick, equal tokens,
    logits within 1e-5, equal ``stats()["paged"]`` and paged events."""
    jcfg, jp, cfg, tp = _bridged(arch)
    jeng = jserve.PagedLMEngine(jp, jcfg, record_logits=True, **kw)
    teng = PagedLMEngine(tp, cfg, record_logits=True, device="cpu", **kw)
    events, reqs = [], []
    for eng, req in ((jeng, jserve.Request), (teng, Request)):
        reqs.append(submit(req))
        for r in reqs[-1]:
            eng.submit(r)
    for obs in (jobs, tobs):
        obs.trace.clear()
        obs.trace.enable()
    try:
        ticks = 0
        while jeng.scheduler.depth or jeng._busy():
            if ticks == fork_at:
                for eng in (jeng, teng):
                    eng.pool.fork(int(eng._bt[0, 1]))
            jeng.tick()
            teng.tick()
            ticks += 1
            assert np.array_equal(jeng._bt, teng._bt), ticks
            assert teng.slot_pos == jeng.slot_pos
        assert not teng._busy()
        events = [_paged_events(obs.trace.snapshot()) for obs in (jobs, tobs)]
    finally:
        for obs in (jobs, tobs):
            obs.trace.disable()
            obs.trace.clear()
    assert events[0] == events[1]
    assert [r.generated for r in reqs[1]] == [r.generated for r in reqs[0]]
    assert all(r.status == "done" for r in reqs[1])
    for uid in jeng._logits_log:
        got, want = teng.logits_for(uid), jeng.logits_for(uid)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want, strict=True):
            assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
    ts, js = teng.stats(), jeng.stats()
    assert ts["paged"] == js["paged"]
    for key in ("ticks", "prompt_tokens", "tokens_generated", "prefill_ticks", "decode_ticks"):
        assert ts[key] == js[key], key
    _null_block_untouched(teng)
    return jeng, teng, events[1]


@pytest.mark.parametrize("arch", ["smollm-360m", "hymba-1.5b", "deepseek-v2-lite-16b"])
def test_plain_traffic_equals_reference_engine(arch):
    rng = np.random.RandomState(5)
    prompts = [[int(t) for t in rng.randint(1, 200, n)] for n in (3, 9, 5, 14, 20)]
    _lockstep(arch, lambda R: [R(uid=i, prompt=list(p), max_new_tokens=5)
                               for i, p in enumerate(prompts)],
              dict(n_slots=2, max_len=32, prefill_chunk=4, block_size=8, scheduler="spf"))


def test_shared_prefix_equals_reference_engine():
    _, teng, events = _lockstep(
        "smollm-360m", lambda R: [R(uid=u, prompt=SHARED + [u + 1, u + 2], max_new_tokens=4)
                                  for u in range(6)],
        dict(n_slots=2, max_len=32, prefill_chunk=4, block_size=8))
    assert teng.stats()["paged"]["prefix"]["hits"] >= 4
    assert [n for n, _ in events].count("serve/paged/prefix_hit") >= 4


def test_cow_equals_reference_engine():
    _, teng, events = _lockstep(
        "smollm-360m",
        lambda R: [R(uid=0, prompt=[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8], max_new_tokens=4)],
        dict(n_slots=1, max_len=32, prefill_chunk=4, block_size=8), fork_at=3)
    assert teng.pool.cow_copies == 1 and ("serve/paged/cow" in [n for n, _ in events])


def test_eviction_equals_reference_engine():
    _, teng, events = _lockstep(
        "smollm-360m", lambda R: [R(uid=u, prompt=[u + 1] * 8 + [1, 2], max_new_tokens=3)
                                  for u in range(5)],
        dict(n_slots=1, max_len=32, prefill_chunk=4, block_size=8, num_blocks=6))
    assert teng.stats()["paged"]["prefix"]["evictions"] > 0
    assert "serve/paged/evict" in [n for n, _ in events]


# -- the async frontend ----------------------------------------------------------------------
def test_frontend_submit_stream_and_deadlines():
    cfg, params = _params_for("smollm-360m")
    engine = _paged(params, cfg, n_slots=2, max_len=32, prefill_chunk=4, block_size=8)
    ref = _dense(params, cfg, n_slots=2, max_len=32, prefill_chunk=4)
    r_done, _ = ref.run_until_done([Request(uid=u, prompt=[2, 7, 1, 8, 2, 8], max_new_tokens=4)
                                    for u in range(2)])
    want = {r.uid: r.generated for r in r_done}
    before = tobs.registry().snapshot()["counters"].get(
        "repro_frontend_deadline_misses_total", 0.0)

    async def main():
        front = AsyncServeFrontend(engine)
        streamed = []

        async def consume():
            async for tok in front.stream(Request(uid=1, prompt=[2, 7, 1, 8, 2, 8],
                                                  max_new_tokens=4)):
                streamed.append(tok)

        a = front.submit_async(Request(uid=0, prompt=[2, 7, 1, 8, 2, 8], max_new_tokens=4),
                               deadline_ms=0.0)   # an impossible deadline: an accounted miss
        done0, _ = await asyncio.gather(a, consume())
        return front, done0, streamed

    tobs.trace.clear()
    tobs.trace.enable()
    try:
        front, done0, streamed = asyncio.run(main())
        names = Counter(r["name"] for r in tobs.trace.snapshot() if r["kind"] in ("b", "e"))
    finally:
        tobs.trace.disable()
        tobs.trace.clear()
    assert done0.status == "done" and done0.generated == want[0]
    assert streamed == want[1]
    m = front.metrics()
    assert m["requests"] == 2 and m["completed"] == 2
    assert m["deadline_misses"] == 1 and m["deadline_miss_rate"] == 1.0
    assert m["latency_ms"]["p99"] >= m["latency_ms"]["p50"] > 0 and m["jitter_ms"] >= 0
    recs = {r["uid"]: r for r in front.records}
    assert recs[0]["deadline_missed"] is True and recs[1]["deadline_missed"] is False
    assert recs[0]["ttft_ms"] is not None and recs[1]["n_generated"] == 4
    snap = tobs.registry().snapshot()
    assert snap["counters"]["repro_frontend_deadline_misses_total"] == before + 1
    assert snap["gauges"]["repro_frontend_completed"] == 2
    assert names["frontend/request"] == 4 and names["frontend/ttft"] == 4
    _null_block_untouched(engine)


def test_frontend_duplicate_uid_and_engine_errors():
    cfg, params = _params_for("smollm-360m")
    engine = _paged(params, cfg, n_slots=1, max_len=32, block_size=8)

    async def dup():
        front = AsyncServeFrontend(engine)
        t = asyncio.ensure_future(front.submit_async(Request(uid=7, prompt=[1, 2, 3],
                                                             max_new_tokens=2)))
        await asyncio.sleep(0)
        with pytest.raises(ValueError, match="already in flight"):
            await front.submit_async(Request(uid=7, prompt=[4, 5], max_new_tokens=2))
        await t

    asyncio.run(dup())
    # an exhausted pool wakes every waiter with the engine's error
    full = _paged(params, cfg, n_slots=2, max_len=32, prefill_chunk=4, block_size=8,
                  num_blocks=4, prefix_sharing=False)

    async def exhaust():
        front = AsyncServeFrontend(full)

        async def consume():
            async for _ in front.stream(Request(uid=1, prompt=list(range(1, 10)),
                                                max_new_tokens=4)):
                pass

        return await asyncio.gather(
            front.submit_async(Request(uid=0, prompt=list(range(1, 10)), max_new_tokens=4)),
            consume(), return_exceptions=True)

    got = asyncio.run(asyncio.wait_for(exhaust(), 60))
    assert all(isinstance(e, RuntimeError) and "pool exhausted" in str(e) for e in got), got


# -- the example and the smoke launcher -------------------------------------------------------
def test_example_paged_with_deadline(capsys):
    stats = serve_lm.main(["--paged", "--block-size", "8", "--slo-deadline-ms", "250",
                           "--device", "cpu", "--requests", "4"])
    out = capsys.readouterr().out
    assert "slo:" in out and stats["engine"] == "lm_paged" and stats["completed"] == 4
    assert stats["paged"]["block_size"] == 8


def test_serve_smoke_writes_the_references_keys(tmp_path):
    out = tmp_path / "serve_smoke.json"
    rec = serve_smoke.main(["--device", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert set(doc) == {"lm", "lm_paged", "operator", "meta"} and doc["meta"]["device"] == "cpu"
    want = jserve_smoke_paged()
    assert set(doc["lm_paged"]) == set(want)
    assert set(want["stats"]) <= set(doc["lm_paged"]["stats"])
    assert set(doc["lm_paged"]["stats"]["paged"]) == set(want["stats"]["paged"])
    assert set(doc["lm_paged"]["stats"]["paged"]["prefix"]) == set(want["stats"]["paged"]["prefix"])
    # the same engines: the lm entry's stats are the paged one's without "paged"
    assert set(doc["lm"]) == set(want) | {"policy_sites"}
    assert set(doc["lm"]["stats"]) == set(doc["lm_paged"]["stats"]) - {"paged"}
    assert doc["lm_paged"]["stats"]["paged"]["prefix"]["hits"] > 0
    assert rec["lm_paged"]["stats"]["paged"]["prefix"]["hits"] == \
        want["stats"]["paged"]["prefix"]["hits"]
    assert doc["operator"]["stats"]["memo"]["hits"] >= 1
    assert doc["lm"]["stats"]["completed"] == 6 and doc["lm"]["stats"]["failed"] == 1


def jserve_smoke_paged():
    from repro.launch import serve_smoke as jsmoke

    return jsmoke.run_paged_lm_smoke()
