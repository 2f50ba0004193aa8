"""The PyTorch port's operator serving on the CPU: scheduler admission,
resolution buckets, stats, capacity failures, the content-hash memo and
batched == solo bit-identity, mirroring the reference's
tests/test_serve_engine.py; plus the request-field generator against the
reference's distribution."""
import jax
import numpy as np
import pytest
import torch

from repro.data import grf_2d as jgrf_2d
from repro.serve.paged.prefix import content_key as jcontent_key
from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE
from repro_torch.data import grf_2d
from repro_torch.models import fno_infer, init_fno
from repro_torch.precision import get_policy
from repro_torch.serve import FieldRequest, OperatorEngine, Scheduler, content_key

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def net():
    return init_fno(torch.Generator().manual_seed(1), FNO_DARCY_SMOKE, device="cpu")


def _engine(net, **kw):
    return OperatorEngine(net, device="cpu", **kw)


def _fields(n, count, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(1, n, n).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("policy_name", ["full", "mixed_fno_bf16"])
def test_batched_matches_solo_bit_identically(net, policy_name):
    policy = get_policy(policy_name)
    xs = _fields(16, 5, 0)
    engine = _engine(net, policy=policy, max_batch=4)
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(xs)]
    for r in reqs:
        engine.submit(r)
    done, _ = engine.drain()
    assert all(r.status == "done" for r in done)
    for i, x in enumerate(xs):
        solo = _engine(net, policy=policy, max_batch=4)
        sr = FieldRequest(uid=0, x=x)
        solo.submit(sr)
        solo.drain()
        assert np.array_equal(sr.y, reqs[i].y)


def test_engine_output_matches_fno_infer(net):
    """The engine is a scheduler around ``fno_infer``: its output rows
    equal the padded-batch forward."""
    policy = get_policy("mixed_fno_bf16")
    xs = _fields(16, 4, 3)
    engine = _engine(net, policy=policy, max_batch=4)
    reqs = [FieldRequest(uid=i, x=x) for i, x in enumerate(xs)]
    for r in reqs:
        engine.submit(r)
    engine.drain()
    ref = fno_infer(net, np.stack(xs), policy, device="cpu").numpy()
    for i, r in enumerate(reqs):
        assert r.y.dtype == np.float32 and np.array_equal(r.y, ref[i])


def test_resolution_buckets_and_stats(net):
    engine = _engine(net, max_batch=4)
    for i, x in enumerate(_fields(16, 5, 1)):
        engine.submit(FieldRequest(uid=i, x=x))
    for i, x in enumerate(_fields(24, 3, 2)):
        engine.submit(FieldRequest(uid=10 + i, x=x))
    done, ticks = engine.drain()
    assert sum(r.status == "done" for r in done) == 8
    # 16x16 needs two ticks (5 > max_batch), 24x24 one
    assert ticks == 3
    s = engine.stats()
    assert s["buckets"] == {"16x16": 5, "24x24": 3}
    assert s["fields_served"] == 8 and s["batches"] == 3
    assert s["avg_batch_fill"] == round(8 / 12, 4) and s["device"] == "cpu"
    assert s["queue"]["admitted"] == 8 and s["completed"] == 8
    engine.reset_counters()
    assert engine.stats()["fields_served"] == 0 and engine.stats()["ticks"] == 3


def test_malformed_fields_fail_at_submit(net):
    engine = _engine(net, max_batch=2)
    bad_ch = FieldRequest(uid=0, x=np.zeros((3, 16, 16), np.float32))
    bad_nd = FieldRequest(uid=1, x=np.zeros((1, 16, 16, 16), np.float32))
    assert not engine.submit(bad_ch)
    assert not engine.submit(bad_nd)
    assert "channels" in bad_ch.error and "-d" in bad_nd.error
    done, ticks = engine.drain()
    assert ticks == 0 and {r.status for r in done} == {"failed"}
    assert engine.stats()["failed"] == 2


def test_memoized_matches_batched_bit_identically(net):
    xs = _fields(16, 3, 0)
    fields = [xs[0], xs[1], xs[0], xs[2], xs[1], xs[0], xs[2], xs[0]]
    plain = _engine(net, max_batch=4)
    pr = [FieldRequest(uid=i, x=x) for i, x in enumerate(fields)]
    for r in pr:
        plain.submit(r)
    plain.drain()
    memo = _engine(net, max_batch=4, memo_window=8)
    mr = [FieldRequest(uid=i, x=x) for i, x in enumerate(fields)]
    for r in mr:
        memo.submit(r)
    memo.drain()
    for a, b in zip(pr, mr, strict=True):
        assert a.status == b.status == "done"
        assert np.array_equal(a.y, b.y), a.uid
    st = memo.stats()["memo"]
    assert st == {"window": 8, "entries": 3, "hits": 5, "misses": 3,
                  "hit_rate": 0.625, "evictions": 0}
    assert memo.stats()["batches"] < plain.stats()["batches"]


def test_memo_lru_eviction(net):
    xs = _fields(16, 3, 1)
    engine = _engine(net, max_batch=1, memo_window=1)
    for i, x in enumerate(xs + [xs[0]]):
        engine.submit(FieldRequest(uid=i, x=x))
    engine.drain()
    st = engine.stats()["memo"]
    # window 1: xs[0] was evicted before it came back => 4 misses
    assert st["misses"] == 4 and st["hits"] == 0
    assert st["evictions"] == 3 and st["entries"] == 1


def test_content_key_matches_reference():
    x = np.random.RandomState(0).randn(1, 5, 7)
    assert content_key(x) == jcontent_key(x)
    assert content_key(x) != content_key(x.reshape(1, 7, 5))


def test_scheduler_policies():
    class R:
        def __init__(self, uid, cost):
            self.uid, self.cost = uid, cost

    sched = Scheduler("spf", cost=lambda r: r.cost)
    a, b, c = R(0, 8), R(1, 2), R(2, 2)
    for r in (a, b, c):
        sched.submit(r, tick=0)
    picked = sched.take(2, tick=3)
    # shortest first; FCFS tie-break keeps b before c
    assert [r.uid for r in picked] == [1, 2]
    assert sched.stats()["wait_ticks_total"] == 6
    assert sched.take(5)[0].uid == 0
    fcfs = Scheduler("fcfs", cost=lambda r: r.cost)
    for r in (R(0, 8), R(1, 2)):
        fcfs.submit(r)
    assert [r.uid for r in fcfs.take(2)] == [0, 1]
    with pytest.raises(ValueError, match="unknown scheduler"):
        Scheduler("lifo")


def test_engine_refuses_what_is_not_ported_or_misplaced(net, monkeypatch):
    for kw in ({"telemetry": True}, {"autoprec": object()},
               {"calibration_state": "state.json"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _engine(net, **kw)
    with pytest.raises(ValueError, match="model must be"):
        _engine(net, model="unet")
    # model="sfno" serves an SFNO and refuses an FNO
    with pytest.raises(ValueError, match="needs a SFNOConfig network"):
        _engine(net, model="sfno")
    with pytest.raises(ValueError, match="live on"):
        OperatorEngine(net, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OperatorEngine(net)


def test_grf_matches_reference_distribution():
    """Same covariance as the reference: per-mode power of many samples
    agrees with the reference's within sampling error."""
    n, batch = 16, 512
    ours = grf_2d(torch.Generator().manual_seed(0), n, batch=batch).numpy()
    ref = np.asarray(jgrf_2d(jax.random.PRNGKey(0), n, batch=batch))
    assert ours.shape == ref.shape == (batch, n, n) and ours.dtype == np.float32
    p_ours = (np.abs(np.fft.fft2(ours)) ** 2).mean(0)
    p_ref = (np.abs(np.fft.fft2(ref)) ** 2).mean(0)
    low = np.ix_(range(4), range(4))   # modes with most of the power
    np.testing.assert_allclose(p_ours[low][1:], p_ref[low][1:], rtol=0.3)
    assert abs(ours.var() / ref.var() - 1.0) < 0.15
    assert abs(float(ours.mean())) < 3 * float(ours.std()) / np.sqrt(batch)
