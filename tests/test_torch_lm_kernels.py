"""The port's LM-pool substrate kernels against the reference on the CPU:
``repro_torch.kernels.rmsnorm`` and ``repro_torch.kernels.flash_attention``
(their plain versions, which CPU tensors take) and the ``ops`` entry points,
against the reference's Pallas kernels in interpret mode, on the same numpy
inputs.

Limits.  RMSNorm: the plain version mirrors ``_rmsnorm_kernel`` op for op,
so in f32 it agrees to 1e-6 relative per element (the mean's sum order
differs), and in bf16/fp16 at least 99.9 % of the elements are bit-equal
and every element lies within one ulp of x's dtype (an f32 ulp of
difference can flip a rounding at the store).  Flash attention: in f32
within 1e-5 relative L2; in a half dtype within a quarter of the reference
kernel's own gap to ``flash_attention_ref`` on the same inputs (the
repo's parity rule).  That yardstick is shown to reject a plain version
with another kv block, one that skips p's rounding and a zeroed output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.rmsnorm import rmsnorm as j_rmsnorm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _pair(a, dtype):
    """The same f32 numpy values rounded to ``dtype`` in both frameworks."""
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _ulp(t: torch.Tensor) -> np.ndarray:
    """The spacing of ``t``'s dtype above |t|, as f32."""
    a = t.abs()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).float().numpy()


def _check_rmsnorm(got: torch.Tensor, want, dtype):
    g, w = _np(got), _np(want)
    assert got.shape == tuple(want.shape)
    if dtype == "float32":
        assert np.all(np.abs(g - w) <= 1e-6 * np.abs(w) + 1e-30), np.max(np.abs(g - w))
        return
    _, td = DTYPES[dtype]
    assert np.mean(g == w) >= 0.999, np.mean(g == w)
    ulp = _ulp(torch.tensor(w).to(td))
    assert np.all(np.abs(g - w) <= ulp), np.max(np.abs(g - w) / ulp)


# -- RMSNorm ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,D", [(8, 16), (300, 64), (1, 128), (300, 100), (64, 960)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("block_rows", [64, 256])
def test_rmsnorm_matches_reference_kernel(N, D, dtype, block_rows):
    rng = np.random.RandomState(N + D)
    jx, tx = _pair(rng.randn(N, D), dtype)
    jw, tw = _pair(rng.rand(D) + 0.5, dtype)
    want = j_rmsnorm(jx, jw, block_rows=block_rows, interpret=True)
    got = rn.rmsnorm(tx, tw, block_rows=block_rows)
    assert got.dtype == tx.dtype
    _check_rmsnorm(got, want, dtype)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_rmsnorm_weight_of_another_dtype(wdtype):
    """w is read as f32 whatever its dtype; y is at x's dtype."""
    rng = np.random.RandomState(7)
    jx, tx = _pair(rng.randn(40, 96), "float16")
    jw, tw = _pair(rng.rand(96) + 0.5, wdtype)
    _check_rmsnorm(rn.rmsnorm(tx, tw), j_rmsnorm(jx, jw, interpret=True), "float16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_rmsnorm_rank3_matches_reference(dtype):
    rng = np.random.RandomState(4)
    jx, tx = _pair(rng.randn(2, 5, 16), dtype)
    jw, tw = _pair(rng.rand(16) + 0.5, dtype)
    got = ops.rmsnorm(tx, tw)
    assert got.shape == (2, 5, 16)
    _check_rmsnorm(got, jops.rmsnorm(jx, jw), dtype)


def test_rmsnorm_oracle_matches_reference_oracle():
    rng = np.random.RandomState(5)
    jx, tx = _pair(rng.randn(33, 48), "float32")
    jw, tw = _pair(rng.rand(48) + 0.5, "float32")
    _check_rmsnorm(ref.rmsnorm_ref(tx, tw), jref.rmsnorm_ref(jx, jw), "float32")


# -- flash attention -------------------------------------------------------------------
def _qkv(BH, S, Sk, D, dtype, seed):
    rng = np.random.RandomState(seed)
    return [_pair(rng.randn(BH, n, D), dtype) for n in (S, Sk, Sk)]


def _flash_pair(BH, S, Sk, D, causal, dtype, seed, block=32):
    """(the reference kernel's output, its oracle's, the torch operands)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(BH, S, Sk, D, dtype, seed)
    want = j_flash(jq, jk, jv, causal=causal, block_q=block, block_k=block, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    return _np(want), _np(oracle), (tq, tk, tv)


#: (BH, S, Sk, D, causal, dtype): tests/test_kernels.py's cases, then the
#: unaligned lengths causal in fp16 and more half cases
FLASH_CASES = [(2, 64, 64, 32, True, "float32"), (2, 128, 128, 64, False, "float32"),
               (2, 96, 96, 32, True, "float32"), (1, 50, 70, 32, False, "float32"),
               (2, 64, 64, 32, True, "bfloat16"), (1, 50, 70, 32, True, "float16"),
               (2, 96, 96, 32, True, "float16"), (1, 70, 50, 64, True, "bfloat16"),
               (2, 50, 70, 32, False, "bfloat16")]


def _within_flash_limit(got, want, oracle, dtype):
    """f32: 1e-5 relative L2; half: a quarter of the reference kernel's gap
    to the oracle.  Returns (ok, error, limit)."""
    err = _rel_l2(got, want)
    limit = 1e-5 if dtype == "float32" else 0.25 * _rel_l2(want, oracle)
    return err <= limit, err, limit


@pytest.mark.parametrize("BH,S,Sk,D,causal,dtype", FLASH_CASES)
def test_flash_attention_matches_reference_kernel(BH, S, Sk, D, causal, dtype):
    want, oracle, (tq, tk, tv) = _flash_pair(BH, S, Sk, D, causal, dtype, seed=S + Sk)
    got = fa.flash_attention(tq, tk, tv, causal=causal, block_q=32, block_k=32)
    assert got.dtype == tq.dtype and got.shape == (BH, S, D)
    ok, err, limit = _within_flash_limit(_np(got), want, oracle, dtype)
    assert ok, (err, limit)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_flash_attention_4d_matches_reference(dtype):
    rng = np.random.RandomState(3)
    (jq, tq), (jk, tk), (jv, tv) = [_pair(rng.randn(2, 4, 64, 32), dtype) for _ in range(3)]
    want = jops.flash_attention(jq, jk, jv, causal=True, block_q=32, block_k=32)
    oracle = jref.flash_attention_ref(jq.reshape(8, 64, 32), jk.reshape(8, 64, 32),
                                      jv.reshape(8, 64, 32), causal=True).reshape(2, 4, 64, 32)
    got = ops.flash_attention(tq, tk, tv, causal=True, block_q=32, block_k=32)
    assert got.shape == (2, 4, 64, 32)
    ok, err, limit = _within_flash_limit(_np(got), _np(want), _np(oracle), dtype)
    assert ok, (err, limit)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_oracle_matches_reference_oracle(causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 50, 70, 32, "float32", seed=11)
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    assert _rel_l2(_np(got), _np(want)) <= 1e-6


#: half cases the yardstick is shown to reject wrong versions on
YARD_CASES = [(2, 64, 64, 32, True, "bfloat16"), (1, 50, 70, 32, True, "float16")]


@pytest.mark.parametrize("BH,S,Sk,D,causal,dtype", YARD_CASES)
def test_flash_yardstick_rejects_another_kv_block(BH, S, Sk, D, causal, dtype):
    """p is rounded against its block's running max: a plain version with
    kv blocks of 64 where the reference takes 32 lies outside the limit."""
    want, oracle, (tq, tk, tv) = _flash_pair(BH, S, Sk, D, causal, dtype, seed=S + Sk)
    wrong = fa.flash_attention_plain(tq, tk, tv, causal=causal, block_k=64)
    ok, err, limit = _within_flash_limit(_np(wrong), want, oracle, dtype)
    assert not ok, (err, limit)


@pytest.mark.parametrize("BH,S,Sk,D,causal,dtype", YARD_CASES)
def test_flash_yardstick_rejects_skipped_p_rounding(BH, S, Sk, D, causal, dtype):
    """v passed as f32 leaves p unrounded (the same values of v): outside."""
    want, oracle, (tq, tk, tv) = _flash_pair(BH, S, Sk, D, causal, dtype, seed=S + Sk)
    wrong = fa.flash_attention_plain(tq, tk, tv.float(), causal=causal, block_k=32)
    assert wrong.dtype == tq.dtype
    ok, err, limit = _within_flash_limit(_np(wrong), want, oracle, dtype)
    assert not ok, (err, limit)


@pytest.mark.parametrize("BH,S,Sk,D,causal,dtype", YARD_CASES + [FLASH_CASES[0]])
def test_flash_yardstick_rejects_a_zeroed_output(BH, S, Sk, D, causal, dtype):
    want, oracle, (tq, _, _) = _flash_pair(BH, S, Sk, D, causal, dtype, seed=S + Sk)
    ok, err, limit = _within_flash_limit(np.zeros_like(want), want, oracle, dtype)
    assert not ok, (err, limit)


# -- dispatch ---------------------------------------------------------------------------
def test_cpu_tensors_never_touch_the_launch_counters():
    rng = np.random.RandomState(0)
    before = (fa.launches_flash, rn.launches_rmsnorm)
    q = torch.from_numpy(rng.randn(1, 2, 40, 32).astype(np.float32))
    ops.flash_attention(q, q, q)
    fa.flash_attention(q[0], q[0], q[0], causal=False)
    x = torch.from_numpy(rng.randn(3, 7, 24).astype(np.float32))
    ops.rmsnorm(x, torch.ones(24))
    rn.rmsnorm(x[0], torch.ones(24, dtype=torch.bfloat16))
    assert (fa.launches_flash, rn.launches_rmsnorm) == before


def test_wrappers_reject_what_no_version_takes():
    q = torch.zeros(2, 8, 32)
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention(q, q.half(), q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="expected q"):
        fa.flash_attention(q, q[:, :, :16], q[:, :, :16])
    with pytest.raises(ValueError, match="no keys"):
        fa.flash_attention(q, q[:, :0], q[:, :0])
    x = torch.zeros(4, 16)
    with pytest.raises(TypeError):
        rn.rmsnorm(x.double(), torch.ones(16))
    with pytest.raises(ValueError, match="expected x"):
        rn.rmsnorm(x, torch.ones(15))
    with pytest.raises(ValueError, match="block_rows"):
        rn.rmsnorm(x, torch.ones(16), block_rows=0)


# -- the RMSNorm kernel's plan (host side) ----------------------------------------------
@pytest.mark.parametrize("D,dtype,aligned,want", [
    # one warp a row up to 4 packs a lane: 1024 halves, 512 f32 with 16-byte packs
    (960, torch.bfloat16, True, (True, 4, 1, 8, 2)),
    (960, torch.float32, True, (True, 4, 2, 4, 0)),
    (512, torch.float32, True, (True, 4, 1, 8, 0)),
    (2048, torch.float16, True, (True, 4, 2, 4, 2)),
    (16, torch.bfloat16, True, (True, 2, 1, 8, 2)),
    # wider rows take 2, 4 or 8 warps, 8 packs a lane only at 8 warps
    (6144, torch.bfloat16, True, (True, 4, 8, 1, 2)),
    (6144, torch.float32, True, (True, 8, 8, 1, 0)),
    (4096, torch.bfloat16, True, (True, 4, 4, 2, 2)),
    (16384, torch.bfloat16, True, (True, 8, 8, 1, 2)),
    # a row of bytes off 16, or an operand off 16 bytes: one element a lane
    (961, torch.bfloat16, True, (False, 4, 8, 1, 2)),
    (960, torch.bfloat16, False, (False, 4, 8, 1, 2)),
    (7, torch.float32, True, (False, 2, 1, 8, 0)),
    (1, torch.float16, True, (False, 2, 1, 8, 2)),
    (2048, torch.float32, False, (False, 8, 8, 1, 0)),
    # past what 8 warps hold: the generic instance reads the row twice
    (2049, torch.float32, False, (False, 0, 8, 1, 0)),
    (6145, torch.bfloat16, True, (False, 0, 8, 1, 2)),
    (32768, torch.bfloat16, True, (False, 0, 8, 1, 2)),
])
def test_rmsnorm_plan_picks_the_instance_from_width_dtype_and_alignment(D, dtype, aligned,
                                                                       want):
    plan = rn.rmsnorm_plan(D, dtype, torch.float32, aligned)
    assert tuple(plan) == want
    vec, chunks, wpr, rows, _ = plan
    assert rows * wpr == 8
    if chunks:   # the lanes of a row hold all of it, in one of the instances
        size = torch.empty((), dtype=dtype).element_size()
        assert chunks in (2, 4, 8) and 32 * wpr * chunks * (16 // size if vec else 1) >= D


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16, torch.float16])
def test_rmsnorm_plan_does_not_depend_on_the_weight_dtype(wdtype):
    for D in (1, 7, 960, 961, 2048, 6144, 6145):
        for xdtype in (torch.float32, torch.bfloat16, torch.float16):
            assert rn.rmsnorm_plan(D, xdtype, wdtype) == rn.rmsnorm_plan(D, xdtype, torch.float32)
    with pytest.raises(TypeError):
        rn.rmsnorm_plan(960, torch.float64, wdtype)
