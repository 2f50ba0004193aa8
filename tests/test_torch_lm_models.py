"""The port's LM architecture pool against ``repro.models.lm`` on the CPU.

The same numpy-seeded inputs, and the reference's own weights bridged
with ``lm_params_from_jax`` / ``whisper_params_from_jax``, go through
both packages:

* the configs field for field, ``SHAPES``, ``cell_is_runnable`` and
  ``layer_windows`` (L in 1..64, n in 1..4);
* ``common``: RMSNorm, the three RoPE forms, plain, blocked (S = 1100,
  with a window, padded) and cache attention, a fully masked cache row,
  SwiGLU;
* under ``full`` (relative L2 <= 1e-5 of the reference's logits):
  ``lm_forward`` of the nine decoder archs (llava with ``patch_embeds``;
  ``inputs_embeds``; ``remat`` bit-identical to without),
  ``lm_decode_step`` sequences and ``lm_prefill_chunk`` sequences with
  padded rows, ``n_valid = 0`` and a hymba ring that wraps, and the
  caches they leave;
* the half policies: ``tests/test_torch_lm_half.py``;
* MoE routing (expert ids, the capacity table with its collisions,
  gates, output, aux loss) with and without drops, and ``lax.top_k``'s
  order on ties;
* SSD forward (padded) and decode; Whisper's forward, its decode
  against the reference's and against its own forward;
* the token stream: a pure function of (seed, step), the vectorised
  stream equal to the sequential recurrence on the same draws, and its
  marginal and repeat rate against the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.lm as jlm
import repro.models.lm.common as jc
import repro.models.lm.model as jm
import repro.models.lm.moe as jmoe
import repro.models.lm.ssd as jssd
from repro.core import get_policy as jget_policy
from repro.data.tokens import token_batch as jtoken_batch
import repro_torch.configs as tconfigs
import repro_torch.models.lm as tlm
import repro_torch.models.lm.common as tc
import repro_torch.models.lm.model as tm
import repro_torch.models.lm.moe as tmoe
import repro_torch.models.lm.ssd as tssd
from repro_torch.data import tokens as ttokens

jax.config.update("jax_platform_name", "cpu")

DECODER_ARCHS = [a for a in tconfigs.ARCH_IDS if a != "whisper-large-v3"]
HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def npf(x):
    """A JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def tt(x, dtype=None):
    """A JAX/numpy array as a torch tensor (half dtypes kept)."""
    a = jnp.asarray(x)
    t = torch.from_numpy(np.asarray(a.astype(jnp.float32)).copy()) \
        if a.dtype in (jnp.bfloat16, jnp.float16) else torch.from_numpy(np.array(a))
    if a.dtype == jnp.bfloat16:
        t = t.bfloat16()
    elif a.dtype == jnp.float16:
        t = t.half()
    return t if dtype is None else t.to(dtype)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- configs --------------------------------------------------------------------------
def test_configs_field_for_field():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for smoke in (False, True):
        tall, jall = tconfigs.all_configs(smoke), jconfigs.all_configs(smoke)
        assert list(tall) == list(jall)
        for a in tconfigs.ARCH_IDS:
            t, j = tall[a], jall[a]
            assert dataclasses.asdict(t) == dataclasses.asdict(j), a
            for prop in ("hd", "d_inner", "ssm_heads", "is_subquadratic"):
                assert getattr(t, prop) == getattr(j, prop), (a, prop)
            assert t.params_dense_approx() == j.params_dense_approx()
            assert t.active_params_approx() == j.active_params_approx()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for a in tconfigs.ARCH_IDS:
        for s in tconfigs.SHAPES:
            assert tconfigs.cell_is_runnable(tconfigs.get_config(a), tconfigs.SHAPES[s]) == \
                jconfigs.cell_is_runnable(jconfigs.get_config(a), jconfigs.SHAPES[s])
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-5")
    # the FNO-family exports stay
    assert tconfigs.FNO_DARCY.n_layers == 4 and tconfigs.UNET_BASELINE is not None


@pytest.mark.parametrize("n_full", [1, 2, 3, 4])
def test_layer_windows_match_reference(n_full):
    base_t = tconfigs.get_config("hymba-1.5b", smoke=True)
    base_j = jconfigs.get_config("hymba-1.5b", smoke=True)
    for L in range(1, 65):
        ct = dataclasses.replace(base_t, n_layers=L, n_full_attn_layers=n_full)
        cj = dataclasses.replace(base_j, n_layers=L, n_full_attn_layers=n_full)
        got = tm.layer_windows(ct)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jm.layer_windows(cj)), err_msg=str(L))
    full = tconfigs.get_config("smollm-360m", smoke=True)
    assert tm.layer_windows(full).tolist() == [tm.FULL_WINDOW] * full.n_layers
    swa = dataclasses.replace(base_t, n_full_attn_layers=0)
    assert tm.layer_windows(swa).tolist() == [base_t.attn_window] * base_t.n_layers


# -- common ------------------------------------------------------------------------------
def _ulps_apart(a, b, dtype):
    """Elementwise distance of two half tensors in units of the dtype's
    spacing at the larger magnitude."""
    a, b = a.float(), b.float()
    eps = torch.finfo(dtype).eps
    scale = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(dtype).tiny)
    return ((a - b).abs() / (eps * 2.0 ** torch.floor(torch.log2(scale)))).max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(64, 960).astype(np.float32) * 3
    w = (1 + 0.1 * rng.randn(960)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = jc.rmsnorm(xj, jnp.asarray(w), 1e-5)
    got = tc.rmsnorm(tt(xj), torch.from_numpy(w), 1e-5)
    assert str(got.dtype).endswith(dtype)
    if dtype == "float32":
        assert rel(npf(got), npf(want)) <= 1e-6
    else:
        # the f32 mean of squares sums in another order: a rare last-bit flip
        assert _ulps_apart(got, tt(want), HALF[dtype]) <= 1.0
        assert np.mean(npf(got) != npf(want)) <= 0.01


def test_rope_forms_match_reference():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 10, 16).astype(np.float32)
    pos = np.arange(10)
    np.testing.assert_allclose(npf(tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))),
                               npf(jc.apply_rope(x, pos)), rtol=1e-6, atol=1e-6)
    x1 = rng.randn(4, 3, 16).astype(np.float32)
    p1 = np.array([0, 7, 300, 1023])
    np.testing.assert_allclose(npf(tc.apply_rope_one(torch.from_numpy(x1), torch.from_numpy(p1))),
                               npf(jc.apply_rope_one(x1, p1)), rtol=1e-5, atol=1e-5)
    pc = np.array([[0, 1, 2, 3, 4], [900, 901, 902, 903, 904]])
    xc = rng.randn(2, 3, 5, 8).astype(np.float32)
    np.testing.assert_allclose(npf(tc.apply_rope_chunk(torch.from_numpy(xc), torch.from_numpy(pc))),
                               npf(jc.apply_rope_chunk(xc, pc)), rtol=1e-5, atol=1e-5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = tc.apply_rope(tt(xb), torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    assert np.mean(npf(got) != npf(jc.apply_rope(xb, pos))) <= 0.01


def _qkv(rng, B, H, Hk, S, D, Sk=None):
    Sk = S if Sk is None else Sk
    return (rng.randn(B, H, S, D).astype(np.float32), rng.randn(B, Hk, Sk, D).astype(np.float32),
            rng.randn(B, Hk, Sk, D).astype(np.float32))


@pytest.mark.parametrize("window", [2 ** 30, 7])
def test_plain_attention_matches_reference(window):
    rng = np.random.RandomState(2)
    q, k, v = _qkv(rng, 2, 4, 2, 33, 16)
    pos = np.arange(33)
    want = jc.gqa_attention(q, k, v, pos, pos, window)
    got = tc.gqa_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(pos),
                           torch.from_numpy(pos), window)
    assert rel(npf(got), npf(want)) <= 1e-6


@pytest.mark.parametrize("window", [2 ** 30, 300])
def test_blocked_attention_matches_reference(window):
    """S = 1100 takes the blocked path (>= 1024) and pads both the queries
    (to 3 x 512... q_chunk 512) and the keys; GQA 4 over 2."""
    rng = np.random.RandomState(3)
    q, k, v = _qkv(rng, 1, 4, 2, 1100, 16)
    pos = np.arange(1100)
    jblk = jax.jit(lambda q, k, v: jc.gqa_attention(q, k, v, jnp.arange(1100), jnp.arange(1100),
                                                    window))
    want = jblk(q, k, v)
    tpos = torch.arange(1100)
    got = tc.gqa_attention(*map(torch.from_numpy, (q, k, v)), tpos, tpos, window)
    assert rel(npf(got), npf(want)) <= 1e-5
    # half: within 1/4 of the reference's own bf16-vs-f32 gap
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want_b = jblk(qb, kb, vb)
    ref32 = jblk(*(a.astype(jnp.float32) for a in (qb, kb, vb)))
    got_b = tc.blocked_attention(tt(qb), tt(kb), tt(vb), tpos, tpos, window)
    assert got_b.dtype == torch.bfloat16
    assert rel(npf(got_b), npf(want_b)) <= 0.25 * rel(npf(want_b), npf(ref32))
    # an explicit chunking: 4 query chunks of 300 (padding 100) x keys of 256
    want_c = jc.blocked_attention(jnp.asarray(q), jnp.repeat(k, 2, axis=1),
                                  jnp.repeat(v, 2, axis=1), pos, pos, window, 300, 256)
    got_c = tc.blocked_attention(*map(torch.from_numpy, (q, k, v)), tpos, tpos, window, 300, 256)
    assert rel(npf(got_c), npf(want_c)) <= 1e-5


def test_chunk_attention_matches_reference_and_masks_finitely():
    rng = np.random.RandomState(4)
    q, kc, vc = _qkv(rng, 3, 4, 2, 5, 16, Sk=12)
    k_pos = np.tile(np.arange(12), (3, 1)).astype(np.int32)
    k_pos[1, 6:] = -1          # a half-empty slot
    k_pos[2, :] = -1           # an empty slot: every key masked
    q_pos = np.array([[7, 8, 9, 10, 11], [3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    for window in (2 ** 30, 4):
        want = jc.chunk_attention(q, kc, vc, k_pos, q_pos, window)
        got = tc.chunk_attention(*map(torch.from_numpy, (q, kc, vc, k_pos, q_pos)), window)
        assert rel(npf(got), npf(want)) <= 1e-6
        assert torch.isfinite(got).all()
    # the empty slot's rows are the uniform mean of its values (query heads
    # 0 and 1 read KV head 0)
    uni = vc[2].mean(axis=1)  # (Hk, D)
    np.testing.assert_allclose(got[2, :2].numpy(), np.broadcast_to(uni[0], (2, 5, 16)),
                               rtol=1e-5, atol=1e-7)
    wd = jc.decode_attention(q[:, :, :1], kc, vc, k_pos, q_pos[:, 0], 2 ** 30)
    gd = tc.decode_attention(*map(torch.from_numpy, (q[:, :, :1], kc, vc, k_pos, q_pos[:, 0])),
                             2 ** 30)
    assert rel(npf(gd), npf(wd)) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_swiglu_matches_reference(dtype):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 64).astype(np.float32)
    p = {"wg": rng.randn(64, 128).astype(np.float32) * 0.1,
         "wu": rng.randn(64, 128).astype(np.float32) * 0.1,
         "wd": rng.randn(128, 64).astype(np.float32) * 0.1}
    jd = getattr(jnp, dtype)
    with jax.disable_jit():
        want = jc.swiglu(p, jnp.asarray(x), jd)
    got = tc.swiglu({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                    getattr(torch, dtype))
    if dtype == "float32":
        assert rel(npf(got), npf(want)) <= 1e-6
    else:
        # bf16/fp16: jax.nn.silu's logistic rounds 1 / (1 + exp(-x)) op by op;
        # only f32 sum-order flips remain
        assert np.mean(npf(got) != npf(want)) <= 0.01
        ref32 = jc.swiglu(p, jnp.asarray(x).astype(jd).astype(jnp.float32), jnp.float32)
        assert rel(npf(got), npf(want)) <= 0.25 * rel(npf(want), npf(ref32))
    g = jnp.asarray(rng.randn(4096).astype(np.float32) * 4).astype(jnp.bfloat16)
    np.testing.assert_array_equal(npf(tc.silu(tt(g))), npf(jax.nn.silu(g)))


# -- models under full -----------------------------------------------------------------------
class Arch:
    """The reference's smoke model and its bridged twin, with the
    reference's steps jitted once."""

    def __init__(self, arch, seed=0, **replace):
        self.tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True), **replace)
        self.jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), **replace)
        self.jp = jlm.init_lm(jax.random.PRNGKey(seed), self.jcfg)
        self.tp = tlm.lm_params_from_jax(tree_np(self.jp), self.tcfg, device="cpu")
        jcfg = self.jcfg
        full = jget_policy("full")
        self.jfwd = jax.jit(lambda p, t, pe: jlm.lm_forward(p, t, jcfg, full, patch_embeds=pe))
        self.jdec = jax.jit(lambda p, c, t: jlm.lm_decode_step(p, c, t, jcfg, full))
        self.jchunk = jax.jit(lambda p, c, t, n: jlm.lm_prefill_chunk(p, c, t, n, jcfg, full))


@pytest.fixture(scope="module")
def archs():
    return {}


def _arch(archs, name):
    if name not in archs:
        archs[name] = Arch(name)
    return archs[name]


def _cmp_cache(tcache, jcache):
    for k, v in jcache.items():
        if v.dtype == jnp.int32:
            np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(v), err_msg=k)
        else:
            assert rel(npf(tcache[k]), npf(v)) <= 1e-5, k


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_lm_forward_decode_and_prefill_match_reference(archs, arch):
    a = _arch(archs, arch)
    cfg = a.tcfg
    rng = np.random.RandomState(10)
    toks = rng.randint(0, cfg.vocab, (2, 12)).astype(np.int32)
    pe = (0.1 * rng.randn(2, cfg.n_patches, cfg.d_model)).astype(np.float32) \
        if cfg.frontend == "vision_stub" else None
    jl, jaux = a.jfwd(a.jp, jnp.asarray(toks), None if pe is None else jnp.asarray(pe))
    with torch.no_grad():
        tl, taux = tlm.lm_forward(a.tp, torch.from_numpy(toks).long(), cfg,
                                  patch_embeds=None if pe is None else torch.from_numpy(pe))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert rel(npf(tl), npf(jl)) <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-5 * max(1.0, abs(float(jaux)))

    # decode: 6 steps from zero caches, B = 2
    jcache = jlm.init_cache(a.jcfg, 2, 16)
    tcache = tlm.init_cache(cfg, 2, 16, device="cpu")
    for t in range(6):
        jlg, jcache = a.jdec(a.jp, jcache, jnp.asarray(toks[:, t]))
        tlg, tcache = tlm.lm_decode_step(a.tp, tcache, torch.from_numpy(toks[:, t]).long(), cfg)
        assert rel(npf(tlg), npf(jlg)) <= 1e-5, t
    _cmp_cache(tcache, jcache)

    # chunked prefill: padded rows, a slot at n_valid = 0, a 1-token row
    K = 4
    W = 40 if cfg.attn_window else 24
    jcache = jlm.init_cache(a.jcfg, 3, W)
    tcache = tlm.init_cache(cfg, 3, W, device="cpu")
    plan = [(4, 2, 0), (3, 4, 1), (0, 4, 4), (4, 1, 2)]
    for n_valid in plan:
        ch = rng.randint(0, cfg.vocab, (3, K)).astype(np.int32)
        nv = np.asarray(n_valid, np.int32)
        jlg, jcache = a.jchunk(a.jp, jcache, jnp.asarray(ch), jnp.asarray(nv))
        tlg, tcache = tlm.lm_prefill_chunk(a.tp, tcache, torch.from_numpy(ch).long(),
                                           torch.from_numpy(nv).long(), cfg)
        live = nv > 0
        assert rel(npf(tlg)[live], npf(jlg)[live]) <= 1e-5, n_valid
        assert torch.isfinite(tlg).all()
    _cmp_cache(tcache, jcache)


def test_inputs_embeds_and_remat(archs):
    """``inputs_embeds`` in place of tokens against the reference; remat
    (``torch.utils.checkpoint`` per layer) changes no bit of the logits or
    the gradients."""
    a = _arch(archs, "hymba-1.5b")
    cfg = a.tcfg
    emb = (0.3 * np.random.RandomState(14).randn(2, 10, cfg.d_model)).astype(np.float32)
    jcfg = a.jcfg
    want, _ = jax.jit(lambda p, e: jlm.lm_forward(p, None, jcfg, inputs_embeds=e))(a.jp, emb)
    with torch.no_grad():
        got, _ = tlm.lm_forward(a.tp, None, cfg, inputs_embeds=torch.from_numpy(emb))
    assert rel(npf(got), npf(want)) <= 1e-5
    toks = torch.from_numpy(np.random.RandomState(15).randint(0, cfg.vocab, (2, 10)))
    params = list(a.tp.parameters())
    outs = []
    for remat in (False, True):
        logits, _ = tlm.lm_forward(a.tp, toks, cfg, remat=remat)
        outs.append((logits.detach(), torch.autograd.grad(logits.square().mean(), params)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(g0, g1) for g0, g1 in zip(outs[0][1], outs[1][1], strict=True))


def test_prefill_chunk_ring_wraps_like_reference(archs):
    """hymba's SWA ring (window 32) written by 12 chunks of 4: the rows
    wrap twice; every chunk's logits and the final ring match."""
    a = _arch(archs, "hymba-1.5b")
    cfg = a.tcfg
    rng = np.random.RandomState(11)
    jcache = jlm.init_cache(a.jcfg, 2, 64)
    tcache = tlm.init_cache(cfg, 2, 64, device="cpu")
    assert tcache["kv_pos"].shape[-1] == cfg.attn_window == 32
    for c in range(18):
        ch = rng.randint(0, cfg.vocab, (2, 4)).astype(np.int32)
        nv = np.array([4, 3 if c % 3 else 4], np.int32)
        jlg, jcache = a.jchunk(a.jp, jcache, jnp.asarray(ch), jnp.asarray(nv))
        tlg, tcache = tlm.lm_prefill_chunk(a.tp, tcache, torch.from_numpy(ch).long(),
                                           torch.from_numpy(nv).long(), cfg)
        assert rel(npf(tlg), npf(jlg)) <= 1e-5, c
    assert int(tcache["step"][0]) == 72 > 2 * 32
    _cmp_cache(tcache, jcache)


def test_decode_matches_forward_per_position(archs):
    """The KV-cache contract within the port: decode logits equal the
    forward's at every position (dense, MLA without drops, SSD, hybrid)."""
    for arch in ("smollm-360m", "mamba2-370m", "hymba-1.5b"):
        a = _arch(archs, arch)
        toks = torch.from_numpy(np.random.RandomState(12).randint(0, a.tcfg.vocab, (1, 8)))
        with torch.no_grad():
            full, _ = tlm.lm_forward(a.tp, toks, a.tcfg)
        cache = tlm.init_cache(a.tcfg, 1, 8, device="cpu")
        for t in range(8):
            lg, cache = tlm.lm_decode_step(a.tp, cache, toks[:, t], a.tcfg)
            assert rel(lg.numpy(), full[:, t].numpy()) <= 1e-5, (arch, t)


# -- MoE ----------------------------------------------------------------------------------------
@jax.jit
def _jroute_topk(probs):
    return jax.lax.top_k(probs, 4)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jroute(params, x, top_k, capacity_factor):
    """The routing lines of ``repro.models.lm.moe._moe_one_group`` (its
    router through the (E, C) tables), run by JAX."""
    T = x.shape[0]
    E = params["router"].shape[1]
    C = max(1, int(top_k * T * capacity_factor / E))
    logits = jnp.einsum("td,de->te", x, params["router"])
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdims=True) + 1e-9)
    flat_expert = expert_ids.reshape(-1)
    flat_token = jnp.repeat(jnp.arange(T), top_k)
    order = jnp.argsort(flat_expert)
    se, stok, sg = flat_expert[order], flat_token[order], gate_vals.reshape(-1)[order]
    counts = jnp.zeros(E, jnp.int32).at[se].add(1)
    seg_start = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]])
    pos_in_seg = jnp.arange(T * top_k) - seg_start[se]
    valid = pos_in_seg < C
    table = jnp.full((E, C), T, jnp.int32).at[se, jnp.minimum(pos_in_seg, C - 1)].set(
        jnp.where(valid, stok, T))
    gates = jnp.zeros((E, C), jnp.float32).at[se, jnp.minimum(pos_in_seg, C - 1)].set(
        jnp.where(valid, sg, 0.0))
    return expert_ids, table, gates


@pytest.mark.parametrize("capacity_factor,drops", [(8.0, False), (0.5, True)])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_routing_and_output_match_reference(capacity_factor, drops, n_shared):
    jp = jmoe.init_moe(jax.random.PRNGKey(5), 32, 4, 64, n_shared, 64)
    tp = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict)
              else {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
          for k, v in jp.items()}
    x = np.random.RandomState(2).randn(64, 32).astype(np.float32)
    ids, table, gates, aux = tmoe.route(tp, torch.from_numpy(x), 2, capacity_factor)
    jids, jtable, jgates = _jroute(jp, jnp.asarray(x), 2, capacity_factor)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    # the gates are softmax probabilities: f32 sum order
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=1e-6, atol=0)
    # with drops some of the 64 x 2 assignments find no slot
    assert (int((table < 64).sum()) < 64 * 2) == drops
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_apply(
        p, x, top_k=2, capacity_factor=capacity_factor, dtype=jnp.float32))(jp, jnp.asarray(x))
    out, aux2 = tmoe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                               capacity_factor=capacity_factor, dtype=torch.float32)
    assert rel(out.numpy(), npf(jout)) <= 1e-6
    assert float(aux) == float(aux2)
    assert abs(float(aux2) - float(jaux)) <= 1e-6


def test_top_k_keeps_lower_index_first_on_ties():
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.1, 0.5], [1, 1, 1, 1, 1, 1]], np.float32)
    v, i = tmoe.lax_top_k(torch.from_numpy(x), 4)
    jv, ji = _jroute_topk(jnp.asarray(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert i[0].tolist() == [1, 3, 5, 0]
    # a tie in the router: two experts with equal columns route identically
    jp = jmoe.init_moe(jax.random.PRNGKey(6), 16, 4, 32, 0, 0)
    r = np.asarray(jp["router"]).copy()
    r[:, 2] = r[:, 1]
    jp = dict(jp, router=jnp.asarray(r))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    xs = np.random.RandomState(3).randn(32, 16).astype(np.float32)
    ids, table, _, _ = tmoe.route(tp, torch.from_numpy(xs), 2, 1.0)
    jids, jtable, _ = _jroute(jp, jnp.asarray(xs), 2, 1.0)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))


# -- SSD ----------------------------------------------------------------------------------------
def test_ssd_forward_and_decode_match_reference():
    cfg_t = tconfigs.get_config("mamba2-370m", smoke=True)
    cfg_j = jconfigs.get_config("mamba2-370m", smoke=True)
    jp = jssd.init_ssd(jax.random.PRNGKey(4), cfg_j.d_model, cfg_j.d_inner, cfg_j.ssm_heads,
                       cfg_j.ssm_state)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    u = (0.3 * np.random.RandomState(1).randn(2, 40, cfg_t.d_model)).astype(np.float32)  # 40 = 2.5 chunks
    want = jax.jit(lambda p, u: jssd.ssd_forward(p, u, cfg_j))(jp, u)
    got = tssd.ssd_forward(tp, torch.from_numpy(u), cfg_t)
    assert rel(got.numpy(), npf(want)) <= 1e-5
    state_j = jnp.zeros((2, cfg_j.ssm_heads, cfg_j.ssm_head_dim, cfg_j.ssm_state))
    state_t = torch.zeros(tuple(state_j.shape))
    ys = []
    for t in range(12):
        yj, state_j = jssd.ssd_decode_step(jp, jnp.asarray(u[:, t]), state_j, cfg_j)
        yt, state_t = tssd.ssd_decode_step(tp, torch.from_numpy(u[:, t]), state_t, cfg_t)
        assert rel(yt.numpy(), npf(yj)) <= 1e-5, t
        ys.append(yt)
    assert rel(state_t.numpy(), npf(state_j)) <= 1e-5
    # the chunked form against the port's own recurrence
    assert rel(torch.stack(ys, 1).numpy(), got[:, :12].numpy()) <= 2e-5


# -- Whisper -------------------------------------------------------------------------------------
def test_whisper_forward_and_decode_match_reference():
    cfg_t = tconfigs.get_config("whisper-large-v3", smoke=True)
    cfg_j = jconfigs.get_config("whisper-large-v3", smoke=True)
    jp = jlm.init_whisper(jax.random.PRNGKey(2), cfg_j)
    tp = tlm.whisper_params_from_jax(tree_np(jp), cfg_t, device="cpu")
    rng = np.random.RandomState(6)
    frames = (0.5 * rng.randn(2, 24, cfg_t.d_model)).astype(np.float32)
    dec = rng.randint(0, cfg_t.vocab, (2, 8)).astype(np.int32)
    want = jax.jit(lambda p, f, d: jlm.whisper_forward(p, f, d, cfg_j))(jp, frames, dec)
    with torch.no_grad():
        got = tlm.whisper_forward(tp, torch.from_numpy(frames), torch.from_numpy(dec).long(), cfg_t)
        mem = tlm.whisper_encode(tp, torch.from_numpy(frames), cfg_t)
    assert rel(got.numpy(), npf(want)) <= 1e-5
    jmem = jlm.whisper_encode(jp, frames, cfg_j)
    assert rel(mem.numpy(), npf(jmem)) <= 1e-5
    jcache = jlm.init_whisper_cache(jp, jmem, cfg_j, 2)
    tcache = tlm.init_whisper_cache(tp, mem, cfg_t, 2)
    jdec = jax.jit(lambda p, c, t: jlm.whisper_decode_step(p, c, t, cfg_j))
    for t in range(8):
        jl, jcache = jdec(jp, jcache, jnp.asarray(dec[:, t]))
        tl, tcache = tlm.whisper_decode_step(tp, tcache, torch.from_numpy(dec[:, t]).long(), cfg_t)
        assert rel(tl.numpy(), npf(jl)) <= 1e-5, t
        # decode against the port's own forward at that position
        assert rel(tl.numpy(), got[:, t].numpy()) <= 1e-5, t
    for k in ("self_k", "self_v", "cross_k", "cross_v"):
        assert rel(tcache[k].numpy(), npf(jcache[k])) <= 1e-5, k
    np.testing.assert_array_equal(tcache["self_pos"].numpy(), np.asarray(jcache["self_pos"]))


# -- tokens ----------------------------------------------------------------------------------------
def test_token_batch_is_a_pure_function_of_seed_and_step():
    a = ttokens.token_batch(7, 3, 4, 64, 1000)["tokens"]
    b = ttokens.token_batch(7, 3, 4, 64, 1000)["tokens"]
    assert a.shape == (4, 65) and a.dtype == torch.int64
    assert torch.equal(a, b)
    assert not torch.equal(a, ttokens.token_batch(7, 4, 4, 64, 1000)["tokens"])
    assert not torch.equal(a, ttokens.token_batch(8, 3, 4, 64, 1000)["tokens"])
    # a restart at step 3 resumes the stream bit for bit
    run = [ttokens.token_batch(7, s, 4, 64, 1000)["tokens"] for s in range(5)]
    assert torch.equal(run[3], a)
    inp = ttokens.lm_inputs(7, 3, 4, 64, 1000)
    assert torch.equal(inp["tokens"], a[:, :-1]) and torch.equal(inp["labels"], a[:, 1:])
    # the vectorised stream is the reference's sequential recurrence on the
    # same draws
    g = ttokens._generator(7, 3)
    u = torch.rand((4, 65), generator=g)
    base = torch.clamp(torch.floor(1000.0 ** u) - 1.0, 0, 999).long()
    rep = torch.rand((4, 65), generator=g) < 0.3
    prev = base[:, 0].clone()
    for t in range(65):
        prev = torch.where(rep[:, t], (prev + 1) % 1000, base[:, t])
        assert torch.equal(a[:, t], prev), t


def test_token_stream_statistics_match_reference():
    V = 512
    t = torch.cat([ttokens.token_batch(0, s, 32, 256, V)["tokens"] for s in range(4)]).numpy()
    j = np.concatenate([np.asarray(jtoken_batch(0, s, 32, 256, V)["tokens"]) for s in range(4)])
    assert t.min() >= 0 and t.max() < V

    def stats(x):
        rep = np.mean(x[:, 1:] == (x[:, :-1] + 1) % V)
        return rep, [np.mean(x < c) for c in (1, 4, 16, 64, 256)], np.mean(np.log1p(x))

    rt, mt, lt = stats(t)
    rj, mj, lj = stats(j)
    assert abs(rt - rj) <= 0.01, (rt, rj)
    assert 0.3 <= rt <= 0.36
    np.testing.assert_allclose(mt, mj, atol=0.015)
    assert abs(lt - lj) <= 0.05
