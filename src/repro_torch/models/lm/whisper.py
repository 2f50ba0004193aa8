"""Whisper-style encoder-decoder backbone (audio family).

The conv/mel frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings (B, S, d).  Bidirectional encoder
self-attention over the frames, causal decoder self-attention (up to
``max_dec_len`` tokens), cross-attention into the encoder memory.
Positions use RoPE throughout, as the reference does.

Decode (:func:`whisper_decode_step`) keeps the decoder's self-KV in a
ring of ``max_dec_len`` rows and the cross-KV projected once from the
encoder memory (:func:`init_whisper_cache`), updated in place under
``torch.inference_mode()``.  ``LMEngine`` does not serve this model.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.constrain import constrain_bhsd, constrain_bsd
from repro_torch.dist.local import matmul, rows_matmul
from repro_torch.dist.sharding import write_rows
from repro_torch.precision import FULL

from .common import (
    decode_attention,
    dense,
    embed_rows,
    gen_device,
    gqa_attention,
    init_swiglu,
    randn,
    rmsnorm,
    rope_cs,
    rotate,
    split_heads,
    swiglu,
)
from .model import (
    FULL_WINDOW,
    ParamTree,
    _grad_off,
    _init_attn,
    flat_items,
    jax_leaves,
    load_tree,
    unstack_jax,
)


def _init_block(generator, cfg: LMArchConfig, cross: bool) -> dict:
    dev = gen_device(generator)
    blk = {
        "ln1": torch.ones((cfg.d_model,), device=dev),
        "ln2": torch.ones((cfg.d_model,), device=dev),
        "attn": _init_attn(generator, cfg),
        "ffn": init_swiglu(generator, cfg.d_model, cfg.d_ff),
    }
    if cross:
        blk["ln_x"] = torch.ones((cfg.d_model,), device=dev)
        blk["xattn"] = _init_attn(generator, cfg)
    return blk


class Whisper(nn.Module):
    """``embed`` (V, d), ``enc_norm``, ``dec_norm``, and one
    :class:`~repro_torch.models.lm.model.ParamTree` a block in ``enc`` and
    ``dec``.  Built on the meta device; :func:`init_whisper` and
    :func:`whisper_params_from_jax` load its tensors."""

    def __init__(self, cfg: LMArchConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.Parameter(randn(None, (cfg.vocab, d)))
        self.enc_norm = nn.Parameter(randn(None, (d,)))
        self.dec_norm = nn.Parameter(randn(None, (d,)))
        self.enc = nn.ModuleList([ParamTree(_init_block(None, cfg, False))
                                  for _ in range(cfg.n_layers)])
        self.dec = nn.ModuleList([ParamTree(_init_block(None, cfg, True))
                                  for _ in range(cfg.dec_layers or cfg.n_layers)])


def init_whisper(generator: torch.Generator, cfg: LMArchConfig,
                 device: DeviceLike = None) -> Whisper:
    """A randomly initialised Whisper on ``device`` (CUDA unless the caller
    names another), drawn from ``generator`` on its own device."""
    dev = resolve_device(device)
    gdev = generator.device
    state = {}
    for group, n, cross in (("enc", cfg.n_layers, False),
                            ("dec", cfg.dec_layers or cfg.n_layers, True)):
        for i in range(n):
            for name, v in flat_items(_init_block(generator, cfg, cross)):
                state[f"{group}.{i}.{name}"] = v
    state["embed"] = randn(generator, (cfg.vocab, cfg.d_model), 1.0 / cfg.d_model ** 0.5)
    state["enc_norm"] = torch.ones((cfg.d_model,), device=gdev)
    state["dec_norm"] = torch.ones((cfg.d_model,), device=gdev)
    return load_tree(Whisper(cfg), state, dev)


def whisper_params_from_jax(tree: Mapping, cfg: LMArchConfig,
                            device: DeviceLike = None) -> Whisper:
    """A Whisper on ``device`` holding the reference's parameters
    (``repro.models.lm.init_whisper``'s tree, ``enc``/``dec`` stacked)."""
    dev = resolve_device(device)
    state = unstack_jax(tree["enc"], "enc")
    state.update(unstack_jax(tree["dec"], "dec"))
    state.update(jax_leaves(tree, ("embed", "enc_norm", "dec_norm")))
    return load_tree(Whisper(cfg), state, dev)


def _mha(ap, hq, hkv, q_pos, k_pos, causal: bool, cfg: LMArchConfig, dtype, q_cs, k_cs):
    """Attention of hq's queries over hkv's keys; ``q_cs``/``k_cs``: the
    RoPE (cos, sin) at q_pos and k_pos."""
    B, Sq, _ = hq.shape
    Sk = hkv.shape[1]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rotate(constrain_bhsd(split_heads(dense(hq, ap["wq"], dtype), H, hd).transpose(1, 2)),
               q_cs)
    k = rotate(constrain_bhsd(split_heads(dense(hkv, ap["wk"], dtype), Hk, hd).transpose(1, 2)),
               k_cs)
    v = constrain_bhsd(split_heads(dense(hkv, ap["wv"], dtype), Hk, hd).transpose(1, 2))
    # bidirectional: every key precedes the shifted query positions
    o = gqa_attention(q, k, v, q_pos if causal else q_pos + Sk, k_pos, FULL_WINDOW)
    return dense(o.transpose(1, 2).reshape(B, Sq, H * hd), ap["wo"], dtype)


def _enc_block(lp, h, pos, cfg, dtype, cs):
    h = constrain_bsd(h)
    hn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
    h = h + _mha(lp["attn"], hn, hn, pos, pos, False, cfg, dtype, cs, cs)
    return h + swiglu(lp["ffn"], rmsnorm(h, lp["ln2"], cfg.norm_eps), dtype)


def _dec_block(lp, h, memory, dpos, epos, cfg, dtype, dcs, ecs):
    h = constrain_bsd(h)
    hn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
    h = h + _mha(lp["attn"], hn, hn, dpos, dpos, True, cfg, dtype, dcs, dcs)
    hn = rmsnorm(h, lp["ln_x"], cfg.norm_eps)
    h = h + _mha(lp["xattn"], hn, memory, dpos, epos, False, cfg, dtype, dcs, ecs)
    return h + swiglu(lp["ffn"], rmsnorm(h, lp["ln2"], cfg.norm_eps), dtype)


def whisper_encode(params: Whisper, frames: torch.Tensor, cfg: LMArchConfig, policy=FULL,
                   remat: bool = False) -> torch.Tensor:
    """frames: (B, S, d) stub embeddings -> encoder memory (B, S, d)."""
    dtype = policy.at("lm/dense").compute_dtype
    h = frames.to(dtype)
    pos = torch.arange(h.shape[1], device=h.device)
    cs = rope_cs(pos, cfg.hd, cfg.rope_theta)
    for lp in params.enc:
        args = (lp, h, pos, cfg, dtype, cs)
        h = checkpoint(_enc_block, *args, use_reentrant=False) if remat else _enc_block(*args)
    return rmsnorm(h, params.enc_norm, cfg.norm_eps)


def whisper_forward(params: Whisper, frames: torch.Tensor, dec_tokens: torch.Tensor,
                    cfg: LMArchConfig, policy=FULL, remat: bool = False) -> torch.Tensor:
    """Training forward: (B, S, d) frames + (B, T) decoder tokens -> logits
    (B, T, V)."""
    dtype = policy.at("lm/dense").compute_dtype
    head_dt = policy.at("lm/proj_out").compute_dtype
    memory = whisper_encode(params, frames, cfg, policy, remat=remat)
    h = embed_rows(params.embed, dec_tokens, split_seq=True).to(dtype)
    dpos = torch.arange(h.shape[1], device=h.device)
    epos = torch.arange(memory.shape[1], device=h.device)
    dcs, ecs = rope_cs(dpos, cfg.hd, cfg.rope_theta), rope_cs(epos, cfg.hd, cfg.rope_theta)
    for lp in params.dec:
        args = (lp, h, memory, dpos, epos, cfg, dtype, dcs, ecs)
        h = checkpoint(_dec_block, *args, use_reentrant=False) if remat else _dec_block(*args)
    h = rmsnorm(h, params.dec_norm, cfg.norm_eps)
    return rows_matmul(h.to(head_dt), params.embed, head_dt)


@torch.no_grad()
def init_whisper_cache(params: Whisper, memory: torch.Tensor, cfg: LMArchConfig, batch: int,
                       policy=FULL, dtype=None) -> Dict[str, torch.Tensor]:
    """The cross-KV projected once from the encoder memory (RoPE at the
    frame positions), and a zero self-KV ring, on the memory's device.
    The KV storage dtype is the ``serve/kv_cache`` site's unless ``dtype``
    is given."""
    cdt = policy.at("lm/dense").compute_dtype
    if dtype is None:
        dtype = policy.at("serve/kv_cache").compute_dtype
    dev = memory.device
    L = len(params.dec)
    S = memory.shape[1]
    Hk, hd = cfg.n_kv_heads, cfg.hd
    epos = torch.arange(S, device=dev)
    ecs = rope_cs(epos, hd, cfg.rope_theta)
    mem = memory.to(cdt).float()
    xk, xv = [], []
    for lp in params.dec:
        k = matmul(mem, lp["xattn"]["wk"].to(cdt).float())
        v = matmul(mem, lp["xattn"]["wv"].to(cdt).float())
        k = rotate(k.reshape(batch, S, Hk, hd).transpose(1, 2), ecs)
        xk.append(k.to(dtype))
        xv.append(v.reshape(batch, S, Hk, hd).transpose(1, 2).to(dtype))
    W = cfg.max_dec_len
    return {
        "step": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "self_k": torch.zeros((L, batch, Hk, W, hd), dtype=dtype, device=dev),
        "self_v": torch.zeros((L, batch, Hk, W, hd), dtype=dtype, device=dev),
        "self_pos": torch.full((L, batch, W), -1, dtype=torch.int32, device=dev),
        "cross_k": torch.stack(xk),
        "cross_v": torch.stack(xv),
        "cross_pos": epos.to(torch.int32).expand(L, batch, S).clone(),
    }


def whisper_decode_step(params: Whisper, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                        cfg: LMArchConfig, policy=FULL
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder token a slot against the cached self- and cross-KV:
    (logits (B, V) f32, the cache updated in place)."""
    with _grad_off(cache):
        return _whisper_decode(params, cache, tokens, cfg, policy)


def _whisper_decode(params, cache, tokens, cfg, policy):
    dtype = policy.at("lm/dense").compute_dtype
    head_dt = policy.at("lm/proj_out").compute_dtype
    pos = cache["step"]                           # (B,) per-slot clocks
    h = embed_rows(params.embed, tokens).to(dtype)
    B = h.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    W = cache["self_pos"].shape[-1]
    slot = torch.remainder(pos, W).long()
    b_idx = None if isinstance(pos, DTensor) else torch.arange(B, device=h.device)
    zeros = torch.zeros_like(pos)
    cs = rope_cs(pos[:, None], hd, cfg.rope_theta)
    for i, lp in enumerate(params.dec):
        sk, sv, sp = cache["self_k"][i], cache["self_v"][i], cache["self_pos"][i]
        # self attention
        hn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        ap = lp["attn"]
        q = rotate(split_heads(dense(hn, ap["wq"], dtype), H, hd), cs)[:, :, None, :]
        k = rotate(split_heads(dense(hn, ap["wk"], dtype), Hk, hd), cs)
        v = split_heads(dense(hn, ap["wv"], dtype), Hk, hd)
        write_rows(sk, b_idx, slot, k.to(sk.dtype), row_dim=2)
        write_rows(sv, b_idx, slot, v.to(sv.dtype), row_dim=2)
        write_rows(sp, b_idx, slot, pos)
        o = decode_attention(q, sk.to(dtype), sv.to(dtype), sp, pos, FULL_WINDOW)
        h = h + dense(o[:, :, 0].reshape(B, H * hd), ap["wo"], dtype)
        # cross attention: every frame is visible
        hn = rmsnorm(h, lp["ln_x"], cfg.norm_eps)
        xp = lp["xattn"]
        qx = rotate(split_heads(dense(hn, xp["wq"], dtype), H, hd), cs)[:, :, None, :]
        ox = decode_attention(qx, cache["cross_k"][i].to(dtype), cache["cross_v"][i].to(dtype),
                              cache["cross_pos"][i] * 0, zeros, FULL_WINDOW)
        h = h + dense(ox[:, :, 0].reshape(B, H * hd), xp["wo"], dtype)
        # ffn
        h = h + swiglu(lp["ffn"], rmsnorm(h, lp["ln2"], cfg.norm_eps), dtype)
    h = rmsnorm(h, params.dec_norm, cfg.norm_eps)
    logits = matmul(h.to(head_dt), params.embed.to(head_dt).t())
    cache["step"] += 1
    return logits, cache
