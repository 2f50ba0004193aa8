"""One decoder-only LM covering the architecture pool.

Per-layer mixer (static, from the config):
  attn   GQA attention with RoPE (smollm, granite, stablelm, starcoder2,
         the llava backbone) or MLA (deepseek);
  ssd    Mamba-2 state-space duality (mamba2);
  hymba  parallel attention and SSD heads, mean-fused, with per-layer
         windows: full-attention layers beside sliding-window ones.
FFN: dense SwiGLU or MoE (``moe.py``).

The model is an ``nn.Module`` holding the reference's parameter tree with
one submodule per layer (``layers``, an ``nn.ModuleList``); the layer
loop is a Python loop where the reference scans over stacked layers.
:func:`lm_params_from_jax` unstacks a reference tree into it.

Serving: :func:`init_cache` makes the decode cache, a dict of device
tensors (per-slot ``step`` clocks, so every request keeps its own
position); :func:`lm_decode_step` and :func:`lm_prefill_chunk` update it
in place under ``torch.inference_mode()`` and return the logits.  A
padding token of a chunk writes nothing: its row is left out of the
scatter (the reference drops it at an out-of-range row).

Paged serving: :func:`init_paged_cache` keeps the KV rows in fixed-size
blocks; :func:`lm_paged_decode_step` and :func:`lm_paged_prefill_chunk`
gather each layer's dense view through a block table, run the dense
step's attention on it and scatter back the rows it wrote.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.constrain import constrain, constrain_bhsd, constrain_bsd, pin
from repro_torch.dist.local import matmul
from repro_torch.dist.sharding import write_rows
from repro_torch.precision import FULL, PrecisionPolicy

from .common import (
    chunk_attention,
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
from .moe import init_moe, moe_apply
from .ssd import init_ssd, ssd_decode_step, ssd_forward

FULL_WINDOW = 2 ** 30  # "window" value meaning full attention


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested dict of parameters, read like the reference's pytree
    (``tree["attn"]["wq"]``, ``"ffn" in tree``)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules


def flat_items(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``("a.b.c", leaf)`` pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from flat_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def load_tree(model: nn.Module, state: Dict[str, torch.Tensor], device: torch.device):
    """Load ``state`` into ``model`` (built on the meta device), every key
    present with the shape the config gives it, and place it on
    ``device``."""
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device)


def unstack_jax(tree: Mapping, group: str) -> Dict[str, torch.Tensor]:
    """``"<group>.<i>.<path>"`` entries of the reference's stacked layer
    tree (every leaf with a leading layer axis)."""
    out = {}
    for name, v in flat_items(tree):
        a = np.array(v, dtype=np.float32)
        for i in range(a.shape[0]):
            out[f"{group}.{i}.{name}"] = torch.from_numpy(a[i].copy())
    return out


def jax_leaves(tree: Mapping, names) -> Dict[str, torch.Tensor]:
    return {n: torch.from_numpy(np.array(tree[n], dtype=np.float32)) for n in names if n in tree}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_attn(generator: Optional[torch.Generator], cfg: LMArchConfig) -> dict:
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = (1.0 / d) ** 0.5
    if cfg.mla_kv_lora:
        r, dr, dn, dv = cfg.mla_kv_lora, cfg.mla_rope_dim, cfg.mla_nope_dim, cfg.mla_v_dim
        return {
            "wq": randn(generator, (d, H * (dn + dr)), s),
            "w_dkv": randn(generator, (d, r), s),
            "w_kr": randn(generator, (d, dr), s),
            "w_uk": randn(generator, (r, H * dn), (1.0 / r) ** 0.5),
            "w_uv": randn(generator, (r, H * dv), (1.0 / r) ** 0.5),
            "wo": randn(generator, (H * dv, d), (1.0 / (H * dv)) ** 0.5),
        }
    return {
        "wq": randn(generator, (d, H * hd), s),
        "wk": randn(generator, (d, Hk * hd), s),
        "wv": randn(generator, (d, Hk * hd), s),
        "wo": randn(generator, (H * hd, d), (1.0 / (H * hd)) ** 0.5),
    }


def _init_layer(generator: Optional[torch.Generator], cfg: LMArchConfig) -> dict:
    """One layer's parameter tree; meta tensors for ``generator=None``."""
    dev = gen_device(generator)
    layer = {"ln1": torch.ones((cfg.d_model,), device=dev),
             "ln2": torch.ones((cfg.d_model,), device=dev)}
    if cfg.mixer in ("attn", "hymba"):
        layer["attn"] = _init_attn(generator, cfg)
    if cfg.mixer in ("ssd", "hymba"):
        layer["ssd"] = init_ssd(generator, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                                cfg.ssm_state)
    if cfg.moe_experts:
        layer["ffn"] = init_moe(generator, cfg.d_model, cfg.moe_experts, cfg.moe_ff,
                                cfg.moe_shared, cfg.moe_ff)
    elif cfg.d_ff:
        layer["ffn"] = init_swiglu(generator, cfg.d_model, cfg.d_ff)
    return layer


class LM(nn.Module):
    """The pool's decoder-only LM: ``embed`` (V, d), ``final_norm``,
    ``layers`` (one :class:`ParamTree` a layer), ``unembed`` when the
    embeddings are not tied, ``patch_proj`` for the vision stub.  Built
    on the meta device; :func:`init_lm` and :func:`lm_params_from_jax`
    load its tensors."""

    def __init__(self, cfg: LMArchConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = nn.Parameter(randn(None, (cfg.vocab, d)))
        self.final_norm = nn.Parameter(randn(None, (d,)))
        self.layers = nn.ModuleList(
            [ParamTree(_init_layer(None, cfg)) for _ in range(cfg.n_layers)])
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(randn(None, (cfg.vocab, d)))
        if cfg.frontend == "vision_stub":
            self.patch_proj = nn.Parameter(randn(None, (d, d)))

    def forward(self, tokens, policy: PrecisionPolicy = FULL, **kw):
        return lm_forward(self, tokens, self.cfg, policy, **kw)


def layer_windows(cfg: LMArchConfig, n_layers: Optional[int] = None) -> torch.Tensor:
    """(L,) int32 per-layer attention windows (on the CPU).  hymba:
    ``n_full_attn_layers`` layers get full attention (first, middle, last),
    picked as the reference picks them: an f32 ``jnp.linspace`` over the
    layer indices, truncated."""
    return torch.tensor(window_list(cfg, n_layers), dtype=torch.int32)


def window_list(cfg: LMArchConfig, n_layers: Optional[int] = None) -> List[int]:
    """:func:`layer_windows` as a list of ints, computed on the host with
    numpy (no tensor op: a step traced on fake tensors needs the values)."""
    L = n_layers or cfg.n_layers
    if cfg.attn_window <= 0:
        return [FULL_WINDOW] * L
    w = np.full((L,), cfg.attn_window, dtype=np.int64)
    n = cfg.n_full_attn_layers
    if n > 0:
        stop = np.float32(L - 1)
        if n == 1:
            pts = np.zeros((1,), np.float32)
        else:
            # jnp.linspace: start * (1 - i/div) + stop * (i/div), then stop
            step = np.arange(n - 1, dtype=np.float32) / np.float32(n - 1)
            pts = np.concatenate([np.float32(0.0) * (np.float32(1.0) - step) + stop * step,
                                  [stop]]).astype(np.float32)
        w[pts.astype(np.int32)] = FULL_WINDOW
    return [int(v) for v in w]


def init_lm(generator: torch.Generator, cfg: LMArchConfig, device: DeviceLike = None) -> LM:
    """A randomly initialised LM on ``device`` (CUDA unless the caller
    names another): the reference's scaled normals, ones and constants,
    drawn from ``generator`` on its own device (a CUDA generator draws
    the weights on the card)."""
    dev = resolve_device(device)
    gdev = generator.device
    state = {}
    for i in range(cfg.n_layers):
        for name, v in flat_items(_init_layer(generator, cfg)):
            state[f"layers.{i}.{name}"] = v
    state["embed"] = randn(generator, (cfg.vocab, cfg.d_model), 1.0 / cfg.d_model ** 0.5)
    state["final_norm"] = torch.ones((cfg.d_model,), device=gdev)
    if not cfg.tie_embeddings:
        state["unembed"] = randn(generator, (cfg.vocab, cfg.d_model), 1.0 / cfg.d_model ** 0.5)
    if cfg.frontend == "vision_stub":
        state["patch_proj"] = randn(generator, (cfg.d_model, cfg.d_model),
                                      1.0 / cfg.d_model ** 0.5)
    return load_tree(LM(cfg), state, dev)


def lm_params_from_jax(tree: Mapping, cfg: LMArchConfig, device: DeviceLike = None) -> LM:
    """An LM on ``device`` holding the JAX reference's parameters
    (``repro.models.lm.init_lm``'s tree: ``embed``, ``final_norm``, the
    stacked ``layers``, and ``unembed`` / ``patch_proj`` where the config
    has them), each layer's slice of the stacked leaves in its own
    submodule.  Every entry must be present with the shape ``cfg`` gives
    it."""
    dev = resolve_device(device)
    state = unstack_jax(tree["layers"], "layers")
    state.update(jax_leaves(tree, ("embed", "final_norm", "unembed", "patch_proj")))
    return load_tree(LM(cfg), state, dev)


# ---------------------------------------------------------------------------
# Attention forward (full sequence)
# ---------------------------------------------------------------------------


def _rope_dim(cfg: LMArchConfig) -> int:
    return cfg.mla_rope_dim if cfg.mla_kv_lora else cfg.hd


def _attn_forward(ap, h, positions, window, cfg: LMArchConfig, dtype, cs=None):
    """``cs``: the RoPE (cos, sin) at ``positions`` (computed here if None)."""
    B, S, _ = h.shape
    if cs is None:
        cs = rope_cs(positions, _rope_dim(cfg), cfg.rope_theta)
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.mla_kv_lora:
        dn, dr, dv = cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
        q = split_heads(dense(h, ap["wq"], dtype), H, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q = torch.cat([q_nope.transpose(1, 2), rotate(q_rope.transpose(1, 2), cs)], dim=-1)
        c_kv = dense(h, ap["w_dkv"], dtype)                           # (B, S, r)
        k_r = rotate(dense(h, ap["w_kr"], dtype)[:, None], cs)        # (B, 1, S, dr)
        k_n = split_heads(dense(c_kv, ap["w_uk"], dtype), H, dn).transpose(1, 2)
        k = constrain_bhsd(torch.cat([k_n, k_r.expand(B, H, S, dr)], dim=-1))
        v = constrain_bhsd(split_heads(dense(c_kv, ap["w_uv"], dtype), H, dv).transpose(1, 2))
        q = constrain_bhsd(q)
        o = gqa_attention(q, k, v, positions, positions, window)
        o = o.transpose(1, 2).reshape(B, S, H * dv)
    else:
        q = constrain_bhsd(split_heads(dense(h, ap["wq"], dtype), H, hd).transpose(1, 2))
        k = constrain_bhsd(split_heads(dense(h, ap["wk"], dtype), Hk, hd).transpose(1, 2))
        v = constrain_bhsd(split_heads(dense(h, ap["wv"], dtype), Hk, hd).transpose(1, 2))
        o = gqa_attention(rotate(q, cs), rotate(k, cs), v, positions, positions, window)
        o = o.transpose(1, 2).reshape(B, S, H * hd)
    return dense(o, ap["wo"], dtype)


def _ffn(fp, h, cfg: LMArchConfig, dtype, router_dtype):
    """(out, aux loss) of the layer's FFN over h (..., d)."""
    if cfg.moe_experts:
        shape = h.shape
        # the tokens in (batch, sequence) order: the sequence whole first
        # (dispatch drops tokens by their order; no view folds a sharded S)
        out, aux = moe_apply(fp, constrain(h, "dp", None, None).reshape(-1, shape[-1]),
                             cfg.moe_top_k, cfg.capacity_factor, dtype,
                             router_dtype=router_dtype)
        return pin(out.reshape(shape)), aux
    return swiglu(fp, h, dtype), None


def _dtypes(policy: PrecisionPolicy):
    return (policy.at("lm/dense").compute_dtype, policy.at("lm/router").compute_dtype,
            policy.at("lm/proj_out").compute_dtype)


def _head(params: LM, h: torch.Tensor, head_dtype) -> torch.Tensor:
    unembed = params.unembed if hasattr(params, "unembed") else params.embed
    return matmul(h.to(head_dtype), unembed.to(head_dtype).t())


def _block(lp, h, positions, window, cfg, policy, dtype, router_dtype, cs=None):
    h = constrain_bsd(h)
    hn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
    if cfg.mixer == "attn":
        mix = _attn_forward(lp["attn"], hn, positions, window, cfg, dtype, cs)
    elif cfg.mixer == "ssd":
        mix = ssd_forward(lp["ssd"], hn, cfg, policy)
    else:  # hymba: parallel attention + SSD heads, mean-fused
        a = _attn_forward(lp["attn"], hn, positions, window, cfg, dtype, cs)
        s = ssd_forward(lp["ssd"], hn, cfg, policy)
        mix = 0.5 * (a + s)
    h = h + mix
    aux = None
    if "ffn" in lp:
        f, aux = _ffn(lp["ffn"], rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg, dtype,
                      router_dtype)
        h = h + f
    return h, aux


def lm_forward(
    params: LM,
    tokens: Optional[torch.Tensor],
    cfg: LMArchConfig,
    policy: PrecisionPolicy = FULL,
    patch_embeds: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S_total, V) at f32, aux loss).

    vlm: ``patch_embeds`` (B, Np, d) are projected and prepended; an
    encoder can pass ``inputs_embeds`` instead of tokens.  ``remat=True``
    recomputes each layer in the backward (``torch.utils.checkpoint``).
    Precision: ``lm/dense`` for the mixers and FFNs, ``lm/router`` for the
    MoE router and ``lm/proj_out`` for the head."""
    dtype, router_dtype, head_dtype = _dtypes(policy)
    if inputs_embeds is not None:
        h = inputs_embeds.to(dtype)
    else:
        h = embed_rows(params.embed, tokens).to(dtype)
    if patch_embeds is not None:
        h = torch.cat([dense(patch_embeds, params.patch_proj, dtype), h], dim=1)
    h = constrain_bsd(h)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    cs = rope_cs(positions, _rope_dim(cfg), cfg.rope_theta)
    aux = h.new_zeros((), dtype=torch.float32)
    for lp, window in zip(params.layers, window_list(cfg), strict=True):
        args = (lp, h, positions, window, cfg, policy, dtype, router_dtype, cs)
        h, a = checkpoint(_block, *args, use_reentrant=False) if remat else _block(*args)
        if a is not None:
            aux = aux + a
    h = constrain_bsd(rmsnorm(h, params.final_norm, cfg.norm_eps))
    logits = constrain(_head(params, h, head_dtype), "dp", "seq", None)  # S-sharded CE
    return logits, aux


# ---------------------------------------------------------------------------
# Decode and chunked prefill (serving)
# ---------------------------------------------------------------------------


def init_cache(cfg: LMArchConfig, batch: int, max_len: int, dtype=torch.float32,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The decode cache: zeros, per-slot ``step`` clocks, on ``device``.

    ``dtype`` is the KV storage dtype (the ``serve/kv_cache`` site's; f32
    keeps decode exact under ``full``).  Attention caches are rings of
    min(max_len, window) rows for a sliding-window arch, else max_len.
    MLA caches the compressed c_kv and the rope key only; SSD keeps its
    recurrent state (f32)."""
    dev = resolve_device(device)
    L = cfg.n_layers
    cache = {"step": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.mixer in ("attn", "hymba"):
        W = max_len if cfg.attn_window <= 0 else min(max_len, cfg.attn_window)
        if cfg.mla_kv_lora:
            cache["c_kv"] = torch.zeros((L, batch, W, cfg.mla_kv_lora), dtype=dtype, device=dev)
            cache["k_rope"] = torch.zeros((L, batch, W, cfg.mla_rope_dim), dtype=dtype,
                                          device=dev)
        else:
            shape = (L, batch, cfg.n_kv_heads, W, cfg.hd)
            cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["kv_pos"] = torch.full((L, batch, W), -1, dtype=torch.int32, device=dev)
    if cfg.mixer in ("ssd", "hymba"):
        cache["ssd_state"] = torch.zeros(
            (L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), device=dev)
    return cache


def _layer_caches(cache: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Each layer's views of the cache (writes through them land in it)."""
    keys = [k for k in cache if k != "step"]
    L = cache[keys[0]].shape[0] if keys else 0
    return [{k: cache[k][i] for k in keys} for i in range(L)]


def _mla_expand(ap, lc, B, cfg: LMArchConfig, dtype):
    """The full keys and values of every cache row from the compressed
    cache: (B, H, W, dn + dr) and (B, H, W, dv)."""
    H, dn, dr, dv = cfg.n_heads, cfg.mla_nope_dim, cfg.mla_rope_dim, cfg.mla_v_dim
    W = lc["kv_pos"].shape[-1]
    k_n = split_heads(dense(lc["c_kv"], ap["w_uk"], dtype), H, dn).transpose(1, 2)
    k_full = torch.cat([k_n, lc["k_rope"].to(dtype)[:, None].expand(B, H, W, dr)], dim=-1)
    v_full = split_heads(dense(lc["c_kv"], ap["w_uv"], dtype), H, dv).transpose(1, 2)
    return k_full, v_full


def _attn_decode(ap, h, lc, pos, window, cfg: LMArchConfig, dtype, at):
    """h: (B, d) one token a slot; lc: this layer's cache views; pos: (B,)
    per-slot positions; ``at``: (slot index, ring row, RoPE (cos, sin)) of
    each slot's token.  Writes the token's KV, then attends."""
    B = h.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b_idx, slot, cs = at
    if cfg.mla_kv_lora:
        dn, dv = cfg.mla_nope_dim, cfg.mla_v_dim
        q = split_heads(dense(h, ap["wq"], dtype), H, -1)
        q = torch.cat([q[:, :, :dn], rotate(q[:, :, dn:], cs)], dim=-1)[:, :, None, :]
        c_kv = dense(h, ap["w_dkv"], dtype)
        k_r = rotate(dense(h, ap["w_kr"], dtype)[:, None, :], cs)[:, 0]
        write_rows(lc["c_kv"], b_idx, slot, c_kv.to(lc["c_kv"].dtype))
        write_rows(lc["k_rope"], b_idx, slot, k_r.to(lc["k_rope"].dtype))
        write_rows(lc["kv_pos"], b_idx, slot, pos)
        k_full, v_full = _mla_expand(ap, lc, B, cfg, dtype)
        o = decode_attention(q, k_full, v_full, lc["kv_pos"], pos, window)
        o = o[:, :, 0].reshape(B, H * dv)
    else:
        q = rotate(split_heads(dense(h, ap["wq"], dtype), H, hd), cs)[:, :, None, :]
        k = rotate(split_heads(dense(h, ap["wk"], dtype), Hk, hd), cs)
        v = split_heads(dense(h, ap["wv"], dtype), Hk, hd)
        write_rows(lc["k"], b_idx, slot, k.to(lc["k"].dtype), row_dim=2)
        write_rows(lc["v"], b_idx, slot, v.to(lc["v"].dtype), row_dim=2)
        write_rows(lc["kv_pos"], b_idx, slot, pos)
        o = decode_attention(q, lc["k"].to(dtype), lc["v"].to(dtype), lc["kv_pos"], pos, window)
        o = o[:, :, 0].reshape(B, H * hd)
    return dense(o, ap["wo"], dtype)


def _grad_off(cache: Dict[str, torch.Tensor]):
    """Inference mode for plain caches; ``no_grad`` for a sharded one
    (DTensors cannot be made under inference mode)."""
    return torch.no_grad() if isinstance(cache["step"], DTensor) else torch.inference_mode()


def lm_decode_step(
    params: LM,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,   # (B,) next token ids
    cfg: LMArchConfig,
    policy: PrecisionPolicy = FULL,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One serve step: (logits (B, V) f32, the cache updated in place).
    ``cache["step"]`` holds the per-slot position clocks."""
    with _grad_off(cache):
        return _decode(params, cache, tokens, cfg, policy), cache


def _decode(params, cache, tokens, cfg, policy, paged=None, active_slots=None):
    """The decode step's body over a dense cache, or over ``paged``'s
    per-layer views (written back for ``active_slots`` only)."""
    dtype, router_dtype, head_dtype = _dtypes(policy)
    pos = cache["step"]
    h = embed_rows(params.embed, tokens).to(dtype)                  # (B, d)
    at = None
    if "kv_pos" in cache:
        W = cache["kv_pos"].shape[-1] if paged is None else paged.width
        # every slot writes its row; a sharded cache takes the rank's slots
        b_idx = None if isinstance(pos, DTensor) else torch.arange(h.shape[0], device=h.device)
        at = (b_idx, torch.remainder(pos, W).long(),
              rope_cs(pos[:, None], _rope_dim(cfg), cfg.rope_theta))
        if paged is not None:
            paged.index(active_slots, at[1][active_slots])
    lcs = _layer_caches(cache) if paged is None else None
    for i, (lp, window) in enumerate(zip(params.layers, window_list(cfg), strict=True)):
        lc = lcs[i] if paged is None else paged.view(i)
        hn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        if cfg.mixer == "attn":
            mix = _attn_decode(lp["attn"], hn, lc, pos, window, cfg, dtype, at)
        elif cfg.mixer == "ssd":
            mix, state = ssd_decode_step(lp["ssd"], hn, lc["ssd_state"], cfg, policy)
            lc["ssd_state"].copy_(state)
        else:
            a = _attn_decode(lp["attn"], hn, lc, pos, window, cfg, dtype, at)
            s, state = ssd_decode_step(lp["ssd"], hn, lc["ssd_state"], cfg, policy)
            lc["ssd_state"].copy_(state)
            mix = 0.5 * (a + s)
        if paged is not None:
            paged.commit(i, lc)
        h = h + mix
        if "ffn" in lp:
            f, _ = _ffn(lp["ffn"], rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg, dtype, router_dtype)
            h = h + f
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    logits = _head(params, h, head_dtype)
    cache["step"] += 1
    return logits


def _attn_prefill_chunk(ap, h, lc, q_pos, rows, window, cfg: LMArchConfig, dtype):
    """h: (B, K, d), a chunk of K tokens a slot.  Writes the chunk's valid
    KVs into the cache (``rows``: (slot, chunk index, ring row) of each
    valid token, and the RoPE (cos, sin) at ``q_pos``), then attends every chunk query against the updated
    cache (write, then attend).  Masked cache columns contribute an exact
    0.0, so a chunk's rows equal feeding its tokens one a tick, as long as
    the chunk does not wrap a ring over rows an in-chunk query still
    needs (the engine clamps SWA chunks)."""
    B, K, _ = h.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    vb, vj, ws, cs = rows
    if cfg.mla_kv_lora:
        dn, dv = cfg.mla_nope_dim, cfg.mla_v_dim
        q = split_heads(dense(h, ap["wq"], dtype), H, -1)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q = torch.cat([q_nope.transpose(1, 2), rotate(q_rope.transpose(1, 2), cs)], dim=-1)
        c_kv = dense(h, ap["w_dkv"], dtype)                             # (B, K, r)
        k_r = rotate(dense(h, ap["w_kr"], dtype)[:, None], cs)[:, 0]    # (B, K, dr)
        write_rows(lc["c_kv"], vb, ws, c_kv[vb, vj].to(lc["c_kv"].dtype))
        write_rows(lc["k_rope"], vb, ws, k_r[vb, vj].to(lc["k_rope"].dtype))
        write_rows(lc["kv_pos"], vb, ws, q_pos[vb, vj].to(torch.int32))
        k_full, v_full = _mla_expand(ap, lc, B, cfg, dtype)
        o = chunk_attention(q, k_full, v_full, lc["kv_pos"], q_pos, window)
        o = o.transpose(1, 2).reshape(B, K, H * dv)
    else:
        q = split_heads(dense(h, ap["wq"], dtype), H, hd).transpose(1, 2)
        k = split_heads(dense(h, ap["wk"], dtype), Hk, hd).transpose(1, 2)
        v = split_heads(dense(h, ap["wv"], dtype), Hk, hd)
        q = rotate(q, cs)
        k = rotate(k, cs).transpose(1, 2)                               # (B, K, Hk, hd)
        write_rows(lc["k"], vb, ws, k[vb, vj].to(lc["k"].dtype), row_dim=2)
        write_rows(lc["v"], vb, ws, v[vb, vj].to(lc["v"].dtype), row_dim=2)
        write_rows(lc["kv_pos"], vb, ws, q_pos[vb, vj].to(torch.int32))
        o = chunk_attention(q, lc["k"].to(dtype), lc["v"].to(dtype), lc["kv_pos"], q_pos,
                            window)
        o = o.transpose(1, 2).reshape(B, K, H * hd)
    return dense(o, ap["wo"], dtype)


def _ssd_prefill_chunk(sp, h, state, valid, cfg: LMArchConfig, policy):
    """The one-token SSD recurrence over the K chunk positions, the state
    kept for padding tokens: equal to feeding the chunk token by token."""
    ys = []
    for j in range(h.shape[1]):
        y_j, new_state = ssd_decode_step(sp, h[:, j], state, cfg, policy)
        state = torch.where(valid[:, j, None, None, None], new_state, state)
        ys.append(y_j)
    return torch.stack(ys, dim=1), state


def lm_prefill_chunk(
    params: LM,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,    # (B, K) next chunk of token ids a slot
    n_valid: torch.Tensor,   # (B,) valid prefix length a slot (0..K)
    cfg: LMArchConfig,
    policy: PrecisionPolicy = FULL,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One chunked-prefill step: consume up to K pending tokens a slot in
    one pass, writing their KVs and SSD state into the cache in place, and
    return the logits at each slot's last valid token (B, V) f32.

    A slot with ``n_valid == 0`` is untouched (no writes, clock kept); a
    slot with ``n_valid == 1`` behaves as one ``lm_decode_step`` tick."""
    with _grad_off(cache):
        return _prefill_chunk(params, cache, tokens, n_valid, cfg, policy), cache


def _prefill_chunk(params, cache, tokens, n_valid, cfg, policy, paged=None):
    """The chunk step's body over a dense cache, or over ``paged``'s
    per-layer views (the valid tokens' rows written back)."""
    dtype, router_dtype, head_dtype = _dtypes(policy)
    B, K = tokens.shape
    dev = tokens.device
    pos0 = cache["step"]                                  # (B,)
    j = torch.arange(K, device=dev)
    q_pos = pos0.long()[:, None] + j[None, :]             # (B, K)
    rows = None
    if "kv_pos" in cache:
        W = cache["kv_pos"].shape[-1] if paged is None else paged.width
        # the valid tokens' (slot, chunk index), found where n_valid lives:
        # no device sync when the caller passes it on the CPU
        jn = torch.arange(K, device=n_valid.device)
        vb, vj = (jn[None, :] < n_valid[:, None]).nonzero(as_tuple=True)
        vb, vj = vb.to(dev), vj.to(dev)
        rows = (vb, vj, torch.remainder(q_pos[vb, vj], W),
                rope_cs(q_pos[:, None, :], _rope_dim(cfg), cfg.rope_theta))
        if paged is not None:
            paged.index(vb, rows[2])
    n_valid = n_valid.to(dev)
    valid = j[None, :] < n_valid[:, None]                 # (B, K)

    h = embed_rows(params.embed, tokens).to(dtype)                    # (B, K, d)
    h = torch.where(valid[..., None], h, 0)               # padding rows inert

    lcs = _layer_caches(cache) if paged is None else None
    for i, (lp, window) in enumerate(zip(params.layers, window_list(cfg), strict=True)):
        lc = lcs[i] if paged is None else paged.view(i)
        hn = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        if cfg.mixer == "attn":
            mix = _attn_prefill_chunk(lp["attn"], hn, lc, q_pos, rows, window, cfg, dtype)
        elif cfg.mixer == "ssd":
            mix, state = _ssd_prefill_chunk(lp["ssd"], hn, lc["ssd_state"], valid, cfg, policy)
            lc["ssd_state"].copy_(state)
        else:
            a = _attn_prefill_chunk(lp["attn"], hn, lc, q_pos, rows, window, cfg, dtype)
            s, state = _ssd_prefill_chunk(lp["ssd"], hn, lc["ssd_state"], valid, cfg, policy)
            lc["ssd_state"].copy_(state)
            mix = 0.5 * (a + s)
        if paged is not None:
            paged.commit(i, lc)
        h = h + mix
        if "ffn" in lp:
            f, _ = _ffn(lp["ffn"], rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg, dtype, router_dtype)
            h = h + f
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    # only each slot's last valid position seeds generation
    last = torch.clamp(n_valid.long() - 1, 0, K - 1)
    logits = _head(params, h[torch.arange(B, device=dev), last], head_dtype)
    cache["step"] += n_valid.to(torch.int32)
    return logits


# ---------------------------------------------------------------------------
# Paged KV cache (block-table gather, then a scatter of the written rows)
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: LMArchConfig, batch: int, num_blocks: int, block_size: int,
                     max_len: int, dtype=torch.float32,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The paged decode cache on ``device``: KV rows live in ``num_blocks``
    fixed-size blocks instead of per-slot ``(batch, W)`` strips.  One
    physical block id addresses all L layers at once, so a block table is
    one ``(batch, W // block_size)`` array shared by every layer: k and v
    ``(L, Nb, Hk, bs, hd)``, MLA's ``c_kv`` and ``k_rope`` ``(L, Nb, bs,
    r)``, ``kv_pos`` ``(L, Nb, bs)``.

    Block 0 is the *null block*: its ``kv_pos`` stays -1, so unallocated
    table entries gather an all-masked view.  ``ssd_state`` (O(1)
    recurrent state) is not paged: a dense per-slot array as in
    :func:`init_cache`."""
    dev = resolve_device(device)
    L = cfg.n_layers
    cache = {"step": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.mixer in ("attn", "hymba"):
        W = max_len if cfg.attn_window <= 0 else min(max_len, cfg.attn_window)
        if W % block_size:
            raise ValueError(f"cache width {W} (max_len/window) must be a multiple of "
                             f"block_size {block_size}")
        if cfg.mla_kv_lora:
            cache["c_kv"] = torch.zeros((L, num_blocks, block_size, cfg.mla_kv_lora), dtype=dtype,
                                        device=dev)
            cache["k_rope"] = torch.zeros((L, num_blocks, block_size, cfg.mla_rope_dim),
                                          dtype=dtype, device=dev)
        else:
            shape = (L, num_blocks, cfg.n_kv_heads, block_size, cfg.hd)
            cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
            cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["kv_pos"] = torch.full((L, num_blocks, block_size), -1, dtype=torch.int32,
                                     device=dev)
    if cfg.mixer in ("ssd", "hymba"):
        cache["ssd_state"] = torch.zeros(
            (L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), device=dev)
    return cache


class _PagedViews:
    """A paged cache read through a block table: each layer's dense view is
    gathered into the exact layout, dtype and strides of the dense cache's
    layer slice (so the dense attention step runs the same kernels on it),
    the dense step writes its rows into that copy, and only the rows
    written this tick go back into the blocks.  Rows of inactive slots and
    padding tokens are never in the written set, so nothing is written
    through the null block they map to."""

    def __init__(self, cache: Dict[str, torch.Tensor], block_table: torch.Tensor):
        self.cache = cache
        self.bt = block_table.long()                      # (B, nbt)
        self.bs = cache["kv_pos"].shape[-1]
        self.width = self.bt.shape[1] * self.bs
        if "k" in cache:
            self.heads = torch.arange(cache["k"].shape[2], device=self.bt.device)[None, :, None]

    def index(self, vb: torch.Tensor, rows: torch.Tensor) -> None:
        """The rows this tick writes: slot ``vb`` at ring row ``rows``, and
        their (block, offset) in the block arrays, once a tick."""
        self.vb, self.rows = vb, rows
        self.wb = self.bt[vb, rows // self.bs]
        self.wo = torch.remainder(rows, self.bs)

    def view(self, i: int) -> Dict[str, torch.Tensor]:
        c, bt = self.cache, self.bt
        B, W = bt.shape[0], self.width
        lc = {"kv_pos": c["kv_pos"][i][bt].view(B, W)}
        if "c_kv" in c:
            for k in ("c_kv", "k_rope"):
                lc[k] = c[k][i][bt].contiguous().view(B, W, c[k].shape[-1])
        else:
            for k in ("k", "v"):
                g = c[k][i][bt[:, None, :], self.heads]  # (B, Hk, nbt, bs, hd)
                lc[k] = g.contiguous().view(B, g.shape[1], W, g.shape[-1])
        if "ssd_state" in c:
            lc["ssd_state"] = c["ssd_state"][i]
        return lc

    def commit(self, i: int, lc: Dict[str, torch.Tensor]) -> None:
        c, vb, rows, wb, wo = self.cache, self.vb, self.rows, self.wb, self.wo
        c["kv_pos"][i][wb, wo] = lc["kv_pos"][vb, rows]
        if "c_kv" in c:
            for k in ("c_kv", "k_rope"):
                c[k][i][wb, wo] = lc[k][vb, rows]
        else:
            for k in ("k", "v"):
                c[k][i][wb, :, wo] = lc[k][vb, :, rows]


@torch.inference_mode()
def lm_paged_decode_step(
    params: LM,
    cache: Dict[str, torch.Tensor],
    block_table: torch.Tensor,   # (B, W // block_size) physical block ids
    active: torch.Tensor,        # (B,) bool: the slot holds a live request
    tokens: torch.Tensor,        # (B,) next token ids
    cfg: LMArchConfig,
    policy: PrecisionPolicy = FULL,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One paged serve step: each layer's dense view gathered from the block
    arrays, the exact dense decode step on it, the written rows scattered
    back; (logits (B, V) f32, the cache updated in place).  The same shapes
    and strides as :func:`lm_decode_step` over an equally filled dense
    cache, so the same logits bit for bit.  ``active`` masks the write-back
    only; on the CPU it costs no device sync."""
    if "kv_pos" not in cache:
        return _decode(params, cache, tokens, cfg, policy), cache
    vb = torch.as_tensor(active).nonzero().flatten().to(tokens.device)
    logits = _decode(params, cache, tokens, cfg, policy,
                     _PagedViews(cache, block_table.to(tokens.device)), vb)
    return logits, cache


@torch.inference_mode()
def lm_paged_prefill_chunk(
    params: LM,
    cache: Dict[str, torch.Tensor],
    block_table: torch.Tensor,   # (B, W // block_size) physical block ids
    tokens: torch.Tensor,        # (B, K) next chunk of token ids a slot
    n_valid: torch.Tensor,       # (B,) valid prefix length a slot (0..K)
    cfg: LMArchConfig,
    policy: PrecisionPolicy = FULL,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Paged chunked prefill: the block-table twin of
    :func:`lm_prefill_chunk` (gather the view, the exact dense chunk step,
    scatter the valid tokens' rows).  A slot with ``n_valid == 0`` neither
    writes nor advances."""
    paged = (_PagedViews(cache, block_table.to(tokens.device)) if "kv_pos" in cache else None)
    return _prefill_chunk(params, cache, tokens, n_valid, cfg, policy, paged), cache
