"""Step builders: per (architecture x shape), the step function, its
input placeholders and the specs that place them on a mesh.

``build_train_step`` makes a full optimizer step (forward, backward and
the port's AdamW update, each layer recomputed in the backward) so a
dry-run's memory covers params, moments and the activation working set;
``build_prefill_step`` the forward; ``build_decode_step`` one serve step
against a seq_len KV cache; ``build_prefill_chunk_step`` the serve
engine's chunked-prefill step; ``build_fno_train_step`` the FNO family's
train step, on one device or data-parallel on a mesh.

Placeholders are meta tensors (the counterpart of the reference's
``ShapeDtypeStruct``s and ``jax.eval_shape``): the parameters are the
model built on the meta device, the optimizer state and the caches are
made from them on the meta device.  The dry-runs turn them into fake
tensors placed by :func:`bundle_shardings`; a real run passes real ones.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LMArchConfig, ShapeConfig
from repro_torch.models.lm import (
    LM,
    Whisper,
    init_cache,
    init_whisper_cache,
    lm_decode_step,
    lm_forward,
    lm_prefill_chunk,
    whisper_decode_step,
    whisper_encode,
    whisper_forward,
)
from repro_torch.optim import AdamW, AdamWState
from repro_torch.precision import AMP_BF16, PrecisionPolicy
from repro_torch.train.losses import cross_entropy

META = torch.device("meta")


@dataclasses.dataclass
class StepBundle:
    """Everything a dry-run needs to trace one cell."""
    step_fn: Callable
    inputs: Dict[str, Any]             # name -> meta tensor tree
    params_shape: Any                  # the model on the meta device
    extra_state_shape: Dict[str, Any]  # opt state / cache, meta tensors
    description: str
    #: True when step_fn returns an autoprec telemetry snapshot as its
    #: trailing output (bundle_shardings leaves its placement unspecified)
    telemetry: bool = False


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def params_shape(cfg: LMArchConfig) -> torch.nn.Module:
    """The parameters without allocating: the model on the meta device."""
    return Whisper(cfg) if cfg.encoder_decoder else LM(cfg)


def _named(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params


def _loss_fn(cfg: LMArchConfig, policy: PrecisionPolicy):
    if cfg.encoder_decoder:
        def loss(params, batch):
            logits = whisper_forward(params, batch["frames"], batch["dec_tokens"],
                                     cfg, policy, remat=True)
            return cross_entropy(logits, batch["dec_labels"])
        return loss
    if cfg.frontend == "vision_stub":
        def loss(params, batch):
            logits, aux = lm_forward(params, batch["tokens"], cfg, policy,
                                     patch_embeds=batch["patch_embeds"], remat=True)
            return cross_entropy(logits, batch["labels"], start=cfg.n_patches) + 0.01 * aux
        return loss

    def loss(params, batch):
        logits, aux = lm_forward(params, batch["tokens"], cfg, policy, remat=True)
        return cross_entropy(logits, batch["labels"]) + 0.01 * aux
    return loss


def train_inputs(cfg: LMArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.encoder_decoder:
        T = cfg.max_dec_len
        return {
            "frames": _sds((B, S, cfg.d_model), torch.bfloat16),
            "dec_tokens": _sds((B, T), torch.int32),
            "dec_labels": _sds((B, T), torch.int32),
        }
    if cfg.frontend == "vision_stub":
        S_text = S - cfg.n_patches
        return {
            "tokens": _sds((B, S_text), torch.int32),
            "labels": _sds((B, S_text), torch.int32),
            "patch_embeds": _sds((B, cfg.n_patches, cfg.d_model), torch.bfloat16),
        }
    return {
        "tokens": _sds((B, S), torch.int32),
        "labels": _sds((B, S), torch.int32),
    }


def _opt_shape(opt: AdamW, params) -> AdamWState:
    named = _named(params)
    zeros = {k: torch.empty(p.shape, dtype=torch.float32, device=META) for k, p in named.items()}
    return AdamWState(count=_sds((), torch.int32), mu=zeros,
                      nu={k: torch.empty_like(v) for k, v in zeros.items()})


def _grads(loss: torch.Tensor, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d every parameter (zeros where a parameter is unused)."""
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named.items(), gs, strict=True)}


def _placed_grads(loss: torch.Tensor, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """:func:`_grads`, each gradient of a parameter on a mesh of more than
    one rank brought to the parameter's placements as the backward
    produces it (a hook on the parameter): a reduce-scatter where the
    parameter is sharded, an all-reduce where it is replicated, summed in
    f32.  No rank then holds a whole weight's gradient, nor all of them at
    once.  Elsewhere this is :func:`_grads`."""
    from torch.distributed.tensor import DTensor

    handles = [p.register_hook(functools.partial(_to_placements, p)) for p in named.values()
               if isinstance(p, DTensor) and p.device_mesh.size() > 1 and p.requires_grad]
    try:
        return _grads(loss, named)
    finally:
        for h in handles:
            h.remove()


def _to_placements(p, g):
    if tuple(g.placements) == tuple(p.placements):
        return g
    return g.to(torch.float32).redistribute(p.device_mesh, p.placements).to(g.dtype)


@torch.no_grad()
def _assign(params, new: Dict[str, torch.Tensor]) -> None:
    for k, p in _named(params).items():
        p.copy_(new[k])


def build_train_step(cfg: LMArchConfig, shape: ShapeConfig,
                     policy: PrecisionPolicy = AMP_BF16,
                     optimizer: Optional[AdamW] = None,
                     telemetry: bool = False) -> StepBundle:
    """``step_fn(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss, its gradients (each layer recomputed in the backward) and
    the port's AdamW update, written into ``params`` and ``opt_state`` in
    place a leaf at a time (``AdamW.update_``; the model and the state
    object themselves are returned, as the reference's step donates its
    own).  ``telemetry=True``: the autoprec-instrumented
    twin, the collector's snapshot of the loss's taps as a trailing
    output."""
    opt = optimizer or AdamW(lr=1e-4)
    loss_fn = _loss_fn(cfg, policy)

    def train_step(params, opt_state, batch):
        named = _named(params)
        if telemetry:
            from repro_torch.autoprec import TraceCollector, collecting

            col = TraceCollector()
            with collecting(col):
                loss = loss_fn(params, batch)
        else:
            loss = loss_fn(params, batch)
        grads = _placed_grads(loss, named)
        opt_state = opt.update_(grads, opt_state, {k: p.detach() for k, p in named.items()})
        if telemetry:
            return params, opt_state, loss.detach(), col.snapshot()
        return params, opt_state, loss.detach()

    p_shape = params_shape(cfg)
    return StepBundle(
        step_fn=train_step,
        inputs={"batch": train_inputs(cfg, shape)},
        params_shape=p_shape,
        extra_state_shape={"opt_state": _opt_shape(opt, p_shape)},
        description=f"train_step {cfg.name} {shape.name}"
                    + (" [telemetry]" if telemetry else ""),
        telemetry=telemetry,
    )


def build_prefill_step(cfg: LMArchConfig, shape: ShapeConfig,
                       policy: PrecisionPolicy = AMP_BF16) -> StepBundle:
    B, S = shape.global_batch, shape.seq_len
    if cfg.encoder_decoder:
        @torch.no_grad()
        def prefill(params, batch):
            return whisper_encode(params, batch["frames"], cfg, policy)
        inputs = {"batch": {"frames": _sds((B, S, cfg.d_model), torch.bfloat16)}}
    elif cfg.frontend == "vision_stub":
        @torch.no_grad()
        def prefill(params, batch):
            logits, _ = lm_forward(params, batch["tokens"], cfg, policy,
                                   patch_embeds=batch["patch_embeds"])
            return logits[:, -1]
        inputs = {"batch": {
            "tokens": _sds((B, S - cfg.n_patches), torch.int32),
            "patch_embeds": _sds((B, cfg.n_patches, cfg.d_model), torch.bfloat16),
        }}
    else:
        @torch.no_grad()
        def prefill(params, batch):
            logits, _ = lm_forward(params, batch["tokens"], cfg, policy)
            return logits[:, -1]
        inputs = {"batch": {"tokens": _sds((B, S), torch.int32)}}
    return StepBundle(
        step_fn=prefill,
        inputs=inputs,
        params_shape=params_shape(cfg),
        extra_state_shape={},
        description=f"prefill {cfg.name} {shape.name}",
    )


def _kv_dtype(policy: PrecisionPolicy) -> torch.dtype:
    return policy.at("serve/kv_cache").compute_dtype


def build_decode_step(cfg: LMArchConfig, shape: ShapeConfig,
                      policy: PrecisionPolicy = AMP_BF16) -> StepBundle:
    B, S = shape.global_batch, shape.seq_len
    p_shape = params_shape(cfg)
    if cfg.encoder_decoder:
        # decode against a seq_len-frame encoder memory (cross-KV cached)
        cache_shape = init_whisper_cache(p_shape, _sds((B, S, cfg.d_model), torch.bfloat16),
                                         cfg, B, policy)

        def serve_step(params, cache, tokens):
            return whisper_decode_step(params, cache, tokens, cfg, policy)
    else:
        cache_shape = init_cache(cfg, B, S, dtype=_kv_dtype(policy), device=META)

        def serve_step(params, cache, tokens):
            return lm_decode_step(params, cache, tokens, cfg, policy)

    return StepBundle(
        step_fn=serve_step,
        inputs={"cache": cache_shape, "tokens": _sds((B,), torch.int32)},
        params_shape=p_shape,
        extra_state_shape={},
        description=f"serve_step {cfg.name} {shape.name} (KV len {S})",
    )


def build_prefill_chunk_step(cfg: LMArchConfig, shape: ShapeConfig,
                             policy: PrecisionPolicy = AMP_BF16,
                             chunk: int = 16) -> StepBundle:
    """The serve engine's chunked-prefill step against a seq_len KV cache:
    (B, chunk) pending prompt tokens with per-slot valid lengths (on the
    host, as the engine passes them).  What a prefill-heavy serving tick
    runs: the dry-run records it next to the one-token decode step."""
    if cfg.encoder_decoder:
        raise ValueError("chunked prefill targets the decoder-only cache path")
    B, S = shape.global_batch, shape.seq_len

    def chunk_step(params, cache, tokens, n_valid):
        return lm_prefill_chunk(params, cache, tokens, n_valid, cfg, policy)

    return StepBundle(
        step_fn=chunk_step,
        inputs={"cache": init_cache(cfg, B, S, dtype=_kv_dtype(policy), device=META),
                "tokens": _sds((B, chunk), torch.int32),
                "n_valid": torch.full((B,), chunk, dtype=torch.int32)},
        params_shape=params_shape(cfg),
        extra_state_shape={},
        description=f"prefill_chunk[{chunk}] {cfg.name} {shape.name} (KV len {S})",
    )


def build_step(cfg: LMArchConfig, shape: ShapeConfig,
               policy: PrecisionPolicy = AMP_BF16) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, shape, policy)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, policy)
    return build_decode_step(cfg, shape, policy)


# ---------------------------------------------------------------------------
# Placement derivation: every consumer of a StepBundle (dry-run, launch,
# serving) gets its specs from the repro_torch.dist rule tables here.
# ---------------------------------------------------------------------------


def opt_specs(opt_shape: Any, param_specs: Dict[str, tuple]) -> AdamWState:
    """Optimizer-state specs mirror the parameter specs (AdamW moments are
    param-shaped; the step count replicates)."""
    del opt_shape  # structure is implied by AdamWState
    return AdamWState(count=(), mu=dict(param_specs), nu=dict(param_specs))


def bundle_shardings(bundle: StepBundle, cfg: LMArchConfig, mesh,
                     param_specs: Any = None) -> Tuple[Any, Any]:
    """(in_specs, out_specs) for ``bundle.step_fn``'s arguments and
    results on ``mesh``, derived entirely from the ``repro_torch.dist``
    rule tables: ``to_placements(mesh, spec)`` gives a leaf's DTensor
    placements, ``distribute(tree, mesh, specs)`` places a tree by them.
    An out spec of None is left to the step (the logits; the telemetry
    snapshot).  ``param_specs`` lets a caller that already derived the
    parameter specs pass them in."""
    from repro_torch.dist.sharding import batch_specs, cache_specs, lm_param_specs

    if param_specs is None:
        param_specs = lm_param_specs(bundle.params_shape, mesh)
    if "opt_state" in bundle.extra_state_shape:       # train step
        o_specs = opt_specs(bundle.extra_state_shape["opt_state"], param_specs)
        b_specs = batch_specs(bundle.inputs["batch"], mesh)
        outs = (param_specs, o_specs, ())
        if bundle.telemetry:                           # trailing snapshot
            outs = outs + (None,)
        return (param_specs, o_specs, b_specs), outs
    if "cache" in bundle.inputs:                      # decode / prefill-chunk
        c_specs = cache_specs(bundle.inputs["cache"], mesh, cfg)
        t_specs = batch_specs(bundle.inputs["tokens"], mesh)
        if "n_valid" in bundle.inputs:                # stays on the host
            return (param_specs, c_specs, t_specs, None), (None, c_specs)
        return (param_specs, c_specs, t_specs), (None, c_specs)
    b_specs = batch_specs(bundle.inputs["batch"], mesh)
    return (param_specs, b_specs), None               # prefill


# ---------------------------------------------------------------------------
# The FNO family's data-parallel train step
# ---------------------------------------------------------------------------


def batch_axes(mesh, shape) -> Tuple[str, ...]:
    """The mesh axes a (B, C, *spatial) batch is sharded over by
    ``constrain_spatial``'s rule: every axis when B covers the mesh, else
    the data axes (those that divide B).  On a one-rank mesh too: its
    reductions then run over groups of one."""
    from repro_torch.dist.constrain import _resolve_spec, logical_axis_size

    B = shape[0]
    entry = ("dp", "tp") if B % logical_axis_size("all", mesh) == 0 else "dp"
    spec = _resolve_spec((B,), (entry,), mesh)
    if spec is None:
        return ()
    return (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])


def channel_axis(mesh, shape, width: int) -> Optional[str]:
    """The mesh axis the FNO family's hidden channels (``width`` of them)
    split over for a (B, C, *spatial) batch of ``shape``:
    ``constrain_spatial``'s fallback, the tp axis, where B does not cover
    the mesh and the axis divides the width; None where the batch covers
    the mesh, the axis is a single rank, or nothing divides."""
    from repro_torch.dist.constrain import _resolve_spec, logical_axis_size

    B = shape[0]
    if B % logical_axis_size("all", mesh) == 0:
        return None
    spec = _resolve_spec((B, width), ("dp", "tp"), mesh)
    ax = None if spec is None else spec[1]
    if isinstance(ax, tuple):
        if len(ax) != 1:
            raise ValueError(f"the channels resolve to {len(ax)} mesh axes {ax}; "
                             f"the step splits them over one")
        ax = ax[0]
    if ax is None or int(mesh.shape[tuple(mesh.mesh_dim_names).index(ax)]) <= 1:
        return None
    return ax


def channel_blocks(model) -> Dict[str, Optional[int]]:
    """The FNO/TFNO/SFNO parameters whose gradients differ between the
    ranks of tp when the hidden channels split, name -> dim: a rank holds
    only its block of the output channels of the spectral weights' O
    (dense ``w_re``/``w_im`` (L, corners, I, O, *modes), SFNO's (L, I, O,
    lmax), the CP and Tucker ``U_o`` rows (L, corners, O, R)) and of the
    skip's bias (``skips.b`` (L, H)), and of the input channels of the
    skip's weight (``skips.w`` (L, I, O): the rank's partial product over
    its input block is summed over tp, ``models.fno.skip``); None for a
    factor every rank holds whole but contracts against its own output
    block only (CP ``lam``, ``U_i`` and the mode factors, the Tucker core,
    ``U_i`` and mode factors), whose gradient is a partial sum.  Lifting
    and projection are not listed: every rank of tp computes them whole."""
    from repro_torch.models.sfno import SFNO

    out: Dict[str, Optional[int]] = {"skips.w": 1, "skips.b": 1}
    for name in model.spectral:
        if isinstance(model, SFNO):
            out[f"spectral.{name}"] = 2
        elif name in ("w_re", "w_im"):
            out[f"spectral.{name}"] = 3
        else:
            out[f"spectral.{name}"] = 2 if name.startswith("U_o_") else None
    return out


def fno_batch_specs(batch: Any, mesh) -> Any:
    """The full-DP input layout: each leaf's batch dim over the axes
    :func:`batch_axes` gives, the rest whole.  The leaves' channels stay
    whole; where the batch does not cover the mesh the step splits the
    model's hidden channels over tp (:func:`build_fno_train_step`)."""
    from repro_torch.dist.sharding import tree_map_with_path

    def spec(_, leaf):
        axes = batch_axes(mesh, tuple(leaf.shape))
        if not axes:
            return ()
        return ((axes[0] if len(axes) == 1 else axes),) + (None,) * (leaf.ndim - 1)

    return tree_map_with_path(spec, batch)


def build_fno_train_step(policy: PrecisionPolicy, mesh=None, optimizer: Optional[AdamW] = None,
                         loss_fn: Optional[Callable] = None, grad_reduce: Optional[Callable] = None
                         ) -> Callable:
    """``step(model, opt_state, batch) -> (model, opt_state, loss)`` for the
    FNO family (FNO, TFNO, SFNO), the full-DP layout of the reference's
    dry-run made explicit.

    ``mesh=None``: one device; the loss (``relative_l2`` unless
    ``loss_fn``) over the batch, its gradients, the port's AdamW, written
    into the model in place.

    On a mesh, the parameters are DTensors placed by ``fno_param_specs``
    (the optimizer state alike) and the batch leaves DTensors placed by
    :func:`fno_batch_specs`.  Each rank takes its share of the batch
    (``constrain_spatial``'s rule); a parameter sharded over ``model`` is
    gathered whole before the forward; the forward and backward run on
    plain local tensors (so the spectral kernels launch as they do off a
    mesh); each gradient is summed in f32 into its parameter's placement,
    over every axis that carries the batch (an all-reduce, or a
    reduce-scatter onto a shard), and divided by the number of batch
    shards, so it is the gradient of the batch-mean loss; the update runs
    on the DTensors.

    Where the batch does not cover the mesh, the ranks of the model axis
    hold the same batch share, and the hidden channels split over that
    axis (:func:`channel_axis`; the reference's "batch over dp, channels
    over tp").  The forward and backward then run in a
    ``dist.channels`` scope over the axis: each rank takes its block of
    the spectral and skip weights (:func:`channel_blocks`, sliced from the
    whole weight; the parameters keep their placements), the lifting runs
    whole and its output is split, the spectra are gathered over tp, the
    skips' partial products reduce-scattered, and the projection runs
    whole on the gathered channels.  Before the batch sums, each spectral
    and skip gradient is summed over tp in f32: the blocks all-gathered,
    the factors every rank holds whole (CP, Tucker) all-reduced.  The
    lifting's and projection's gradients are the same on every rank of tp
    (the split's backward gathers the cotangent; the projection is
    repeated) and are not summed over it.
    ``grad_reduce``: replaces the f32 sum for replicated parameters (e.g.
    ``optim.grad_comm.make_dp_allreduce``'s bf16 all-reduce, which also
    divides)."""
    from repro_torch.train.losses import relative_l2

    opt = optimizer or AdamW(lr=1e-3)
    loss_fn = loss_fn or relative_l2

    if mesh is None:
        def plain_step(model, opt_state, batch):
            named = dict(model.named_parameters())
            loss = loss_fn(model(batch["x"], policy), batch["y"])
            grads = _grads(loss, named)
            new_params, new_opt = opt.update(grads, opt_state,
                                             {k: p.detach() for k, p in named.items()})
            _assign(model, new_params)
            return model, new_opt, loss.detach()
        return plain_step

    import contextlib

    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.func import functional_call

    from repro_torch.dist import channels

    names = tuple(mesh.mesh_dim_names)

    def group(ax):
        return mesh.get_group(ax)

    def size(ax):
        return int(mesh.shape[names.index(ax)])

    def wait(t):
        return funcol.wait_tensor(t) if isinstance(t, funcol.AsyncCollectiveTensor) else t

    def dp_step(model, opt_state, batch):
        x, y = batch["x"].to_local(), batch["y"].to_local()
        axes = batch_axes(mesh, tuple(batch["x"].shape))
        n_shards = 1
        for ax in axes:
            n_shards *= size(ax)
        ch_ax = channel_axis(mesh, tuple(batch["x"].shape), model.cfg.hidden_channels)
        named = dict(model.named_parameters())
        with channels.channel_scope(group(ch_ax), mesh.get_local_rank(ch_ax), size(ch_ax)) \
                if ch_ax else contextlib.nullcontext() as scope:
            blocks = channel_blocks(model) if scope else {}
            full = {}
            for k, p in named.items():
                t = p.to_local()
                for i, pl in enumerate(p.placements):
                    if isinstance(pl, Shard):
                        t = funcol.all_gather_tensor(t, pl.dim, group(names[i]))
                t = wait(t)
                if blocks.get(k) is not None:
                    t = channels.block_of(t, blocks[k], scope).contiguous()
                full[k] = t.detach().requires_grad_()
            loss = loss_fn(functional_call(model, full, (x,), {"policy": policy}), y)
            g_full = _grads(loss, full)
        for k, dim in blocks.items():       # the sum over tp of each rank's part
            g = g_full[k].float().contiguous()
            g_full[k] = wait(funcol.all_reduce(g, "sum", scope.group) if dim is None
                             else funcol.all_gather_tensor(g, dim, scope.group))
        grads = {}
        replicated = [k for k, p in named.items()
                      if not any(isinstance(pl, Shard) for pl in p.placements)]
        if grad_reduce is not None:
            reduced = grad_reduce({k: g_full[k] for k in replicated})
        for k, p in named.items():
            g = g_full[k].float()
            if k in replicated and grad_reduce is not None:
                g = reduced[k]
            else:
                for i, pl in enumerate(p.placements):
                    ax = names[i]
                    if isinstance(pl, Shard):
                        if ax in axes:
                            g = funcol.reduce_scatter_tensor(g, "sum", pl.dim, group(ax))
                        else:
                            g = g.chunk(size(ax), dim=pl.dim)[mesh.get_coordinate()[i]]
                    elif ax in axes:
                        g = funcol.all_reduce(g, "sum", group(ax))
                g = wait(g) / n_shards
            grads[k] = DTensor.from_local(g.to(p.dtype), mesh, p.placements, run_check=False,
                                          shape=p.shape, stride=p.stride())
        total = loss.detach()
        for ax in axes:
            total = funcol.all_reduce(total, "sum", group(ax))
        total = wait(total)
        # the optimizer state's step count is a plain tensor beside DTensors
        with implicit_replication():
            new_params, new_opt = opt.update(grads, opt_state,
                                             {k: p.detach() for k, p in named.items()})
            _assign(model, new_params)
        return model, new_opt, total / n_shards

    return dp_step
