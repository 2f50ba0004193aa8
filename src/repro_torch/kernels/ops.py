"""Host wrappers the model code calls around the kernels.

``spectral_contract`` splits the complex spectrum into split-real f32
operands, flattens the modes, picks the storage rounding from the
contract site's rule and hands the operands to ``DenseContract``, the
autograd Function that launches the CUDA kernels for CUDA tensors and
runs the plain versions for CPU tensors, forward and backward.
``spectral_contract_cp`` folds the CP mode factor, rounds every operand
to the site's storage dtype outside the kernels (differentiably, so the
gradients come back to f32 through the casts) and hands them to
``CPContract``.  ``spectral_contract_lshared`` does the same for the
SFNO's order-shared contraction and ``LSharedContract``.
``spectral_conv_fused`` runs a dense Fourier layer's whole rFFT ->
contract -> irFFT pipeline through ``FusedSpectral``, on the weight that
``gather_corner_weights`` lays out; ``resolve_fuse_spectral`` and
``fused_spectral_viable`` decide, from the device, shapes, policy and
whether an autoprec collector is active, when ``core.spectral`` takes it.
The three contraction wrappers tap their spectrum at the contract site, as
``SitePrecision.contract`` does on the einsum path, and call their Function
inside ``site_scope`` of that site (``spectral_conv_fused``: of its contract
site), so ``repro_torch.analyze`` attributes the launches, forward and
backward, to it.  ``flash_attention``
and ``rmsnorm`` are the LM pool's substrate kernels behind the reference's
entry points; no model calls them.

Tile resolution (the reference's ``_resolve_blocks``): the two families
whose kernels take a launch tile, the fused layer (its batch tile per
direction) and the order-shared contraction (``ls_mix``'s splits per
direction), consult the active ``repro_torch.tune`` calibration cache on
every call; a missing, stale, corrupt or illegal entry leaves the
heuristics' tiles (``pick_block_b``, ``ls_plan``), so with no state every
launch is the same as without the tuner.  Every spectral wrapper counts
its calls in the obs registry (``repro_kernels_calls_total{family=...}``,
with the traffic model's bytes in ``repro_kernels_bytes_moved``), as do
``flash_attention`` and ``rmsnorm``.  The reference counts once per traced
shape (jit caches its wrappers' traces); the port compiles nothing, so it
counts once per call.  The kernels' own launch counts stay in
``spectral_contract.launches_*``.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.autoprec.telemetry import fmt_of, tap, telemetry_active
from repro_torch.core.precision import dtype_name
from repro_torch.obs import registry
from repro_torch.precision import FULL, PrecisionPolicy, site_scope

from . import flash_attention as _flash
from . import rmsnorm as _rmsnorm
from .spectral_contract import (
    H100_SMS,
    L2_BUDGET,
    SMEM_LIMIT,
    CPContract,
    DenseContract,
    FusedSpectral,
    LSharedContract,
    fused_rows,
    fused_scratch_bytes,
    fused_smem_bytes,
    fused_supported,
    ls_plan,
    pick_block_b,
)


def _site_of(policy, site: str):
    """Resolve a PrecisionPolicy at ``site``; pass SitePrecision through."""
    if isinstance(policy, PrecisionPolicy):
        return policy.at(site)
    return policy


# -- tile resolution and the obs counters --------------------------------------------

#: tile-resolution outcomes since process start (or the last reset), one
#: per call of a tuned wrapper
_TILE_SOURCES = {"heuristic": 0, "calibrated": 0}


@functools.lru_cache(maxsize=256)
def _bytes_moved(family: str, shape: tuple, dtype: str) -> float:
    from repro_torch.tune.measure import bytes_moved

    return float(bytes_moved(family, shape, dtype))


def _obs_kernel_call(family: str, shape: tuple, dtype) -> None:
    """Per-family call counter + bytes-moved gauge in the obs registry:
    one count per call (the reference counts per traced shape), the gauge
    the tune traffic model's HBM bytes for the last shape this family ran
    with."""
    name = dtype_name(dtype)
    reg = registry()
    reg.counter("repro_kernels_calls_total", family=family).inc()
    reg.gauge("repro_kernels_bytes_moved", family=family).set(
        _bytes_moved(family, tuple(int(s) for s in shape), name))


def heuristic_blocks(family: str, shape: Sequence[int], dtype,
                     device=None) -> Tuple[int, int]:
    """The (forward, backward) tiles the launchers take with no
    calibration entry: ``pick_block_b``'s batch tile both ways for the
    fused layer; ``ls_plan``'s splits for ``ls_fwd`` and ``ls_bwd_x`` at
    ``device``'s SM count (an H100's on the CPU)."""
    from repro_torch.tune.space import fused_axes

    if family == "spectral_fused":
        B, I, O, spatial, modes = fused_axes(shape)
        bb = pick_block_b(B, I, O, spatial, modes)
        return bb, bb
    if family == "lshared":
        B, I, O, L, M = (int(s) for s in shape)
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        dev = torch.device(device or "cpu")
        sms = (torch.cuda.get_device_properties(dev).multi_processor_count
               if dev.type == "cuda" else H100_SMS)
        return (ls_plan(I, O, dt, B=B, L=L, M=M, sms=sms).splits,
                ls_plan(O, I, dt, B=B, L=L, M=M, sms=sms).splits)
    raise ValueError(f"{family!r} has no launch tile")


def _resolve_blocks(family: str, shape: tuple, dtype,
                    heuristic: Callable[[], Tuple[int, int]], device=None):
    """Resolve (block_fwd, block_bwd, source) for one call.

    Consults the active ``repro_torch.tune`` calibration cache first
    (explicit ``tune.cache.activate(...)`` or the
    ``REPRO_CALIBRATION_STATE`` env var), keyed by the running device's
    name; an entry that is missing, stale (kernel-version or device
    mismatch), corrupt, or not a legal tile at this shape
    (``tune.space.legal_blocks``) falls back to ``heuristic()`` — tuning
    state can change a tile, never the device or the kernel.
    """
    from repro_torch.tune.cache import active_cache, backend_of
    from repro_torch.tune.space import legal_blocks

    _obs_kernel_call(family, shape, dtype)
    cache = active_cache()
    if cache is not None:
        name = dtype_name(dtype)
        ent = cache.lookup(family, shape, name, backend=backend_of(device))
        if ent is not None and \
                ent["block_fwd"] in legal_blocks(family, shape, name, "fwd") and \
                ent["block_bwd"] in legal_blocks(family, shape, name, "bwd"):
            _TILE_SOURCES["calibrated"] += 1
            return int(ent["block_fwd"]), int(ent["block_bwd"]), "calibrated"
    _TILE_SOURCES["heuristic"] += 1
    return (*heuristic(), "heuristic")


def tile_resolution_stats() -> dict:
    """Where this process's kernel tiles came from: per-source counts
    plus the active calibration cache's path and hit/miss/stale
    counters (None when no cache is active).  Surfaced by
    ``OperatorEngine.stats()``."""
    from repro_torch.tune.cache import active_cache

    cache = active_cache()
    return {
        "sources": dict(_TILE_SOURCES),
        "calibration_state": cache.path if cache is not None else None,
        "cache": dict(cache.counters) if cache is not None else None,
    }


def reset_tile_resolution_stats() -> None:
    """Zero the tile-source counters and the active calibration cache's
    hit/miss/stale counters (hygiene between warm-up and measurement).
    Registered with the obs registry below, so
    ``repro_torch.obs.registry().reset()`` covers it too."""
    from repro_torch.tune.cache import active_cache

    for k in _TILE_SOURCES:
        _TILE_SOURCES[k] = 0
    cache = active_cache()
    if cache is not None:
        for k in cache.counters:
            cache.counters[k] = 0


def _register_obs() -> None:
    registry().register_external(
        "repro_kernels_tiles", tile_resolution_stats,
        reset_tile_resolution_stats)


_register_obs()


def spectral_contract(
    x: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor, *,
    policy=FULL, site: str = "model/spectral/contract",
) -> torch.Tensor:
    """Dense spectral contraction ``bi<modes>,io<modes>->bo<modes>``.

    ``x``: complex64 (B, I, *modes).  ``w_re`` / ``w_im``: the layer's
    split-real f32 corner weight, (I, O, *modes), as the parameters hold
    it.  ``policy``: the resolved contract site, or a PrecisionPolicy
    resolved here at ``site``.

    Under a half rule the operands stay f32 and the kernel rounds them
    onto the storage grid as it loads them (the reference's fused cast);
    the product is stored at the storage dtype.  Under full precision the
    operands and the product are f32 with no rounding.  Gradients reach
    ``x``, ``w_re`` and ``w_im`` through the reference's custom VJP
    (f32, never rounded to the half grid).  Returns complex64
    (B, O, *modes).
    """
    policy = _site_of(policy, site)
    tap(policy.site, x, fmt=fmt_of(policy))
    if not torch.is_complex(x) or x.ndim < 3 or w_re.ndim != x.ndim:
        raise ValueError(
            f"spectral_contract is dense-only: expected complex x (B, I, *modes) "
            f"and real w (I, O, *modes), got {x.dtype} {tuple(x.shape)} and "
            f"{tuple(w_re.shape)}")
    B, I, *modes = x.shape
    _, O, *wmodes = w_re.shape
    if tuple(modes) != tuple(wmodes) or w_re.shape[0] != I:
        raise ValueError(
            f"spectral_contract: x {tuple(x.shape)} and w {tuple(w_re.shape)} "
            f"disagree on channels or modes")
    M = 1
    for m in modes:
        M *= m
    half = policy.spectral_dtype if policy.spectral_is_half else None
    _obs_kernel_call("dense-fused" if half else "dense", (B, I, O, M),
                     half or torch.float32)
    xr = x.real.reshape(B, I, M).contiguous()
    xi = x.imag.reshape(B, I, M).contiguous()
    with site_scope(policy.site):
        out_re, out_im = DenseContract.apply(
            xr, xi, w_re.reshape(I, O, M), w_im.reshape(I, O, M),
            half, half or torch.float32)
    return torch.complex(out_re.float(), out_im.float()).reshape(B, O, *modes)


def cp_mode_factor(lam: torch.Tensor, mode_factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fold λ (R,) and the per-axis CP factors (m_k, R) into the combined
    mode factor ``W[r, m] = λ_r Π_k U_mk[m_k, r]`` over the row-major
    flattened mode index (tiny, differentiable; the kernels never
    materialise the dense (I, O, M) weight this factor replaces)."""
    w = lam[:, None]
    for f in mode_factors:
        w = (w[:, :, None] * f.T[:, None, :]).reshape(w.shape[0], -1)
    return w


def _pair(z: torch.Tensor, dtype: torch.dtype):
    """Split-real parts of ``z`` at ``dtype``, contiguous (differentiable)."""
    return z.real.to(dtype).contiguous(), z.imag.to(dtype).contiguous()


def spectral_contract_cp(
    x: torch.Tensor, lam: torch.Tensor, ui: torch.Tensor, uo: torch.Tensor,
    mode_factors: Sequence[torch.Tensor], *, policy=FULL,
    site: str = "model/spectral/contract",
) -> torch.Tensor:
    """CP-factorised spectral contraction (TFNO, paper §4.6).

    ``x``: complex64 (B, I, *modes); ``lam``: (R,) complex CP weights;
    ``ui``/``uo``: (I, R)/(O, R) complex channel factors;
    ``mode_factors``: one (m_k, R) complex factor per mode axis.
    ``policy``: the resolved contract site, or a PrecisionPolicy resolved
    here at ``site``.

    x, U_i, U_o and the folded W are rounded to the site's storage dtype
    (f32 when it does not quantise) before the kernels, which take no
    cast; t and u stay f32 inside them and the product is stored at the
    storage dtype.  Returns complex64 (B, O, *modes).
    """
    policy = _site_of(policy, site)
    tap(policy.site, x, fmt=fmt_of(policy))
    half = policy.spectral_dtype if policy.spectral_is_half else torch.float32
    B, I, *modes = x.shape
    if len(mode_factors) != len(modes):
        raise ValueError(
            f"spectral_contract_cp: {len(mode_factors)} mode factors for "
            f"{len(modes)}-d modes {tuple(modes)}")
    M = 1
    for m in modes:
        M *= m
    w = cp_mode_factor(lam, mode_factors)  # (R, M) complex
    O, R = uo.shape
    _obs_kernel_call("cp", (B, I, O, R, M), half)

    with site_scope(policy.site):
        out_re, out_im = CPContract.apply(*_pair(x.reshape(B, I, M), half), *_pair(ui, half),
                                          *_pair(uo, half), *_pair(w, half))
    return torch.complex(out_re.float(), out_im.float()).reshape(B, O, *modes)


def spectral_contract_lshared(
    x: torch.Tensor, w: torch.Tensor, *, policy=FULL,
    site: str = "model/spectral/contract",
) -> torch.Tensor:
    """Order-shared spherical contraction ``bilm,iol->bolm`` (SFNO).

    ``x``: complex64 (B, I, L, M), the (degree, order) spherical spectrum;
    ``w``: complex (I, O, L), shared across orders m by the spherical
    convolution theorem, so the dense (I, O, L, M) weight and its gradient
    are never formed.  ``policy``: the resolved contract site, or a
    PrecisionPolicy resolved here at ``site``.

    x and w are rounded to the site's storage dtype (f32 when it does not
    quantise) before the kernels, which sum in f32 and store the product
    at that dtype.  Returns complex64 (B, O, L, M).
    """
    policy = _site_of(policy, site)
    tap(policy.site, x, fmt=fmt_of(policy))
    if x.ndim != 4 or w.ndim != 3:
        raise ValueError(
            f"spectral_contract_lshared: expected x (B, I, L, M) and w (I, O, L), "
            f"got {tuple(x.shape)} and {tuple(w.shape)}")
    half = policy.spectral_dtype if policy.spectral_is_half else torch.float32
    B, I, L, M = x.shape
    key = (B, I, w.shape[1], L, M)
    splits_fwd, splits_bwd, _src = _resolve_blocks(
        "lshared", key, half, lambda: heuristic_blocks("lshared", key, half, x.device),
        x.device)
    with site_scope(policy.site):
        out_re, out_im = LSharedContract.apply(*_pair(x, half), *_pair(w, half),
                                               splits_fwd, splits_bwd)
    return torch.complex(out_re.float(), out_im.float())


# -- the fused spectral layer ------------------------------------------------------

def resolve_fuse_spectral(flag: Optional[bool], device) -> bool:
    """Resolve the tri-state ``fuse_spectral`` setting.  An explicit
    True/False wins; ``None`` is on for a CUDA tensor and off for a CPU
    tensor, as the reference's auto is on where its kernels compile (the
    TPU) and off on the CPU.  The reference's ``REPRO_FUSE_SPECTRAL``
    switch has no counterpart: ``FNOConfig.fuse_spectral`` carries the
    choice."""
    if flag is not None:
        return bool(flag)
    return torch.device(device).type == "cuda"


def fused_spectral_viable(fft_in, ctr, I: int, O: int, spatial: Sequence[int],
                          modes: Sequence[int]) -> bool:
    """Can this dense layer run the fused kernels?  The reference's vetoes
    (``repro.kernels.ops.fused_spectral_viable``) with the H100's budgets:
    the shape must suit the truncated-DFT factor layout on at most 3 axes,
    the floor tile's truncated spectra (``fused_scratch_bytes(1, ...)``)
    must fit in the L2 and a slab's partial transform in a block's shared
    memory, and ``fft_in`` and ``contract`` must quantise to one format
    (and one compute dtype when they quantise).  An active autoprec
    collector vetoes it, as in the reference: the staged path owns
    telemetry, since its taps read the spectrum the fused kernels never
    write.  So does an active ``dist.channels`` scope (the channels split
    over tp): the fused kernels transform the whole spatial input of every
    input channel, where a rank holds its channel block only.  Decided
    before any launch; the batch does not enter (the kernels tile it)."""
    from repro_torch.dist import channels

    if telemetry_active() or channels.active() is not None:
        return False
    spatial, modes = tuple(spatial), tuple(modes)
    if not fused_supported(spatial, modes) or len(modes) > 3:
        return False
    if fused_scratch_bytes(1, I, O, spatial, modes) > L2_BUDGET:
        return False
    if fused_smem_bytes(spatial, modes) > SMEM_LIMIT:
        return False
    if fft_in.quantize_fmt != ctr.quantize_fmt:
        return False
    if fft_in.quantize_fmt is not None and fft_in.compute != ctr.compute:
        return False
    return True


def _fused_qspec(ctr):
    """``(cast_to, sim_fmt)`` of a contract-site rule: ``half`` rounds the
    spectrum and the weight onto the compute dtype; a simulated fp8 format
    rounds the spectrum onto the fp8 grid, then both onto the compute
    dtype, as the staged ``fft_in.quantize`` then half contraction do."""
    fmt = ctr.quantize_fmt
    if fmt is None:
        return None, None
    return ctr.compute, None if fmt == "half" else fmt


def gather_corner_weights(w_re: torch.Tensor, w_im: torch.Tensor, modes: Sequence[int]):
    """Fold per-corner dense weights into the fused kernels' layout.

    ``w_re``/``w_im``: (corners, I, O, *modes).  The fused forward DFT
    keeps, per truncated axis, the low block ``[0, m)`` then the high block
    ``[S-m, S)``, so corner ``c``'s weight lands at axis-``k`` rows
    ``[m, 2m)`` when bit ``k`` of ``c`` is set and at ``[0, m)`` otherwise
    (the last axis: always ``[0, m)``).  Returns ``(wgr, wgi)`` of shape
    (I, O, Mh), flattened row-major.  A permutation of the corners, so
    gradients scatter back to them exactly."""
    nd = len(modes)
    nc, I, O = w_re.shape[:3]
    if nc != 2 ** (nd - 1) or tuple(w_re.shape[3:]) != tuple(modes):
        raise ValueError(f"gather_corner_weights: weight {tuple(w_re.shape)}, expected "
                         f"({2 ** (nd - 1)} corners, I, O, *{tuple(modes)})")
    Mh = math.prod(fused_rows(None, modes))
    # the corner index, bit k for axis k, as (bit_{nd-2}, ..., bit_0) row-major
    # axes; each bit goes in front of its axis' modes
    perm = [nd - 1, nd]
    for k in range(nd - 1):
        perm += [nd - 2 - k, nd + 1 + k]
    perm.append(2 * nd)

    def gather(w):
        w = w.reshape(*([2] * (nd - 1)), I, O, *modes).permute(*perm)
        return w.reshape(I, O, Mh)

    return gather(w_re), gather(w_im)


def spectral_conv_fused(x: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor,
                        modes: Sequence[int], *, policy=FULL,
                        site: str = "model/spectral") -> torch.Tensor:
    """The dense Fourier convolution as one fused launch per batch tile.

    Semantically ``spectral_conv_apply`` for a dense layer: the stabiliser
    (outside the kernels, on the input the caller owns), the ``fft_in``
    quantisation of the truncated spectrum, the per-corner contraction as
    row blocks of the gathered weight, the inverse transform.  The kernels'
    output is f32 with no store rounding; it is cast at ``fft_out`` when
    that site is half, then to ``x``'s dtype.  ``x``: real (B, I,
    *spatial); ``w_re``/``w_im``: (corners, I, O, *modes); ``policy``: a
    PrecisionPolicy, resolved here at ``{site}/fft_in|contract|fft_out``.
    """
    if not isinstance(policy, PrecisionPolicy):
        raise ValueError("spectral_conv_fused resolves fft_in/contract/fft_out sites "
                         "itself: pass the PrecisionPolicy, not a SitePrecision")
    # no tap here: ``fused_spectral_viable`` keeps this path from running
    # while a collector is active
    fft_in = policy.at(f"{site}/fft_in")
    ctr = policy.at(f"{site}/contract")
    fft_out = policy.at(f"{site}/fft_out")
    modes = tuple(int(m) for m in modes)
    in_dtype = x.dtype
    x = fft_in.stabilize(x)
    wgr, wgi = gather_corner_weights(w_re, w_im, modes)
    cast_to, sim_fmt = _fused_qspec(ctr)
    # the fused kernels stream f32 operands whatever the storage dtype; the
    # key carries the contract site's dtype, as the reference's does
    key = (*x.shape[:2], w_re.shape[2], *x.shape[2:], *modes)
    half = ctr.spectral_dtype or torch.float32
    block_fwd, block_bwd, _src = _resolve_blocks(
        "spectral_fused", key, half, lambda: heuristic_blocks("spectral_fused", key, half),
        x.device)
    with site_scope(ctr.site):
        y = FusedSpectral.apply(x.float().contiguous(), wgr.contiguous(), wgi.contiguous(),
                                modes, cast_to, sim_fmt, block_fwd, block_bwd)
    if fft_out.spectral_is_half:
        y = y.to(fft_out.compute_dtype)
    return y.to(in_dtype)


# -- the LM pool's substrate kernels ------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """(B, H, S, D) attention; folds (B, H) into the kernel's batch axis.
    k and v are (B, H, Sk, D)."""
    registry().counter("repro_kernels_calls_total", family="flash_attention").inc()
    B, H, S, D = q.shape
    Sk = k.shape[2]
    out = _flash.flash_attention(
        q.reshape(B * H, S, D), k.reshape(B * H, Sk, D), v.reshape(B * H, Sk, D),
        causal=causal, block_q=block_q, block_k=block_k)
    return out.reshape(B, H, S, D)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 256) -> torch.Tensor:
    """Rank-agnostic RMSNorm over the last axis."""
    registry().counter("repro_kernels_calls_total", family="rmsnorm").inc()
    shape = x.shape
    out = _rmsnorm.rmsnorm(x.reshape(-1, shape[-1]), w, eps=eps, block_rows=block_rows)
    return out.reshape(shape)
