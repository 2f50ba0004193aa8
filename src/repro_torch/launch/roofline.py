"""Roofline analysis of one traced step, for an NVIDIA H100 SXM (no card
needed: the step runs on fake tensors).

Three terms per (arch x mesh), in seconds, per device:

    compute    = FLOPs            / PEAK_FLOPS
    memory     = bytes            / HBM_BW
    collective = collective_bytes / link rate of the mesh's widest axis

:func:`count_step` counts one step by running it under a dispatch mode
that sees every ATen op a rank runs on its own shards (DTensor ops are
left to DTensor, whose local ops and collectives come back through the
mode):

  * FLOPs: ``torch.utils.flop_counter``'s formulas (those of
    ``FlopCounterMode``) on each local op;
  * bytes: the operand and output bytes of every ATen op that touches
    memory (views move nothing; an in-place op reads and writes its
    operands).  The port dispatches op by op, so this is what the step
    moves through HBM: nothing is fused;
  * collective bytes, by kind: the output bytes of the functional
    collectives DTensor issues and of the c10d collectives
    ``optim.grad_comm`` issues;
  * peak bytes: the arguments plus the most the step's own allocations
    hold at once (each op's new outputs, freed when no tensor refers to
    them).

Everything is per device.  These are derived counts, not timings.
"""
from __future__ import annotations

import dataclasses as _dc
import math
import weakref
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: bf16 dense tensor-core peak of an H100 SXM5, FLOP/s: 989.4 TFLOPS
#: (NVIDIA H100 Tensor Core GPU data sheet, "BF16 Tensor Core", without
#: sparsity)
PEAK_FLOPS = 989e12
#: HBM3 bandwidth of an H100 SXM5 80 GB, bytes/s: 3.35 TB/s (same data sheet)
HBM_BW = 3.35e12
#: NVLink 4 within an 8-GPU HGX H100 node, bytes/s a direction a GPU: 900
#: GB/s bidirectional, 450 GB/s each way (same data sheet, "NVLink: 900GB/s")
NVLINK_BW = 450e9
#: InfiniBand NDR across nodes, bytes/s a GPU: one 400 Gb/s ConnectX-7 port
#: a GPU in a DGX H100 (DGX H100 user guide: 8x single-port ConnectX-7 400 Gb/s)
IB_BW = 50e9
#: GPUs a node: a mesh axis wider than this crosses nodes
GPUS_PER_NODE = 8


def link_bw(mesh_shape) -> float:
    """The link rate the step's collectives run at: NVLink when every mesh
    axis fits one node, InfiniBand when an axis is wider than a node (a
    16-wide axis spans two nodes, so its rings cross InfiniBand)."""
    return IB_BW if max(int(s) for s in mesh_shape) > GPUS_PER_NODE else NVLINK_BW


# ---------------------------------------------------------------------------
# Counting one step
# ---------------------------------------------------------------------------

#: functional / c10d collective op names -> the reference's HLO kinds
_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


@_dc.dataclass
class Counts:
    """One traced step's per-device counts (the reference's ``HLOCounts``
    plus the memory the trace saw)."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_by_kind: Dict[str, float] = _dc.field(default_factory=dict)
    n_ops: int = 0
    temp_peak_bytes: int = 0
    flops_by_op: Dict[str, float] = _dc.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collective_by_kind.values()))


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _alias(func) -> str:
    """"view" for an op returning an alias of an input, "inplace" for one
    writing an input (or an out= argument), "" for one making new tensors."""
    rets = func._schema.returns
    if not rets or all(r.alias_info is None for r in rets):
        return ""
    return "inplace" if any(r.alias_info is not None and r.alias_info.is_write
                            for r in rets) else "view"


#: ops that only allocate: DTensor's sharding propagation makes its
#: global-shape stand-ins with ``empty_strided`` (and runs the op on them to
#: learn the output's shape), so its outputs are not a rank's tensors
_STAND_IN = ("empty_strided",)


class _CountMode(TorchDispatchMode):
    """Counts the ops a rank runs on its own tensors: the step's inputs
    (their local shards), host constants, and what ops on them make.  An op
    with a fake tensor argument that is none of these is DTensor's shape
    propagation (its stand-ins are fake, even in a real run) and is left
    out."""

    def __init__(self, counts: Counts, inputs):
        super().__init__()
        self.c = counts
        self.live = 0
        self.peak = 0
        self.known: Dict[int, Any] = {}
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        for t in _input_tensors(inputs):
            self._know(t)

    def _know(self, t: torch.Tensor) -> None:
        k = id(t)
        if k not in self.known:
            self.known[k] = weakref.finalize(t, self.known.pop, k, None)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor runs its local ops through us
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        name = func._overloadpacket.__name__
        if any(isinstance(t, FakeTensor) and id(t) not in self.known for t in ins) or \
                (not ins and name in _STAND_IN):
            return out
        outs = _tensors(out)
        for t in outs:
            self._know(t)
        if func.namespace in ("_c10d_functional", "c10d", "c10d_functional"):
            kind = _COLLECTIVE_KINDS.get(name)
            if kind is not None and _group_size(args) > 1:   # one rank sends nothing
                nb = sum(_nbytes(t) for t in outs)
                self.c.collective_by_kind[kind] = self.c.collective_by_kind.get(kind, 0) + nb
            return out
        self.c.n_ops += 1
        f = self.flop_registry.get(func._overloadpacket)
        if f is not None:
            n = float(f(*args, **kwargs, out_val=out))
            self.c.flops += n
            self.c.flops_by_op[name] = self.c.flops_by_op.get(name, 0.0) + n
        alias = _alias(func)
        if alias == "view":
            return out
        self.c.bytes += sum(_nbytes(t) for t in ins)
        if alias == "":
            self.c.bytes += sum(_nbytes(t) for t in outs)
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


def _group_size(args) -> int:
    """Ranks in the process group a collective's arguments name (a
    functional collective's group name, or a c10d op's group object)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError):
                continue
        if hasattr(a, "size") and not torch.is_tensor(a) and callable(a.size):
            return int(a.size())
    return 2


def _input_tensors(tree):
    """The rank's own tensors in a step's arguments: plain tensors, the
    local shards of DTensors, a module's parameters and buffers."""
    from torch.distributed.tensor import DTensor

    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.nn.Module):
            out.extend(_input_tensors(list(x.parameters()) + list(x.buffers())))
        elif isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def count_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counting mode: returns
    (its result, :class:`Counts`).  Run it under ``FakeTensorMode`` (and a
    fake process group for a mesh) to count a step no device could hold.
    Tensors the step reads that are not in its arguments (a closure's) are
    not the rank's as far as the count knows: pass them in."""
    counts = Counts()
    mode = _CountMode(counts, (args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    counts.temp_peak_bytes = int(mode.peak)
    return out, counts


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------


@_dc.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return _dc.asdict(self) | {
            "dominant": self.dominant, "step_time_s": self.step_time_s}


def analyze_counts(counts: Counts, n_devices: int, link: float = NVLINK_BW) -> Roofline:
    """Per-device counts -> the three roofline terms on an H100 (the
    collective term at ``link``, see :func:`link_bw`)."""
    return Roofline(
        flops_per_device=counts.flops,
        bytes_per_device=counts.bytes,
        collective_bytes_per_device=counts.collective_bytes,
        n_devices=n_devices,
        compute_s=counts.flops / PEAK_FLOPS,
        memory_s=counts.bytes / HBM_BW,
        collective_s=counts.collective_bytes / link,
    )


def model_flops(n_params_active: float, tokens: float) -> float:
    """6·N·D napkin-math (N_active for MoE)."""
    return 6.0 * n_params_active * tokens


# ---------------------------------------------------------------------------
# The spectral kernels' launch plan at a cell
# ---------------------------------------------------------------------------


def spectral_kernel_smem(B: int, I: int, O: int, modes, *, spatial=None, rank: int = 0,
                         l_shared: bool = False, policy=None,
                         site: str = "fno/layer0/spectral") -> dict:
    """The launch plan the card runs for one spectral layer at a dry-run
    cell, B the batch a device holds.

    A dense layer runs the fused kernels where
    ``kernels.ops.fused_spectral_viable`` admits its shapes and
    ``policy``'s rules at ``site`` (the batch tile from ``heuristic_blocks``
    or, with an active ``repro_torch.tune`` state holding a validated
    entry, that entry: ``tile_source`` "calibrated"), else the staged
    dense kernels; ``rank > 0`` is the CP kernels' plan (``cp_fwd_plan``,
    ``cp_bwd_plan``), ``l_shared`` the order-shared kernels' (``ls_plan``;
    ``modes = (lmax, mmax)``).  Recorded: shared memory a block against
    ``SMEM_LIMIT``, the fused kernels' scratch against ``L2_BUDGET``, and
    the bytes the step's kernels move (``tune.measure.bytes_moved``: each
    operand read once, each output written once) with their time at
    ``HBM_BW``, the bytes term of ``chip_smoke.py``'s bounds."""
    from repro_torch.kernels import spectral_contract as sc
    from repro_torch.kernels.ops import fused_spectral_viable, heuristic_blocks
    from repro_torch.precision import FULL
    from repro_torch.tune.cache import active_cache
    from repro_torch.tune.measure import bytes_moved

    policy = policy or FULL
    ctr = policy.at(f"{site}/contract")
    fft_in = policy.at(f"{site}/fft_in")
    half = ctr.quantize_fmt is not None
    dtype = ctr.compute if half else torch.float32
    dname = str(dtype).replace("torch.", "")
    modes = tuple(int(m) for m in modes)
    rec: Dict[str, Any] = {"B": B, "I": I, "O": O, "modes": list(modes), "rank": rank,
                           "dtype": dname, "smem_limit": sc.SMEM_LIMIT,
                           "l2_budget": sc.L2_BUDGET, "tile_source": None}

    def calibrated(family, shape):
        cache = active_cache()
        if cache is None:
            return None
        ent = cache.lookup(family, shape, dname, backend="cuda")
        return None if ent is None else (int(ent["block_fwd"]), int(ent["block_bwd"]))

    if l_shared:
        L, Mm = modes
        family, shape = "lshared", (B, I, O, L, Mm)
        fwd, bwd = sc.ls_plan(I, O, dtype, B=B, L=L, M=Mm), sc.ls_plan(O, I, dtype, B=B, L=L, M=Mm)
        tuned = calibrated(family, shape)
        rec.update(kind="l_shared", splits=tuned or (fwd.splits, bwd.splits),
                   tile_source="calibrated" if tuned else "heuristic",
                   smem_fwd_bytes=fwd.smem, smem_bwd_bytes=bwd.smem, scratch_bytes=0)
    elif rank:
        M = math.prod(modes)
        family, shape = "cp", (B, I, O, rank, M)
        fwd, bwd = sc.cp_fwd_plan(I, O, rank, dtype), sc.cp_bwd_plan(I, O, rank, dtype)
        rec.update(kind="cp", factors_resident=fwd.resident, smem_fwd_bytes=fwd.smem,
                   smem_bwd_bytes=bwd.smem, scratch_bytes=0)
    else:
        spatial = tuple(int(s) for s in spatial)
        fused = fused_spectral_viable(fft_in, ctr, I, O, spatial, modes)
        if fused:
            family, shape = "spectral_fused", (B, I, O, *spatial, *modes)
            tuned = calibrated(family, shape)
            bf, bb = tuned or heuristic_blocks(family, shape, dname)
            smem = sc.fused_smem_bytes(spatial, modes)
            rec.update(kind="fused", block_b=bf, block_b_bwd=bb,
                       tile_source="calibrated" if tuned else "heuristic",
                       smem_fwd_bytes=smem, smem_bwd_bytes=smem,
                       scratch_bytes=max(sc.fused_scratch_bytes(bb, I, O, spatial, modes),
                                         sc.fused_fwd_scratch_bytes(bf, I, O, spatial, modes)))
        else:
            family, shape = "spectral_staged", (B, I, O, *spatial, *modes)
            rec.update(kind="staged", smem_fwd_bytes=None, smem_bwd_bytes=None,
                       scratch_bytes=0)
    smem = max(v for v in (rec["smem_fwd_bytes"], rec["smem_bwd_bytes"], 0) if v is not None)
    rec["fits_smem"] = smem <= sc.SMEM_LIMIT
    rec["fits_l2"] = rec["scratch_bytes"] <= sc.L2_BUDGET
    nbytes = bytes_moved(family, shape, dname)
    rec["kernel_bytes"] = int(nbytes)
    rec["kernel_bytes_ms"] = nbytes / HBM_BW * 1e3
    return rec
