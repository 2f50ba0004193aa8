"""Dtype-flow pass: precision lint over the ops the port really runs.

The reference traces jaxprs without running them.  The port runs
eagerly and launches its kernels through ctypes, where no tracer sees
them, so this pass runs the program (on the CPU or on the card, as the
caller's tensors say) under a recorder and lints what was recorded:

* a ``TorchDispatchMode`` records every ATen op below autograd: its
  name, its tensor operands and results by identity (so producers and
  consumers link up) with their dtypes, and the site it ran under;
* every kernel launch adds one record through ``kernels.build``'s
  ``launch_hook``: the kernel's name, its operand dtypes, the grid it
  rounds them onto (``cast_to``, ``sim_fmt``), its accumulation dtype
  (f32, for all twelve kernels) and its output dtypes;
* sites come from ``precision.site_scope``: the innermost open scope in
  the forward, and in the backward the scope that created the autograd
  node being run (each scope's range of autograd sequence numbers), so a
  backward op lands on the forward site that made it, also on the
  autograd engine's device thread.

The checks are the reference's, with its slugs and severities:

  half-accum-contract (error)   a contraction whose accumulation dtype is
      half inside a ``*/spectral/contract`` scope: the invariant Thm 3.2's
      error model assumes (half storage, f32 accumulation).
  half-accum (warning)          the same outside spectral scopes.
  half-accum-reduce             a sum/product/mean carried out at a half
      dtype (error inside contract scopes, else warning).
  fp16-overflow-risk (warning)  ``exp`` / ``x**n`` on an fp16 value with no
      bounded op (stabiliser, tanh, clamp) between it and its source.
  round-trip-cast (warning)     ``f32 → half → f32`` with no compute
      between, unless the widened value feeds only contractions (below).
  fp32-resident (error)         a ``*/contract`` scope whose policy demotes
      storage to half but whose ops and launches never touch the half
      dtype: the declared precision does not hold.

JAX primitives map onto ATen ops through one table, ``PRIMITIVES``.  ATen
has no ``preferred_element_type``: the port writes f32 accumulation of
half operands as "round to half, widen, multiply in f32"
(``core.contraction._einsum_half``, the kernels' plain versions).  So a
contraction operand that comes straight from a half → f32 widening (layout
ops between allowed) counts as that half dtype, the contraction's
accumulation dtype is its output dtype, and an ``f32 → half → f32`` pair
that feeds only contractions is not a round trip.  Anything else with a
half output accumulates at half, as in the reference.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.precision.rules import site_matches

from .findings import ERROR, WARNING, Finding

_HALF = (torch.float16, torch.bfloat16)
_F16 = torch.float16

#: JAX primitive -> the ATen ops that are its counterpart (``OpOverloadPacket``
#: names, in-place variants folded onto the out-of-place name)
PRIMITIVES: Dict[str, frozenset] = {
    # dot_general / conv_general_dilated: the contractions
    "dot_general": frozenset({"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
                              "dot", "vdot", "convolution"}),
    # convert_element_type: a copy that changes the dtype
    "convert_element_type": frozenset({"_to_copy", "copy"}),
    "fft": frozenset({"_fft_r2c", "_fft_c2r", "_fft_c2c"}),
    "tanh": frozenset({"tanh"}),
    "integer_pow": frozenset({"pow"}),
    # reduce_sum / reduce_prod / cumsum
    "reduce": frozenset({"sum", "prod", "cumsum", "mean", "nansum"}),
    # bounded O(1) whatever the input: they clear the fp16 overflow taint
    "bounded": frozenset({"tanh", "erf", "erfc", "sigmoid", "sin", "cos", "sign", "clamp",
                          "clamp_min", "clamp_max", "eq", "ne", "lt", "le", "gt", "ge",
                          "isfinite"}),
    # boundedness flows through these (shape, layout, identity, selection)
    "transparent": frozenset({"view", "_unsafe_view", "reshape", "_reshape_alias", "t",
                              "transpose", "permute", "expand", "slice", "select", "narrow",
                              "squeeze", "unsqueeze", "flip", "clone", "alias", "detach",
                              "as_strided", "split", "unbind", "_to_copy", "copy", "neg",
                              "abs", "real", "imag", "view_as_real", "view_as_complex",
                              "conj", "_conj", "conj_physical", "complex", "amax", "amin",
                              "max", "min", "gather", "index", "index_select",
                              "constant_pad_nd", "cat", "stack", "where", "maximum",
                              "minimum", "lift_fresh"}),
    # products and sums of bounded values stay bounded
    "combining": frozenset({"add", "sub", "rsub", "mul", "div"}),
    # can push a finite fp16 value past 65504
    "overflow": frozenset({"exp", "exp2", "expm1", "cosh", "sinh"}),
    # move or view values without changing them: a widened operand stays
    # widened through these on its way to a contraction
    "layout": frozenset({"view", "_unsafe_view", "reshape", "_reshape_alias", "t",
                         "transpose", "permute", "expand", "slice", "select", "narrow",
                         "squeeze", "unsqueeze", "clone", "alias", "detach", "as_strided",
                         "split", "unbind"}),
}

#: which tensor operands of a contraction are multiplied (the rest are added)
_MULTIPLIED = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2),
               "addbmm": (1, 2), "mv": (0, 1), "addmv": (1, 2), "dot": (0, 1),
               "vdot": (0, 1), "convolution": (0, 1)}

#: every kernel of the port sums in f32
KERNEL_ACCUM = torch.float32


def _dt(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def _prim(op: str) -> Optional[str]:
    for prim in ("dot_general", "convert_element_type", "fft", "tanh", "integer_pow"):
        if op in PRIMITIVES[prim]:
            return prim
    return None


def _base(name: str) -> str:
    """``add_`` -> ``add``; ``copy_`` -> ``copy``; ``_to_copy`` stays."""
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One recorded op or kernel launch.

    op:       ATen op (in-place variants folded: ``add_`` is ``add``) or the
              launched kernel's name.
    kernel:   a launch (through ``kernels.build._call``), not an ATen op.
    site:     the site it ran under (None: no scope).
    backward: it ran inside an autograd node's backward.
    ins/outs: (uid, dtype) of each tensor operand / result, in order; a uid
              names one tensor object for as long as it lives.
    exponent: ``pow``'s scalar exponent, where it has one.
    cast_to, sim_fmt: the grids a kernel rounds its operands onto.
    zero_dim: uids of its 0-d tensor operands (constants, where the run did
              not compute them).
    """

    op: str
    kernel: bool
    site: Optional[str]
    backward: bool
    ins: Tuple[Tuple[int, torch.dtype], ...]
    outs: Tuple[Tuple[int, torch.dtype], ...]
    exponent: Optional[float] = None
    cast_to: Optional[torch.dtype] = None
    sim_fmt: Optional[str] = None
    zero_dim: Tuple[int, ...] = ()

    @property
    def in_dtypes(self) -> Tuple[torch.dtype, ...]:
        return tuple(dt for _, dt in self.ins)

    @property
    def out_dtypes(self) -> Tuple[torch.dtype, ...]:
        return tuple(dt for _, dt in self.outs)


class Recorder(TorchDispatchMode):
    """Records every ATen op and kernel launch while active (``recording()``
    activates it).  Thread-safe: a backward on the autograd engine's device
    thread records into the same list."""

    def __init__(self):
        super().__init__()
        self.records: List[OpRecord] = []
        self._uids = WeakIdKeyDictionary()
        self._next = 0
        self._lock = threading.Lock()
        #: (first, end, site) of each closed scope's autograd sequence numbers
        self._scopes: List[Tuple[int, int, str]] = []
        self._node_sites: Dict[int, Optional[str]] = {}

    # -- identities -----------------------------------------------------------
    def _uid(self, t: torch.Tensor) -> int:
        uid = self._uids.get(t)
        if uid is None:
            uid = self._uids[t] = self._next
            self._next += 1
        return uid

    def _tensors(self, tree) -> Tuple[Tuple[int, torch.dtype], ...]:
        leaves, _ = tree_flatten(tree)
        return tuple((self._uid(t), t.dtype) for t in leaves if isinstance(t, torch.Tensor))

    # -- sites ------------------------------------------------------------------
    def opened(self) -> int:
        return torch._C._autograd._get_sequence_nr()

    def closed(self, site: str, first: int) -> None:
        end = torch._C._autograd._get_sequence_nr()
        if end > first:
            with self._lock:
                self._scopes.append((first, end, site))
                self._node_sites.clear()

    def _site_now(self) -> Tuple[Optional[str], bool]:
        from repro_torch.precision.scope import current_site

        node = torch._C._current_autograd_node()
        if node is None:
            return current_site(), False
        seq = node._sequence_nr()
        with self._lock:
            if seq not in self._node_sites:
                # the innermost scope holding it: the latest to open, the
                # earliest to close
                inner = [((first, -end, -k), site) for k, (first, end, site)
                         in enumerate(self._scopes) if first <= seq < end]
                self._node_sites[seq] = max(inner)[1] if inner else None
            return self._node_sites[seq], True

    # -- records ----------------------------------------------------------------
    def __torch_dispatch__(self, func, _types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _base(func.overloadpacket.__name__)
        site, backward = self._site_now()
        exponent = None
        if name == "pow" and len(args) > 1 and isinstance(args[1], (int, float)):
            exponent = float(args[1])
        with self._lock:
            ins = self._tensors((args, kwargs))
            outs = self._tensors(out)
            zero = tuple(self._uid(t) for t in tree_flatten((args, kwargs))[0]
                         if isinstance(t, torch.Tensor) and t.dim() == 0)
            self.records.append(OpRecord(name, False, site, backward, ins, outs,
                                         exponent=exponent, zero_dim=zero))
        return out

    def launch(self, name: str, io) -> None:
        """``kernels.build.launch_hook``: one record a launch."""
        if io is None:
            raise RuntimeError(f"{name}: a launch without its LaunchIO cannot be recorded")
        site, backward = self._site_now()
        with self._lock:
            self.records.append(OpRecord(
                name, True, site, backward, self._tensors(io.operands),
                self._tensors(io.outputs), cast_to=io.cast_to, sim_fmt=io.sim_fmt))


@contextmanager
def recording() -> Iterator[Recorder]:
    """Record every op, launch and site scope of the block.  Nothing nests:
    a second recorder while one is active raises, and so does a scope or
    launch the recorder cannot take (there is no fallback)."""
    from repro_torch.kernels import build
    from repro_torch.precision import scope

    if scope.listener is not None or build.launch_hook is not None:
        raise RuntimeError("a dtype-flow recorder is already active")
    rec = Recorder()
    scope.listener = rec
    build.launch_hook = rec.launch
    try:
        with rec:
            yield rec
    finally:
        scope.listener = None
        build.launch_hook = None


# ---------------------------------------------------------------------------
# The checks
# ---------------------------------------------------------------------------


def _is_cast(r: OpRecord) -> bool:
    """A copy that changes the dtype (``_to_copy``, or ``copy_`` into a
    tensor of another dtype: the destination is the result)."""
    if r.kernel or r.op not in PRIMITIVES["convert_element_type"] or not r.outs:
        return False
    src = r.ins[1][1] if r.op == "copy" and len(r.ins) > 1 else r.in_dtypes[0]
    return src != r.outs[0][1]


def _cast_src(r: OpRecord) -> torch.dtype:
    return r.ins[1][1] if r.op == "copy" and len(r.ins) > 1 else r.in_dtypes[0]


def _is_widening(r: OpRecord) -> bool:
    return _is_cast(r) and _cast_src(r) in _HALF and r.outs[0][1] == torch.float32


class _Flow:
    """The records' consumers, and the forward facts the checks read as they
    walk the records in order: which tensors are widened halves (and of
    which dtype), which are bounded."""

    def __init__(self, records: Sequence[OpRecord]):
        self.records = list(records)
        self.consumers: Dict[int, List[int]] = {}
        for k, r in enumerate(self.records):
            for uid, _ in r.ins:
                self.consumers.setdefault(uid, []).append(k)
        self.widened: Dict[int, torch.dtype] = {}
        self.bounded: Dict[int, bool] = {}
        self.produced: set = set()

    def _is_bounded(self, r: OpRecord, uid: int) -> bool:
        # a 0-d tensor the program did not compute is a constant, as a JAX
        # literal is
        if uid not in self.produced and uid in r.zero_dim:
            return True
        return self.bounded.get(uid, False)

    def step(self, r: OpRecord) -> Tuple[Tuple[torch.dtype, ...], List[bool]]:
        """Advance past ``r``.  Returns the dtypes its multiplied operands
        are read as (a widened half as its half dtype; a kernel's operands
        on its ``cast_to`` grid; empty for anything but a contraction or a
        launch) and whether each of its tensor operands is bounded."""
        ins = [uid for uid, _ in r.ins]
        in_b = [self._is_bounded(r, uid) for uid in ins]
        if r.kernel:
            eff = tuple(r.cast_to or dt for dt in r.in_dtypes)
        elif r.op in _MULTIPLIED:
            eff = tuple(self.widened.get(r.ins[i][0], r.ins[i][1])
                        for i in _MULTIPLIED[r.op] if i < len(r.ins))
        else:
            eff = ()
        widened = None
        if _is_widening(r):
            widened = _cast_src(r)
        elif not r.kernel and r.op in PRIMITIVES["layout"] and ins and r.outs \
                and r.outs[0][1] == torch.float32:
            widened = self.widened.get(ins[0])
        if r.kernel or r.op not in PRIMITIVES["bounded"] and \
                r.op not in PRIMITIVES["transparent"] and r.op not in PRIMITIVES["combining"]:
            out_b = False
        else:
            out_b = r.op in PRIMITIVES["bounded"] or (bool(ins) and all(in_b))
        for uid, _ in r.outs:
            if widened is not None:
                self.widened[uid] = widened
            elif uid not in ins:
                self.widened.pop(uid, None)
            self.bounded[uid] = out_b
            self.produced.add(uid)
        return eff, in_b

    def feeds_only_contractions(self, uid: int, after: int) -> bool:
        """Whether every use of ``uid`` after record ``after`` is a multiplied
        operand of a contraction or a kernel's operand, layout ops between."""
        uses = [k for k in self.consumers.get(uid, []) if k > after]
        if not uses:
            return False
        for k in uses:
            r = self.records[k]
            if r.kernel:
                continue
            if r.op in _MULTIPLIED:
                if all(i in _MULTIPLIED[r.op] for i, (u, _) in enumerate(r.ins) if u == uid):
                    continue
                return False
            if r.op in PRIMITIVES["layout"] and r.outs and all(
                    o != uid and self.feeds_only_contractions(o, k) for o, _ in r.outs):
                continue
            return False
        return True


def _contract_site(site: Optional[str]) -> bool:
    return site is not None and site_matches("*/spectral/contract", site)


def analyze_records(records: Sequence[OpRecord], policy, where: str) -> List[Finding]:
    """Lint one recorded run under ``policy`` (the checks above)."""
    findings: List[Finding] = []
    site_dtypes: Dict[str, set] = {}

    def emit(check, severity, site, detail):
        findings.append(Finding(pass_name="dataflow", check=check, severity=severity,
                                site=site, where=where, detail=detail))

    flow = _Flow(records)
    for k, r in enumerate(flow.records):
        site = r.site
        eff, in_bounded = flow.step(r)
        if site is not None and site.endswith("/contract"):
            seen = site_dtypes.setdefault(site, set())
            seen.update(r.in_dtypes + r.out_dtypes)
            if r.cast_to is not None:
                seen.add(r.cast_to)
        severity = ERROR if _contract_site(site) else WARNING

        # 1. half accumulation: a contraction (never a kernel: they sum in
        #    f32) or a reduction whose result is half
        if not r.kernel and r.op in _MULTIPLIED and r.outs and r.outs[0][1] in _HALF:
            emit("half-accum-contract" if severity == ERROR else "half-accum",
                 severity, site,
                 f"{r.op} accumulates at {_dt(r.outs[0][1])} (operands read as "
                 f"{[_dt(d) for d in eff]}); widen the operands to float32 and "
                 f"multiply there")
        if not r.kernel and r.op in PRIMITIVES["reduce"] and r.ins and r.outs \
                and r.ins[0][1] in _HALF and r.outs[0][1] in _HALF:
            emit("half-accum-reduce", severity, site,
                 f"{r.op} carried out at {_dt(r.outs[0][1])}")

        # 2. fp16 overflow-prone ops on unbounded values
        risky = r.op in PRIMITIVES["overflow"] or (
            r.op == "pow" and r.exponent is not None and r.exponent >= 2)
        if not r.kernel and risky and r.outs and r.outs[0][1] == _F16 and any(
                dt == _F16 and not b for (_, dt), b in zip(r.ins, in_bounded, strict=True)):
            emit("fp16-overflow-risk", WARNING, site,
                 f"{r.op} on an unstabilized float16 value (no bounded op between "
                 f"source and use)")

        # 3. round trips: f32 -> half -> f32, no compute between, unless the
        #    widened value feeds only contractions
        if _is_cast(r) and _cast_src(r) == torch.float32 and r.outs[0][1] in _HALF:
            uses = [j for j in flow.consumers.get(r.outs[0][0], []) if j > k]
            if uses and all(_is_widening(flow.records[j]) for j in uses) and not all(
                    flow.feeds_only_contractions(flow.records[j].outs[0][0], j)
                    for j in uses):
                emit("round-trip-cast", WARNING, site,
                     f"float32 -> {_dt(r.outs[0][1])} -> float32 with no compute between "
                     f"(wasted HBM round trip)")

    # 4. the declared precision of each contract scope
    for site, dtypes in sorted(site_dtypes.items()):
        sp = policy.at(site)
        if sp.spectral_dtype is not None and sp.spectral_dtype not in dtypes:
            emit("fp32-resident", ERROR, site,
                 f"policy {policy.name!r} demotes this site to {_dt(sp.spectral_dtype)} "
                 f"but no op or launch under its scope touches that dtype: the "
                 f"declared precision does not hold")
    return findings


def trace_findings(fn, args: Sequence, policy, where: str) -> List[Finding]:
    """Run ``fn(*args)`` under the recorder and lint what it ran."""
    with recording() as rec:
        fn(*args)
    return analyze_records(rec.records, policy, where)


# ---------------------------------------------------------------------------
# Models and the trainer
# ---------------------------------------------------------------------------

MODELS = ("fno", "tfno", "sfno")


def _normal(shape, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


def tiny_model(model: str, device="cpu", fuse_spectral: Optional[bool] = False):
    """(config, model, input) of a representative but cheap instance of each
    operator family, weights and input from a seed.  TFNO is the
    CP-factorised FNO."""
    gen = torch.Generator().manual_seed(0)
    if model in ("fno", "tfno"):
        from repro_torch.models import FNOConfig, init_fno

        cfg = FNOConfig(in_channels=1, out_channels=1, hidden_channels=8,
                        lifting_channels=8, projection_channels=8, n_layers=2,
                        modes=(4, 4), factorization="cp" if model == "tfno" else "dense",
                        fuse_spectral=fuse_spectral)
        return cfg, init_fno(gen, cfg, device=device), _normal((2, 1, 16, 16), 1, device)
    if model == "sfno":
        from repro_torch.models import SFNOConfig, init_sfno

        cfg = SFNOConfig(in_channels=1, out_channels=1, hidden_channels=8,
                         lifting_channels=8, projection_channels=8, n_layers=2,
                         nlat=8, nlon=16, lmax=4, mmax=4)
        return cfg, init_sfno(gen, cfg, device=device), _normal((2, 1, 8, 16), 1, device)
    raise ValueError(f"unknown model {model!r}; have fno | tfno | sfno")


def _where(prefix: str, policy, fused: bool) -> str:
    return f"{prefix}/{policy.name}" + ("+fused" if fused else "")


def model_findings(model: str, policy, fuse_spectral: bool = False,
                   device="cpu") -> List[Finding]:
    """Lint one model forward under one policy and path.  ``fuse_spectral``
    takes the fused kernels (the dense FNO only)."""
    if fuse_spectral and model != "fno":
        raise ValueError(f"{model} has no fused path: only the dense FNO does")
    _cfg, net, x = tiny_model(model, device, fuse_spectral)

    def forward(xx):
        with torch.no_grad():
            net(xx, policy)

    return trace_findings(forward, (x,), policy, _where(model, policy, fuse_spectral))


def trainer_findings(policy, fuse_spectral: bool = False, device="cpu") -> List[Finding]:
    """Lint one full ``Trainer`` step of a tiny FNO: the forward, the loss
    scaling the policy asks for, ``torch.autograd.grad`` and AdamW."""
    from repro_torch.core.schedule import PrecisionSchedule
    from repro_torch.models import FNOConfig, init_fno
    from repro_torch.train import Trainer, TrainerConfig, relative_l2

    cfg = FNOConfig(in_channels=1, out_channels=1, hidden_channels=8, lifting_channels=8,
                    projection_channels=8, n_layers=1, modes=(4, 4),
                    fuse_spectral=fuse_spectral)
    net = init_fno(torch.Generator().manual_seed(0), cfg, device=device)

    def loss_fn(model, batch, pol):
        return relative_l2(model(batch["x"], pol), batch["t"])

    tr = Trainer(loss_fn, net, TrainerConfig(
        total_steps=1, schedule=PrecisionSchedule.constant(policy.name)), device=device)
    batch = {"x": _normal((2, 1, 16, 16), 2, "cpu"), "t": _normal((2, 1, 16, 16), 3, "cpu")}
    return trace_findings(lambda: tr.run(lambda _step: batch, steps=1), (), policy,
                          _where("trainer", policy, fuse_spectral))


# ---------------------------------------------------------------------------
# Dtype traces of one spectral layer, and their projection
# ---------------------------------------------------------------------------


def trace_entries(records: Sequence[OpRecord]) -> List[str]:
    """The cast, contraction, FFT, kernel, power and tanh records as
    ``prim[op]:ins->outs[@acc=dtype][@site]`` strings, ``prim`` the JAX
    primitive of ``PRIMITIVES`` (``kernel`` for a launch).  A contraction
    lists its multiplied operands as it reads them (a widened half as its
    half dtype, a kernel's operands on its ``cast_to`` grid) and its
    accumulation dtype; a cast lists its source and destination."""
    flow = _Flow(records)
    out: List[str] = []

    def names(dts):
        return ",".join(_dt(d) for d in dts)

    for r in flow.records:
        eff, _ = flow.step(r)
        prim = "kernel" if r.kernel else _prim(r.op)
        entry = None
        if prim in ("dot_general", "kernel"):
            acc = KERNEL_ACCUM if r.kernel else r.outs[0][1]
            entry = f"{prim}[{r.op}]:{names(eff)}->{names(r.out_dtypes)}@acc={names([acc])}"
        elif prim == "convert_element_type":
            if _is_cast(r):
                entry = f"{prim}[{r.op}]:{names([_cast_src(r)])}->{names(r.out_dtypes[:1])}"
        elif prim is not None and (prim != "integer_pow" or r.exponent is not None):
            entry = f"{prim}[{r.op}]:{names(r.in_dtypes)}->{names(r.out_dtypes)}"
        if entry is not None:
            out.append(entry + (f"@{r.site}" if r.site else ""))
    return out


def dtype_trace(policy, factorization: str = "dense", fuse_spectral: bool = False,
                device="cpu") -> List[str]:
    """The cast, contraction, FFT, kernel and tanh sequence of one FNO
    spectral layer (4 channels, modes (4, 4), a 2 x 4 x 16 x 16 input from a
    seed) under ``policy``, at site ``model/spectral``: the reference's
    golden-trace surface (``repro.analyze.dtype_trace``)."""
    from repro_torch.core.spectral import init_spectral_weights, spectral_conv_apply

    params = {k: v.to(device) for k, v in init_spectral_weights(
        4, 4, (4, 4), factorization, generator=torch.Generator().manual_seed(0)).items()}
    x = _normal((2, 4, 16, 16), 0, device)
    with recording() as rec:
        spectral_conv_apply(params, x, (4, 4), policy, site="model/spectral",
                            fuse_spectral=fuse_spectral)
    return trace_entries(rec.records)


_STAGES = ("fft_in", "contract", "fft_out")
_REAL_OF = {"complex64": "float32", "complex128": "float64"}


def _stage_site(site: Optional[str]) -> str:
    """A site cut after its stage (an einsum scope the reference appends,
    ``.../contract/bixy``, falls away); "" for no site."""
    if not site:
        return ""
    parts = site.split("/")
    for k, p in enumerate(parts):
        if p in _STAGES:
            return "/".join(parts[:k + 1])
    return site


def project(trace: Sequence[str]) -> Dict[str, dict]:
    """The stated projection the port's traces and the reference's goldens
    are compared under, per site (cut after its stage; "" for none):

      half:      the half dtypes its entries touch;
      contract:  each contraction's (operand dtypes as read, accumulation
                 dtype), a complex dtype read as its real parts' (a complex
                 product is four real ones);
      fft:       the dtypes its transforms read and write (the port splits
                 an inverse into a c2c and a c2r transform where JAX runs
                 one);
      tanh:      whether tanh runs there.

    The reference's ``pallas_call`` entries are left out (its body's
    ``dot_general``s stay); a port kernel entry is a contraction at its
    ``cast_to`` grid with f32 accumulation."""
    proj: Dict[str, dict] = {}
    for entry in trace:
        head, *tags = entry.split("@")
        prim = head.split(":", 1)[0].split("[", 1)[0]
        if prim == "pallas_call":
            continue
        ins, outs = head.split(":", 1)[1].split("->")
        ins_l = [d for d in ins.split(",") if d]
        outs_l = [d for d in outs.split(",") if d]
        acc = next((t[4:] for t in tags if t.startswith("acc=")), None)
        site = _stage_site(next((t for t in tags if not t.startswith("acc=")), None))
        p = proj.setdefault(site, {"half": set(), "contract": set(), "fft": set(),
                                   "tanh": False})
        p["half"].update(d for d in ins_l + outs_l if d in ("bfloat16", "float16"))
        if prim in ("dot_general", "kernel"):
            ops = sorted({_REAL_OF.get(d, d) for d in ins_l})
            p["contract"].add((",".join(ops), _REAL_OF.get(acc, acc)))
        elif prim == "fft":
            p["fft"].update(ins_l + outs_l)
        elif prim == "tanh":
            p["tanh"] = True
    return {site: {"half": sorted(p["half"]), "contract": sorted(p["contract"]),
                   "fft": sorted(p["fft"]), "tanh": p["tanh"]}
            for site, p in sorted(proj.items())
            if p["half"] or p["contract"] or p["fft"] or p["tanh"]}
