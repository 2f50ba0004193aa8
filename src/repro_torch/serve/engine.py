"""The serving protocol and the LM slot engine.

Every engine speaks the same four verbs:

    submit(req) -> bool     queue a request (capacity-rejected => failed)
    tick()                  one batched device step
    drain(max_ticks)        tick until idle; returns finished requests
    stats()                 tokens/s or fields/s, slot occupancy, queue

``LMEngine`` serves the LM pool from a fixed pool of slots with
continuous batching: a :class:`~repro_torch.serve.scheduler.Scheduler`
owns admission (FCFS or shortest-prompt-first) and rejects at submit a
request that cannot fit ``max_len``; up to ``prefill_chunk`` pending
prompt tokens a slot are consumed a tick through one ``lm_prefill_chunk``
step (a prompt costs ceil(len/K) ticks instead of len); a pure-decode
tick runs the one-token ``lm_decode_step``; sampling is per request
(greedy, temperature, top-k, top-p) at the ``serve/sampler`` site.

Each tick copies the (B, V) f32 logits to the host once; greedy picks
its token there with ``argmax``.  The steps dispatch op by op (the
reference jits them), so small ticks are host-bound.

With ``mesh`` (a named ``DeviceMesh``, one process a rank) the engine
serves sharded through the ``repro_torch.dist`` rule tables, as the
reference does: the parameters placed as DTensors by ``lm_param_specs``,
the slot cache by ``cache_specs``, each tick's tokens by ``batch_specs``.
Every rank runs the same engine on the same requests in lockstep; the
logits are gathered whole on every rank, so each samples the same tokens.

With tracing on (``repro_torch.obs.trace``), each accepted request is an
async ``request`` track from submit to finish, each tick a
``serve/tick`` span (and ``serve/prefill`` or ``serve/decode`` for the
LM engine); ``stats()`` publishes its numbers into the obs registry as
``repro_serve_<kind>_*`` gauges.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import LMArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.constrain import use_mesh
from repro_torch.dist.sharding import fill_slots
from repro_torch.models.lm import init_cache, lm_decode_step, lm_prefill_chunk
from repro_torch.obs import numerics_event, registry
from repro_torch.obs import trace as obs_trace
from repro_torch.precision import FULL, PrecisionPolicy

from .sampler import GREEDY, SamplingParams, request_key, sample_token
from .scheduler import Scheduler


@dataclasses.dataclass(eq=False)
class Request:
    """One LM generation request.  Identity semantics (``eq=False``): two
    requests are never the same work item because their fields match."""

    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = GREEDY
    generated: List[int] = dataclasses.field(default_factory=list)
    status: str = "new"          # new | queued | running | done | failed
    error: Optional[str] = None
    submit_tick: int = -1
    start_tick: int = -1
    finish_tick: int = -1

    @property
    def done(self) -> bool:
        return self.status == "done"


@runtime_checkable
class Engine(Protocol):
    """The engine-agnostic serving protocol (LM and operator engines)."""

    def submit(self, req) -> bool: ...
    def tick(self) -> None: ...
    def drain(self, max_ticks: int = 10_000) -> Tuple[List[Any], int]: ...
    def stats(self) -> Dict[str, Any]: ...


class EngineBase:
    """Shared slot bookkeeping + drain loop + stats scaffolding."""

    kind = "engine"

    def __init__(self, scheduler: Scheduler, n_slots: int):
        self.scheduler = scheduler
        self.n_slots = n_slots
        self._ticks = 0
        self._tick0 = 0     # tick count at the last reset_counters()
        self._wall_s = 0.0
        self._occupancy_sum = 0.0
        self._n_done = 0
        self._n_failed = 0

    # subclasses implement one device step over the current slots
    def _tick_impl(self) -> List[Any]:
        raise NotImplementedError

    def _busy(self) -> bool:
        raise NotImplementedError

    def submit(self, req) -> bool:
        ok = self.scheduler.submit(req, self._ticks)
        if not ok:
            self._n_failed += 1
        elif obs_trace.is_enabled():
            # request lifecycle: an async track slice per uid, queued at
            # submit, closed when the request finishes
            obs_trace.begin("request", getattr(req, "uid", id(req)),
                            category="request", engine=self.kind)
        return ok

    def tick(self) -> List[Any]:
        """One engine step.  Returns the requests finished this tick."""
        t0 = time.perf_counter()
        with obs_trace.span("serve/tick", engine=self.kind, tick=self._ticks):
            finished = self._tick_impl()
        self._wall_s += time.perf_counter() - t0
        self._ticks += 1
        for r in finished:
            r.finish_tick = self._ticks
            r.status = "done"
            self._n_done += 1
            if obs_trace.is_enabled():
                obs_trace.end("request", getattr(r, "uid", id(r)),
                              category="request",
                              ticks=self._ticks - getattr(r, "submit_tick", 0))
        return finished

    def drain(self, max_ticks: int = 10_000) -> Tuple[List[Any], int]:
        """Tick until every submitted request is finished (or max_ticks).
        Capacity-rejected requests come back *failed* rather than burning
        ticks."""
        finished: List[Any] = list(self.scheduler.take_failed())
        ticks = 0
        while (self.scheduler.depth or self._busy()) and ticks < max_ticks:
            finished.extend(self.tick())
            ticks += 1
        finished.extend(self.scheduler.take_failed())
        return finished, ticks

    def stats(self) -> Dict[str, Any]:
        denom = max(self._ticks - self._tick0, 1)
        out = {
            "engine": self.kind,
            "ticks": self._ticks,
            "wall_s": round(self._wall_s, 6),
            "n_slots": self.n_slots,
            "slot_occupancy": round(self._occupancy_sum / denom, 4),
            "completed": self._n_done,
            "failed": self._n_failed,
            "queue": self.scheduler.stats(),
            **self._extra_stats(),
        }
        # the dict stays the caller-facing return; the registry snapshot
        # is the machine-readable export source for the same numbers
        registry().publish(f"serve_{self.kind}", out)
        return out

    def _extra_stats(self) -> Dict[str, Any]:
        return {}

    def reset_counters(self) -> None:
        """Zero the engine's throughput/occupancy counters (call between a
        warm-up and a measurement, with no requests in flight).  The
        absolute tick count is kept, since scheduler wait accounting is
        keyed on it; occupancy averages over ticks since the reset."""
        self._tick0 = self._ticks
        self._wall_s = 0.0
        self._occupancy_sum = 0.0
        self._n_done = 0
        self._n_failed = 0
        self._reset_extra_counters()

    def _reset_extra_counters(self) -> None:
        pass


# ---------------------------------------------------------------------------
# LM engine
# ---------------------------------------------------------------------------


class LMEngine(EngineBase):
    """Continuous-batching LM serving over ``n_slots`` slots.

    ``params``: an :class:`~repro_torch.models.lm.LM` that already lives
    on ``device`` (CUDA unless the caller names another).  ``prefill_chunk``
    defaults to 1 for MoE archs (capacity dispatch depends on the batch
    composition, so a chunk routes differently from token-by-token) and 8
    otherwise.  ``seed`` seeds the per-request sampling generators.
    ``telemetry`` keeps numerics counters over the logits (running amax,
    non-finite count, a ``nonfinite_logits`` numerics event per bad
    tick); ``record_logits`` keeps every request's per-step logits rows
    (:meth:`logits_for`).  ``mesh``: serve sharded on this named
    ``DeviceMesh`` (its device type must be the engine's); None serves
    on one device.
    """

    kind = "lm"

    def __init__(
        self,
        params,
        cfg: LMArchConfig,
        n_slots: int = 4,
        max_len: int = 512,
        policy: PrecisionPolicy = FULL,
        mesh=None,
        scheduler: str = "fcfs",
        prefill_chunk: Optional[int] = None,
        seed: int = 0,
        telemetry: bool = False,
        record_logits: bool = False,
        device: DeviceLike = None,
    ):
        if cfg.encoder_decoder:
            raise ValueError(f"{cfg.name} is an encoder-decoder model; LMEngine serves "
                             "decoder-only archs (use whisper_decode_step directly)")
        if prefill_chunk is None:
            prefill_chunk = 1 if cfg.moe_experts else 8
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.device = resolve_device(device)
        held = {p.device for p in params.parameters()}
        if held != {self.device}:
            raise ValueError(f"model parameters live on {sorted(map(str, held))}, "
                             f"but the engine runs on {self.device}")
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise ValueError(f"mesh must be a named DeviceMesh, got {type(mesh).__name__}")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type} devices, "
                             f"but the engine runs on {self.device}")
        super().__init__(
            Scheduler(scheduler, capacity_check=self._capacity_check,
                      cost=lambda r: len(r.prompt)),
            n_slots,
        )
        self.params = params
        self.cfg = cfg
        self.policy = policy
        self.max_len = max_len
        self.mesh = mesh
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        self._sampler_site = policy.at("serve/sampler")
        # an SWA arch keeps a ring narrower than max_len; a chunk must never
        # wrap rows an in-chunk query still needs, so a slot's chunk is
        # clamped to its remaining unwrapped rows
        if cfg.mixer in ("attn", "hymba"):
            self._kv_len = max_len if cfg.attn_window <= 0 else min(max_len, cfg.attn_window)
            self._ring = self._kv_len if cfg.attn_window > 0 else None
        else:
            self._kv_len = 0
            self._ring = None
        self.cache = self._build_cache()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.slot_pending: List[List[int]] = [[] for _ in range(n_slots)]
        self.slot_pos: List[int] = [0] * n_slots   # host mirror of the cache clocks
        self._record_logits = record_logits
        self._logits_log: Dict[int, List[np.ndarray]] = {}
        self._n_prompt_tokens = 0
        self._n_generated = 0
        self._prefill_ticks = 0
        self._decode_ticks = 0
        # numerics counters over the logits, already on the host
        self._telemetry_on = telemetry
        self._logits_amax = 0.0
        self._logits_nonfinite = 0
        self._rows_observed = 0
        self._build_steps()

    # -- build hooks (the paged engine overrides them) -------------------------
    def _build_cache(self):
        # KV storage at the serve/kv_cache site's dtype: f32 under `full`
        # for an exact decode, half under the AMP rule sets
        return init_cache(self.cfg, self.n_slots, self.max_len,
                          dtype=self.policy.at("serve/kv_cache").compute_dtype,
                          device=self.device)

    def _build_steps(self):
        if self.mesh is not None:
            self._place_on_mesh()
        params, cfg, policy = self.params, self.cfg, self.policy
        self._decode = lambda c, t: lm_decode_step(params, c, t, cfg, policy)
        self._chunk = lambda c, t, n: lm_prefill_chunk(params, c, t, n, cfg, policy)

    def _place_on_mesh(self):
        """Shard the serving state through the rule tables the dry-run
        derives its placements from: params by ``lm_param_specs``, the slot
        cache by ``cache_specs`` (tokens by ``batch_specs``, each tick).
        The caller's model is left as it was: a skeleton on the meta device
        takes its tensors, which the placement then splits."""
        from repro_torch.dist import cache_specs, distribute, lm_param_specs
        from repro_torch.models.lm import LM

        placed = LM(self.cfg)
        placed.load_state_dict(self.params.state_dict(), strict=True, assign=True)
        self.params = distribute(placed, self.mesh, lm_param_specs(placed, self.mesh))
        self.cache = distribute(self.cache, self.mesh,
                                cache_specs(self.cache, self.mesh, self.cfg))

    def _on_mesh(self):
        """The scope a step runs in: the mesh ambient on this thread (the
        engine may step on another thread than the one that built it), and
        on a mesh ``implicit_replication``, which lets the plain tensors a
        step makes (positions, masks, RoPE tables) meet the DTensors as
        replicated ones."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication

        stack = contextlib.ExitStack()
        stack.enter_context(use_mesh(self.mesh))
        stack.enter_context(implicit_replication())
        return stack

    def _tokens_in(self, tokens: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(tokens).to(self.device)
        if self.mesh is None:
            return t
        from repro_torch.dist import batch_specs, distribute

        return distribute(t, self.mesh, batch_specs(t, self.mesh))

    @staticmethod
    def _logits_out(logits: torch.Tensor) -> np.ndarray:
        if isinstance(logits, DTensor):
            logits = logits.full_tensor()
        return logits.cpu().numpy()

    # -- admission -------------------------------------------------------------
    def _capacity_check(self, req: Request) -> Tuple[bool, str]:
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len:
            return False, (
                f"request needs {need} cache rows "
                f"(prompt {len(req.prompt)} + max_new_tokens "
                f"{req.max_new_tokens}) but max_len is {self.max_len}"
            )
        return True, ""

    def _admit_slot(self, i: int, req: Request) -> int:
        """Slot-admission hook; returns the request's starting position
        (nonzero where a cached prompt prefix lets prefill be skipped)."""
        del i, req
        return 0

    @torch.no_grad()
    def _reset_slots(self, admitted: List[Tuple[int, int]]):
        """Reset the admitted slots' clocks and invalidate their cache rows,
        one indexed update per array: the other slots keep decoding
        undisturbed.  ``admitted`` is [(slot, start_pos), ...]."""
        ids = torch.tensor([i for i, _ in admitted], dtype=torch.long, device=self.device)
        starts = torch.tensor([s for _, s in admitted], dtype=torch.int32, device=self.device)
        c = self.cache
        fill_slots(c["step"], ids, starts)
        if "kv_pos" in c:
            fill_slots(c["kv_pos"], ids, -1, slot_dim=1)
        if "ssd_state" in c:
            fill_slots(c["ssd_state"], ids, 0.0, slot_dim=1)

    def _release_slot(self, i: int):
        """Slot-release hook (the request finished)."""
        del i

    def _on_prefill_complete(self, i: int, req: Request):
        """Called once per request, the tick its last prompt token is
        consumed."""
        del i, req

    def _assign_slots(self):
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return
        admitted: List[Tuple[int, int]] = []
        for i, req in zip(free, self.scheduler.take(len(free), self._ticks), strict=False):
            self.slots[i] = req
            start = self._admit_slot(i, req)
            self.slot_pos[i] = start
            # an empty prompt decodes from token 0
            self.slot_pending[i] = list(req.prompt)[start:] or [0]
            admitted.append((i, start))
        if admitted:
            self._reset_slots(admitted)

    def _observe_logits(self, logits: np.ndarray) -> None:
        """Update the numerics counters over the active slots' rows."""
        if not self._telemetry_on:
            return
        rows = [i for i, s in enumerate(self.slots) if s is not None]
        if not rows:
            return
        sub = logits[rows]
        finite = np.isfinite(sub)
        if finite.any():
            self._logits_amax = max(self._logits_amax, float(np.abs(sub[finite]).max()))
        n_bad = int((~finite).sum())
        if n_bad:
            numerics_event("nonfinite_logits", site="serve/logits", count=n_bad,
                           tick=self._ticks)
        self._logits_nonfinite += n_bad
        self._rows_observed += len(rows)

    # -- sampling --------------------------------------------------------------
    def _next_token(self, req: Request, logits_row: np.ndarray) -> int:
        if req.sampling.temperature <= 0.0:
            # greedy: the row is already an f32 host array
            return int(np.argmax(logits_row))
        gen = request_key(self.seed, req.uid, len(req.generated))
        return sample_token(logits_row, req.sampling, gen,
                            site=self._sampler_site)

    def _record(self, req: Request, logits_row: np.ndarray):
        if self._record_logits:
            self._logits_log.setdefault(req.uid, []).append(np.array(logits_row, copy=True))

    def logits_for(self, uid: int) -> List[np.ndarray]:
        """Per-step logits rows recorded for ``uid`` (needs
        ``record_logits=True``)."""
        return self._logits_log.get(uid, [])

    def _finish_or_continue(self, i: int, req: Request, finished: List[Request]):
        if len(req.generated) >= req.max_new_tokens:
            finished.append(req)
            self.slots[i] = None  # free the slot (continuous batching)
            self._release_slot(i)

    # -- one engine tick -------------------------------------------------------
    def _busy(self) -> bool:
        return any(s is not None for s in self.slots)

    def _tick_impl(self) -> List[Request]:
        self._assign_slots()
        self._occupancy_sum += sum(s is not None for s in self.slots) / self.n_slots
        prefilling = any(self.slots[i] is not None and self.slot_pending[i]
                         for i in range(self.n_slots))
        if prefilling and self.prefill_chunk > 1:
            with obs_trace.span("serve/prefill"):
                return self._tick_chunk()
        with obs_trace.span("serve/decode"):
            return self._tick_decode()

    def _chunk_limit(self, i: int) -> int:
        """Largest safe chunk for slot i (the ring-wrap guard)."""
        if self._ring is None:
            return self.prefill_chunk
        return max(1, min(self.prefill_chunk, self._ring - self.slot_pos[i]))

    def _prompt_done(self, i: int, req: Request):
        self._on_prefill_complete(i, req)
        if obs_trace.is_enabled():
            obs_trace.event("serve/prefill_complete", category="request", uid=req.uid,
                            prompt_tokens=len(req.prompt))

    def _emit(self, i: int, req: Request, row: np.ndarray, finished: List[Request]):
        self._record(req, row)
        req.generated.append(self._next_token(req, row))
        self._n_generated += 1
        self._finish_or_continue(i, req, finished)

    def _tick_chunk(self) -> List[Request]:
        """Chunked prefill tick: up to K pending prompt tokens a prefilling
        slot; decoding slots ride along as one-token rows.  The step that
        consumes a slot's last prompt token also emits its first generated
        token."""
        K = self.prefill_chunk
        tokens = np.zeros((self.n_slots, K), np.int64)
        n_valid = np.zeros((self.n_slots,), np.int64)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if self.slot_pending[i]:
                k = min(len(self.slot_pending[i]), self._chunk_limit(i))
                tokens[i, :k] = self.slot_pending[i][:k]
                n_valid[i] = k
            else:
                tokens[i, 0] = req.generated[-1]
                n_valid[i] = 1
        logits = self._run_chunk(tokens, n_valid)
        self._observe_logits(logits)
        self._prefill_ticks += 1
        finished: List[Request] = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            k = int(n_valid[i])
            if self.slot_pending[i]:
                del self.slot_pending[i][:k]
                self.slot_pos[i] += k
                self._n_prompt_tokens += k
                if self.slot_pending[i]:
                    continue  # still prefilling this slot
                self._prompt_done(i, req)
            else:
                self.slot_pos[i] += 1
            self._emit(i, req, logits[i], finished)
        return finished

    def _run_chunk(self, tokens: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
        # n_valid stays on the host: the step finds its write rows there
        with self._on_mesh():
            logits, self.cache = self._chunk(self.cache, self._tokens_in(tokens),
                                             torch.from_numpy(n_valid))
            return self._logits_out(logits)

    def _run_decode(self, tokens: np.ndarray) -> np.ndarray:
        with self._on_mesh():
            logits, self.cache = self._decode(self.cache, self._tokens_in(tokens))
            return self._logits_out(logits)

    def _tick_decode(self) -> List[Request]:
        """One one-token decode step for the slot pool (also the prefill
        path at ``prefill_chunk=1``: teacher-forced token by token).  The
        step that consumes a slot's last prompt token is the one whose
        logits give its first generated token."""
        tokens = np.zeros((self.n_slots,), np.int64)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tokens[i] = self.slot_pending[i][0] if self.slot_pending[i] else req.generated[-1]
        logits = self._run_decode(tokens)
        self._observe_logits(logits)
        self._decode_ticks += 1
        finished: List[Request] = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slot_pos[i] += 1
            if self.slot_pending[i]:
                self.slot_pending[i].pop(0)
                self._n_prompt_tokens += 1
                if self.slot_pending[i]:
                    continue  # still prefilling this slot
                self._prompt_done(i, req)
            self._emit(i, req, logits[i], finished)
        return finished

    def run_until_done(self, requests: List[Request],
                       max_ticks: int = 10_000) -> Tuple[List[Request], int]:
        """Submit ``requests`` and drain: (finished, ticks).  A request that
        cannot fit comes back failed."""
        for r in requests:
            self.submit(r)
        return self.drain(max_ticks)

    def _extra_stats(self) -> Dict[str, Any]:
        processed = self._n_prompt_tokens + self._n_generated
        out = {
            "device": str(self.device),
            "policy": self.policy.name,
            "prefill_chunk": self.prefill_chunk,
            "prefill_ticks": self._prefill_ticks,
            "decode_ticks": self._decode_ticks,
            "prompt_tokens": self._n_prompt_tokens,
            "tokens_generated": self._n_generated,
            "tokens_per_s": round(processed / self._wall_s, 2) if self._wall_s else None,
        }
        if self._telemetry_on:
            out["numerics"] = {
                "logits_amax": self._logits_amax,
                "logits_nonfinite": self._logits_nonfinite,
                "rows_observed": self._rows_observed,
            }
        return out

    def _reset_extra_counters(self) -> None:
        self._n_prompt_tokens = 0
        self._n_generated = 0
        self._prefill_ticks = 0
        self._decode_ticks = 0
        self._logits_amax = 0.0
        self._logits_nonfinite = 0
        self._rows_observed = 0


#: The slot engine's earlier name.
ServeEngine = LMEngine
