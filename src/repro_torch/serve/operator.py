"""Operator serving: micro-batched FNO/SFNO field inference.

Each request carries one input field ``(C, *spatial)``.  The engine
groups the waiting queue into *resolution buckets* (FNO weights are
resolution-agnostic, but one batched forward needs one spatial shape; the
SFNO's grid is fixed by its Legendre matrices), admits up to
``max_batch`` same-resolution requests per tick through the scheduler
policy, pads them to ``max_batch`` fields and runs one batched
``fno_infer`` / ``sfno_infer`` on the engine's device.

Every op in the forward is per-sample independent and every micro-batch
has the same width, so a field's answer does not depend on what it was
batched with: batched output is bit-identical to serving the field alone
under the same precision policy.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.spectral import check_grid
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.fno import FNO, FNOConfig, fno_infer
from repro_torch.models.sfno import SFNO, SFNOConfig, sfno_infer
from repro_torch.precision import FULL, PrecisionPolicy

from .engine import EngineBase
from .scheduler import Scheduler


def content_key(x) -> str:
    """Content hash of an operator input field: exact bytes of the
    f32-normalised array plus its shape.  Two fields with equal keys are
    bitwise-identical inputs, so memoised outputs are bitwise-valid."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    h = hashlib.sha1(a.tobytes())
    h.update(str(a.shape).encode())
    return h.hexdigest()


@dataclasses.dataclass(eq=False)
class FieldRequest:
    """One operator-inference request: a single input field.  Identity
    semantics (``eq=False``): value comparison over the array payload is
    both meaningless and ambiguous."""

    uid: int
    x: Any                        # (C, *spatial) array-like
    y: Optional[np.ndarray] = None
    status: str = "new"           # new | queued | running | done | failed
    error: Optional[str] = None
    submit_tick: int = -1
    start_tick: int = -1
    finish_tick: int = -1

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def resolution(self) -> Tuple[int, ...]:
        return tuple(np.shape(self.x)[1:])


class OperatorEngine(EngineBase):
    """Micro-batching engine over ``fno_infer`` / ``sfno_infer``.

    ``net``: an :class:`~repro_torch.models.fno.FNO` (``model="fno"``) or
    an :class:`~repro_torch.models.sfno.SFNO` (``model="sfno"``) that
    already lives on ``device`` (CUDA unless the caller names another).
    ``max_batch`` is the micro-batch width: each tick fills up to ``max_batch``
    same-resolution requests into one batched forward.  ``memo_window``
    > 0 keeps an LRU of that many distinct fields' outputs, keyed by
    content, so a repeated field is answered without compute.
    """

    kind = "operator"

    def __init__(
        self,
        net: Union[FNO, SFNO],
        model: str = "fno",
        policy: PrecisionPolicy = FULL,
        max_batch: int = 8,
        scheduler: str = "fcfs",
        memo_window: int = 0,
        device: DeviceLike = None,
        telemetry: bool = False,
        autoprec=None,
        calibration_state: Optional[str] = None,
    ):
        kinds = {"fno": FNOConfig, "sfno": SFNOConfig}
        if model not in kinds:
            raise ValueError(f"model must be 'fno' or 'sfno', got {model!r}")
        if not isinstance(net.cfg, kinds[model]):
            raise ValueError(f"model={model!r} needs a {kinds[model].__name__} network, "
                             f"got one of {type(net.cfg).__name__}")
        if telemetry or autoprec is not None:
            raise NotImplementedError(
                "telemetry/autoprec are not ported yet (ROADMAP: auto-precision slice)")
        if calibration_state is not None:
            raise NotImplementedError(
                "calibration_state is not ported yet (ROADMAP: tuning slice)")
        self.device = resolve_device(device)
        held = {p.device for p in net.parameters()}
        if held != {self.device}:
            raise ValueError(f"model parameters live on {sorted(map(str, held))}, "
                             f"but the engine runs on {self.device}")
        super().__init__(
            Scheduler(
                scheduler,
                capacity_check=self._capacity_check,
                # spf for fields = smallest-grid-first
                cost=lambda r: float(np.prod(r.resolution, dtype=np.int64)),
            ),
            max_batch,
        )
        self.net = net
        self.cfg = net.cfg
        self.model = model
        self._infer = fno_infer if model == "fno" else sfno_infer
        self.policy = policy
        self.max_batch = max_batch
        # content-hash memo: identical input fields (by value, under the
        # engine's policy) reuse the computed output.  Sound because
        # inference is a pure function of (weights, field, policy) and
        # micro-batching is per-sample exact.  0 disables.
        self.memo_window = memo_window
        self._memo: OrderedDict[str, np.ndarray] = OrderedDict()
        self._memo_hits = 0
        self._memo_misses = 0
        self._memo_evictions = 0
        self._n_fields = 0
        self._n_points = 0
        self._n_batches = 0
        self._bucket_counts: Dict[str, int] = {}

    # -- admission -------------------------------------------------------------
    def _capacity_check(self, req: FieldRequest) -> Tuple[bool, str]:
        shape = tuple(np.shape(req.x))
        if len(shape) < 2:
            return False, f"field must be (channels, *spatial), got shape {shape}"
        if shape[0] != self.cfg.in_channels:
            return False, (
                f"field has {shape[0]} channels but the {self.model} config "
                f"expects {self.cfg.in_channels}"
            )
        if self.model == "sfno":
            want = (self.cfg.nlat, self.cfg.nlon)
            if shape[1:] != want:
                return False, f"sfno grid is fixed at {want}, got {shape[1:]}"
            return True, ""
        if len(shape) - 1 != self.cfg.ndim:
            return False, f"{self.cfg.ndim}-d FNO got a {len(shape) - 1}-d field"
        try:
            check_grid(shape[1:], self.cfg.modes)
        except ValueError as e:
            return False, str(e)
        return True, ""

    # -- one engine tick -------------------------------------------------------
    def _busy(self) -> bool:
        return False  # fields finish within their tick; no carried state

    def _memo_partition(self, batch: List[FieldRequest]
                        ) -> Tuple[Optional[List[str]], List[int]]:
        """Split a bucket batch into memoised fields and the indices that
        still need compute.  In-batch duplicates collapse onto the first
        occurrence; only that one enters the device batch."""
        if self.memo_window <= 0:
            return None, list(range(len(batch)))
        keys = [content_key(r.x) for r in batch]
        compute: List[int] = []
        pending = set()
        for j, k in enumerate(keys):
            if k in self._memo:
                self._memo.move_to_end(k)
                self._memo_hits += 1
            elif k in pending:
                self._memo_hits += 1
            else:
                pending.add(k)
                self._memo_misses += 1
                compute.append(j)
        return keys, compute

    def _tick_impl(self) -> List[FieldRequest]:
        batch = self.scheduler.take(
            self.max_batch, self._ticks, bucket_key=lambda r: r.resolution)
        self._occupancy_sum += len(batch) / self.max_batch
        if not batch:
            return []
        res = batch[0].resolution
        keys, compute = self._memo_partition(batch)
        computed: Dict[str, np.ndarray] = {}
        if compute:
            # pad to the fixed micro-batch width, so a field's output does
            # not depend on how full its batch was
            xb = np.zeros((self.max_batch, *np.shape(batch[0].x)), np.float32)
            for pos, j in enumerate(compute):
                xb[pos] = np.asarray(batch[j].x, np.float32)
            yb = self._infer(self.net, torch.from_numpy(xb), self.policy,
                             device=self.device)
            yb = yb.cpu().numpy()[:len(compute)]
            self._n_batches += 1
            names = [str(j) for j in compute] if keys is None else [keys[j] for j in compute]
            computed = dict(zip(names, yb, strict=True))
        key = "x".join(map(str, res))
        self._bucket_counts[key] = self._bucket_counts.get(key, 0) + len(batch)
        self._n_fields += len(batch)
        self._n_points += int(np.prod(res, dtype=np.int64)) * len(batch)
        for j, r in enumerate(batch):
            if keys is None:
                r.y = computed[str(j)]
            else:
                r.y = computed.get(keys[j], self._memo.get(keys[j]))
        if keys is not None:
            # admit this tick's fresh results, then LRU-trim: after the
            # batch is answered, so an admission never evicts a key a later
            # request in the same tick still needs
            self._memo.update(computed)
            while len(self._memo) > self.memo_window:
                self._memo.popitem(last=False)
                self._memo_evictions += 1
        return list(batch)

    def _extra_stats(self) -> Dict[str, Any]:
        out = {
            "model": self.model,
            "device": str(self.device),
            "max_batch": self.max_batch,
            "policy": self.policy.name,
            "fields_served": self._n_fields,
            "batches": self._n_batches,
            "avg_batch_fill": round(
                self._n_fields / (self._n_batches * self.max_batch), 4)
            if self._n_batches else 0.0,
            "buckets": dict(self._bucket_counts),
            "fields_per_s": round(self._n_fields / self._wall_s, 2)
            if self._wall_s else None,
            "points_per_s": round(self._n_points / self._wall_s, 2)
            if self._wall_s else None,
        }
        if self.memo_window > 0:
            seen = self._memo_hits + self._memo_misses
            out["memo"] = {
                "window": self.memo_window,
                "entries": len(self._memo),
                "hits": self._memo_hits,
                "misses": self._memo_misses,
                "hit_rate": round(self._memo_hits / seen, 4) if seen else 0.0,
                "evictions": self._memo_evictions,
            }
        return out

    def _reset_extra_counters(self) -> None:
        self._memo_hits = 0
        self._memo_misses = 0
        self._memo_evictions = 0
        self._n_fields = 0
        self._n_points = 0
        self._n_batches = 0
        self._bucket_counts = {}
