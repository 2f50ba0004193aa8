"""The training loop: precision schedule, loss scaling, checkpoints,
preemption, stragglers.

One Trainer drives any model through a user-supplied
``loss_fn(model, batch, policy) -> scalar tensor``.

  * **precision schedule** (paper §4.4): the schedule's policy at each
    step is handed to ``loss_fn``.  PyTorch runs eagerly, so a phase
    change needs no recompile;
  * **dynamic loss scaling + skip-step** where the policy's rules ask for
    it (the fp16 family): a non-finite gradient skips the update, counts
    in ``stats["skipped_steps"]`` and backs the scale off;
  * **checkpoint/restart**: asynchronous atomic checkpoints every
    ``ckpt_every`` steps; :meth:`Trainer.restore` resumes with the same
    parameters, optimizer state, loss scale and step (the data pipeline
    is stateless, so nothing else needs storing);
  * **preemption**: SIGTERM sets a flag; the loop checkpoints at the next
    step boundary and stops;
  * **straggler monitor**: an EWMA of the step wall time; steps slower
    than ``straggler_factor`` times it are counted in ``stats``;
  * **gradient accumulation** over ``microbatches`` slices of the batch's
    leading axis, their gradients averaged;
  * **auto-precision** (``TrainerConfig.autoprec``, or a schedule built by
    ``PrecisionSchedule.auto``): the controller's policy replaces the
    schedule's, each microbatch's forward runs under one telemetry
    collector (their snapshots merged as ``merge_stacked`` does), and
    every ``interval`` steps the controller consumes the telemetry window;
    ``stats["policy_changes"]`` counts the overlays it changed.
    ``TrainerConfig.telemetry`` collects without a controller.  The port
    compiles no step, so a policy change rebuilds nothing and there is no
    ``recompiles`` counter; the loss-scale state carries across changes;
  * **tuned tiles** (``TrainerConfig.calibration_state``): a
    ``repro_torch.tune`` calibration file activated at construction;
  * **observability** (``TrainerConfig.obs``): the trace ring on, the
    ``train/data``, ``train/step`` (the step and its ``float(loss)``
    sync), ``train/telemetry`` and ``train/controller`` spans, the
    step-wall histogram, the step counter, loss-scale numerics events and
    ``publish_stats`` at the end of ``run``.
"""
from __future__ import annotations

import copy
import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from repro_torch.autoprec import AutoPrecisionController, TelemetryAggregator
from repro_torch.autoprec.telemetry import (
    TraceCollector,
    collecting,
    merge_stacked,
    stack_snapshots,
)
from repro_torch.core.schedule import PrecisionSchedule
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import loss_scale_event, registry
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import (
    AdamW,
    all_finite,
    init_loss_scale,
    loss_scaling_required,
    scale_loss,
    unscale_grads,
    update_loss_scale,
)
from repro_torch.precision import PrecisionPolicy

from . import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    schedule: PrecisionSchedule = dataclasses.field(
        default_factory=lambda: PrecisionSchedule.constant("full"))
    optimizer: AdamW = dataclasses.field(default_factory=AdamW)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_last_k: int = 3
    microbatches: int = 1
    straggler_factor: float = 3.0
    #: an ``repro_torch.autoprec.AutoPrecisionController`` that supersedes
    #: the schedule; ``PrecisionSchedule.auto(...)`` creates one implicitly
    autoprec: Optional[Any] = None
    #: collect numerics telemetry (amax / overflow / underflow taps) without
    #: a controller
    telemetry: bool = False
    #: calibration-state JSON (``repro_torch.tune``), activated at Trainer
    #: construction so the tuned kernels take its validated tiles; None
    #: keeps whatever is already active (an explicit ``activate()`` or
    #: ``$REPRO_CALIBRATION_STATE``)
    calibration_state: Optional[str] = None
    #: observability (``repro_torch.obs``): turn the trace ring on (if not
    #: already on) and record the step's phase spans, loss-scale numerics
    #: events and step-wall histograms in the metrics registry.  The span
    #: calls are free no-ops while tracing is off.
    obs: bool = False


def _nest(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``{"lift1.w": t}`` -> ``{"lift1": {"w": t}}``: the reference's
    parameter-tree layout, which the checkpoint keys follow."""
    out: Dict[str, Any] = {}
    for name, t in flat.items():
        *groups, leaf = name.split(".")
        node = out
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = t
    return out


def _flat(nested: Mapping[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in nested.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class Trainer:
    """Trains a copy of ``model`` on ``device`` (CUDA unless the caller
    names another).  The caller's model is left untouched; the trained
    one is ``trainer.model`` (its parameters: ``trainer.params``)."""

    def __init__(self, loss_fn: Callable[[nn.Module, Dict, PrecisionPolicy], torch.Tensor],
                 model: nn.Module, config: TrainerConfig, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.cfg = config
        self.model = copy.deepcopy(model).to(self.device)
        self.params: Dict[str, nn.Parameter] = dict(self.model.named_parameters())
        self.opt_state = config.optimizer.init(self.params)
        self.scale_state = init_loss_scale(device=self.device)
        self.step = 0
        self.history: list = []
        self.stats = {"straggler_steps": 0, "skipped_steps": 0, "policy_changes": 0}
        # auto-precision: an explicit controller wins; a schedule in auto
        # mode gets a default controller over its base policy
        self.controller = config.autoprec
        if config.schedule.mode == "auto" and self.controller is None:
            self.controller = AutoPrecisionController(
                base=config.schedule.base, grid_points=config.schedule.grid_points)
        self.telemetry = None
        if config.telemetry or self.controller is not None:
            self.telemetry = TelemetryAggregator()
        if config.calibration_state is not None:
            from repro_torch.tune.cache import activate

            activate(config.calibration_state)
        self._obs = bool(config.obs)
        if self._obs and not obs_trace.is_enabled():
            obs_trace.enable()
        self._last_scale: Optional[float] = None
        self._preempted = False
        self._ckptr = (ckpt_lib.AsyncCheckpointer(config.ckpt_dir, config.keep_last_k)
                       if config.ckpt_dir else None)

    # -- fault tolerance ----------------------------------------------------
    def install_preemption_handler(self, signum=signal.SIGTERM):
        signal.signal(signum, lambda *_: self._on_preempt())

    def _on_preempt(self):
        self._preempted = True

    def _state(self) -> Dict[str, Any]:
        return {
            "params": _nest({k: p.detach() for k, p in self.params.items()}),
            "opt": self.opt_state._replace(mu=_nest(self.opt_state.mu),
                                           nu=_nest(self.opt_state.nu)),
            "scale": self.scale_state,
            "step": torch.tensor(self.step, dtype=torch.int32),
        }

    def save(self, wait: bool = False):
        """Checkpoint the current step; ``wait`` blocks until it is on disk."""
        if self._ckptr is None:
            return
        self._ckptr.save(self.step, self._state())
        if wait:
            self._ckptr.wait()

    def restore(self, step: Optional[int] = None) -> bool:
        """Load the checkpoint of ``step`` (default: the latest); False if
        there is none."""
        if self.cfg.ckpt_dir is None or ckpt_lib.latest_step(self.cfg.ckpt_dir) is None:
            return False
        state, _ = ckpt_lib.restore(self.cfg.ckpt_dir, self._state(), step)
        with torch.no_grad():
            for k, v in _flat(state["params"]).items():
                self.params[k].copy_(v)
        opt = state["opt"]
        self.opt_state = opt._replace(mu=_flat(opt.mu), nu=_flat(opt.nu))
        self.scale_state = state["scale"]
        self.step = int(state["step"])
        return True

    # -- one step -------------------------------------------------------------
    def _to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _grads(self, batch, policy, use_scaling):
        """(loss, grads, telemetry) of one step: the (scaled) loss and its
        gradients, averaged over the micro-batches, and the step's telemetry
        snapshot (``{}`` when telemetry is off).  Only the forward runs
        under the collector."""
        names = list(self.params)
        leaves = [self.params[k] for k in names]
        snapshots = []

        def micro(b):
            if self.telemetry is not None:
                col = TraceCollector()
                with collecting(col):
                    loss = self.loss_fn(self.model, b, policy)
                snapshots.append(col.snapshot())
            else:
                loss = self.loss_fn(self.model, b, policy)
            if use_scaling:
                loss = scale_loss(loss, self.scale_state)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), dict(zip(names, grads))

        nmicro = self.cfg.microbatches
        if nmicro == 1:
            loss, grads = micro(batch)
            return loss, grads, snapshots[0] if snapshots else {}
        sizes = {k: v.shape[0] for k, v in batch.items()}
        if any(s % nmicro for s in sizes.values()):
            raise ValueError(f"batch sizes {sizes} do not split into {nmicro} micro-batches")
        acc_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        acc = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        for i in range(nmicro):
            b = {k: v.reshape(nmicro, v.shape[0] // nmicro, *v.shape[1:])[i]
                 for k, v in batch.items()}
            loss, g = micro(b)
            for k in names:     # summed in place: one f32 buffer a leaf
                acc[k].add_(g.pop(k))
            acc_loss = acc_loss + loss
        inv = 1.0 / nmicro
        telem = merge_stacked(stack_snapshots(snapshots)) if snapshots else {}
        return acc_loss * inv, {k: g.mul_(inv) for k, g in acc.items()}, telem

    def _train_step(self, policy: PrecisionPolicy, batch) -> tuple:
        use_scaling = loss_scaling_required(policy)
        loss, grads, telem = self._grads(batch, policy, use_scaling)
        if use_scaling:
            grads = unscale_grads(grads, self.scale_state)
            loss = loss / self.scale_state.scale
        finite = bool(all_finite(grads))
        if finite:
            # the parameters and the moments written in place a leaf at a
            # time, as the reference's step donates its own
            self.opt_state = self.cfg.optimizer.update_(grads, self.opt_state, self.params)
        if use_scaling:
            self.scale_state = update_loss_scale(self.scale_state, finite)
        return float(loss), finite, telem

    # -- observability --------------------------------------------------------
    def _obs_step_end(self, dt: float) -> None:
        """Per-step metrics + loss-scale numerics events (obs mode only;
        the extra ``float(scale)`` sync is why this is gated)."""
        registry().histogram("repro_train_step_wall_ms").observe(dt * 1e3)
        registry().counter("repro_train_steps_total").inc()
        new_scale = float(self.scale_state.scale)
        if self._last_scale is not None and new_scale != self._last_scale:
            kind = ("loss_scale_halved" if new_scale < self._last_scale
                    else "loss_scale_grown")
            loss_scale_event(kind, new_scale, step=self.step)
        self._last_scale = new_scale

    def publish_stats(self) -> Dict:
        """Publish ``self.stats`` into the obs registry as
        ``repro_train_*`` gauges and return the dict (the registry
        snapshot is the machine-readable export source)."""
        registry().publish("train", self.stats)
        registry().gauge("repro_train_step").set(float(self.step))
        return self.stats

    # -- the loop -------------------------------------------------------------
    def run(self, batch_fn: Callable[[int], Mapping], steps: Optional[int] = None):
        """``batch_fn(step)`` -> a dict of arrays (stateless pipeline
        contract); the trainer moves them to its device."""
        total = steps if steps is not None else self.cfg.total_steps
        ewma = None
        while self.step < total and not self._preempted:
            if self.controller is not None:
                # auto mode: the controller's overlay decides the formats
                policy = self.controller.policy()
            else:
                policy = self.cfg.schedule.policy_at(self.step, self.cfg.total_steps)
            with obs_trace.span("train/data", step=self.step):
                batch = self._to_device(batch_fn(self.step))
            t0 = time.perf_counter()
            # the span brackets the step and its float(loss) sync, so its
            # duration carries the step's device wall
            with obs_trace.span("train/step", step=self.step, policy=policy.name):
                loss, finite, telem = self._train_step(policy, batch)
            dt = time.perf_counter() - t0
            if not finite:
                self.stats["skipped_steps"] += 1
            if ewma is not None and dt > self.cfg.straggler_factor * ewma:
                self.stats["straggler_steps"] += 1
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if self.telemetry is not None:
                with obs_trace.span("train/telemetry", step=self.step):
                    self.telemetry.update(telem)
            if self._obs:
                self._obs_step_end(dt)
            self.history.append({"step": self.step, "loss": loss,
                                 "policy": policy.name, "dt": dt, "finite": finite})
            self.step += 1
            if (self.controller is not None
                    and self.step % self.controller.config.interval == 0):
                with obs_trace.span("train/controller", step=self.step):
                    if self.controller.update(self.telemetry.take_window(), step=self.step):
                        self.stats["policy_changes"] += 1
            if self._ckptr is not None and self.step % self.cfg.ckpt_every == 0:
                self.save()
        if self._preempted and self._ckptr is not None:
            self.save()
        if self._ckptr is not None:
            self._ckptr.wait()
        if self._obs:
            self.publish_stats()
        return self.history
