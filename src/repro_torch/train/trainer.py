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
    leading axis, their gradients averaged.
"""
from __future__ import annotations

import copy
import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from repro_torch.core.schedule import PrecisionSchedule
from repro_torch.device import DeviceLike, resolve_device
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
    #: not ported yet: setting any of these raises (ROADMAP slices named
    #: in the error)
    autoprec: Optional[Any] = None
    telemetry: bool = False
    calibration_state: Optional[str] = None
    obs: bool = False


def _unported(config: TrainerConfig) -> None:
    if config.autoprec is not None or config.telemetry:
        raise NotImplementedError(
            "TrainerConfig autoprec/telemetry are not ported yet "
            "(ROADMAP: auto-precision slice)")
    if config.calibration_state is not None:
        raise NotImplementedError(
            "TrainerConfig.calibration_state is not ported yet (ROADMAP: tuning slice)")
    if config.obs:
        raise NotImplementedError(
            "TrainerConfig.obs is not ported yet (ROADMAP: observability slice)")


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
        _unported(config)
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.cfg = config
        self.model = copy.deepcopy(model).to(self.device)
        self.params: Dict[str, nn.Parameter] = dict(self.model.named_parameters())
        self.opt_state = config.optimizer.init(self.params)
        self.scale_state = init_loss_scale(device=self.device)
        self.step = 0
        self.history: list = []
        self.stats = {"straggler_steps": 0, "skipped_steps": 0}
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
        """(loss, grads) of one step: the (scaled) loss and its gradients,
        averaged over the micro-batches."""
        names = list(self.params)
        leaves = [self.params[k] for k in names]

        def micro(b):
            loss = self.loss_fn(self.model, b, policy)
            if use_scaling:
                loss = scale_loss(loss, self.scale_state)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), dict(zip(names, grads))

        nmicro = self.cfg.microbatches
        if nmicro == 1:
            return micro(batch)
        sizes = {k: v.shape[0] for k, v in batch.items()}
        if any(s % nmicro for s in sizes.values()):
            raise ValueError(f"batch sizes {sizes} do not split into {nmicro} micro-batches")
        acc_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        acc = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        for i in range(nmicro):
            b = {k: v.reshape(nmicro, v.shape[0] // nmicro, *v.shape[1:])[i]
                 for k, v in batch.items()}
            loss, g = micro(b)
            acc = {k: acc[k] + g[k] for k in names}
            acc_loss = acc_loss + loss
        inv = 1.0 / nmicro
        return acc_loss * inv, {k: g * inv for k, g in acc.items()}

    def _train_step(self, policy: PrecisionPolicy, batch) -> tuple:
        use_scaling = loss_scaling_required(policy)
        loss, grads = self._grads(batch, policy, use_scaling)
        if use_scaling:
            grads = unscale_grads(grads, self.scale_state)
            loss = loss / self.scale_state.scale
        finite = bool(all_finite(grads))
        if finite:
            new_params, self.opt_state = self.cfg.optimizer.update(
                grads, self.opt_state, self.params)
            with torch.no_grad():
                for k, p in self.params.items():
                    p.copy_(new_params[k])
        if use_scaling:
            self.scale_state = update_loss_scale(self.scale_state, finite)
        return float(loss), finite

    # -- the loop -------------------------------------------------------------
    def run(self, batch_fn: Callable[[int], Mapping], steps: Optional[int] = None):
        """``batch_fn(step)`` -> a dict of arrays (stateless pipeline
        contract); the trainer moves them to its device."""
        total = steps if steps is not None else self.cfg.total_steps
        ewma = None
        while self.step < total and not self._preempted:
            policy = self.cfg.schedule.policy_at(self.step, self.cfg.total_steps)
            batch = self._to_device(batch_fn(self.step))
            t0 = time.perf_counter()
            loss, finite = self._train_step(policy, batch)
            dt = time.perf_counter() - t0
            if not finite:
                self.stats["skipped_steps"] += 1
            if ewma is not None and dt > self.cfg.straggler_factor * ewma:
                self.stats["straggler_steps"] += 1
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            self.history.append({"step": self.step, "loss": loss,
                                 "policy": policy.name, "dt": dt, "finite": finite})
            self.step += 1
            if self._ckptr is not None and self.step % self.cfg.ckpt_every == 0:
                self.save()
        if self._preempted and self._ckptr is not None:
            self.save()
        if self._ckptr is not None:
            self._ckptr.wait()
        return self.history
