"""The FNO ``Trainer`` updates its state in place, as the reference's
donated step does (``AdamW.update_``, micro-batch gradients summed into one
f32 buffer a leaf), with the bits of the functional update it replaced.

* Three steps under ``full`` and ``mixed_fno_bf16``, with one and two
  micro-batches: every parameter, ``mu``, ``nu``, ``count`` and the loss
  history bit-equal to a trainer that steps as the port did before
  (``AdamW.update``, the new leaves copied in, the micro-batch sums made
  anew), and the trainer's parameters, moments and count the same tensor
  objects after the steps as before them.
* The fp16 skip-step (an overflowed gradient) leaves the parameters, the
  moments and the count untouched.
* A checkpoint saved before in-place steps keeps the saved values, and a
  restore followed by the remaining steps is the straight run's bit for
  bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.fno_paper import FNO_DARCY_SMOKE
from repro_torch.core.schedule import PrecisionSchedule
from repro_torch.models import fno_apply, init_fno
from repro_torch.optim import all_finite, loss_scaling_required, update_loss_scale
from repro_torch.optim.loss_scale import scale_loss, unscale_grads
from repro_torch.train import Trainer, TrainerConfig, relative_l2

STEPS, BATCH = 3, 4


def _batches(n, seed=7):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = rng.randn(BATCH, 1, 16, 16).astype(np.float32)
        u = 0.05 * (np.roll(a, 1, axis=-1) + 0.5 * a ** 2)
        out.append({"a": a, "u": u.astype(np.float32)})
    return out


def _loss(model, batch, policy):
    return relative_l2(fno_apply(model, batch["a"], policy), batch["u"])


class _FunctionalTrainer(Trainer):
    """The trainer's step as the port wrote it before it updated in place."""

    def _grads(self, batch, policy, use_scaling):
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
            loss, grads = micro(batch)
            return loss, grads, {}
        acc_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        acc = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        for i in range(nmicro):
            b = {k: v.reshape(nmicro, v.shape[0] // nmicro, *v.shape[1:])[i]
                 for k, v in batch.items()}
            loss, g = micro(b)
            acc = {k: acc[k] + g[k] for k in names}
            acc_loss = acc_loss + loss
        inv = 1.0 / nmicro
        return acc_loss * inv, {k: g * inv for k, g in acc.items()}, {}

    def _train_step(self, policy, batch):
        use_scaling = loss_scaling_required(policy)
        loss, grads, telem = self._grads(batch, policy, use_scaling)
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
        return float(loss), finite, telem


def _trainer(cls, policy, microbatches=1, total=STEPS, loss=_loss, **kw):
    net = init_fno(torch.Generator().manual_seed(0), FNO_DARCY_SMOKE, device="cpu")
    cfg = TrainerConfig(total_steps=total, schedule=PrecisionSchedule.constant(policy),
                        microbatches=microbatches, **kw)
    return cls(loss, net, cfg, device="cpu")


def _state(tt):
    return ({k: p.detach().clone() for k, p in tt.params.items()},
            {k: v.clone() for k, v in tt.opt_state.mu.items()},
            {k: v.clone() for k, v in tt.opt_state.nu.items()}, int(tt.opt_state.count))


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("policy", ["full", "mixed_fno_bf16"])
def test_in_place_step_is_the_functional_step_bit_for_bit(policy, microbatches):
    batches = _batches(STEPS)
    ref = _trainer(_FunctionalTrainer, policy, microbatches)
    ref.run(lambda s: batches[s])
    tt = _trainer(Trainer, policy, microbatches)
    ids = ({k: id(p) for k, p in tt.params.items()}, id(tt.opt_state),
           {k: id(v) for k, v in tt.opt_state.mu.items()})
    tt.run(lambda s: batches[s])
    assert [h["loss"] for h in tt.history] == [h["loss"] for h in ref.history]
    p0, mu0, nu0, c0 = _state(ref)
    p1, mu1, nu1, c1 = _state(tt)
    assert _same(p0, p1) and _same(mu0, mu1) and _same(nu0, nu1)
    assert c0 == c1 == STEPS
    # the state written in place: the same tensors (and state object) as before
    assert {k: id(p) for k, p in tt.params.items()} == ids[0]
    assert id(tt.opt_state) == ids[1]
    assert {k: id(v) for k, v in tt.opt_state.mu.items()} == ids[2]


def test_fp16_skip_step_leaves_the_state_untouched():
    batch = _batches(1)[0]

    def loss_fn(model, b, policy):
        loss = _loss(model, b, policy)
        return loss * float("inf") if b["poison"] else loss

    tt = _trainer(Trainer, "mixed_fno_fp16", total=3, loss=loss_fn)
    tt.run(lambda s: {**batch, "poison": np.asarray(False)}, steps=2)
    before = _state(tt)
    scale = float(tt.scale_state.scale)
    tt.run(lambda s: {**batch, "poison": np.asarray(True)}, steps=3)
    after = _state(tt)
    assert tt.stats["skipped_steps"] == 1
    assert all(_same(a, b) for a, b in zip(before[:3], after[:3], strict=True))
    assert before[3] == after[3] == 2
    assert float(tt.scale_state.scale) == scale / 2


def test_restore_after_in_place_steps_is_bit_for_bit(tmp_path):
    batches = _batches(6)
    straight = _trainer(Trainer, "full", total=6)
    straight.run(lambda s: batches[s])
    first = _trainer(Trainer, "full", total=6, ckpt_dir=str(tmp_path), ckpt_every=3)
    first.run(lambda s: batches[s], steps=3)
    saved = _state(first)
    first.run(lambda s: batches[s])              # three more steps, in place
    resumed = _trainer(Trainer, "full", total=6, ckpt_dir=str(tmp_path), ckpt_every=100)
    assert resumed.restore(step=3) and resumed.step == 3
    got = _state(resumed)
    assert all(_same(a, b) for a, b in zip(saved[:3], got[:3], strict=True))
    assert saved[3] == got[3] == 3
    resumed.run(lambda s: batches[s])
    assert _same(_state(straight)[0], _state(resumed)[0])
    assert _same(_state(straight)[1], _state(resumed)[1])
    assert [h["loss"] for h in straight.history[3:]] == [h["loss"] for h in resumed.history]
