"""Synthetic token streams for the LM architecture pool.

Stateless by construction: the batch at ``(seed, step)`` comes from a
``torch.Generator`` seeded from both, so the pipeline keeps no iterator
state and a restart resumes bit for bit from the step number alone.

Tokens follow a Zipf-like marginal (``floor(vocab^u) - 1`` for uniform
u) with short-range structure: with probability 0.3 a token is the
previous one plus 1 (mod vocab), so perplexity is learnable.  The same
distribution as the reference's ``repro.data.tokens``; the numbers
differ, since the noise comes from a ``torch.Generator`` (the reference's
threefry keys are not ported).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def token_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int
                ) -> Dict[str, torch.Tensor]:
    """The batch at ``(seed, step)``: ``{"tokens": (batch, seq_len + 1)}``
    int64 token ids on the CPU."""
    g = _generator(seed, step)
    u = torch.rand((batch, seq_len + 1), generator=g)
    zipf = torch.floor(float(vocab) ** u) - 1.0
    base = torch.clamp(zipf, 0, vocab - 1).long()
    rep = torch.rand((batch, seq_len + 1), generator=g) < 0.3
    # token t is base[a] + (t - a), a the last position <= t that does not
    # repeat; before the first such position, base[0] + (t + 1)
    idx = torch.arange(seq_len + 1).expand(batch, -1)
    anchor = torch.cummax(torch.where(rep, -1, idx), dim=1).values
    anchor_val = torch.where(anchor >= 0, base.gather(1, anchor.clamp_min(0)), base[:, :1])
    return {"tokens": (anchor_val + idx - anchor) % vocab}


def lm_inputs(seed: int, step: int, batch: int, seq_len: int, vocab: int
              ) -> Dict[str, torch.Tensor]:
    """Training view: inputs = tokens[:, :-1], labels = tokens[:, 1:]."""
    b = token_batch(seed, step, batch, seq_len, vocab)["tokens"]
    return {"tokens": b[:, :-1], "labels": b[:, 1:]}
