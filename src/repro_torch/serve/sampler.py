"""Sampling for the LM engine: greedy, temperature, top-k and top-p with
per-request parameters.

Sampling is a precision site like the rest of the serving stack: the
engine resolves ``serve/sampler`` through the rule table (f32 in the
shared base table) and hands it in, so the filtering and softmax run at
a declared format whatever dtype the logits arrive in.

Determinism: ``sample_token`` is a pure function of ``(logits, params,
generator state)``.  The engine takes a fresh generator per request and
generation index from :func:`request_key`, seeded from ``(engine seed,
uid, index)``, so a fixed engine seed replays identical samples whatever
the slot assignment or the tick interleaving.  The reference's threefry
keys are not ported: the samples differ from its, their distribution
does not.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.

    temperature: 0 (or negative) => greedy argmax; no generator used.
    top_k:       keep only the k highest logits (0 => off).
    top_p:       nucleus sampling: keep the smallest prefix of the
                 descending-probability order with cumulative mass >=
                 top_p (1.0 => off).  Always keeps the argmax, so top_p
                 -> 0 degrades to greedy.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


GREEDY = SamplingParams()


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit to -inf."""
    kth = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(logits < kth, -torch.inf, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter along the last axis: keep the minimal
    descending-probability prefix whose cumulative mass reaches ``p`` (the
    head token always stays).  The order is a stable descending sort, ties
    in index order, as ``jnp.argsort(-logits)``."""
    order = torch.sort(-logits, dim=-1, stable=True).indices
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # token i is kept while the mass *before* it is < p
    keep_sorted = (cum - probs) < p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, logits, -torch.inf)


def categorical(generator: torch.Generator, logits: torch.Tensor) -> int:
    """One draw from softmax(logits) by the Gumbel-max trick, the noise
    from ``generator`` (on its own device)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, device=generator.device)
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
    return int(torch.argmax(logits.float() + gumbel.to(logits.device)))


def sample_token(logits, params: SamplingParams = GREEDY,
                 generator: Optional[torch.Generator] = None, site=None) -> int:
    """Draw one token id from a (V,) logits row.

    ``site`` is the resolved ``serve/sampler`` SitePrecision (f32 in the
    base table); the filtering and softmax run at its compute dtype.
    Greedy requests never touch a generator."""
    logits = torch.as_tensor(logits)
    if site is not None:
        logits = logits.to(site.compute_dtype)
    if params.temperature <= 0.0:
        return int(torch.argmax(logits, dim=-1))
    if generator is None:
        raise ValueError("non-greedy sampling requires an explicit generator")
    logits = logits / params.temperature
    if params.top_k:
        logits = apply_top_k(logits, params.top_k)
    if params.top_p < 1.0:
        logits = apply_top_p(logits, params.top_p)
    return categorical(generator, logits)


def request_key(seed: int, uid: int, step: int) -> torch.Generator:
    """The per-(engine seed, request, generation index) generator: stable
    under slot reassignment and tick interleaving."""
    state = np.random.SeedSequence([int(seed), int(uid), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))
