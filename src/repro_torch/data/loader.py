"""Deterministic, shardable, restartable data loading.

A stateless pipeline: batch ``i`` is a pure function of ``(seed, i)``, so
checkpoints never store iterator state and a restart on another host
count re-shards by construction (host h of H consumes indices
``i*H + h``).  Numpy only; the trainer moves batches to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator

import numpy as np


@dataclasses.dataclass
class StatelessLoader:
    """Wraps sample_fn(seed, index) -> batch dict."""

    sample_fn: Callable[[int, int], Dict]
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    def batch_at(self, step: int) -> Dict:
        index = step * self.num_hosts + self.host_id
        return self.sample_fn(self.seed, index)

    def __iter__(self) -> Iterator[Dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class CachedDataset:
    """Pre-generate N samples once; serve deterministic mini-batches.

    The batch of step s uses indices drawn by a RandomState seeded from
    (seed, s): restartable from the step number alone.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int, seed: int = 0):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"arrays of unequal length: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2 ** 31))
        idx = rng.randint(0, self.n, self.batch_size)
        return {k: v[idx] for k, v in self.arrays.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
