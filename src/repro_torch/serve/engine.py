"""The serving protocol's shared part: submit, tick, drain, stats.

Every engine speaks the same four verbs:

    submit(req) -> bool     queue a request (capacity-rejected => failed)
    tick()                  one batched device step
    drain(max_ticks)        tick until idle; returns finished requests
    stats()                 fields/s, slot occupancy, queue
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

from .scheduler import Scheduler


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
        return ok

    def tick(self) -> List[Any]:
        """One engine step.  Returns the requests finished this tick."""
        t0 = time.perf_counter()
        finished = self._tick_impl()
        self._wall_s += time.perf_counter() - t0
        self._ticks += 1
        for r in finished:
            r.finish_tick = self._ticks
            r.status = "done"
            self._n_done += 1
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
        return {
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
