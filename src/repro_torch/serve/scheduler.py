"""Admission scheduler shared by the serve engines.

One waiting queue + a pluggable admission policy, generic over request
types: engines hand in a ``cost`` function (grid points for the operator
engine) and a ``capacity_check`` that rejects requests which could
*never* run, so they fail fast at submit instead of spinning the engine's
drain loop forever.

Policies:
  fcfs  first-come-first-served (arrival order).
  spf   shortest-prompt-first: order by ``cost`` (ties arrival order).

The scheduler also owns per-tick queue accounting (wait ticks, depth,
admit/reject counters) that ``stats()`` reports.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

POLICIES = ("fcfs", "spf")


class Scheduler:
    def __init__(
        self,
        policy: str = "fcfs",
        capacity_check: Optional[Callable[[Any], Tuple[bool, str]]] = None,
        cost: Optional[Callable[[Any], float]] = None,
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown scheduler policy {policy!r}; have {POLICIES}")
        self.policy = policy
        self.capacity_check = capacity_check
        self.cost = cost or (lambda _req: 0.0)
        self.waiting: List[Any] = []
        self.rejected: List[Any] = []
        self.n_submitted = 0
        self.n_admitted = 0
        self.wait_ticks_total = 0

    # -- submit ----------------------------------------------------------------
    def submit(self, req, tick: int = 0) -> bool:
        """Queue a request, or fail it immediately if it exceeds capacity.
        Rejected requests get ``status='failed'`` + ``error`` and are
        surfaced through ``take_failed`` / the engine's drain."""
        self.n_submitted += 1
        if self.capacity_check is not None:
            ok, reason = self.capacity_check(req)
            if not ok:
                req.status = "failed"
                req.error = reason
                self.rejected.append(req)
                return False
        req.status = "queued"
        req.submit_tick = tick
        self.waiting.append(req)
        return True

    # -- admission -------------------------------------------------------------
    def _ordered(self) -> List[Any]:
        if self.policy == "spf":
            # python sort is stable => ties stay in arrival order
            return sorted(self.waiting, key=self.cost)
        return list(self.waiting)

    def take(self, n: int, tick: int = 0,
             bucket_key: Optional[Callable[[Any], Any]] = None) -> List[Any]:
        """Admit up to ``n`` requests in policy order.

        ``bucket_key`` restricts the batch to requests sharing the
        policy-order head's bucket (the operator engine's same-resolution
        micro-batching); ``None`` admits across buckets.
        """
        order = self._ordered()
        if not order or n <= 0:
            return []
        head_bucket = bucket_key(order[0]) if bucket_key else None
        picked = []
        for req in order:
            if len(picked) >= n:
                break
            if bucket_key is not None and bucket_key(req) != head_bucket:
                continue
            picked.append(req)
        picked_ids = {id(r) for r in picked}
        self.waiting = [r for r in self.waiting if id(r) not in picked_ids]
        for req in picked:
            req.status = "running"
            req.start_tick = tick
            self.wait_ticks_total += tick - req.submit_tick
            self.n_admitted += 1
        return picked

    def take_failed(self) -> List[Any]:
        """Pop every capacity-rejected request (drain surfaces these)."""
        failed, self.rejected = self.rejected, []
        return failed

    # -- accounting ------------------------------------------------------------
    @property
    def depth(self) -> int:
        return len(self.waiting)

    def stats(self) -> dict:
        n_rej = self.n_submitted - self.n_admitted - self.depth
        return {
            "policy": self.policy,
            "depth": self.depth,
            "submitted": self.n_submitted,
            "admitted": self.n_admitted,
            "rejected": n_rej,
            "wait_ticks_total": self.wait_ticks_total,
            "avg_wait_ticks": (
                self.wait_ticks_total / self.n_admitted if self.n_admitted else 0.0
            ),
        }
