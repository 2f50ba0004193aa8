"""Async serving frontend: ``submit_async`` / ``stream`` generators in
front of the synchronous engine tick loop, with per-request deadlines.

One driver task owns the tick loop: it runs while any watched request is
unfinished, delivering newly generated tokens to per-request queues
after every tick and resolving completion events.  Callers are plain
coroutines:

    front = AsyncServeFrontend(engine)
    req = await front.submit_async(Request(...), deadline_ms=250.0)
    async for tok in front.stream(Request(...)):
        ...

Deadlines are *accounting*, not preemption — a missed request still
completes (an SLO harness wants the full latency distribution, and
killing work mid-slot would perturb the other slots' batching).  Every
request leaves a metrics record: submit->finish latency,
time-to-first-token, deadline verdict.  A tick that raises (an exhausted
block pool) wakes every waiting caller with that error.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, AsyncIterator, Dict, List, Optional

from repro_torch.obs import registry
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class _Tracked:
    req: Any
    t0: float
    deadline_ms: Optional[float]
    queue: Optional[asyncio.Queue]
    done: asyncio.Event
    delivered: int = 0
    ttft_s: Optional[float] = None
    error: Optional[BaseException] = None


class AsyncServeFrontend:
    """Async facade over any ``submit / tick / drain / stats`` engine."""

    def __init__(self, engine, tick_sleep_s: float = 0.0,
                 max_ticks: int = 1_000_000):
        self.engine = engine
        self.tick_sleep_s = tick_sleep_s
        self.max_ticks = max_ticks
        self._watch: Dict[int, _Tracked] = {}
        self._driver: Optional[asyncio.Task] = None
        self.records: List[Dict[str, Any]] = []

    # -- public API ------------------------------------------------------------
    async def submit_async(self, req, deadline_ms: Optional[float] = None):
        """Submit and await completion; returns the finished request."""
        tr = self._track(req, deadline_ms, want_stream=False)
        if not self.engine.submit(req):
            self._finish(tr, time.perf_counter())
            return req
        self._ensure_driver()
        await tr.done.wait()
        if tr.error is not None:
            raise tr.error
        return req

    async def stream(self, req, deadline_ms: Optional[float] = None
                     ) -> AsyncIterator[int]:
        """Submit and yield tokens as the tick loop generates them."""
        tr = self._track(req, deadline_ms, want_stream=True)
        if not self.engine.submit(req):
            self._finish(tr, time.perf_counter())
            return
        self._ensure_driver()
        while True:
            tok = await tr.queue.get()
            if tok is None:
                if tr.error is not None:
                    raise tr.error
                return
            yield tok

    # -- bookkeeping -----------------------------------------------------------
    def _track(self, req, deadline_ms, want_stream: bool) -> _Tracked:
        if req.uid in self._watch:
            raise ValueError(f"request uid {req.uid} is already in flight")
        tr = _Tracked(req=req, t0=time.perf_counter(), deadline_ms=deadline_ms,
                      queue=asyncio.Queue() if want_stream else None,
                      done=asyncio.Event())
        self._watch[req.uid] = tr
        if obs_trace.is_enabled():
            # two async tracks per uid: the whole submit->finish latency
            # and the TTFT prefix, closed at the first generated token
            obs_trace.begin("frontend/request", req.uid, category="frontend",
                            deadline_ms=deadline_ms)
            obs_trace.begin("frontend/ttft", req.uid, category="frontend")
        return tr

    def _ensure_driver(self):
        if self._driver is None or self._driver.done():
            self._driver = asyncio.get_running_loop().create_task(self._run())

    def _finish(self, tr: _Tracked, now: float):
        latency_ms = (now - tr.t0) * 1e3
        missed = (tr.deadline_ms is not None and tr.req.status == "done"
                  and latency_ms > tr.deadline_ms)
        reg = registry()
        reg.histogram("repro_frontend_latency_ms").observe(latency_ms)
        reg.counter("repro_frontend_requests_total",
                    status=tr.req.status).inc()
        if missed:
            reg.counter("repro_frontend_deadline_misses_total").inc()
        if obs_trace.is_enabled():
            if tr.ttft_s is None:
                obs_trace.end("frontend/ttft", tr.req.uid,
                              category="frontend")
            obs_trace.end("frontend/request", tr.req.uid,
                          category="frontend", status=tr.req.status,
                          latency_ms=round(latency_ms, 3),
                          deadline_missed=bool(missed))
        self.records.append({
            "uid": tr.req.uid,
            "status": tr.req.status,
            "latency_ms": round(latency_ms, 3),
            "ttft_ms": round(tr.ttft_s * 1e3, 3)
            if tr.ttft_s is not None else None,
            "deadline_ms": tr.deadline_ms,
            "deadline_missed": bool(missed),
            "n_generated": len(getattr(tr.req, "generated", []) or []),
        })
        self._watch.pop(tr.req.uid, None)
        if tr.queue is not None:
            tr.queue.put_nowait(None)
        tr.done.set()

    async def _run(self):
        """The driver: tick while anything is watched, deliver tokens."""
        ticks = 0
        while self._watch and ticks < self.max_ticks:
            # yield to the event loop *before* the (blocking) device step
            # so queued arrival coroutines get to submit into this tick
            await asyncio.sleep(self.tick_sleep_s)
            try:
                self.engine.tick()
            except Exception as e:
                for tr in list(self._watch.values()):
                    tr.error = e
                    self._watch.pop(tr.req.uid, None)
                    if tr.queue is not None:
                        tr.queue.put_nowait(None)
                    tr.done.set()
                raise
            ticks += 1
            now = time.perf_counter()
            for tr in list(self._watch.values()):
                gen = getattr(tr.req, "generated", None) or []
                if tr.ttft_s is None and len(gen) > 0:
                    tr.ttft_s = now - tr.t0
                    registry().histogram("repro_frontend_ttft_ms").observe(
                        tr.ttft_s * 1e3)
                    if obs_trace.is_enabled():
                        obs_trace.end("frontend/ttft", tr.req.uid,
                                      category="frontend",
                                      ttft_ms=round(tr.ttft_s * 1e3, 3))
                while tr.delivered < len(gen):
                    tok = gen[tr.delivered]
                    tr.delivered += 1
                    if tr.queue is not None:
                        tr.queue.put_nowait(tok)
                if tr.req.status in ("done", "failed"):
                    self._finish(tr, now)

    # -- metrics ---------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """SLO accounting over every finished request."""
        lats = sorted(r["latency_ms"] for r in self.records
                      if r["status"] == "done")
        with_deadline = [r for r in self.records
                         if r["deadline_ms"] is not None
                         and r["status"] == "done"]
        out: Dict[str, Any] = {
            "requests": len(self.records),
            "completed": sum(r["status"] == "done" for r in self.records),
            "failed": sum(r["status"] == "failed" for r in self.records),
            "deadline_misses": sum(r["deadline_missed"]
                                   for r in self.records),
            "deadline_miss_rate": round(
                sum(r["deadline_missed"] for r in with_deadline)
                / len(with_deadline), 4) if with_deadline else None,
        }
        if lats:
            def pct(p):
                k = min(len(lats) - 1, max(0, int(round(
                    p / 100.0 * (len(lats) - 1)))))
                return round(lats[k], 3)
            mean = sum(lats) / len(lats)
            out.update({
                "latency_ms": {
                    "p50": pct(50), "p90": pct(90), "p99": pct(99),
                    "mean": round(mean, 3), "max": round(lats[-1], 3),
                },
                # jitter: latency stddev — the CORTEX real-time metric
                "jitter_ms": round(
                    (sum((x - mean) ** 2 for x in lats) / len(lats)) ** 0.5,
                    3),
            })
        registry().publish("frontend", out)
        return out
