"""Lightweight span/event tracing: the timeline half of ``repro_torch.obs``.

Host-side wall-clock tracing around the port's eager calls: a span
brackets the host call (``step()``, ``tick()``) together with the sync
that ends it (``float(loss)`` in the trainer, the device-to-host copy of
an operator tick), so the span's duration attributes the device wall to
the host phase that launched it.  Nothing here touches tensors.

Design constraints (tracing must stay cheap enough to leave on):

* **off is free**: ``span(...)`` / ``event(...)`` check one module-level
  flag and return a shared no-op object — no allocation, no lock;
* **on is a ring buffer**: records land in a preallocated ring of
  fixed-slot lists (drop-oldest, ``dropped()`` counts what fell off);
  writing a record assigns slots in place — the only per-record
  allocation is the caller's ``attrs`` dict when it passes attributes;
* **monotonic time**: ``time.perf_counter_ns`` relative to the enable()
  origin, so exported timelines are comparable across threads.

Record kinds (the wire vocabulary shared with :mod:`repro_torch.obs.export`):

  ``span``   completed span: name, ts, dur, tid, depth, parent, attrs
  ``event``  instant: name, ts, tid, category, attrs
  ``b``/``e``  async begin/end pair correlated by ``id`` (request
             lifecycle phases: queued -> prefill -> decode -> drain)

Thread-local span stacks give nesting (depth + parent name) without any
cross-thread coordination; the ring itself takes one lock per record.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

#: record slot layout: [kind, name, ts_ns, dur_ns, tid, depth, parent,
#: category, id, attrs]
_KIND, _NAME, _TS, _DUR, _TID, _DEPTH, _PARENT, _CAT, _ID, _ATTRS = range(10)
_N_SLOTS = 10

DEFAULT_CAPACITY = 1 << 16


class _Ring:
    """Preallocated drop-oldest ring of record slots."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.slots: List[list] = [[None] * _N_SLOTS for _ in range(capacity)]
        self.head = 0          # next write index
        self.count = 0         # live records (<= capacity)
        self.dropped = 0
        self.lock = threading.Lock()

    def write(self, kind, name, ts, dur, tid, depth, parent, cat, rid, attrs):
        with self.lock:
            slot = self.slots[self.head]
            slot[_KIND] = kind
            slot[_NAME] = name
            slot[_TS] = ts
            slot[_DUR] = dur
            slot[_TID] = tid
            slot[_DEPTH] = depth
            slot[_PARENT] = parent
            slot[_CAT] = cat
            slot[_ID] = rid
            slot[_ATTRS] = attrs
            self.head = (self.head + 1) % self.capacity
            if self.count < self.capacity:
                self.count += 1
            else:
                self.dropped += 1


_enabled = False
_ring: Optional[_Ring] = None
_origin_ns = 0
_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "spans", None)
    if st is None:
        st = _local.spans = []
    return st


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Turn tracing on with a fresh ring of ``capacity`` records."""
    global _enabled, _ring, _origin_ns
    _ring = _Ring(capacity)
    _origin_ns = time.perf_counter_ns()
    _enabled = True


def disable() -> None:
    """Turn tracing off (the ring is kept until ``enable``/``clear``)."""
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def clear() -> None:
    """Drop every buffered record (keeps the enabled state)."""
    global _ring, _origin_ns
    if _ring is not None:
        _ring = _Ring(_ring.capacity)
        _origin_ns = time.perf_counter_ns()


def dropped() -> int:
    """Records lost to ring wrap since enable()/clear()."""
    return _ring.dropped if _ring is not None else 0


def _now() -> int:
    return time.perf_counter_ns() - _origin_ns


class _NullSpan:
    """The shared no-op returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0", "depth", "parent")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = _stack()
        self.depth = len(st)
        self.parent = st[-1] if st else None
        st.append(self.name)
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        if _enabled and _ring is not None:
            _ring.write("span", self.name, self.t0, t1 - self.t0,
                        threading.get_ident(), self.depth, self.parent,
                        None, None, self.attrs)
        return False


def span(name: str, **attrs):
    """Context manager timing one host-side phase.

    Spans nest through a thread-local stack (depth + parent recorded);
    wrap device work together with the sync that ends it (a ``float()``
    or a device-to-host copy) so the duration includes device wall.  Free no-op while disabled.
    """
    if not _enabled:
        return _NULL
    return _Span(name, attrs or None)


def event(name: str, category: str = "event", **attrs) -> None:
    """Record one instant event.  No-op while disabled."""
    if not _enabled or _ring is None:
        return
    _ring.write("event", name, _now(), None, threading.get_ident(),
                len(_stack()), None, category, None, attrs or None)


def begin(name: str, rid, category: str = "async", **attrs) -> None:
    """Open an async interval correlated by ``rid`` (e.g. request uid).
    Renders as an async track slice in Perfetto once ``end`` closes it."""
    if not _enabled or _ring is None:
        return
    _ring.write("b", name, _now(), None, threading.get_ident(),
                0, None, category, rid, attrs or None)


def end(name: str, rid, category: str = "async", **attrs) -> None:
    """Close the async interval opened by ``begin(name, rid)``."""
    if not _enabled or _ring is None:
        return
    _ring.write("e", name, _now(), None, threading.get_ident(),
                0, None, category, rid, attrs or None)


_FIELDS = ("kind", "name", "ts_ns", "dur_ns", "tid", "depth", "parent",
           "category", "id", "attrs")


def snapshot() -> List[Dict[str, Any]]:
    """The buffered records, oldest first, as JSON-friendly dicts."""
    if _ring is None:
        return []
    with _ring.lock:
        n, head, cap = _ring.count, _ring.head, _ring.capacity
        start = (head - n) % cap
        rows = [list(_ring.slots[(start + i) % cap]) for i in range(n)]
    out = []
    for row in rows:
        rec = {k: v for k, v in zip(_FIELDS, row, strict=True)
               if v is not None}
        rec.setdefault("kind", "event")
        out.append(rec)
    return out
