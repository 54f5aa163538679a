"""Ring-buffer tracer with Chrome/Perfetto ``trace_event`` export.

Low-overhead by construction: a disabled tracer is falsy, so call sites
guard with ``if tr:`` and pay one attribute load + branch; an enabled
tracer appends a plain tuple into a preallocated ring (no dict build, no
timestamp formatting) and serializes only at :meth:`export`. The ring
keeps the most recent ``capacity`` events — long runs drop the oldest
events, never block, and :meth:`export` reports how many were dropped.

Event model (maps 1:1 onto the Chrome ``trace_event`` JSON schema that
Perfetto / ``chrome://tracing`` load directly):

  * **duration spans** (``ph`` B/E) on named *tracks* — synchronous host
    phases: admission prefill, seed forwards, slice dispatch, per-slot
    serve spans. Strictly nested per track.
  * **async spans** (``ph`` b/e, keyed by ``id`` + ``cat``) — request
    lifecycle phases that overlap arbitrarily: ``request`` (submit →
    response) and ``queued`` (submit/requeue → admit).
  * **instants** (``ph`` i) — point events: evictions, promotions,
    calibration ingests, failures.
  * **counters** (``ph`` C) — time series (pages in use, rows live).

``validate_trace`` checks structural integrity (schema + balanced span
trees) and is shared by the tests and the observability benchmark.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "validate_trace"]

_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


class Tracer:
    """Bounded in-memory trace sink (Chrome ``trace_event`` exporter).

    ``enabled=False`` (the default posture in the engine) makes the
    tracer falsy and every emit a no-op; the scheduler's hot paths guard
    with ``if tracer:`` so the disabled cost is one branch.

    Timestamps are microseconds relative to the tracer's construction,
    taken from ``clock`` (``time.perf_counter``); emit methods accept an
    explicit ``t=`` (a ``clock()`` reading) so call sites that already
    timed the work don't read the clock twice.
    """

    def __init__(self, capacity: int = 1 << 16, *, enabled: bool = True,
                 clock=time.perf_counter):
        assert capacity > 0, capacity
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._clock = clock
        self._t0 = clock()
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._n = 0                 # total events ever emitted
        self._tracks: Dict[int, str] = {}

    def __bool__(self) -> bool:
        return self.enabled

    # -- tracks ----------------------------------------------------------
    def track(self, tid: int, name: str) -> int:
        """Name a track (rendered via ``thread_name`` metadata)."""
        self._tracks[int(tid)] = str(name)
        return int(tid)

    # -- emission --------------------------------------------------------
    def _ts(self, t: Optional[float]) -> float:
        return ((self._clock() if t is None else t) - self._t0) * 1e6

    def _emit(self, ph: str, name: str, tid: int, ts: float,
              args: Optional[dict], eid: Optional[int], cat: str):
        self._buf[self._n % self.capacity] = (ph, name, tid, ts, args,
                                              eid, cat)
        self._n += 1

    def begin(self, name: str, *, tid: int = 0, t: Optional[float] = None,
              **args) -> None:
        """Open a duration span on ``tid`` (close with :meth:`end`)."""
        if self.enabled:
            self._emit("B", name, tid, self._ts(t), args or None, None, "")

    def end(self, name: str, *, tid: int = 0, t: Optional[float] = None,
            **args) -> None:
        if self.enabled:
            self._emit("E", name, tid, self._ts(t), args or None, None, "")

    def abegin(self, name: str, eid: int, *, cat: str = "request",
               t: Optional[float] = None, **args) -> None:
        """Open an async span keyed by (cat, id, name) — request
        lifecycle phases that overlap across slots and the queue."""
        if self.enabled:
            self._emit("b", name, 0, self._ts(t), args or None,
                       int(eid), cat)

    def aend(self, name: str, eid: int, *, cat: str = "request",
             t: Optional[float] = None, **args) -> None:
        if self.enabled:
            self._emit("e", name, 0, self._ts(t), args or None,
                       int(eid), cat)

    def instant(self, name: str, *, tid: int = 0,
                t: Optional[float] = None, **args) -> None:
        if self.enabled:
            self._emit("i", name, tid, self._ts(t), args or None, None, "")

    def counter(self, name: str, value, *, tid: int = 0,
                t: Optional[float] = None) -> None:
        if self.enabled:
            self._emit("C", name, tid, self._ts(t),
                       {"value": float(value)}, None, "")

    # -- export ----------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events evicted by the ring (oldest-first) so far."""
        return max(0, self._n - self.capacity)

    def events(self) -> List[tuple]:
        """Surviving events, oldest first."""
        if self._n <= self.capacity:
            return [e for e in self._buf[:self._n]]
        k = self._n % self.capacity
        return self._buf[k:] + self._buf[:k]

    def export(self) -> Dict[str, Any]:
        """The Chrome ``trace_event`` JSON object (Perfetto-loadable)."""
        out: List[dict] = []
        for tid in sorted(self._tracks):
            out.append({"name": "thread_name", "ph": "M", "pid": 0,
                        "tid": tid, "ts": 0,
                        "args": {"name": self._tracks[tid]}})
        for ph, name, tid, ts, args, eid, cat in self.events():
            ev: Dict[str, Any] = {"name": name, "ph": ph, "pid": 0,
                                  "tid": tid, "ts": round(ts, 3)}
            if ph in ("b", "e"):
                ev["cat"] = cat
                ev["id"] = str(eid)
            if ph == "i":
                ev["s"] = "t"       # thread-scoped instant
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped}}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)


def validate_trace(doc: Dict[str, Any]) -> Dict[str, int]:
    """Structural integrity of an exported trace document.

    Raises ``AssertionError`` on: missing required keys, an ``E`` that
    does not match the innermost open ``B`` on its track (spans must
    nest), an async ``e`` without a prior matching ``b``, or any span
    left open at the end of the document. Returns counts (spans /
    async spans / instants) so callers can assert coverage.
    """
    assert isinstance(doc, dict) and "traceEvents" in doc, \
        "not a trace_event document"
    stacks: Dict[int, List[str]] = {}
    open_async: Dict[tuple, int] = {}
    n_span = n_async = n_inst = 0
    last_ts: Dict[int, float] = {}
    for ev in doc["traceEvents"]:
        for k in _REQUIRED_KEYS:
            assert k in ev, f"event missing {k!r}: {ev}"
        ph, tid, ts = ev["ph"], ev["tid"], ev["ts"]
        assert isinstance(ts, (int, float)) and ts >= 0, ev
        if ph == "M":
            continue
        assert ts >= last_ts.get(tid, 0.0), \
            f"track {tid}: timestamps not monotonic at {ev}"
        last_ts[tid] = ts
        if ph == "B":
            stacks.setdefault(tid, []).append(ev["name"])
        elif ph == "E":
            st = stacks.get(tid) or []
            assert st, f"E without open B on track {tid}: {ev}"
            top = st.pop()
            assert top == ev["name"], \
                f"span close mismatch on track {tid}: open {top!r}, " \
                f"close {ev['name']!r}"
            n_span += 1
        elif ph in ("b", "e"):
            assert "id" in ev and "cat" in ev, f"async event needs id+cat: {ev}"
            key = (ev["cat"], ev["id"], ev["name"])
            if ph == "b":
                open_async[key] = open_async.get(key, 0) + 1
            else:
                assert open_async.get(key, 0) > 0, \
                    f"async e without open b: {key}"
                open_async[key] -= 1
                n_async += 1
        elif ph == "i":
            n_inst += 1
        elif ph == "C":
            assert "args" in ev, f"counter needs args: {ev}"
        else:
            raise AssertionError(f"unknown phase {ph!r}: {ev}")
    leftover = {t: s for t, s in stacks.items() if s}
    assert not leftover, f"unclosed duration spans: {leftover}"
    dangling = {k: n for k, n in open_async.items() if n}
    assert not dangling, f"unclosed async spans: {dangling}"
    return {"spans": n_span, "async": n_async, "instants": n_inst}
