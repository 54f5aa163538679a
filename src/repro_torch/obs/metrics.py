"""Typed metrics registry with Prometheus text + JSON exposition.

Three instrument kinds, each label-aware:

  * ``Counter`` — monotonically non-decreasing (``inc`` rejects negative
    deltas). Requests served, traces dropped.
  * ``Gauge``   — settable/addable. Every ``EngineStats`` field exports
    as a gauge, NOT a counter: the scheduler *backs stats out* with
    ``-=`` when a failed slice requeues its admissions, and a counter
    contract would make that an error.
  * ``Histogram`` — cumulative fixed buckets (+Inf implicit), sum and
    count; Prometheus ``_bucket``/``_sum``/``_count`` exposition.

``StepTimer`` accumulates wall-clock dispatch timings per program kind
and renders them as µs/forward.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "StepTimer"]

LabelKey = Tuple[Tuple[str, str], ...]


def _labelkey(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labelstr(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def samples(self) -> Iterable[Tuple[str, str, float]]:
        """(suffix, label string, value) triples for exposition."""
        raise NotImplementedError

    def snapshot(self) -> Dict[str, float]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._v: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        assert amount >= 0, f"counter {self.name}: negative inc {amount}"
        k = _labelkey(labels)
        self._v[k] = self._v.get(k, 0.0) + amount

    def get(self, **labels) -> float:
        return self._v.get(_labelkey(labels), 0.0)

    def samples(self):
        for k in sorted(self._v):
            yield "", _labelstr(k), self._v[k]

    def snapshot(self):
        return {_labelstr(k) or "_": v for k, v in sorted(self._v.items())}


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._v: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        self._v[_labelkey(labels)] = float(value)

    def add(self, delta: float, **labels) -> None:
        k = _labelkey(labels)
        self._v[k] = self._v.get(k, 0.0) + delta

    def get(self, **labels) -> float:
        return self._v.get(_labelkey(labels), 0.0)

    def samples(self):
        for k in sorted(self._v):
            yield "", _labelstr(k), self._v[k]

    def snapshot(self):
        return {_labelstr(k) or "_": v for k, v in sorted(self._v.items())}


class Histogram(_Metric):
    kind = "histogram"

    #: seconds-scale default: 100µs .. 10s
    DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5,
                       1.0, 5.0, 10.0)

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Tuple[float, ...]] = None):
        super().__init__(name, help)
        b = tuple(buckets) if buckets else self.DEFAULT_BUCKETS
        assert all(x < y for x, y in zip(b, b[1:])), \
            f"histogram {name}: buckets must increase: {b}"
        self.buckets = b
        # per labelset: ([counts per finite bucket], sum, count)
        self._v: Dict[LabelKey, list] = {}

    def observe(self, value: float, **labels) -> None:
        k = _labelkey(labels)
        st = self._v.get(k)
        if st is None:
            st = self._v[k] = [[0] * len(self.buckets), 0.0, 0]
        counts, _, _ = st
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
        st[1] += value
        st[2] += 1

    def get(self, **labels) -> Tuple[float, int]:
        """(sum, count) for a labelset."""
        st = self._v.get(_labelkey(labels))
        return (0.0, 0) if st is None else (st[1], st[2])

    def samples(self):
        for k in sorted(self._v):
            counts, total, n = self._v[k]
            for i, ub in enumerate(self.buckets):
                lk = k + (("le", repr(ub)),)
                yield "_bucket", _labelstr(lk), float(counts[i])
            yield "_bucket", _labelstr(k + (("le", "+Inf"),)), float(n)
            yield "_sum", _labelstr(k), total
            yield "_count", _labelstr(k), float(n)

    def snapshot(self):
        out = {}
        for k, (counts, total, n) in sorted(self._v.items()):
            out[_labelstr(k) or "_"] = {
                "buckets": dict(zip(map(repr, self.buckets), counts)),
                "sum": total, "count": n}
        return out


class MetricsRegistry:
    """Get-or-create home for every metric; single exposition point.

    Names follow Prometheus conventions (``snake_case``, unit-suffixed
    where meaningful). Re-requesting a name returns the SAME instrument
    — with a kind check, so a counter can never silently become a
    gauge.
    """

    def __init__(self, prefix: str = "repro_"):
        self.prefix = prefix
        self._m: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        m = self._m.get(name)
        if m is None:
            m = self._m[name] = cls(name, help, **kw)
        else:
            assert isinstance(m, cls), \
                f"metric {name!r} is a {m.kind}, requested {cls.kind}"
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._m

    def names(self) -> List[str]:
        return sorted(self._m)

    # -- exposition ------------------------------------------------------
    def prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name in sorted(self._m):
            m = self._m[name]
            full = self.prefix + name
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            lines.append(f"# TYPE {full} {m.kind}")
            for suffix, labels, value in m.samples():
                v = repr(value) if value != int(value) else str(int(value))
                lines.append(f"{full}{suffix}{labels} {v}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready snapshot: name -> {kind, help, values}."""
        return {self.prefix + name: {"kind": m.kind, "help": m.help,
                                     "values": m.snapshot()}
                for name, m in sorted(self._m.items())}

    def snapshot_json(self, **json_kw) -> str:
        return json.dumps(self.snapshot(), **json_kw)


class StepTimer:
    """Wall-clock dispatch accumulator per compiled-program kind.

    The scheduler calls ``add(kind, wall_s, forwards)`` once per
    dispatch with the host-observed wall (block-until-ready) and the
    number of model forwards the dispatch executed (nfe delta — prefill,
    denoise and commit forwards all count).
    """

    def __init__(self):
        # kind -> [wall_s, forwards, dispatches]
        self._acc: Dict[str, list] = {}

    def add(self, kind: str, wall_s: float, forwards: int) -> None:
        st = self._acc.setdefault(kind, [0.0, 0, 0])
        st[0] += wall_s
        st[1] += int(forwards)
        st[2] += 1

    def us_per_forward(self, kind: str) -> float:
        st = self._acc.get(kind)
        if not st or not st[1]:
            return 0.0
        return st[0] * 1e6 / st[1]

    def rows(self) -> Dict[str, Tuple[float, int, int]]:
        """kind -> (us_per_forward, forwards, dispatches)."""
        return {k: (self.us_per_forward(k), st[1], st[2])
                for k, st in sorted(self._acc.items())}

    def publish(self, registry: MetricsRegistry) -> None:
        g = registry.gauge("dispatch_us_per_forward",
                           "measured wall-clock per model forward")
        n = registry.gauge("dispatch_forwards",
                           "model forwards timed per program kind")
        for kind, (us, fwd, _) in self.rows().items():
            g.set(us, kind=kind)
            n.set(fwd, kind=kind)
