"""Observability for the serving runtime (SERVING.md "Observability"; a
copy of the reference's ``obs`` package, which imports no framework).

Always compiled, off by default: the :class:`Observability` bundle is
constructed unconditionally by the scheduler, but the tracer is falsy
and the drift monitor is ``None`` unless ``EngineConfig`` opts in —
hot-path call sites guard with ``if obs.tracer:`` / ``if obs.drift:``
so the disabled cost is a branch, and decode output + ``EngineStats``
stay bit-identical to an engine built without the subsystem.

Pieces (each usable standalone):
  * :mod:`repro_torch.obs.trace`   — ring-buffer tracer, Perfetto export
  * :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry,
    Prometheus + JSON exposition, measured dispatch timing
  * :mod:`repro_torch.obs.drift`   — per-task confidence-drift scoring vs the
    stored calibration profile
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               StepTimer)
from repro_torch.obs.trace import Tracer, validate_trace

__all__ = ["Observability", "Tracer", "validate_trace", "MetricsRegistry",
           "Counter", "Gauge", "Histogram", "StepTimer", "DriftMonitor"]


class Observability:
    """The scheduler-owned bundle: one registry, one tracer, one step
    timer, and (opt-in) one drift monitor sharing the engine's
    calibration store."""

    #: fixed track ids for the tracer's duration spans; per-slot serve
    #: tracks are ``TID_SLOT0 + slot_index``
    TID_ENGINE = 0
    TID_SLOT0 = 16

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 drift: Optional[DriftMonitor] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.drift = drift
        self.timer = StepTimer()
        if self.tracer:
            self.tracer.track(self.TID_ENGINE, "engine")

    @classmethod
    def from_config(cls, ecfg, *, store=None) -> "Observability":
        """Build from ``EngineConfig`` knobs (``trace``,
        ``trace_capacity``, ``drift_telemetry``, ``drift_threshold``,
        ``drift_window``). ``store`` is the engine's calibration store —
        required only when drift telemetry is on."""
        tracer = Tracer(capacity=int(getattr(ecfg, "trace_capacity", 1 << 16)),
                        enabled=bool(getattr(ecfg, "trace", False)))
        drift = None
        if getattr(ecfg, "drift_telemetry", False):
            assert store is not None, \
                "drift telemetry scores against the calibration store"
            drift = DriftMonitor(
                store,
                threshold=float(getattr(ecfg, "drift_threshold", 0.95)),
                window=int(getattr(ecfg, "drift_window", 32)))
        return cls(tracer=tracer, drift=drift)

    def slot_track(self, slot_index: int) -> int:
        """Tracer track id for a slot's serve spans (named lazily)."""
        tid = self.TID_SLOT0 + int(slot_index)
        if tid not in self.tracer._tracks:
            self.tracer.track(tid, f"slot {slot_index}")
        return tid

    # -- exposition ------------------------------------------------------
    def _publish(self) -> None:
        if self.drift is not None:
            self.drift.publish(self.registry)
        self.timer.publish(self.registry)
        if self.tracer.enabled:
            self.registry.gauge(
                "trace_events_dropped",
                "trace ring evictions (grow trace_capacity if > 0)"
            ).set(self.tracer.dropped)

    def prometheus(self) -> str:
        """Prometheus text exposition of everything (drift + timing
        gauges refreshed first)."""
        self._publish()
        return self.registry.prometheus()

    def snapshot(self) -> dict:
        """JSON-ready snapshot of everything."""
        self._publish()
        out = {"metrics": self.registry.snapshot()}
        if self.drift is not None:
            out["drift"] = self.drift.snapshot()
        out["dispatch"] = {k: {"us_per_forward": us, "forwards": fwd,
                               "dispatches": d}
                           for k, (us, fwd, d) in self.timer.rows().items()}
        return out

    def save_trace(self, path) -> None:
        self.tracer.save(path)
