"""Live confidence-drift telemetry (the OSDT staleness question).

OSDT calibrates once per task and then trusts the stored signature
forever, so a stale signature goes unseen unless it is measured. The
``DriftMonitor`` closes that gap: every retired row's
recorded confidence trajectory (``result_profile`` — the SAME recording
calibration uses) is compared against the task's stored
:class:`~repro_torch.core.calibrate.CalibrationProfile` via
``core.signature.cosine_matrix``, yielding a per-task cosine stream.

  * ``drift(task)``  = 1 − windowed mean cosine (0 ⇒ live traffic still
    matches the one-shot profile; paper O2 predicts ≈ 0 in-task).
  * ``stale(task)``  = the windowed mean cosine fell below ``threshold``
    after ``min_obs`` observations — the trigger input for the future
    online-refinement loop (ROADMAP "online signature refinement"):
    a tripped flag means the stored table/signature should be re-fit
    from live traffic, not trusted.

Like-for-like support: a serving row decodes under the task's
*calibrated* (compressed) step budget, while the stored profile was
recorded under the static calibration budget — raw cosines between the
two mostly measure the budget difference, not drift. ``observe``
therefore projects the stored reference onto the live recording's
(block, step) support before scoring: an exact same-traffic replay
scores cosine ≈ 1 and content drift shows up as support/value changes
on the cells the table actually schedules.

The carry-resident accumulators (``thr_steps`` / ``margin_sum`` /
``margin_n``, drained at slice boundaries — see ``core/decoder.py``)
feed secondary health signals: ``fallback_frac`` (share of denoising
steps that needed the argmax fallback because *nothing* cleared τ —
rising fallback means thresholds sit too high for live traffic) and
``margin_mean`` (average confidence headroom over τ of cleared
positions — shrinking margin means they sit too tight).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.calibrate import CalibrationProfile
from repro_torch.core.signature import signature_vector

__all__ = ["DriftMonitor"]


class _TaskDrift:
    __slots__ = ("cosines", "obs", "steps", "thr_steps", "margin_sum",
                 "margin_n")

    def __init__(self, window: int):
        self.cosines = deque(maxlen=window)
        self.obs = 0            # scored observations
        self.steps = 0          # total live denoising steps seen
        self.thr_steps = 0      # steps where >= 1 position cleared tau
        self.margin_sum = 0.0   # sum of (conf - tau) over cleared positions
        self.margin_n = 0       # cleared positions


class DriftMonitor:
    """Per-task drift scoring of live trajectories vs the stored profile.

    ``store`` is duck-typed: anything with a ``profiles`` mapping
    (task -> :class:`CalibrationProfile`) works —
    ``core.osdt.CalibrationStore`` in the engine. Rows whose task has no
    stored profile yet (its own calibration row included) score against
    nothing and are skipped.
    """

    def __init__(self, store, *, threshold: float = 0.95,
                 min_obs: int = 2, window: int = 32):
        assert 0.0 < threshold <= 1.0, threshold
        self.store = store
        self.threshold = float(threshold)
        self.min_obs = int(min_obs)
        self.window = int(window)
        self._t: Dict[str, _TaskDrift] = {}

    # -- ingestion -------------------------------------------------------
    def observe(self, task: str, profile: CalibrationProfile, *,
                thr_steps=None, seq_steps=None, margin_sum=None,
                margin_n=None) -> Optional[float]:
        """Score one retired row's trajectory; returns its cosine vs the
        stored profile (or ``None`` when unscorable: no stored profile,
        or an empty recording — e.g. a row that EOS'd in block 0 before
        recording anything)."""
        td = self._t.setdefault(task, _TaskDrift(self.window))
        if seq_steps is not None:
            td.steps += int(np.sum(seq_steps))
        if thr_steps is not None:
            td.thr_steps += int(np.sum(thr_steps))
        if margin_sum is not None:
            td.margin_sum += float(np.sum(margin_sum))
        if margin_n is not None:
            td.margin_n += int(np.sum(margin_n))
        ref = getattr(self.store, "profiles", {}).get(task)
        if ref is None:
            return None
        lv = signature_vector(profile)
        if not lv.any():
            return None
        rv = signature_vector(self._project(ref, profile))
        if not rv.any():
            return None  # no overlap with the live support: unscorable
        # the ``cosine_matrix([ref, live])[0, 1]`` entry, computed
        # directly — observe sits on the retirement hot path
        cos = float(np.dot(rv, lv)
                    / (max(np.linalg.norm(rv), 1e-12)
                       * max(np.linalg.norm(lv), 1e-12)))
        td.cosines.append(cos)
        td.obs += 1
        return cos

    @staticmethod
    def _project(ref: CalibrationProfile,
                 live: CalibrationProfile) -> CalibrationProfile:
        """Restrict ``ref`` to the (block, step) cells the live row
        actually recorded — the calibrated table schedules far fewer
        steps than the static calibration pass, and the comparison must
        measure drift, not that budget gap."""
        support = live.valid.sum(-1) > 0
        return CalibrationProfile(conf=ref.conf,
                                  valid=ref.valid & support[..., None],
                                  steps=live.steps)

    # -- scores ----------------------------------------------------------
    def tasks(self) -> List[str]:
        return sorted(self._t)

    def cosine(self, task: str) -> float:
        """Windowed mean cosine (1.0 when nothing scored yet)."""
        td = self._t.get(task)
        if td is None or not td.cosines:
            return 1.0
        return float(np.mean(td.cosines))

    def drift(self, task: str) -> float:
        """1 − windowed mean cosine: ≈ 0 while live traffic matches the
        one-shot profile (paper O2), grows as the signature goes stale."""
        return 1.0 - self.cosine(task)

    def stale(self, task: str) -> bool:
        """True once the task has drifted past ``threshold`` with at
        least ``min_obs`` scored observations — re-calibrate trigger."""
        td = self._t.get(task)
        if td is None or td.obs < self.min_obs:
            return False
        return self.cosine(task) < self.threshold

    def fallback_frac(self, task: str) -> float:
        """Share of live denoising steps where NO position cleared τ
        (the Algorithm-1 argmax fallback fired instead)."""
        td = self._t.get(task)
        if td is None or not td.steps:
            return 0.0
        return 1.0 - td.thr_steps / td.steps

    def margin_mean(self, task: str) -> float:
        """Mean (conf − τ) over positions that cleared τ."""
        td = self._t.get(task)
        if td is None or not td.margin_n:
            return 0.0
        return td.margin_sum / td.margin_n

    # -- export ----------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        return {task: {
            "observations": td.obs,
            "cosine": self.cosine(task),
            "drift": self.drift(task),
            "stale": self.stale(task),
            "fallback_frac": self.fallback_frac(task),
            "margin_mean": self.margin_mean(task),
            "steps": td.steps,
        } for task, td in sorted(self._t.items())}

    def publish(self, registry) -> None:
        """Mirror the per-task scores into gauges on ``registry``."""
        g_cos = registry.gauge("drift_cosine",
                               "windowed mean cosine vs stored profile")
        g_drift = registry.gauge("drift_score", "1 - drift_cosine")
        g_stale = registry.gauge("drift_stale",
                                 "1 when the staleness flag is tripped")
        g_obs = registry.gauge("drift_observations",
                               "scored live trajectories")
        g_fb = registry.gauge("drift_fallback_frac",
                              "live steps resolved by the argmax fallback")
        g_mg = registry.gauge("drift_margin_mean",
                              "mean confidence headroom over tau")
        for task in self.tasks():
            g_cos.set(self.cosine(task), task=task)
            g_drift.set(self.drift(task), task=task)
            g_stale.set(float(self.stale(task)), task=task)
            g_obs.set(self._t[task].obs, task=task)
            g_fb.set(self.fallback_frac(task), task=task)
            g_mg.set(self.margin_mean(task), task=task)
