"""One-shot calibration (OSDT Phase 1).

The decoder records, for the *first* sequence of a task, the confidence of
every still-masked position at every (block, step). ``build_table`` reduces
that population with the metric μ at block or step-block granularity and
applies cap κ / slack ε (Algorithm 1, line 17). Runs on host in numpy —
calibration happens once per task, overhead is negligible (paper §3).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.config.base import DecodeConfig


@dataclass
class CalibrationProfile:
    """Raw confidence recordings from one calibration generation.

    conf  : [num_blocks, steps_cap, block_size] float32
    valid : same shape, True where the position was masked at that step
    steps : [num_blocks] int32, denoising steps actually used per block
    """

    conf: np.ndarray
    valid: np.ndarray
    steps: np.ndarray

    def stepblock_means(self) -> np.ndarray:
        """Mean confidence per (block, step) — the Fig 1/Fig 2 signature.
        Invalid cells (no masked tokens) are NaN."""
        s = np.where(self.valid, self.conf, 0.0).sum(-1)
        n = self.valid.sum(-1)
        with np.errstate(invalid="ignore"):
            return np.where(n > 0, s / np.maximum(n, 1), np.nan)


def _metric(pop: np.ndarray, metric: str) -> float:
    if pop.size == 0:
        return np.nan
    if metric == "mean":
        return float(np.mean(pop))
    if metric in ("q1", "q2", "median"):
        q = 25.0 if metric == "q1" else 50.0
        return float(np.percentile(pop, q))
    if metric == "q3":
        return float(np.percentile(pop, 75.0))
    if metric == "min-whisker":
        q1, q3 = np.percentile(pop, [25.0, 75.0])
        lo = q1 - 1.5 * (q3 - q1)
        above = pop[pop >= lo]
        return float(above.min()) if above.size else float(pop.min())
    raise ValueError(f"unknown metric {metric!r}")


def build_table(profile: CalibrationProfile, dcfg: DecodeConfig) -> np.ndarray:
    """Threshold table [num_blocks, steps_cap] with κ/ε applied."""
    nb, sc, _ = profile.conf.shape
    assert nb == dcfg.num_blocks and sc == dcfg.steps_cap, (
        "calibration ran with a different block geometry")
    table = np.full((nb, sc), dcfg.threshold, np.float32)

    for b in range(nb):
        pooled = profile.conf[b][profile.valid[b]]
        if dcfg.mode == "block":
            tau = _metric(pooled, dcfg.metric)
            if np.isfinite(tau):
                table[b, :] = tau
        elif dcfg.mode == "step-block":
            last = np.nan
            for s in range(sc):
                pop = profile.conf[b, s][profile.valid[b, s]]
                tau = _metric(pop, dcfg.metric)
                if not np.isfinite(tau):
                    # step never reached during calibration: reuse the last
                    # observed step's threshold (trajectories are smooth, O1)
                    tau = last if np.isfinite(last) else _metric(
                        pooled, dcfg.metric)
                if np.isfinite(tau):
                    table[b, s] = tau
                    last = tau
        else:
            raise ValueError(f"unknown mode {dcfg.mode!r}")

    table = np.minimum(table, dcfg.cap) * (1.0 - dcfg.slack)
    return table.astype(np.float32)
