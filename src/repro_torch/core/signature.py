"""Task-level confidence signatures (paper §2, Figures 1-2).

A *signature* is the step-block mean-confidence vector of one generation,
flattened over (block, step). The paper's O2: within a task these vectors
have pairwise cosine similarity ≈ 1, which licenses one-shot calibration.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.calibrate import CalibrationProfile


def signature_vector(profile: CalibrationProfile) -> np.ndarray:
    """Flattened step-block mean confidences; NaN (unreached cells) -> 0."""
    v = profile.stepblock_means().reshape(-1)
    return np.nan_to_num(v, nan=0.0)


def cosine_matrix(profiles: List[CalibrationProfile]) -> np.ndarray:
    """Pairwise cosine similarity of signatures (Fig 2)."""
    vs = np.stack([signature_vector(p) for p in profiles])
    norms = np.linalg.norm(vs, axis=1, keepdims=True)
    vs = vs / np.maximum(norms, 1e-12)
    return vs @ vs.T


def mean_offdiag_cosine(profiles: List[CalibrationProfile]) -> float:
    m = cosine_matrix(profiles)
    n = m.shape[0]
    if n < 2:
        return 1.0
    mask = ~np.eye(n, dtype=bool)
    return float(m[mask].mean())


def trajectory(profile: CalibrationProfile) -> np.ndarray:
    """[num_blocks, steps_cap] mean-confidence trajectory (Fig 1)."""
    return profile.stepblock_means()


def signature_cosine(ref: CalibrationProfile,
                     live: CalibrationProfile) -> float:
    """Cosine between two profiles' signatures — the pairwise entry of
    :func:`cosine_matrix` that ``obs.drift.DriftMonitor`` tracks per
    task (stored calibration profile vs a live generation)."""
    return float(cosine_matrix([ref, live])[0, 1])
