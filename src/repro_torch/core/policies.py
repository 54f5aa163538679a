"""Threshold policies for parallel diffusion decoding.

Every policy materialises a threshold table ``tau [num_blocks, steps_cap]``
(float32) consumed uniformly by the decoder — so static (Fast-dLLM),
factor-decay, and OSDT all share one compiled decode program; only the table
data differs. OSDT's cap κ and slack ε are baked into the table at
construction (``calibrate.build_table``), matching Algorithm 1 line 17:
``tau = min(tau, kappa); tau_eff = tau * (1 - eps)``.

``fixed-step`` (the LLaDA quota baseline) is not a table policy — the
decoder's ``quota`` argument selects it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.config.base import DecodeConfig


def static_table(dcfg: DecodeConfig) -> np.ndarray:
    """Fast-dLLM fixed global threshold."""
    return np.full((dcfg.num_blocks, dcfg.steps_cap), dcfg.threshold,
                   np.float32)


def factor_table(dcfg: DecodeConfig) -> np.ndarray:
    """Fast-dLLM 'factor' variant (under-specified upstream; implemented as
    a per-step geometric decay ``tau_s = threshold * factor**s`` — looser
    thresholds as denoising progresses; see DESIGN.md §5)."""
    steps = np.arange(dcfg.steps_cap, dtype=np.float32)
    row = dcfg.threshold * (dcfg.factor ** steps)
    return np.broadcast_to(row, (dcfg.num_blocks, dcfg.steps_cap)).copy()


def table_for(dcfg: DecodeConfig, calibration=None) -> np.ndarray:
    if dcfg.policy == "static":
        return static_table(dcfg)
    if dcfg.policy == "factor":
        return factor_table(dcfg)
    if dcfg.policy == "osdt":
        assert calibration is not None, "OSDT needs a calibration profile"
        from repro_torch.core.calibrate import build_table
        return build_table(calibration, dcfg)
    if dcfg.policy == "fixed":
        # quota mode: table unused; keep an impossible threshold
        return np.full((dcfg.num_blocks, dcfg.steps_cap), 2.0, np.float32)
    raise ValueError(f"unknown policy {dcfg.policy!r}")
