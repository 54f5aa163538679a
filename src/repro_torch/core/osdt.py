"""OSDT orchestration — Algorithm 1 end to end.

Phase 1: decode the first sequence with the Fast-dLLM static threshold and
record its confidence profile. Phase 2: build the (block | step-block)
table with metric μ, cap κ, slack ε, and decode every later sequence with
it. Both phases run the same generate function; only the table differs.

The calibration state lives in a :class:`CalibrationStore`, the task →
(profile, table) map. Its ``.npz`` format is the reference's, key for key,
so a store saved by either package loads in the other.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.config.base import DecodeConfig, ModelConfig
from repro_torch.core import policies
from repro_torch.core.calibrate import CalibrationProfile, build_table
from repro_torch.core.decoder import (GenerateResult, make_generate_fn,
                                      result_profile)


class CalibrationStore:
    """task → calibration profile + threshold table.

    Tables are host-side float32 ``[num_blocks, steps_cap]`` arrays.
    Uncalibrated tasks resolve to the Fast-dLLM static table.
    ``save``/``load`` round-trip the whole store through one ``.npz``.
    """

    def __init__(self, dcfg: DecodeConfig):
        self.dcfg = dcfg
        self.static = policies.static_table(dcfg)
        self.profiles: Dict[str, CalibrationProfile] = {}
        self.tables: Dict[str, np.ndarray] = {}

    def calibrated(self, task: str) -> bool:
        return task in self.tables

    def tasks(self) -> List[str]:
        return sorted(self.tables)

    def table(self, task: str) -> np.ndarray:
        """[nb, steps_cap] — the task's table, or the static fallback."""
        return self.tables.get(task, self.static)

    def tables_for(self, tasks: Sequence[str]) -> np.ndarray:
        """The per-slot table [B, nb, steps_cap] for a mixed batch."""
        return np.stack([self.table(t) for t in tasks]).astype(np.float32)

    def ingest(self, task: str, profile: CalibrationProfile) -> np.ndarray:
        """One-shot calibration (Phase 1 → table). Returns the table."""
        tab = build_table(profile, self.dcfg)
        self.profiles[task] = profile
        self.tables[task] = tab
        return tab

    def update_ema(self, task: str, profile: CalibrationProfile,
                   alpha: float) -> np.ndarray:
        """Online variant: EMA the task's table towards the table implied
        by a fresh profile."""
        new_tab = build_table(profile, self.dcfg)
        old = self.tables.get(task)
        tab = new_tab if old is None else (
            (1.0 - alpha) * old + alpha * new_tab).astype(np.float32)
        self.tables[task] = tab
        return tab

    @staticmethod
    def npz_path(path: str) -> str:
        """np.savez appends '.npz' to bare paths; normalise so save, load
        and existence checks agree on the name."""
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str) -> None:
        path = self.npz_path(path)
        arrays: Dict[str, np.ndarray] = {
            "__geometry__": np.asarray(
                [self.dcfg.num_blocks, self.dcfg.steps_cap,
                 self.dcfg.block_size], np.int64),
        }
        for task, tab in self.tables.items():
            arrays[f"table::{task}"] = tab
            prof = self.profiles.get(task)
            if prof is not None:
                arrays[f"conf::{task}"] = prof.conf
                arrays[f"valid::{task}"] = prof.valid
                arrays[f"steps::{task}"] = prof.steps
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, dcfg: DecodeConfig) -> "CalibrationStore":
        store = cls(dcfg)
        with np.load(cls.npz_path(path)) as z:
            geom = z["__geometry__"]
            if (int(geom[0]), int(geom[1]), int(geom[2])) != (
                    dcfg.num_blocks, dcfg.steps_cap, dcfg.block_size):
                raise ValueError("calibration store saved with a different "
                                 "block geometry")
            for key in z.files:
                if not key.startswith("table::"):
                    continue
                task = key[len("table::"):]
                store.tables[task] = z[key].astype(np.float32)
                if f"conf::{task}" in z.files:
                    store.profiles[task] = CalibrationProfile(
                        conf=z[f"conf::{task}"],
                        valid=z[f"valid::{task}"],
                        steps=z[f"steps::{task}"])
        return store


class TaskView:
    """Read-only per-task view over a :class:`CalibrationStore`."""

    def __init__(self, store: CalibrationStore, task: str):
        self.store = store
        self.task = task

    @property
    def calibrated(self) -> bool:
        return self.store.calibrated(self.task)

    @property
    def table(self) -> Optional[np.ndarray]:
        return self.store.tables.get(self.task)

    @property
    def profile(self) -> Optional[CalibrationProfile]:
        return self.store.profiles.get(self.task)


class OSDTSession(TaskView):
    """Stateful per-task view over a :class:`CalibrationStore`: calibrates
    on the first request, then serves with the calibrated table."""

    def __init__(self, params, cfg: ModelConfig, dcfg: DecodeConfig,
                 mask_id: int, *, use_cache: bool = True,
                 online_ema: float = 0.0, attn_impl: str = "",
                 store: Optional[CalibrationStore] = None,
                 task: str = "default", gen_fn=None):
        """``online_ema`` > 0 EMA-updates the table after each Phase-2
        generation from that generation's own profile; 0 is the paper.
        ``store``/``task`` bind the session to a shared store; ``gen_fn``
        replaces the generate function built from ``dcfg``. The session
        runs on the device that holds ``params``."""
        super().__init__(store if store is not None
                         else CalibrationStore(dcfg), task)
        self.params = params
        self.cfg = cfg
        self.dcfg = dcfg
        self.mask_id = int(mask_id)
        self.online_ema = online_ema
        self._gen = gen_fn if gen_fn is not None else make_generate_fn(
            cfg, dcfg, use_cache=use_cache, attn_impl=attn_impl)
        self.total_nfe = 0
        self.total_tokens = 0

    def generate(self, prompt) -> GenerateResult:
        """prompt: [B, P] int. The first call calibrates (Phase 1)."""
        first = not self.calibrated
        res = self._gen(self.params, prompt, self.store.table(self.task),
                        self.mask_id)
        if first:
            self.store.ingest(self.task, result_profile(res))
        elif self.online_ema > 0.0:
            prof = result_profile(res)
            if prof.valid.any():
                self.store.update_ema(self.task, prof, self.online_ema)
        self.total_nfe += int(res.nfe)
        self.total_tokens += int(np.prod(res.tokens.shape))
        return res

    def run_batch(self, prompts: List) -> Tuple[List, dict]:
        """Decode a list of [B, P] prompt arrays; returns (results, stats)."""
        results = [self.generate(p) for p in prompts]
        stats = {
            "nfe": self.total_nfe,
            "tokens": self.total_tokens,
            "tokens_per_nfe": self.total_tokens / max(self.total_nfe, 1),
        }
        return results, stats
