"""Diffusion serving engine — a thin facade over the batching scheduler
(``repro_torch.serving.scheduler``, SERVING.md, SERVING_TORCH.md).

Requests carry a ``task`` tag; the engine keeps ONE
:class:`~repro_torch.core.osdt.CalibrationStore` (task → calibrated
threshold table: the paper's observation O2 says the confidence signature
is a *task-level* property) and ONE generate function. Mixed-task batches
are the normal case: each slot's table is gathered per row at runtime.

``submit()`` is the synchronous surface: enqueue, drain, and return
responses in uid order. Callers that want batch-granularity control
(admit/step/retire, per-batch stats) drive the scheduler directly.

Throughput accounting (``EngineStats``): NFE (model forwards), *delivered*
tokens (post-EOS truncation), and per-request wall = its own queue wait +
the decode wall it was decoded in. Under the paged KV layout the stats
also report page-pool occupancy: ``page_capacity``, ``pages_peak`` /
``page_util``, ``pages_shared``, ``pages_freed``.

The engine runs on the device that holds ``params``: the port's entry
points that make params (``model.init_params``, ``convert.
load_checkpoint``, ``convert.params_from_numpy``) put them on CUDA unless
the caller asks for the CPU. Step-sliced decode, drafting, the radix
prefix cache and mesh sharding are not ported and raise
``NotImplementedError``; ``DiffusionEngine.mesh`` is always ``None``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.config.base import DecodeConfig, EngineConfig, ModelConfig
from repro_torch.core.osdt import CalibrationStore, TaskView
from repro_torch.data import tokenizer as tok
from repro_torch.serving.scheduler import (EngineStats, Request, Response,
                                           Scheduler)

__all__ = ["DiffusionEngine", "EngineStats", "Request", "Response",
           "TaskView"]


class DiffusionEngine:
    def __init__(self, params, cfg: ModelConfig, dcfg: DecodeConfig, *,
                 ecfg: Optional[EngineConfig] = None,
                 mask_id: int = tok.MASK_ID, eos_id: int = tok.EOS_ID,
                 store: Optional[CalibrationStore] = None):
        """``ecfg`` carries every serving knob (batch shape, cache mode,
        block-step attention, EOS early exit, calibration persistence —
        see ``EngineConfig``); absent, its defaults. Pass
        ``EngineConfig(attn_impl="kernel")`` to serve through the block
        attention kernel on the card."""
        ecfg = ecfg if ecfg is not None else EngineConfig()
        self.params = params
        self.cfg = cfg
        self.dcfg = dcfg
        self.ecfg = ecfg
        self.scheduler = Scheduler(params, cfg, dcfg, ecfg=ecfg,
                                   store=store, mask_id=mask_id,
                                   eos_id=eos_id)

    # -- convenience surface --------------------------------------------
    @property
    def store(self) -> CalibrationStore:
        return self.scheduler.store

    @property
    def stats(self) -> EngineStats:
        return self.scheduler.stats

    @property
    def obs(self):
        """The scheduler's :class:`repro_torch.obs.Observability` bundle
        (tracer, metrics registry, drift monitor, dispatch timer)."""
        return self.scheduler.obs

    @property
    def mesh(self):
        """The serving mesh: ``None``, the single-device runtime (mesh
        sharding is not ported)."""
        return self.scheduler.mesh

    @property
    def sessions(self) -> Dict[str, TaskView]:
        """task → read-only calibration view, for every task ever admitted."""
        return {t: TaskView(self.store, t)
                for t in self.scheduler.seen_tasks}

    def submit(self, requests: List[Request]) -> List[Response]:
        """Synchronous drain: enqueue, run to completion, uid order."""
        self.scheduler.submit(requests)
        out = self.scheduler.run()
        out.sort(key=lambda r: r.uid)
        return out
