"""Slot-based batching scheduler for diffusion decoding: the batch-boundary
path of the reference's ``serving/scheduler.py``.

The generate function is built ONCE per engine for fixed ``[batch_size,
prompt_len]`` batches; everything that varies per request rides as a
runtime argument: the per-slot threshold table ``[B, nb, steps_cap]``
gathered from the :class:`~repro_torch.core.osdt.CalibrationStore`, the
per-slot ``live`` mask, and the EOS id. That is what lets a *mixed-task*
request stream share one batch: OSDT's table is a task-level artifact,
and here every row of a batch may belong to a different task.

Lifecycle (SERVING.md):

  QUEUED --admit--> ACTIVE --decode--> RETIRED (response emitted)
                 \\-> slots with no request are admitted DEAD: mask-only
                     prompt rows with ``live=False`` that cost no
                     denoising steps of their own.

The decoder records the confidence profile of EVERY live row, so each
*uncalibrated* task's first admitted request, whatever slot it lands in,
becomes that task's one-shot calibration (paper Algorithm 1), and several
new tasks calibrate inside one mixed batch. Extra requests of a
not-yet-calibrated task ride along on the static table.

With ``DecodeConfig.cache_layout == "paged"`` the scheduler owns the page
pool for its whole life and a host :class:`~repro_torch.models.cache.
PageAllocator`. Admission forks each request off the shared system-prompt
pages (``PageAllocator.fork``: the shared pages mapped read-only, private
pages for the logical range the row writes), retirement releases the
fork, and a request is admissible as soon as enough *pages* are free.
Dead slots map no pages. ``EngineConfig.shared_prefix`` is prefilled ONCE
into those shared pages at construction. The generate writes the pool in
place and only reads pages below the shared length; pages that a later
batch reuses keep earlier rows' K/V, which each call's own positions and
length keep out of sight.

Not ported yet, and raising ``NotImplementedError`` at construction:
step-sliced decode (``slice_len >= 1``), speculative drafting
(``spec_decode``, or ``draft_max_steps`` other than 1), the radix prefix
cache (``prefix_cache``, or a non-zero ``prefix_cache_pages`` or
``prefix_cache_watermark``) and mesh sharding (``data_parallel`` or
``model_parallel`` > 1).
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import DecodeConfig, EngineConfig, ModelConfig
from repro_torch.core.calibrate import CalibrationProfile
from repro_torch.core.decoder import make_generate_fn, result_profile
from repro_torch.core.osdt import CalibrationStore
from repro_torch.data import tokenizer as tok
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as M
from repro_torch.models.quantize import (WEIGHT_DTYPES, decode_weight_bytes,
                                         is_quantized,
                                         quantize_decode_params)
from repro_torch.obs import Observability
from repro_torch.obs.metrics import MetricsRegistry

DEAD_TASK = "__dead__"  # pseudo-task of pad slots (resolves to the static table)


@dataclass
class Request:
    uid: int
    task: str
    prompt: str
    # cacheable prompt prefix (tenant system prompt, few-shot template):
    # the decoded row is always ``shared_prefix + prefix + prompt``, laid
    # out as the reference's radix-cache engines lay it out, and
    # prefilled whole
    prefix: str = ""


@dataclass
class Response:
    uid: int
    task: str
    text: str
    nfe: int          # denoising forwards THIS row needed (its seq_steps)
    wall_s: float     # queue wait + decode wall THIS row was decoded in
    queue_s: float = 0.0
    decode_s: float = 0.0
    tokens_out: int = 0   # tokens delivered after EOS truncation
    tokens_dropped: int = 0  # generated but cut at EOS / never unmasked
    blocks_drafted: int = 0   # spec decode (not ported): always 0
    blocks_accepted: int = 0
    # submit -> the row's first decoded block is available; the batch
    # runtime only observes the batch end, so it equals wall_s
    ttfb_s: float = 0.0
    # radix prefix cache (not ported): always 0
    prefix_hit_pages: int = 0
    prefill_tokens_saved: int = 0


@dataclass
class RequestState:
    req: Request
    t_submit: float
    t_admit: float = 0.0
    slot: int = -1


@dataclass
class Slot:
    """One row of the decode batch. ``state``: free | active | dead.
    ``pages``: private pool pages this slot's request owns (paged layout),
    freed, with the shared-prefix reference, at retirement."""
    index: int
    state: str = "free"
    rs: Optional[RequestState] = None
    pages: Optional[List[int]] = None

    def admit(self, rs: Optional[RequestState],
              pages: Optional[List[int]] = None) -> None:
        self.rs = rs
        self.pages = pages
        self.state = "active" if rs is not None else "dead"
        if rs is not None:
            rs.slot = self.index

    def retire(self) -> None:
        self.rs = None
        self.pages = None
        self.state = "free"


# EngineStats field spec: name -> (python type, help text), the
# reference's whole list, so the exported metrics read the same. Every
# field exports as a Prometheus GAUGE, not a counter, as in the reference.
_STATS_FIELDS: Dict[str, tuple] = {
    "requests": (int, "requests admitted"),
    "tokens": (int, "delivered tokens (post-EOS truncation)"),
    "tokens_dropped": (int, "generated-but-truncated tokens"),
    "nfe": (int, "model forwards across all batches"),
    "wall_s": (float, "sum of batch decode walls"),
    "queue_s": (float, "sum of per-request queue waits"),
    "batches": (int, "monolithic decode batches"),
    "dead_slots": (int, "pad rows admitted dead"),
    "seq_steps": (int, "sum of per-row live denoising steps"),
    # nfe x the resident decode footprint — int8 engines stream ~1/4
    # the f32 bytes per forward
    "weight_bytes_streamed": (int, "decode-weight bytes read"),
    # paged layout occupancy (all 0 under the dense layout)
    "page_capacity": (int, "total pool pages"),
    "pages_peak": (int, "max pages simultaneously allocated"),
    "pages_shared": (int, "pages pinned by the shared prefix"),
    "pages_freed": (int, "private-page frees at retirement"),
    # speculative drafting (all 0 with spec_decode off)
    "blocks_drafted": (int, "row-blocks flagged by the signature"),
    "blocks_accepted": (int, "drafted blocks surviving verification"),
    "draft_batches": (int, "batches running the draft+verify forwards"),
    "nfe_saved": (int, "forwards saved vs stepping (lower bound)"),
    # step-sliced decode (all 0 with slice_len == 0)
    "slices": (int, "compiled slice dispatches"),
    "mid_admits": (int, "requests admitted mid-generation"),
    "ttfb_s": (float, "sum of per-request time-to-first-block"),
    # radix prefix cache (all 0 with prefix_cache off)
    "prefix_hits": (int, "admissions that reused >= 1 tree node"),
    "prefix_misses": (int, "non-empty-prefix admissions reusing none"),
    "prefix_inserts": (int, "tree nodes adopted (seeds + promotions)"),
    "prefix_evictions": (int, "LRU nodes reclaimed under page pressure"),
    "prefix_hit_pages": (int, "tree pages served at admission"),
    "prefill_tokens_saved": (int, "prompt tokens those pages replaced"),
    # the batch's prefill plus the one-time shared prefill
    "prefill_nfe": (int, "prefill forwards"),
}


class EngineStats:
    """Engine counters — a typed VIEW over a ``MetricsRegistry``.

    Field access reads/writes ``engine_<name>`` gauges in the backing
    registry, so the scheduler's ledger IS the exported metric:
    ``obs.prometheus()`` / ``snapshot()`` expose exactly what the stats
    report prints. Reads come back in the field's declared python type.
    SERVING.md "Stats glossary" documents the semantics.
    """

    PREFIX = "engine_"

    def __init__(self, registry=None):
        reg = registry if registry is not None else MetricsRegistry()
        gauges = {}
        for name, (_, help) in _STATS_FIELDS.items():
            g = reg.gauge(self.PREFIX + name, help)
            g.set(0.0)
            gauges[name] = g
        object.__setattr__(self, "registry", reg)
        object.__setattr__(self, "_g", gauges)

    def __getattr__(self, name):  # fields only; properties hit the class
        f = _STATS_FIELDS.get(name)
        if f is None:
            raise AttributeError(name)
        return f[0](object.__getattribute__(self, "_g")[name].get())

    def __setattr__(self, name, value):
        g = object.__getattribute__(self, "_g").get(name)
        if g is None:
            raise AttributeError(f"unknown engine stat {name!r}")
        g.set(float(value))

    def as_dict(self) -> Dict[str, float]:
        return {name: getattr(self, name) for name in _STATS_FIELDS}

    def __eq__(self, other):
        if not isinstance(other, EngineStats):
            return NotImplemented
        return self.as_dict() == other.as_dict()

    def __repr__(self):
        inner = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"EngineStats({inner})"

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s else 0.0

    @property
    def tokens_per_nfe(self) -> float:
        return self.tokens / self.nfe if self.nfe else 0.0

    @property
    def page_util(self) -> float:
        return self.pages_peak / self.page_capacity \
            if self.page_capacity else 0.0

    @property
    def draft_accept_rate(self) -> float:
        return self.blocks_accepted / self.blocks_drafted \
            if self.blocks_drafted else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0


def check_ported(ecfg: EngineConfig) -> None:
    """Raise for the reference's serving features the port lacks, and for
    any non-default setting of their knobs, so none is taken and
    ignored."""
    for on, what in ((ecfg.slice_len >= 1, "step-sliced decode "
                      "(slice_len >= 1) is ROADMAP Queue 1 item 2"),
                     (ecfg.spec_decode or ecfg.draft_max_steps != 1,
                      "speculative drafting (spec_decode, draft_max_steps) "
                      "is ROADMAP Queue 1 item 4"),
                     (ecfg.prefix_cache or ecfg.prefix_cache_pages != 0
                      or ecfg.prefix_cache_watermark != 0.0,
                      "the radix prefix cache (prefix_cache, "
                      "prefix_cache_pages, prefix_cache_watermark) is "
                      "ROADMAP Queue 1 item 5"),
                     (ecfg.data_parallel > 1 or ecfg.model_parallel > 1,
                      "mesh-sharded serving (data_parallel or "
                      "model_parallel > 1) is ROADMAP Queue 1 item 8")):
        if on:
            raise NotImplementedError(f"not ported yet: {what}")


class Scheduler:
    """Request queue + slot pool + one generate function.

    ``step()`` admits up to ``batch_size`` queued requests into slots,
    decodes one batch, retires every slot, and returns the responses.
    ``run()`` drains the queue. Unfilled slots are admitted DEAD. The
    batch runs on the device that holds ``params``.
    """

    def __init__(self, params, cfg: ModelConfig, dcfg: DecodeConfig, *,
                 ecfg: Optional[EngineConfig] = None,
                 store: Optional[CalibrationStore] = None,
                 obs: Optional[Observability] = None,
                 mask_id: int = tok.MASK_ID, eos_id: int = tok.EOS_ID):
        self.params = params
        self.cfg = cfg
        self.dcfg = dcfg
        self.ecfg = ecfg if ecfg is not None else EngineConfig()
        check_ported(self.ecfg)
        mode = self.ecfg.resolved_cache_mode()
        # weight streaming dtype: quantize ONCE at load (before the page
        # pool's shared prefill), and price each forward's weight traffic
        # for the ``weight_bytes_streamed`` stat
        self.weight_dtype = self.ecfg.weight_dtype or dcfg.weight_dtype \
            or "bf16"
        assert self.weight_dtype in WEIGHT_DTYPES, self.weight_dtype
        if self.weight_dtype == "int8" and not is_quantized(self.params):
            self.params = quantize_decode_params(params, cfg)
        self._decode_w_bytes = decode_weight_bytes(self.params, cfg)
        if store is not None:
            # an explicitly passed store wins over any on-disk npz
            self.store = store
        elif self.ecfg.store_path and os.path.exists(
                CalibrationStore.npz_path(self.ecfg.store_path)):
            self.store = CalibrationStore.load(self.ecfg.store_path, dcfg)
        else:
            self.store = CalibrationStore(dcfg)
        self.mask_id = int(mask_id)
        self.eos_id = int(eos_id)
        self.queue: Deque[RequestState] = deque()
        self.slots = [Slot(i) for i in range(self.ecfg.batch_size)]
        # observability bundle: the stats ledger is a view over its
        # registry; tracing and drift telemetry stay off unless
        # EngineConfig opts in
        self.obs = obs if obs is not None else Observability.from_config(
            self.ecfg, store=self.store)
        self.stats = EngineStats(self.obs.registry)
        self._h_queue = self.obs.registry.histogram(
            "queue_wait_seconds", "submit -> admission wait per request")
        self._h_dispatch = self.obs.registry.histogram(
            "dispatch_seconds", "compiled decode dispatch wall")
        self.seen_tasks: Dict[str, int] = {}  # task -> requests admitted
        self.paged = dcfg.cache_layout == "paged" and mode != "none"
        self.mesh = None  # single-device runtime (no mesh sharding yet)
        self._prefix_memo: Dict[str, Tuple[List[int], int]] = {}

        # the shared system prompt is prepended to every row's prompt
        # under BOTH layouts (same tokens in, comparable runs), rounded
        # down to whole pages; only the paged layout also stores its K/V
        # once, in shared pages
        self.shared_len = 0           # shared-prefix tokens (page multiple)
        self._shared_ids: List[int] = []
        self._shared_pages: List[int] = []
        if self.ecfg.shared_prefix:
            ps = dcfg.page_size
            ids = tok.encode(self.ecfg.shared_prefix, bos=True)
            # keep at least one page of per-row prompt, so decode writes
            # never touch a shared page
            cap = (max(self.ecfg.prompt_len - ps, 0) // ps) * ps
            self.shared_len = min((len(ids) // ps) * ps, cap)
            self._shared_ids = ids[:self.shared_len]
        if self.paged:
            self._init_page_pool(mode)
        # dispatch-timer key: layout x runtime x epilogue
        fusion = dcfg.step_fusion or "unfused"
        if self.weight_dtype != "bf16":
            fusion += f"-{self.weight_dtype}"
        self._prog_kind = "/".join((
            "paged" if self.paged else "dense", "batch", fusion))
        self._gen = make_generate_fn(
            cfg, dcfg, cache_mode=mode, attn_impl=self.ecfg.attn_impl,
            cache_layout="paged" if self.paged else "dense",
            shared_prefix_len=self.shared_len if self.paged else 0,
            weight_dtype=self.weight_dtype)

    def _count_nfe(self, n: int) -> None:
        """Every counted forward streams the decode weight set once."""
        self.stats.nfe += n
        self.stats.weight_bytes_streamed += n * self._decode_w_bytes

    # -- page pool (paged layout; SERVING.md "Paged KV") ----------------
    def _init_page_pool(self, mode: str) -> None:
        cfg, dcfg, ecfg = self.cfg, self.dcfg, self.ecfg
        ps = dcfg.page_size
        B, P = ecfg.batch_size, ecfg.prompt_len
        self.max_len = P + dcfg.max_new_tokens + \
            (dcfg.block_size if mode == "dual" else 0)
        self.n_log = dcfg.pages_per_seq(self.max_len)
        n_shared = self.shared_len // ps
        self.private_per_slot = self.n_log - n_shared
        num_pages = ecfg.num_pages or (n_shared + B * self.private_per_slot)
        assert num_pages >= n_shared + self.private_per_slot, \
            f"pool of {num_pages} pages cannot fit one request"
        self.allocator = cache_lib.PageAllocator(num_pages)
        dev = self.params["embed"].device
        pool = cache_lib.init_paged_kv_cache(
            cfg.num_layers, B, self.max_len, cfg.num_kv_heads,
            cfg.resolved_head_dim, M.param_dtype(cfg), page_size=ps,
            num_pages=num_pages, device=dev)
        self._pool_k, self._pool_v = pool["kp"], pool["vp"]
        self.stats.page_capacity = num_pages
        if self.shared_len:
            # prefill the shared prefix ONCE; the scheduler keeps a
            # permanent reference so retirement never reclaims the pages
            self._shared_pages = self.allocator.alloc(n_shared)
            spt = np.full((1, self.n_log), -1, np.int32)
            spt[0, :n_shared] = self._shared_pages
            kv = {"kp": self._pool_k, "vp": self._pool_v,
                  "pt": torch.as_tensor(spt, device=dev),
                  "pos": torch.full((self.max_len,), -1, dtype=torch.int32,
                                    device=dev),
                  "length": 0}
            shared = torch.as_tensor([self._shared_ids], dtype=torch.int32,
                                     device=dev)
            M.prefill(self.params, cfg, shared, max_len=self.max_len,
                      mode="full", cache={"attn": kv}, page_size=ps)
            self._count_nfe(1)  # the one-time shared-prefix forward
            self.stats.prefill_nfe += 1
        self.stats.pages_shared = len(self._shared_pages)
        self.stats.pages_peak = self.allocator.in_use

    # -- queue ----------------------------------------------------------
    def submit(self, requests: List[Request],
               at: Optional[float] = None) -> None:
        """Enqueue requests. ``at`` overrides the submit timestamp (a
        ``time.perf_counter()`` value), so queue waits can be measured
        from an arrival time."""
        now = time.perf_counter() if at is None else at
        tr = self.obs.tracer
        for r in requests:
            self.queue.append(RequestState(r, now))
            if tr:
                tr.abegin("request", r.uid, t=now, task=r.task)
                tr.abegin("queued", r.uid, t=now)

    def pending(self) -> int:
        return len(self.queue)

    # -- batch formation ------------------------------------------------
    def _fill(self) -> Tuple[List[RequestState], Dict[str, int]]:
        """Pop admissible requests (FIFO).

        Returns (picked, calib_rows): ``picked[i]`` lands in slot ``i``;
        ``calib_rows`` maps each not-yet-calibrated task to the row whose
        recorded profile will calibrate it (its first admitted request).

        Paged layout: admission stops once the page pool cannot fit
        another request's private pages.
        """
        B = self.ecfg.batch_size
        if self.paged and self.private_per_slot:
            B = min(B, self.allocator.available // self.private_per_slot)
        picked: List[RequestState] = []
        calib_rows: Dict[str, int] = {}
        while self.queue and len(picked) < B:
            rs = self.queue.popleft()
            t = rs.req.task
            if not self.store.calibrated(t) and t not in calib_rows:
                calib_rows[t] = len(picked)
            picked.append(rs)
        return picked, calib_rows

    # -- decode ---------------------------------------------------------
    def step(self) -> List[Response]:
        picked, calib_rows = self._fill()
        if not picked:
            return []
        P = self.ecfg.prompt_len
        tr = self.obs.tracer
        now = time.perf_counter()
        for slot, rs in zip(self.slots, picked):
            rs.t_admit = now
            pages = None
            if self.paged:
                # admit = fork off the shared-prefix pages: a read-only
                # reference on them plus private pages for the logical
                # range this row writes (_fill guaranteed availability)
                _, pages = self.allocator.fork(self._shared_pages,
                                               self.private_per_slot)
            slot.admit(rs, pages)
            if tr:
                tr.aend("queued", rs.req.uid, t=now)
                tr.begin("serve", tid=self.obs.slot_track(slot.index),
                         t=now, uid=rs.req.uid, task=rs.req.task)
            self.seen_tasks[rs.req.task] = \
                self.seen_tasks.get(rs.req.task, 0) + 1
        for slot in self.slots[len(picked):]:
            slot.admit(None)  # explicit dead slot: zero pages

        # the slot pool is the source of truth for the batch's runtime
        # arguments: prompt rows, liveness, per-slot tables and (paged)
        # the page tables
        rows, tasks = [], []
        n_shared = self.shared_len // self.dcfg.page_size if self.paged \
            else 0
        page_tables = np.full((len(self.slots), self.n_log), -1, np.int32) \
            if self.paged else None
        for slot in self.slots:
            if slot.state == "active":
                rows.append(self._prompt_row(slot.rs))
                tasks.append(slot.rs.req.task)
                if self.paged:
                    page_tables[slot.index, :n_shared] = self._shared_pages
                    page_tables[slot.index, n_shared:] = slot.pages
            else:  # dead slot: mask-only prompt row, live=False
                rows.append([self.mask_id] * P)
                tasks.append(DEAD_TASK)
        prompt = np.asarray(rows, np.int32)
        live = np.asarray([s.state == "active" for s in self.slots])
        n_dead = int((~live).sum())
        tables = self.store.tables_for(tasks)
        if self.paged:
            self.stats.pages_peak = max(self.stats.pages_peak,
                                        self.allocator.in_use)

        served: set = set()   # slots whose serve span closed (trace)
        batch_open = False
        try:
            t0 = time.perf_counter()
            if tr:
                tr.begin("batch", tid=0, t=t0, rows_live=len(picked),
                         dead=n_dead,
                         pages_in_use=self.allocator.in_use
                         if self.paged else 0,
                         draft_blocks=0)
                batch_open = True
            args = (self.params, prompt, tables, self.mask_id, live,
                    self.eos_id if self.ecfg.eos_early_exit else None)
            if self.paged:
                args += (self._pool_k, self._pool_v, page_tables)
            res = self._gen(*args)
            tokens = res.tokens.cpu().numpy()  # waits for the device
            t_end = time.perf_counter()
            decode_s = t_end - t0
            if tr:
                tr.end("batch", tid=0, t=t_end, nfe=int(res.nfe))
                batch_open = False
            self.obs.timer.add(self._prog_kind, decode_s, int(res.nfe))
            self._h_dispatch.observe(decode_s, kind="batch")

            for task, row in calib_rows.items():
                # each new task calibrates from its own row's recording
                # and step counts
                self.store.ingest(task, result_profile(res, row=row))
                if tr:
                    tr.instant("calibrate", t=t_end, task=task, row=row)
            if calib_rows and self.ecfg.store_path:
                self.store.save(self.ecfg.store_path)

            seq_steps = res.seq_steps.cpu().numpy()
            drift = self.obs.drift
            if drift is not None:
                # one batch conversion, not one per served row
                thr = res.thr_steps.cpu().numpy()
                msum = res.margin_sum.cpu().numpy()
                mn = res.margin_n.cpu().numpy()
                conf_rec = res.conf.cpu().numpy()
                val_rec = res.conf_valid.cpu().numpy()
            out: List[Response] = []
            for slot in self.slots:
                if slot.rs is None:
                    continue
                j, rs = slot.index, slot.rs
                row = tokens[j].tolist()
                if self.eos_id in row:
                    row = row[:row.index(self.eos_id)]
                row = [t for t in row if t != self.mask_id]
                queue_s = rs.t_admit - rs.t_submit
                steps = int(seq_steps[j].sum())
                out.append(Response(
                    rs.req.uid, rs.req.task, tok.decode(row),
                    nfe=steps, wall_s=queue_s + decode_s, queue_s=queue_s,
                    decode_s=decode_s, tokens_out=len(row),
                    tokens_dropped=tokens.shape[1] - len(row),
                    # batch granularity: the first block is only
                    # observable when the whole batch returns
                    ttfb_s=queue_s + decode_s))
                self.stats.tokens += len(row)
                self.stats.tokens_dropped += tokens.shape[1] - len(row)
                self.stats.queue_s += queue_s
                self.stats.ttfb_s += queue_s + decode_s
                self.stats.seq_steps += steps
                self._h_queue.observe(queue_s)
                if drift is not None:
                    drift.observe(rs.req.task,
                                  CalibrationProfile(conf=conf_rec[j],
                                                     valid=val_rec[j],
                                                     steps=seq_steps[j]),
                                  thr_steps=thr[j], seq_steps=seq_steps[j],
                                  margin_sum=msum[j], margin_n=mn[j])
                if tr:
                    tr.end("serve", tid=self.obs.slot_track(j), t=t_end,
                           tokens=len(row), nfe=steps)
                    tr.aend("request", rs.req.uid, t=t_end)
                    served.add(j)
            self.stats.requests += len(picked)
            self._count_nfe(int(res.nfe))
            self.stats.prefill_nfe += 1  # the batch's prefill
            self.stats.wall_s += decode_s
            self.stats.batches += 1
            self.stats.dead_slots += n_dead
        except BaseException:
            # a failed batch must not swallow its requests: put them
            # back at the head of the queue (FIFO order preserved) so a
            # retried run() can still serve every uid
            if tr:
                tr.instant("batch_failed", tid=0)
                if batch_open:
                    tr.end("batch", tid=0, error=True)
                for slot in self.slots:
                    if slot.rs is None:
                        continue
                    if slot.index in served:
                        # its response was already emitted when the
                        # failure hit; the requeue re-serves it, so
                        # re-open the lifecycle span for balance
                        tr.abegin("request", slot.rs.req.uid,
                                  task=slot.rs.req.task)
                    else:
                        tr.end("serve",
                               tid=self.obs.slot_track(slot.index),
                               requeued=True)
            for rs in reversed(picked):
                self.queue.appendleft(rs)
                if tr:
                    tr.abegin("queued", rs.req.uid)
            raise
        finally:
            # retire = reclaim, even when decode raises: a leak would
            # shrink the pool until _fill admits nothing
            for slot in self.slots:
                if self.paged and slot.pages is not None:
                    # release the fork: private pages return to the free
                    # list; the shared-prefix reference is dropped (the
                    # scheduler's own reference keeps those pages)
                    self.allocator.free(slot.pages)
                    self.allocator.free(self._shared_pages)
                    self.stats.pages_freed += len(slot.pages)
                slot.retire()
        return out

    # -- prompt rows ----------------------------------------------------
    def _prompt_row(self, rs: RequestState) -> List[int]:
        P = self.ecfg.prompt_len
        if rs.req.prefix:
            # prefix-layout row, the reference's radix-cache layout,
            # prefilled whole
            return self._row_tokens(rs.req)
        ids = tok.encode(rs.req.prompt, bos=True)
        ids = ids[-(P - self.shared_len):]
        return self._shared_ids + tok.pad_left(ids, P - self.shared_len)

    def _row_tokens(self, req: Request) -> List[int]:
        """The request's full [prompt_len] row in the prefix layout:
        cacheable stream left-anchored up to its page-rounded boundary,
        remainder right-aligned (pads in the middle)."""
        P = self.ecfg.prompt_len
        pfx, _ = self._row_prefix_ids(req)
        L = len(pfx)
        full = tok.encode(self.ecfg.shared_prefix + req.prefix
                          + req.prompt, bos=True)
        rest = full[L:][-(P - L):]
        return list(pfx) + tok.pad_left(rest, P - L)

    def _row_prefix_ids(self, req: Request) -> Tuple[List[int], int]:
        """The request's cacheable token stream and its shared-template
        boundary: ``(ids, m0)`` where ``ids`` is the page-rounded (and
        capped: at least one page of the row stays per-request) encoding
        of ``shared_prefix + req.prefix`` and ``ids[:m0]`` is the
        page-rounded shared template alone. The byte tokenizer
        concatenates (``encode(a + b) == encode(a) + bytes(b)``), which
        keeps the boundaries stable under memoization by tenant
        prefix."""
        hit = self._prefix_memo.get(req.prefix)
        if hit is not None:
            return hit
        ps, P = self.dcfg.page_size, self.ecfg.prompt_len
        cap = (max(P - ps, 0) // ps) * ps
        shared = tok.encode(self.ecfg.shared_prefix, bos=True) \
            if self.ecfg.shared_prefix else []
        ids = tok.encode(self.ecfg.shared_prefix + req.prefix, bos=True)
        L = min((len(ids) // ps) * ps, cap)
        m0 = min((len(shared) // ps) * ps, cap, L)
        out = (ids[:L], m0)
        self._prefix_memo[req.prefix] = out
        return out

    def run(self) -> List[Response]:
        out: List[Response] = []
        while self.queue:
            got = self.step()
            if not got:  # nothing admissible (should not happen)
                break
            out.extend(got)
        return out
