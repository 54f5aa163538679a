"""Block diffusion decoder (semi-autoregressive MDLM generation).

The reference compiles one program per variant and keeps the threshold
table a runtime argument; here the generate function runs eagerly, and
the table is likewise an argument, so static / factor / OSDT share one
code path.

Cache modes:
  * ``prefix`` — Fast-dLLM prefix KV cache: the prompt is prefilled
    bidirectionally, each denoising step runs ``block_step`` over the
    active block only, and the block's K/V are committed after it
    completes (one extra forward per block, counted in NFE);
  * ``dual``   — prefix plus suffix: the response region's K/V are
    refreshed once per block, so steps also see the future masked blocks;
  * ``none``   — vanilla LLaDA: every step is a full forward over
    [prompt | response].

Unmasking rules per step:
  quota  > 0 : LLaDA fixed-step baseline — top-``quota`` masked positions.
  quota == 0 : threshold rule — unmask every masked position with
               confidence > table[block, step]; if none clears it, the
               single most confident masked position (Algorithm 1 l.19-21).

The reference's ``while_loop`` over steps depends on the data, so this
loop reads one boolean from the device per step (the known host sync of
the eager port), and one per block for the liveness checks.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.base import DecodeConfig, ModelConfig
from repro_torch.core.calibrate import CalibrationProfile
from repro_torch.core.confidence import confidence
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as M
from repro_torch.models.quantize import WEIGHT_DTYPES


class GenerateResult(NamedTuple):
    tokens: torch.Tensor           # [B, max_new_tokens] int32
    nfe: int                       # model forwards executed
    conf: torch.Tensor             # [B, nb, steps_cap, block_size] f32
    conf_valid: torch.Tensor       # same, bool
    steps_per_block: torch.Tensor  # [nb] int32 — batch-max steps per block
    seq_steps: torch.Tensor        # [B, nb] int32 — steps each row was live
    live: torch.Tensor             # [B] bool — row still live at exit
    thr_steps: torch.Tensor        # [B, nb] int32 — steps where a position
    #                                cleared tau outright
    margin_sum: torch.Tensor       # [B, nb] f32 — sum (conf - tau) cleared
    margin_n: torch.Tensor         # [B, nb] int32 — cleared positions


def _threshold_fallback(conf, masked, above, live):
    """Algorithm 1 l.19-21: positions already above threshold, plus the
    single most confident masked position for live rows where none
    cleared it."""
    conf_m = torch.where(masked, conf, -torch.inf)
    best = torch.argmax(conf_m, dim=-1)
    need_fb = (~above.any(dim=-1)) & masked.any(dim=-1)
    if live is not None:
        need_fb = need_fb & live
    fb = torch.nn.functional.one_hot(best, conf.shape[-1]).bool() \
        & need_fb[:, None]
    return above | (fb & masked)


def _unmask_choice(conf, toks, block, mask_id: int, tau, quota: int,
                   live=None):
    """Boolean [B, bs] of positions to unmask this step; ``tau`` is a
    scalar or per-row [B]."""
    masked = block == mask_id
    conf_m = torch.where(masked, conf, -torch.inf)
    if quota > 0:
        order = torch.argsort(torch.argsort(-conf_m, dim=-1, stable=True),
                              dim=-1, stable=True)
        return (order < quota) & masked
    above = (conf_m > torch.reshape(tau, (-1, 1))) & masked
    return _threshold_fallback(conf, masked, above, live)


def _norm_slice_key(dcfg: DecodeConfig, use_cache: bool, cache_mode: str,
                    attn_impl: str, cache_layout: str,
                    shared_prefix_len: int, variant: str = "step",
                    step_fusion: str = "", weight_dtype: str = ""):
    """THE decode-variant normalisation: ``make_generate_fn`` and the
    sliced family share it, so spelling-equivalent calls cannot key or
    validate the monolithic and the sliced paths differently. Returns
    ``(cache_mode, attn_impl, cache_layout, shared_prefix_len,
    step_fusion, weight_dtype)``; the cacheless mode's layout is "dense".
    """
    cache_mode = cache_mode or ("prefix" if use_cache else "none")
    attn_impl = attn_impl or dcfg.attn_impl
    step_fusion = step_fusion or dcfg.step_fusion or "unfused"
    cache_layout = cache_layout or dcfg.cache_layout or "dense"
    weight_dtype = weight_dtype or dcfg.weight_dtype or "bf16"
    if cache_mode not in ("prefix", "dual", "none") or attn_impl not in (
            "auto", "dense", "flash", "kernel") or step_fusion not in (
            "unfused", "fused") or cache_layout not in ("dense", "paged") \
            or weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"unknown decode variant {cache_mode!r}, "
                         f"{attn_impl!r}, {step_fusion!r}, "
                         f"{cache_layout!r}, {weight_dtype!r}")
    if variant == "draft":
        raise NotImplementedError(
            "not ported yet: speculative drafting (variant='draft') is "
            "ROADMAP Queue 1 item 4")
    if variant != "step":
        raise ValueError(f"unknown decode variant {variant!r}")
    if cache_mode == "none":
        cache_layout = "dense"
    ps, Sp = dcfg.page_size, shared_prefix_len
    if Sp and (cache_layout != "paged" or Sp % ps):
        raise ValueError(f"shared_prefix_len={Sp} needs the paged layout "
                         f"and a multiple of page_size={ps}")
    return (cache_mode, attn_impl, cache_layout, Sp, step_fusion,
            weight_dtype)


def make_generate_fn(cfg: ModelConfig, dcfg: DecodeConfig, *,
                     use_cache: bool = True, quota: int = 0,
                     use_kernel: bool = False, cache_mode: str = "",
                     attn_impl: str = "", step_fusion: str = "",
                     cache_layout: str = "", shared_prefix_len: int = 0,
                     weight_dtype: str = ""):
    """Build the generate function.

    fn(params, prompt [B, P] int, table, mask_id, live [B] bool = None,
       eos_id = None) -> GenerateResult

    With the paged cache layout three trailing arguments are added:
    fn(..., pool_k, pool_v, page_table), where pool_k/v
    [L, num_pages, page_size, Kh, D] is the caller's page pool and
    page_table [B, n_log] maps each row's logical pages onto it (-1 =
    unmapped). Unlike the reference, which returns nothing of its updated
    pool copy, the port writes the pool IN PLACE (as its dense cache is
    written): the pages the rows' tables map at slots ``>= Sp`` hold this
    call's K/V afterwards. Pages below ``shared_prefix_len`` are only
    read, so shared-prefix pages keep their contents and a second call
    over the same pool and tables gives the same result.

    ``table`` is the threshold table, per slot [B, nb, steps_cap] or
    shared [nb, steps_cap] (numpy or tensor). ``live`` marks rows that
    decode: dead rows never trigger the fallback nor keep the step loop
    alive, and flush their masks in one ride-along step. ``eos_id`` (None
    disables) retires a row once a completed block of its response holds
    EOS. ``attn_impl`` (default ``dcfg.attn_impl``) picks the block-step
    attention; ``step_fusion`` (default ``dcfg.step_fusion``) picks the
    unfused epilogue (head product, confidence pass, select; the
    confidence pass is the CUDA kernel with ``use_kernel``) or the fused
    kernel. ``cache_layout`` (default ``dcfg.cache_layout``) is "dense" or
    "paged"; ``shared_prefix_len`` (paged only, a multiple of
    ``dcfg.page_size``) marks the first ``Sp`` prompt positions as already
    prefilled into the mapped pages: prefill then encodes only
    ``prompt[:, Sp:]`` against them. ``weight_dtype`` (default
    ``dcfg.weight_dtype``, else "bf16") is checked against
    ``WEIGHT_DTYPES`` and otherwise unused: the reference keys its
    compiled programs on it, and this eager port has no such cache. The
    weights route by type, as in the reference: the ``QuantizedTensor``
    leaves of ``models.quantize.quantize_decode_params`` output take
    every projection through the int8 matmul, and the head through it
    (unfused) or through the int8-head fused step (fused). Everything
    runs on the device that holds ``params``.
    """
    cache_mode, attn_impl, cache_layout, Sp, step_fusion, weight_dtype = \
        _norm_slice_key(dcfg, use_cache, cache_mode, attn_impl, cache_layout,
                        shared_prefix_len, "step", step_fusion, weight_dtype)
    assert cfg.supports_mdlm, f"{cfg.name}: diffusion decoding inapplicable"
    use_cache = cache_mode != "none"
    dual = cache_mode == "dual"
    fused = step_fusion == "fused"
    paged = cache_layout == "paged"
    ps = dcfg.page_size
    N, bs = dcfg.max_new_tokens, dcfg.block_size
    nb, sc = dcfg.num_blocks, dcfg.steps_cap

    def init_cache(params, prompt, pool_k, pool_v, page_table):
        """Prefill the prompt into a dense cache, or into the caller's
        page pool (from ``Sp`` on, when the shared pages hold ``[0,
        Sp)``)."""
        B, P = prompt.shape
        # the dual cache reserves a scratch slot region for the in-flight
        # block beyond [prompt | response]
        max_len = P + N + (bs if dual else 0)
        if not paged:
            return M.prefill(params, cfg, prompt, max_len=max_len,
                             mode="full")[1]
        if pool_k is None or pool_v is None or page_table is None:
            raise ValueError("paged layout: pass pool_k, pool_v, page_table")
        n_log = dcfg.pages_per_seq(max_len)
        if tuple(page_table.shape) != (B, n_log):
            raise ValueError(f"page_table is {tuple(page_table.shape)}, "
                             f"want {(B, n_log)}")
        if Sp >= P:
            raise ValueError(f"shared_prefix_len {Sp} must be below the "
                             f"prompt length {P}")
        dev = prompt.device
        kv = {"kp": pool_k, "vp": pool_v,
              "pt": torch.as_tensor(page_table).to(dev, torch.int32)
              .contiguous(),
              "pos": torch.full((max_len,), -1, dtype=torch.int32,
                                device=dev),
              "length": 0}
        if not Sp:
            return M.prefill(params, cfg, prompt, max_len=max_len,
                             mode="full", cache={"attn": kv},
                             page_size=ps)[1]
        # the shared pages already hold [0, Sp): mark them valid and
        # encode only the per-row remainder against them
        kv["pos"][:Sp] = torch.arange(Sp, dtype=torch.int32, device=dev)
        kv["length"] = Sp
        return M.block_step(params, cfg, prompt[:, Sp:], Sp, {"attn": kv},
                            write=True, attn_impl=attn_impl,
                            page_size=ps)[1]

    def gen(params, prompt, table, mask_id, live=None, eos_id=None,
            pool_k=None, pool_v=None, page_table=None) -> GenerateResult:
        dev = params["embed"].device
        prompt = torch.as_tensor(prompt, dtype=torch.int32).to(dev)
        table = torch.as_tensor(table, dtype=torch.float32).to(dev)
        mask_id = int(mask_id)
        B, P = prompt.shape
        if table.ndim == 2:
            table = table[None].expand((B,) + tuple(table.shape))
        live = torch.ones((B,), dtype=torch.bool, device=dev) if live is None \
            else torch.as_tensor(live).to(dev).bool()
        resp = torch.full((B, N), mask_id, dtype=torch.int32, device=dev)
        conf_rec = torch.zeros((B, nb, sc, bs), dtype=torch.float32,
                               device=dev)
        val_rec = torch.zeros((B, nb, sc, bs), dtype=torch.bool, device=dev)
        steps_used = torch.zeros((nb,), dtype=torch.int32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        seq_steps = torch.zeros((B, nb), **i32)
        thr_steps = torch.zeros((B, nb), **i32)
        margin_sum = torch.zeros((B, nb), dtype=torch.float32, device=dev)
        margin_n = torch.zeros((B, nb), **i32)
        nfe = 0

        cache = None
        if use_cache:
            cache = init_cache(params, prompt, pool_k, pool_v, page_table)
            nfe += 1

        def paged_kw():
            # every paged block step reads the rows' current liveness
            return dict(page_size=ps, row_live=live) if paged else {}

        for b in range(nb):
            start = b * bs
            block = resp[:, start:start + bs].clone()
            block_start = P + start

            if dual and bool(live.any()):
                # refresh the response region's K/V (suffix cache) at slot
                # P without advancing the length
                _, cache = M.block_step(params, cfg, resp, P, cache,
                                        write=True, advance=False,
                                        write_slot=P, attn_impl=attn_impl,
                                        **paged_kw())
                nfe += 1

            def model_out(block, head=True):
                if dual:
                    out, _ = M.block_step(
                        params, cfg, block, block_start, cache,
                        write_slot=P + N, exclude_start=start + P,
                        exclude_len=bs, attn_impl=attn_impl, head=head,
                        **paged_kw())
                    return out
                if use_cache:
                    out, _ = M.block_step(params, cfg, block, block_start,
                                          cache, attn_impl=attn_impl,
                                          head=head, **paged_kw())
                    return out
                x = torch.cat([prompt, resp], dim=1)
                out = M.forward(params, cfg, x, mode="full", head=head)
                return out[:, block_start:block_start + bs]

            step = 0
            # only live rows keep the denoising loop alive (a host sync)
            while step < sc and bool(((block == mask_id)
                                      & live[:, None]).any()):
                masked = block == mask_id
                row_active = live & masked.any(dim=-1)
                tau = table[:, b, min(step, sc - 1)]              # [B]
                if fused:
                    xh = model_out(block, head=False)
                    conf, toks, above = kops.fused_step(
                        xh, M.head_weights(params, cfg),
                        tau[:, None].expand(masked.shape), masked,
                        tied=cfg.tie_embeddings, quota=quota)
                    # quota: the in-kernel top-k is the whole rule
                    unmask = above if quota else _threshold_fallback(
                        conf, masked, above, live)
                else:
                    logits = model_out(block)
                    conf, toks = confidence(logits, use_kernel=use_kernel)
                    unmask = _unmask_choice(conf, toks, block, mask_id, tau,
                                            quota, live)
                # dead rows flush their masks in whatever step rides along
                unmask = unmask | (masked & ~live[:, None])
                block = torch.where(unmask, toks, block)
                resp[:, start:start + bs] = block
                # calibration signal: every live row's masked positions
                rec = masked & live[:, None]
                conf_rec[:, b, step] = torch.where(rec, conf, 0.0)
                val_rec[:, b, step] = rec
                seq_steps[:, b] += row_active.to(torch.int32)
                # drift telemetry: positions that cleared tau outright
                above_t = (torch.where(masked, conf, -torch.inf)
                           > tau[:, None]) & live[:, None]
                thr_steps[:, b] += above_t.any(dim=-1).to(torch.int32)
                margin_sum[:, b] += torch.where(
                    above_t, conf - tau[:, None], 0.0).sum(dim=-1)
                margin_n[:, b] += above_t.sum(dim=-1).to(torch.int32)
                step += 1
                nfe += 1
            steps_used[b] = step

            if eos_id is not None:
                # rows whose completed prefix holds EOS retire
                done = torch.arange(N, device=dev) < (b + 1) * bs
                seen = ((resp == int(eos_id)) & done[None]).any(dim=-1)
                live = live & ~seen

            if use_cache and not dual and bool(live.any()):
                # commit the finished block's K/V (Fast-dLLM prefix cache)
                _, cache = M.block_step(params, cfg, block, block_start,
                                        cache, write=True,
                                        attn_impl=attn_impl, **paged_kw())
                nfe += 1

        return GenerateResult(resp, nfe, conf_rec, val_rec, steps_used,
                              seq_steps, live, thr_steps, margin_sum,
                              margin_n)

    return gen


def result_profile(res: GenerateResult,
                   row: Optional[int] = None) -> CalibrationProfile:
    """Host-side view of one row's recorded confidences (Phase-1 output).

    ``row``: the calibration row — its recording and its own live step
    counts. ``None``: row 0's recording with the batch-max step counts.
    """
    r = 0 if row is None else row
    steps = res.steps_per_block if row is None else res.seq_steps[row]
    return CalibrationProfile(
        conf=res.conf[r].cpu().numpy(),
        valid=res.conf_valid[r].cpu().numpy(),
        steps=steps.cpu().numpy(),
    )


# ---------------------------------------------------------------------------
# step-sliced decode (SERVING.md "Async admission")
#
# The monolithic generate above stays as it is, the oracle. The sliced
# family splits it into host-visible pieces: a slice function runs
# ``slice_len`` block iterations over an explicit ``DecodeCarry``, and the
# host drives the loop, retiring EOS rows, reclaiming their pages and
# admitting queued requests into freed slots BETWEEN slices. Each row
# carries its own block cursor (a row admitted afresh decodes block 0
# while its neighbours are at block k), so every block-offset quantity is
# per row; with uniform cursors the values are the monolithic generate's,
# bit for bit (tests/test_torch_sliced.py).
# ---------------------------------------------------------------------------

class DecodeCarry(NamedTuple):
    """Decode state carried between block slices.

    Shapes are fixed per engine: ``B`` slots, ``P`` prompt slots, ``N``
    response slots (= nb * bs). ``cursor`` is PER ROW, the next block each
    row denoises, which lets one batch mix rows admitted at different
    times. ``cache`` is the KV cache dict (dense, or paged with the pool
    inside it), or ``None`` for the cacheless mode. The sliced functions
    update the carry's tensors and the cache IN PLACE (as the reference's
    TPU runtime donates its carry) and return a carry over them.
    """
    resp: torch.Tensor        # [B, N] int32 response tokens (mask = open)
    prompt: torch.Tensor      # [B, P] int32
    table: torch.Tensor       # [B, nb, sc] float32 per-slot tables
    live: torch.Tensor        # [B] bool: False = free slot / EOS-retired
    cursor: torch.Tensor      # [B] int32: next block, nb = done
    conf: torch.Tensor        # [B, nb, sc, bs] calibration recording
    conf_valid: torch.Tensor  # [B, nb, sc, bs] bool
    steps_used: torch.Tensor  # [nb] int32: batch-max steps per block
    seq_steps: torch.Tensor   # [B, nb] int32: per-row live steps
    nfe: int                  # model forwards so far
    cache: Any                # {"attn": ...} or None
    thr_steps: torch.Tensor   # [B, nb] int32 (drift telemetry)
    margin_sum: torch.Tensor  # [B, nb] float32
    margin_n: torch.Tensor    # [B, nb] int32

    def result(self) -> GenerateResult:
        """The accumulated state as a ``GenerateResult``, so
        ``result_profile`` (calibration ingest) works unchanged."""
        return GenerateResult(self.resp, self.nfe, self.conf,
                              self.conf_valid, self.steps_used,
                              self.seq_steps, self.live, self.thr_steps,
                              self.margin_sum, self.margin_n)


def init_decode_carry(cfg: ModelConfig, dcfg: DecodeConfig, *, batch: int,
                      prompt_len: int, mask_id: int,
                      cache_mode: str = "prefix", cache_layout: str = "",
                      shared_prefix_len: int = 0, pool_k=None, pool_v=None,
                      page_table=None, device=None) -> DecodeCarry:
    """A fresh all-free carry. The paged layout takes the caller's pool
    and an initial ``[B, n_log]`` page table (free rows all ``-1``) and
    lives on the pool's device; a non-zero ``shared_prefix_len`` expects
    the shared pages to hold their K/V already and marks their slots
    valid, as the monolithic generate does. Otherwise the carry lives on
    ``device``: CUDA unless the caller asks for the CPU."""
    cache_mode, _, cache_layout, Sp, _, _ = _norm_slice_key(
        dcfg, True, cache_mode, "auto", cache_layout, shared_prefix_len)
    B, P = batch, prompt_len
    N, bs = dcfg.max_new_tokens, dcfg.block_size
    nb, sc = dcfg.num_blocks, dcfg.steps_cap
    paged = cache_layout == "paged"
    if paged:
        if pool_k is None or pool_v is None or page_table is None:
            raise ValueError("a paged carry needs pool_k, pool_v, "
                             "page_table")
        dev = pool_k.device
    else:
        dev = resolve_device(device)
    cache = None
    if cache_mode != "none":
        max_len = P + N + (bs if cache_mode == "dual" else 0)
        if paged:
            pos = torch.full((max_len,), -1, dtype=torch.int32, device=dev)
            pos[:Sp] = torch.arange(Sp, dtype=torch.int32, device=dev)
            cache = {"attn": {
                "kp": pool_k, "vp": pool_v,
                "pt": torch.as_tensor(page_table).to(dev, torch.int32)
                .contiguous(),
                "pos": pos, "length": Sp}}
        else:
            cache = {"attn": cache_lib.init_kv_cache(
                cfg.num_layers, B, max_len, cfg.num_kv_heads,
                cfg.resolved_head_dim, M.param_dtype(cfg), dev)}
    i32 = dict(dtype=torch.int32, device=dev)
    return DecodeCarry(
        resp=torch.full((B, N), int(mask_id), **i32),
        prompt=torch.full((B, P), int(mask_id), **i32),
        table=torch.zeros((B, nb, sc), dtype=torch.float32, device=dev),
        live=torch.zeros((B,), dtype=torch.bool, device=dev),
        cursor=torch.full((B,), nb, **i32),
        conf=torch.zeros((B, nb, sc, bs), dtype=torch.float32, device=dev),
        conf_valid=torch.zeros((B, nb, sc, bs), dtype=torch.bool,
                               device=dev),
        steps_used=torch.zeros((nb,), **i32),
        seq_steps=torch.zeros((B, nb), **i32),
        nfe=0, cache=cache,
        thr_steps=torch.zeros((B, nb), **i32),
        margin_sum=torch.zeros((B, nb), dtype=torch.float32, device=dev),
        margin_n=torch.zeros((B, nb), **i32))


def admit_carry_rows(carry: DecodeCarry, rows: Sequence[int], prompts,
                     tables, mask_id: int, *, page_rows=None,
                     live: Optional[Sequence[bool]] = None,
                     mark_prompt_pos: bool = False) -> DecodeCarry:
    """Slot (re)initialisation at admission, in place: place each row's
    prompt, table (and page-table row), reset its response to masks, its
    cursor to block 0, and zero its accumulators. ``live`` marks which
    rows carry a real request (default: all). The KV prefill itself is
    ``make_admit_fn``'s. Rows not in ``rows`` are left as they were. The
    reference's power-of-two row buckets are a compile-time device of
    its JAX program; this eager port writes the rows directly."""
    if mark_prompt_pos:
        raise NotImplementedError(
            "not ported yet: mark_prompt_pos belongs to the radix prefix "
            "cache, ROADMAP Queue 1 item 5")
    if not len(rows):
        return carry
    dev = carry.resp.device
    r = torch.as_tensor(list(rows), dtype=torch.long, device=dev)
    carry.resp[r] = int(mask_id)
    carry.prompt[r] = torch.as_tensor(np.asarray(prompts, np.int32),
                                      device=dev)
    carry.table[r] = torch.as_tensor(np.asarray(tables, np.float32),
                                     device=dev)
    carry.live[r] = torch.as_tensor(
        np.ones(len(rows), bool) if live is None
        else np.asarray(live, bool), device=dev)
    carry.cursor[r] = 0
    for t in (carry.conf, carry.conf_valid, carry.seq_steps,
              carry.thr_steps, carry.margin_sum, carry.margin_n):
        t[r] = 0
    if page_rows is not None:
        carry.cache["attn"]["pt"][r] = torch.as_tensor(
            np.asarray(page_rows, np.int32), device=dev)
    return carry


def retire_carry_rows(carry: DecodeCarry, rows: Sequence[int],
                      num_blocks: int) -> DecodeCarry:
    """Slot release, in place: mark rows dead, set their cursors to
    ``num_blocks`` and (paged) unmap their page-table rows, so pages freed
    to the allocator can go to the next admission without the old row
    still reading or writing them."""
    if not len(rows):
        return carry
    r = torch.as_tensor(list(rows), dtype=torch.long,
                        device=carry.resp.device)
    carry.live[r] = False
    carry.cursor[r] = num_blocks
    if carry.cache is not None and "pt" in carry.cache["attn"]:
        carry.cache["attn"]["pt"][r] = -1
    return carry


def make_admit_fn(cfg: ModelConfig, dcfg: DecodeConfig, *,
                  cache_mode: str = "prefix", attn_impl: str = "",
                  cache_layout: str = "", shared_prefix_len: int = 0):
    """Build the admission function.

    fn(params, carry, admit [B] bool, prefix_len=None) -> carry

    ONE forward prefills the prompts of the rows flagged in ``admit``
    into the carried cache (+1 nfe); every other row's cache stays byte
    for byte as it was. Dense: the whole ``[B, P]`` prompt batch (the
    monolithic prefill's shape) is prefilled into scratch buffers and
    only the admitted rows' prompt slots are copied in. Paged: the
    prefill writes through the page table masked to the admitted rows;
    with a shared prefix it encodes ``prompt[:, Sp:]`` at slot ``Sp``
    against the shared pages, each row limited to them. The host batches
    a slice boundary's admissions into one call. The cacheless mode has
    nothing to prefill. ``prefix_len`` (per-row radix-cache hits) is not
    ported and raises."""
    cache_mode, attn_impl, cache_layout, Sp, _, _ = _norm_slice_key(
        dcfg, True, cache_mode, attn_impl, cache_layout, shared_prefix_len)
    if cache_mode == "none":
        raise ValueError("cacheless decode has nothing to admit")
    assert cfg.supports_mdlm, f"{cfg.name}: diffusion decoding inapplicable"
    paged = cache_layout == "paged"
    ps = dcfg.page_size
    N, bs = dcfg.max_new_tokens, dcfg.block_size
    dual = cache_mode == "dual"

    def admit(params, carry: DecodeCarry, admit_mask,
              prefix_len=None) -> DecodeCarry:
        if prefix_len is not None:
            raise NotImplementedError(
                "not ported yet: per-row prefix_len admission belongs to "
                "the radix prefix cache, ROADMAP Queue 1 item 5")
        B, P = carry.prompt.shape
        dev = carry.resp.device
        kv = carry.cache["attn"]
        sel = np.asarray(torch.as_tensor(admit_mask).cpu(), bool)
        if paged:
            mask = torch.as_tensor(sel, device=dev)
            pt_admit = torch.where(mask[:, None], kv["pt"], -1)
            if Sp:
                # the shared pages hold [0, Sp): encode only the per-row
                # remainder against them; the write slot is explicit since
                # the carried length tracks the batch-max extent
                M.block_step(params, cfg, carry.prompt[:, Sp:], Sp,
                             {"attn": dict(kv, pt=pt_admit)}, write=True,
                             advance=False, write_slot=Sp,
                             attn_impl=attn_impl, page_size=ps,
                             row_limit=torch.full((B,), Sp,
                                                  dtype=torch.int32,
                                                  device=dev))
            else:
                M.prefill(params, cfg, carry.prompt,
                          max_len=P + N + (bs if dual else 0), mode="full",
                          cache={"attn": dict(kv, pt=pt_admit)},
                          page_size=ps)
        else:
            fresh = M.prefill(params, cfg, carry.prompt, max_len=P,
                              mode="full")[1]["attn"]
            r = torch.as_tensor(np.flatnonzero(sel), dtype=torch.long,
                                device=dev)
            kv["k"][:, r, :P] = fresh["k"][:, r]
            kv["v"][:, r, :P] = fresh["v"][:, r]
            kv["pos"][:P] = torch.arange(P, dtype=torch.int32, device=dev)
        kv = dict(kv, length=max(kv["length"], P))
        return carry._replace(cache=dict(carry.cache, attn=kv),
                              nfe=carry.nfe + 1)

    return admit


def make_slice_fn(cfg: ModelConfig, dcfg: DecodeConfig, *,
                  slice_len: int = 1, quota: int = 0,
                  use_kernel: bool = False, cache_mode: str = "prefix",
                  attn_impl: str = "", cache_layout: str = "",
                  shared_prefix_len: int = 0, variant: str = "step",
                  step_fusion: str = "", weight_dtype: str = ""):
    """Build the block-slice function.

    fn(params, carry, mask_id, eos_id=None) -> carry

    Runs ``slice_len`` block iterations of the decode loop. Each
    iteration denoises, for every row, the row's OWN ``cursor`` block,
    with per-row positions, write slots, exclusion ranges and valid
    extents, then advances the cursors, so one batch mixes rows admitted
    at different times. With uniform cursors, driving slices until every
    cursor reaches ``nb`` gives the monolithic ``make_generate_fn``'s
    tokens, ``seq_steps``, recordings, counters and ``nfe``.

    The cursors are read to the host once a slice (they move by rule:
    +1 an iteration); each reference ``lax.cond`` is a host ``if`` on one
    device boolean, and the step loop reads one a step, as the monolithic
    port does. A dense committing forward builds its per-row write index
    with one more sync. The other arguments are ``make_generate_fn``'s;
    ``variant="draft"`` raises (ROADMAP Queue 1 item 4).
    """
    cache_mode, attn_impl, cache_layout, _, step_fusion, _ = \
        _norm_slice_key(dcfg, True, cache_mode, attn_impl, cache_layout,
                        shared_prefix_len, variant, step_fusion,
                        weight_dtype)
    if slice_len < 1:
        raise ValueError(f"slice_len must be >= 1, not {slice_len}")
    assert cfg.supports_mdlm, f"{cfg.name}: diffusion decoding inapplicable"
    use_cache = cache_mode != "none"
    dual = cache_mode == "dual"
    paged = cache_layout == "paged"
    fused = step_fusion == "fused"
    ps = dcfg.page_size
    N, bs = dcfg.max_new_tokens, dcfg.block_size
    nb, sc = dcfg.num_blocks, dcfg.steps_cap

    def slice_fn(params, carry: DecodeCarry, mask_id,
                 eos_id=None) -> DecodeCarry:
        mask_id = int(mask_id)
        resp, prompt, table = carry.resp, carry.prompt, carry.table
        B, P = prompt.shape
        dev = resp.device
        max_len = P + N + (bs if dual else 0)
        cache, nfe, live = carry.cache, carry.nfe, carry.live
        conf_rec, val_rec = carry.conf, carry.conf_valid
        steps_used, seq_steps = carry.steps_used, carry.seq_steps
        thr_steps, margin_sum = carry.thr_steps, carry.margin_sum
        margin_n = carry.margin_n
        rows = torch.arange(B, device=dev)
        cursor_h = carry.cursor.tolist()         # one sync a slice

        def row_extent(live_now, ext):
            """Each row's committed-cache extent [B]: what it may attend
            beyond its own fresh block. Paged masks dead and retired rows
            to 0 (their mapped pages stop being read), dense keeps it."""
            return torch.where(live_now, ext, 0) if paged else ext

        for _ in range(slice_len):
            cur_h = [min(c, nb - 1) for c in cursor_h]
            todo_h = [c < nb for c in cursor_h]
            cur_c = torch.tensor(cur_h, dtype=torch.int32, device=dev)
            col = (cur_c * bs)[:, None] + torch.arange(
                bs, dtype=torch.int32, device=dev)
            col_l = col.long()
            block = torch.gather(resp, 1, col_l)
            block_start = P + cur_c * bs                          # [B]
            ext = torch.tensor([P + (N if dual else min(c, nb) * bs)
                                for c in cursor_h], dtype=torch.int32,
                               device=dev)
            todo = torch.tensor(todo_h, device=dev)
            # finished rows record nothing (the reference's rec_blk = nb
            # drop, spelled as an explicit row selection)
            rec_r = torch.tensor([b for b in range(B) if todo_h[b]],
                                 dtype=torch.long, device=dev)
            rec_b = cur_c[rec_r].long()

            if dual and bool((live & todo).any()):
                _, cache = M.block_step(
                    params, cfg, resp, P, cache, write=True, advance=False,
                    write_slot=P, attn_impl=attn_impl, page_size=ps,
                    row_live=live if paged else None)
                nfe += 1

            lim = row_extent(live, ext)

            def model_out(block, head=True):
                if dual:
                    return M.block_step(
                        params, cfg, block, block_start, cache,
                        write_slot=P + N, exclude_start=block_start,
                        exclude_len=bs, attn_impl=attn_impl, page_size=ps,
                        row_live=live if paged else None, head=head)[0]
                if use_cache:
                    # each row writes (virtually) at its own block slots
                    return M.block_step(
                        params, cfg, block, block_start, cache,
                        write_slot=block_start, attn_impl=attn_impl,
                        page_size=ps, row_limit=lim, head=head)[0]
                x = torch.cat([prompt, resp], dim=1)
                out = M.forward(params, cfg, x, mode="full", head=head)
                return torch.gather(out, 1, (P + col_l)[..., None].expand(
                    B, bs, out.shape[-1]))

            step = 0
            while step < sc and bool(((block == mask_id)
                                      & live[:, None]).any()):
                masked = block == mask_id
                row_active = live & masked.any(dim=-1)
                tau = table[rows, cur_c.long(), min(step, sc - 1)]  # [B]
                if fused:
                    xh = model_out(block, head=False)
                    conf, toks, above = kops.fused_step(
                        xh, M.head_weights(params, cfg),
                        tau[:, None].expand(masked.shape), masked,
                        tied=cfg.tie_embeddings, quota=quota)
                    unmask = above if quota else _threshold_fallback(
                        conf, masked, above, live)
                else:
                    logits = model_out(block)
                    conf, toks = confidence(logits, use_kernel=use_kernel)
                    unmask = _unmask_choice(conf, toks, block, mask_id, tau,
                                            quota, live)
                unmask = unmask | (masked & ~live[:, None])
                block = torch.where(unmask, toks, block)
                resp.scatter_(1, col_l, block)
                rec = masked & live[:, None]
                conf_rec[rec_r, rec_b, step] = torch.where(
                    rec, conf, 0.0)[rec_r]
                val_rec[rec_r, rec_b, step] = rec[rec_r]
                seq_steps[rec_r, rec_b] += row_active.to(torch.int32)[rec_r]
                above_t = (torch.where(masked, conf, -torch.inf)
                           > tau[:, None]) & live[:, None]
                thr_steps[rec_r, rec_b] += above_t.any(dim=-1).to(
                    torch.int32)[rec_r]
                margin_sum[rec_r, rec_b] += torch.where(
                    above_t, conf - tau[:, None], 0.0).sum(dim=-1)[rec_r]
                margin_n[rec_r, rec_b] += above_t.sum(dim=-1).to(
                    torch.int32)[rec_r]
                step += 1
                nfe += 1
            blks = torch.tensor(sorted({cur_h[b] for b in range(B)
                                        if todo_h[b]}), dtype=torch.long,
                                device=dev)
            steps_used[blks] = torch.clamp(steps_used[blks], min=step)

            if eos_id is not None:
                done = torch.arange(N, device=dev)[None] \
                    < ((cur_c + 1) * bs)[:, None]
                seen = ((resp == int(eos_id)) & done).any(dim=-1)
                live = live & ~seen

            if use_cache and not dual and bool((live & todo).any()):
                # commit each working row's block at its own slots; a
                # finished row's sentinel slot max_len drops its write
                wslot = torch.where(todo, block_start, max_len)
                _, cache = M.block_step(
                    params, cfg, block, block_start, cache, write=True,
                    advance=False, write_slot=wslot, attn_impl=attn_impl,
                    page_size=ps, row_limit=row_extent(live, ext))
                kv = cache["attn"]
                top = max(c + 1 for c, t in zip(cur_h, todo_h) if t)
                cache = dict(cache, attn=dict(
                    kv, length=max(kv["length"], P + bs * top)))
                nfe += 1
            cursor_h = [min(c + 1, nb) for c in cursor_h]

        carry.cursor.copy_(torch.tensor(cursor_h, dtype=torch.int32))
        return carry._replace(cache=cache, nfe=nfe, live=live)

    return slice_fn
