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

from typing import NamedTuple, Optional

import torch

from repro_torch.config.base import DecodeConfig, ModelConfig
from repro_torch.core.calibrate import CalibrationProfile
from repro_torch.core.confidence import confidence
from repro_torch.kernels import ops as kops
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
    cache_mode = cache_mode or ("prefix" if use_cache else "none")
    attn_impl = attn_impl or dcfg.attn_impl
    step_fusion = step_fusion or dcfg.step_fusion
    cache_layout = cache_layout or dcfg.cache_layout
    weight_dtype = weight_dtype or dcfg.weight_dtype or "bf16"
    if cache_mode not in ("prefix", "dual", "none") or attn_impl not in (
            "auto", "dense", "flash", "kernel") or step_fusion not in (
            "unfused", "fused") or cache_layout not in ("dense", "paged") \
            or weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"unknown decode variant {cache_mode!r}, "
                         f"{attn_impl!r}, {step_fusion!r}, "
                         f"{cache_layout!r}, {weight_dtype!r}")
    assert cfg.supports_mdlm, f"{cfg.name}: diffusion decoding inapplicable"
    use_cache = cache_mode != "none"
    dual = cache_mode == "dual"
    fused = step_fusion == "fused"
    paged = cache_layout == "paged" and use_cache
    ps, Sp = dcfg.page_size, shared_prefix_len
    if Sp and (not paged or Sp % ps):
        raise ValueError(f"shared_prefix_len={Sp} needs the paged layout "
                         f"and a multiple of page_size={ps}")
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
