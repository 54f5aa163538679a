"""Card check for the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device and exits non-zero without one. In order it:
  1. prints the versions and the card (name, power limit) and builds the
     CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc each, in
     parallel);
  2. holds each kernel against its plain PyTorch version on the card, in
     bf16 at the main path's shapes and on edge cases (the confidence
     kernel, K2, also on ragged and unaligned rows and on equal maxima in
     different splits of its cluster, giving the same bits twice and
     allocating only its outputs), the paged block
     attention kernel (K4) bit for bit against the dense one (K1) on the
     gathered view, and the int8-head fused step (K6) against the int8
     matmul's float32 head (K5), which share one body: K6's tokens are the
     argmax of K5's logits;
  3. drives the main path: OSDT decode (Phase 1 on one row, Phase 2 on the
     batch) of LLaDA-8B at full width and depth with random weights from a
     seed, through ``OSDTSession`` with the block attention and fused step
     kernels, then the same batch through the unfused epilogue with the
     confidence kernel, counting every kernel launch; then, outside the
     counts, the fused Phase 2 once more, warm, the teacher-forced replay
     (the same fused Phase 2 driven by the plain block attention, the
     kernel run on the same inputs and cache at every forward: each
     forward's conf and argmax must follow, and the same replay under
     three emulated kernel faults must fail),
     the K3 replay (the same fused Phase 2 driven by the plain fused step,
     the fused step kernel run on the same inputs at every denoising
     forward, held to the same bars, and the same replay under three
     emulated K3 faults, which must fail them), the K2 replay (the
     unfused Phase 2 driven by the plain confidence pass, the confidence
     kernel run on the same logits at every denoising forward, held to
     the same bars, and the same replay under three emulated K2 faults,
     which must fail them) and a report, not a gate,
     of the Phase-2 NFE with the kernel and with the plain attention over
     two prompt batches; then the paged path:
     the same Phase-2 decode over a page pool through a permuted page table
     (K4 + K3), whose tokens, NFE and steps must equal the dense run's, and
     a 64-token system prefix prefilled once into allocator pages that
     every row forks, which must decode as private copies of those pages
     do and stay byte-identical; then the int8 path: the weights quantized
     on the card, the same OSDT decode through the unfused epilogue with
     the int8 matmul kernel (K5) in every projection and the head, the
     same Phase 2 on the dequantized weights through the bf16 path, and
     the same Phase 2 through the fused int8 epilogue (K6), which must
     decode as the unfused int8 run does, then, outside the counts, that
     Phase 2 once more, warm, the K6 replay (the fused int8 Phase 2 driven
     by the plain int8 fused step, K6 run on the same inputs at every
     denoising forward, held to the same bars, and the same replay under
     three emulated K6 faults, which must fail them), the int8
     teacher-forced replay (the unfused int8 Phase 2 driven by the
     plain int8 matmul, K5 run on the same inputs and cache at every
     forward and held to the block attention replay's bars, and the same
     replay under three emulated K5 faults, which must fail); then the
     flash path:
     ``ops.flash_attention`` (K7) on layer 0's q, k, v of the full forward
     over the batch; and checks a reduced model's decode (bf16 and int8
     weights, both epilogues) on the card against the same decode on the
     CPU;
  4. times each kernel, its plain version and, where one exists, one
     PyTorch call computing the same function (device time: CUDA graph
     replays between CUDA events), beside the least time the card could
     take; then checks under the profiler that one K2 call is one kernel;
  5. prints the ``kernels`` JSON line and, last, the ``ok`` line.
Any failed check raises, so the script exits non-zero and prints no
result line.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data sheet: 3.35 TB/s HBM, 989 TFLOP/s dense bf16, 67 TFLOP/s
# f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
SEED = 0

# the main path's shapes; the paged path's page size and shared prefix
BATCH, PROMPT, NEW, BLOCK = 8, 128, 128, 32
PAGE, SHARED = 16, 64


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2, repeats: int = 5):
    """Device time per call: ``iters`` back-to-back calls captured in one
    CUDA graph, replayed between CUDA events, divided by ``iters``.
    Returns the median, min and max over ``repeats`` replays. A replay
    issues no Python, so the time is the card's even where the host
    issues calls more slowly than the card runs them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        runs.append(e0.elapsed_time(e1) / iters)
    del graph
    torch.cuda.empty_cache()
    return float(np.median(runs)), min(runs), max(runs)


def bound(nbytes: float, ops: float, ops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel inputs at the main path's shapes
# ---------------------------------------------------------------------------

def block_attention_inputs(gen, dev, *, B, bs, H, Kh, D, T, fill, copies=1):
    bf = torch.bfloat16

    def r(*s):
        return torch.randn(s, generator=gen, device=dev).to(bf)

    ar = torch.arange(T, device=dev)
    return dict(
        q=r(B, bs, H, D), ck=[r(B, T, Kh, D) for _ in range(copies)],
        cv=[r(B, T, Kh, D) for _ in range(copies)], bk=r(B, bs, Kh, D),
        bv=r(B, bs, Kh, D), pos=torch.where(ar < fill, ar, -1).to(
            torch.int32))


def paged_inputs(gen, dev, *, B, bs, H, Kh, D, T, fill, ps, spare=4,
                 copies=1):
    """K4's operands: a bf16 pool with ``spare`` pages more than the rows
    map, and a random permutation of physical pages as the page table."""
    bf = torch.bfloat16

    def r(*s):
        return torch.randn(s, generator=gen, device=dev).to(bf)

    n_log = -(-T // ps)
    P = B * n_log + spare
    perm = torch.randperm(P, generator=gen, device=dev)
    ar = torch.arange(T, device=dev)
    return dict(
        q=r(B, bs, H, D), pk=[r(P, ps, Kh, D) for _ in range(copies)],
        pv=[r(P, ps, Kh, D) for _ in range(copies)], bk=r(B, bs, Kh, D),
        bv=r(B, bs, Kh, D),
        pos=torch.where(ar < fill, ar, -1).to(torch.int32),
        pt=perm[:B * n_log].reshape(B, n_log).to(torch.int32).contiguous())


def gather_view(pool, pt, T, ps):
    """The dense logical view [B, T, Kh, D] of a pool through a table
    (every page mapped)."""
    slots = torch.arange(T, device=pt.device)
    return pool[pt[:, slots // ps].long(), slots % ps].contiguous()


def bf16_close(out, want):
    """Elementwise |out - want| <= 2^-7 |want| + 1e-4: the two sum in
    another order in f32 and each rounds once to bf16, so they may differ
    by one bf16 step (2^-7 relative)."""
    err = (out.float() - want.float()).abs()
    return bool((err <= want.float().abs() * 2 ** -7 + 1e-4).all()), \
        float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_step import fused_step_kernel as k3
    from repro_torch.kernels.fused_step import fused_step_plain
    from repro_torch.kernels.head import plan as k3_plan
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ops import cached_block_attention as k1
    from repro_torch.models.layers import unembed

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}
    H, D, T = 32, 128, PROMPT + NEW
    # K1: main shape (prefix cache after two committed blocks), then edges
    k1_cases = [
        ("main", dict(B=BATCH, bs=BLOCK, H=H, Kh=H, D=D, T=T,
                      fill=PROMPT + 2 * BLOCK), PROMPT + 2 * BLOCK, {}),
        ("gqa4_ragged_T", dict(B=2, bs=BLOCK, H=8, Kh=2, D=D, T=100,
                               fill=50), 50, {}),
        ("dual_exclude", dict(B=2, bs=BLOCK, H=4, Kh=4, D=D,
                              T=T + BLOCK, fill=T), T,
         dict(exclude_start=PROMPT + BLOCK, exclude_len=BLOCK)),
        ("window", dict(B=1, bs=8, H=4, Kh=4, D=64, T=96, fill=60), 60,
         dict(window=20)),
        ("sentinel_slot", dict(B=2, bs=8, H=4, Kh=4, D=64, T=96, fill=40),
         96, {}),
        ("per_row_kv_limit_0", dict(B=3, bs=8, H=4, Kh=4, D=64, T=96,
                                    fill=64), 64,
         dict(kv_limit=torch.tensor([0, 40, 64], dtype=torch.int32,
                                    device=dev))),
    ]
    for name, shape, slot, extra in k1_cases:
        x = block_attention_inputs(gen, dev, **shape)
        kw = dict(slot=slot, block_start=shape["fill"], **extra)
        args = (x["q"], x["ck"][0], x["cv"][0], x["bk"], x["bv"], x["pos"])
        out = k1(*args[:5], kv_pos=args[5], **kw)
        torch.cuda.synchronize()
        ok, err = bf16_close(out, ref.cached_block_attention_ref(*args, **kw))
        log(f"K1 {name}: max_abs_err={err:.3e}")
        check(ok, f"K1 {name} within 2^-7 relative + 1e-4")
        if name == "main":
            errs["block_attention"] = err

    # K4: the main shape over a random permutation of physical pages, with
    # one unmapped page inside the valid extent and one retired row
    # (kv_limit 0), then K1's edge cases and a page size that divides
    # neither T nor 8
    from repro_torch.kernels.block_attention import \
        cached_block_attention_kernel, paged_block_attention_kernel, \
        row_scalars
    fill = PROMPT + 2 * BLOCK
    k4_cases = [
        ("main", dict(B=BATCH, bs=BLOCK, H=H, Kh=H, D=D, T=T, fill=fill,
                      ps=PAGE), fill, {}, True),
        ("gqa4_ragged_T", dict(B=2, bs=BLOCK, H=8, Kh=2, D=D, T=100,
                               fill=50, ps=PAGE), 50, {}, True),
        ("dual_exclude", dict(B=2, bs=BLOCK, H=4, Kh=4, D=D, T=T + BLOCK,
                              fill=T, ps=PAGE), T,
         dict(exclude_start=PROMPT + BLOCK, exclude_len=BLOCK), False),
        ("window", dict(B=1, bs=8, H=4, Kh=4, D=64, T=96, fill=60,
                        ps=PAGE), 60, dict(window=20), False),
        ("page_size_5", dict(B=3, bs=8, H=4, Kh=4, D=64, T=93, fill=61,
                             ps=5), 61, {}, True),
    ]
    for name, shape, slot, extra, hole in k4_cases:
        x = paged_inputs(gen, dev, **shape)
        pt = x["pt"].clone()
        if hole:
            pt[-1, 1] = -1
        lim = torch.full((shape["B"],), shape["fill"], dtype=torch.int32,
                         device=dev)
        if shape["B"] > 2:
            lim[0] = 0
        kw = dict(slot=slot, block_start=shape["fill"], kv_limit=lim,
                  **extra)
        args = (x["q"], x["pk"][0], x["pv"][0], x["bk"], x["bv"])
        out = kops.paged_block_attention(*args, kv_pos=x["pos"],
                                         page_table=pt, page_size=shape["ps"],
                                         **kw)
        torch.cuda.synchronize()
        ok, err = bf16_close(out, ref.paged_block_attention_ref(
            *args, x["pos"], pt, **kw))
        log(f"K4 {name}: max_abs_err={err:.3e}")
        check(ok, f"K4 {name} within 2^-7 relative + 1e-4")
        if name == "main":
            errs["paged_block_attention"] = err
            # one body: over a fully mapped table K4 is K1 on the view
            sc = row_scalars(BATCH, dev, slot=slot, block_start=fill,
                             kv_limit=lim)
            paged = paged_block_attention_kernel(*args, x["pos"], x["pt"],
                                                 sc)
            dense = cached_block_attention_kernel(
                x["q"], gather_view(x["pk"][0], x["pt"], T, PAGE),
                gather_view(x["pv"][0], x["pt"], T, PAGE), x["bk"], x["bv"],
                x["pos"], sc)
            torch.cuda.synchronize()
            check(torch.equal(paged, dense),
                  "K4 over a permuted table equals K1 on the gathered view "
                  "bit for bit")
            log("K4 main vs K1 on the gathered view: bitwise equal")

    errs["confidence"] = check_confidence(gen, dev)
    R, V = BATCH * BLOCK, 126464

    # K3: bf16 x and head, products exact in f32; the f32 sums differ by
    # at most ~M * 2^-24 * sum|x w| per logit, so tokens must be equal
    # wherever the plain top-2 gap exceeds twice that, and `above` wherever
    # conf is further than 1e-3 relative from tau. The main path runs K3
    # untied at R = BATCH * BLOCK (Phase 2) and BLOCK (Phase 1) rows; K3's
    # plan gives each row count its own block, and the cases below must
    # reach every block those two steps take.
    M = 4096
    k3_cases = [
        ("main_untied", R, M, V, False, 0),
        ("phase1", BLOCK, M, V, False, 0),
        ("tied_ragged_V", 40, 512, 1000, True, 0),
        ("quota", 4 * BLOCK, 512, 3001, False, 4),
    ]
    k3_blocks = set()
    for name, R3, M3, V3, tied, quota in k3_cases:
        x = torch.randn((R3, M3), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((V3, M3) if tied else (M3, V3), generator=gen,
                         device=dev) * M3 ** -0.5).to(torch.bfloat16)
        k3_blocks.add(k3_plan(R3, V3, tied, M3 % 8 == 0 and
                              x.data_ptr() % 16 == 0 and
                              w.data_ptr() % 16 == 0))
        logits = unembed(w, x, transpose=tied)
        c0, _ = ref.confidence_ref(logits)
        tau = c0 * torch.where(torch.rand(R3, generator=gen, device=dev)
                               < 0.5, 0.8, 1.25)
        masked = torch.rand(R3, generator=gen, device=dev) < 0.8
        group = BLOCK if quota else 0
        conf, tok, above = k3(x, w, tau, masked, tied=tied, quota=quota,
                              group=group)
        again = k3(x, w, tau, masked, tied=tied, quota=quota, group=group)
        rc, rt, ra = fused_step_plain(x, w, tau, masked, tied=tied,
                                      quota=quota, group=group)
        sabs = unembed(w.abs(), x.abs(), transpose=tied)
        gap_bound = 2 * M3 * 2.0 ** -24 * sabs.amax(dim=-1)
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > gap_bound
        del sabs, logits
        torch.cuda.synchronize()
        rel = float(((conf - rc).abs() / rc).max())
        mism = int(((tok != rt) & clear).sum())
        far = ((rc - tau).abs() > 1e-3 * rc) if not quota else \
            torch.ones_like(masked)
        amism = int(((above != ra) & far).sum())
        same = all(torch.equal(a, b) for a, b in zip((conf, tok, above),
                                                      again))
        log(f"K3 {name}: conf_rel_err={rel:.3e} token_mismatches={mism} "
            f"(rows with a clear top-2 gap: {int(clear.sum())}/{R3}) "
            f"above_mismatches={amism} same_bits_twice={same}")
        check(rel <= 1e-3 and mism == 0 and amism == 0, f"K3 {name}")
        check(same, f"K3 {name} gives the same bits twice")
        if name == "main_untied":
            errs["fused_step"] = float((conf - rc).abs().max())
    main_blocks = {k3_plan(rows, V, False, True) for rows in (R, BLOCK)}
    log(f"K3 blocks checked: {sorted(k3_blocks)}; the main path's: "
        f"{sorted(main_blocks)}")
    check(main_blocks <= k3_blocks, "the K3 check reaches every block the "
          "main path's steps take")

    errs["quantized_matmul"] = check_quantized_matmul(gen, dev)
    errs["quantized_fused_step"] = check_quantized_fused_step(gen, dev)
    check_shared_head_body(gen, dev)
    errs["flash_attention"] = check_flash_attention(gen, dev)
    return errs


def k2_cases(gen, dev):
    """K2's check cases, (name, logits): the main path's two shapes
    ([256, 126464] of the unfused Phase 2, [32, 126464] of Phase 1), one
    row, vocabularies that are not a whole number of 16-byte vectors (each
    row then starts at another offset), a base off the 16-byte grid,
    integer logits full of ties, and equal maxima planted in different
    splits of the launch plan (a 16-byte aligned and an unaligned base),
    where the first column must win."""
    from repro_torch.kernels.confidence import THREADS as K2_THREADS
    from repro_torch.kernels.confidence import plan as k2_plan

    R, V = BATCH * BLOCK, 126464

    def randn(rows, cols, offset=0):
        buf = torch.randn((rows * cols + offset,), generator=gen,
                          device=dev) * 3
        return buf[offset:].view(rows, cols)

    def ties(rows, cols, offset):
        # integer logits (0..3) with a 9 at a first column in split
        # r % (C - 1) of row r, again in a later thread or lane of the
        # vector, in the same thread's next load, and twice in later
        # splits: the first column must win
        x = randn(rows, cols, offset)
        x.copy_(torch.randint(0, 4, (rows, cols), generator=gen,
                              device=dev).float())
        C, split = k2_plan(rows, cols)
        first = []
        for r in range(rows):
            c0 = (r % max(C - 1, 1)) * split + (37 * r) % (split // 2)
            x[r, [min(cols - 1, c) for c in (
                c0, c0 + 4 * r + 1, c0 + 4 * K2_THREADS, c0 + split + 3 * r,
                c0 + 2 * split + 3 * r)]] = 9.0
            first.append(c0)
        return x, torch.tensor(first, dtype=torch.int32, device=dev)

    return [
        ("main", randn(R, V), None),
        ("integer_ties", torch.randint(0, 4, (9, 5000), generator=gen,
                                       device=dev).float(), None),
        ("phase1_R32", randn(BLOCK, V), None),
        ("one_row", randn(1, V), None),
        ("ragged_V_5001", randn(BLOCK, 5001), None),
        ("ragged_V_513", randn(R, 513), None),
        ("unaligned_base", randn(BLOCK, V, offset=1), None),
        ("ties_across_splits", *ties(BLOCK, V, 0)),
        ("ties_across_splits_unaligned", *ties(BLOCK, 5001, 2)),
    ]


def check_confidence(gen, dev):
    """K2 against its plain version on :func:`k2_cases`: max and argmax
    involve no arithmetic, so tokens are equal everywhere (and, where
    planted, the first maximum's column); conf differs by the f32 sum
    order (1e-4 relative). Two calls give the same bits. One call
    allocates conf and tok, nothing else; an all -inf row gives token 0
    and conf inf. One call is one kernel (:func:`k2_one_launch`). Returns
    the main case's max |conf difference|."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.confidence import fused_confidence_kernel as k2
    from repro_torch.kernels.confidence import plan as k2_plan

    err = None
    for name, x, planted in k2_cases(gen, dev):
        conf, tok = k2(x)
        again = k2(x)
        rc, rt = ref.confidence_ref(x)
        torch.cuda.synchronize()
        rel = float(((conf - rc).abs() / rc).max())
        mism = int((tok != rt).sum())
        same = torch.equal(conf, again[0]) and torch.equal(tok, again[1])
        first = "" if planted is None else \
            f" planted_first_max_mismatches={int((tok != planted).sum())}"
        log(f"K2 {name} [{x.shape[0]}, {x.shape[1]}] (cluster "
            f"{k2_plan(*x.shape).cluster}, base mod 16 "
            f"{x.data_ptr() % 16}): conf_rel_err={rel:.3e} "
            f"token_mismatches={mism}{first} same_bits_twice={same}")
        check(rel <= 1e-4 and mism == 0, f"K2 {name}")
        check(planted is None or torch.equal(tok, planted),
              f"K2 {name}: the first of the planted maxima wins")
        check(same, f"K2 {name} gives the same bits twice")
        if name == "main":
            err = float((conf - rc).abs().max())
            main = x
    x = main
    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = k2(x)
    n1 = torch.cuda.memory_stats()["allocation.all.allocated"]
    log(f"K2 one call: {n1 - n0} device allocations")
    check(n1 - n0 == 2, "one K2 call allocates conf and tok, nothing else")
    del out
    y = x[:4].clone()
    y[1] = -torch.inf
    conf, tok = k2(y)
    torch.cuda.synchronize()
    check(int(tok[1]) == 0 and bool(torch.isinf(conf[1])),
          "K2 on an all -inf row: token 0, conf inf")
    k2_one_launch(x)
    del main, x, y
    torch.cuda.empty_cache()
    return err


def k2_one_launch(x):
    """One K2 call on ``x`` captured into a CUDA graph: the graph must
    hold exactly one node, a kernel (no finishing pass, no copy, no
    memset). A graph and not a profiler trace: a one-call trace came back
    empty in some runs."""
    import ctypes

    from repro_torch.kernels.confidence import fused_confidence_kernel as k2

    k2(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        k2(x)
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType")
        kinds.append(kind.value)
    del graph
    torch.cuda.synchronize()
    log(f"K2 one call captured in a CUDA graph: {len(kinds)} node(s) of "
        f"type {kinds} (0 = kernel)")
    check(kinds == [0], "one K2 call is one kernel launch")


def f32_close(out, want):
    """max |out - want| <= 1e-4 rms(want): float32 sums of K products in
    another order differ by ~sqrt(K) 2^-24 rms (~4e-6 rms at K = 4096),
    while a TF32 product (10-bit mantissa) or a weight rounded to bf16
    misses by ~1e-3 rms."""
    err = float((out - want).abs().max())
    return err <= 1e-4 * float(want.square().mean().sqrt()), err


def check_quantized_matmul(gen, dev):
    """K5 against its plain version at the main path's shapes (bf16 block
    step R = 256 and prefill R = 1024 over LLaDA-8B's projections; the
    head as the main path calls it, bf16 x with float32 out, at R = 32,
    128, 256 and 1024, and with f32 x, three terms, at R = 256), the
    transposed layout, and a ragged shape in both layouts and dtypes; a
    second launch of each bf16 block-step shape and of the head at R = 256
    must give the same bits. Returns the main case's max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantized_matmul import \
        quantized_matmul_kernel as k5
    from repro_torch.models.quantize import quantize_tensor

    M, F, V = 4096, 12288, 126464
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(f"bf16 R={R} [{K}, {N}]", R, K, N, False, bf, bf)
             for R in (BATCH * BLOCK, BATCH * PROMPT)
             for K, N in ((M, M), (M, F), (F, M))]
    cases += [
        (f"bf16 R=256 [{M}, {M}] transposed", 256, M, M, True, bf, bf),
        # the head at every row count of the int8 decode (R = 32 and 128:
        # Phase 1's step and prefill), so every block of the plan
        *((f"head R={R} [{M}, {V}] bf16 x f32 out", R, M, V, False, bf,
           f32) for R in (BLOCK, PROMPT, BATCH * BLOCK, BATCH * PROMPT)),
        ("tied head R=256 [32000, 4096] transposed bf16 x f32 out", 256, M,
         32000, True, bf, f32),
        (f"f32 head R=256 [{M}, {V}]", 256, M, V, False, f32, f32),
        ("f32 tied head R=256 [32000, 4096] transposed", 256, M, 32000,
         True, f32, f32),
    ]
    cases += [(f"{'bf16' if dt == bf else 'f32'} ragged "
               f"(13, 200, 513){' transposed' if tr else ''}", 13, 200, 513,
               tr, dt, dt) for dt in (bf, f32) for tr in (False, True)]
    cases += [(f"ragged (13, 200, 513){' transposed' if tr else ''} bf16 x "
               f"f32 out", 13, 200, 513, tr, bf, f32) for tr in (False, True)]
    main = None
    for name, R, K, N, tr, dt, od in cases:
        x = torch.randn((R, K), generator=gen, device=dev).to(dt)
        w = torch.randn((N, K) if tr else (K, N), generator=gen,
                        device=dev) * K ** -0.5
        qt = quantize_tensor(w, axis=-1 if tr else -2)
        del w
        out = k5(x, qt.q, qt.scale, transpose=tr, out_dtype=od)
        want = ref.quantized_matmul_ref(x, qt.q, qt.scale, transpose=tr,
                                        out_dtype=od)
        torch.cuda.synchronize()
        if od == bf:
            ok, err = bf16_close(out, want)
            tol = "2^-7 relative + 1e-4"
        else:
            ok, err = f32_close(out, want)
            tol = "1e-4 rms"
        log(f"K5 {name}: max_abs_err={err:.3e} (tolerance {tol})")
        check(ok and out.dtype == od and out.shape == (R, N),
              f"K5 {name} within {tol}")
        if name == f"bf16 R=256 [{M}, {F}]":
            main = err
        if R == BATCH * BLOCK and not tr and dt == bf:
            again = k5(x, qt.q, qt.scale, transpose=tr, out_dtype=od)
            check(torch.equal(out, again), f"K5 {name}: two launches give "
                  f"the same bits")
            log(f"K5 {name}: a second launch gives the same bits")
        del x, qt, out, want
    torch.cuda.empty_cache()
    return main


def check_quantized_fused_step(gen, dev):
    """K6 against its plain version: the main path's step (x [256, 4096]
    bf16 on LLaDA-8B's untied int8 head), f32 x, a tied head, ragged rows
    and widths in both layouts, and the quota rule in the decoder's groups
    of 32 rows. Tolerances as K3's: conf within 1e-3 relative; tokens
    equal wherever the plain top-2 gap exceeds twice the f32 sum-order
    bound (M 2^-24 sum|x w| per logit), ``above`` wherever conf is
    further than 1e-3 relative from tau. Returns the main case's max abs
    conf error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_step import \
        quantized_fused_step_kernel as k6
    from repro_torch.models.quantize import dequantize, quantize_tensor

    M, V = 4096, 126464
    R = BATCH * BLOCK
    cases = [
        ("main_untied_bf16", R, M, V, False, torch.bfloat16, 0),
        ("untied_f32", R, M, V, False, torch.float32, 0),
        ("tied_bf16", R, M, 32000, True, torch.bfloat16, 0),
        ("ragged_tied_f32", 37, 200, 1001, True, torch.float32, 0),
        ("ragged_untied_bf16", 37, 200, 513, False, torch.bfloat16, 0),
        ("quota_untied_bf16", R, M, V, False, torch.bfloat16, 4),
        ("quota_tied_f32", 4 * BLOCK, 512, 3001, True, torch.float32, 4),
    ]
    main = None
    for name, R6, M6, V6, tied, dt, quota in cases:
        x = torch.randn((R6, M6), generator=gen, device=dev).to(dt)
        qt = quantize_tensor(torch.randn((V6, M6) if tied else (M6, V6),
                                         generator=gen, device=dev)
                             * M6 ** -0.5, axis=-1 if tied else -2)
        w = dequantize(qt)
        logits = x.float() @ (w.t() if tied else w)
        c0, _ = ref.confidence_ref(logits)
        tau = c0 * torch.where(torch.rand(R6, generator=gen, device=dev)
                               < 0.5, 0.8, 1.25)
        masked = torch.rand(R6, generator=gen, device=dev) < 0.8
        group = BLOCK if quota else 0
        conf, tok, above = k6(x, qt.q, qt.scale, tau, masked, tied=tied,
                              quota=quota, group=group)
        if quota:
            g = R6 // group
            rc, rt, ra = ref.quantized_fused_step_ref(
                x.reshape(g, group, M6), qt.q, qt.scale,
                tau.reshape(g, group), masked.reshape(g, group), tied=tied,
                quota=quota)
            rc, rt, ra = rc.reshape(-1), rt.reshape(-1), ra.reshape(-1)
        else:
            rc, rt, ra = ref.quantized_fused_step_ref(
                x, qt.q, qt.scale, tau, masked, tied=tied)
        sabs = x.float().abs() @ (w.t() if tied else w).abs()
        gap_bound = 2 * M6 * 2.0 ** -24 * sabs.amax(dim=-1)
        del sabs
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > gap_bound
        torch.cuda.synchronize()
        rel = float(((conf - rc).abs() / rc).max())
        mism = int(((tok != rt) & clear).sum())
        far = ((rc - tau).abs() > 1e-3 * rc) if not quota else \
            torch.ones_like(masked)
        amism = int(((above != ra) & far).sum())
        log(f"K6 {name}: conf_rel_err={rel:.3e} token_mismatches={mism} "
            f"(rows with a clear top-2 gap: {int(clear.sum())}/{R6}) "
            f"above_mismatches={amism}")
        check(rel <= 1e-3 and mism == 0 and amism == 0, f"K6 {name}")
        if name == "main_untied_bf16":
            main = float((conf - rc).abs().max())
        del x, qt, w, logits
    torch.cuda.empty_cache()
    return main


def check_shared_head_body(gen, dev):
    """K6 and K5's float32 head share one body: on the main step's inputs
    (x [256, 4096] bf16 on LLaDA-8B's untied int8 head), K6's tokens must
    be the argmax of K5's head logits exactly and its conf within 1e-6
    relative of K2's on those logits (the two reduce the same logits in
    another order), and two launches of each must give the same bits."""
    from repro_torch.kernels.confidence import fused_confidence_kernel as k2
    from repro_torch.kernels.fused_step import \
        quantized_fused_step_kernel as k6
    from repro_torch.kernels.quantized_matmul import \
        quantized_matmul_kernel as k5
    from repro_torch.models.quantize import quantize_tensor

    R, M, V = BATCH * BLOCK, 4096, 126464
    x = torch.randn((R, M), generator=gen, device=dev).to(torch.bfloat16)
    qt = quantize_tensor(torch.randn((M, V), generator=gen, device=dev)
                         * M ** -0.5, axis=-2)
    logits = k5(x, qt.q, qt.scale, transpose=False, out_dtype=torch.float32)
    again = k5(x, qt.q, qt.scale, transpose=False, out_dtype=torch.float32)
    c2, _ = k2(logits)
    tau = c2 * torch.where(torch.rand(R, generator=gen, device=dev) < 0.5,
                           0.8, 1.25)
    masked = torch.rand(R, generator=gen, device=dev) < 0.8
    out = k6(x, qt.q, qt.scale, tau, masked, tied=False)
    out2 = k6(x, qt.q, qt.scale, tau, masked, tied=False)
    torch.cuda.synchronize()
    conf, tok, _ = out
    mism = int((tok != torch.argmax(logits, dim=-1).to(torch.int32)).sum())
    rel = float(((conf - c2).abs() / c2).max())
    same = torch.equal(logits, again) and all(
        torch.equal(a, b) for a, b in zip(out, out2))
    log(f"K6 vs K5's head on the main step: token mismatches against the "
        f"argmax of K5's logits={mism}/{R}, conf_rel_err against K2 on "
        f"them={rel:.3e}, same_bits_twice={same}")
    check(mism == 0 and rel <= 1e-6, "K6's tokens are the argmax of K5's "
          "head logits and its conf within 1e-6 relative of K2 on them")
    check(same, "K5's head and K6 give the same bits twice")
    del x, qt, logits, again
    torch.cuda.empty_cache()


def bf16_attention_close(out, want, pv):
    """Elementwise |out - want| <= 2^-7 (|want| + P|V|): both round the
    output to bf16 once (at most one step, 2^-7 relative, apart), and the
    kernel rounds each probability to bf16 before P V, which moves the
    output by at most 2^-8 P|V|."""
    err = (out.float() - want.float()).abs()
    return bool((err <= 2 ** -7 * (want.float().abs() + pv)).all()), \
        float(err.max())


def attention_check(q, k, v, out, *, causal, q_offset):
    """``out`` (K7's) against the plain version: float32 within 2e-5 (the
    reference's own kernel sweep), bf16 by ``bf16_attention_close``.
    Returns (ok, max abs error)."""
    from repro_torch.kernels import ref

    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   q_offset=q_offset)
    if q.dtype == torch.float32:
        err = float((out - want).abs().max())
        return err <= 2e-5, err
    pv = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                 causal=causal, q_offset=q_offset)
    return bf16_attention_close(out, want, pv)


def check_flash_attention(gen, dev):
    """K7 against its plain version at LLaDA-8B's full-forward attention
    [8, 32, 256, 128] bf16 (causal and not), then f32 and bf16 edge
    cases: S < T with q_offset = T - S, ragged S and T, one query, rows
    that see no key. Returns the main case's max abs error."""
    from repro_torch.kernels.flash_attention import \
        flash_attention_kernel as k7

    bf, f32 = torch.bfloat16, torch.float32
    S = PROMPT + NEW
    cases = [
        ("main_full", BATCH, 32, S, S, 128, bf, False, 0),
        ("main_causal", BATCH, 32, S, S, 128, bf, True, 0),
        ("suffix_causal", 2, 4, 48, 96, 64, bf, True, 48),
        ("suffix_causal_f32", 2, 4, 48, 96, 64, f32, True, 48),
        ("ragged", 1, 2, 33, 65, 16, bf, False, 0),
        ("ragged_f32", 1, 2, 33, 65, 32, f32, True, 32),
        ("one_query", 2, 8, 1, 77, 128, bf, True, 76),
        ("one_query_f32", 2, 8, 1, 77, 128, f32, False, 0),
        ("no_key_rows", 1, 2, 70, 40, 64, bf, True, -30),
        ("no_key_rows_f32", 1, 2, 70, 40, 64, f32, True, -30),
    ]
    main = None
    for name, B, H, S7, T7, D, dt, causal, off in cases:
        q, k, v = (torch.randn((B, H, n, D), generator=gen,
                               device=dev).to(dt) for n in (S7, T7, T7))
        out = k7(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        ok, err = attention_check(q, k, v, out, causal=causal, q_offset=off)
        log(f"K7 {name} [{B}, {H}, {S7}/{T7}, {D}] "
            f"{'bf16' if dt == bf else 'f32'} causal={causal} "
            f"q_offset={off}: max_abs_err={err:.3e}")
        check(ok and out.shape == q.shape and out.dtype == dt,
              f"K7 {name} within its tolerance")
        if name == "main_full":
            main = err
    return main


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def reset_counts(kernels):
    for k in kernels.values():
        k.launches = 0
        if hasattr(k, "head_launches"):  # K5's float32 outputs
            k.head_launches = 0


def read_counts(kernels):
    return {n: k.launches for n, k in kernels.items()}


def reduced_reference_check(dev):
    """A reduced LLaDA-8B (f32) decoded through OSDT on the card (kernel
    paths: fused and unfused, on raw and on int8 weights) and on the CPU
    (plain paths): the tokens must agree (bf16 weights: >= 0.95 of them,
    a float32 near-tie may flip; int8: all) and the calibrated tables to
    1e-4."""
    from repro_torch.config.base import DecodeConfig
    from repro_torch.config.registry import get_config
    from repro_torch.core.decoder import make_generate_fn
    from repro_torch.core.osdt import OSDTSession
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import model as M
    from repro_torch.models.quantize import (quantize_decode_params,
                                             tree_leaves)

    cfg = dataclasses.replace(
        get_config("llada-8b").reduced(num_layers=2, max_d_model=128,
                                       vocab_size=tok.VOCAB),
        mask_token_id=tok.MASK_ID)
    dcfg = DecodeConfig(max_new_tokens=32, block_size=8, policy="osdt",
                        cap=0.75, slack=0.2, step_fusion="fused")
    cpu = M.init_params(cfg, seed=SEED, device="cpu")
    gpu = _to(cpu, dev)
    # int8: quantized on each device; the two must be bitwise equal
    q_cpu = quantize_decode_params(cpu, cfg)
    q_gpu = quantize_decode_params(gpu, cfg)
    check(all(torch.equal(a.cpu(), b) for a, b in
              zip(tree_leaves(q_gpu), tree_leaves(q_cpu))),
          "int8 quantization on the card is bitwise the CPU's")
    prompts = np.random.default_rng(SEED).integers(0, 256, (4, 16))
    rates = []
    for fusion, wd in (("fused", "bf16"), ("unfused", "bf16"),
                       ("unfused", "int8"), ("fused", "int8")):
        res = {}
        dc = dataclasses.replace(dcfg, step_fusion=fusion, weight_dtype=wd)
        for name, params in (("cpu", q_cpu if wd == "int8" else cpu),
                             ("gpu", q_gpu if wd == "int8" else gpu)):
            gen = make_generate_fn(cfg, dc, attn_impl="kernel",
                                   use_kernel=True)
            s = OSDTSession(params, cfg, dc, tok.MASK_ID, gen_fn=gen)
            r1 = s.generate(prompts[:1])
            r2 = s.generate(prompts)
            res[name] = (s.table, r1.tokens.cpu(), r2.tokens.cpu())
        tab_err = float(np.abs(res["cpu"][0] - res["gpu"][0]).max())
        match = float(torch.cat([
            (res["cpu"][i] == res["gpu"][i]).flatten() for i in (1, 2)])
            .float().mean())
        label = f"{'int8 ' if wd == 'int8' else ''}{fusion}"
        log(f"reduced model, {label}: card-vs-CPU token match={match:.4f} "
            f"table max_abs_err={tab_err:.2e}")
        # int8: tokens must be equal (K5's and K6's float32 products
        # against the plain float32 product); bf16 keeps its 0.95 floor
        check((match == 1.0 if wd == "int8" else match >= 0.95)
              and tab_err <= 1e-4, f"reduced {label} decode agrees with "
              f"the CPU")
        rates.append(match)
    return rates


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _map_quantized(tree, fn):
    """``tree`` with every QuantizedTensor replaced by ``fn(name, qt)``."""
    from repro_torch.models.quantize import QuantizedTensor

    return {k: _map_quantized(v, fn) if isinstance(v, dict) else
            fn(k, v) if isinstance(v, QuantizedTensor) else v
            for k, v in tree.items()}


def main_path(dev, kernels):
    from repro_torch.config.base import DecodeConfig
    from repro_torch.config.registry import get_config
    from repro_torch.core.decoder import make_generate_fn
    from repro_torch.core.osdt import OSDTSession
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import model as M
    from repro_torch.models.quantize import tree_leaves

    cfg = dataclasses.replace(get_config("llada-8b"),
                              mask_token_id=tok.MASK_ID)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"LLaDA-8B full width: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.resolved_head_dim}, d_ff={cfg.d_ff}, "
        f"vocab={cfg.vocab_size}, {nbytes / 1e9:.2f} GB bf16 weights, "
        f"init {time.perf_counter() - t0:.1f}s")
    dcfg = DecodeConfig(max_new_tokens=NEW, block_size=BLOCK, policy="osdt",
                        mode="block", metric="q1", cap=0.75, slack=0.2,
                        step_fusion="fused")
    # prompts: byte tokens (never the mask id), from the seed
    prompts = np.random.default_rng(SEED).integers(0, 256, (BATCH, PROMPT))
    torch.cuda.reset_peak_memory_stats()
    out = {}

    reset_counts(kernels)
    session = OSDTSession(params, cfg, dcfg, tok.MASK_ID, attn_impl="kernel")
    for phase, rows in (("phase1_calibrate", prompts[:1]),
                        ("phase2_osdt_fused", prompts)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = session.generate(rows)
        torch.cuda.synchronize()
        out[phase] = (res, time.perf_counter() - t0)
    fused_counts = read_counts(kernels)
    unfused = make_generate_fn(cfg, dcfg, attn_impl="kernel",
                               step_fusion="unfused", use_kernel=True)
    s2 = OSDTSession(params, cfg, dcfg, tok.MASK_ID, store=session.store,
                     gen_fn=unfused)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = s2.generate(prompts)
    torch.cuda.synchronize()
    out["phase2_osdt_unfused"] = (res, time.perf_counter() - t0)
    counts = read_counts(kernels)

    unfused_counts = {n: counts[n] - fused_counts[n] for n in counts}
    log(f"launches, fused session (both phases): {fused_counts}")
    log(f"launches, unfused run: {unfused_counts}")
    check(fused_counts["block_attention"] > 0
          and fused_counts["fused_step"] > 0,
          "the fused session launched K1 and K3")
    check(unfused_counts["block_attention"] > 0
          and unfused_counts["confidence"] > 0,
          "the unfused run launched K1 and K2")
    check(all(counts[n] > 0 for n in ("block_attention", "confidence",
                                      "fused_step")),
          "every kernel of the dense bf16 path launched")
    check(all(counts[n] == 0 for n in ("quantized_matmul",
                                       "quantized_fused_step",
                                       "flash_attention")),
          "the bf16 path launched no K5, K6 or K7")

    table = session.table
    log(f"calibrated OSDT table (block x step 0): "
        f"{[float(f'{v:.3e}') for v in table[:, 0]]}")
    for phase, (res, secs) in out.items():
        toks = res.tokens
        rows = toks.shape[0]
        check(tuple(toks.shape) == (rows, NEW), f"{phase} token shape")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"{phase} tokens in the vocabulary")
        check(not bool((toks == tok.MASK_ID).any()),
              f"{phase} left no position masked")
        check(bool(torch.isfinite(res.conf).all()), f"{phase} finite conf")
        steps = res.steps_per_block.tolist()
        log(f"{phase}: rows={rows} NFE={res.nfe} steps_per_block={steps} "
            f"thr_steps={int(res.thr_steps.sum())} wall={secs:.3f}s "
            f"tokens/s={rows * NEW / secs:.1f} "
            f"ms/forward={secs / res.nfe * 1e3:.2f}")
    p1 = out["phase1_calibrate"][0]
    check(int(p1.thr_steps.sum()) == 0,
          "Phase 1 (static 0.9 on random weights) ran the fallback path")
    check(int(out["phase2_osdt_fused"][0].thr_steps.sum()) > 0,
          "Phase 2 ran the threshold path")
    match = float((out["phase2_osdt_fused"][0].tokens
                   == out["phase2_osdt_unfused"][0].tokens).float().mean())
    log(f"fused vs unfused Phase-2 token match rate: {match:.4f}")
    warm_repeat(session, prompts, "phase2_osdt_fused", *out[
        "phase2_osdt_fused"])
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    # compare-only phases: their launches are outside every path's count
    replay_path(params, cfg, dcfg, session.store, prompts)
    k3_replay_path(params, cfg, dcfg, session.store, prompts)
    k2_replay_path(params, cfg, dcfg, session.store, prompts)
    nfe_report(params, cfg, dcfg, session.store)
    paged_counts = paged_path(dev, kernels, params, cfg, dcfg, table,
                              prompts, out["phase2_osdt_fused"][0])
    int8_counts, int8_sessions = int8_path(dev, kernels, params, cfg, dcfg,
                                           prompts)
    flash_counts = flash_path(dev, kernels, params, cfg, prompts)
    # last: the profiler may leave the host slower for what follows it
    profile_phase2(session, prompts, "bf16 fused")
    for label, s in int8_sessions.items():
        profile_phase2(s, prompts, label)
    del params, session, int8_sessions
    torch.cuda.empty_cache()
    return {n: counts[n] + paged_counts[n] + int8_counts[n] + flash_counts[n]
            for n in counts}


def warm_repeat(session, prompts, label, first, first_secs):
    """The same Phase 2 once more, warm and outside the launch counts: its
    ms/forward beside the first run's (a first call's cost shows as the
    difference), and whether it decodes the same tokens."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = session.generate(prompts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"{label} warm repeat (outside the counts): NFE={res.nfe} "
        f"wall={secs:.3f}s ms/forward={secs / res.nfe * 1e3:.2f}; first "
        f"run: NFE={first.nfe} wall={first_secs:.3f}s "
        f"ms/forward={first_secs / first.nfe * 1e3:.2f}; same tokens: "
        f"{torch.equal(res.tokens, first.tokens)}")


def int8_path(dev, kernels, params, cfg, dcfg, prompts):
    """The int8 weight-streaming path: the params quantized on the card
    (``quantize_decode_params``), then OSDT (Phase 1 on one row, Phase 2
    on the batch) through the unfused epilogue, where every projection
    and the head run K5 (7 x 32 + 1 = 225 launches a forward at
    LLaDA-8B's depth) and the
    confidence pass K2. Then the same Phase 2 on the dequantized weights
    through the raw bf16 path (projections bf16, the head float32, as
    K5 rounds them): the same function up to the order of the sums, so
    its token match and NFE are printed beside the int8 run's. Last, the
    same Phase 2 on the int8 weights through the fused epilogue: K6 once
    a denoising forward in place of the K5 head and K2, which must decode
    as the unfused int8 run does (NFE equal, token match >= 0.99).
    Returns the launch counts of both int8 runs and their sessions by
    label."""
    from repro_torch.core.decoder import make_generate_fn
    from repro_torch.core.osdt import OSDTSession
    from repro_torch.data import tokenizer as tok
    from repro_torch.models.quantize import (decode_weight_bytes, dequantize,
                                             quantize_decode_params)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_decode_params(params, cfg)
    torch.cuda.synchronize()
    log(f"int8 quantization on the card: "
        f"{time.perf_counter() - t0:.2f}s; decode_weight_bytes bf16 "
        f"{decode_weight_bytes(params, cfg)} B, int8 "
        f"{decode_weight_bytes(qparams, cfg)} B")
    qdcfg = dataclasses.replace(dcfg, step_fusion="unfused",
                                weight_dtype="int8")
    gen = make_generate_fn(cfg, qdcfg, attn_impl="kernel", use_kernel=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    session = OSDTSession(qparams, cfg, qdcfg, tok.MASK_ID, gen_fn=gen)
    out = {}
    for phase, rows in (("int8_phase1_calibrate", prompts[:1]),
                        ("int8_phase2_osdt_unfused", prompts)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = session.generate(rows)
        torch.cuda.synchronize()
        out[phase] = (res, time.perf_counter() - t0)
    counts = read_counts(kernels)
    heads = kernels["quantized_matmul"].head_launches
    nfe = sum(res.nfe for res, _ in out.values())
    per_forward = 7 * cfg.num_layers + 1
    log(f"launches, int8 session (both phases, {nfe} forwards): {counts}")
    check(counts["quantized_matmul"] == per_forward * nfe,
          f"K5 launched {per_forward} times a forward (7 projections x "
          f"{cfg.num_layers} layers + the head)")
    check(heads == nfe, "K5's float32 head launched once a forward")
    check(counts["confidence"] > 0 and counts["block_attention"] > 0,
          "the int8 session launched K2 and K1")
    check(all(counts[n] == 0 for n in ("fused_step", "paged_block_attention",
                                       "quantized_fused_step",
                                       "flash_attention")),
          "the int8 session ran no K3, K4, K6 or K7")
    for phase, (res, secs) in out.items():
        toks = res.tokens
        rows = toks.shape[0]
        check(tuple(toks.shape) == (rows, NEW)
              and not bool((toks == tok.MASK_ID).any())
              and bool(torch.isfinite(res.conf).all()), f"{phase} output")
        log(f"{phase}: rows={rows} NFE={res.nfe} "
            f"steps_per_block={res.steps_per_block.tolist()} "
            f"thr_steps={int(res.thr_steps.sum())} wall={secs:.3f}s "
            f"tokens/s={rows * NEW / secs:.1f} "
            f"ms/forward={secs / res.nfe * 1e3:.2f}")
    check(int(out["int8_phase1_calibrate"][0].thr_steps.sum()) == 0,
          "int8 Phase 1 (static 0.9 on random weights) ran the fallback")
    check(int(out["int8_phase2_osdt_unfused"][0].thr_steps.sum()) > 0,
          "int8 Phase 2 ran the threshold path")
    log(f"calibrated int8 OSDT table (block x step 0): "
        f"{[float(f'{v:.3e}') for v in session.table[:, 0]]}")
    log(f"peak device memory through the int8 session: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the same Phase 2 on the dequantized weights, through the bf16 path
    dq = _map_quantized(qparams, lambda name, qt: dequantize(qt) if
                        name == "head" else dequantize(qt).to(torch.bfloat16))
    gen_dq = make_generate_fn(cfg, dataclasses.replace(
        dcfg, step_fusion="unfused"), attn_impl="kernel", use_kernel=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_dq = gen_dq(dq, prompts, session.table, tok.MASK_ID)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    res_q = out["int8_phase2_osdt_unfused"][0]
    match = float((res_dq.tokens == res_q.tokens).float().mean())
    log(f"dequantized-weights Phase 2 (bf16 path): NFE={res_dq.nfe} "
        f"steps_per_block={res_dq.steps_per_block.tolist()} "
        f"ms/forward={secs / res_dq.nfe * 1e3:.2f}; against the int8 "
        f"run: token match={match:.4f}, NFE {res_dq.nfe} vs {res_q.nfe}")
    # the same function up to the order of the float32 sums: a K5 fault
    # the per-shape checks miss (a layer's sliced view) shows here
    check(res_dq.nfe == res_q.nfe and match >= 0.99,
          "the int8 Phase 2 decodes as the dequantized weights do")
    del dq, res_dq
    torch.cuda.empty_cache()

    # the same Phase 2 through the fused int8 epilogue (K6), with the
    # unfused session's calibrated table
    fdcfg = dataclasses.replace(qdcfg, step_fusion="fused")
    fused = OSDTSession(qparams, cfg, fdcfg, tok.MASK_ID, store=session.store,
                        gen_fn=make_generate_fn(cfg, fdcfg,
                                                attn_impl="kernel"))
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_f = fused.generate(prompts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fcounts = read_counts(kernels)
    fheads = kernels["quantized_matmul"].head_launches
    toks = res_f.tokens
    check(tuple(toks.shape) == (len(prompts), NEW)
          and not bool((toks == tok.MASK_ID).any())
          and bool(torch.isfinite(res_f.conf).all()),
          "int8_phase2_osdt_fused output")
    # K6 replaces the head product in every denoising forward; the
    # prefill and the commit forwards still unembed through the K5 head
    denoise = int(res_f.steps_per_block.sum())
    match = float((toks == res_q.tokens).float().mean())
    log(f"int8_phase2_osdt_fused: rows={len(prompts)} NFE={res_f.nfe} "
        f"steps_per_block={res_f.steps_per_block.tolist()} "
        f"thr_steps={int(res_f.thr_steps.sum())} wall={secs:.3f}s "
        f"tokens/s={len(prompts) * NEW / secs:.1f} "
        f"ms/forward={secs / res_f.nfe * 1e3:.2f}; against the unfused int8 "
        f"run: token match={match:.4f}, NFE {res_f.nfe} vs {res_q.nfe}")
    log(f"launches, fused int8 Phase 2 ({res_f.nfe} forwards, {denoise} "
        f"denoising): {fcounts}")
    check(fcounts["quantized_fused_step"] == denoise,
          "K6 launched once a denoising forward")
    check(fcounts["quantized_matmul"]
          == 7 * cfg.num_layers * res_f.nfe + (res_f.nfe - denoise),
          f"K5 launched 7 x {cfg.num_layers} times a forward, plus the head "
          f"of each prefill and commit forward")
    check(all(fcounts[n] == 0 for n in ("confidence", "fused_step",
                                        "paged_block_attention",
                                        "flash_attention")),
          "the fused int8 run ran no K2, K3, K4 or K7")
    check(res_f.nfe == res_q.nfe and match >= 0.99,
          "the fused int8 Phase 2 decodes as the unfused one does")
    check(fheads == res_f.nfe - denoise, "K5's float32 head launched once "
          "a prefill and commit forward of the fused int8 Phase 2")
    log(f"K5 float32 head launches (main run): {heads + fheads} (int8 "
        f"session {heads}, one a forward; fused int8 Phase 2 {fheads}, one a "
        f"prefill and commit forward)")
    total = {n: counts[n] + fcounts[n] for n in counts}
    # compare-only: their launches are outside every path's count
    warm_repeat(fused, prompts, "int8_phase2_osdt_fused", res_f, secs)
    k6_replay_path(qparams, cfg, fdcfg, session.store, prompts)
    int8_replay_path(qparams, cfg, qdcfg, session.store, prompts)
    return total, {"int8 unfused": session, "int8 fused": fused}


def flash_path(dev, kernels, params, cfg, prompts):
    """``ops.flash_attention`` (K7) at the attention of the full forward
    that the ``cache_mode="none"`` decode runs: layer 0's rotated q, k, v
    of the main path's batch (the prompt and 128 masked positions, 256
    tokens), bidirectional as the model attends and causal, each held to
    the plain version. Returns the launch counts."""
    from repro_torch.data import tokenizer as tok
    from repro_torch.kernels import ops as kops
    from repro_torch.models import model as M
    from repro_torch.models.layers import embed, rms_norm

    tokens = torch.cat([torch.as_tensor(prompts, device=dev),
                        torch.full((len(prompts), NEW), tok.MASK_ID,
                                   device=dev)], 1)
    pos = torch.arange(tokens.shape[1], dtype=torch.int32, device=dev)
    lp = M.layer_params(params["layers"], 0)
    h = rms_norm(embed(params["embed"], tokens), lp["ln1"], cfg.norm_eps)
    q, k, v = (t.transpose(1, 2).contiguous() for t in M._qkv(lp, cfg, h,
                                                              pos))
    reset_counts(kernels)
    outs = {causal: kops.flash_attention(q, k, v, causal=causal)
            for causal in (False, True)}
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    for causal, out in outs.items():
        ok, err = attention_check(q, k, v, out, causal=causal, q_offset=0)
        log(f"flash path: ops.flash_attention causal={causal} on layer 0's "
            f"q, k, v {list(q.shape)} bf16: max_abs_err={err:.3e}")
        check(ok and out.shape == q.shape
              and bool(torch.isfinite(out.float()).all()),
              f"ops.flash_attention causal={causal} agrees with the plain "
              f"version")
    log(f"launches, flash path: {counts}")
    check(counts["flash_attention"] == 2
          and sum(counts.values()) == 2, "the flash path launched K7 twice "
          "and nothing else")
    return counts


def paged_path(dev, kernels, params, cfg, dcfg, table, prompts, dense):
    """The paged layout's path, fused (K4 + K3), with the calibrated
    table: (a) the Phase-2 batch over a permuted page table must give the
    dense run's tokens, NFE and steps exactly (K4 shares K1's body); (b) a
    64-token system prefix prefilled once into allocator pages, forked
    into every row and decoded with ``shared_prefix_len``, must give the
    tokens of the same decode over private copies of those pages, and its
    pages must come back byte-identical. Returns the launch counts."""
    from repro_torch.core.decoder import make_generate_fn
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import cache as cache_lib
    from repro_torch.models import model as M

    pdcfg = dataclasses.replace(dcfg, cache_layout="paged", page_size=PAGE)
    max_len = PROMPT + NEW
    n_log = pdcfg.pages_per_seq(max_len)
    n_shared = SHARED // PAGE
    n_priv = n_log - n_shared
    # (a) maps B * n_log pages; (b) the shared pages, B private tails and
    # B private copies of the shared pages
    num_pages = BATCH * n_log + n_shared
    pool = cache_lib.init_paged_kv_cache(
        cfg.num_layers, BATCH, max_len, cfg.num_kv_heads,
        cfg.resolved_head_dim, torch.bfloat16, page_size=PAGE,
        num_pages=num_pages, device=dev)
    kp, vp = pool["kp"], pool["vp"]
    log(f"page pool: {num_pages} pages x {PAGE} slots, "
        f"{2 * kp.numel() * kp.element_size() / 1e9:.2f} GB bf16")
    alloc = cache_lib.PageAllocator(num_pages)
    rng = np.random.default_rng(SEED + 2)

    def table_of(rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    def timed(gen, rows, pt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gen(params, rows, table, tok.MASK_ID, None, None, kp, vp, pt)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def report(phase, res, secs):
        toks = res.tokens
        check(tuple(toks.shape) == (BATCH, NEW)
              and not bool((toks == tok.MASK_ID).any())
              and bool(torch.isfinite(res.conf).all()), f"{phase} output")
        log(f"{phase}: rows={BATCH} NFE={res.nfe} "
            f"steps_per_block={res.steps_per_block.tolist()} "
            f"wall={secs:.3f}s tokens/s={BATCH * NEW / secs:.1f} "
            f"ms/forward={secs / res.nfe * 1e3:.2f}")

    reset_counts(kernels)
    # (a) Sp = 0 over a random permutation of the allocator's pages
    pages = alloc.alloc(BATCH * n_log)
    pt = table_of(rng.permutation(pages).reshape(BATCH, n_log))
    gen = make_generate_fn(cfg, pdcfg, attn_impl="kernel")
    res, secs = timed(gen, prompts, pt)
    report("paged_a_phase2_fused", res, secs)
    same = (torch.equal(res.tokens, dense.tokens) and res.nfe == dense.nfe
            and torch.equal(res.steps_per_block, dense.steps_per_block))
    log(f"paged (a) vs dense Phase 2: token match="
        f"{float((res.tokens == dense.tokens).float().mean()):.4f} "
        f"NFE {res.nfe} vs {dense.nfe}")
    check(same, "paged Phase 2 equals the dense run in tokens, NFE, steps")
    alloc.free(pages)

    # (b) a shared system prefix, prefilled once into allocator pages
    shared = alloc.alloc(n_shared)
    system = rng.integers(0, 256, (1, SHARED))
    spt = [shared + [-1] * n_priv]
    cache = {"attn": {"kp": kp, "vp": vp, "pt": table_of(spt),
                      "pos": torch.full((max_len,), -1, dtype=torch.int32,
                                        device=dev), "length": 0}}
    M.prefill(params, cfg, torch.as_tensor(system, device=dev),
              max_len=max_len, mode="full", cache=cache, page_size=PAGE)
    sk, sv = kp[:, shared].clone(), vp[:, shared].clone()
    forks = [alloc.fork(shared, n_priv) for _ in range(BATCH)]
    rows = np.concatenate([np.repeat(system, BATCH, 0),
                           prompts[:, SHARED:]], 1)
    gen_s = make_generate_fn(cfg, pdcfg, attn_impl="kernel",
                             shared_prefix_len=SHARED)
    res_s, secs = timed(gen_s, rows, table_of([a + b for a, b in forks]))
    report("paged_b_shared_prefix", res_s, secs)
    check(torch.equal(kp[:, shared], sk) and torch.equal(vp[:, shared], sv),
          "the shared pages are byte-identical after the decode")
    copies = [alloc.alloc(n_shared) for _ in range(BATCH)]
    for c in copies:
        kp[:, c] = sk
        vp[:, c] = sv
    res_p, secs = timed(gen_s, rows, table_of(
        [c + priv for c, (_, priv) in zip(copies, forks)]))
    report("paged_b_private_copies", res_p, secs)
    counts = read_counts(kernels)
    check(torch.equal(res_s.tokens, res_p.tokens) and res_s.nfe == res_p.nfe
          and torch.equal(res_s.steps_per_block, res_p.steps_per_block),
          "shared pages decode as private copies of them do")
    log(f"shared prefix vs private copies: tokens equal, NFE {res_s.nfe}; "
        f"refcount of a shared page with {BATCH} forks: "
        f"{alloc.refcount(shared[0])}")
    for (sh, priv), c in zip(forks, copies):
        alloc.free(sh)
        alloc.free(priv)
        alloc.free(c)
    check(alloc.in_use == n_shared, "after free only the shared pages stay")
    alloc.free(shared)
    check(alloc.in_use == 0, "the pool drains")
    log(f"launches, paged path: {counts}")
    check(counts["paged_block_attention"] > 0 and counts["fused_step"] > 0
          and counts["block_attention"] == 0,
          "the paged path launched K4 and K3, and not K1")
    del pool, kp, vp, cache
    return counts


# ---------------------------------------------------------------------------
# teacher-forced replay: the block attention kernel against the plain
# attention at every forward of one decode that the plain one drives
# ---------------------------------------------------------------------------

# The replay's bars, held by the kernel on every compared forward: its max
# |conf difference| within REPLAY_CONF_SHARE of the forward's max conf,
# and its argmax agreement, pooled over every compared position, at
# least REPLAY_ARGMAX_AGREE. The plain path that drives the decode
# (``attn_impl="dense"``) rounds its normalised probabilities to bf16
# before P V, while the kernel, like its plain version, keeps P nearly in
# f32; the plain chunked attention (``attn_impl="flash"``, f32 P, another
# sum order) runs beside it as a reference that is printed, not gated,
# and shows how far a path without the kernel moves on the same forwards.
REPLAY_CONF_SHARE, REPLAY_ARGMAX_AGREE = 0.05, 0.95
REPLAY_CHECKS = ("kernel", "flash")  # gated, printed reference


def _with_scalar(scalars, row, value):
    """``scalars`` [5, B] with one geometry row replaced."""
    s = scalars.clone()
    s[row] = value
    return s


# Kernel faults the replay must reject, each emulated around K1's wrapper
# (``kernels.ops.cached_block_attention_kernel``) as a kernel with that
# fault would compute: a softmax scale 10% high, the fresh block hidden
# as if its slot were the sentinel, and the last live cache slot dropped
# (``kv_limit`` one short).
REPLAY_FAULTS = {
    "scale_10pct_high": lambda f: (
        lambda q, *a, **k: f(q * 1.1, *a, **k)),
    "fresh_block_hidden": lambda f: (
        lambda q, ck, cv, bk, bv, pos, s, **k: f(
            q, ck, cv, bk, bv, pos, _with_scalar(s, 0, ck.shape[1]), **k)),
    "last_slot_dropped": lambda f: (
        lambda q, ck, cv, bk, bv, pos, s, **k: f(
            q, ck, cv, bk, bv, pos, _with_scalar(s, 4, s[4] - 1), **k)),
}


def replay_compare(out, alt, masked, head=None, tied=False):
    """(conf, argmax) of two outputs of one forward on the same inputs:
    ``out`` [B, bs, V] logits, or final hidden [B, bs, d] when ``head``
    (the unembed matrix) is given, as the fused epilogue takes them. Read
    over the masked positions (every position when none is masked, as in
    a commit forward). Returns the max |conf difference|, its share of
    ``out``'s max conf there, the argmax agreement and the count."""
    from repro_torch.kernels.ref import confidence_ref
    from repro_torch.models.layers import unembed

    def conf_tok(x):
        logits = x if head is None else unembed(head, x, transpose=tied)
        return confidence_ref(logits.reshape(-1, logits.shape[-1]))

    c0, t0 = conf_tok(out)
    c1, t1 = conf_tok(alt)
    sel = masked.reshape(-1)
    if not bool(sel.any()):
        sel = torch.ones_like(sel)
    dmax = float((c1 - c0).abs()[sel].max())
    return dict(max_dconf=dmax, share=dmax / float(c0[sel].max()),
                agree=float((t0 == t1)[sel].float().mean()),
                n=int(sel.sum()))


def disagreement(rows, impl) -> float:
    """Argmax disagreement of ``impl`` over every compared position."""
    n = sum(r[impl]["n"] for r in rows)
    return sum((1 - r[impl]["agree"]) * r[impl]["n"] for r in rows) / n


def replay_ok(rows) -> bool:
    """The replay's gate (the bars above) on the kernel's rows."""
    return bool(rows) and all(
        r["kernel"]["share"] <= REPLAY_CONF_SHARE for r in rows) and (
        1 - disagreement(rows, "kernel") >= REPLAY_ARGMAX_AGREE)


def attn_check(impl):
    """A replay check: the same ``block_step`` with ``attn_impl=impl``."""
    def run(step, *args, **kw):
        return step(*args, **dict(kw, attn_impl=impl, write=False))[0]
    return run


class ReplayStop(Exception):
    """Raised by :class:`TeacherForced` once its forward limit is met."""


class TeacherForced:
    """While active, every ``models.model.block_step`` first runs each
    check of ``checks`` (``{name: fn(block_step, *args, **kw) -> output}``;
    by default ``attn_impl`` of ``REPLAY_CHECKS``) with ``write=False`` on
    the caller's inputs and cache, then as the caller asked, whose output
    (and cache) drives the decode. Each forward adds one row to ``rows``:
    its ``kind`` ("step" for a denoising forward, "commit" for one that
    writes the cache) and, under each check, its :func:`replay_compare`
    against the driving output. With ``forwards`` set, the row of that
    forward raises :class:`ReplayStop` and the decode ends there."""

    def __init__(self, params, cfg, checks=None, forwards=None):
        from repro_torch.models import model as M

        self.M, self.cfg = M, cfg
        self.head = M.head_weights(params, cfg)
        self.checks = checks or {impl: attn_check(impl)
                                 for impl in REPLAY_CHECKS}
        self.forwards = forwards
        self.rows = []

    def __enter__(self):
        self.orig = self.M.block_step
        self.M.block_step = self.step
        return self

    def __exit__(self, *exc):
        self.M.block_step = self.orig

    def step(self, params, cfg, block_tokens, block_start, cache, **kw):
        alts = {name: fn(self.orig, params, cfg, block_tokens, block_start,
                         cache, **kw)
                for name, fn in self.checks.items()}
        out, cache = self.orig(params, cfg, block_tokens, block_start,
                               cache, **kw)
        head = None if kw.get("head", True) else self.head
        masked = block_tokens == self.cfg.mask_token_id
        row = {name: replay_compare(out, alt, masked, head=head,
                                    tied=self.cfg.tie_embeddings)
               for name, alt in alts.items()}
        row["kind"] = "commit" if kw.get("write") else "step"
        self.rows.append(row)
        if len(self.rows) == self.forwards:
            raise ReplayStop
        return out, cache


def replay_rows(params, cfg, dcfg, store, prompts, attn_impl="dense",
                checks=None, forwards=None):
    """One OSDT decode of ``prompts`` on the calibrated ``store``, driven
    with ``attn_impl`` (by default the plain block attention), with every
    check (by default each impl of ``REPLAY_CHECKS``) run on the same
    inputs and cache at each forward: (result, replay rows). Unlike the
    tokens of two free-running decodes, this comparison does not
    compound: each forward sees the same inputs on every side. With
    ``forwards``, the decode stops after that many block-step forwards
    and the result is None."""
    from repro_torch.core.decoder import make_generate_fn
    from repro_torch.core.osdt import OSDTSession
    from repro_torch.data import tokenizer as tok

    s = OSDTSession(params, cfg, dcfg, tok.MASK_ID, store=store,
                    gen_fn=make_generate_fn(cfg, dcfg, attn_impl=attn_impl))
    res = None
    with TeacherForced(params, cfg, checks, forwards) as tf:
        try:
            res = s.generate(prompts)
        except ReplayStop:
            pass
    return res, tf.rows


def replay_path(params, cfg, dcfg, store, prompts):
    """The replay of the main path's bf16 fused Phase 2 (its batch, its
    calibrated table), gated by :func:`replay_ok`; then the same replay
    under each emulated fault of ``REPLAY_FAULTS``, which the gate must
    reject."""
    from repro_torch.kernels import ops as kops

    res, rows = replay_rows(params, cfg, dcfg, store, prompts)
    torch.cuda.synchronize()
    for i, r in enumerate(rows):
        log(f"replay forward {i} ({r['kind']}, {r['kernel']['n']} "
            f"positions): " + "; ".join(
                f"{impl} max |dconf| {r[impl]['max_dconf']:.3e} "
                f"({r[impl]['share']:.2%} of max conf), argmax agreement "
                f"{r[impl]['agree']:.4f}" for impl in REPLAY_CHECKS))
    for impl in REPLAY_CHECKS:
        log(f"teacher-forced replay, {impl} against the plain dense "
            f"attention driving the bf16 fused Phase 2 (NFE {res.nfe}, "
            f"{len(rows)} block-step forwards): worst share "
            f"{max(r[impl]['share'] for r in rows):.2%}, lowest argmax "
            f"agreement {min(r[impl]['agree'] for r in rows):.4f}, "
            f"pooled agreement {1 - disagreement(rows, impl):.4f} over "
            f"{sum(r[impl]['n'] for r in rows)} positions")
    check(replay_ok(rows), "teacher-forced replay: the kernel's conf share "
          f"<= {REPLAY_CONF_SHARE:.0%} at every forward and its pooled "
          f"argmax agreement >= {REPLAY_ARGMAX_AGREE}")
    orig = kops.cached_block_attention_kernel
    for name, fault in REPLAY_FAULTS.items():
        kops.cached_block_attention_kernel = fault(orig)
        try:
            _, rows = replay_rows(params, cfg, dcfg, store, prompts)
        finally:
            kops.cached_block_attention_kernel = orig
        caught = not replay_ok(rows)
        log(f"replay under the emulated fault {name}: worst share "
            f"{max(r['kernel']['share'] for r in rows):.2%}, pooled "
            f"agreement {1 - disagreement(rows, 'kernel'):.4f}, "
            f"rejected: {caught}")
        check(caught, f"the replay's gate rejects the fault {name}")


# The K3 replay: one bf16 fused Phase 2 driven by the plain fused step
# (``fused_step_plain`` on the card, in place of
# ``kernels.ops.fused_step_kernel``), the fused step kernel (K3) run on
# the same (x, w, tau, masked) at every denoising forward, the block
# attention kernel driving the forwards, gated by the same bars as K1's.

class K3Replay:
    """While active, ``kernels.ops`` takes the plain fused step for the
    fused epilogue, after running ``kernel`` (K3's wrapper, or a fault
    around it) on the same inputs; each call adds one row to ``rows``,
    :func:`k3_compare` of the two under ``"kernel"``. ``wrapper`` names
    the swapped entry of ``kernels.ops`` and ``plain`` its plain version
    (K6's, in :class:`K6Replay`)."""

    wrapper = "fused_step_kernel"

    @staticmethod
    def plain(*args, **kw):
        from repro_torch.kernels.fused_step import fused_step_plain

        return fused_step_plain(*args, **kw)

    def __init__(self, kernel):
        self.kernel = kernel
        self.rows = []

    def __enter__(self):
        from repro_torch.kernels import ops as kops

        self.kops, self.saved = kops, getattr(kops, self.wrapper)
        setattr(kops, self.wrapper, self.step)
        return self

    def __exit__(self, *exc):
        setattr(self.kops, self.wrapper, self.saved)

    def step(self, *args, tied, quota=0, group=0):
        """``args``: x, the head's operands, tau, masked."""
        tau, masked = args[-2:]
        got = self.kernel(*args, tied=tied, quota=quota, group=group)
        want = self.plain(*args, tied=tied, quota=quota, group=group)
        self.rows.append({"kind": "step", "kernel": k3_compare(
            want, got, masked, None if quota else tau)})
        return want


class K6Replay(K3Replay):
    """:class:`K3Replay` for the int8 head's fused step (K6), the plain
    ``quantized_fused_step_plain`` driving."""

    wrapper = "quantized_fused_step_kernel"

    @staticmethod
    def plain(*args, **kw):
        from repro_torch.kernels.fused_step import quantized_fused_step_plain

        return quantized_fused_step_plain(*args, **kw)


def k3_compare(want, got, masked, tau=None):
    """Two fused steps' ``(conf, tok, above)`` on the same inputs, as
    :func:`replay_compare` reads two forwards: the max |conf difference|
    over the masked positions (every position when none is), its share of
    ``want``'s max conf there, the argmax agreement and the count; and
    ``above``'s disagreements over the positions whose conf is further
    than 1e-3 relative from ``tau`` (every position in quota mode,
    ``tau`` None), with that count."""
    (c0, t0, a0), (c1, t1, a1) = want, got
    sel = masked if bool(masked.any()) else torch.ones_like(masked)
    dmax = float((c1 - c0).abs()[sel].max())
    far = torch.ones_like(masked) if tau is None else \
        (c0 - tau).abs() > 1e-3 * c0
    return dict(max_dconf=dmax, share=dmax / float(c0[sel].max()),
                agree=float((t0 == t1)[sel].float().mean()),
                n=int(sel.sum()), above_mismatch=int(((a0 != a1) & far)
                                                     .sum()),
                above_far=int(far.sum()))


def _lower_vocab(w, tied):
    """The head's first half of the vocabulary."""
    V = w.shape[0] if tied else w.shape[1]
    return (w[:V // 2] if tied else w[:, :V // 2]).contiguous()


# K3 faults the replay must reject, each emulated around K3's wrapper as
# a kernel with that fault would compute: logits 10% high (x scaled), the
# last 1/16 of the contraction dropped, the upper half of the vocabulary
# hidden.
K3_REPLAY_FAULTS = {
    "logits_10pct_high": lambda f: (
        lambda x, w, *a, **k: f(x * 1.1, w, *a, **k)),
    "last_sixteenth_dropped": lambda f: (
        lambda x, w, *a, **k: f(_tail_dropped(x), w, *a, **k)),
    "upper_vocab_hidden": lambda f: (
        lambda x, w, *a, tied, **k: f(x, _lower_vocab(w, tied), *a,
                                      tied=tied, **k)),
}


def k3_replay_rows(params, cfg, dcfg, store, prompts, kernel,
                   replay=K3Replay):
    """The K3 replay's rows: the fused decode driven by the plain fused
    step, ``kernel`` (K3's wrapper, or a fault around it) checked at
    every denoising forward: (result, rows). With ``replay=K6Replay`` (and
    int8 params), the K6 replay's."""
    from repro_torch.core.decoder import make_generate_fn
    from repro_torch.core.osdt import OSDTSession
    from repro_torch.data import tokenizer as tok

    s = OSDTSession(params, cfg, dcfg, tok.MASK_ID, store=store,
                    gen_fn=make_generate_fn(cfg, dcfg, attn_impl="kernel"))
    with replay(kernel) as rp:
        res = s.generate(prompts)
    return res, rp.rows


def k6_replay_rows(qparams, cfg, fdcfg, store, prompts, kernel):
    """The K6 replay's rows: the fused int8 decode driven by the plain
    int8 fused step, ``kernel`` (K6's wrapper, or a fault around it)
    checked at every denoising forward: (result, rows)."""
    return k3_replay_rows(qparams, cfg, fdcfg, store, prompts, kernel,
                          replay=K6Replay)


def step_replay_summary(rows):
    """A fused-step (or confidence) replay's rows in one line; ``above``
    where the rows have it."""
    k = [r["kernel"] for r in rows]
    above = "" if "above_mismatch" not in k[0] else (
        f", above mismatches {sum(r['above_mismatch'] for r in k)} of "
        f"{sum(r['above_far'] for r in k)} positions 1e-3 from tau")
    return (f"max |dconf| {max(r['max_dconf'] for r in k):.3e}, worst "
            f"share {max(r['share'] for r in k):.2%}, lowest "
            f"argmax agreement {min(r['agree'] for r in k):.4f}, pooled "
            f"agreement {1 - disagreement(rows, 'kernel'):.4f} over "
            f"{sum(r['n'] for r in k)} positions{above}; "
            "share by forward " + " ".join(f"{r['share']:.2%}" for r in k))


def step_replay_path(name, driven, run, kernel, faults):
    """A fused-step or confidence replay (``run(kernel) -> (result,
    rows)``) gated by :func:`replay_ok`; then the same replay under each
    fault of ``faults``, which the gate must reject. ``name`` is the
    kernel's tag (K3, K6, K2) and ``driven`` says what the plain version
    drives."""
    res, rows = run(kernel)
    torch.cuda.synchronize()
    log(f"{name} teacher-forced replay, {name} against the plain "
        f"{driven} (NFE {res.nfe}, {len(rows)} denoising forwards): "
        f"{step_replay_summary(rows)}")
    check(replay_ok(rows), f"{name} teacher-forced replay: {name}'s conf "
          f"share <= {REPLAY_CONF_SHARE:.0%} at every forward and its "
          f"pooled argmax agreement >= {REPLAY_ARGMAX_AGREE}")
    for fault_name, fault in faults.items():
        _, rows = run(fault(kernel))
        caught = not replay_ok(rows)
        log(f"{name} replay under the emulated fault {fault_name}: "
            f"{step_replay_summary(rows)}; rejected: {caught}")
        check(caught, f"the {name} replay's gate rejects the fault "
              f"{fault_name}")


def k3_replay_path(params, cfg, dcfg, store, prompts):
    """The K3 replay of the main path's bf16 fused Phase 2 (its batch, its
    calibrated table), gated by :func:`replay_ok`; then the same replay
    under each fault of ``K3_REPLAY_FAULTS``, which the gate must
    reject."""
    from repro_torch.kernels.fused_step import fused_step_kernel as k3

    step_replay_path(
        "K3", "fused step driving the bf16 fused Phase 2",
        lambda kernel: k3_replay_rows(params, cfg, dcfg, store, prompts,
                                      kernel), k3, K3_REPLAY_FAULTS)


# The K2 replay: the main path's unfused bf16 Phase 2 (K1 and the bf16
# head driving the forwards) driven by the plain confidence pass
# (``ref.confidence_ref`` on the card, in place of
# ``kernels.ops.fused_confidence_kernel``), K2 run on the same logits at
# every denoising forward, gated by the same bars as K1's. K2's wrapper
# sees no mask, so every position of the block is read.

class K2Replay:
    """While active, ``kernels.ops`` takes the plain confidence pass for
    the unfused epilogue, after running ``kernel`` (K2's wrapper, or a
    fault around it) on the same logits; each call adds one row to
    ``rows``, :func:`conf_compare` of the two under ``"kernel"``."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.rows = []

    def __enter__(self):
        from repro_torch.kernels import ops as kops

        self.kops, self.saved = kops, kops.fused_confidence_kernel
        kops.fused_confidence_kernel = self.step
        return self

    def __exit__(self, *exc):
        self.kops.fused_confidence_kernel = self.saved

    def step(self, logits):
        from repro_torch.kernels.ref import confidence_ref

        got = self.kernel(logits)
        want = confidence_ref(logits)
        self.rows.append({"kind": "step", "kernel": conf_compare(want, got)})
        return want


def conf_compare(want, got):
    """Two confidence passes' ``(conf, tok)`` on the same logits, as
    :func:`replay_compare` reads two forwards, over every row: the max
    |conf difference|, its share of ``want``'s max conf, the argmax
    agreement and the count."""
    (c0, t0), (c1, t1) = want, got
    dmax = float((c1 - c0).abs().max())
    return dict(max_dconf=dmax, share=dmax / float(c0.max()),
                agree=float((t0 == t1).float().mean()), n=int(c0.numel()))


def _split_local_argmax(f, x):
    """K2 whose token is its column within its split (the plan's)."""
    from repro_torch.kernels.confidence import plan

    conf, tok = f(x)
    return conf, tok % plan(*x.shape).split


def _merge_without_rescale(f, x):
    """K2 whose cluster merge adds the splits' sums of exp(x - m_i) as
    they are, without exp(m_i - m): 1 / the sum of each split's 1/conf."""
    from repro_torch.kernels.confidence import plan

    w = plan(*x.shape).split
    conf, tok = f(x)
    s = sum(1 / f(x[:, c:c + w].contiguous())[0]
            for c in range(0, x.shape[1], w))
    return 1 / s, tok


# K2 faults the replay must reject, each emulated around K2's wrapper as a
# kernel with that fault would compute: the upper half of the vocabulary
# hidden, the token taken relative to its split's first column, and the
# splits' sums merged without their rescale.
K2_REPLAY_FAULTS = {
    "upper_vocab_hidden": lambda f: (
        lambda x: f(x[:, :x.shape[1] // 2].contiguous())),
    "split_local_argmax": lambda f: (lambda x: _split_local_argmax(f, x)),
    "merge_without_rescale": lambda f: (
        lambda x: _merge_without_rescale(f, x)),
}


def k2_replay_rows(params, cfg, dcfg, store, prompts, kernel):
    """The K2 replay's rows: the unfused bf16 decode (the main path's, K1
    driving the forwards) driven by the plain confidence pass, ``kernel``
    (K2's wrapper, or a fault around it) checked at every denoising
    forward: (result, rows)."""
    from repro_torch.core.decoder import make_generate_fn
    from repro_torch.core.osdt import OSDTSession
    from repro_torch.data import tokenizer as tok

    s = OSDTSession(params, cfg, dcfg, tok.MASK_ID, store=store,
                    gen_fn=make_generate_fn(cfg, dcfg, attn_impl="kernel",
                                            step_fusion="unfused",
                                            use_kernel=True))
    with K2Replay(kernel) as rp:
        res = s.generate(prompts)
    return res, rp.rows


def k2_replay_path(params, cfg, dcfg, store, prompts):
    """The K2 replay of the main path's unfused bf16 Phase 2 (its batch,
    the session's calibrated table), gated by :func:`replay_ok`; then the
    same replay under each fault of ``K2_REPLAY_FAULTS``, which the gate
    must reject."""
    from repro_torch.kernels.confidence import fused_confidence_kernel as k2

    step_replay_path(
        "K2", "confidence pass driving the unfused bf16 Phase 2",
        lambda kernel: k2_replay_rows(params, cfg, dcfg, store, prompts,
                                      kernel), k2, K2_REPLAY_FAULTS)


# The K6 replay: one fused int8 Phase 2 driven by the plain int8 fused
# step (``quantized_fused_step_plain`` on the card, in place of
# ``kernels.ops.quantized_fused_step_kernel``), K6 run on the same (x, q,
# scale, tau, masked) at every denoising forward, K5 and K1 driving the
# forwards, gated by the same bars as K1's. Its faults, each emulated
# around K6's wrapper as a kernel with that fault would compute: every
# channel scaled by its neighbour's scale, the last 1/16 of the
# contraction dropped, the upper half of the vocabulary hidden.
K6_REPLAY_FAULTS = {
    "scale_one_channel_over": lambda f: (
        lambda x, q, scale, *a, **k: f(
            x, q, torch.roll(scale.reshape(-1), 1).reshape(scale.shape), *a,
            **k)),
    "last_sixteenth_dropped": lambda f: (
        lambda x, *a, **k: f(_tail_dropped(x), *a, **k)),
    "upper_vocab_hidden": lambda f: (
        lambda x, q, scale, *a, tied, **k: f(
            x, _lower_vocab(q, tied),
            scale.reshape(-1)[:scale.numel() // 2].contiguous(), *a,
            tied=tied, **k)),
}


def k6_replay_path(qparams, cfg, fdcfg, store, prompts):
    """The K6 replay of the fused int8 Phase 2 (its batch, the unfused int8
    session's calibrated table), gated by :func:`replay_ok`; then the
    same replay under each fault of ``K6_REPLAY_FAULTS``, which the gate
    must reject."""
    from repro_torch.kernels.fused_step import \
        quantized_fused_step_kernel as k6

    step_replay_path(
        "K6", "int8 fused step driving the fused int8 Phase 2",
        lambda kernel: k6_replay_rows(qparams, cfg, fdcfg, store, prompts,
                                      kernel), k6, K6_REPLAY_FAULTS)


# The int8 replay: one unfused int8 Phase 2 driven by the plain int8
# matmul (``ref.quantized_matmul_ref`` on the card, in place of
# ``kernels.ops.quantized_matmul_kernel``), the int8 matmul kernel (K5)
# run on the same inputs and cache at every forward, the block attention
# kernel on both sides, gated by the same bars as K1's.

class K5Swapped:
    """While active, ``kernels.ops`` calls ``fn`` for the int8 matmul."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.kernels import ops as kops

        self.kops, self.saved = kops, kops.quantized_matmul_kernel
        kops.quantized_matmul_kernel = self.fn

    def __exit__(self, *exc):
        self.kops.quantized_matmul_kernel = self.saved


def k5_check(fn):
    """A replay check: the same ``block_step`` with the int8 matmul ``fn``
    (the kernel, or the kernel under an emulated fault)."""
    def run(step, *args, **kw):
        with K5Swapped(fn):
            return step(*args, **dict(kw, write=False))[0]
    return run


def _tail_dropped(x, *_):
    """x with the last 1/16 of its contraction zeroed."""
    x = x.clone()
    x[:, x.shape[1] - x.shape[1] // 16:] = 0
    return x


def _stage_twice(f, x, q, scale, **kw):
    """The product plus the middle 64-deep stage of it once more."""
    k0 = 64 * (x.shape[1] // 128)
    xs = torch.zeros_like(x)
    xs[:, k0:k0 + 64] = x[:, k0:k0 + 64]
    out = f(x, q, scale, **kw)
    return (out.float() + f(xs, q, scale, **kw).float()).to(out.dtype)


# Kernel faults the int8 replay must reject, each emulated around K5's
# wrapper as a kernel with that fault would compute: every column scaled
# by its neighbour's scale, the last 1/16 of the contraction dropped, one
# 64-deep K stage counted twice.
K5_REPLAY_FAULTS = {
    "scale_one_channel_over": lambda f: (
        lambda x, q, scale, **kw: f(
            x, q, torch.roll(scale.reshape(-1), 1).reshape(scale.shape),
            **kw)),
    "last_sixteenth_dropped": lambda f: (
        lambda x, q, scale, **kw: f(_tail_dropped(x), q, scale, **kw)),
    "one_stage_twice": lambda f: (
        lambda x, q, scale, **kw: _stage_twice(f, x, q, scale, **kw)),
}


# The faults' replays stop after this many block-step forwards (on the
# main path's batch: blocks 0 and 1 with their commits, and the start of
# block 2); each fault is in every projection of every forward, so the
# first forwards show it as surely as the whole decode.
K5_FAULT_FORWARDS = 8


def int8_replay_rows(qparams, cfg, qdcfg, store, prompts, kernel,
                     forwards=None):
    """The int8 replay's rows: the decode driven by the plain int8 matmul,
    ``kernel`` (K5's wrapper, or a fault around it) checked, over the
    first ``forwards`` block-step forwards (None: all)."""
    from repro_torch.kernels.ref import quantized_matmul_ref

    with K5Swapped(quantized_matmul_ref):
        return replay_rows(qparams, cfg, qdcfg, store, prompts,
                           attn_impl="kernel",
                           checks={"kernel": k5_check(kernel)},
                           forwards=forwards)


def int8_replay_path(qparams, cfg, qdcfg, store, prompts):
    """The int8 replay of the unfused int8 Phase 2 (its batch, its
    calibrated table), gated by :func:`replay_ok`; then the same replay
    under each fault of ``K5_REPLAY_FAULTS``, which the gate must
    reject over the decode's first ``K5_FAULT_FORWARDS`` forwards."""
    from repro_torch.kernels.quantized_matmul import \
        quantized_matmul_kernel as k5

    def summary(rows):
        worst = max(range(len(rows)), key=lambda i: rows[i]["kernel"]["share"])
        return (f"worst share {rows[worst]['kernel']['share']:.2%} (forward "
                f"{worst}, {rows[worst]['kind']}), lowest argmax agreement "
                f"{min(r['kernel']['agree'] for r in rows):.4f}, pooled "
                f"agreement {1 - disagreement(rows, 'kernel'):.4f} over "
                f"{sum(r['kernel']['n'] for r in rows)} positions")

    res, rows = int8_replay_rows(qparams, cfg, qdcfg, store, prompts, k5)
    torch.cuda.synchronize()
    log(f"int8 teacher-forced replay, K5 against the plain int8 matmul "
        f"driving the unfused int8 Phase 2 (NFE {res.nfe}, {len(rows)} "
        f"block-step forwards): {summary(rows)}")
    check(replay_ok(rows), "int8 teacher-forced replay: K5's conf share "
          f"<= {REPLAY_CONF_SHARE:.0%} at every forward and its pooled "
          f"argmax agreement >= {REPLAY_ARGMAX_AGREE}")
    for name, fault in K5_REPLAY_FAULTS.items():
        _, rows = int8_replay_rows(qparams, cfg, qdcfg, store, prompts,
                                   fault(k5), forwards=K5_FAULT_FORWARDS)
        caught = not replay_ok(rows)
        log(f"int8 replay under the emulated K5 fault {name}, first "
            f"{len(rows)} forwards: {summary(rows)}; share by forward "
            + " ".join(f"{r['kernel']['share']:.2%}" for r in rows)
            + f"; rejected: {caught}")
        check(caught, f"the int8 replay's gate rejects the K5 fault {name}")


def nfe_report(params, cfg, dcfg, store, batches: int = 2):
    """Not a gate: the bf16 fused Phase-2 NFE with the kernel and with the
    plain attention, on the calibrated table, over ``batches`` prompt
    batches from seeds SEED .. SEED + batches - 1. On random weights every
    confidence sits near its threshold, so any change of rounding flips
    decisions and a single batch's NFE moves either way."""
    from repro_torch.core.decoder import make_generate_fn
    from repro_torch.core.osdt import OSDTSession
    from repro_torch.data import tokenizer as tok

    nfe = {"kernel": [], "dense": []}
    for k in range(batches):
        rows = np.random.default_rng(SEED + k).integers(0, 256,
                                                        (BATCH, PROMPT))
        for impl in nfe:
            gen = make_generate_fn(cfg, dcfg, attn_impl=impl)
            s = OSDTSession(params, cfg, dcfg, tok.MASK_ID, store=store,
                            gen_fn=gen)
            nfe[impl].append(int(s.generate(rows).nfe))
        log(f"NFE report, seed {SEED + k}: kernel {nfe['kernel'][-1]}, "
            f"plain {nfe['dense'][-1]}")
    log(f"NFE report over {batches} batches: kernel mean "
        f"{np.mean(nfe['kernel']):.2f} {nfe['kernel']}, plain mean "
        f"{np.mean(nfe['dense']):.2f} {nfe['dense']}")


def profile_phase2(session, prompts, label):
    """One more Phase-2 generate under ``torch.profiler``: the device's
    busy share of the wall time, the kernels that take it (and the shares
    of K5, ``qmm_wgmma`` and, its float32 head, ``head_wgmma<Int8Head...,
    StoreF32>``; K6, ``head_wgmma<Int8Head..., Partials>``; K3's pass 1;
    and K1/K4, ``block_attn*``), and the host calls that launch and
    wait."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = session.generate(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or 0

    kern = sorted((e for e in ka if getattr(e, "device_type", None)
                   == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kern) / 1e6
    if busy == 0:
        log(f"profiled Phase 2 {label}: the trace holds no device time "
            "(busy share not measured)")
        return
    # K5's float32 head and K6 share the head body, told apart by epilogue
    int8 = [e for e in kern if "Int8Head" in e.key]
    k6 = sum(dev_us(e) for e in int8 if "Partials" in e.key) / 1e6
    k5h = sum(dev_us(e) for e in int8 if "StoreF32" in e.key) / 1e6
    k5 = sum(dev_us(e) for e in kern if "qmm_wgmma" in e.key) / 1e6 + k5h
    k1 = [e for e in kern if "block_attn" in e.key]
    k1_s = sum(dev_us(e) for e in k1) / 1e6
    # K3's pass 1 (the head body on a bf16 head; ``fused_step_partial``
    # f32)
    k3 = [e for e in kern if "Bf16Head" in e.key
          or "fused_step_partial" in e.key]
    k3_s = sum(dev_us(e) for e in k3) / 1e6
    log(f"profiled Phase 2 {label} (under the profiler): NFE={res.nfe} "
        f"wall={wall:.3f}s device busy={busy:.3f}s "
        f"({busy / wall:.1%}), {sum(e.count for e in kern)} kernels; "
        f"K5 device {k5:.3f}s ({k5 / busy:.1%} of busy; its float32 head "
        f"{k5h:.4f}s, {k5h / busy:.1%}), K6 device "
        f"{k6:.3f}s ({k6 / busy:.1%}); K1/K4 device {k1_s:.4f}s "
        f"({k1_s / busy:.1%}) over {sum(e.count for e in k1)} launches; "
        f"K3 pass 1 device {k3_s:.4f}s ({k3_s / busy:.1%}) over "
        f"{sum(e.count for e in k3)} launches")
    for e in kern[:10]:
        log(f"  device {dev_us(e) / 1e3:9.2f} ms x{e.count:6d}  "
            f"{e.key[:100]}")
    host = {e.key: e for e in ka}
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cudaMemcpyAsync", "cudaStreamSynchronize",
                 "cudaFuncSetAttribute", "aten::item", "aten::matmul"):
        if name in host:
            e = host[name]
            log(f"  host {e.cpu_time_total / 1e3:9.2f} ms x{e.count:6d}  "
                f"{name}")


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def time_kernels(dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.block_attention import \
        cached_block_attention_kernel as k1
    from repro_torch.kernels.block_attention import (kv_limit_from_pos,
                                                     row_scalars)
    from repro_torch.kernels.fused_step import fused_step_kernel as k3

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    res = {}
    # K1 at the main path's block step: B=8, bs=32, 32 MHA heads x 128, a
    # T=256 prefix cache holding the prompt and two committed blocks. Four
    # layers' caches rotate so each launch reads its cache from HBM, as a
    # layer of the real step does (4 x 33.5 MB exceeds the 50 MB L2).
    B, bs, H, D, T = BATCH, BLOCK, 32, 128, PROMPT + NEW
    fill, copies = PROMPT + 2 * BLOCK, 4
    x = block_attention_inputs(gen, dev, B=B, bs=bs, H=H, Kh=H, D=D, T=T,
                               fill=fill, copies=copies)

    # the block step builds the geometry once for all its layers
    sc = row_scalars(B, dev, slot=fill, block_start=fill,
                     kv_limit=kv_limit_from_pos(x["pos"]))

    def run_k1(i):
        return k1(x["q"], x["ck"][i % copies], x["cv"][i % copies], x["bk"],
                  x["bv"], x["pos"], sc)

    def run_k1_plain(i):
        return ref.cached_block_attention_ref(
            x["q"], x["ck"][i % copies], x["cv"][i % copies], x["bk"],
            x["bv"], x["pos"], slot=sc[0], block_start=sc[1],
            kv_limit=sc[4])

    # yardstick: SDPA over the pre-written cache with the same mask
    kfull = [c.clone() for c in x["ck"]]
    vfull = [c.clone() for c in x["cv"]]
    for c in kfull:
        c[:, fill:fill + bs] = x["bk"]
    for c in vfull:
        c[:, fill:fill + bs] = x["bv"]
    kfull = [c.transpose(1, 2).contiguous() for c in kfull]
    vfull = [c.transpose(1, 2).contiguous() for c in vfull]
    qt = x["q"].transpose(1, 2).contiguous()
    valid = (torch.arange(T, device=dev) < fill + bs)[None, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def run_k1_lib(i):
        return sdpa(qt, kfull[i % copies], vfull[i % copies],
                    attn_mask=valid)

    with torch.no_grad():
        got = run_k1_lib(0).transpose(1, 2)
        ok, _ = bf16_close(run_k1(0), ref.cached_block_attention_ref(
            x["q"], x["ck"][0], x["cv"][0], x["bk"], x["bv"], x["pos"],
            slot=fill, block_start=fill))
        check(ok, "K1 timing inputs agree with the plain version")
        check(bool((got.float() - run_k1(0).float()).abs().max() < 0.05),
              "the SDPA yardstick computes the same attention")
    live = fill + bs
    k1_bytes = 2 * (x["q"].numel() + 2 * B * fill * H * D + 2 * B * bs * H * D
                    + x["q"].numel()) + 4 * T
    k1_ops = 4 * B * H * bs * live * D
    res["block_attention"] = dict(
        ms=cuda_ms(run_k1, 50), plain_ms=cuda_ms(run_k1_plain, 10),
        library_ms=cuda_ms(run_k1_lib, 50),
        bound=bound(k1_bytes, k1_ops, BF16_OPS_PER_S))

    # K4 at the paged path's block step: K1's shapes over a pool of 132
    # pages of 16 slots through a random permutation of pages, every row
    # live and every page of the 192 valid slots mapped, as on the path.
    # Four layers' pools rotate (4 x 34.6 MB > L2).
    from repro_torch.kernels.block_attention import \
        paged_block_attention_kernel as k4
    xp = paged_inputs(gen, dev, B=B, bs=bs, H=H, Kh=H, D=D, T=T, fill=fill,
                      ps=PAGE, copies=copies)

    def run_k4(i):
        return k4(xp["q"], xp["pk"][i % copies], xp["pv"][i % copies],
                  xp["bk"], xp["bv"], xp["pos"], xp["pt"], sc)

    def run_k4_plain(i):
        return ref.paged_block_attention_ref(
            xp["q"], xp["pk"][i % copies], xp["pv"][i % copies], xp["bk"],
            xp["bv"], xp["pos"], xp["pt"], slot=sc[0], block_start=sc[1],
            kv_limit=sc[4])

    # yardstick: SDPA over the gathered dense view with the block written
    # in (the gather is done here, outside the timed calls)
    kview, vview = [], []
    for c in range(copies):
        kv_ = gather_view(xp["pk"][c], xp["pt"], T, PAGE)
        vv_ = gather_view(xp["pv"][c], xp["pt"], T, PAGE)
        kv_[:, fill:fill + bs] = xp["bk"]
        vv_[:, fill:fill + bs] = xp["bv"]
        kview.append(kv_.transpose(1, 2).contiguous())
        vview.append(vv_.transpose(1, 2).contiguous())
    qpt = xp["q"].transpose(1, 2).contiguous()

    def run_k4_lib(i):
        return sdpa(qpt, kview[i % copies], vview[i % copies],
                    attn_mask=valid)

    with torch.no_grad():
        ok, _ = bf16_close(run_k4(0), run_k4_plain(0))
        check(ok, "K4 timing inputs agree with the plain version")
        check(bool((run_k4_lib(0).transpose(1, 2).float()
                    - run_k4(0).float()).abs().max() < 0.05),
              "the SDPA yardstick computes the same attention")
    n_log = -(-T // PAGE)
    res["paged_block_attention"] = dict(
        ms=cuda_ms(run_k4, 50), plain_ms=cuda_ms(run_k4_plain, 10),
        library_ms=cuda_ms(run_k4_lib, 50),
        bound=bound(k1_bytes + 4 * B * n_log, k1_ops, BF16_OPS_PER_S))
    del xp, kview, vview

    res.update(time_confidence(gen, dev))

    R, V, M = B * bs, 126464, 4096
    # K3 at the main path's step: x [256, 4096] bf16, untied head
    # [4096, 126464] bf16 (1.04 GB); and Phase 1's R = 32. No single
    # PyTorch call computes (conf, tok, above); the bf16 cuBLAS product of
    # the same operands (the logits alone, in bf16) is printed beside it
    # as a yardstick for the product.
    w = (torch.randn((M, V), generator=gen, device=dev) * M ** -0.5).to(
        torch.bfloat16)
    for rows in (R, BLOCK):
        xs = torch.randn((rows, M), generator=gen, device=dev).to(
            torch.bfloat16)
        tau = torch.full((rows,), 1e-4, device=dev)
        masked = torch.ones((rows,), dtype=torch.bool, device=dev)
        r = dict(
            ms=cuda_ms(lambda i: k3(xs, w, tau, masked, tied=False), 10),
            plain_ms=cuda_ms(lambda i: ref.fused_step_ref(
                xs, w, tau, masked, tied=False), 5),
            library_ms=None,
            bound=bound(M * V * 2 + rows * M * 2 + rows * 5 + rows * 9,
                        2 * rows * M * V, BF16_OPS_PER_S))
        cublas = cuda_ms(lambda i: xs @ w, 10)
        log(f"time fused_step R={rows} [{M}, {V}] bf16 (graph replay, "
            f"median of 5): kernel {r['ms'][0]:.4f} ms [{r['ms'][1]:.4f}-"
            f"{r['ms'][2]:.4f}], plain {r['plain_ms'][0]:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); bf16 cuBLAS "
            f"product of the same operands (logits only, a yardstick): "
            f"{cublas[0]:.4f} ms [{cublas[1]:.4f}-{cublas[2]:.4f}]")
        if rows == R:
            res["fused_step"] = r
        del xs
    del w
    torch.cuda.empty_cache()
    res.update(time_quantized_matmul(gen, dev))
    res.update(time_quantized_fused_step(gen, dev))
    res.update(time_flash_attention(gen, dev))
    for name, r in res.items():
        for key in ("ms", "plain_ms", "library_ms"):
            if r[key] is not None:
                med, lo, hi = r[key]
                r[key] = med
                r[f"{key}_range"] = (lo, hi)
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"time {name} (graph replay, median of 5): kernel "
            f"{r['ms']:.4f} ms [{r['ms_range'][0]:.4f}-"
            f"{r['ms_range'][1]:.4f}], plain {r['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")
    return res


def time_confidence(gen, dev):
    """K2 on the unfused Phase 2's logits, [B*bs, V] f32, 129.5 MB (> L2),
    and on Phase 1's R = 32, four copies rotating (4 x 16.2 MB > L2).
    No single PyTorch call computes (conf, tok); the two-call composition
    torch.max + torch.logsumexp prints beside it as a yardstick, its
    tokens held equal to K2's, and the plan's cluster size beside its
    neighbours. Returns the R = 256 row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.confidence import fused_confidence_kernel as k2

    R, V = BATCH * BLOCK, 126464
    res = {}
    for rows, copies in ((R, 1), (BLOCK, 4)):
        xs = [torch.randn((rows, V), generator=gen, device=dev) * 3
              for _ in range(copies)]

        def two_calls(i):
            x = xs[i % copies]
            return torch.max(x, -1), torch.logsumexp(x, -1)

        for x in xs:
            check(torch.equal(k2(x)[1], torch.max(x, -1).indices.to(
                torch.int32)), "the two-call yardstick's tokens are K2's")
        r = dict(ms=cuda_ms(lambda i: k2(xs[i % copies]), 50),
                 plain_ms=cuda_ms(lambda i: ref.confidence_ref(
                     xs[i % copies]), 10),
                 library_ms=None,
                 bound=bound(rows * V * 4 + rows * 8, 4 * rows * V,
                             F32_OPS_PER_S))
        yard = cuda_ms(two_calls, 50)
        log(f"time confidence R={rows} [{rows}, {V}] f32 (graph replay, "
            f"median of 5, {copies} cop{'ies' if copies > 1 else 'y'}): "
            f"kernel {r['ms'][0]:.4f} ms [{r['ms'][1]:.4f}-"
            f"{r['ms'][2]:.4f}], plain {r['plain_ms'][0]:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}); torch.max + "
            f"torch.logsumexp (two calls, a yardstick): {yard[0]:.4f} ms "
            f"[{yard[1]:.4f}-{yard[2]:.4f}]")
        if rows == R:
            res["confidence"] = r
        del xs
    return res


def int8pack_yardstick(x, qt, out, transpose):
    """``torch._weight_int8pack_mm`` on the same inputs, as a timing
    yardstick for K5, or None with the reason when it does not compute
    K5's function within K5's tolerance (the tolerance of ``out``'s
    dtype). It takes q as [N, K] and the scales in x's dtype (bf16 scales
    for bf16 x, so a bf16 call is a near neighbour of K5's function, not
    the same one)."""
    qn = (qt.q if transpose else qt.q.t()).contiguous()
    sc = qt.scale.reshape(-1).to(x.dtype).contiguous()
    try:
        got = torch._weight_int8pack_mm(x, qn, sc)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"does not run: {str(e).splitlines()[0][:120]}"
    ok, err = (bf16_close if out.dtype == torch.bfloat16 else f32_close)(
        got.to(out.dtype), out)
    if not ok:
        return None, f"disagrees with K5 (max_abs_err {err:.3e})"
    return (lambda i: torch._weight_int8pack_mm(x, qn, sc)), \
        f"agrees with K5 (max_abs_err {err:.3e})"


def head_yardsticks(x, qts, copies):
    """The two cuBLAS yardsticks of an int8 head product, device ms
    (median, min, max): f32 cuBLAS on the f32-dequantized head (TF32
    off): the oracle's function in one call; and bf16 cuBLAS on bf16(q):
    the one-term product alone, without its scale."""
    xf, xb = x.float(), x.to(torch.bfloat16)
    wf = [qt.q.float() * qt.scale for qt in qts]
    f32 = cuda_ms(lambda i: xf @ wf[i % copies], 5)
    del wf
    wb = [qt.q.to(torch.bfloat16) for qt in qts]
    bf = cuda_ms(lambda i: xb @ wb[i % copies], 10)
    del wb
    torch.cuda.empty_cache()
    return f32, bf


def time_quantized_matmul(gen, dev):
    """K5 at the main path's shapes: the bf16 projections at the block
    step (R = 256) and the prefill (R = 1024), and the head as the main
    path calls it (bf16 x, float32 out: one term) at both, with f32 x
    (three terms) at R = 256 beside it. Several weight copies rotate where
    one fits in the 50 MB L2, so each launch streams its weight from HBM
    as a layer of the forward does. The head's bound is the bf16 tensor
    rate times its terms. Prints every shape; returns the block step's
    [4096, 12288] as the kernel's row and the head's R = 256 rows. Beside
    a projection, the bf16 cuBLAS product on an unquantized bf16 weight of
    the same shape (a different function, twice the weight bytes); beside
    a head, :func:`head_yardsticks`."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.quantized_matmul import \
        quantized_matmul_kernel as k5
    from repro_torch.models.quantize import quantize_tensor

    bf, f32 = torch.bfloat16, torch.float32
    M, F, V = 4096, 12288, 126464
    shapes = [(f"bf16 R={R} [{K}, {N}]", R, K, N, bf, bf)
              for R in (BATCH * BLOCK, BATCH * PROMPT)
              for K, N in ((M, M), (M, F), (F, M))]
    shapes += [(f"head R={R} [{M}, {V}] bf16 x f32 out", R, M, V, bf, f32)
               for R in (BATCH * BLOCK, BATCH * PROMPT)]
    shapes += [(f"head R={BATCH * BLOCK} [{M}, {V}] f32 x (three terms)",
                BATCH * BLOCK, M, V, f32, f32)]
    rows = {}
    for label, R, K, N, dt, od in shapes:
        copies = max(1, min(4, -(-100_000_000 // (K * N))))
        qts = [quantize_tensor(torch.randn((K, N), generator=gen,
                                           device=dev) * K ** -0.5, axis=-2)
               for _ in range(copies)]
        x = torch.randn((R, K), generator=gen, device=dev).to(dt)

        def run(i):
            qt = qts[i % copies]
            return k5(x, qt.q, qt.scale, transpose=False, out_dtype=od)

        def plain(i):
            qt = qts[i % copies]
            return ref.quantized_matmul_ref(x, qt.q, qt.scale,
                                            transpose=False, out_dtype=od)

        lib_fn, lib_note = int8pack_yardstick(x, qts[0], run(0), False)
        head = od == f32
        terms = 3 if dt == f32 else 1
        iters = 10 if head else 20
        nbytes = R * K * x.element_size() + R * N * (4 if head else 2) \
            + K * N + 4 * N
        r = dict(ms=cuda_ms(run, iters),
                 plain_ms=cuda_ms(plain, 2 if head else 10),
                 library_ms=cuda_ms(lib_fn, 3 if head else iters)
                 if lib_fn else None,
                 bound=bound(nbytes, 2 * R * K * N * terms, BF16_OPS_PER_S))
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms'][0]:.4f} ms"
        if head:
            yf, yb = head_yardsticks(x, qts, copies)
            other = (f"f32 cuBLAS on the f32-dequantized head (TF32 off, the "
                     f"oracle's function): {yf[0]:.4f} ms [{yf[1]:.4f}-"
                     f"{yf[2]:.4f}]; bf16 cuBLAS on bf16(q) (the one-term "
                     f"product): {yb[0]:.4f} ms [{yb[1]:.4f}-{yb[2]:.4f}]")
            r.update(f32_cublas_ms=yf[0], bf16_cublas_ms=yb[0])
        else:
            ws = [(torch.randn((K, N), generator=gen, device=dev)
                   * K ** -0.5).to(bf) for _ in range(copies)]
            cublas = cuda_ms(lambda i: x @ ws[i % copies], iters)[0]
            other = (f"bf16 cuBLAS on an unquantized bf16 weight (a "
                     f"different function): {cublas:.4f} ms")
            del ws
        log(f"time quantized_matmul {label} (graph replay, median of 5, "
            f"{copies} weight copies): kernel {r['ms'][0]:.4f} ms "
            f"[{r['ms'][1]:.4f}-{r['ms'][2]:.4f}], plain "
            f"{r['plain_ms'][0]:.4f} ms, library (_weight_int8pack_mm) "
            f"{lib} [{lib_note}], bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}, HBM 3.35 TB/s, bf16 989 TF/s x {terms} "
            f"term{'s' if terms > 1 else ''}); {other}")
        rows[label] = r
        del qts, x
        torch.cuda.empty_cache()
    return {"quantized_matmul": rows[f"bf16 R={BATCH * BLOCK} [{M}, {F}]"]}


def time_quantized_fused_step(gen, dev):
    """K6 at the fused int8 path's step: x [256, 4096] bf16 (one term) on
    LLaDA-8B's untied int8 head [4096, 126464] (0.52 GB, two copies rotate
    so each launch streams it from HBM), and f32 x (three terms) beside
    it; the bound is the bf16 tensor rate times the terms. Beside it: its
    plain version, the unfused chain it replaces as the main path runs it
    (K5's float32 head on bf16 x, then K2) and :func:`head_yardsticks`.
    No single PyTorch call computes it."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.confidence import fused_confidence_kernel as k2
    from repro_torch.kernels.fused_step import \
        quantized_fused_step_kernel as k6
    from repro_torch.kernels.quantized_matmul import \
        quantized_matmul_kernel as k5
    from repro_torch.models.quantize import quantize_tensor

    R, M, V, copies = BATCH * BLOCK, 4096, 126464, 2
    qts = [quantize_tensor(torch.randn((M, V), generator=gen, device=dev)
                           * M ** -0.5, axis=-2) for _ in range(copies)]
    tau = torch.full((R,), 1e-4, device=dev)
    masked = torch.ones((R,), dtype=torch.bool, device=dev)
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((R, M), generator=gen, device=dev).to(dt)
        terms = 1 if dt == torch.bfloat16 else 3

        def run(i):
            qt = qts[i % copies]
            return k6(x, qt.q, qt.scale, tau, masked, tied=False)

        def plain(i):
            qt = qts[i % copies]
            return ref.quantized_fused_step_ref(x, qt.q, qt.scale, tau,
                                                masked, tied=False)

        def chain(i):
            qt = qts[i % copies]
            return k2(k5(x, qt.q, qt.scale, transpose=False,
                         out_dtype=torch.float32))

        r = dict(ms=cuda_ms(run, 10), plain_ms=cuda_ms(plain, 2),
                 library_ms=None,
                 bound=bound(M * V + 4 * V + R * M * x.element_size()
                             + R * (4 + 1 + 4 + 4 + 1), 2 * R * M * V * terms,
                             BF16_OPS_PER_S))
        unfused = cuda_ms(chain, 10)
        yf, yb = head_yardsticks(x, qts, copies)
        log(f"time quantized_fused_step R={R} [{M}, {V}] "
            f"{'bf16' if terms == 1 else 'f32'} x (graph replay, median of "
            f"5, {copies} head copies): kernel {r['ms'][0]:.4f} ms "
            f"[{r['ms'][1]:.4f}-{r['ms'][2]:.4f}], plain "
            f"{r['plain_ms'][0]:.4f} ms, unfused chain (K5 f32 head + K2) "
            f"{unfused[0]:.4f} ms [{unfused[1]:.4f}-{unfused[2]:.4f}], bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, bf16 989 TF/s x "
            f"{terms} term{'s' if terms > 1 else ''}); f32 cuBLAS on the "
            f"f32-dequantized head (TF32 off, the oracle's product): "
            f"{yf[0]:.4f} ms; bf16 cuBLAS on bf16(q) (the one-term product): "
            f"{yb[0]:.4f} ms")
        rows[dt] = r
        del x
    del qts
    torch.cuda.empty_cache()
    return {"quantized_fused_step": rows[torch.bfloat16]}


def time_flash_attention(gen, dev):
    """K7 at LLaDA-8B's full-forward attention, [8, 32, 256, 128] bf16
    (two copies rotate: 134 MB > L2), bidirectional and causal, beside
    its plain version and ``scaled_dot_product_attention`` (S == T, so
    SDPA's top-left causal mask is the oracle's bottom-right one). The
    bidirectional numbers are the kernel's row; the causal ones print."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import \
        flash_attention_kernel as k7

    B, H, S, D, copies = BATCH, 32, PROMPT + NEW, 128, 2
    qkv = [[torch.randn((B, H, S, D), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(3)] for _ in range(copies)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for causal in (False, True):
        def run(i, causal=causal):
            return k7(*qkv[i % copies], causal=causal)

        def plain(i, causal=causal):
            return ref.flash_attention_ref(*qkv[i % copies], causal=causal)

        def lib(i, causal=causal):
            return sdpa(*qkv[i % copies], is_causal=causal)

        with torch.no_grad():
            err = float((lib(0).float() - run(0).float()).abs().max())
        check(err < 0.05, "the SDPA yardstick computes the same attention")
        pairs = S * (S + 1) // 2 if causal else S * S
        r = dict(ms=cuda_ms(run, 50), plain_ms=cuda_ms(plain, 10),
                 library_ms=cuda_ms(lib, 50),
                 bound=bound(4 * B * H * S * D * 2, 4 * B * H * pairs * D,
                             BF16_OPS_PER_S))
        log(f"time flash_attention [{B}, {H}, {S}, {D}] bf16 causal={causal}"
            f" (graph replay, median of 5): kernel {r['ms'][0]:.4f} ms "
            f"[{r['ms'][1]:.4f}-{r['ms'][2]:.4f}], plain "
            f"{r['plain_ms'][0]:.4f} ms, SDPA {r['library_ms'][0]:.4f} ms "
            f"(max |SDPA - K7| {err:.3e}), bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")
        rows[causal] = r
    del qkv
    torch.cuda.empty_cache()
    return {"flash_attention": rows[False]}


KERNEL_META = {
    "block_attention": ("src/repro_torch/kernels/csrc/block_attention.cu",
                        "src/repro/kernels/block_attention.py:218"),
    "confidence": ("src/repro_torch/kernels/csrc/confidence.cu",
                   "src/repro/kernels/confidence.py:82"),
    "fused_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                   "src/repro/kernels/fused_step.py:144"),
    "paged_block_attention": (
        "src/repro_torch/kernels/csrc/block_attention.cu",
        "src/repro/kernels/block_attention.py:361"),
    "quantized_matmul": ("src/repro_torch/kernels/csrc/quantized_matmul.cu",
                         "src/repro/kernels/quantized_matmul.py:61"),
    "quantized_fused_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                             "src/repro/kernels/fused_step.py:184"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:68"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.block_attention import (
        cached_block_attention_kernel, paged_block_attention_kernel)
    from repro_torch.kernels.confidence import fused_confidence_kernel
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.fused_step import (fused_step_kernel,
                                                quantized_fused_step_kernel)
    from repro_torch.kernels.quantized_matmul import quantized_matmul_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(card)
    t0 = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t0
    log(f"kernel build: {secs:.1f}s for {sorted(logs)}")
    for name, text in logs.items():
        fn = ""
        for line in text.splitlines():
            if "Compiling entry function" in line and "'" in line:
                fn = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                            line.split("'")[1])[:96]
            elif "registers" in line or "spill" in line or "C75" in line:
                log(f"  {name} {fn}: {line.strip()}")

    kernels = {"block_attention": cached_block_attention_kernel,
               "confidence": fused_confidence_kernel,
               "fused_step": fused_step_kernel,
               "paged_block_attention": paged_block_attention_kernel,
               "quantized_matmul": quantized_matmul_kernel,
               "quantized_fused_step": quantized_fused_step_kernel,
               "flash_attention": flash_attention_kernel}
    t0 = time.perf_counter()
    errs = check_kernels(dev)
    log(f"kernel checks passed ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    counts = main_path(dev, kernels)
    log(f"main path done ({time.perf_counter() - t0:.1f}s)")
    check(all(c > 0 for c in counts.values()), "every kernel launched")
    reduced_reference_check(dev)
    timing = time_kernels(dev)

    rows = []
    for name, (source, replaces) in KERNEL_META.items():
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": errs[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                     "bound_by": t["bound"][1],
                     "library_ms": t["library_ms"]})
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
