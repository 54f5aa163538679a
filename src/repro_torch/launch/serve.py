"""Serving launcher: batched OSDT diffusion serving of a checkpoint, the
port's counterpart of ``python -m repro.launch.serve`` with the same flags,
plus ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --ckpt experiments/bench_model.msgpack --policy osdt --n 16

It answers on CUDA unless ``--device cpu`` is given, and raises without
CUDA otherwise. The checkpoint is the reference's msgpack file (read by
``convert.load_checkpoint``), for the bench configuration. The flags of
serving features the port lacks (``--spec-decode``,
``--draft-max-steps`` other than 1, ``--prefix-cache``, a non-zero
``--prefix-cache-pages`` or ``--prefix-cache-watermark``,
``--data-parallel`` / ``--model-parallel`` > 1) raise
``NotImplementedError`` before the checkpoint is read.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import convert
from repro_torch.config.base import DecodeConfig, EngineConfig, ModelConfig
from repro_torch.config.registry import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import TASKS
from repro_torch.device import resolve_device
from repro_torch.serving.engine import DiffusionEngine, Request
from repro_torch.serving.scheduler import check_ported


def bench_config() -> ModelConfig:
    """The reference's bench model (``benchmarks/common.py``): LLaDA-8B
    reduced to 4 layers, d 256, vocab 512, on the byte tokenizer's mask."""
    cfg = get_config("llada-8b").reduced(num_layers=4, max_d_model=256,
                                         vocab_size=512)
    return dataclasses.replace(cfg, name="llada-bench",
                               mask_token_id=tok.MASK_ID)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="experiments/bench_model.msgpack")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on: cuda (the default; raises "
                         "without CUDA) or cpu")
    ap.add_argument("--policy", default="osdt",
                    choices=["static", "factor", "osdt"])
    ap.add_argument("--task", default="gsm8k-syn", choices=list(TASKS))
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--cache-mode", default="prefix",
                    choices=["prefix", "dual", "none"])
    ap.add_argument("--cache-layout", default="dense",
                    choices=["dense", "paged"],
                    help="paged: page-pool KV with per-slot page tables — "
                         "dead slots pin zero pages (SERVING.md)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="cache slots per page (paged layout)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool capacity; 0 = auto-size for the batch")
    ap.add_argument("--shared-prefix", default="",
                    help="system prompt prefilled once into refcounted "
                         "shared pages and mapped into every slot")
    ap.add_argument("--store", default="",
                    help="npz path persisting per-task calibration across "
                         "restarts (SERVING.md)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative block drafting (not ported: raises)")
    ap.add_argument("--draft-max-steps", type=int, default=1,
                    help="draft blocks predicted to clear in <= this many "
                         "steps (spec decode; not ported: other than 1 raises)")
    ap.add_argument("--slice-len", type=int, default=0,
                    help="step-sliced decode loop: decode N blocks per "
                         "slice and admit queued requests into freed slots "
                         "mid-generation (0 = batch-boundary admission, "
                         "SERVING.md 'Async admission')")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix cache (not ported: raises)")
    ap.add_argument("--prefix-cache-pages", type=int, default=0,
                    help="page budget the tree may pin (prefix cache; "
                         "not ported: non-zero raises)")
    ap.add_argument("--prefix-cache-watermark", type=float, default=0.0,
                    help="fraction of the pool eviction keeps free "
                         "(prefix cache; not ported: non-zero raises)")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="slot-pool shards (> 1 is not ported: raises)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel decode (> 1 is not ported: "
                         "raises)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run here (enables the ring-buffer tracer; "
                         "SERVING.md 'Observability')")
    ap.add_argument("--trace-capacity", type=int, default=1 << 16,
                    help="trace ring size in events (oldest evicted)")
    ap.add_argument("--metrics", default="",
                    help="write a Prometheus text-exposition snapshot of "
                         "the engine's metrics registry here ('-' = stdout)")
    ap.add_argument("--metrics-json", default="",
                    help="write the full JSON snapshot (metrics + drift + "
                         "measured dispatch timing) here")
    ap.add_argument("--drift", action="store_true",
                    help="confidence-drift telemetry: score each retiring "
                         "row's live trajectory against the task's stored "
                         "calibration profile and flag staleness")
    args = ap.parse_args(argv)

    dcfg = DecodeConfig(max_new_tokens=args.max_new, block_size=args.block,
                        policy=args.policy, threshold=0.9, mode="block",
                        metric="q1", cap=0.9, slack=0.1,
                        cache_layout=args.cache_layout,
                        page_size=args.page_size)
    ecfg = EngineConfig(batch_size=args.batch, prompt_len=64,
                        cache_mode=args.cache_mode, store_path=args.store,
                        num_pages=args.num_pages,
                        shared_prefix=args.shared_prefix,
                        spec_decode=args.spec_decode,
                        draft_max_steps=args.draft_max_steps,
                        slice_len=args.slice_len,
                        data_parallel=args.data_parallel,
                        model_parallel=args.model_parallel,
                        prefix_cache=args.prefix_cache,
                        prefix_cache_pages=args.prefix_cache_pages,
                        prefix_cache_watermark=args.prefix_cache_watermark,
                        trace=bool(args.trace_out),
                        trace_capacity=args.trace_capacity,
                        drift_telemetry=args.drift)
    check_ported(ecfg)
    device = resolve_device(args.device)
    cfg = bench_config()
    params, meta = convert.load_checkpoint(args.ckpt, device=device)
    print(f"# loaded {args.ckpt} (meta={meta})")

    engine = DiffusionEngine(params, cfg, dcfg, ecfg=ecfg)
    rng = np.random.default_rng(0)
    samples = TASKS[args.task].make(rng, args.n)
    reqs = [Request(i, args.task, s.prompt) for i, s in enumerate(samples)]
    out = engine.submit(reqs)
    hits = sum(TASKS[args.task].score(r.text, s)
               for r, s in zip(out, samples))
    st = engine.stats
    print(f"# {st.requests} requests  acc={hits / len(samples):.2f}  "
          f"tokens/s={st.tokens_per_s:.1f}  NFE={st.nfe}  "
          f"tokens/NFE={st.tokens_per_nfe:.2f}")
    if st.page_capacity:
        print(f"# pages: capacity={st.page_capacity} "
              f"peak={st.pages_peak} ({st.page_util:.0%}) "
              f"shared={st.pages_shared} freed={st.pages_freed}")
    if st.slices:
        q = [r.queue_s for r in out]
        ttfb = [r.ttfb_s for r in out]
        print(f"# sliced: {st.slices} slices, {st.mid_admits} "
              f"mid-generation admits, queue p95 "
              f"{np.percentile(q, 95) * 1e3:.1f}ms, ttfb p95 "
              f"{np.percentile(ttfb, 95) * 1e3:.1f}ms")
    obs = engine.obs
    if args.drift and obs.drift is not None:
        for task, row in sorted(obs.drift.snapshot().items()):
            print(f"# drift[{task}]: cosine={row['cosine']:.4f} "
                  f"score={row['drift']:.4f} stale={row['stale']} "
                  f"obs={row['observations']} "
                  f"fallback={row['fallback_frac']:.2f} "
                  f"margin={row['margin_mean']:.3f}")
    if args.trace_out:
        obs.save_trace(args.trace_out)
        print(f"# trace: {len(obs.tracer.events())} events -> "
              f"{args.trace_out}"
              + (f" ({obs.tracer.dropped} dropped)"
                 if obs.tracer.dropped else ""))
    if args.metrics:
        text = obs.prometheus()
        if args.metrics == "-":
            print(text, end="")
        else:
            with open(args.metrics, "w") as f:
                f.write(text)
            print(f"# metrics: {args.metrics}")
    if args.metrics_json:
        import json
        with open(args.metrics_json, "w") as f:
            json.dump(obs.snapshot(), f, indent=1, sort_keys=True)
        print(f"# metrics json: {args.metrics_json}")
    for r in out[:3]:
        print(f"  [{r.uid}] {r.text!r}")


if __name__ == "__main__":
    main()
