"""The port's step-sliced serving loop (``Scheduler.slice_step`` and
``run`` with ``EngineConfig.slice_len >= 1``, ``DiffusionEngine``,
``launch/serve.py --slice-len``) against its own batch-boundary path and
against the JAX reference's sliced scheduler on the same weights and
request streams.

Covers: sliced responses equal to the batch path's; a request admitted
mid-generation decoding as in a fresh batch (dense and paged); pages
given back at the slice boundary a row retires at; the slice-granular
latency split; calibration equal to the batch path's; the shared prefix;
a failed slice requeued and retried; and, on staggered streams, the
reference's responses, integer ``EngineStats`` and trace events. CPU,
float32, the reduced LLaDA-8B."""
import dataclasses
import pathlib
import re
import sys

import jax
import numpy as np
import pytest

from repro.checkpoint.checkpoint import save
from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.base import EngineConfig as JEngineConfig
from repro.config.registry import get_config as jax_get_config
from repro.core.osdt import CalibrationStore as JCalibrationStore
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import convert
from repro_torch.config.base import DecodeConfig, EngineConfig
from repro_torch.config.registry import get_config
from repro_torch.core.osdt import CalibrationStore
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import TASKS
from repro_torch.launch import serve
from repro_torch.obs import validate_trace
from repro_torch.serving.engine import DiffusionEngine
from repro_torch.serving.scheduler import _STATS_FIELDS, Request, Scheduler

ROOT = pathlib.Path(__file__).resolve().parents[1]
DK = dict(max_new_tokens=16, block_size=4, policy="osdt", mode="block",
          metric="q1", cap=0.9, slack=0.1, threshold=0.9, page_size=4)
P_LEN = 16
NB = DecodeConfig(**DK).num_blocks
TASK_NAMES = ("gsm8k-syn", "gpqa-syn", "humaneval-syn")
INT_STATS = [n for n, (typ, _) in _STATS_FIELDS.items() if typ is int]
SHARED = "answer briefly answer briefly "


@pytest.fixture(scope="module")
def models():
    kw = dict(num_layers=2, max_d_model=128, vocab_size=tok.VOCAB)
    jc = dataclasses.replace(jax_get_config("llada-8b").reduced(**kw),
                             mask_token_id=tok.MASK_ID)
    tc = dataclasses.replace(get_config("llada-8b").reduced(**kw),
                             mask_token_id=tok.MASK_ID)
    jp = JM.init_params(jax.random.key(0), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jc, tc, jp, tp


def _stream(n, *, seed=0, base=0):
    """``n`` requests from the task generators, the three tasks
    interleaved: (uid, task, prompt) tuples."""
    rng = np.random.default_rng(seed)
    per = {t: TASKS[t].make(rng, -(-n // 3)) for t in TASK_NAMES}
    return [(base + i, TASK_NAMES[i % 3], per[TASK_NAMES[i % 3]][i // 3]
             .prompt) for i in range(n)]


@pytest.fixture(scope="module")
def store_path(models, tmp_path_factory):
    """A store that the port's batch engine calibrated on all three
    tasks, saved as npz: each engine loads it afresh (both packages read
    the same file)."""
    _, tc, _, tp = models
    eng = DiffusionEngine(tp, tc, DecodeConfig(**DK),
                          ecfg=EngineConfig(batch_size=3, prompt_len=P_LEN))
    eng.submit([Request(*r) for r in _stream(3, seed=99, base=900)])
    assert eng.store.tasks() == sorted(TASK_NAMES)
    path = str(tmp_path_factory.mktemp("store") / "calib.npz")
    eng.store.save(path)
    return path


def _sched(models, path=None, *, dk=None, **ek):
    _, tc, _, tp = models
    dcfg = DecodeConfig(**dict(DK, **(dk or {})))
    kw = dict(dict(batch_size=2, prompt_len=P_LEN, slice_len=1), **ek)
    store = CalibrationStore.load(path, dcfg) if path else None
    return Scheduler(tp, tc, dcfg, ecfg=EngineConfig(**kw), store=store)


def _reqs(stream):
    return [Request(*r) for r in stream]


def _drain(s):
    out = []
    while s.queue or any(sl.state == "active" for sl in s.slots):
        out.extend(s.slice_step())
    return out


@pytest.mark.parametrize("dk,ek", [
    (dict(), dict(attn_impl="kernel")),
    (dict(cache_layout="paged"), dict(attn_impl="kernel")),
    (dict(step_fusion="fused"), dict(attn_impl="kernel")),
    (dict(cache_layout="paged"), dict(cache_mode="dual")),
    (dict(), dict(cache_mode="none")),
    (dict(weight_dtype="int8", step_fusion="fused"),
     dict(attn_impl="kernel"))])
def test_sliced_matches_batch_path(models, store_path, dk, ek):
    """All requests admitted at once: the sliced runtime answers as the
    batch runtime does, with the same NFE and delivered tokens."""
    reqs = _stream(4)
    ref = _sched(models, store_path, dk=dk, batch_size=4, slice_len=0, **ek)
    ref.submit(_reqs(reqs))
    want = {r.uid: r for r in ref.run()}
    sl = _sched(models, store_path, dk=dk, batch_size=4, slice_len=1, **ek)
    sl.submit(_reqs(reqs))
    got = {r.uid: r for r in sl.run()}
    assert got.keys() == want.keys()
    for uid, r in got.items():
        assert (r.text, r.nfe, r.tokens_out) == \
            (want[uid].text, want[uid].nfe, want[uid].tokens_out), uid
    assert sl.stats.tokens == ref.stats.tokens
    assert sl.stats.nfe == ref.stats.nfe
    assert sl.stats.weight_bytes_streamed == ref.stats.weight_bytes_streamed
    assert sl.stats.slices >= NB and sl.stats.batches == 0
    assert sl._carry is None   # torn down once the queue drained


@pytest.mark.parametrize("dk", [dict(), dict(cache_layout="paged")])
def test_mid_loop_admission_matches_fresh_batch(models, store_path, dk):
    """A request admitted mid-generation decodes to the tokens it gets in
    a fresh batch: per-row cursors, per-row prefill, per-row extents."""
    first, late = _stream(2)
    mid = _sched(models, store_path, dk=dk, attn_impl="kernel")
    mid.submit(_reqs([first]))
    out = list(mid.slice_step())             # the first row starts
    mid.submit(_reqs([late]))                # arrives mid-generation
    out += _drain(mid)
    got = {r.uid: r for r in out}
    assert mid.stats.mid_admits == 1
    fresh = _sched(models, store_path, dk=dk, attn_impl="kernel")
    fresh.submit(_reqs([late]))
    want = {r.uid: r for r in _drain(fresh)}
    assert (got[late[0]].text, got[late[0]].nfe) == \
        (want[late[0]].text, want[late[0]].nfe)


def test_mid_loop_retirement_frees_pages(models, store_path):
    """A retired row's private pages return to the allocator at the slice
    boundary while the other row still decodes."""
    a, b = _stream(2)
    s = _sched(models, store_path, dk=dict(cache_layout="paged"),
               attn_impl="kernel", eos_early_exit=False)
    s.submit(_reqs([a]))
    s.slice_step()                            # a: one block ahead
    s.submit(_reqs([b]))
    s.slice_step()                            # b admitted mid-generation
    per_slot = s.private_per_slot
    assert s.allocator.in_use == 2 * per_slot
    freed_mid = False
    while s.queue or any(sl.state == "active" for sl in s.slots):
        s.slice_step()
        if sum(sl.state == "active" for sl in s.slots) == 1:
            assert s.allocator.in_use == per_slot
            # the retired row's page-table row is unmapped in the carry
            assert bool((s._carry.cache["attn"]["pt"] < 0).all(dim=1)
                        .any())
            freed_mid = True
    assert freed_mid
    assert s.allocator.in_use == 0
    assert s.stats.pages_freed == 2 * per_slot


def test_pages_gate_admission(models, store_path):
    """A pool with room for one request admits the second only once the
    first retires, and reuses its pages."""
    s0 = _sched(models, store_path, dk=dict(cache_layout="paged"))
    s = _sched(models, store_path, dk=dict(cache_layout="paged"),
               num_pages=s0.private_per_slot)
    s.submit(_reqs(_stream(3)))
    out = s.run()
    assert sorted(r.uid for r in out) == [0, 1, 2]
    assert s.stats.mid_admits == 0 and s.stats.pages_peak == \
        s0.private_per_slot and s.allocator.in_use == 0


def test_sliced_latency_accounting(models, store_path):
    """ttfb is taken at the first slice boundary a row decoded a block
    in, and a mid-batch admission is charged only the slices it decoded
    in, not the whole wall."""
    a, b = _stream(2)
    s = _sched(models, store_path, eos_early_exit=False)
    s.submit(_reqs([a]))
    out = list(s.slice_step())
    s.submit(_reqs([b]))
    out += _drain(s)
    got = {r.uid: r for r in out}
    total = s.stats.wall_s
    for r in got.values():
        assert r.ttfb_s > 0.0
        assert r.wall_s == pytest.approx(r.queue_s + r.decode_s)
        assert r.decode_s <= total + 1e-9
    assert got[b[0]].decode_s < total
    assert s.stats.ttfb_s == pytest.approx(sum(r.ttfb_s
                                               for r in got.values()))
    assert s.obs.registry.histogram("dispatch_seconds").snapshot()
    assert s.stats.slices == NB + 1


def test_sliced_calibration_matches_batch(models):
    """An uncalibrated task's first request calibrates the same table
    under the sliced runtime (the same recording, ingested at its
    retirement), and the claim is released."""
    reqs = _stream(3)
    a = _sched(models, slice_len=0, batch_size=3)
    a.submit(_reqs(reqs))
    a.run()
    b = _sched(models, slice_len=1, batch_size=3)
    b.submit(_reqs(reqs))
    b.run()
    assert b.store.tasks() == sorted(TASK_NAMES) and not b._calibrating
    for t in TASK_NAMES:
        np.testing.assert_array_equal(a.store.tables[t], b.store.tables[t])


def test_sliced_shared_prefix_matches_batch(models, store_path):
    """Paged with a shared system prompt: the admission encodes only the
    per-row remainder against the shared pages; the same responses as the
    batch engine, a mid-generation admission included, and only the
    shared pages stay allocated."""
    a, b = _stream(2)
    kw = dict(dk=dict(cache_layout="paged"), shared_prefix=SHARED,
              attn_impl="kernel")
    ref = _sched(models, store_path, slice_len=0, **kw)
    assert ref.shared_len > 0
    ref.submit(_reqs([a, b]))
    want = {r.uid: r for r in ref.run()}
    sl = _sched(models, store_path, **kw)
    sl.submit(_reqs([a]))
    out = list(sl.slice_step())
    sl.submit(_reqs([b]))
    out += _drain(sl)
    got = {r.uid: r for r in out}
    for uid in want:
        assert (got[uid].text, got[uid].nfe) == (want[uid].text,
                                                 want[uid].nfe), uid
    assert sl.stats.mid_admits == 1
    assert sl.allocator.in_use == len(sl._shared_pages)
    assert sl.stats.prefill_nfe == 1 + 2   # shared prefix + two admits


def test_failed_slice_requeues_and_retries_cleanly(models):
    """A slice that raises swallows no request, leaks no page, counts
    nothing twice and releases its calibration claim: a retried run()
    serves every uid and still calibrates the task."""
    s = _sched(models, dk=dict(cache_layout="paged"))
    real = s._slice_fn
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected slice failure")
        return real(*a, **kw)

    s._slice_fn = flaky
    s.submit(_reqs(_stream(2)))
    with pytest.raises(RuntimeError, match="injected"):
        s.slice_step()
    assert s.allocator.in_use == 0 and s._carry is None
    assert s.pending() == 2 and s.stats.requests == 0
    assert not s._calibrating
    assert sorted(rs.req.uid for rs in s.queue) == [0, 1]
    out = s.run()
    assert sorted(r.uid for r in out) == [0, 1]
    assert s.stats.requests == 2 and s.store.calibrated(TASK_NAMES[0])


@pytest.mark.parametrize("dk", [dict(), dict(cache_layout="paged")])
def test_failed_admission_requeues_and_retries_cleanly(models, store_path,
                                                       dk):
    """An admission prefill that raises mid-generation is handled as a
    failed slice: the admitted row and the row already decoding go back to
    the queue in FIFO order with their counts, pages and carry backed out,
    and the retried run() answers as a clean one does (no row decodes
    against a cache its admission never wrote)."""
    first, late = _stream(2)
    s = _sched(models, store_path, dk=dk, attn_impl="kernel")
    real = s._admit_fn
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected admission failure")
        return real(*a, **kw)

    s._admit_fn = flaky
    s.submit(_reqs([first]))
    assert s.slice_step() == []               # first: one block decoded
    s.submit(_reqs([late]))
    with pytest.raises(RuntimeError, match="injected"):
        s.slice_step()
    assert s._carry is None and not s._calibrating
    assert all(sl.state == "free" for sl in s.slots)
    assert [rs.req.uid for rs in s.queue] == [first[0], late[0]]
    assert s.stats.requests == 0 and s.stats.mid_admits == 0
    if s.paged:
        assert s.allocator.in_use == 0
    got = {r.uid: r for r in s.run()}
    assert s.stats.requests == 2 and s.stats.mid_admits == 0
    clean = _sched(models, store_path, dk=dk, attn_impl="kernel")
    clean.submit(_reqs([first, late]))
    want = {r.uid: r for r in clean.run()}
    assert got.keys() == want.keys()
    for uid, r in got.items():
        assert (r.text, r.nfe) == (want[uid].text, want[uid].nfe), uid


# ---------------------------------------------------------------------------
# against the reference's sliced scheduler
# ---------------------------------------------------------------------------

def _both(models, path, dk, ek):
    jc, tc, jp, tp = models
    dk = dict(DK, **dk)
    ek = dict(dict(batch_size=3, prompt_len=P_LEN, slice_len=1), **ek)
    stores = ((JCalibrationStore.load(path, JDecodeConfig(**dk)),
               CalibrationStore.load(path, DecodeConfig(**dk)))
              if path else (None, None))
    js = JScheduler(jp, jc, JDecodeConfig(**dk), ecfg=JEngineConfig(**ek),
                    store=stores[0])
    ts = Scheduler(tp, tc, DecodeConfig(**dk), ecfg=EngineConfig(**ek),
                   store=stores[1])
    return js, ts


def _staggered(s, req, stream):
    """Two requests, one slice, then the rest into three slots: rows sit
    at different cursors and are admitted mid-decode."""
    s.submit([req(*r) for r in stream[:2]])
    out = list(s.slice_step())
    s.submit([req(*r) for r in stream[2:]])
    return sorted(out + s.run(), key=lambda r: r.uid)


@pytest.mark.parametrize("dk,ek,calibrated", [
    (dict(cache_layout="paged"), dict(attn_impl="kernel",
                                      shared_prefix=SHARED), True),
    (dict(step_fusion="fused"), dict(attn_impl="kernel", slice_len=2),
     True),
    (dict(cache_layout="paged"), dict(cache_mode="dual"), True),
    (dict(), dict(attn_impl="kernel", trace=True), False)])
def test_sliced_scheduler_matches_reference(models, store_path, dk, ek,
                                            calibrated):
    """A staggered stream of ten requests: the reference's responses and
    integer stats, field for field (tasks calibrating mid-stream in the
    uncalibrated case), and with ``trace=True`` the reference's trace
    events (name, phase, track, ids and arguments) in its order."""
    js, ts = _both(models, store_path if calibrated else None, dk, ek)
    stream = _stream(10, seed=4)
    jo = _staggered(js, JRequest, stream)
    to = _staggered(ts, Request, stream)
    assert [r.uid for r in to] == [r.uid for r in jo] == list(range(10))
    for a, b in zip(jo, to):
        assert (b.task, b.text, b.nfe, b.tokens_out, b.tokens_dropped) == \
            (a.task, a.text, a.nfe, a.tokens_out, a.tokens_dropped), a.uid
    for name in INT_STATS:
        assert getattr(ts.stats, name) == getattr(js.stats, name), name
    assert ts.stats.mid_admits > 0 and ts.stats.slices >= NB
    if not calibrated:
        assert ts.store.tasks() == sorted(TASK_NAMES)
        for t in TASK_NAMES:
            np.testing.assert_allclose(ts.store.tables[t],
                                       js.store.tables[t], rtol=0,
                                       atol=1e-5)
    if ek.get("trace"):
        jdoc, tdoc = js.obs.tracer.export(), ts.obs.tracer.export()
        validate_trace(tdoc)
        strip = (lambda doc: [{k: v for k, v in e.items() if k != "ts"}
                              for e in doc["traceEvents"]])
        assert strip(tdoc) == strip(jdoc)
        names = {e["name"] for e in tdoc["traceEvents"]}
        assert {"slice", "admit_prefill", "serve", "request"} <= names


def test_failed_slice_trace_matches_reference(models, store_path):
    """A slice that fails once: the reference's ``slice_failed`` instant,
    requeue spans and stats, then the same responses on the retry."""
    js, ts = _both(models, store_path, dict(cache_layout="paged"),
                   dict(attn_impl="kernel", trace=True))
    outs = []
    for s, req in ((js, JRequest), (ts, Request)):
        real = s._slice_fn
        s._slice_fn = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("injected slice failure"))
        s.submit([req(*r) for r in _stream(4, seed=5)])
        with pytest.raises(RuntimeError, match="injected"):
            s.slice_step()
        s._slice_fn = real
        outs.append(sorted(s.run(), key=lambda r: r.uid))
    for a, b in zip(*outs):
        assert (a.uid, a.text, a.nfe) == (b.uid, b.text, b.nfe)
    for name in INT_STATS:
        assert getattr(ts.stats, name) == getattr(js.stats, name), name
    strip = (lambda doc: [{k: v for k, v in e.items() if k != "ts"}
                          for e in doc["traceEvents"]])
    tdoc = ts.obs.tracer.export()
    assert strip(tdoc) == strip(js.obs.tracer.export())
    assert "slice_failed" in {e["name"] for e in tdoc["traceEvents"]}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = serve.bench_config()
    jcfg = jax_get_config("llada-8b").reduced(num_layers=4, max_d_model=256,
                                              vocab_size=512)
    assert (jcfg.num_layers, jcfg.d_model, jcfg.vocab_size) == \
        (cfg.num_layers, cfg.d_model, cfg.vocab_size)
    path = str(tmp_path_factory.mktemp("ckpt") / "bench.msgpack")
    save(path, JM.init_params(jax.random.key(5), jcfg), meta={"steps": 0})
    return path


def _masked(out):
    """Lines without their host-clock numbers (tokens/s, p95 waits)."""
    out = re.sub(r"tokens/s=[0-9.]+", "tokens/s=*", out)
    return re.sub(r"p95 [0-9.]+ms", "p95 *ms", out).splitlines()


def test_serve_sliced_prints_the_reference_lines(ckpt, monkeypatch, capsys):
    """``serve.py --slice-len 1 --device cpu`` (paged, with a shared
    prefix) runs, answers every request, and prints the reference
    launcher's lines, its ``# sliced`` summary included."""
    args = ["--ckpt", ckpt, "--n", "6", "--max-new", "16", "--slice-len",
            "1", "--cache-layout", "paged", "--shared-prefix",
            "System: you answer in one short line. "]
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jax_serve.main()
    want = capsys.readouterr().out
    serve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    lines = got.splitlines()
    assert lines[1].startswith("# 6 requests")
    assert any(line.startswith("# sliced: ") for line in lines)
