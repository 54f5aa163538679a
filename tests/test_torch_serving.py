"""The port's serving engine (``repro_torch.serving``) against the JAX
reference's ``DiffusionEngine`` on the same request streams and the same
weights (``convert.params_from_numpy``): responses must have equal text,
NFE, delivered and dropped token counts, and every integer
``EngineStats`` field must be equal. Covers mixed tasks on a calibrated
store (prefix, dual, none), several tasks calibrating in one batch, EOS
early exit and dead slots, the paged layout over batches that reuse
freed pages (with and without a shared prefix), ``Request.prefix`` rows,
the int8 engine, a failed batch, store persistence across packages and
the features that still raise. CPU, float32, the reduced LLaDA-8B."""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest

from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.base import EngineConfig as JEngineConfig
from repro.config.registry import get_config as jax_get_config
from repro.core.osdt import CalibrationStore as JCalibrationStore
from repro.models import model as JM
from repro.serving.engine import DiffusionEngine as JDiffusionEngine
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import RequestState as JRequestState
from repro_torch import convert
from repro_torch.config.base import DecodeConfig, EngineConfig
from repro_torch.config.registry import get_config
from repro_torch.core.osdt import CalibrationStore
from repro_torch.data import tokenizer as tok
from repro_torch.data.tasks import TASKS
from repro_torch.models.quantize import decode_weight_bytes
from repro_torch.serving.engine import DiffusionEngine
from repro_torch.serving.scheduler import (_STATS_FIELDS, Request,
                                           RequestState)

DK = dict(max_new_tokens=16, block_size=4, policy="osdt", mode="block",
          metric="q1", cap=0.9, slack=0.1, threshold=0.9, page_size=8)
P_LEN = 16
TASK_NAMES = ("gsm8k-syn", "gpqa-syn", "humaneval-syn")
INT_STATS = [n for n, (typ, _) in _STATS_FIELDS.items() if typ is int]
SHARED = "System: you answer in one short line. "


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


def _stream(n, *, seed=0, base=0, prefix=""):
    """``n`` requests from the task generators, the three tasks
    interleaved: (uid, task, prompt, prefix) tuples."""
    rng = np.random.default_rng(seed)
    per = {t: TASKS[t].make(rng, -(-n // 3)) for t in TASK_NAMES}
    return [(base + i, TASK_NAMES[i % 3], per[TASK_NAMES[i % 3]][i // 3]
             .prompt, prefix) for i in range(n)]


def _engines(models, *, dk=None, ek=None, stores=(None, None),
             eos_id=tok.EOS_ID):
    jc, tc, jp, tp = models
    dk = dict(DK, **(dk or {}))
    ek = dict(dict(batch_size=4, prompt_len=P_LEN), **(ek or {}))
    je = JDiffusionEngine(jp, jc, JDecodeConfig(**dk),
                          ecfg=JEngineConfig(**ek), store=stores[0],
                          eos_id=eos_id)
    te = DiffusionEngine(tp, tc, DecodeConfig(**dk), ecfg=EngineConfig(**ek),
                         store=stores[1], eos_id=eos_id)
    return je, te


def _submit(je, te, stream):
    jo = je.submit([JRequest(*r) for r in stream])
    to = te.submit([Request(*r) for r in stream])
    return jo, to


def _assert_same(je, jo, te, to):
    assert [r.uid for r in to] == [r.uid for r in jo]
    for a, b in zip(jo, to):
        assert (b.task, b.text, b.nfe, b.tokens_out, b.tokens_dropped) == \
            (a.task, a.text, a.nfe, a.tokens_out, a.tokens_dropped), a.uid
    for name in INT_STATS:
        assert getattr(te.stats, name) == getattr(je.stats, name), name


@pytest.fixture(scope="module")
def store_path(models, tmp_path_factory):
    """A store calibrated by the reference engine on all three tasks,
    saved as npz: each test loads it afresh into both packages, so both
    engines start from the same tables bit for bit."""
    je, _ = _engines(models)
    je.submit([JRequest(*r) for r in _stream(3, seed=99, base=900)])
    assert je.store.tasks() == sorted(TASK_NAMES)
    path = str(tmp_path_factory.mktemp("store") / "calib.npz")
    je.store.save(path)
    return path


def _stores(path, dk=None):
    dk = dict(DK, **(dk or {}))
    return (JCalibrationStore.load(path, JDecodeConfig(**dk)),
            CalibrationStore.load(path, DecodeConfig(**dk)))


@pytest.mark.parametrize("cache_mode", ["prefix", "dual", "none"])
def test_mixed_tasks_on_calibrated_store(models, store_path, cache_mode):
    attn = "" if cache_mode == "none" else "kernel"
    je, te = _engines(models, ek=dict(cache_mode=cache_mode, attn_impl=attn),
                      stores=_stores(store_path))
    jo, to = _submit(je, te, _stream(10))
    _assert_same(je, jo, te, to)
    assert te.stats.batches == 3 and te.stats.dead_slots == 2
    assert te.stats.requests == 10
    assert te.stats.tokens == sum(r.tokens_out for r in to)
    assert te.mesh is None
    assert sorted(te.sessions) == sorted(TASK_NAMES)


def test_several_tasks_calibrate_in_one_batch(models):
    """Batch 1 holds the first request of every task: each calibrates
    from its own row; batch 2 decodes on the three tables."""
    je, te = _engines(models, dk=dict(step_fusion="fused"),
                      ek=dict(attn_impl="kernel"))
    stream = _stream(6, seed=1)
    jo, to = _submit(je, te, stream)
    _assert_same(je, jo, te, to)
    assert te.store.tasks() == je.store.tasks() == sorted(TASK_NAMES)
    for t in TASK_NAMES:
        np.testing.assert_allclose(te.store.tables[t], je.store.tables[t],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(te.store.profiles[t].steps,
                                      je.store.profiles[t].steps)
    assert te.stats.batches == 2 and te.stats.dead_slots == 2


def test_eos_early_exit_and_dead_slots(models, store_path):
    """An EOS byte that the rows emit truncates their responses and
    retires them early; 5 requests in batches of 4 leave 3 dead slots."""
    stream = _stream(5, seed=2)
    je, te = _engines(models, ek=dict(eos_early_exit=False),
                      stores=_stores(store_path))
    base = te.submit([Request(*r) for r in stream])
    eos = next(ord(c) for r in base for c in r.text if ord(c) < 128)
    je, te = _engines(models, stores=_stores(store_path), eos_id=eos)
    jo, to = _submit(je, te, stream)
    _assert_same(je, jo, te, to)
    assert any(r.tokens_out < DK["max_new_tokens"] for r in to)
    assert sum(r.nfe for r in to) <= sum(r.nfe for r in base)
    assert te.stats.dead_slots == 3 and te.stats.batches == 2
    assert te.stats.tokens + te.stats.tokens_dropped == \
        5 * DK["max_new_tokens"]


def _record_batches(sched):
    """``chip_smoke.record_batches``: the one recorder of the scheduler's
    generate calls (inputs, page table and result of each batch)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.record_batches(sched)


@pytest.mark.parametrize("shared", ["", SHARED])
def test_paged_batches_reuse_freed_pages(models, store_path, shared):
    """Three paged batches (4, 4 and 2 live rows): later batches decode
    over pages earlier rows freed, with the reference's tokens, page
    stats and no leaked page."""
    je, te = _engines(models, dk=dict(cache_layout="paged"),
                      ek=dict(prompt_len=32, attn_impl="kernel",
                              shared_prefix=shared),
                      stores=_stores(store_path))
    calls = _record_batches(te.scheduler)
    jo, to = _submit(je, te, _stream(10, seed=3))
    _assert_same(je, jo, te, to)
    n_shared = te.scheduler.shared_len // DK["page_size"]
    assert n_shared == (3 if shared else 0)
    assert te.stats.pages_shared == n_shared
    assert te.stats.page_capacity == \
        n_shared + 4 * te.scheduler.private_per_slot
    for s in (je.scheduler, te.scheduler):
        assert s.allocator.in_use == n_shared
    tables = [c["pt"] for c in calls]
    first = set(tables[0][tables[0] >= 0].tolist())
    second = set(tables[1][tables[1] >= 0].tolist())
    assert first == second  # the second batch reuses every freed page
    assert (tables[2][2:] == -1).all()  # dead slots map no pages


@pytest.mark.parametrize("layout,shared", [("dense", ""),
                                           ("paged", SHARED)])
def test_request_prefix_rows(models, store_path, layout, shared):
    """``Request.prefix`` selects the prefix-layout row (the prefix
    left-anchored to a page boundary, the prompt right-aligned)."""
    je, te = _engines(models, dk=dict(cache_layout=layout),
                      ek=dict(prompt_len=32, shared_prefix=shared),
                      stores=_stores(store_path))
    stream = _stream(4, seed=4, prefix="Tenant A: reply with digits. ")
    jo, to = _submit(je, te, stream)
    _assert_same(je, jo, te, to)
    row = te.scheduler._prompt_row(RequestState(Request(*stream[0]), 0.0))
    assert row == je.scheduler._prompt_row(
        JRequestState(JRequest(*stream[0]), 0.0))
    # the cacheable stream (30 ids) is left-anchored up to its page
    # boundary (24), the capped prompt takes the rest of the row
    pfx = tok.encode(shared + stream[0][3], bos=True)
    assert row[:24] == pfx[:24] and row[24:] == tok.encode(
        shared + stream[0][3] + stream[0][2])[-8:]


def test_int8_engine(models, store_path):
    """``weight_dtype="int8"``: both engines quantize their params once
    at construction (bitwise the same) and serve through the fused int8
    epilogue; ``weight_bytes_streamed`` counts the int8 tree a forward."""
    dk = dict(step_fusion="fused")
    je, te = _engines(models, dk=dk,
                      ek=dict(weight_dtype="int8", attn_impl="kernel"),
                      stores=_stores(store_path, dk))
    jo, to = _submit(je, te, _stream(6, seed=5))
    _assert_same(je, jo, te, to)
    tc = models[1]
    assert te.stats.weight_bytes_streamed == te.stats.nfe * \
        decode_weight_bytes(te.scheduler.params, tc)
    assert te.stats.weight_bytes_streamed < te.stats.nfe * \
        decode_weight_bytes(models[3], tc) / 2


def test_failed_batch_requeues_in_order_and_frees_pages(models, store_path):
    """An injected raise in the generate puts the batch's requests back
    at the head of the queue in FIFO order and returns their pages; the
    retry serves them as the reference does."""
    je, te = _engines(models, dk=dict(cache_layout="paged"),
                      ek=dict(prompt_len=32, shared_prefix=SHARED),
                      stores=_stores(store_path))
    stream = _stream(6, seed=6)
    for eng, req in ((je, JRequest), (te, Request)):
        s = eng.scheduler
        s.submit([req(*r) for r in stream])
        real = s._gen
        s._gen = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("injected batch failure"))
        with pytest.raises(RuntimeError, match="injected"):
            s.step()
        assert [rs.req.uid for rs in s.queue] == [r[0] for r in stream]
        assert s.allocator.in_use == s.shared_len // DK["page_size"]
        assert all(sl.state == "free" for sl in s.slots)
        s._gen = real
    for name in INT_STATS:
        assert getattr(te.stats, name) == getattr(je.stats, name), name
    jo = sorted(je.scheduler.run(), key=lambda r: r.uid)
    to = sorted(te.scheduler.run(), key=lambda r: r.uid)
    _assert_same(je, jo, te, to)
    assert te.stats.pages_freed == je.stats.pages_freed > 0


def test_store_path_persists_across_packages(models, tmp_path):
    """``EngineConfig.store_path``: a store the reference engine saved
    serves the port's engine without recalibration, and the other way
    round."""
    stream = _stream(3, seed=7)
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        path = str(tmp_path / f"calib_{writer}")
        je, te = _engines(models, ek=dict(store_path=path))
        first = je if writer == "jax" else te
        req = JRequest if writer == "jax" else Request
        first.submit([req(*r) for r in stream])
        assert first.store.tasks() == sorted(TASK_NAMES)
        je, te = _engines(models, ek=dict(store_path=path))
        second = te if reader == "torch" else je
        assert second.store.tasks() == sorted(TASK_NAMES)
        for t in TASK_NAMES:
            np.testing.assert_array_equal(second.store.tables[t],
                                          first.store.tables[t])
        jo, to = _submit(je, te, _stream(4, seed=8))
        _assert_same(je, jo, te, to)
        assert te.stats.batches == 1


@pytest.mark.parametrize("knob,item", [
    (dict(slice_len=1), "item 2"), (dict(spec_decode=True), "item 4"),
    (dict(draft_max_steps=2), "item 4"), (dict(prefix_cache=True), "item 5"),
    (dict(prefix_cache_pages=64), "item 5"),
    (dict(prefix_cache_watermark=0.1), "item 5"),
    (dict(data_parallel=2), "item 8"),
    (dict(model_parallel=2), "item 8")])
def test_unported_features_raise(models, knob, item):
    with pytest.raises(NotImplementedError, match=item):
        _, tc, _, tp = models
        DiffusionEngine(tp, tc, DecodeConfig(**DK),
                        ecfg=EngineConfig(batch_size=2, prompt_len=P_LEN,
                                          **knob))
