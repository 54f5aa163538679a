"""The port's observability (``repro_torch.obs``) against the reference's,
driven by both serving engines on one request stream with ``trace=True``
and ``drift_telemetry=True``: the port's trace passes its own
``validate_trace`` and holds the reference's events (name, phase, track,
async id and arguments) in the reference's order, so the same nesting;
the Prometheus exposition has the reference's series and equal values,
apart from the timing-derived series (the ``*_seconds`` histograms,
``engine_wall_s``, ``engine_queue_s``, ``engine_ttfb_s`` and the
dispatch timer's µs/forward) and the drift gauges, which are held within
1e-6 like the drift snapshot. CPU, float32, the reduced LLaDA-8B."""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.base import EngineConfig as JEngineConfig
from repro.config.registry import get_config as jax_get_config
from repro.core.osdt import CalibrationStore as JCalibrationStore
from repro.models import model as JM
from repro.obs.trace import validate_trace as jax_validate_trace
from repro.serving.scheduler import Request as JRequest
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch import convert
from repro_torch.config.base import DecodeConfig, EngineConfig
from repro_torch.config.registry import get_config
from repro_torch.core.osdt import CalibrationStore
from repro_torch.data import tokenizer as tok
from repro_torch.obs import Tracer, validate_trace
from repro_torch.serving.scheduler import Request, Scheduler

DK = dict(max_new_tokens=16, block_size=4, policy="osdt", mode="block",
          metric="q1", cap=0.9, slack=0.1, threshold=0.9, page_size=8,
          cache_layout="paged")
EK = dict(batch_size=3, prompt_len=32, attn_impl="kernel",
          shared_prefix="System: you answer in one short line. ",
          trace=True, drift_telemetry=True, drift_threshold=0.9)
# series whose values come from the host clock
TIMED = ("repro_queue_wait_seconds", "repro_dispatch_seconds",
         "repro_engine_wall_s", "repro_engine_queue_s",
         "repro_engine_ttfb_s", "repro_dispatch_us_per_forward")


def _requests(cls, task, n, base=0):
    return [cls(base + i, task, f"{task} question {i}?") for i in range(n)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both schedulers over one stream: alpha and beta come calibrated
    (the same npz loaded into both), gamma calibrates in the first batch;
    the first attempt at a batch fails and is retried."""
    kw = dict(num_layers=2, max_d_model=128, vocab_size=tok.VOCAB)
    jc = dataclasses.replace(jax_get_config("llada-8b").reduced(**kw),
                             mask_token_id=tok.MASK_ID)
    tc = dataclasses.replace(get_config("llada-8b").reduced(**kw),
                             mask_token_id=tok.MASK_ID)
    jp = JM.init_params(jax.random.key(2), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    seed = JScheduler(jp, jc, JDecodeConfig(**DK),
                      ecfg=JEngineConfig(batch_size=2, prompt_len=32))
    seed.submit(_requests(JRequest, "alpha", 1, 90)
                + _requests(JRequest, "beta", 1, 91))
    seed.run()
    path = str(tmp_path_factory.mktemp("store") / "calib.npz")
    seed.store.save(path)
    out = {}
    for name, sched, req, store, params, cfg, dc, ec in (
            ("jax", JScheduler, JRequest, JCalibrationStore, jp, jc,
             JDecodeConfig, JEngineConfig),
            ("torch", Scheduler, Request, CalibrationStore, tp, tc,
             DecodeConfig, EngineConfig)):
        s = sched(params, cfg, dc(**DK), ecfg=ec(**EK),
                  store=store.load(path, dc(**DK)))
        s.submit(_requests(req, "gamma", 2) + _requests(req, "alpha", 3, 10)
                 + _requests(req, "beta", 2, 20))
        real = s._gen
        s._gen = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("injected batch failure"))
        with pytest.raises(RuntimeError, match="injected"):
            s.step()
        s._gen = real
        got = s.run()
        assert sorted(r.uid for r in got) == [0, 1, 10, 11, 12, 20, 21]
        out[name] = s
    return out["jax"], out["torch"]


def _events(doc):
    """Each event without its timestamp."""
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in doc["traceEvents"]]


def test_trace_matches_reference(served):
    js, ts = served
    jdoc, tdoc = js.obs.tracer.export(), ts.obs.tracer.export()
    counts = validate_trace(tdoc)
    assert counts == jax_validate_trace(jdoc)
    assert counts["spans"] > 0 and counts["async"] > 0
    assert counts["instants"] > 0
    assert _events(tdoc) == _events(jdoc)
    names = {e["name"] for e in tdoc["traceEvents"]}
    assert {"request", "queued", "serve", "batch", "batch_failed",
            "calibrate"} <= names
    assert tdoc["otherData"] == jdoc["otherData"] == {"dropped": 0}


def test_trace_json_roundtrip(served, tmp_path):
    _, ts = served
    path = tmp_path / "trace.json"
    ts.obs.save_trace(path)
    doc = json.loads(path.read_text())
    validate_trace(doc)
    assert _events(doc) == _events(ts.obs.tracer.export())


def _samples(text):
    """metric line -> value, and the HELP / TYPE lines in order."""
    vals, meta = {}, []
    for line in text.splitlines():
        if line.startswith("#"):
            meta.append(line)
        else:
            key, v = line.rsplit(" ", 1)
            vals[key] = float(v)
    return vals, meta


def test_prometheus_matches_reference(served):
    js, ts = served
    jv, jm = _samples(js.obs.prometheus())
    tv, tm = _samples(ts.obs.prometheus())
    assert tm == jm
    assert tv.keys() == jv.keys()
    drift = [k for k in tv if k.startswith("repro_drift_")]
    assert drift
    for k in tv:
        if k.startswith(TIMED):
            continue
        if k in drift:
            assert tv[k] == pytest.approx(jv[k], abs=1e-6), k
        else:
            assert tv[k] == jv[k], k
    assert tv['repro_dispatch_forwards{kind="paged/batch/unfused"}'] == \
        ts.stats.nfe - 1  # all but the shared prefix's one-time forward


def test_drift_snapshot_matches_reference(served):
    js, ts = served
    jsnap, tsnap = js.obs.drift.snapshot(), ts.obs.drift.snapshot()
    assert sorted(tsnap) == sorted(jsnap) == ["alpha", "beta", "gamma"]
    for task, row in jsnap.items():
        assert tsnap[task].keys() == row.keys()
        for k, v in row.items():
            assert tsnap[task][k] == pytest.approx(v, abs=1e-6), (task, k)
    # the calibrated tasks scored their rows; gamma's rows calibrated it
    assert tsnap["alpha"]["observations"] == 3
    snap = ts.obs.snapshot()
    assert snap.keys() == js.obs.snapshot().keys()
    assert snap["dispatch"]["paged/batch/unfused"]["dispatches"] == \
        ts.stats.batches


def test_disabled_tracer_is_silent():
    t = Tracer(enabled=False)
    assert not t
    t.begin("x")
    t.instant("y")
    assert t.events() == [] and t.dropped == 0
