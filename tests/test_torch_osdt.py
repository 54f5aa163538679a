"""OSDT end to end (Algorithm 1, the quickstart flow) in the port against
the JAX reference: Phase 1 calibrates on one row, Phase 2 decodes the batch
with the calibrated table; tables and tokens must match, and a calibration
store saved by either package loads in the other."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.registry import get_config as jax_get_config
from repro.core import osdt as jax_osdt
from repro.core import policies as jax_policies
from repro.core.calibrate import build_table as jax_build_table
from repro.data import tokenizer as tok
from repro.models import model as JM
from repro_torch import convert
from repro_torch.config.base import DecodeConfig
from repro_torch.config.registry import get_config
from repro_torch.core import osdt as torch_osdt
from repro_torch.core import policies
from repro_torch.core.calibrate import build_table

DK = dict(max_new_tokens=32, block_size=8, policy="osdt", mode="block",
          metric="q1", cap=0.75, slack=0.2, step_fusion="fused")


@pytest.fixture(scope="module")
def sessions():
    kw = dict(num_layers=2, max_d_model=128, vocab_size=tok.VOCAB)
    jc = dataclasses.replace(jax_get_config("llada-8b").reduced(**kw),
                             mask_token_id=tok.MASK_ID)
    tc = dataclasses.replace(get_config("llada-8b").reduced(**kw),
                             mask_token_id=tok.MASK_ID)
    jp = JM.init_params(jax.random.key(3), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    js = jax_osdt.OSDTSession(jp, jc, JDecodeConfig(**DK), tok.MASK_ID,
                              attn_impl="kernel")
    ts = torch_osdt.OSDTSession(tp, tc, DecodeConfig(**DK), tok.MASK_ID,
                                attn_impl="kernel")
    prompts = tok.batch_prompts(
        [tok.encode(s, bos=True) for s in
         ("Q: 2+3=?", "Q: what is 7*6?", "say hi", "count: 1 2 3")], 16)
    out = []
    for s, to_in in ((js, jnp.asarray), (ts, np.asarray)):
        r1 = s.generate(to_in(prompts[:1]))      # Phase 1: calibrate
        r2 = s.generate(to_in(prompts))          # Phase 2: OSDT table
        out.append((s, r1, r2))
    return out


def test_osdt_tables_and_tokens_match_reference(sessions):
    (js, j1, j2), (ts, t1, t2) = sessions
    assert ts.calibrated and js.calibrated
    np.testing.assert_allclose(js.table, ts.table, rtol=0, atol=1e-6)
    for jr, tr in ((j1, t1), (j2, t2)):
        np.testing.assert_array_equal(np.asarray(jr.tokens),
                                      tr.tokens.numpy())
        assert int(jr.nfe) == tr.nfe
        np.testing.assert_array_equal(np.asarray(jr.steps_per_block),
                                      tr.steps_per_block.numpy())
    assert ts.total_nfe == js.total_nfe
    assert ts.total_tokens == js.total_tokens
    # Phase 1 took the fallback path everywhere, Phase 2 the threshold
    assert int(t1.thr_steps.sum()) == 0 and int(t2.thr_steps.sum()) > 0
    assert t2.nfe < t1.nfe * 4


def test_policy_tables_match_reference():
    jd, td = JDecodeConfig(**DK), DecodeConfig(**DK)
    np.testing.assert_array_equal(jax_policies.static_table(jd),
                                  policies.static_table(td))
    np.testing.assert_array_equal(jax_policies.factor_table(jd),
                                  policies.factor_table(td))
    rng = np.random.default_rng(5)
    conf = rng.random((td.num_blocks, td.steps_cap, td.block_size)) \
        .astype(np.float32)
    valid = rng.random(conf.shape) < 0.5
    steps = valid.any(-1).sum(-1).astype(np.int32)
    from repro.core.calibrate import CalibrationProfile as JP
    from repro_torch.core.calibrate import CalibrationProfile as TP
    for mode in ("block", "step-block"):
        for metric in ("mean", "q1", "median", "q3", "min-whisker"):
            kw = dict(DK, mode=mode, metric=metric)
            np.testing.assert_array_equal(
                jax_build_table(JP(conf, valid, steps), JDecodeConfig(**kw)),
                build_table(TP(conf, valid, steps), DecodeConfig(**kw)))


def test_store_npz_loads_across_packages(sessions, tmp_path):
    (js, _, _), (ts, _, _) = sessions
    jd, td = JDecodeConfig(**DK), DecodeConfig(**DK)
    p_t = str(tmp_path / "torch_store")
    p_j = str(tmp_path / "jax_store.npz")
    ts.store.save(p_t)
    js.store.save(p_j)
    from_torch = jax_osdt.CalibrationStore.load(p_t, jd)
    from_jax = torch_osdt.CalibrationStore.load(p_j, td)
    for loaded, src in ((from_torch, ts.store), (from_jax, js.store)):
        assert loaded.tasks() == src.tasks() == ["default"]
        np.testing.assert_array_equal(loaded.table("default"),
                                      src.table("default"))
        a, b = loaded.profiles["default"], src.profiles["default"]
        np.testing.assert_array_equal(a.conf, b.conf)
        np.testing.assert_array_equal(a.valid, b.valid)
        np.testing.assert_array_equal(a.steps, b.steps)
    np.testing.assert_array_equal(from_jax.tables_for(["default", "new"]),
                                  js.store.tables_for(["default", "new"]))
    # the online variant's EMA update agrees from the same stored table
    from repro.core.calibrate import CalibrationProfile as JP
    from repro_torch.core.calibrate import CalibrationProfile as TP
    both_t = torch_osdt.CalibrationStore.load(p_t, td)
    prof = ts.store.profiles["default"]
    np.testing.assert_array_equal(
        from_torch.update_ema("default", JP(prof.conf * 1.1, prof.valid,
                                            prof.steps), 0.25),
        both_t.update_ema("default", TP(prof.conf * 1.1, prof.valid,
                                        prof.steps), 0.25))
    with pytest.raises(ValueError):
        torch_osdt.CalibrationStore.load(
            p_j, DecodeConfig(**dict(DK, block_size=16)))
