"""The port's block-diffusion decoder against the JAX reference's
``make_generate_fn`` across cache modes and epilogues, on a reduced
LLaDA-8B with the reference's weights (CPU, float32). Counts, tokens and
decisions must be equal; recorded confidences agree at atol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.registry import get_config as jax_get_config
from repro.core.decoder import make_generate_fn as jax_make_generate_fn
from repro.models import model as JM
from repro_torch import convert
from repro_torch.config.base import DecodeConfig
from repro_torch.config.registry import get_config
from repro_torch.core.decoder import make_generate_fn

MASK = 259
EXACT = ("tokens", "steps_per_block", "seq_steps", "live", "thr_steps",
         "margin_n", "conf_valid")
CLOSE = ("conf", "margin_sum")


@pytest.fixture(scope="module")
def models():
    kw = dict(num_layers=2, max_d_model=128, vocab_size=260)
    jc = dataclasses.replace(jax_get_config("llada-8b").reduced(**kw),
                             mask_token_id=MASK)
    tc = dataclasses.replace(get_config("llada-8b").reduced(**kw),
                             mask_token_id=MASK)
    jp = JM.init_params(jax.random.key(1), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jc, tc, jp, tp


def _table(nb, sc):
    """Thresholds inside the reduced model's confidence range, so blocks
    take a mix of threshold and fallback steps."""
    steps = np.clip(0.04 - 0.003 * np.arange(sc), 0.02, None)
    return (steps[None] + 0.002 * np.arange(nb)[:, None]).astype(np.float32)


def _compare(models, *, live=None, eos=None, **kw):
    jc, tc, jp, tp = models
    dk = dict(max_new_tokens=32, block_size=8)
    jd, td = JDecodeConfig(**dk), DecodeConfig(**dk)
    prompt = np.random.default_rng(0).integers(0, 256, (3, 16)) \
        .astype(np.int32)
    table = _table(td.num_blocks, td.steps_cap)
    jres = jax_make_generate_fn(jc, jd, **kw)(
        jp, jnp.asarray(prompt), jnp.asarray(table), jnp.asarray(MASK),
        None if live is None else jnp.asarray(live),
        None if eos is None else jnp.asarray(eos))
    tres = make_generate_fn(tc, td, **kw)(tp, prompt, table, MASK, live, eos)
    assert int(jres.nfe) == tres.nfe
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                      getattr(tres, f).numpy(), err_msg=f)
    for f in CLOSE:
        np.testing.assert_allclose(np.asarray(getattr(jres, f)),
                                   getattr(tres, f).numpy(), rtol=0,
                                   atol=1e-5, err_msg=f)
    return tres


@pytest.mark.parametrize("cache_mode", ["prefix", "dual", "none"])
@pytest.mark.parametrize("step_fusion", ["unfused", "fused"])
def test_decode_matches_reference(models, cache_mode, step_fusion):
    res = _compare(models, cache_mode=cache_mode, step_fusion=step_fusion,
                   attn_impl="kernel", use_kernel=True)
    steps = res.steps_per_block.numpy()
    assert steps.max() > 1 and res.thr_steps.sum() > 0  # both rules ran


@pytest.mark.parametrize("step_fusion", ["unfused", "fused"])
def test_decode_quota_matches_reference(models, step_fusion):
    _compare(models, cache_mode="prefix", step_fusion=step_fusion, quota=2,
             attn_impl="kernel")


def test_decode_dead_rows_and_eos_match_reference(models):
    """A dead row flushes without forcing steps, and EOS retires rows at
    block boundaries (the EOS id is one the model emits here)."""
    res = _compare(models, cache_mode="prefix", attn_impl="dense",
                   live=np.array([True, False, True]), eos=88)
    assert res.live.tolist() == [False, False, True]  # row 0 hit EOS
    assert res.seq_steps[1].sum() == 0 and res.seq_steps[0, 1:].sum() == 0
