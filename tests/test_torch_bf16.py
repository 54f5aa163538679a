"""The port's bf16 numerics against the JAX reference (CPU), on the bench
config (``llada-8b`` reduced to 4 layers, d 256, vocab 512) in bf16 with
the reference's weights brought over by ``convert.py``.

Bounds, each as measured on this config before it was written down:
  * embed, ``rms_norm`` and RoPE are bitwise the reference's;
  * a projection, the int8 matmul's plain version (K5) with bf16
    activations and the MLP are within one bf16 step of the reference
    elementwise: both sum the same bf16 products in float32 and round
    once, so they part only where the sums straddle a rounding boundary.
    Attention rounds twice (the probabilities to bf16, then the output),
    so it is held within two steps, with at most 0.1% of its elements
    differing at all (measured: 8 of 12,288, one of them by two steps);
  * after 4 layers the mean |logit difference| to the reference stays
    under 1.5x the reference's own bf16-vs-f32 drift on the same weights
    (measured 0.94-1.03x; two independent roundings of equal size add to
    ~1.41x), and the argmax agrees at least as often as the reference's
    bf16 and f32 forwards agree, less 0.1;
  * prefix and dual decodes (8 rows, threshold and fallback tables) match
    the reference's bf16 tokens at least as often as the reference's bf16
    and f32 decodes match each other, less 0.1 (measured gaps down to
    -0.074), never below 0.5 (measured minimum 0.586), with NFE within 2
    (measured equal).
A decode on random weights is chaotic: one near-tie flipped by rounding
changes every later step, so tokens are held to the reference's own
rounding sensitivity, not to equality.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.registry import get_config as jax_get_config
from repro.core.decoder import make_generate_fn as jax_make_generate_fn
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import quantize as JQ
from repro_torch import convert
from repro_torch.config.base import DecodeConfig
from repro_torch.config.registry import get_config
from repro_torch.core.decoder import make_generate_fn
from repro_torch.kernels.quantized_matmul import quantized_matmul_kernel
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

MASK = 511
BENCH = dict(num_layers=4, max_d_model=256, vocab_size=512)
VARIANTS = {
    "untied": {},
    "tied": dict(tie_embeddings=True),
    "gqa": dict(num_heads=4, num_kv_heads=1),
}


def _bf16(a):
    """numpy float32 -> (jax bf16, torch bf16), the same rounding."""
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bitwise(j, t):
    np.testing.assert_array_equal(_np32(j), _np32(t))


def _within_steps(j, t, steps=1, differ=1.0):
    """Elementwise within ``steps`` bf16 steps (a step is 2^-7 of the
    value's power of two, floored at the smallest normal's), and at most
    a fraction ``differ`` of the elements not equal."""
    a, b = _np32(j), _np32(t)
    mag = np.maximum(np.abs(a), np.abs(b))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert bool((np.abs(a - b) <= steps * step).all()), \
        (np.abs(a - b) / step).max()
    assert (a != b).mean() <= differ, (a != b).mean()


def _pair(variant):
    over = dict(VARIANTS[variant], mask_token_id=MASK, dtype="bfloat16")
    jc = dataclasses.replace(jax_get_config("llada-8b").reduced(**BENCH),
                             **over)
    tc = dataclasses.replace(get_config("llada-8b").reduced(**BENCH),
                             **over)
    jp = JM.init_params(jax.random.key(0), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    # the reference's float32 twin: the same bf16 weights, widened
    jc32 = dataclasses.replace(jc, dtype="float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jc, tc, jp, tp, jc32, jp32


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_embed_norm_rope_bitwise():
    rng = np.random.default_rng(0)
    jt, tt = _bf16(rng.standard_normal((40, 64)).astype(np.float32))
    toks = rng.integers(0, 40, (2, 5)).astype(np.int32)
    _bitwise(JL.embed(jt, jnp.asarray(toks)),
             TL.embed(tt, torch.as_tensor(toks)))
    jh, th = _bf16(rng.standard_normal((2, 5, 64)).astype(np.float32))
    js, ts = _bf16(rng.standard_normal((64,)).astype(np.float32))
    out = TL.rms_norm(th, ts, 1e-5)
    assert out.dtype == torch.bfloat16
    _bitwise(JL.rms_norm(jh, js, 1e-5), out)
    jx, tx = _bf16(rng.standard_normal((2, 5, 3, 32)).astype(np.float32))
    pos = rng.integers(0, 300, (5,)).astype(np.int32)
    out = TL.apply_rope(tx, torch.as_tensor(pos), 5.0e5)
    assert out.dtype == torch.bfloat16
    _bitwise(JL.apply_rope(jx, jnp.asarray(pos), 5.0e5), out)


def test_projection_attention_mlp_within_bf16_steps():
    rng = np.random.default_rng(1)
    jx, tx = _bf16(rng.standard_normal((2, 24, 256)).astype(np.float32))
    jw, tw = _bf16((rng.standard_normal((256, 384)) / 16)
                   .astype(np.float32))
    _within_steps(JL.project(jx, jw, "bsm,mf->bsf"), TL.project(tx, tw))
    p = {k: _bf16((rng.standard_normal(s) / 16).astype(np.float32))
         for k, s in (("wi_gate", (256, 512)), ("wi_up", (256, 512)),
                      ("wo", (512, 256)))}
    _within_steps(JL.mlp({k: v[0] for k, v in p.items()}, jx),
                  TL.mlp({k: v[1] for k, v in p.items()}, tx))
    # GQA 4 over 24 positions, bidirectional and causal
    q, k, v = (_bf16(rng.standard_normal((2, 24, h, 32))
                     .astype(np.float32)) for h in (8, 2, 2))
    pos = np.arange(24, dtype=np.int32)
    for mode in ("full", "causal"):
        j = JA.attention(q[0], k[0], v[0], q_pos=jnp.asarray(pos),
                         kv_pos=jnp.asarray(pos), mode=mode)
        t = TA.attention(q[1], k[1], v[1], q_pos=torch.as_tensor(pos),
                         kv_pos=torch.as_tensor(pos), mode=mode)
        assert t.dtype == torch.bfloat16
        # the probabilities are rounded to bf16 before P V: one that
        # rounds the other way moves an output by up to one more step
        _within_steps(j, t, steps=2, differ=1e-3)


def test_quantized_matmul_plain_bf16_at_model_projections():
    """K5's plain version with bf16 activations against the reference's
    oracle on the reference's own int8 quantization of the bench model's
    bf16 projections (every layer's wq and the MLP's down projection)."""
    jc, tc, jp, _, _, _ = _pair("untied")
    jq = JQ.quantize_decode_params(jp, jc)
    tq = convert.params_from_numpy(jax.tree.map(np.asarray, jq),
                                   device="cpu")
    rng = np.random.default_rng(2)
    for name, d_in in (("wq", tc.d_model), ("wo", tc.d_ff)):
        jx, tx = _bf16(rng.standard_normal((24, d_in)).astype(np.float32))
        jqt = jq["layers"][name] if name == "wq" else \
            jq["layers"]["mlp"][name]
        tqt = tq["layers"][name] if name == "wq" else \
            tq["layers"]["mlp"][name]
        for layer in range(tc.num_layers):
            got = quantized_matmul_kernel(tx, tqt.q[layer], tqt.scale[layer],
                                          transpose=False)
            assert got.dtype == torch.bfloat16
            _within_steps(jref.quantized_matmul_ref(
                jx, jqt.q[layer], jqt.scale[layer], transpose=False), got)


# ---------------------------------------------------------------------------
# model and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_drift_within_reference_rounding(variant):
    jc, tc, jp, tp, jc32, jp32 = _pair(variant)
    toks = np.random.default_rng(3).integers(0, 500, (2, 24)) \
        .astype(np.int32)
    j16, _ = JM.forward(jp, jc, jnp.asarray(toks), mode="full")
    j32, _ = JM.forward(jp32, jc32, jnp.asarray(toks), mode="full")
    t16 = TM.forward(tp, tc, torch.as_tensor(toks), mode="full")
    a, b, c = _np32(j16), _np32(j32), _np32(t16)
    own = np.abs(a - b).mean()
    assert np.abs(c - a).mean() <= 1.5 * own
    own_argmax = (a.argmax(-1) == b.argmax(-1)).mean()
    assert (c.argmax(-1) == a.argmax(-1)).mean() >= own_argmax - 0.1


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("cache_mode", ["prefix", "dual"])
@pytest.mark.parametrize("tau", [0.006, 0.9])
def test_decode_within_reference_rounding(variant, cache_mode, tau):
    """8 rows, 32 new tokens in blocks of 8; tau 0.006 takes threshold
    steps, 0.9 only fallback steps."""
    jc, tc, jp, tp, jc32, jp32 = _pair(variant)
    dk = dict(max_new_tokens=32, block_size=8)
    prompt = np.random.default_rng(1).integers(0, 500, (8, 16)) \
        .astype(np.int32)
    table = np.full((4, 8), tau, np.float32)
    kw = dict(cache_mode=cache_mode, attn_impl="kernel", use_kernel=True)
    jargs = (jnp.asarray(prompt), jnp.asarray(table), jnp.asarray(MASK),
             None, None)
    j16 = jax_make_generate_fn(jc, JDecodeConfig(**dk), **kw)(jp, *jargs)
    j32 = jax_make_generate_fn(jc32, JDecodeConfig(**dk), **kw)(jp32, *jargs)
    t16 = make_generate_fn(tc, DecodeConfig(**dk), **kw)(tp, prompt, table,
                                                         MASK)
    ref16 = np.asarray(j16.tokens)
    match = (t16.tokens.numpy() == ref16).mean()
    own = (np.asarray(j32.tokens) == ref16).mean()
    assert match >= max(own - 0.1, 0.5), (match, own)
    assert abs(t16.nfe - int(j16.nfe)) <= 2
