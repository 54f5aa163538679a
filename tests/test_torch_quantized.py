"""The port's int8 weight-streaming decode against the JAX reference:
the quantizer (``q`` and ``scale`` bitwise the reference's), the
conversion of a quantized reference tree, the plain version of the int8
matmul kernel (K5) and of the int8-head fused step (K6) against the
reference's oracles and its Pallas kernels in interpret mode, the
quantized layers, model and generate (both epilogues), and OSDT on int8
params. CPU, float32, numpy inputs from a seed.

The port's int8 decode is held to the reference's decode on the
*dequantized* weights, the same function: tokens, NFE and step counts
equal, floats within 1e-5. It is held the same way to the reference's own
int8 decode, unfused and fused, and the fused one to its own unfused one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.registry import get_config as jax_get_config
from repro.core import osdt as jax_osdt
from repro.core.decoder import make_generate_fn as jax_make_generate_fn
from repro.data import tokenizer as tok
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_step import quantized_fused_step_pallas
from repro.kernels.quantized_matmul import quantized_matmul_pallas
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import quantize as JQ
from repro_torch import convert
from repro_torch.config.base import DecodeConfig
from repro_torch.config.registry import get_config
from repro_torch.core import osdt as torch_osdt
from repro_torch.core.decoder import make_generate_fn
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_step import quantized_fused_step_kernel
from repro_torch.kernels.quantized_matmul import quantized_matmul_kernel
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import quantize as TQ

MASK = 259
ATOL = 1e-5
KW = dict(num_layers=2, max_d_model=128, vocab_size=260)


def _np(t):
    return t.detach().numpy()


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), _np(t), rtol=0, atol=atol)


def _equal_qt(jqt, tqt):
    np.testing.assert_array_equal(np.asarray(jqt.q), _np(tqt.q))
    np.testing.assert_array_equal(np.asarray(jqt.scale), _np(tqt.scale))
    assert tqt.q.dtype == torch.int8 and tqt.scale.dtype == torch.float32


def _configs(tied=False, dtype="float32"):
    jc = dataclasses.replace(jax_get_config("llada-8b").reduced(**KW),
                             mask_token_id=MASK, tie_embeddings=tied,
                             dtype=dtype)
    tc = dataclasses.replace(get_config("llada-8b").reduced(**KW),
                             mask_token_id=MASK, tie_embeddings=tied,
                             dtype=dtype)
    return jc, tc


def _qpairs(jtree, ttree, path=""):
    """Every (reference, port) QuantizedTensor pair of two trees."""
    if isinstance(jtree, JQ.QuantizedTensor):
        assert isinstance(ttree, TQ.QuantizedTensor), path
        yield path, jtree, ttree
    elif isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            yield from _qpairs(jtree[k], ttree[k], f"{path}/{k}")
    else:
        assert not isinstance(ttree, TQ.QuantizedTensor), path


@pytest.fixture(scope="module")
def models():
    """Reference params and their int8 quantization, the converted int8
    tree, and the reference's dequantized tree (float32)."""
    jc, tc = _configs()
    jp = JM.init_params(jax.random.key(1), jc)
    jq = JQ.quantize_decode_params(jp, jc)
    tq = convert.params_from_numpy(jax.tree.map(np.asarray, jq),
                                   device="cpu")
    jdq = jax.tree_util.tree_map(
        lambda t: JQ.dequantize(t) if isinstance(t, JQ.QuantizedTensor)
        else t, jq, is_leaf=lambda t: isinstance(t, JQ.QuantizedTensor))
    return jc, tc, jq, tq, jdq


# ---------------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [
    ((64, 96), -2),        # projection [in, out]: per output column
    ((96, 64), -1),        # tied table [V, d]: per vocab row
    ((3, 64, 96), -2),     # stacked layers: per layer and column
    ((16, 8), -2),         # an all-zero column (column 0)
])
def test_quantize_tensor_bitwise_reference(shape, axis):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w *= 3.0
    if shape == (16, 8):
        w[:, 0] = 0.0
    jqt = JQ.quantize_tensor(jnp.asarray(w), axis=axis)
    tqt = TQ.quantize_tensor(torch.tensor(w), axis=axis)
    _equal_qt(jqt, tqt)
    assert tqt.shape == shape and tqt.scale.ndim == len(shape)
    assert tqt.scale.shape[axis] == 1
    # |dequant - w| <= scale/2 holds up to two float32 roundings, each at
    # most 2^-24 of |q| <= 127 steps: the division w / scale (which may
    # tip a half-way rounding) and the product q * scale. On the
    # reference's own shape2 case the worst ratio |dequant - w| / scale
    # is 0.5000042, so a slack of 1e-7 absolute (the reference test's) or
    # 1e-6 relative is too tight; this one is the derived 2 * 127 * 2^-24
    err = (TQ.dequantize(tqt) - torch.tensor(w)).abs()
    slack = 2 * 127 * 2.0 ** -24 * tqt.scale
    assert bool((err <= TQ.max_abs_error_bound(tqt) + slack).all())
    if shape == (16, 8):
        assert float(tqt.scale[0, 0]) == 1.0
        assert not bool(TQ.dequantize(tqt)[:, 0].any())


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_decode_params_matches_reference(tied):
    """The port's quantization of the converted params equals the
    reference's quantized tree, leaf for leaf and bit for bit; the
    weight-byte counts agree."""
    jc, tc = _configs(tied)
    jp = JM.init_params(jax.random.key(0), jc)
    jq = JQ.quantize_decode_params(jp, jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    tq = TQ.quantize_decode_params(tp, tc)
    assert TQ.is_quantized(tq) and not TQ.is_quantized(tp)
    names = []
    for path, jqt, tqt in _qpairs(jq, tq):
        _equal_qt(jqt, tqt)
        names.append(path)
    want = ["/layers/wq", "/layers/wk", "/layers/wv", "/layers/wo",
            "/layers/mlp/wi_gate", "/layers/mlp/wi_up", "/layers/mlp/wo",
            "/head_q" if tied else "/head"]
    assert sorted(names) == sorted(want)
    # norms and the gather table stay raw; the input is untouched
    assert torch.equal(tq["embed"], tp["embed"])
    assert tq["layers"]["ln1"].dtype == torch.float32
    assert not isinstance(tp["layers"]["wq"], TQ.QuantizedTensor)
    head = tq["head_q"] if tied else tq["head"]
    assert head.scale.shape == ((tc.vocab_size, 1) if tied
                                else (1, tc.vocab_size))
    for p, c in ((jp, tp), (jq, tq)):
        assert TQ.decode_weight_bytes(c, tc) == JQ.decode_weight_bytes(p, jc)
    ratio = TQ.decode_weight_bytes(tp, tc) / TQ.decode_weight_bytes(tq, tc)
    assert 3.0 < ratio <= 4.0


def test_convert_quantized_bf16_tree():
    """A quantized bf16 reference tree converts leaf for leaf: int8 ``q``,
    float32 ``scale``, bf16 raw leaves; the port's own quantization of
    the converted bf16 params gives the same bits."""
    jc, tc = _configs(dtype="bfloat16")
    jp = JM.init_params(jax.random.key(2), jc)
    jq = JQ.quantize_decode_params(jp, jc)
    tq = convert.params_from_numpy(jax.tree.map(np.asarray, jq),
                                   device="cpu")
    assert tq["embed"].dtype == torch.bfloat16
    assert tq["layers"]["ln1"].dtype == torch.bfloat16
    pairs = list(_qpairs(jq, tq))
    assert len(pairs) == 8
    for _, jqt, tqt in pairs:
        _equal_qt(jqt, tqt)
    own = TQ.quantize_decode_params(
        convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu"), tc)
    for _, a, b in _qpairs(jq, own):
        _equal_qt(a, b)
    # a stacked QuantizedTensor is sliced layer by layer in both tensors
    lp = TM.layer_params(tq["layers"], 1)
    assert torch.equal(lp["wq"].q, tq["layers"]["wq"].q[1])
    assert torch.equal(lp["mlp"]["wo"].scale,
                       tq["layers"]["mlp"]["wo"].scale[1])


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,K,N", [
    (1, 128, 128),      # one row
    (8, 256, 1024),     # several column tiles
    (13, 200, 513),     # ragged everything
])
@pytest.mark.parametrize("transpose", [False, True])
def test_quantized_matmul_plain_matches_oracle_and_pallas(R, K, N, transpose):
    rng = np.random.default_rng(R * 7 + int(transpose))
    x = rng.standard_normal((R, K)).astype(np.float32)
    w = rng.standard_normal((N, K) if transpose else (K, N)) \
        .astype(np.float32)
    jqt = JQ.quantize_tensor(jnp.asarray(w), axis=-1 if transpose else -2)
    tqt = TQ.quantize_tensor(torch.tensor(w), axis=-1 if transpose else -2)
    _equal_qt(jqt, tqt)
    got = quantized_matmul_kernel(torch.tensor(x), tqt.q, tqt.scale,
                                  transpose=transpose)
    assert got.dtype == torch.float32 and got.shape == (R, N)
    # the same dequantized weight and float32 product on both sides: they
    # differ only by the order of the float32 sums, within 1e-6 of the
    # output's range (outputs reach ~50 here, where a float32 step is 4e-6)
    oracle = np.asarray(jref.quantized_matmul_ref(
        jnp.asarray(x), jqt.q, jqt.scale, transpose=transpose))
    np.testing.assert_allclose(oracle, _np(got), rtol=0,
                               atol=1e-6 * np.abs(oracle).max())
    # the Pallas kernel in interpret mode, at the reference test's 1e-5
    pallas = quantized_matmul_pallas(jnp.asarray(x), jqt.q, jqt.scale,
                                     transpose=transpose, interpret=True)
    np.testing.assert_allclose(np.asarray(pallas), _np(got), rtol=1e-5,
                               atol=1e-5)
    # the entry point keeps leading dims
    lead = ops.quantized_matmul(torch.tensor(x).reshape(1, R, K), tqt,
                                transpose=transpose)
    assert lead.shape == (1, R, N) and torch.equal(lead[0], got)


def _bf16_step_close(oracle, got):
    """Elementwise within one bf16 step (2^-7 of the value's power of
    two, floored at the smallest normal's): both sides contract the same
    bf16 operands in float32 and round once, so they differ only where
    the float32 sums fall on either side of a bf16 rounding boundary."""
    a = np.asarray(oracle, np.float32)
    b = got.float().numpy()
    mag = np.maximum(np.abs(a), np.abs(b))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert bool((np.abs(a - b) <= step).all()), np.abs(a - b).max()


@pytest.mark.parametrize("R,K,N", [
    (1, 128, 128),
    (8, 256, 1024),
    (13, 200, 513),
])
@pytest.mark.parametrize("transpose", [False, True])
def test_quantized_matmul_plain_bf16_matches_oracle(R, K, N, transpose):
    """bf16 activations, the main path's projections: the port's plain K5
    against the reference's oracle on the same ``q`` and ``scale`` (both
    round the dequantized weight to bf16 before the product)."""
    rng = np.random.default_rng(R * 11 + int(transpose))
    x = rng.standard_normal((R, K)).astype(np.float32)
    w = rng.standard_normal((N, K) if transpose else (K, N)) \
        .astype(np.float32)
    axis = -1 if transpose else -2
    jqt = JQ.quantize_tensor(jnp.asarray(w), axis=axis)
    tqt = TQ.quantize_tensor(torch.tensor(w), axis=axis)
    _equal_qt(jqt, tqt)
    xb = torch.tensor(x).to(torch.bfloat16)
    got = quantized_matmul_kernel(xb, tqt.q, tqt.scale, transpose=transpose)
    assert got.dtype == torch.bfloat16 and got.shape == (R, N)
    oracle = jref.quantized_matmul_ref(jnp.asarray(x, jnp.bfloat16), jqt.q,
                                       jqt.scale, transpose=transpose)
    assert oracle.dtype == jnp.bfloat16
    _bf16_step_close(oracle, got)
    # a bf16 layer projection with int8 weights against the reference's
    # raw-weight projection on the dequantized weight rounded to bf16
    if not transpose:
        wdq = JQ.dequantize(jqt).astype(jnp.bfloat16)
        x3 = jnp.asarray(x, jnp.bfloat16)[None]
        _bf16_step_close(JL.project(x3, wdq, "bsm,mf->bsf")[0],
                         TL.project(xb[None], tqt)[0])


def test_quantized_matmul_plain_rounds_weight_to_x_dtype():
    """bf16 activations meet the dequantized weight rounded to bf16 (the
    oracle), not the float32 one."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((4, 64)).astype(np.float32))
    qt = TQ.quantize_tensor(
        torch.tensor(rng.standard_normal((64, 48)).astype(np.float32)), -2)
    xb = x.to(torch.bfloat16)
    got = ref.quantized_matmul_ref(xb, qt.q, qt.scale, transpose=False)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, xb @ TQ.dequantize(qt).to(torch.bfloat16))


@pytest.mark.parametrize("transpose", [False, True])
def test_quantized_matmul_f32_out_of_bf16_x_is_the_widened_product(
        transpose):
    """The lm head's call, bf16 x with ``out_dtype=torch.float32``, gives
    on the CPU the bits of the former route, the float32 product of
    ``x.float()``, through the wrapper, ``ops.quantized_matmul`` and
    ``unembed``; bf16 x cannot ask for another narrowing."""
    rng = np.random.default_rng(21 + int(transpose))
    R, K, N = 9, 96, 200
    xb = torch.tensor(rng.standard_normal((R, K)),
                      dtype=torch.float32).bfloat16()
    w = torch.tensor(rng.standard_normal((N, K) if transpose else (K, N)),
                     dtype=torch.float32)
    tqt = TQ.quantize_tensor(w, axis=-1 if transpose else -2)
    want = quantized_matmul_kernel(xb.float(), tqt.q, tqt.scale,
                                   transpose=transpose)
    got = quantized_matmul_kernel(xb, tqt.q, tqt.scale, transpose=transpose,
                                  out_dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    lead = ops.quantized_matmul(xb[None], tqt, transpose=transpose,
                                out_dtype=torch.float32)
    assert torch.equal(lead[0], want)
    assert torch.equal(TL.unembed(tqt, xb[None], transpose=transpose)[0],
                       want)
    with pytest.raises(ValueError):
        quantized_matmul_kernel(xb.float(), tqt.q, tqt.scale,
                                transpose=transpose,
                                out_dtype=torch.bfloat16)


def test_quantized_matmul_kernel_refuses_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        quantized_matmul_kernel(torch.empty((2, 8), **meta),
                                torch.empty((8, 4), dtype=torch.int8, **meta),
                                torch.empty((1, 4), **meta), transpose=False)


# ---------------------------------------------------------------------------
# layers and model with quantized params
# ---------------------------------------------------------------------------

def test_project_mlp_unembed_quantized(models):
    jc, tc, jq, tq, _ = models
    x = np.random.default_rng(4).standard_normal((2, 5, tc.d_model)) \
        .astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jq["layers"])
    tl = TM.layer_params(tq["layers"], 0)
    _close(JL.project(jnp.asarray(x), jl["wq"], "bsm,mf->bsf"),
           TL.project(torch.tensor(x), tl["wq"]))
    _close(JL.mlp(jl["mlp"], jnp.asarray(x)), TL.mlp(tl["mlp"],
                                                     torch.tensor(x)))
    _close(JL.unembed(jq["head"], jnp.asarray(x), transpose=False),
           TL.unembed(tq["head"], torch.tensor(x), transpose=False))
    # the tied table as the unembed, quantized per vocab row, at the
    # embedding's init scale (0.02, as ``init_embedding`` draws it)
    table = 0.02 * np.random.default_rng(5).standard_normal(
        (tc.vocab_size, tc.d_model)).astype(np.float32)
    jt = JQ.quantize_tensor(jnp.asarray(table), axis=-1)
    tt = TQ.quantize_tensor(torch.tensor(table), axis=-1)
    _close(JL.unembed(jt, jnp.asarray(x), transpose=True),
           TL.unembed(tt, torch.tensor(x), transpose=True))


@pytest.mark.parametrize("tied", [False, True])
def test_prefill_and_block_step_quantized(tied):
    jc, tc = _configs(tied)
    jp = JM.init_params(jax.random.key(6), jc)
    jq = JQ.quantize_decode_params(jp, jc)
    tq = convert.params_from_numpy(jax.tree.map(np.asarray, jq),
                                   device="cpu")
    rng = np.random.default_rng(6)
    P, bs = 12, 4
    prompt = rng.integers(0, 256, (2, P)).astype(np.int32)
    jl, jcache = JM.prefill(jq, jc, jnp.asarray(prompt), max_len=P + 8,
                            mode="full")
    tl, tcache = TM.prefill(tq, tc, torch.as_tensor(prompt), max_len=P + 8,
                            mode="full")
    _close(jl, tl)
    _close(jcache["attn"]["k"], tcache["attn"]["k"])
    block = rng.integers(0, 256, (2, bs)).astype(np.int32)
    for write in (False, True):
        jo, jcache = JM.block_step(jq, jc, jnp.asarray(block), P, jcache,
                                   write=write)
        to, tcache = TM.block_step(tq, tc, torch.as_tensor(block), P, tcache,
                                   write=write, attn_impl="kernel")
        _close(jo, to)
    _close(jcache["attn"]["v"], tcache["attn"]["v"])
    assert int(jcache["attn"]["length"]) == tcache["attn"]["length"]


# ---------------------------------------------------------------------------
# generate and OSDT on int8 params
# ---------------------------------------------------------------------------

DK = dict(max_new_tokens=32, block_size=8)
EXACT = ("tokens", "steps_per_block", "seq_steps", "thr_steps")


def _table(nb, sc):
    """Thresholds inside the reduced model's confidence range, so blocks
    take a mix of threshold and fallback steps."""
    steps = np.clip(0.04 - 0.003 * np.arange(sc), 0.02, None)
    return (steps[None] + 0.002 * np.arange(nb)[:, None]).astype(np.float32)


def _max_len(cache_mode, P):
    return P + DK["max_new_tokens"] + (DK["block_size"]
                                       if cache_mode == "dual" else 0)


def _assert_same(jres, tres):
    assert int(jres.nfe) == tres.nfe
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                      _np(getattr(tres, f)), err_msg=f)
    _close(jres.conf, tres.conf)


@pytest.mark.parametrize("cache_mode,layout", [
    ("prefix", "dense"), ("dual", "dense"), ("none", "dense"),
    ("prefix", "paged"), ("dual", "paged")])
def test_generate_int8_matches_reference_dequantized(models, cache_mode,
                                                     layout):
    """The port's int8 unfused generate equals the reference's generate
    on the dequantized weights, and the reference's int8 generate."""
    jc, tc, jq, tq, jdq = models
    jd = JDecodeConfig(**DK, cache_layout=layout, page_size=8)
    td = DecodeConfig(**DK, cache_layout=layout, page_size=8,
                      weight_dtype="int8")
    rng = np.random.default_rng(7)
    B, P = 2, 16
    prompt = rng.integers(0, 256, (B, P)).astype(np.int32)
    table = _table(td.num_blocks, td.steps_cap)
    jargs = [jnp.asarray(prompt), jnp.asarray(table), jnp.asarray(MASK),
             None, None]
    targs = [prompt, table, MASK, None, None]
    if layout == "paged":
        n_log = td.pages_per_seq(_max_len(cache_mode, P))
        pt = rng.permutation(B * n_log + 2)[:B * n_log] \
            .reshape(B, n_log).astype(np.int32)
        shape = (tc.num_layers, B * n_log + 2, 8, tc.num_kv_heads,
                 tc.resolved_head_dim)
        pool = np.zeros(shape, np.float32)
        jargs += [jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(pt)]
    kw = dict(cache_mode=cache_mode, attn_impl="kernel", use_kernel=True)
    jkw = dict(kw, attn_impl="auto") if cache_mode == "none" else kw
    tres = None
    for params, wd in ((jdq, "bf16"), (jq, "int8")):
        jres = jax_make_generate_fn(jc, jd, weight_dtype=wd, **jkw)(
            params, *jargs)
        if layout == "paged":
            # the port writes its pool in place: a fresh one each run
            targs_run = targs + [torch.tensor(pool), torch.tensor(pool),
                                 torch.tensor(pt)]
        else:
            targs_run = targs
        tres = make_generate_fn(tc, td, **kw)(tq, *targs_run)
        _assert_same(jres, tres)
    assert tres.steps_per_block.max() > 1 and tres.thr_steps.sum() > 0


def test_osdt_session_int8_matches_reference_dequantized():
    """OSDT (Phase 1 calibrates, Phase 2 decodes the batch) on int8
    params through the unfused epilogue: the port's table and tokens
    equal the reference session's on the dequantized weights."""
    dk = dict(max_new_tokens=32, block_size=8, policy="osdt", mode="block",
              metric="q1", cap=0.75, slack=0.2, step_fusion="unfused")
    kw = dict(num_layers=2, max_d_model=128, vocab_size=tok.VOCAB)
    jc = dataclasses.replace(jax_get_config("llada-8b").reduced(**kw),
                             mask_token_id=tok.MASK_ID)
    tc = dataclasses.replace(get_config("llada-8b").reduced(**kw),
                             mask_token_id=tok.MASK_ID)
    jp = JM.init_params(jax.random.key(3), jc)
    jq = JQ.quantize_decode_params(jp, jc)
    jdq = jax.tree_util.tree_map(
        lambda t: JQ.dequantize(t) if isinstance(t, JQ.QuantizedTensor)
        else t, jq, is_leaf=lambda t: isinstance(t, JQ.QuantizedTensor))
    tq = TQ.quantize_decode_params(
        convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu"), tc)
    td = DecodeConfig(**dk, weight_dtype="int8")
    js = jax_osdt.OSDTSession(jdq, jc, JDecodeConfig(**dk), tok.MASK_ID,
                              attn_impl="kernel")
    ts = torch_osdt.OSDTSession(tq, tc, td, tok.MASK_ID, gen_fn=(
        make_generate_fn(tc, td, attn_impl="kernel", use_kernel=True)))
    prompts = tok.batch_prompts(
        [tok.encode(s, bos=True) for s in
         ("Q: 2+3=?", "Q: what is 7*6?", "say hi", "count: 1 2 3")], 16)
    for rows in (prompts[:1], prompts):
        jr = js.generate(jnp.asarray(rows))
        tr = ts.generate(np.asarray(rows))
        _assert_same(jr, tr)
    assert ts.calibrated and js.calibrated
    np.testing.assert_allclose(js.table, ts.table, rtol=0, atol=ATOL)
    assert int(tr.thr_steps.sum()) > 0


def test_weight_dtype_normalized_and_refused(models):
    """``weight_dtype`` defaults to the DecodeConfig's and unknown dtypes
    are refused, as in the reference; it does not route the weights,
    which go by type: int8 params decode the same under either name."""
    _, tc, _, tq, _ = models
    td = DecodeConfig(**DK)
    args = (np.zeros((1, 8), np.int32), _table(td.num_blocks, td.steps_cap),
            MASK)
    with pytest.raises(ValueError, match="fp4"):
        make_generate_fn(tc, td, weight_dtype="fp4")
    with pytest.raises(ValueError, match="fp4"):
        make_generate_fn(tc, DecodeConfig(**DK, weight_dtype="fp4"))
    dq = DecodeConfig(**DK, weight_dtype="int8")
    a = make_generate_fn(tc, dq)(tq, *args)               # "" -> int8
    b = make_generate_fn(tc, td, weight_dtype="int8")(tq, *args)
    c = make_generate_fn(tc, td)(tq, *args)               # "" -> bf16
    for r in (b, c):
        assert torch.equal(a.tokens, r.tokens) and a.nfe == r.nfe
        assert torch.equal(a.conf, r.conf)


# ---------------------------------------------------------------------------
# K6's plain version and the fused int8 epilogue
# ---------------------------------------------------------------------------

def _k6_case(R, M, V, tied, seed):
    """x, the int8 head quantized per vocab channel by both quantizers
    (bitwise equal), and thresholds straddling the confidences."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, M)).astype(np.float32)
    w = rng.standard_normal((V, M) if tied else (M, V)).astype(np.float32)
    axis = -1 if tied else -2
    jqt = JQ.quantize_tensor(jnp.asarray(w), axis=axis)
    tqt = TQ.quantize_tensor(torch.tensor(w), axis=axis)
    _equal_qt(jqt, tqt)
    conf0, _ = jref.confidence_ref(jnp.einsum(
        "rm,vm->rv" if tied else "rm,mv->rv", jnp.asarray(x),
        JQ.dequantize(jqt)))
    tau = (np.asarray(conf0) * rng.uniform(0.5, 1.5, R)).astype(np.float32)
    masked = rng.random(R) < 0.7
    return x, jqt, tqt, tau, masked


@pytest.mark.parametrize("R,M,V", [(13, 200, 1000), (8, 64, 513)])
@pytest.mark.parametrize("tied", [True, False])
def test_quantized_fused_step_plain_matches_pallas(R, M, V, tied):
    """The port's plain K6 against the reference's Pallas kernel in
    interpret mode and its off-TPU ``ops.fused_step`` (the oracle on the
    float32-dequantized head): conf at 1e-5, tokens and selections
    equal."""
    x, jqt, tqt, tau, masked = _k6_case(R, M, V, tied, R + V)
    jargs = [jnp.asarray(a) for a in (x, tau, masked)]
    jc, jt, ja = quantized_fused_step_pallas(
        jargs[0], jqt.q, jqt.scale, jargs[1], jargs[2], tied=tied,
        vocab_tile=256, interpret=True)
    tc, tt, ta = quantized_fused_step_kernel(
        torch.tensor(x), tqt.q, tqt.scale, torch.tensor(tau),
        torch.tensor(masked), tied=tied)
    _close(jc, tc)
    np.testing.assert_array_equal(np.asarray(jt), _np(tt))
    np.testing.assert_array_equal(np.asarray(ja), _np(ta))
    assert 0 < int(ta.sum()) < R
    oc, ot, oa = jops.fused_step(*jargs[:1], jqt, *jargs[1:], tied=tied)
    _close(oc, tc)
    np.testing.assert_array_equal(np.asarray(ot), _np(tt))
    np.testing.assert_array_equal(np.asarray(oa), _np(ta))
    # the entry point routes the int8 head to K6 and keeps leading dims
    ec, et, ea = ops.fused_step(torch.tensor(x)[None], tqt,
                                torch.tensor(tau)[None],
                                torch.tensor(masked)[None], tied=tied)
    assert ec.shape == (1, R)
    assert torch.equal(ec[0], tc) and torch.equal(et[0], tt) \
        and torch.equal(ea[0], ta)


@pytest.mark.parametrize("tied", [True, False])
def test_quantized_fused_step_quota_matches_reference(tied):
    """quota > 0 with an int8 head: the top-quota of each block row's
    masked confidences, as the reference's Pallas kernel (interpret) and
    its oracle give it."""
    B, bs, M, V, quota = 3, 8, 64, 300, 3
    x, jqt, tqt, _, _ = _k6_case(B * bs, M, V, tied, 11)
    x = x.reshape(B, bs, M)
    rng = np.random.default_rng(12)
    tau = np.zeros((B, bs), np.float32)
    masked = rng.random((B, bs)) < 0.6
    jargs = [jnp.asarray(a) for a in (x, tau, masked)]
    targs = [torch.tensor(a) for a in (x, tau, masked)]
    tc, tt, ta = ops.fused_step(targs[0], tqt, *targs[1:], tied=tied,
                                quota=quota)
    for interpret in (True, False):
        jc, jt, ja = jops.fused_step(jargs[0], jqt, *jargs[1:], tied=tied,
                                     quota=quota, interpret=interpret)
        _close(jc, tc)
        np.testing.assert_array_equal(np.asarray(jt), _np(tt))
        np.testing.assert_array_equal(np.asarray(ja), _np(ta))
    assert int(ta.sum()) == int(np.minimum(masked.sum(-1), quota).sum())


def test_quantized_fused_step_plain_is_the_float32_dequant():
    """The plain K6 contracts f32(x) with the float32 dequantized head
    (one multiply, not rounded to x's dtype): for bf16 x it equals the
    plain K3 on x widened to f32 and that head."""
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal((6, 32)).astype(np.float32)) \
        .to(torch.bfloat16)
    qt = TQ.quantize_tensor(
        torch.tensor(rng.standard_normal((32, 50)).astype(np.float32)), -2)
    tau = torch.full((6,), 0.03)
    masked = torch.ones(6, dtype=torch.bool)
    got = ref.quantized_fused_step_ref(x, qt.q, qt.scale, tau, masked,
                                       tied=False)
    want = ref.fused_step_ref(x.float(), TQ.dequantize(qt), tau, masked,
                              tied=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_quantized_fused_step_kernel_refuses_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        quantized_fused_step_kernel(
            torch.empty((2, 8), **meta),
            torch.empty((8, 4), dtype=torch.int8, **meta),
            torch.empty((1, 4), **meta), torch.empty((2,), **meta),
            torch.empty((2,), dtype=torch.bool, **meta), tied=False)


def _generate_pair(models, cache_mode, layout, quota=0, fusions=("fused",)):
    """The reference's int8 generate (fused epilogue) and the port's int8
    generates for each of ``fusions``, on the same converted weights."""
    jc, tc, jq, tq, _ = models
    jd = JDecodeConfig(**DK, cache_layout=layout, page_size=8)
    td = DecodeConfig(**DK, cache_layout=layout, page_size=8,
                      weight_dtype="int8")
    rng = np.random.default_rng(17)
    B, P = 2, 16
    prompt = rng.integers(0, 256, (B, P)).astype(np.int32)
    table = _table(td.num_blocks, td.steps_cap)
    jargs = [jnp.asarray(prompt), jnp.asarray(table), jnp.asarray(MASK),
             None, None]
    pool = pt = None
    if layout == "paged":
        n_log = td.pages_per_seq(_max_len(cache_mode, P))
        pt = rng.permutation(B * n_log + 2)[:B * n_log] \
            .reshape(B, n_log).astype(np.int32)
        shape = (tc.num_layers, B * n_log + 2, 8, tc.num_kv_heads,
                 tc.resolved_head_dim)
        pool = np.zeros(shape, np.float32)
        jargs += [jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(pt)]
    kw = dict(cache_mode=cache_mode, attn_impl="kernel", use_kernel=True,
              quota=quota)
    jkw = dict(kw, attn_impl="auto") if cache_mode == "none" else kw
    jres = jax_make_generate_fn(jc, jd, weight_dtype="int8",
                                step_fusion="fused", **jkw)(jq, *jargs)
    tres = []
    for fusion in fusions:
        targs = [prompt, table, MASK, None, None]
        if layout == "paged":
            # the port writes its pool in place: a fresh one each run
            targs += [torch.tensor(pool), torch.tensor(pool),
                      torch.tensor(pt)]
        tres.append(make_generate_fn(tc, td, step_fusion=fusion, **kw)(
            tq, *targs))
    return jres, tres


@pytest.mark.parametrize("cache_mode,layout", [
    ("prefix", "dense"), ("dual", "dense"), ("none", "dense"),
    ("prefix", "paged"), ("dual", "paged")])
def test_generate_fused_int8_matches_reference(models, cache_mode, layout):
    """The port's fused int8 generate (K6's plain version) equals the
    reference's fused int8 generate on the same converted weights, and
    the port's own unfused int8 generate (K5's float32 head, then the
    confidence pass): tokens, NFE and steps equal, conf within 1e-5."""
    jres, (fused, unfused) = _generate_pair(
        models, cache_mode, layout, fusions=("fused", "unfused"))
    _assert_same(jres, fused)
    assert fused.nfe == unfused.nfe
    for f in EXACT:
        assert torch.equal(getattr(fused, f), getattr(unfused, f)), f
    torch.testing.assert_close(fused.conf, unfused.conf, rtol=0, atol=ATOL)
    assert fused.steps_per_block.max() > 1 and fused.thr_steps.sum() > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_generate_fused_int8_quota_matches_reference(models, layout):
    """The fixed-step baseline (quota 2) through the fused int8 epilogue:
    the in-kernel top-k ranking against the reference's."""
    jres, (fused,) = _generate_pair(models, "prefix", layout, quota=2)
    _assert_same(jres, fused)
    assert int(fused.steps_per_block.max()) == DK["block_size"] // 2
