"""The head body's arithmetic (K6 and K5's float32 output), on the CPU.

``csrc/head_wgmma.cuh`` runs only on the card. What can be checked here
is kept in Python: that its operands are exact (every int8 weight is a
bf16 value; three bf16 terms rebuild float32 x, and bf16 x is one term),
that its order of sums (bf16 products exact in f32, 16 deep a tensor-core
step, the steps in order over the whole contraction, the scale applied
once after the sum), emulated in numpy, stays within the bounds of
``chip_smoke.py``'s checks at LLaDA-8B's contraction depths, why f32 x
takes three terms and a second accumulator for the small ones, and that
the wrappers' tile constants are the source's.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import head as hd
from repro_torch.kernels.ref import (confidence_ref, quantized_fused_step_ref,
                                     quantized_matmul_ref)
from repro_torch.models.quantize import quantize_tensor

_HEAD = (pathlib.Path(fs.__file__).resolve().parent / "csrc"
         / "head_wgmma.cuh").read_text()
ROWS, COLS = 32, 256


def _bf16(a) -> np.ndarray:
    """float32 values rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _split(x: np.ndarray):
    """The three bf16 terms of ``split_terms``: hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each difference in f32."""
    hi = _bf16(x)
    r = (x - hi).astype(np.float32)
    mid = _bf16(r)
    lo = _bf16((r - mid).astype(np.float32))
    return hi, mid, lo


def _toward_zero(s: np.ndarray) -> np.ndarray:
    """float64 values rounded to float32 toward zero (a truncating adder)."""
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def _body(terms, q: np.ndarray, scale: np.ndarray, rounding: str,
          accumulators: int = 2) -> np.ndarray:
    """The head body's logits for x given as bf16 ``terms`` (hi first)
    and q int8 [K, V]: per 64-deep stage, the small terms' 16-deep steps
    (lo, then mid) into a second accumulator (or, with ``accumulators``
    = 1, into the first) and hi's into the first, each step's products
    (exact in f32) summed and rounded once into its accumulator with
    ``rounding`` ("nearest" or "toward_zero"); after the K loop the two
    accumulators added and the sum multiplied by the scale, in f32."""
    rnd = (lambda s: s.astype(np.float32)) if rounding == "nearest" \
        else _toward_zero
    K, V = q.shape
    q64 = q.astype(np.float64)
    acc = np.zeros((terms[0].shape[0], V), np.float32)
    acc2 = np.zeros_like(acc)
    for k0 in range(0, K, 64):
        for i in list(range(len(terms) - 1, 0, -1)) + [0]:
            for kk in range(k0, min(K, k0 + 64), 16):
                step = terms[i][:, kk:kk + 16].astype(np.float64) \
                    @ q64[kk:kk + 16]
                if i and accumulators == 2:
                    acc2 = rnd(acc2.astype(np.float64) + step)
                else:
                    acc = rnd(acc.astype(np.float64) + step)
    acc = (acc + acc2).astype(np.float32)
    return (acc * scale.reshape(1, -1)).astype(np.float32)


def _inputs(K: int, bf16_x: bool, seed: int = 0):
    g = np.random.default_rng(K + seed)
    x = g.standard_normal((ROWS, K)).astype(np.float32)
    if bf16_x:
        x = _bf16(x)
    w = torch.tensor(g.standard_normal((K, COLS)), dtype=torch.float32) \
        * K ** -0.5
    return x, quantize_tensor(w, axis=-2)


def _oracle(x: np.ndarray, qt) -> torch.Tensor:
    """ref.quantized_matmul_ref on the widened x: f32(x) . (f32(q) *
    scale), contracted in float32."""
    return quantized_matmul_ref(torch.from_numpy(x), qt.q, qt.scale,
                                transpose=False, out_dtype=torch.float32)


def _f32_miss(out, want) -> float:
    """max |out - want| over chip_smoke.py's f32_close bound, 1e-4
    rms(want): <= 1 holds it."""
    out = torch.as_tensor(out)
    return float((out - want).abs().max()) / \
        (1e-4 * float(want.square().mean().sqrt()))


# ---------------------------------------------------------------------------
# exact operands
# ---------------------------------------------------------------------------

def test_every_int8_value_is_exact_in_bf16():
    """q in [-128, 127] is a bf16 value, and the body's conversion (the
    byte q ^ 0x80 under the float 2^23, minus 2^23 + 128) gives it
    exactly."""
    q = np.arange(-128, 128)
    assert np.array_equal(_bf16(q), q.astype(np.float32))
    u = (q.astype(np.int64) & 0xFF) ^ 0x80
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32)
    assert np.array_equal(f - np.float32(8388736.0), q.astype(np.float32))


def test_three_terms_rebuild_f32_x():
    """hi + mid + lo is x to within 2^-24 relative, over normal values and
    over exponents from 2^-60 to 2^60 (exactly, here); bf16 keeps 8
    significant bits, so one term alone misses by up to 2^-9."""
    g = np.random.default_rng(3)
    for x in (g.standard_normal(100_000).astype(np.float32),
              (np.exp2(g.uniform(-60, 60, 100_000))
               * g.choice([-1, 1], 100_000)).astype(np.float32)):
        hi, mid, lo = _split(x)
        rebuilt = hi.astype(np.float64) + mid + lo
        rel = np.abs(rebuilt - x) / np.abs(x)
        assert rel.max() <= 2.0 ** -24
        assert rel.max() == 0.0
        assert np.abs(hi - x).max() / np.abs(x).max() > 2.0 ** -12


def test_bf16_x_is_one_term():
    """bf16-valued x (the main path's final norm output) splits into
    itself and zeros: one term carries it."""
    x = _bf16(np.random.default_rng(4).standard_normal(50_000) * 7)
    hi, mid, lo = _split(x)
    assert np.array_equal(hi, x)
    assert not mid.any() and not lo.any()


# ---------------------------------------------------------------------------
# the body's order of sums against the checks' bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
@pytest.mark.parametrize("bf16_x", [True, False])
@pytest.mark.parametrize("K", [4096, 12288])
def test_body_order_within_the_checks(K, bf16_x, rounding):
    """At K = 4096 (the head) and 12288, the emulated body (one term for
    bf16 x, three for f32 x) lies within f32_close of the oracle, and
    through the fused step within K6's check bars: conf within 1e-3
    relative, tokens equal wherever the plain top-2 gap exceeds twice the
    f32 sum-order bound (K 2^-24 sum|x w|), ``above`` equal wherever conf
    is 1e-3 away from tau."""
    x, qt = _inputs(K, bf16_x)
    terms = (x,) if bf16_x else _split(x)
    q, scale = qt.q.numpy(), qt.scale.numpy()
    emu = torch.from_numpy(_body(terms, q, scale, rounding))
    want = _oracle(x, qt)
    assert _f32_miss(emu, want) <= 1.0
    xt = torch.from_numpy(x)
    c0, _ = confidence_ref(want)
    tau = c0 * torch.where(torch.arange(ROWS) % 2 == 0, 0.8, 1.25)
    tau[:4] = c0[:4] * torch.tensor([0.9995, 1.0005, 0.99999, 1.00001])
    masked = torch.ones(ROWS, dtype=torch.bool)
    rc, rt, ra = quantized_fused_step_ref(xt, qt.q, qt.scale, tau, masked,
                                          tied=False)
    ec, et = confidence_ref(emu)
    ea = masked & (ec > tau)
    assert float(((ec - rc).abs() / rc).max()) <= 1e-3
    w = qt.q.float() * qt.scale
    gap_bound = 2 * K * 2.0 ** -24 * (xt.abs() @ w.abs()).amax(dim=-1)
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > gap_bound
    assert bool(clear.any()) and not bool(((et != rt) & clear).any())
    far = (rc - tau).abs() > 1e-3 * rc
    assert bool(far.any()) and not bool((~far).all())
    assert not bool(((ea != ra) & far).any())


def test_tf32_x_misses_f32_close():
    """x rounded to TF32 (10-bit mantissa), as a TF32 product would take
    it, misses the float32 bound by far: the body keeps f32 x whole."""
    x, qt = _inputs(4096, bf16_x=False)
    tf32 = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    assert _f32_miss(_oracle(tf32, qt), _oracle(x, qt)) > 5.0


@pytest.mark.parametrize("K", [4096, 12288])
def test_two_terms_do_not_rebuild_x(K):
    """hi + mid leaves up to ~2^-17 of each x element, where three terms
    leave nothing: the two-term logits lie within f32_close here but
    several times further from the oracle than the three-term body's,
    which only the order of the sums moves."""
    x, qt = _inputs(K, bf16_x=False)
    hi, mid, lo = _split(x)
    residual = np.abs(x - (hi.astype(np.float64) + mid)) / np.abs(x)
    assert 2.0 ** -20 < residual.max() <= 2.0 ** -17
    q, scale = qt.q.numpy(), qt.scale.numpy()
    want = _oracle(x, qt)
    two = _f32_miss(_body((hi, mid), q, scale, "nearest"), want)
    three = _f32_miss(_body((hi, mid, lo), q, scale, "nearest"), want)
    assert three < two / 2 and two <= 1.0


def test_small_terms_need_their_own_accumulator():
    """With a truncating tensor-core adder, the three terms summed into one
    accumulator round the large running sum three times a step and miss
    f32_close at K = 12288; the small terms' own accumulator (the body's
    design) keeps the three-term body at the one-term body's error."""
    K = 12288
    x, qt = _inputs(K, bf16_x=False)
    q, scale = qt.q.numpy(), qt.scale.numpy()
    want = _oracle(x, qt)
    terms = _split(x)
    one = _f32_miss(_body(terms, q, scale, "toward_zero", accumulators=1),
                    want)
    two = _f32_miss(_body(terms, q, scale, "toward_zero", accumulators=2),
                    want)
    assert one > 1.0 >= two
    assert two < one / 3


# ---------------------------------------------------------------------------
# the wrappers' constants and plan
# ---------------------------------------------------------------------------

def test_wrapper_tiles_match_the_source():
    """The wrappers' column tile and block rows are the body's: kCols
    (= 64 kWG) columns a block, the ``launch_rows`` of each ``case``, and
    the 256-row block only for one term."""
    wg = int(re.search(r"constexpr int kWG = (\d+);", _HEAD).group(1))
    assert re.search(r"constexpr int kCols = 64 \* kWG;", _HEAD)
    assert {w for _, w in hd._TILES} == {64 * wg}
    cases = re.findall(r"case (\d):\s+(if constexpr \(NT == 1\)\s+)?"
                       r"return launch_rows<Head, (\d+), NT>", _HEAD)
    assert [(int(t), int(r)) for t, _, r in cases] == \
        [(i, rows) for i, (rows, _) in enumerate(hd._TILES)]
    assert [bool(g) for _, g, _ in cases] == [True, False, False]
    assert hd._TILES[0][0] == 256


@pytest.mark.parametrize("R,V,tied,aligned,terms,want", [
    # K6 and K5's head on the main path: 256 rows, TMA (V % 16 == 0)
    (256, 126464, False, True, 1, (0, 256, 128, True)),
    (1024, 126464, False, True, 1, (0, 256, 128, True)),
    # Phase 1's step and prefill
    (32, 126464, False, True, 1, (2, 64, 128, True)),
    (128, 126464, False, True, 1, (1, 128, 128, True)),
    # f32 x: three terms take at most 128 rows
    (256, 126464, False, True, 3, (1, 128, 128, True)),
    (40, 1000, True, True, 3, (2, 64, 128, True)),
    # an untied int8 row of V bytes must be 16-byte aligned (bf16: V % 8)
    (256, 1000, False, True, 1, (0, 256, 128, False)),
    (256, 1008, False, True, 1, (0, 256, 128, True)),
    (256, 513, True, False, 1, (0, 256, 128, False)),
])
def test_int8_plan(R, V, tied, aligned, terms, want):
    assert tuple(hd.plan(R, V, tied, aligned, int8=True, terms=terms)) == \
        want
    assert hd.plan(256, 1000, False, True).tma  # bf16: 2000-byte rows


@pytest.mark.parametrize("dtype,R,M,V,tied,want", [
    # the main path's head: bf16 x is one term, 256 rows, TMA
    (torch.bfloat16, 256, 64, 1008, False, (0, 256, 128, True)),
    # f32 x: three terms of scratch, at most 128 rows
    (torch.float32, 256, 64, 1008, False, (1, 128, 128, True)),
    (torch.float32, 40, 64, 1000, True, (2, 64, 128, True)),
    # rows of x (M bf16) or of a tied int8 head (M bytes) not 16-byte
    # aligned: plain loads
    (torch.bfloat16, 32, 40, 1008, True, (2, 64, 128, False)),
    (torch.bfloat16, 32, 36, 1008, False, (2, 64, 128, False)),
])
def test_int8_launch(dtype, R, M, V, tied, want):
    """``head.int8_launch``, which both int8-head wrappers call: no terms
    for bf16 x, [3, R, M] bf16 scratch for f32 x, and the plan of
    ``head.plan`` for that many terms with the alignment of the operands
    the body reads."""
    x = torch.zeros((R, M), dtype=dtype)
    q = torch.zeros((V, M) if tied else (M, V), dtype=torch.int8)
    terms, p = hd.int8_launch(x, q, V, tied)
    if dtype == torch.bfloat16:
        assert terms is None
    else:
        assert terms.shape == (3, R, M) and terms.dtype == torch.bfloat16
    assert tuple(p) == want


def test_one_term_decision_lives_in_the_body():
    """K6's and K5's float32-output entries both reach the body through
    ``head::launch_x``, the one place that splits f32 x into terms."""
    csrc = pathlib.Path(hd.__file__).resolve().parent / "csrc"
    assert _HEAD.count("split(static_cast<const float*>(x)") == 1
    for name in ("fused_step.cu", "quantized_matmul.cu"):
        src = (csrc / name).read_text()
        assert src.count("head::launch_x<head::Int8Head<") == 2
        assert "split(" not in src
