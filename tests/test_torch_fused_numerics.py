"""The bf16 fused step kernel's (K3's) plan and arithmetic, on the CPU.

K3 runs only on the card. What can be checked here is kept in Python:
the wrapper's block plan, the order of the f32 sums that its ``wgmma``
body takes (bf16 products, exact in f32, summed 16 deep a step, the steps
in order over the whole contraction), emulated in numpy and held to the
bound of ``chip_smoke.py``'s K3 check, and its epilogue's reduction of a
logit tile to one (max, sum-exp, argmax) partial per row and tile, merged
across tiles in any order, against ``ref.confidence_ref``.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import head as hd
from repro_torch.kernels.ref import confidence_ref, fused_step_ref

_CSRC = pathlib.Path(fs.__file__).resolve().parent / "csrc"
_CU = (_CSRC / "fused_step.cu").read_text()
_HEAD = (_CSRC / "head_wgmma.cuh").read_text()


@pytest.mark.parametrize("R,V,tied,aligned,want", [
    # the main path's block step: 256 rows x 128 columns, 988 tiles
    (256, 126464, False, True, (0, 256, 128, True)),
    # Phase 1's one row of 32: 64-row blocks, 988 of them
    (32, 126464, False, True, (2, 64, 128, True)),
    # chip_smoke.py's K3 check: tied_ragged_V and quota (V * 2 bytes a row
    # is not 16-byte aligned: plain loads)
    (40, 1000, True, True, (2, 64, 128, True)),
    (128, 3001, False, True, (1, 128, 128, False)),
    # past 256 rows, 256-row tiles; x unaligned means no TMA, tied or not
    (300, 2000, False, True, (0, 256, 128, True)),
    (40, 1000, True, False, (2, 64, 128, False)),
    # a tied head's rows are M long: V may be odd
    (256, 3001, True, True, (0, 256, 128, True)),
])
def test_plan(R, V, tied, aligned, want):
    p = hd.plan(R, V, tied, aligned)
    assert tuple(p) == want
    assert (p.rows, p.width) == hd._TILES[p.tile]
    assert p.rows >= min(R, 256)


def test_plan_picks_the_block_by_rows_alone():
    """The block's rows follow R alone (the fewest of 64, 128, 256 that
    hold it) and its width is always 128: V and the head's layout decide
    only between TMA and plain loads."""
    for R in (1, 32, 64, 65, 128, 129, 256, 300):
        want = 2 if R <= 64 else 1 if R <= 128 else 0
        for V in (1000, 5000, 11904, 126464):
            for tied in (False, True):
                p = hd.plan(R, V, tied, True)
                assert (p.tile, p.width) == (want, 128)


def test_plan_tiles_match_the_kernel_source():
    """The wrapper's tiles are the head body's: the
    ``launch_rows<Head, ROWS, NT>`` of each ``case`` of ``launch``, each
    64 ``kWG`` columns wide."""
    wg = int(re.search(r"constexpr int kWG = (\d+);", _HEAD).group(1))
    cases = re.findall(r"case (\d):\s+(?:if constexpr \(NT == 1\)\s+)?"
                       r"return launch_rows<Head, (\d+), NT>", _HEAD)
    assert [(int(r), 64 * wg) for _, r in sorted(cases)] == list(hd._TILES)
    assert [int(t) for t, _ in sorted(cases)] == list(range(len(hd._TILES)))
    assert re.search(r"constexpr int kVT = (\d+);", _CU).group(1) == \
        str(fs._F32_VT)


# ---------------------------------------------------------------------------
# the order of sums: wgmma steps of 16 products, the steps in order
# ---------------------------------------------------------------------------

def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
        .float().numpy()


def _toward_zero(s: np.ndarray) -> np.ndarray:
    """float64 values rounded to float32 toward zero (a truncating adder)."""
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def _wgmma_logits(x: np.ndarray, w: np.ndarray, rounding: str) -> np.ndarray:
    """x [R, M] @ w [M, V] as the kernel's f32 accumulator takes it: each
    16-deep step's products (exact: bf16 x bf16 fits f32) summed and
    rounded once to f32, then added to the running f32 sum, step after
    step over M. ``rounding`` is "nearest" or "toward_zero" (the tensor
    core's adder is not IEEE round-to-nearest; truncation is the worse
    case), for the step sums and the running adds alike."""
    rnd = (lambda s: s.astype(np.float32)) if rounding == "nearest" \
        else _toward_zero
    R, M = x.shape
    acc = np.zeros((R, w.shape[1]), dtype=np.float32)
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    for k0 in range(0, M, 16):
        step = rnd(x64[:, k0:k0 + 16] @ w64[k0:k0 + 16])
        acc = rnd(acc.astype(np.float64) + step.astype(np.float64))
    return acc


@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
def test_wgmma_sum_order_within_the_k3_check(rounding):
    """At the main path's M = 4096, the emulated wgmma logits stay within
    the K3 check's per-logit bound of the plain f32 product, M 2^-24
    sum|x w|; conf within the check's 1e-3 relative; tokens equal wherever
    the plain top-2 gap exceeds twice the bound."""
    g = np.random.default_rng(7)
    R, M, V = 8, 4096, 192
    x = _bf16(g.standard_normal((R, M)))
    w = _bf16(g.standard_normal((M, V)) * M ** -0.5)
    emu = torch.from_numpy(_wgmma_logits(x, w, rounding))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = xt @ wt
    bound = M * 2.0 ** -24 * (xt.abs() @ wt.abs())
    err = (emu - plain).abs()
    assert bool((err <= bound).all()), float((err / bound).max())
    # far inside: the check's bound is a sequential f32 sum's worst case
    assert float((err / bound).max()) < 0.1
    c_emu, t_emu = confidence_ref(emu)
    c_pl, t_pl = confidence_ref(plain)
    assert float(((c_emu - c_pl).abs() / c_pl).max()) <= 1e-3
    top2 = plain.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * bound.amax(dim=-1)
    assert bool(clear.any())
    assert not bool(((t_emu != t_pl) & clear).any())


def test_wgmma_sum_order_conf_through_the_fused_step():
    """The same emulated logits through the fused step's confidence:
    ``fused_step_ref`` on an f32 head that reproduces them exactly (x =
    identity) gives conf within 1e-3 of the plain bf16 fused step, and
    ``above`` equal wherever conf is 1e-3 away from tau."""
    g = np.random.default_rng(8)
    R, M, V = 4, 4096, 160
    x = _bf16(g.standard_normal((R, M)))
    w = _bf16(g.standard_normal((M, V)) * M ** -0.5)
    emu = torch.from_numpy(_wgmma_logits(x, w, "toward_zero"))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    c0, _ = confidence_ref(xt @ wt)
    tau = c0 * torch.tensor([0.8, 1.25, 0.999, 1.0005])
    masked = torch.ones(R, dtype=torch.bool)
    rc, _, ra = fused_step_ref(xt, wt, tau, masked, tied=False)
    ec, _, ea = fused_step_ref(torch.eye(R), emu, tau, masked, tied=False)
    assert float(((ec - rc).abs() / rc).max()) <= 1e-3
    far = (rc - tau).abs() > 1e-3 * rc
    assert bool(far.any()) and not bool(((ea != ra) & far).any())


# ---------------------------------------------------------------------------
# the epilogue: per-(row, tile) partials, merged in any order
# ---------------------------------------------------------------------------

def _first_max(v: torch.Tensor):
    """(max, first column of the max) over the last axis; an all -inf
    slice has no column (the kernel's INT_MAX)."""
    m = v.amax(dim=-1)
    idx = torch.argmax((v == m[..., None]).to(torch.int8), dim=-1)
    idx = torch.where(m == -torch.inf, torch.iinfo(torch.int32).max, idx)
    return m, idx


def _merge(a, b):
    """softmax_acc.cuh acc_merge in float32: the larger max wins, an equal
    max keeps the smaller column."""
    (am, as_, ai), (bm, bs, bi) = a, b
    m = torch.maximum(am, bm)
    fin = m != -torch.inf
    s = torch.where(fin, as_ * torch.exp(torch.where(fin, am - m, 0.0))
                    + bs * torch.exp(torch.where(fin, bm - m, 0.0)), 0.0)
    i = torch.where(am > bm, ai, torch.where(bm > am, bi,
                                             torch.minimum(ai, bi)))
    return m, s, i


def _tile_partials(logits: torch.Tensor, width: int):
    """The wgmma body's epilogue over ``width``-column tiles: each warp's
    16 columns (lane g holds columns g and g + 8) reduced to (max, first
    column) and the sum of exp(x - max) by xor-butterflies over the 8
    lanes, then the tile's warps merged in order. Columns past V are
    -inf. Returns (m, s, idx), each [ntiles, R]."""
    R, V = logits.shape
    nt = -(-V // width)
    pad = torch.full((R, nt * width), -torch.inf)
    pad[:, :V] = logits
    warps = pad.reshape(R, nt, width // 16, 16).permute(1, 2, 0, 3)
    m, idx = _first_max(warps)                      # [nt, nw, R]
    base = torch.arange(nt)[:, None, None] * width + \
        torch.arange(width // 16)[None, :, None] * 16
    idx = torch.where(idx == torch.iinfo(torch.int32).max, idx, idx + base)
    fin = (m != -torch.inf)[..., None]
    e = torch.exp(torch.where(fin, warps - m[..., None], -torch.inf))
    s = e[..., :8] + e[..., 8:]                     # lane g: g and g + 8
    for off in (1, 2, 4):                           # lanes xor 4, 8, 16
        s = s + s[..., torch.arange(8) ^ off]
    s = s[..., 0]
    part = (m[:, 0], s[:, 0], idx[:, 0])
    for wi in range(1, width // 16):
        part = _merge(part, (m[:, wi], s[:, wi], idx[:, wi]))
    return part


def _merged(part, order):
    acc = (torch.full_like(part[0][0], -torch.inf),
           torch.zeros_like(part[1][0]),
           torch.full_like(part[2][0], torch.iinfo(torch.int32).max))
    for t in order:
        acc = _merge(acc, (part[0][t], part[1][t], part[2][t]))
    m, s, i = acc
    return 1.0 / s, torch.where(i == torch.iinfo(torch.int32).max, 0, i)


@pytest.mark.parametrize("width", sorted({w for _, w in hd._TILES}))
@pytest.mark.parametrize("V", [5000, 1003])
def test_tile_partials_merge_to_the_confidence(width, V):
    """Per-tile partials at the plan's tile widths, merged in tile order,
    in reverse and in a random order: conf within 1e-6 relative of
    ``ref.confidence_ref`` and its argmax exactly, planted ties going to
    the smaller column (in one warp, across warps of a tile, across
    tiles), a ragged last tile masked."""
    g = np.random.default_rng(width + V)
    R = 6
    logits = torch.tensor(g.standard_normal((R, V)) * 3, dtype=torch.float32)
    top = logits.amax(dim=-1) + 1.0
    ties = [(0, 3, 11),                   # one warp: columns g and g + 8
            (1, 5, 40),                   # two warps of the first tile
            (2, 7, width + 9),            # two tiles
            (3, V - 2, V - 1),            # the ragged last tile
            (4, width - 1, 2 * width)]    # tile edges
    for r, a, b in ties:
        logits[r, a] = logits[r, b] = top[r]
    logits[5, V - 1] = top[5]             # the last column alone
    part = _tile_partials(logits, width)
    want_c, want_t = confidence_ref(logits)
    assert [int(want_t[r]) for r, a, _ in ties] == [a for _, a, _ in ties]
    nt = part[0].shape[0]
    for order in (range(nt), range(nt - 1, -1, -1),
                  g.permutation(nt).tolist()):
        conf, tok = _merged(part, order)
        torch.testing.assert_close(conf, want_c, rtol=1e-6, atol=0)
        assert torch.equal(tok.to(torch.int32), want_t)


def test_tile_partials_of_an_all_masked_tile():
    """A tile wholly past V (m = -inf) merges as nothing, and the row's
    partials stay finite; a single-column vocabulary takes column 0."""
    logits = torch.tensor([[1.0, 2.0, 2.0]])
    part = _tile_partials(logits, 64)
    assert part[0].shape == (1, 1) and float(part[1][0, 0]) > 0
    empty = (torch.tensor([-torch.inf]), torch.tensor([0.0]),
             torch.tensor([torch.iinfo(torch.int32).max]))
    m, s, i = _merge((part[0][0], part[1][0], part[2][0]), empty)
    assert (float(m), int(i)) == (2.0, 1) and torch.isfinite(s).all()
    conf, tok = _merged(_tile_partials(torch.tensor([[0.5]]), 128), [0])
    assert (float(conf), int(tok)) == (1.0, 0)
