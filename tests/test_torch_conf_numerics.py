"""The confidence kernel's arithmetic (K2), on the CPU.

``csrc/confidence.cu`` runs only on the card. What can be checked here is
kept in Python: that the launch plan (``kernels.confidence.plan``) fits
the card and matches the source's constants, and that the kernel's order
of operations, emulated in numpy float32, gives the reference's function:
each thread folds its 16-byte vectors in column order (the vector's max,
one rescale of the running sum, four exp2 of the scaled differences), the
scalar head and tail of a row that is not 16-byte aligned go to ranks 0
and C - 1, a butterfly merges each warp's lanes and another the CTA's
warps, and the cluster's CTAs give the row's max and first column, then
their sums, rescaled to that max, added in rank order. Held against ``ref.confidence_ref`` and the
reference's Pallas kernel in interpret mode: conf within 1e-6 relative
(float32 sums in another order), tokens exact, including equal maxima
that fall in different splits.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.confidence import fused_confidence_pallas
from repro_torch.kernels import confidence as k2
from repro_torch.kernels.ref import confidence_ref

_SRC = (pathlib.Path(k2.__file__).resolve().parent / "csrc"
        / "confidence.cu").read_text()
_F32 = np.float32
_LOG2E = _F32(1.4426950408889634)
_INT_MAX = 2 ** 31 - 1
_CONF_REL = 1e-6


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def _exp_diff(x, m):
    """exp2f((x - m) * log2 e) in float32."""
    with np.errstate(invalid="ignore", over="ignore"):
        return np.exp2(((x - m).astype(_F32) * _LOG2E).astype(_F32))


def _fma(a, b, c):
    """fmaf: a * b exact, plus c, rounded once to float32."""
    return (a.astype(np.float64) * b + c).astype(_F32)


def _push(acc, vals, col):
    """``push4`` (vals [..., 4]) or ``push1`` (vals [..., 1]) on every
    thread at once: columns col .. col + n - 1."""
    m0, s0, i0 = acc
    vm = vals.max(axis=-1)
    m = np.maximum(m0, vm)
    d = _exp_diff(vals, m[..., None])
    e = d[..., 0] if vals.shape[-1] == 1 else \
        (d[..., 0] + d[..., 1]) + (d[..., 2] + d[..., 3])
    s = _fma(s0, _exp_diff(m0, m), e)
    first = np.argmax(vals == vm[..., None], axis=-1)
    idx = np.where(vm > m0, col + first, i0)
    return m, np.where(m == -np.inf, s0, s), idx


def _merge(a, b):
    """``acc_merge``: the larger max wins, the smaller column on a tie."""
    (am, as_, ai), (bm, bs, bi) = a, b
    m = np.maximum(am, bm)
    with np.errstate(invalid="ignore"):
        s = _fma(as_, np.exp(am - m), (bs * np.exp(bm - m)).astype(_F32))
    idx = np.where(am > bm, ai, np.where(bm > am, bi, np.minimum(ai, bi)))
    return m, np.where(m == -np.inf, _F32(0), s), idx


def _butterfly(acc):
    """``acc_shfl_reduce`` over the last axis (the lanes): each lane
    merges with its partner at distance width / 2, width / 4, ...; lane
    0's result."""
    lane = np.arange(acc[0].shape[-1])
    off = lane.size // 2
    while off:
        acc = _merge(acc, _take(acc, (Ellipsis, lane ^ off)))
        off //= 2
    return _take(acc, (Ellipsis, 0))


def _take(acc, key):
    return tuple(a[key] for a in acc)


def emulate(x: np.ndarray, cluster: int, base: int = 0):
    """K2 on ``x`` [R, V] float32 whose first element lies ``base`` floats
    past a 16-byte boundary, with ``cluster`` CTAs a row: (conf, tok)."""
    R, V = x.shape
    C, T, U = cluster, k2.THREADS, k2.UNROLL
    t = np.arange(T)
    conf, tok = np.empty(R, _F32), np.empty(R, np.int32)
    for r in range(R):
        row = x[r]
        head = min(V, -(base + r * V) % 4)
        nvec = (V - head) // 4
        tail0 = head + 4 * nvec
        vec = row[head:tail0].reshape(nvec, 4)
        share = -(-nvec // C)
        v0 = np.minimum(nvec, np.arange(C) * share)[:, None]
        v1 = np.minimum(nvec, v0 + share)
        acc = (np.full((C, T), -np.inf, _F32), np.zeros((C, T), _F32),
               np.full((C, T), _INT_MAX, np.int64))
        # pushing -inf leaves an accumulator as it is: idle threads do so
        vals = np.full((C, T, 1), -np.inf, _F32)
        vals[0, :head, 0] = row[:head]
        acc = _push(acc, vals, t)
        for it in range(-(-share // (T * U))):
            for j in range(U):
                v = v0 + t + it * T * U + j * T
                ok = v < v1
                vals = np.where(ok[..., None], vec[np.minimum(v, nvec - 1)],
                                _F32(-np.inf))
                acc = _push(acc, vals, head + 4 * v)
        vals = np.full((C, T, 1), -np.inf, _F32)
        vals[C - 1, :V - tail0, 0] = row[tail0:]
        acc = _push(acc, vals, tail0 + t)
        # a butterfly over each warp's lanes, one over the CTA's warps;
        # then the cluster: the max over ranks, its first column, and the
        # partial sums rescaled to the max, added in rank order
        m, s, idx = _butterfly(_butterfly(
            tuple(a.reshape(C, T // 32, 32) for a in acc)))
        mx = m.max()
        first = idx[m == mx].min()
        e = np.where(mx == -np.inf, _F32(0), s * _exp_diff(m, mx))
        total = e[0]
        for k in range(1, C):
            total = total + e[k]
        with np.errstate(divide="ignore"):
            conf[r] = _F32(1) / total
        tok[r] = 0 if first == _INT_MAX else first
    return conf, tok


def _close(conf, tok, want_conf, want_tok):
    want_conf = np.asarray(want_conf, np.float64)
    rel = np.abs(np.asarray(conf, np.float64) - want_conf) / want_conf
    assert float(rel.max()) <= _CONF_REL, float(rel.max())
    np.testing.assert_array_equal(np.asarray(tok), np.asarray(want_tok))


def _planted(R, V, cluster, seed):
    """Integer logits (0..3) with a 9 at a first column in split
    r % (C - 1) of row r, again in a later thread or lane of the vector,
    in the same thread's next load, and twice in later splits: the first
    column must win. Returns (x, first columns)."""
    x = np.random.default_rng(seed).integers(0, 4, (R, V)).astype(_F32)
    C, split = cluster, 4 * -(-(V // 4) // cluster)  # the plan's split
    first = []
    for r in range(R):
        c0 = (r % max(C - 1, 1)) * split + (37 * r) % (split // 2)
        x[r, [min(V - 1, c) for c in (
            c0, c0 + 4 * r + 1, c0 + 4 * k2.THREADS, c0 + split + 3 * r,
            c0 + 2 * split + 3 * r)]] = 9.0
        first.append(c0)
    return x, np.array(first, np.int32)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [126464, 5001, 513])
@pytest.mark.parametrize("R", [1, 32, 256, 1024])
def test_plan_fits_the_card(R, V):
    """2 to 16 CTAs a cluster, a power of two, so the grid of R * C CTAs
    is whole clusters; the smallest such C that gives each of the 132 SMs
    a CTA, so the main path's R = 32 (Phase 1) and 256 (Phase 2) fill the
    card and still fit in one wave; the split covers the row's whole
    vectors."""
    p = k2.plan(R, V)
    C = p.cluster
    assert 2 <= C <= k2.MAX_CLUSTER == 16 and C & (C - 1) == 0
    assert R * C >= k2.SMS == 132 or C == 16
    assert C == 2 or R * C // 2 < k2.SMS
    if R in (32, 256):
        assert 132 <= R * C <= 4 * k2.SMS
    assert p.split % 4 == 0 and p.split * C >= 4 * (V // 4) > \
        (p.split - 4) * C
    assert (k2.plan(32, V).cluster, k2.plan(256, V).cluster) == (8, 2)


def test_source_constants_match_the_plan():
    """The plan's threads, loads a thread and largest cluster are the
    source's, the kernel declares the occupancy of one wave (four CTAs a
    SM), and the source holds one kernel, launched once with a cluster
    dimension: no finishing pass."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             _SRC).group(1))

    assert const("kThreads") == k2.THREADS
    assert const("kUnroll") == k2.UNROLL
    assert const("kMaxCluster") == k2.MAX_CLUSTER
    assert "__launch_bounds__(kThreads, 4)" in _SRC
    assert _SRC.count("__global__") == 1 and "<<<" not in _SRC
    assert _SRC.count("cudaLaunchKernelEx(") == 1
    assert "cudaLaunchAttributeClusterDimension" in _SRC
    assert "confidence_finish" not in _SRC


# ---------------------------------------------------------------------------
# the emulated order against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,V,base,plan_rows", [
    # the main path's rows at the plans of R = 32 (8 CTAs) and 256 (2),
    # and one row's (16)
    (3, 126464, 0, 32),
    (2, 126464, 0, 256),
    (1, 126464, 0, 1),
    # ragged vocabularies: each row starts at another offset
    (5, 5001, 0, 32),
    (4, 513, 1, 256),
    (3, 1002, 2, 1024),
    # rows shorter than a vector, and than one vector past the head
    (4, 3, 1, 32),
    (3, 6, 3, 1),
])
def test_emulation_matches_reference(R, V, base, plan_rows):
    x = (np.random.default_rng(V + base).standard_normal((R, V)) * 3) \
        .astype(_F32)
    conf, tok = emulate(x, k2.plan(plan_rows, V).cluster, base)
    rc, rt = confidence_ref(torch.from_numpy(x))
    _close(conf, tok, rc.numpy(), rt.numpy())
    if V <= 5001:
        jc, jt = fused_confidence_pallas(jnp.asarray(x), vocab_tile=512,
                                         interpret=True)
        _close(conf, tok, np.asarray(jc), np.asarray(jt))


@pytest.mark.parametrize("R,V,base,plan_rows", [
    (4, 126464, 0, 32),
    (6, 5001, 2, 1),
    (5, 5001, 0, 256),
])
def test_emulation_ties_across_splits(R, V, base, plan_rows):
    """Equal maxima in different splits of the plan (and twice in one):
    the first column wins, as in argmax and the Pallas kernel."""
    C = k2.plan(plan_rows, V).cluster
    x, first = _planted(R, V, C, seed=R)
    conf, tok = emulate(x, C, base)
    np.testing.assert_array_equal(tok, first)
    rc, rt = confidence_ref(torch.from_numpy(x))
    _close(conf, tok, rc.numpy(), rt.numpy())
    if V <= 5001:
        jc, jt = fused_confidence_pallas(jnp.asarray(x), vocab_tile=512,
                                         interpret=True)
        _close(conf, tok, np.asarray(jc), np.asarray(jt))


def test_emulation_integer_ties_and_an_all_ninf_row():
    """Integer logits tie everywhere: the first maximum wins. An all -inf
    row has no maximum: token 0 and conf inf, as the kernel gave before
    (its sum stays 0)."""
    x = np.random.default_rng(3).integers(0, 4, (9, 5000)).astype(_F32)
    conf, tok = emulate(x, k2.plan(9, 5000).cluster)
    rc, rt = confidence_ref(torch.from_numpy(x))
    _close(conf, tok, rc.numpy(), rt.numpy())
    x[4] = -np.inf
    conf, tok = emulate(x, k2.plan(9, 5000).cluster)
    assert tok[4] == 0 and np.isinf(conf[4])
    keep = np.arange(9) != 4
    _close(conf[keep], tok[keep], rc.numpy()[keep], rt.numpy()[keep])


def test_split_merge_needs_its_rescale():
    """The rescale of each split's sum by exp(m_i - m) at the cluster
    merge is what keeps conf: adding the splits' sums as they are (the
    replay's ``merge_without_rescale`` fault) misses by far more than the
    1e-4 bar of the card check."""
    x = (np.random.default_rng(5).standard_normal((4, 126464)) * 3) \
        .astype(_F32)
    split = k2.plan(32, x.shape[1]).split
    rc, _ = confidence_ref(torch.from_numpy(x))
    parts = [confidence_ref(torch.from_numpy(
        np.ascontiguousarray(x[:, c:c + split])))[0]
        for c in range(0, x.shape[1], split)]
    wrong = 1 / sum(1 / p for p in parts)
    assert float(((wrong - rc).abs() / rc).min()) > 1e-2
