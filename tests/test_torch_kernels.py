"""The plain versions of the port's three kernels (what their wrappers run
for CPU tensors) against the reference's Pallas kernels in interpret mode
and its ``ref`` oracles, on the same numpy inputs (float32, atol 1e-5,
tokens and selections equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.block_attention import cached_block_attention_pallas
from repro.kernels.confidence import fused_confidence_pallas
from repro.kernels.fused_step import fused_step_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.block_attention import (
    cached_block_attention_kernel, kv_limit_from_pos, row_scalars)
from repro_torch.kernels.confidence import fused_confidence_kernel
from repro_torch.kernels.fused_step import fused_step_kernel

ATOL = 1e-5


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=atol)


def _block_case(seed, B, bs, H, Kh, D, T, fill):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    pos = np.where(np.arange(T) < fill, np.arange(T), -1).astype(np.int32)
    return (f(B, bs, H, D), f(B, T, Kh, D), f(B, T, Kh, D), f(B, bs, Kh, D),
            f(B, bs, Kh, D), pos)


# (B, bs, H, Kh, D, T, fill, slot, block_start, kv_limit, exclude, window)
K1_CASES = {
    "append": (2, 8, 4, 2, 32, 64, 24, 24, 24, None, None, 0),
    "gqa4_ragged_T": (1, 8, 8, 2, 32, 100, 50, 50, 50, None, None, 0),
    "per_row": (3, 4, 4, 4, 16, 48, 40, [8, 20, 40], [8, 20, 40],
                [8, 20, 40], None, 0),
    "sentinel_slot": (2, 8, 4, 2, 16, 64, 32, [32, 64], [32, 40], None,
                      None, 0),
    "exclude": (2, 8, 4, 2, 32, 72, 64, 64, 24, None, (24, 8), 0),
    "window": (1, 8, 4, 2, 16, 64, 40, 40, 40, None, None, 12),
    "kv_limit_0": (2, 4, 4, 2, 16, 32, 16, 16, 16, [0, 16], None, 0),
}


@pytest.mark.parametrize("name", list(K1_CASES))
def test_block_attention_plain_matches_pallas(name):
    B, bs, H, Kh, D, T, fill, slot, bstart, lim, exc, win = K1_CASES[name]
    q, ck, cv, bk, bv, pos = _block_case(len(name), B, bs, H, Kh, D, T, fill)
    arr = lambda v: None if v is None else jnp.asarray(v, jnp.int32)  # noqa
    jkw = dict(slot=arr(slot), block_start=arr(bstart), kv_limit=arr(lim),
               window=win)
    tkw = dict(slot=slot, block_start=bstart, kv_limit=lim, window=win)
    if exc:
        jkw.update(exclude_start=arr(exc[0]), exclude_len=exc[1])
        tkw.update(exclude_start=exc[0], exclude_len=exc[1])
    jargs = [jnp.asarray(a) for a in (q, ck, cv, bk, bv, pos)]
    targs = [torch.as_tensor(a) for a in (q, ck, cv, bk, bv, pos)]
    jpal = cached_block_attention_pallas(*jargs, kv_tile=32, interpret=True,
                                         **jkw)
    joracle = jref.cached_block_attention_ref(*jargs, **jkw)
    exc_start, exc_len = exc if exc else (None, 0)
    sc = row_scalars(B, "cpu", slot=slot, block_start=bstart,
                     kv_limit=T if lim is None else lim,
                     exclude_start=exc_start, exclude_len=exc_len)
    port = cached_block_attention_kernel(*targs, sc, exclude_len=exc_len,
                                         window=win)
    _close(jpal, port)
    _close(joracle, port)
    _close(joracle, tref.cached_block_attention_ref(*targs, **tkw))


@pytest.mark.parametrize("exclude", [None, (8, 8)])
def test_block_attention_dispatch_matches_reference(exclude):
    """``ops.cached_block_attention`` on the CPU (the wrapper's plain
    version) agrees with the reference's off-TPU dispatch (its bounded
    flash path)."""
    q, ck, cv, bk, bv, pos = _block_case(7, 2, 8, 4, 2, 16, 40, 16)
    jkw = dict(slot=jnp.asarray(16), block_start=jnp.asarray(16))
    tkw = dict(slot=16, block_start=16)
    if exclude:
        jkw.update(exclude_start=jnp.asarray(exclude[0]),
                   exclude_len=exclude[1])
        tkw.update(exclude_start=exclude[0], exclude_len=exclude[1])
    j = jops.cached_block_attention(
        *[jnp.asarray(a) for a in (q, ck, cv, bk, bv)],
        kv_pos=jnp.asarray(pos), **jkw)
    t = tops.cached_block_attention(
        *[torch.as_tensor(a) for a in (q, ck, cv, bk, bv)],
        kv_pos=torch.as_tensor(pos), **tkw)
    _close(j, t)
    lim = kv_limit_from_pos(torch.as_tensor(pos))
    assert int(lim) == 16 and lim.dtype == torch.int32


@pytest.mark.parametrize("R,V", [(5, 1000), (8, 384)])
def test_confidence_plain_matches_pallas_with_cross_tile_ties(R, V):
    """Integer logits make equal maxima in several vocab tiles: the first
    occurrence wins, as in the Pallas kernel and argmax."""
    rng = np.random.default_rng(R)
    x = rng.integers(0, 5, (R, V)).astype(np.float32)
    x[0, :] = 0.0
    x[0, [130, 260, 900 % V]] = 7.0  # maxima in three different tiles
    jc, jt = fused_confidence_pallas(jnp.asarray(x), vocab_tile=128,
                                     interpret=True)
    tc, tt = fused_confidence_kernel(torch.as_tensor(x))
    _close(jc, tc)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    assert int(tt[0]) == 130
    jrc, jrt = jref.confidence_ref(jnp.asarray(x))
    _close(jrc, tc)
    np.testing.assert_array_equal(np.asarray(jrt), tt.numpy())
    oc, ot = tops.fused_confidence(torch.as_tensor(x).reshape(R, 1, V))
    assert oc.shape == (R, 1)
    np.testing.assert_array_equal(ot.reshape(-1).numpy(), tt.numpy())


@pytest.mark.parametrize("R,M,V", [(13, 200, 1000), (8, 64, 513)])
@pytest.mark.parametrize("tied", [True, False])
def test_fused_step_plain_matches_pallas(R, M, V, tied):
    rng = np.random.default_rng(R + V)
    x = rng.standard_normal((R, M)).astype(np.float32)
    w = rng.standard_normal((V, M) if tied else (M, V)).astype(np.float32)
    conf0, _ = jref.confidence_ref(jnp.einsum(
        "rm,vm->rv" if tied else "rm,mv->rv", jnp.asarray(x), jnp.asarray(w)))
    # thresholds straddling the confidences, so `above` mixes both ways
    tau = (np.asarray(conf0) * rng.uniform(0.5, 1.5, R)).astype(np.float32)
    masked = rng.random(R) < 0.7
    jc, jt, ja = fused_step_pallas(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(tau), jnp.asarray(masked),
                                   tied=tied, vocab_tile=256, interpret=True)
    tc, tt, ta = fused_step_kernel(torch.as_tensor(x), torch.as_tensor(w),
                                   torch.as_tensor(tau),
                                   torch.as_tensor(masked), tied=tied)
    _close(jc, tc)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    assert 0 < int(ta.sum()) < R


@pytest.mark.parametrize("tied", [True, False])
def test_fused_step_quota_matches_reference(tied):
    """quota > 0: the top-quota of each block row's masked confidences,
    as the reference's in-kernel pairwise rank and its stable-argsort
    oracle give it."""
    B, bs, M, V, quota = 3, 8, 64, 300, 3
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, bs, M)).astype(np.float32)
    w = rng.standard_normal((V, M) if tied else (M, V)).astype(np.float32)
    tau = np.zeros((B, bs), np.float32)
    masked = rng.random((B, bs)) < 0.6
    jargs = [jnp.asarray(a) for a in (x, w, tau, masked)]
    targs = [torch.as_tensor(a) for a in (x, w, tau, masked)]
    jc, jt, ja = jops.fused_step(*jargs, tied=tied, quota=quota,
                                 interpret=True)
    tc, tt, ta = tops.fused_step(*targs, tied=tied, quota=quota)
    _close(jc, tc)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    rc, rt, ra = jref.fused_step_ref(*jargs, tied=tied, quota=quota)
    np.testing.assert_array_equal(np.asarray(ra), ta.numpy())
    np.testing.assert_array_equal(
        np.asarray(jref.quota_rank_ref(rc, jargs[3])),
        tref.quota_rank_ref(tc, targs[3]).numpy())
