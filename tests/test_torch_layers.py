"""The port's layers, cache writes and attention paths against the JAX
reference on the same numpy inputs (CPU, float32, atol 1e-5)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.registry import get_config as jax_get_config
from repro.data import tokenizer as jtok
from repro.models import attention as JA
from repro.models import cache as JC
from repro.models import layers as JL
from repro_torch.config.base import DecodeConfig
from repro_torch.config.registry import get_config
from repro_torch.data import tokenizer as ttok
from repro_torch.models import attention as TA
from repro_torch.models import cache as TC
from repro_torch.models import layers as TL

ATOL = 1e-5


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), rtol=0,
                               atol=atol)


def test_configs_match_reference():
    """The copied config fields, the reduced rule and the decode knobs
    carry the reference's values."""
    for kw in ({}, dict(num_layers=2, max_d_model=128, vocab_size=260)):
        j = jax_get_config("llada-8b")
        t = get_config("llada-8b")
        if kw:
            j, t = j.reduced(**kw), t.reduced(**kw)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.resolved_head_dim == j.resolved_head_dim
    jd, td = JDecodeConfig(), DecodeConfig()
    for f in dataclasses.fields(td):
        assert getattr(td, f.name) == getattr(jd, f.name), f.name
    assert (td.num_blocks, td.steps_cap) == (jd.num_blocks, jd.steps_cap)


def test_tokenizer_matches_reference():
    assert (ttok.PAD_ID, ttok.BOS_ID, ttok.EOS_ID, ttok.MASK_ID,
            ttok.VOCAB) == (jtok.PAD_ID, jtok.BOS_ID, jtok.EOS_ID,
                            jtok.MASK_ID, jtok.VOCAB)
    ids = ttok.encode("héllo", bos=True, eos=True)
    assert ids == jtok.encode("héllo", bos=True, eos=True)
    assert ttok.decode(ids) == jtok.decode(ids)
    np.testing.assert_array_equal(ttok.batch_prompts([[1, 2], [3]], 4),
                                  jtok.batch_prompts([[1, 2], [3]], 4))


@pytest.mark.parametrize("dtype", [np.float32])
def test_norm_rope_mlp_embed(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(dtype)
    pos = rng.integers(0, 300, (5,)).astype(np.int32)
    _close(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5.0e5),
           TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 5.0e5))
    h = rng.standard_normal((2, 5, 64)).astype(dtype)
    scale = rng.standard_normal((64,)).astype(dtype)
    _close(JL.rms_norm(jnp.asarray(h), jnp.asarray(scale), 1e-5),
           TL.rms_norm(torch.as_tensor(h), torch.as_tensor(scale), 1e-5))
    p = {k: (rng.standard_normal(s) / 8).astype(dtype) for k, s in
         (("wi_gate", (64, 96)), ("wi_up", (64, 96)), ("wo", (96, 64)))}
    _close(JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h)),
           TL.mlp({k: torch.as_tensor(v) for k, v in p.items()},
                  torch.as_tensor(h)))
    table = rng.standard_normal((40, 64)).astype(dtype)
    toks = rng.integers(0, 40, (2, 5)).astype(np.int32)
    _close(JL.embed(jnp.asarray(table), jnp.asarray(toks)),
           TL.embed(torch.as_tensor(table), torch.as_tensor(toks)))
    head = rng.standard_normal((64, 40)).astype(dtype)
    _close(JL.unembed(jnp.asarray(table), jnp.asarray(h), transpose=True),
           TL.unembed(torch.as_tensor(table), torch.as_tensor(h),
                      transpose=True))
    _close(JL.unembed(jnp.asarray(head), jnp.asarray(h), transpose=False),
           TL.unembed(torch.as_tensor(head), torch.as_tensor(h),
                      transpose=False))


@pytest.mark.parametrize("transpose", [True, False])
def test_unembed_chunked_narrow_head(transpose, monkeypatch):
    """A bf16 head is upcast a chunk of columns at a time; every column is
    the same float32 product as upcasting the whole head."""
    monkeypatch.setattr(TL, "UNEMBED_CHUNK", 7)
    g = torch.Generator().manual_seed(0)
    w = torch.randn((20, 16) if transpose else (16, 20),
                    generator=g).to(torch.bfloat16)
    x = torch.randn((3, 16), generator=g)
    full = x @ (w.float().t() if transpose else w.float())
    torch.testing.assert_close(TL.unembed(w, x, transpose=transpose), full,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("start,S,T", [(3, 4, 16), (14, 4, 16), (5, 20, 16),
                                       (16, 4, 16)])
def test_cache_writes_wrap(start, S, T):
    """Contiguous, wrapping and whole-ring writes land where the
    reference's wrap-aware writes put them."""
    rng = np.random.default_rng(1)
    ck = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    kn = rng.standard_normal((2, S, 2, 8)).astype(np.float32)
    jk, jv = JC.kv_write_slice(jnp.asarray(ck), jnp.asarray(ck),
                               jnp.asarray(kn), jnp.asarray(kn),
                               jnp.asarray(start))
    tk, tv = TC.kv_write_slice(torch.as_tensor(ck), torch.as_tensor(ck),
                               torch.as_tensor(kn), torch.as_tensor(kn),
                               start)
    _close(jk, tk, 0)
    _close(jv, tv, 0)
    pos = np.full((T,), -1, np.int32)
    positions = np.arange(100, 100 + S, dtype=np.int32)
    jp = JC.pos_write_slice(jnp.asarray(pos), jnp.asarray(positions),
                            jnp.asarray(start))
    tp = TC.pos_write_slice(torch.as_tensor(pos), torch.as_tensor(positions),
                            start)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def test_init_kv_cache_layout():
    j = JC.init_kv_cache(2, 3, 10, 2, 8, jnp.float32)
    t = TC.init_kv_cache(2, 3, 10, 2, 8, torch.float32, device="cpu")
    assert tuple(t["k"].shape) == j["k"].shape
    np.testing.assert_array_equal(t["pos"].numpy(), np.asarray(j["pos"]))
    assert t["length"] == int(j["length"])


def _attn_inputs(rng, B=2, S=8, H=4, K=2, D=16, T=24):
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("mode,window", [("causal", 0), ("full", 0),
                                         ("sliding", 5)])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_attention_paths(mode, window, impl):
    rng = np.random.default_rng(2)
    q, k, v = _attn_inputs(rng, T=8)
    qp = np.arange(8, dtype=np.int32)
    kv_valid = rng.random((2, 8)) < 0.8
    kv_valid[:, 0] = True
    j = JA.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(qp),
                     mode=mode, window=window,
                     kv_valid=jnp.asarray(kv_valid), impl=impl)
    t = TA.attention(torch.as_tensor(q), torch.as_tensor(k),
                     torch.as_tensor(v), q_pos=torch.as_tensor(qp),
                     kv_pos=torch.as_tensor(qp), mode=mode, window=window,
                     kv_valid=torch.as_tensor(kv_valid), impl=impl)
    _close(j, t)


def test_flash_chunked_with_limit():
    """Several kv chunks, a clamped tail chunk and a length bound."""
    rng = np.random.default_rng(3)
    q, k, v = _attn_inputs(rng, S=8, T=40)
    qp = np.arange(8, dtype=np.int32)
    kp = np.arange(40, dtype=np.int32)
    valid = kp < 27
    kw = dict(mode="full", q_chunk=4, kv_chunk=16)
    j = JA.attend_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp),
                        kv_valid=jnp.asarray(valid),
                        kv_limit=jnp.asarray(27), **kw)
    t = TA.attend_flash(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), q_pos=torch.as_tensor(qp),
                        kv_pos=torch.as_tensor(kp),
                        kv_valid=torch.as_tensor(valid), kv_limit=27, **kw)
    _close(j, t)


@pytest.mark.parametrize("exclude,window", [(None, 0), ((4, 8), 0),
                                            (None, 12)])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_cached_block_attend(exclude, window, impl):
    rng = np.random.default_rng(4)
    q, ck, cv = _attn_inputs(rng, T=32)
    bk = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    bv = rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
    pos = np.where(np.arange(32) < 16, np.arange(32), -1).astype(np.int32)
    slot, qp = 16, np.arange(16, 24, dtype=np.int32)
    exc = dict(exclude_start=exclude[0], exclude_len=exclude[1]) \
        if exclude else {}
    lim = 16 if impl == "flash" else None
    jo, (jk, _) = JA.cached_block_attend(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(bk),
        jnp.asarray(bv), jnp.asarray(pos), slot=jnp.asarray(slot),
        q_pos=jnp.asarray(qp), window=window, impl=impl,
        kv_limit=None if lim is None else jnp.asarray(lim),
        **{k: (jnp.asarray(v) if k == "exclude_start" else v)
           for k, v in exc.items()})
    tck = torch.as_tensor(ck)
    to, (tk, _) = TA.cached_block_attend(
        torch.as_tensor(q), tck, torch.as_tensor(cv), torch.as_tensor(bk),
        torch.as_tensor(bv), torch.as_tensor(pos), slot=slot,
        q_pos=torch.as_tensor(qp), window=window, impl=impl, kv_limit=lim,
        **exc)
    _close(jo, to)
    _close(jk, tk, 0)
    np.testing.assert_array_equal(tck.numpy(), ck)  # input left unchanged


def test_cache_valid_mask_and_mask_bias():
    pos = np.array([0, 1, 2, -1, 4, 5, -1, 7], np.int32)
    j = JA.cache_valid_mask(jnp.asarray(pos), exclude_start=jnp.asarray(1),
                            exclude_len=2, window=4, q_last=jnp.asarray(7))
    t = TA.cache_valid_mask(torch.as_tensor(pos), exclude_start=1,
                            exclude_len=2, window=4, q_last=7)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    qp = np.arange(3, 7, dtype=np.int32)
    for mode in ("causal", "full", "sliding"):
        np.testing.assert_array_equal(
            np.asarray(JA.mask_bias(jnp.asarray(qp), jnp.asarray(pos), mode,
                                    2)),
            TA.mask_bias(torch.as_tensor(qp), torch.as_tensor(pos), mode,
                         2).numpy())
