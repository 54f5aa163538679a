"""The port's dense model against the JAX reference: forward, prefill and
block_step (non-write, commit, dual refresh, excluded dual step, fused
hidden), on reduced LLaDA-8B configs with the reference's weights brought
over by ``convert.py`` (CPU, float32, atol 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.config.registry import get_config as jax_get_config
from repro.models import model as JM
from repro_torch import convert
from repro_torch.config.registry import get_config
from repro_torch.models import model as TM

ATOL = 1e-5
VARIANTS = {
    "untied": {},
    "tied": dict(tie_embeddings=True),
    "gqa": dict(num_heads=4, num_kv_heads=1),
}


def _pair(variant):
    kw = dict(num_layers=2, max_d_model=128, vocab_size=260)
    over = dict(VARIANTS[variant], mask_token_id=259)
    jc = dataclasses.replace(jax_get_config("llada-8b").reduced(**kw), **over)
    tc = dataclasses.replace(get_config("llada-8b").reduced(**kw), **over)
    jp = JM.init_params(jax.random.key(1), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return jc, tc, jp, tp


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=0, atol=atol)


def _close_cache(jc, tc):
    _close(jc["k"], tc["k"])
    _close(jc["v"], tc["v"])
    np.testing.assert_array_equal(np.asarray(jc["pos"]), tc["pos"].numpy())
    assert int(jc["length"]) == tc["length"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_prefill(variant):
    jc, tc, jp, tp = _pair(variant)
    toks = np.random.default_rng(0).integers(0, 260, (2, 12)).astype(np.int32)
    for mode in ("full", "causal"):
        jl, _ = JM.forward(jp, jc, jnp.asarray(toks), mode=mode)
        tl = TM.forward(tp, tc, torch.as_tensor(toks), mode=mode)
        _close(jl, tl)
    jh, _ = JM.forward(jp, jc, jnp.asarray(toks), mode="full", head=False)
    th = TM.forward(tp, tc, torch.as_tensor(toks), mode="full", head=False)
    _close(jh, th)
    jl, jcache = JM.prefill(jp, jc, jnp.asarray(toks), max_len=40,
                            mode="full")
    tl, tcache = TM.prefill(tp, tc, torch.as_tensor(toks), max_len=40,
                            mode="full")
    _close(jl, tl)
    _close_cache(jcache["attn"], tcache["attn"])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("attn_impl", ["kernel", "dense"])
def test_block_step_sequence(variant, attn_impl):
    """One prefix-cache block (step, step, commit), then a dual-cache
    refresh and an excluded dual step with the fused epilogue's hidden."""
    jc, tc, jp, tp = _pair(variant)
    rng = np.random.default_rng(2)
    P, N, bs = 12, 16, 8
    prompt = rng.integers(0, 256, (2, P)).astype(np.int32)
    _, jcache = JM.prefill(jp, jc, jnp.asarray(prompt), max_len=P + N + bs,
                           mode="full")
    _, tcache = TM.prefill(tp, tc, torch.as_tensor(prompt),
                           max_len=P + N + bs, mode="full")
    resp = np.full((2, N), 259, np.int32)
    resp[:, :3] = rng.integers(0, 256, (2, 3))
    block = resp[:, :bs]

    def step(**kw):
        nonlocal jcache, tcache
        toks = kw.pop("toks", block)
        jo, jcache = JM.block_step(jp, jc, jnp.asarray(toks),
                                   jnp.asarray(kw["block_start"]), jcache,
                                   attn_impl=attn_impl,
                                   **{k: v for k, v in kw.items()
                                      if k != "block_start"})
        to, tcache = TM.block_step(tp, tc, torch.as_tensor(toks),
                                   kw["block_start"], tcache,
                                   attn_impl=attn_impl,
                                   **{k: v for k, v in kw.items()
                                      if k != "block_start"})
        _close(jo, to)
        _close_cache(jcache["attn"], tcache["attn"])

    step(block_start=P)                        # non-write step
    step(block_start=P, write=True)            # commit, length += bs
    step(toks=resp, block_start=P, write=True, advance=False,
         write_slot=P)                         # dual refresh of [resp]
    step(toks=resp[:, bs:], block_start=P + bs, write_slot=P + N,
         exclude_start=P + bs, exclude_len=bs, head=False)


def test_checkpoint_reader_matches_pytree(tmp_path):
    """The reference's msgpack checkpoint reads into the same tensors as
    the in-memory conversion, bf16 leaves included."""
    jc, _, jp, tp = _pair("untied")
    path = str(tmp_path / "ckpt.msgpack")
    jp16 = dict(jp, embed=jp["embed"].astype(jnp.bfloat16))
    jckpt.save(path, jp16, meta={"step": 3})
    got, meta = convert.load_checkpoint(path, device="cpu")
    assert meta == {"step": 3}
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["embed"].float().numpy(),
        np.asarray(jp16["embed"].astype(jnp.float32)))
    np.testing.assert_array_equal(got["layers"]["mlp"]["wo"].numpy(),
                                  tp["layers"]["mlp"]["wo"].numpy())
    conv16 = convert.params_from_numpy(
        {"e": np.asarray(jp16["embed"])}, device="cpu")
    assert torch.equal(conv16["e"], got["embed"])
