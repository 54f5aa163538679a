"""The port's paged KV layout against the JAX reference: the page
allocator, write/gather through page tables, the paged prefill, the plain
version of the paged block attention kernel (K4) against the reference's
Pallas kernel in interpret mode, ``block_step(row_live=...)``, and paged
generate (Sp = 0 and a shared prefix) against the reference's paged
generate and the port's dense generate. CPU, float32, numpy inputs from
a seed; tokens, NFE and step counts equal, floats within 1e-5 (attention
2e-5, the reference's own kernel tolerance)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.registry import get_config as jax_get_config
from repro.core.decoder import make_generate_fn as jax_make_generate_fn
from repro.kernels.block_attention import paged_block_attention_pallas
from repro.models import cache as jcache
from repro.models import model as JM
from repro_torch import convert
from repro_torch.config.base import DecodeConfig
from repro_torch.config.registry import get_config
from repro_torch.core.decoder import make_generate_fn
from repro_torch.kernels import ops, ref
from repro_torch.kernels.block_attention import (paged_block_attention_kernel,
                                                 row_scalars)
from repro_torch.models import cache as tcache
from repro_torch.models import model as TM

MASK = 259
PS = 8
P_LEN = 16
DK = dict(max_new_tokens=16, block_size=4)
ATTN_TOL = 2e-5


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


def _t(a):
    """A torch copy: the port writes pools in place, and must not write
    through into numpy arrays that the reference also reads."""
    return torch.tensor(np.asarray(a))


def _pools(tc, num_pages):
    shape = (tc.num_layers, num_pages, PS, tc.num_kv_heads,
             tc.resolved_head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


def _table(nb, sc):
    """Thresholds inside the reduced model's confidence range, so blocks
    take a mix of threshold and fallback steps."""
    steps = np.clip(0.04 - 0.003 * np.arange(sc), 0.02, None)
    return (steps[None] + 0.002 * np.arange(nb)[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# allocator: the same op sequence on both ledgers, raising cases included
# ---------------------------------------------------------------------------

ALLOC_SEQUENCES = {
    # free list, shared refs, double free, exhaustion, reuse
    "lifecycle": [("alloc", 3), ("share", [0, 1, 2]), ("free", [0, 1, 2]),
                  ("free", [0, 1, 2]), ("free", [0, 1, 2]), ("alloc", 9),
                  ("alloc", 8)],
    # the bad page sits last: a non-atomic share would leak two bumps
    "share_raises_midway": [("alloc", 3), ("alloc", 1), ("free", [3]),
                            ("share", [0, 1, 3]), ("free", [0, 1, 2])],
    # a duplicate inside one call is a double free
    "free_duplicate": [("alloc", 2), ("free", [0, 1, 0]), ("free", [0, 1])],
    # private alloc cannot be met: no parent reference is taken
    "fork_exhaustion": [("alloc", 3), ("alloc", 4), ("fork", [0, 1, 2], 2),
                        ("fork", [0, 1, 2], 1), ("free", [0, 1, 2]),
                        ("free", [7])],
    "fork_unallocated_parent": [("alloc", 2), ("fork", [0, 5], 1),
                                ("fork", [0, 1], 3)],
}


def _apply(alloc, op):
    name, *args = op
    try:
        return ("ok", getattr(alloc, name)(*args))
    except (MemoryError, ValueError) as e:
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("seq", list(ALLOC_SEQUENCES))
def test_allocator_matches_reference(seq):
    ja, ta = jcache.PageAllocator(8), tcache.PageAllocator(8)
    raised = 0
    for op in ALLOC_SEQUENCES[seq]:
        jr, tr = _apply(ja, op), _apply(ta, op)
        assert jr == tr, (op, jr, tr)
        raised += jr[0] == "raise"
        assert (ja._refs, ja._free) == (ta._refs, ta._free), op
        assert (ja.available, ja.in_use) == (ta.available, ta.in_use)
        assert [ja.refcount(p) for p in range(8)] == \
            [ta.refcount(p) for p in range(8)]
    assert raised > 0  # every sequence exercises a raising case


# ---------------------------------------------------------------------------
# write / gather through a scrambled page table with an unmapped row
# ---------------------------------------------------------------------------

def test_paged_write_gather_roundtrip_matches_reference():
    rng = np.random.default_rng(0)
    B, T, Kh, D = 3, 24, 2, 4
    n_log, num_pages = T // PS, 11
    pages = rng.permutation(num_pages)[: 2 * n_log]
    pt = np.full((B, n_log), -1, np.int32)
    pt[0], pt[2] = pages[:n_log], pages[n_log:]
    pool = rng.standard_normal((num_pages, PS, Kh, D)).astype(np.float32)
    k = rng.standard_normal((B, 10, Kh, D)).astype(np.float32)
    v = rng.standard_normal((B, 10, Kh, D)).astype(np.float32)
    start = 5  # straddles page boundaries
    jk, jv = jcache.paged_kv_write(jnp.asarray(pool), jnp.asarray(pool),
                                   jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pt), jnp.asarray(start),
                                   page_size=PS)
    tk, tv = _t(pool), _t(pool)
    tcache.paged_kv_write(tk, tv, _t(k), _t(v), _t(pt), start, page_size=PS)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    # the unmapped row's writes were dropped, not clamped onto a page
    for p in sorted(set(range(num_pages)) - set(pages.tolist())):
        np.testing.assert_array_equal(tk.numpy()[p], pool[p])
    gk, gv, mapped = tcache.paged_kv_gather(tk, tv, _t(pt), T, page_size=PS)
    jgk, jgv, jm = jcache.paged_kv_gather(jk, jv, jnp.asarray(pt), T,
                                          page_size=PS)
    np.testing.assert_array_equal(np.asarray(jgk), gk.numpy())
    np.testing.assert_array_equal(np.asarray(jgv), gv.numpy())
    np.testing.assert_array_equal(np.asarray(jm), mapped.numpy())
    for b in (0, 2):
        np.testing.assert_array_equal(gk.numpy()[b, 5:15], k[b])
        np.testing.assert_array_equal(gv.numpy()[b, 5:15], v[b])
        assert mapped[b].all()
    assert not mapped[1].any()


def test_paged_write_through_unmapped_entries_leaves_pool_untouched():
    """Every entry unmapped: a clamping scatter would overwrite page 0."""
    rng = np.random.default_rng(3)
    pool = _t(rng.standard_normal((4, PS, 1, 4)).astype(np.float32))
    before = pool.clone()
    k = _t(rng.standard_normal((2, PS, 1, 4)).astype(np.float32))
    pt = torch.full((2, 2), -1, dtype=torch.int32)
    tcache.paged_kv_write(pool, pool, k, k, pt, 0, page_size=PS)
    assert torch.equal(pool, before)


def test_identity_page_table_matches_reference():
    got = tcache.identity_page_table(3, 20, PS, device="cpu")
    np.testing.assert_array_equal(
        np.asarray(jcache.identity_page_table(3, 20, PS)), got.numpy())


# ---------------------------------------------------------------------------
# paged prefill: pool contents equal the reference's and the dense cache's
# ---------------------------------------------------------------------------

def test_paged_prefill_pool_matches_reference_and_dense(models):
    jc, tc, jp, tp = models
    B, max_len = 2, P_LEN + 16
    prompt = np.random.default_rng(1).integers(1, 256, (B, P_LEN)) \
        .astype(np.int32)
    n_log = -(-max_len // PS)
    pt = np.random.default_rng(2).permutation(B * n_log + 2)[:B * n_log] \
        .reshape(B, n_log).astype(np.int32)
    pk, pv = _pools(tc, B * n_log + 2)
    jkv = {"kp": jnp.asarray(pk), "vp": jnp.asarray(pv),
           "pt": jnp.asarray(pt), "pos": jnp.full((max_len,), -1, jnp.int32),
           "length": jnp.zeros((), jnp.int32)}
    _, jcache_ = JM.prefill(jp, jc, jnp.asarray(prompt), max_len=max_len,
                            mode="full", cache={"attn": jkv}, page_size=PS)
    tkv = {"kp": _t(pk), "vp": _t(pv), "pt": _t(pt),
           "pos": torch.full((max_len,), -1, dtype=torch.int32),
           "length": 0}
    tl, tcache_ = TM.prefill(tp, tc, torch.as_tensor(prompt),
                             max_len=max_len, mode="full",
                             cache={"attn": tkv}, page_size=PS)
    kv = tcache_["attn"]
    assert kv["kp"] is tkv["kp"]  # written in place
    for name in ("kp", "vp"):
        np.testing.assert_allclose(np.asarray(jcache_["attn"][name]),
                                   kv[name].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jcache_["attn"]["pos"]),
                                  kv["pos"].numpy())
    assert kv["length"] == int(jcache_["attn"]["length"]) == P_LEN
    dl, dense = TM.prefill(tp, tc, torch.as_tensor(prompt), max_len=max_len,
                           mode="full")
    assert torch.equal(tl, dl)
    for l in range(tc.num_layers):
        gk, gv, _ = tcache.paged_kv_gather(kv["kp"][l], kv["vp"][l],
                                           kv["pt"], max_len, page_size=PS)
        assert torch.equal(gk[:, :P_LEN], dense["attn"]["k"][l][:, :P_LEN])
        assert torch.equal(gv[:, :P_LEN], dense["attn"]["v"][l][:, :P_LEN])
    assert torch.equal(kv["pos"], dense["attn"]["pos"])


# ---------------------------------------------------------------------------
# K4's plain version against the reference's Pallas kernel (interpret)
# ---------------------------------------------------------------------------

def _attn_inputs(rng, B, num_pages, T=44, bs=8, H=8, Kh=2, D=32):
    def r(*s):
        return rng.standard_normal(s).astype(np.float32)
    return dict(q=r(B, bs, H, D), pk=r(num_pages, PS, Kh, D),
                pv=r(num_pages, PS, Kh, D), bk=r(B, bs, Kh, D),
                bv=r(B, bs, Kh, D))


def _both(x, kv_pos, pt, **kw):
    """(reference Pallas in interpret mode, port plain version,
    port wrapper on the CPU) on the same inputs."""
    jkw = {k: (None if v is None else jnp.asarray(v)) if k in (
        "slot", "block_start", "kv_limit", "exclude_start") else v
        for k, v in kw.items()}
    got = paged_block_attention_pallas(
        jnp.asarray(x["q"]), jnp.asarray(x["pk"]), jnp.asarray(x["pv"]),
        jnp.asarray(x["bk"]), jnp.asarray(x["bv"]), jnp.asarray(kv_pos),
        jnp.asarray(pt), interpret=True, **jkw)
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = ref.paged_block_attention_ref(
        _t(x["q"]), _t(x["pk"]), _t(x["pv"]), _t(x["bk"]), _t(x["bv"]),
        _t(kv_pos), _t(pt), **tkw)
    wrapped = ops.paged_block_attention(
        _t(x["q"]), _t(x["pk"]), _t(x["pv"]), _t(x["bk"]), _t(x["bv"]),
        kv_pos=_t(kv_pos), page_table=_t(pt), page_size=PS, **tkw)
    return np.asarray(got), want.numpy(), wrapped.numpy()


@pytest.mark.parametrize("fill,holes,exclude_len,window", [
    (8, False, 0, 0),
    (20, False, 0, 0),
    (20, True, 0, 0),
    (20, False, 4, 0),
    (20, False, 0, 12),
    (36, True, 4, 0),  # slot + bs == T: the fullest in-contract cache
])
def test_paged_ref_matches_pallas(fill, holes, exclude_len, window):
    rng = np.random.default_rng(fill + exclude_len + window)
    B, T, n_log = 2, 44, 6
    num_pages = B * n_log + 3
    x = _attn_inputs(rng, B, num_pages, T=T)
    kv_pos = np.where(np.arange(T) < fill, np.arange(T), -1).astype(np.int32)
    perm = rng.permutation(num_pages)
    pt = np.stack([perm[:n_log], perm[n_log:2 * n_log]]).astype(np.int32)
    if holes:
        pt[1, 2] = -1  # a reclaimed page inside the valid extent
    got, want, wrapped = _both(
        x, kv_pos, pt, slot=fill, block_start=fill,
        exclude_start=4 if exclude_len else None, exclude_len=exclude_len,
        window=window)
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(wrapped, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["dead_and_unmapped", "retired_row",
                                  "partial_row_limit", "mixed_cursors"])
def test_paged_ref_per_row_matches_pallas(case):
    """Per-row geometry: a fully unmapped (dead) row, a retired row
    (kv_limit 0) whose pages stay mapped, a partial per-row limit, and the
    sliced loop's mixed cursors with a hole and a sentinel slot."""
    rng = np.random.default_rng(len(case))
    B = 4 if case == "mixed_cursors" else 2
    T, n_log = 48, 6
    x = _attn_inputs(rng, B, B * n_log, T=T)
    fill = 24
    kv_pos = np.where(np.arange(T) < fill, np.arange(T), -1).astype(np.int32)
    pt = np.arange(B * n_log).reshape(B, n_log).astype(np.int32)
    kw = dict(slot=fill, block_start=fill)
    if case == "dead_and_unmapped":
        pt[1] = -1
    elif case == "retired_row":
        kw["kv_limit"] = np.array([fill, 0], np.int32)
    elif case == "partial_row_limit":
        kw["kv_limit"] = np.array([fill, PS], np.int32)
    else:
        kv_pos = np.arange(T, dtype=np.int32)
        pt[1, 1] = -1
        kw = dict(slot=np.array([8, 24, 40, T], np.int32),
                  block_start=np.array([8, 24, 40, 0], np.int32),
                  kv_limit=np.array([8, 24, 40, 0], np.int32),
                  exclude_start=np.array([0, 0, 16, 0], np.int32),
                  exclude_len=PS)
    got, want, wrapped = _both(x, kv_pos, pt, **kw)
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(wrapped, want, rtol=0, atol=1e-6)
    if case == "mixed_cursors":
        assert np.abs(want[3]).max() == 0.0  # retired row -> zeros


def test_paged_ref_equals_dense_ref_on_gathered_view():
    """With every page mapped, K4's plain version is K1's on the view."""
    rng = np.random.default_rng(11)
    B, T, n_log = 2, 48, 6
    x = _attn_inputs(rng, B, B * n_log + 1, T=T)
    pt = _t(rng.permutation(B * n_log + 1)[:B * n_log].reshape(B, n_log)
            .astype(np.int32))
    kv_pos = _t(np.where(np.arange(T) < 30, np.arange(T), -1)
                .astype(np.int32))
    lim = torch.tensor([30, 0], dtype=torch.int32)
    got = ref.paged_block_attention_ref(
        _t(x["q"]), _t(x["pk"]), _t(x["pv"]), _t(x["bk"]), _t(x["bv"]),
        kv_pos, pt, slot=30, block_start=30, kv_limit=lim)
    gk, gv, _ = tcache.paged_kv_gather(_t(x["pk"]), _t(x["pv"]), pt, T,
                                       page_size=PS)
    want = ref.cached_block_attention_ref(
        _t(x["q"]), gk, gv, _t(x["bk"]), _t(x["bv"]), kv_pos, slot=30,
        block_start=30, kv_limit=lim)
    assert torch.equal(got, want)


@pytest.mark.parametrize("limit", ["none", "scalar", "per_row",
                                   "row_limit"])
def test_paged_cached_block_attend_matches_reference(limit):
    """The plain paged attend, every form of the extent: none, the shared
    scalar, a rank-1 ``kv_limit`` (folded into the row mask) and an
    explicit ``row_limit`` beside the scalar."""
    from repro.models import attention as JA
    from repro_torch.models import attention as TA

    rng = np.random.default_rng(21)
    B, T, n_log, bs, fill = 3, 40, 5, 4, 20
    x = _attn_inputs(rng, B, B * n_log + 2, T=T, bs=bs)
    pt = rng.permutation(B * n_log + 2)[:B * n_log].reshape(B, n_log) \
        .astype(np.int32)
    pt[2, 1] = -1
    kv_pos = np.where(np.arange(T) < fill, np.arange(T), -1).astype(np.int32)
    per_row = np.array([fill, 0, 12], np.int32)
    kw = {"none": {}, "scalar": dict(kv_limit=np.int32(fill)),
          "per_row": dict(kv_limit=per_row),
          "row_limit": dict(kv_limit=np.int32(fill), row_limit=per_row)
          }[limit]
    q_pos = fill + np.arange(bs, dtype=np.int32)
    jout, jm = JA.paged_cached_block_attend(
        jnp.asarray(x["q"]), jnp.asarray(x["pk"]), jnp.asarray(x["pv"]),
        jnp.asarray(x["bk"]), jnp.asarray(x["bv"]), jnp.asarray(pt),
        jnp.asarray(kv_pos), slot=jnp.asarray(fill, jnp.int32),
        q_pos=jnp.asarray(q_pos), page_size=PS, impl="flash",
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tout, tm = TA.paged_cached_block_attend(
        _t(x["q"]), _t(x["pk"]), _t(x["pv"]), _t(x["bk"]), _t(x["bv"]),
        _t(pt), _t(kv_pos), slot=fill, q_pos=_t(q_pos), page_size=PS,
        impl="flash", **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_allclose(np.asarray(jout), tout.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


# ---------------------------------------------------------------------------
# block_step(row_live): all-live is a no-op, a retired row sees its block
# ---------------------------------------------------------------------------

def _paged_prefilled(jc, tc, jp, tp, B, max_len, seed):
    prompt = np.random.default_rng(seed).integers(1, 256, (B, P_LEN)) \
        .astype(np.int32)
    n_log = -(-max_len // PS)
    pt = np.arange(B * n_log).reshape(B, n_log).astype(np.int32)
    pk, pv = _pools(tc, B * n_log)
    jkv = {"kp": jnp.asarray(pk), "vp": jnp.asarray(pv),
           "pt": jnp.asarray(pt), "pos": jnp.full((max_len,), -1, jnp.int32),
           "length": jnp.zeros((), jnp.int32)}
    _, jcache_ = JM.prefill(jp, jc, jnp.asarray(prompt), max_len=max_len,
                            mode="full", cache={"attn": jkv}, page_size=PS)
    tkv = {"kp": _t(pk), "vp": _t(pv), "pt": _t(pt),
           "pos": torch.full((max_len,), -1, dtype=torch.int32),
           "length": 0}
    _, tcache_ = TM.prefill(tp, tc, torch.as_tensor(prompt),
                            max_len=max_len, mode="full",
                            cache={"attn": tkv}, page_size=PS)
    return jcache_, tcache_


@pytest.mark.parametrize("impl", ["auto", "flash", "kernel"])
def test_block_step_row_live(models, impl):
    jc, tc, jp, tp = models
    B, max_len = 2, P_LEN + 16
    jcache_, tcache_ = _paged_prefilled(jc, tc, jp, tp, B, max_len, 7)
    block = np.full((B, 4), MASK, np.int32)
    tb = torch.as_tensor(block)

    def step(row_live):
        return TM.block_step(tp, tc, tb, P_LEN, tcache_, attn_impl=impl,
                             page_size=PS, row_live=row_live)[0]

    base = step(None)
    assert torch.equal(step(torch.tensor([True, True])), base)
    part = step(torch.tensor([True, False]))
    assert torch.equal(part[0], base[0])
    assert not torch.equal(part[1], base[1])
    jpart, _ = JM.block_step(jp, jc, jnp.asarray(block),
                             jnp.asarray(P_LEN, jnp.int32), jcache_,
                             attn_impl=impl, page_size=PS,
                             row_live=jnp.asarray([True, False]))
    np.testing.assert_allclose(np.asarray(jpart), part.numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_paged_page_size_is_the_pools(models, impl):
    """The page size is read from the pool's shape: leaving it out gives the
    same step, and one that disagrees with the pool is refused by prefill
    and by block_step alike, whatever the attention branch."""
    jc, tc, jp, tp = models
    B, max_len = 2, P_LEN + 16
    _, tcache_ = _paged_prefilled(jc, tc, jp, tp, B, max_len, 10)
    tb = torch.full((B, 4), MASK, dtype=torch.int32)
    given = TM.block_step(tp, tc, tb, P_LEN, tcache_, attn_impl=impl,
                          page_size=PS)[0]
    read = TM.block_step(tp, tc, tb, P_LEN, tcache_, attn_impl=impl)[0]
    assert torch.equal(given, read)
    with pytest.raises(ValueError, match="page size"):
        TM.block_step(tp, tc, tb, P_LEN, tcache_, attn_impl=impl,
                      page_size=PS * 2)
    with pytest.raises(ValueError, match="page size"):
        TM.prefill(tp, tc, tb, max_len=max_len, mode="full",
                   cache=tcache_, page_size=PS + 1)


def test_block_step_paged_write_matches_reference(models):
    """A committing paged step scatters the block into the pool: the pools
    agree with the reference's, and the step's output too."""
    jc, tc, jp, tp = models
    B, max_len = 2, P_LEN + 16
    jcache_, tcache_ = _paged_prefilled(jc, tc, jp, tp, B, max_len, 8)
    block = np.random.default_rng(9).integers(1, 256, (B, 4)) \
        .astype(np.int32)
    jo, jnew = JM.block_step(jp, jc, jnp.asarray(block),
                             jnp.asarray(P_LEN, jnp.int32), jcache_,
                             write=True, attn_impl="kernel", page_size=PS)
    to, tnew = TM.block_step(tp, tc, torch.as_tensor(block), P_LEN,
                             tcache_, write=True, attn_impl="kernel",
                             page_size=PS)
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=0,
                               atol=1e-5)
    for name in ("kp", "vp"):
        np.testing.assert_allclose(np.asarray(jnew["attn"][name]),
                                   tnew["attn"][name].numpy(), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jnew["attn"]["pos"]),
                                  tnew["attn"]["pos"].numpy())
    assert tnew["attn"]["length"] == int(jnew["attn"]["length"])


# ---------------------------------------------------------------------------
# paged generate == the reference's paged generate == the port's dense one
# ---------------------------------------------------------------------------

def _max_len(cache_mode):
    return P_LEN + DK["max_new_tokens"] + \
        (DK["block_size"] if cache_mode == "dual" else 0)


@pytest.mark.parametrize("cache_mode", ["prefix", "dual", "none"])
@pytest.mark.parametrize("attn_impl", ["auto", "flash", "kernel"])
def test_paged_generate_matches_reference_and_dense(models, cache_mode,
                                                    attn_impl):
    jc, tc, jp, tp = models
    B = 2
    td = DecodeConfig(**DK, cache_layout="paged", page_size=PS)
    jd = JDecodeConfig(**DK, cache_layout="paged", page_size=PS)
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, 256, (B, P_LEN)).astype(np.int32)
    table = _table(td.num_blocks, td.steps_cap)
    n_log = td.pages_per_seq(_max_len(cache_mode))
    num_pages = B * n_log + 3
    pt = rng.permutation(num_pages)[:B * n_log].reshape(B, n_log) \
        .astype(np.int32)
    pk, pv = _pools(tc, num_pages)
    kw = dict(cache_mode=cache_mode, attn_impl=attn_impl)
    # the reference's cacheless decode ignores attn_impl: one program
    jkw = dict(kw, attn_impl="auto") if cache_mode == "none" else kw
    jres = jax_make_generate_fn(jc, jd, cache_layout="paged", **jkw)(
        jp, jnp.asarray(prompt), jnp.asarray(table), jnp.asarray(MASK),
        None, None, jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pt))
    tres = make_generate_fn(tc, td, **kw)(tp, prompt, table, MASK, None,
                                          None, _t(pk), _t(pv), _t(pt))
    dres = make_generate_fn(tc, DecodeConfig(**DK), **kw)(tp, prompt, table,
                                                          MASK)
    assert int(jres.nfe) == tres.nfe == dres.nfe
    for f in ("tokens", "seq_steps", "steps_per_block"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                      getattr(tres, f).numpy(), err_msg=f)
        assert torch.equal(getattr(tres, f), getattr(dres, f)), f
    assert tres.steps_per_block.max() > 1 and tres.thr_steps.sum() > 0


# ---------------------------------------------------------------------------
# shared prefix: reference parity, shared == private copies, in place
# ---------------------------------------------------------------------------

P_SHARED = 24


def _shared_setup(jc, tc, jp, tp, Sp):
    """A pool whose pages [0, Sp/PS) hold a prefilled shared prefix, two
    more byte-identical copies of them after it, and B rows' private tail
    pages; the prompts share the prefix. Returns reference and port
    pools, the prompt and the shared / private page tables."""
    B = 2
    max_len = P_SHARED + DK["max_new_tokens"]
    n_log = -(-max_len // PS)
    n_shared = Sp // PS
    n_priv = n_log - n_shared
    num_pages = 3 * n_shared + B * n_priv
    pk, pv = _pools(tc, num_pages)
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 256, (1, Sp)).astype(np.int32)
    spt = np.full((1, n_log), -1, np.int32)
    spt[0, :n_shared] = np.arange(n_shared)
    jkv = {"kp": jnp.asarray(pk), "vp": jnp.asarray(pv),
           "pt": jnp.asarray(spt), "pos": jnp.full((max_len,), -1, jnp.int32),
           "length": jnp.zeros((), jnp.int32)}
    _, jc_ = JM.prefill(jp, jc, jnp.asarray(shared), max_len=max_len,
                        mode="full", cache={"attn": jkv}, page_size=PS)
    tkv = {"kp": _t(pk), "vp": _t(pv), "pt": _t(spt),
           "pos": torch.full((max_len,), -1, dtype=torch.int32),
           "length": 0}
    TM.prefill(tp, tc, torch.as_tensor(shared), max_len=max_len,
               mode="full", cache={"attn": tkv}, page_size=PS)
    jpk, jpv = jc_["attn"]["kp"], jc_["attn"]["vp"]
    tpk, tpv = tkv["kp"], tkv["vp"]
    for c in (1, 2):
        dst = np.arange(c * n_shared, (c + 1) * n_shared)
        jpk = jpk.at[:, dst].set(jpk[:, :n_shared])
        jpv = jpv.at[:, dst].set(jpv[:, :n_shared])
        tpk[:, dst] = tpk[:, :n_shared]
        tpv[:, dst] = tpv[:, :n_shared]
    prompt = np.concatenate(
        [np.broadcast_to(shared, (B, Sp)),
         rng.integers(1, 256, (B, P_SHARED - Sp))], 1).astype(np.int32)
    tails = 3 * n_shared + np.arange(B * n_priv).reshape(B, n_priv)
    pt_shared = np.concatenate(
        [np.tile(np.arange(n_shared), (B, 1)), tails], 1).astype(np.int32)
    pt_private = np.concatenate(
        [np.stack([np.arange(n_shared) + n_shared,
                   np.arange(n_shared) + 2 * n_shared]), tails],
        1).astype(np.int32)
    return (jpk, jpv), (tpk, tpv), prompt, pt_shared, pt_private, n_shared


def test_shared_prefix_matches_reference_and_private_copies(models):
    jc, tc, jp, tp = models
    attn_impl = "kernel"
    Sp = PS
    (jpk, jpv), (tpk, tpv), prompt, pt_s, pt_p, _ = _shared_setup(
        jc, tc, jp, tp, Sp)
    np.testing.assert_allclose(np.asarray(jpk), tpk.numpy(), rtol=0,
                               atol=1e-5)
    td = DecodeConfig(**DK, cache_layout="paged", page_size=PS)
    jd = JDecodeConfig(**DK, cache_layout="paged", page_size=PS)
    table = _table(td.num_blocks, td.steps_cap)
    jres = jax_make_generate_fn(jc, jd, cache_layout="paged",
                                shared_prefix_len=Sp, attn_impl=attn_impl)(
        jp, jnp.asarray(prompt), jnp.asarray(table), jnp.asarray(MASK),
        None, None, jpk, jpv, jnp.asarray(pt_s))
    gen = make_generate_fn(tc, td, shared_prefix_len=Sp,
                           attn_impl=attn_impl)
    res_s = gen(tp, prompt, table, MASK, None, None, tpk, tpv, _t(pt_s))
    res_p = gen(tp, prompt, table, MASK, None, None, tpk, tpv, _t(pt_p))
    assert int(jres.nfe) == res_s.nfe == res_p.nfe
    for f in ("tokens", "seq_steps", "steps_per_block"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)),
                                      getattr(res_s, f).numpy(), err_msg=f)
        assert torch.equal(getattr(res_s, f), getattr(res_p, f)), f


def test_generate_writes_pool_in_place_and_keeps_shared_pages(models):
    """The port writes the pool in place, unlike the reference: the rows'
    private pages change, the shared pages stay byte-identical, and a
    second generate over the same pool gives the same result."""
    jc, tc, jp, tp = models
    Sp = PS
    _, (tpk, tpv), prompt, pt_s, _, n_shared = _shared_setup(
        jc, tc, jp, tp, Sp)
    td = DecodeConfig(**DK, cache_layout="paged", page_size=PS)
    table = _table(td.num_blocks, td.steps_cap)
    gen = make_generate_fn(tc, td, shared_prefix_len=Sp, attn_impl="kernel")
    shared_k = tpk[:, :n_shared].clone()
    shared_v = tpv[:, :n_shared].clone()
    tails = torch.as_tensor(pt_s[:, n_shared:].reshape(-1)).long()
    assert not tpk[:, tails].any()
    first = gen(tp, prompt, table, MASK, None, None, tpk, tpv, _t(pt_s))
    assert tpk[:, tails].any() and tpv[:, tails].any()  # written in place
    assert torch.equal(tpk[:, :n_shared], shared_k)
    assert torch.equal(tpv[:, :n_shared], shared_v)
    again = gen(tp, prompt, table, MASK, None, None, tpk, tpv, _t(pt_s))
    assert torch.equal(first.tokens, again.tokens)
    assert first.nfe == again.nfe
    assert torch.equal(first.seq_steps, again.seq_steps)
    assert torch.equal(tpk[:, :n_shared], shared_k)


def test_paged_generate_rejects_bad_arguments(models):
    _, tc, _, tp = models
    td = DecodeConfig(**DK, cache_layout="paged", page_size=PS)
    with pytest.raises(ValueError, match="page_size"):
        make_generate_fn(tc, td, shared_prefix_len=PS + 1)
    with pytest.raises(ValueError, match="paged"):
        make_generate_fn(tc, DecodeConfig(**DK), shared_prefix_len=PS)
    gen = make_generate_fn(tc, td)
    prompt = np.ones((2, P_LEN), np.int32)
    table = _table(td.num_blocks, td.steps_cap)
    with pytest.raises(ValueError, match="pool_k"):
        gen(tp, prompt, table, MASK)
    pk, pv = _pools(tc, 4)
    with pytest.raises(ValueError, match="page_table"):
        gen(tp, prompt, table, MASK, None, None, _t(pk), _t(pv),
            torch.zeros((2, 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# guards: no silent CPU fallback, no kernel for other devices
# ---------------------------------------------------------------------------

def test_paged_entry_points_refuse_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcache.init_paged_kv_cache(1, 1, 16, 1, 8, torch.float32,
                                   page_size=PS, num_pages=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcache.identity_page_table(1, 16, PS)
    kv = tcache.init_paged_kv_cache(2, 3, 20, 1, 8, torch.float32,
                                    page_size=PS, num_pages=5, device="cpu")
    assert kv["kp"].shape == (2, 5, PS, 1, 8) and kv["kp"].device.type == \
        "cpu"
    assert kv["pt"].shape == (3, 3) and bool((kv["pt"] == -1).all())
    assert kv["pos"].shape == (20,) and kv["length"] == 0


def test_paged_kernel_wrapper_refuses_other_devices():
    meta = dict(device="meta")
    q = torch.empty((1, 4, 2, 32), **meta)
    pool = torch.empty((3, PS, 2, 32), **meta)
    b = torch.empty((1, 4, 2, 32), **meta)
    pos = torch.empty((16,), dtype=torch.int32, **meta)
    pt = torch.empty((1, 2), dtype=torch.int32, **meta)
    sc = torch.empty((5, 1), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no block attention kernel"):
        paged_block_attention_kernel(q, pool, pool, b, b, pos, pt, sc)


def test_row_scalars_carry_per_row_kv_limit():
    sc = row_scalars(3, "cpu", slot=5, block_start=5,
                     kv_limit=torch.tensor([5, 0, 5], dtype=torch.int32))
    assert sc.tolist() == [[5] * 3, [5] * 3, [0] * 3, [0] * 3, [5, 0, 5]]
