"""The port's step-sliced decode (``repro_torch.core.decoder``:
``DecodeCarry``, ``init_decode_carry``, ``admit_carry_rows``,
``retire_carry_rows``, ``make_admit_fn``, ``make_slice_fn``) and the
per-row geometry beneath it (the per-row cache writes, the per-row block
attend, ``block_step`` with per-row slots and limits) against the JAX
reference's on the same inputs and weights, and against the port's own
monolithic generate.

Contracts: tokens, ``nfe``, ``seq_steps``, ``steps_used``, the drift
counters, the recording mask, liveness and cursors equal the reference's
exactly, and ``conf`` and ``margin_sum`` within 1e-5; against the port's
monolithic generate every field is equal bit for bit, and so are the
per-row paths with uniform rows against the scalar ones. CPU, float32,
the reduced LLaDA-8B."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import DecodeConfig as JDecodeConfig
from repro.config.registry import get_config as jax_get_config
from repro.core import decoder as JD
from repro.models import cache as JC
from repro.models import model as JM
from repro.models import quantize as JQ
from repro_torch import convert
from repro_torch.config.base import DecodeConfig
from repro_torch.config.registry import get_config
from repro_torch.core import decoder as D
from repro_torch.data import tokenizer as tok
from repro_torch.models import cache as C
from repro_torch.models import model as M

MASK = tok.MASK_ID
DK = dict(max_new_tokens=16, block_size=4, page_size=4)
P, B = 16, 2
NB = DecodeConfig(**DK).num_blocks
EXACT = ("steps_used", "seq_steps", "live", "cursor", "thr_steps",
         "margin_n", "conf_valid")
CLOSE = ("conf", "margin_sum")


@pytest.fixture(scope="module")
def models():
    kw = dict(num_layers=2, max_d_model=128, vocab_size=tok.VOCAB)
    jc = dataclasses.replace(jax_get_config("llada-8b").reduced(**kw),
                             mask_token_id=MASK)
    tc = dataclasses.replace(get_config("llada-8b").reduced(**kw),
                             mask_token_id=MASK)
    jp = JM.init_params(jax.random.key(1), jc)
    jq = JQ.quantize_decode_params(jp, jc)
    tp, tq = (convert.params_from_numpy(jax.tree.map(np.asarray, t),
                                        device="cpu") for t in (jp, jq))
    return jc, tc, {"bf16": (jp, tp), "int8": (jq, tq)}


def _table(nb, sc, rows=B):
    """Thresholds inside the reduced model's confidence range, so blocks
    take a mix of threshold and fallback steps."""
    steps = np.clip(0.04 - 0.003 * np.arange(sc), 0.02, None)
    t = (steps[None] + 0.002 * np.arange(nb)[:, None]).astype(np.float32)
    return np.broadcast_to(t, (rows, nb, sc)).copy()


def _prompts(rows=B):
    return np.random.default_rng(3).integers(1, 256, (rows, P)).astype(
        np.int32)


def _max_len(mode):
    return P + DK["max_new_tokens"] + (DK["block_size"] if mode == "dual"
                                       else 0)


def _pool(cfg, mode, rows=B):
    """A zeroed pool over a permuted page layout: (k, v, table) numpy."""
    ps = DK["page_size"]
    n_log = -(-_max_len(mode) // ps)
    perm = np.random.default_rng(7).permutation(rows * n_log + 3)
    pt = perm[:rows * n_log].reshape(rows, n_log).astype(np.int32)
    shape = (cfg.num_layers, rows * n_log + 3, ps, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32), pt


# ---------------------------------------------------------------------------
# the sweep: driving slices to the end equals the reference's slices and
# the port's monolithic generate
# ---------------------------------------------------------------------------

# (cache_mode, attn_impl, layout, decode-config extras, slice lens):
# the reference's sweep without drafting, plus fused, quota, int8 and EOS
CASES = {
    "prefix-auto-dense": ("prefix", "auto", "dense", {}, (1, 2, NB)),
    "prefix-kernel-paged": ("prefix", "kernel", "paged", {}, (1, NB)),
    "dual-auto-paged": ("dual", "auto", "paged", {}, (1, 2)),
    "dual-kernel-dense": ("dual", "kernel", "dense", {}, (1, NB)),
    "none-auto-dense": ("none", "auto", "dense", {}, (1, 2)),
    "fused-prefix-kernel-dense": ("prefix", "kernel", "dense",
                                  dict(step_fusion="fused"), (2,)),
    "fused-quota-kernel-paged": ("prefix", "kernel", "paged",
                                 dict(step_fusion="fused", quota=2), (1,)),
    "int8-unfused-prefix-dense": ("prefix", "kernel", "dense",
                                  dict(weight_dtype="int8"), (NB,)),
    "int8-fused-dual-paged": ("dual", "kernel", "paged",
                              dict(step_fusion="fused", weight_dtype="int8"),
                              (1,)),
    "eos-prefix-kernel-dense": ("prefix", "kernel", "dense",
                                dict(eos=True), (1,)),
}
SWEEP = [(name, sl) for name, case in CASES.items() for sl in case[4]]


def _case(models, name):
    mode, impl, layout, extra, _ = CASES[name]
    extra = dict(extra)
    quota = extra.pop("quota", 0)
    eos = extra.pop("eos", False)
    wd = extra.get("weight_dtype", "bf16")
    jc, tc, params = models
    dk = dict(DK, cache_layout=layout, **extra)
    kw = dict(cache_mode=mode, attn_impl=impl, quota=quota)
    return jc, tc, params[wd], dk, kw, eos


@pytest.fixture(scope="module")
def monolithic(models):
    """The port's monolithic generate per case, computed once: (result,
    the EOS id it ran with)."""
    memo = {}

    def run(name):
        if name in memo:
            return memo[name]
        _, tc, (_, tp), dk, kw, eos = _case(models, name)
        td = DecodeConfig(**dk)
        gen = D.make_generate_fn(tc, td, use_kernel=True, **kw)
        args = [tp, _prompts(), _table(td.num_blocks, td.steps_cap), MASK,
                None]

        def pool():
            if td.cache_layout != "paged" or kw["cache_mode"] == "none":
                return ()
            pk, pv, pt = _pool(tc, kw["cache_mode"])
            return torch.from_numpy(pk), torch.from_numpy(pv), pt

        # EOS cases: an id the model emits early in row 0
        eos_id = int(gen(*args, None, *pool()).tokens[0, 1]) if eos \
            else None
        memo[name] = gen(*args, eos_id, *pool()), eos_id
        return memo[name]

    return run


def _run_sliced(pkg, cfg, dcfg, params, kw, slice_len, eos_id, *,
                prompts=None, table=None, stagger=0):
    """Drive one package's sliced family to the end. ``stagger`` > 0
    admits row 0 alone, runs that many slices, then admits the other
    rows (mixed cursors)."""
    lib = JD if pkg == "jax" else D
    mode = kw["cache_mode"]
    paged = dcfg.cache_layout == "paged" and mode != "none"
    prompts = _prompts() if prompts is None else prompts
    rows = prompts.shape[0]
    table = _table(dcfg.num_blocks, dcfg.steps_cap, rows) if table is None \
        else table
    pool_kw, pt = {}, None
    if paged:
        pk, pv, pt = _pool(cfg, mode, rows)
        conv = jnp.asarray if pkg == "jax" else torch.from_numpy
        pool_kw = dict(pool_k=conv(pk), pool_v=conv(pv),
                       page_table=np.full_like(pt, -1))
    if pkg == "torch":
        pool_kw["device"] = "cpu"
    carry = lib.init_decode_carry(cfg, dcfg, batch=rows, prompt_len=P,
                                  mask_id=MASK, cache_mode=mode,
                                  cache_layout=dcfg.cache_layout, **pool_kw)
    common = dict(cache_mode=mode, attn_impl=kw["attn_impl"],
                  cache_layout=dcfg.cache_layout)
    admit = lib.make_admit_fn(cfg, dcfg, **common) if mode != "none" \
        else None
    sf = lib.make_slice_fn(cfg, dcfg, slice_len=slice_len,
                           quota=kw["quota"], use_kernel=True, **common)
    mask = jnp.asarray(MASK, jnp.int32) if pkg == "jax" else MASK
    eos = None if eos_id is None else (
        jnp.asarray(eos_id, jnp.int32) if pkg == "jax" else eos_id)
    groups = [[0], list(range(1, rows))] if stagger else [list(range(rows))]
    for g, members in enumerate(groups):
        carry = lib.admit_carry_rows(
            carry, members, prompts[members], table[members], MASK,
            page_rows=pt[members] if paged else None)
        if admit is not None:
            sel = np.zeros(rows, bool)
            sel[members] = True
            carry = admit(params, carry, jnp.asarray(sel) if pkg == "jax"
                          else sel)
        n = stagger if g == 0 and len(groups) > 1 else None
        while n is None or n > 0:
            if int(np.asarray(carry.cursor).min()) >= dcfg.num_blocks:
                break
            carry = sf(params, carry, mask, eos)
            if n is not None:
                n -= 1
    return carry


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _assert_carries(jcarry, tcarry, key):
    np.testing.assert_array_equal(_np(jcarry.resp), _np(tcarry.resp),
                                  err_msg=str(key))
    assert int(jcarry.nfe) == tcarry.nfe, key
    for f in EXACT:
        np.testing.assert_array_equal(_np(getattr(jcarry, f)),
                                      _np(getattr(tcarry, f)),
                                      err_msg=f"{key} {f}")
    for f in CLOSE:
        np.testing.assert_allclose(_np(getattr(jcarry, f)),
                                   _np(getattr(tcarry, f)), rtol=0,
                                   atol=1e-5, err_msg=f"{key} {f}")


@pytest.mark.parametrize("name,slice_len", SWEEP)
def test_slice_identity(models, monolithic, name, slice_len):
    """Slices driven to the end: the reference's sliced decode's values,
    and the port's monolithic generate's bit for bit."""
    jc, tc, (jp, tp), dk, kw, _ = _case(models, name)
    base, eos_id = monolithic(name)
    jd, td = JDecodeConfig(**dk), DecodeConfig(**dk)
    got = _run_sliced("torch", tc, td, tp, kw, slice_len, eos_id)
    want = _run_sliced("jax", jc, jd, jp, kw, slice_len, eos_id)
    _assert_carries(want, got, (name, slice_len))
    res = got.result()
    assert res.nfe == base.nfe
    for f in ("tokens", "conf", "conf_valid", "steps_per_block",
              "seq_steps", "live", "thr_steps", "margin_sum", "margin_n"):
        assert torch.equal(getattr(res, f), getattr(base, f)), f
    if eos_id is not None:
        assert not bool(base.live.all()), "EOS retired no row"


@pytest.mark.parametrize("name", ["prefix-auto-dense", "prefix-kernel-paged",
                                  "dual-auto-paged",
                                  "fused-prefix-kernel-dense",
                                  "eos-prefix-kernel-dense"])
def test_mixed_cursors_match_reference(models, name):
    """Three rows: row 0 admitted alone and decoded two slices ahead, then
    rows 1 and 2 admitted mid-generation, so every slice after that runs
    rows at different cursors (and row 0 finishes while the others ride
    along): the reference's carry, field for field."""
    jc, tc, (jp, tp), dk, kw, eos = _case(models, name)
    jd, td = JDecodeConfig(**dk), DecodeConfig(**dk)
    prompts = np.random.default_rng(11).integers(1, 256, (3, P)).astype(
        np.int32)
    table = _table(td.num_blocks, td.steps_cap, 3)
    eos_id = 88 if eos else None
    got = _run_sliced("torch", tc, td, tp, kw, 1, eos_id, prompts=prompts,
                      table=table, stagger=2)
    want = _run_sliced("jax", jc, jd, jp, kw, 1, eos_id, prompts=prompts,
                       table=table, stagger=2)
    _assert_carries(want, got, name)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_mid_generation_admission_matches_a_fresh_decode(models, layout):
    """A row admitted while another is two blocks ahead decodes to the
    tokens, steps and recordings it gets decoding alone."""
    _, tc, params, *_ = models
    tp = params["bf16"][1]
    td = DecodeConfig(**dict(DK, cache_layout=layout))
    kw = dict(cache_mode="prefix", attn_impl="kernel", quota=0)
    prompts = _prompts(3)
    table = _table(td.num_blocks, td.steps_cap, 3)
    mixed = _run_sliced("torch", tc, td, tp, kw, 1, None, prompts=prompts,
                        table=table, stagger=2)
    alone = _run_sliced("torch", tc, td, tp, kw, 1, None,
                        prompts=prompts[1:2], table=table[1:2])
    for f in ("resp", "seq_steps", "conf", "conf_valid", "thr_steps"):
        assert torch.equal(getattr(mixed, f)[1], getattr(alone, f)[0]), f


# ---------------------------------------------------------------------------
# admission and retirement of carry rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_admit_and_retire_leave_other_rows_alone(models, layout):
    """``admit_carry_rows`` + ``make_admit_fn`` for row 1 while row 0 is
    mid-decode change row 0's cache, pages and state in no byte, reset
    row 1's state, and mark its prompt slots valid; ``retire_carry_rows``
    kills row 1 and unmaps its page-table row."""
    _, tc, params, *_ = models
    tp = params["bf16"][1]
    td = DecodeConfig(**dict(DK, cache_layout=layout))
    kw = dict(cache_mode="prefix", attn_impl="kernel", quota=0)
    prompts = _prompts()
    table = _table(td.num_blocks, td.steps_cap)
    paged = layout == "paged"
    pool_kw = {}
    if paged:
        pk, pv, pt = _pool(tc, "prefix")
        pool_kw = dict(pool_k=torch.from_numpy(pk),
                       pool_v=torch.from_numpy(pv),
                       page_table=np.full_like(pt, -1))
    carry = D.init_decode_carry(tc, td, batch=B, prompt_len=P, mask_id=MASK,
                                cache_layout=layout, device="cpu", **pool_kw)
    admit = D.make_admit_fn(tc, td, cache_layout=layout, attn_impl="kernel")
    sf = D.make_slice_fn(tc, td, cache_layout=layout, attn_impl="kernel")
    carry = D.admit_carry_rows(carry, [0], prompts[:1], table[:1], MASK,
                               page_rows=pt[:1] if paged else None)
    carry = admit(tp, carry, np.array([True, False]))
    carry = sf(tp, carry, MASK)
    kv = carry.cache["attn"]
    if paged:
        row0 = (kv["kp"][:, pt[0]].clone(), kv["vp"][:, pt[0]].clone())
        row1 = None
    else:
        row0 = (kv["k"][:, 0].clone(), kv["v"][:, 0].clone())
        row1 = (kv["k"][:, 1].clone(), kv["v"][:, 1].clone())
    state0 = {f: getattr(carry, f)[0].clone() for f in (
        "resp", "prompt", "table", "live", "cursor", "conf", "seq_steps")}
    nfe0 = carry.nfe
    carry = D.admit_carry_rows(carry, [1], prompts[1:], table[1:], MASK,
                               page_rows=pt[1:] if paged else None)
    carry = admit(tp, carry, np.array([False, True]))
    kv = carry.cache["attn"]
    assert carry.nfe == nfe0 + 1 and kv["length"] >= P
    if paged:
        assert torch.equal(kv["kp"][:, pt[0]], row0[0])
        assert torch.equal(kv["vp"][:, pt[0]], row0[1])
        assert kv["pt"].tolist() == pt.tolist()
    else:
        assert torch.equal(kv["k"][:, 0], row0[0])
        assert torch.equal(kv["v"][:, 0], row0[1])
        # row 1: its prompt slots written, the rest untouched
        assert torch.equal(kv["k"][:, 1, P:], row1[0][:, P:])
        assert not torch.equal(kv["k"][:, 1, :P], row1[0][:, :P])
    for f, v in state0.items():
        assert torch.equal(getattr(carry, f)[0], v), f
    assert carry.cursor.tolist() == [1, 0]
    assert carry.resp[1].eq(MASK).all() and carry.live.tolist() == [True,
                                                                    True]
    assert int(carry.seq_steps[1].sum()) == 0
    assert (kv["pos"][:P] == torch.arange(P)).all()
    carry = D.retire_carry_rows(carry, [1], NB)
    assert carry.live.tolist() == [True, False]
    assert carry.cursor.tolist() == [1, NB]
    if paged:
        assert carry.cache["attn"]["pt"][1].eq(-1).all()
        assert carry.cache["attn"]["pt"][0].tolist() == pt[0].tolist()


def test_admit_matches_reference(models):
    """The reference's admission on a paged carry with row 0 mid-decode:
    the same pool, positions and length after admitting row 1."""
    jc, tc, params = models
    jp, tp = params["bf16"]
    dk = dict(DK, cache_layout="paged")
    jd, td = JDecodeConfig(**dk), DecodeConfig(**dk)
    kw = dict(cache_mode="prefix", attn_impl="kernel", quota=0)
    out = {}
    for pkg, cfg, dcfg, params_ in (("jax", jc, jd, jp),
                                    ("torch", tc, td, tp)):
        carry = _run_sliced(pkg, cfg, dcfg, params_, kw, 1, None,
                            prompts=_prompts(3), stagger=1)
        out[pkg] = carry.cache["attn"]
    j, t = out["jax"], out["torch"]
    np.testing.assert_allclose(np.asarray(j["kp"]), t["kp"].numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(j["pos"]), t["pos"].numpy())
    assert int(j["length"]) == t["length"]


def test_unported_sliced_features_raise(models):
    _, tc, params, *_ = models
    td = DecodeConfig(**DK)
    with pytest.raises(NotImplementedError, match="item 4"):
        D.make_slice_fn(tc, td, variant="draft")
    carry = D.init_decode_carry(tc, td, batch=B, prompt_len=P, mask_id=MASK,
                                device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        D.admit_carry_rows(carry, [0], _prompts()[:1],
                           _table(NB, td.steps_cap)[:1], MASK,
                           mark_prompt_pos=True)
    admit = D.make_admit_fn(tc, td)
    with pytest.raises(NotImplementedError, match="item 5"):
        admit(params["bf16"][1], carry, np.ones(B, bool),
              prefix_len=np.zeros(B, np.int32))
    with pytest.raises(ValueError, match="nothing to admit"):
        D.make_admit_fn(tc, td, cache_mode="none")
    with pytest.raises(ValueError, match="slice_len"):
        D.make_slice_fn(tc, td, slice_len=0)


@pytest.mark.parametrize("kw", [dict(cache_mode="prefix2"),
                                dict(attn_impl="pallas"),
                                dict(step_fusion="half"),
                                dict(cache_layout="ring"),
                                dict(weight_dtype="int4"),
                                dict(shared_prefix_len=4),
                                dict(cache_layout="paged",
                                     shared_prefix_len=6)])
def test_generate_and_slice_validate_alike(models, kw):
    """One normaliser: the monolithic and the sliced builders refuse the
    same variants with the same error."""
    _, tc, *_ = models
    td = DecodeConfig(**DK)
    errs = []
    builders = [D.make_generate_fn, D.make_slice_fn]
    if not {"step_fusion", "weight_dtype"} & set(kw):
        builders.append(D.make_admit_fn)
    for build in builders:
        with pytest.raises(ValueError) as e:
            build(tc, td, **kw)
        errs.append(str(e.value))
    assert len(set(errs)) == 1, errs


# ---------------------------------------------------------------------------
# per-row helpers: cache writes and block_step
# ---------------------------------------------------------------------------

T = 24
STARTS = np.array([0, 7, T, T - 2], np.int32)   # sentinel, partial


def test_kv_and_pos_write_rows_match_reference():
    rng = np.random.default_rng(0)
    ck = rng.standard_normal((4, T, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((4, T, 2, 8)).astype(np.float32)
    k = rng.standard_normal((4, 4, 2, 8)).astype(np.float32)
    v = rng.standard_normal((4, 4, 2, 8)).astype(np.float32)
    pos = np.full((T,), -1, np.int32)
    qp = STARTS[:, None] + np.arange(4, dtype=np.int32)
    jk, jv = JC.kv_write_slice_rows(jnp.asarray(ck), jnp.asarray(cv),
                                    jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(STARTS))
    tk, tv = C.kv_write_slice_rows(torch.from_numpy(ck.copy()),
                                   torch.from_numpy(cv.copy()),
                                   torch.from_numpy(k), torch.from_numpy(v),
                                   torch.from_numpy(STARTS))
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    # the sentinel row wrote nothing
    np.testing.assert_array_equal(tk.numpy()[2], ck[2])
    jp = JC.pos_write_slice_rows(jnp.asarray(pos), jnp.asarray(qp),
                                 jnp.asarray(STARTS))
    tp = C.pos_write_slice_rows(torch.from_numpy(pos.copy()),
                                torch.from_numpy(qp),
                                torch.from_numpy(STARTS))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


def test_paged_write_rows_match_reference():
    """Per-row paged writes through a table with an unmapped page and a
    sentinel start: the reference's pools; with ``limit`` every slot at or
    past it drops too."""
    ps, n_log = 4, 6
    rng = np.random.default_rng(1)
    pt = rng.permutation(4 * n_log + 2)[:4 * n_log].reshape(4, n_log) \
        .astype(np.int32)
    pt[1, 2] = -1                                   # row 1's slots 8..11
    pool = rng.standard_normal((4 * n_log + 2, ps, 2, 8)).astype(np.float32)
    k = rng.standard_normal((4, 4, 2, 8)).astype(np.float32)
    starts = np.array([4, 6, 21, 2], np.int32)      # 21: past T = 20
    jpp, joff = JC._page_index(jnp.asarray(pt), jnp.asarray(starts), 4, ps)
    tpp, toff = C._page_index(torch.from_numpy(pt), torch.from_numpy(starts),
                              4, ps)
    np.testing.assert_array_equal(np.asarray(jpp), tpp.numpy())
    np.testing.assert_array_equal(np.asarray(joff), toff.numpy())
    jk, _ = JC.paged_kv_write(jnp.asarray(pool), jnp.asarray(pool),
                              jnp.asarray(k), jnp.asarray(k),
                              jnp.asarray(pt), jnp.asarray(starts),
                              page_size=ps)
    tk, _ = C.paged_kv_write(torch.from_numpy(pool.copy()),
                             torch.from_numpy(pool.copy()),
                             torch.from_numpy(k), torch.from_numpy(k),
                             torch.from_numpy(pt), torch.from_numpy(starts),
                             page_size=ps)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    idx = C.paged_write_index(torch.from_numpy(pt), torch.from_numpy(starts),
                              4, ps, limit=20)
    lk, _ = C.paged_kv_write(torch.from_numpy(pool.copy()),
                             torch.from_numpy(pool.copy()),
                             torch.from_numpy(k), torch.from_numpy(k),
                             torch.from_numpy(pt), None, page_size=ps,
                             index=idx)
    want = tk.numpy().copy()
    want[pt[2, 5], 1:] = pool[pt[2, 5], 1:]          # slots 21..23 drop
    np.testing.assert_array_equal(lk.numpy(), want)
    assert sorted(set(idx[0].tolist())) == [0, 1, 3]


def _random_cache(cfg, layout, fill, rng):
    """A cache over max_len = P + 16 slots with random K/V and positions
    ``[0, fill)`` valid: (numpy dict, page table or None)."""
    L, Kh, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    ml = P + 16
    pos = np.where(np.arange(ml) < fill, np.arange(ml), -1).astype(np.int32)
    if layout == "dense":
        shape = (L, 3, ml, Kh, Dh)
        return dict(k=rng.standard_normal(shape).astype(np.float32),
                    v=rng.standard_normal(shape).astype(np.float32),
                    pos=pos, length=fill), None
    ps = DK["page_size"]
    n_log = ml // ps
    pt = rng.permutation(3 * n_log + 2)[:3 * n_log].reshape(3, n_log) \
        .astype(np.int32)
    pt[2, 1] = -1                                  # a hole in row 2
    shape = (L, 3 * n_log + 2, ps, Kh, Dh)
    return dict(kp=rng.standard_normal(shape).astype(np.float32),
                vp=rng.standard_normal(shape).astype(np.float32),
                pt=pt, pos=pos, length=fill), pt


def _to_pkg(kv, pkg):
    conv = jnp.asarray if pkg == "jax" else (
        lambda a: torch.from_numpy(np.array(a)))
    return {"attn": {k: (conv(v) if isinstance(v, np.ndarray) else
                         (jnp.asarray(v, jnp.int32) if pkg == "jax" else v))
                     for k, v in kv.items()}}


BLOCK_STEP_CASES = {
    # name: (layout, attn_impl, per-row kwargs builder, write)
    "dense-auto-rows": ("dense", "auto", "prefix", True),
    "dense-flash-rows": ("dense", "flash", "prefix", True),
    "dense-kernel-rows": ("dense", "kernel", "prefix", True),
    "paged-kernel-rows": ("paged", "kernel", "prefix", True),
    "paged-auto-rows": ("paged", "auto", "prefix", True),
    "dense-kernel-dual": ("dense", "kernel", "dual", False),
    "paged-auto-dual": ("paged", "auto", "dual", False),
}


def _geometry(kind, pkg):
    """Per-row block starts at three cursors, write slots with one
    sentinel (row 1 finished), per-row limits with a retired row."""
    arr = (lambda a: jnp.asarray(np.asarray(a, np.int32))) if pkg == "jax" \
        else (lambda a: torch.tensor(a, dtype=torch.int32))
    bstart = [P, P + 4, P + 8]
    if kind == "prefix":
        return dict(block_start=arr(bstart),
                    write_slot=arr([P, P + 16, P + 8]),
                    row_limit=arr([P, P + 4, 0]))
    return dict(block_start=arr(bstart), write_slot=P + 12,
                exclude_start=arr(bstart), exclude_len=4)


@pytest.mark.parametrize("name", list(BLOCK_STEP_CASES))
def test_block_step_rows_match_reference(models, name):
    layout, impl, kind, write = BLOCK_STEP_CASES[name]
    jc, tc, params = models
    jp, tp = params["bf16"]
    rng = np.random.default_rng(5)
    kv, _ = _random_cache(tc, layout, P + 12, rng)
    block = rng.integers(0, 256, (3, 4)).astype(np.int32)
    block[:, 1] = MASK
    ps = DK["page_size"] if layout == "paged" else 0
    jl, jcache = JM.block_step(jp, jc, jnp.asarray(block), cache=_to_pkg(
        kv, "jax"), write=write, advance=False, attn_impl=impl,
        page_size=ps, **_geometry(kind, "jax"))
    tl, tcache = M.block_step(tp, tc, torch.from_numpy(block),
                              cache=_to_pkg(kv, "torch"), write=write,
                              advance=False, attn_impl=impl, page_size=ps,
                              **_geometry(kind, "torch"))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=0, atol=1e-5)
    for f in jcache["attn"]:
        want = np.asarray(jcache["attn"][f])
        got = tcache["attn"][f]
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_allclose(want, got, rtol=0, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("layout,impl", [("dense", "auto"), ("dense", "flash"),
                                         ("dense", "kernel"),
                                         ("paged", "auto"),
                                         ("paged", "kernel")])
def test_uniform_rows_equal_the_scalar_path(models, layout, impl):
    """Per-row geometry with every row at the same cursor, and its limit
    the cache's valid extent, gives the scalar path's logits and writes
    bit for bit."""
    _, tc, params = models
    tp = params["bf16"][1]
    rng = np.random.default_rng(6)
    fill = P + 8
    kv, _ = _random_cache(tc, layout, fill, rng)
    block = torch.from_numpy(rng.integers(0, 256, (3, 4)).astype(np.int32))
    ps = DK["page_size"] if layout == "paged" else 0
    rows = torch.full((3,), fill, dtype=torch.int32)
    outs = []
    for geo in (dict(block_start=fill),
                dict(block_start=rows, write_slot=rows, row_limit=rows)):
        cache = _to_pkg(kv, "torch")
        logits, cache = M.block_step(tp, tc, block, cache=cache, write=True,
                                     attn_impl=impl, page_size=ps, **geo)
        outs.append((logits, cache["attn"]))
    (l0, c0), (l1, c1) = outs
    assert torch.equal(l0, l1)
    for f in ("kp", "vp", "pt", "pos") if layout == "paged" else (
            "k", "v", "pos"):
        assert torch.equal(c0[f], c1[f]), f
