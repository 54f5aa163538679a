"""The CUDA kernels against their plain versions on the card (marked
``cuda``: they skip where no CUDA device is present). Run on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: float32 inputs agree to 1e-5 (the kernels sum in another
order); tokens and selections are equal, since the inputs here keep the
top two logits and every confidence well apart from its threshold. The
bf16 block attention cases hold the tensor-core body within one bf16
step of the plain version's output plus 1e-4 (``chip_smoke.bf16_close``).
"""
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.block_attention import (
    cached_block_attention_kernel, kv_limit_from_pos,
    paged_block_attention_kernel, row_scalars)
from repro_torch.kernels.confidence import fused_confidence_kernel
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.fused_step import (fused_step_kernel,
                                            fused_step_plain,
                                            quantized_fused_step_kernel)
from repro_torch.kernels.quantized_matmul import quantized_matmul_kernel
from repro_torch.models.quantize import quantize_tensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, dev):
    return torch.randn(shape, generator=gen, device=dev)


def _bf16_close(out, want):
    """|out - want| <= 2^-7 |want| + 1e-4 elementwise: the kernel and the
    plain version sum in another order in f32 and each rounds once to
    bf16, so they may differ by one bf16 step (2^-7 relative)."""
    err = (out.float() - want.float()).abs()
    assert bool((err <= want.float().abs() * 2 ** -7 + 1e-4).all()), \
        float(err.max())


def _block_attention_case(dev, dtype, B, bs, H, Kh, D, T, fill, slot, exc,
                          window):
    """K1 once on seeded inputs in ``dtype``: (kernel out, plain out)."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = _rand(g, B, bs, H, D, dev=dev).to(dtype)
    ck = _rand(g, B, T, Kh, D, dev=dev).to(dtype)
    cv = _rand(g, B, T, Kh, D, dev=dev).to(dtype)
    bk = _rand(g, B, bs, Kh, D, dev=dev).to(dtype)
    bv = _rand(g, B, bs, Kh, D, dev=dev).to(dtype)
    ar = torch.arange(T, device=dev)
    pos = torch.where(ar < fill, ar, -1).to(torch.int32)
    kw = dict(slot=slot, block_start=fill, window=window)
    if exc:
        kw.update(exclude_start=exc[0], exclude_len=exc[1])
    exc_start, exc_len = exc if exc else (None, 0)
    sc = row_scalars(B, dev, slot=slot, block_start=fill,
                     kv_limit=kv_limit_from_pos(pos), exclude_start=exc_start,
                     exclude_len=exc_len)
    n0 = cached_block_attention_kernel.launches
    out = cached_block_attention_kernel(q, ck, cv, bk, bv, pos, sc,
                                        exclude_len=exc_len, window=window)
    torch.cuda.synchronize()
    assert cached_block_attention_kernel.launches == n0 + 1
    assert out.dtype == dtype
    return out, ref.cached_block_attention_ref(q, ck, cv, bk, bv, pos, **kw)


@pytest.mark.parametrize("B,bs,H,Kh,D,T,fill,slot,exc,window", [
    (2, 8, 8, 2, 64, 100, 40, 40, None, 0),     # GQA 4, ragged T
    (2, 32, 4, 4, 128, 96, 64, 64, (16, 32), 0),  # dual exclude
    (1, 8, 4, 4, 32, 64, 40, 64, None, 0),      # sentinel slot
    (1, 8, 4, 4, 32, 64, 40, 40, None, 12),     # window
])
def test_block_attention_kernel(dev, B, bs, H, Kh, D, T, fill, slot, exc,
                                window):
    out, want = _block_attention_case(dev, torch.float32, B, bs, H, Kh, D,
                                      T, fill, slot, exc, window)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,bs,H,Kh,D,T,fill,slot,exc,window", [
    (2, 8, 8, 2, 64, 100, 40, 40, None, 0),     # GQA 4, ragged T
    (2, 32, 4, 4, 128, 96, 64, 64, (16, 32), 0),  # dual exclude
    (1, 8, 4, 4, 32, 64, 40, 64, None, 0),      # sentinel slot
    (1, 8, 4, 4, 32, 64, 40, 40, None, 12),     # window
    (2, 16, 4, 4, 32, 200, 150, 150, None, 0),  # D 32, several tiles
    (2, 32, 8, 4, 64, 256, 192, 192, None, 0),  # D 64, GQA 2, full tiles
    (2, 8, 4, 4, 256, 72, 50, 50, None, 0),     # D 256: the 2-stage ring
    (3, 40, 6, 2, 96, 130, 70, 70, None, 0),    # D 96, bs past one tile
])
def test_block_attention_kernel_bf16(dev, B, bs, H, Kh, D, T, fill, slot,
                                     exc, window):
    """The tensor-core body against the plain version in bf16."""
    out, want = _block_attention_case(dev, torch.bfloat16, B, bs, H, Kh, D,
                                      T, fill, slot, exc, window)
    _bf16_close(out, want)


def _paged_inputs(g, dev, B, bs, H, Kh, D, T, ps, spare=3):
    """Random pool and q/k/v, and a random permutation of physical pages
    as every row's page table (``n_log * ps >= T``)."""
    n_log = -(-T // ps)
    P = B * n_log + spare
    pt = torch.randperm(P, generator=g, device=dev)[:B * n_log] \
        .reshape(B, n_log).to(torch.int32)
    return (_rand(g, B, bs, H, D, dev=dev), _rand(g, P, ps, Kh, D, dev=dev),
            _rand(g, P, ps, Kh, D, dev=dev), _rand(g, B, bs, Kh, D, dev=dev),
            _rand(g, B, bs, Kh, D, dev=dev), pt)


def _paged_block_attention_case(dev, dtype, B, bs, H, Kh, D, T, ps, fill,
                                exc, window, hole, dead):
    """K4 once on seeded inputs in ``dtype`` over a random page table,
    with an unmapped page inside the valid extent (``hole``) and a
    retired first row (``dead``): (kernel out, plain out)."""
    g = torch.Generator(device=dev).manual_seed(3)
    q, pk, pv, bk, bv, pt = _paged_inputs(g, dev, B, bs, H, Kh, D, T, ps)
    q, pk, pv, bk, bv = (x.to(dtype) for x in (q, pk, pv, bk, bv))
    if hole:
        pt[-1, 1] = -1  # an unmapped page inside the valid extent
    ar = torch.arange(T, device=dev)
    pos = torch.where(ar < fill, ar, -1).to(torch.int32)
    lim = torch.full((B,), fill, dtype=torch.int32, device=dev)
    if dead:
        lim[0] = 0
    exc_start, exc_len = exc if exc else (None, 0)
    sc = row_scalars(B, dev, slot=fill, block_start=fill, kv_limit=lim,
                     exclude_start=exc_start, exclude_len=exc_len)
    n0 = paged_block_attention_kernel.launches
    out = paged_block_attention_kernel(q, pk, pv, bk, bv, pos, pt, sc,
                                       exclude_len=exc_len, window=window)
    torch.cuda.synchronize()
    assert paged_block_attention_kernel.launches == n0 + 1
    assert out.dtype == dtype
    return out, ref.paged_block_attention_ref(
        q, pk, pv, bk, bv, pos, pt, slot=fill, block_start=fill,
        kv_limit=lim, exclude_start=exc_start, exclude_len=exc_len,
        window=window)


@pytest.mark.parametrize("B,bs,H,Kh,D,T,ps,fill,exc,window,hole,dead", [
    (2, 8, 8, 2, 64, 100, 16, 40, None, 0, True, False),  # GQA, ragged T
    (2, 32, 4, 4, 128, 96, 16, 64, (16, 32), 0, False, False),  # exclude
    (1, 8, 4, 4, 32, 64, 16, 40, None, 12, False, False),  # window
    (3, 8, 4, 4, 64, 90, 5, 60, None, 0, True, True),  # ps 5, retired row
])
def test_paged_block_attention_kernel(dev, B, bs, H, Kh, D, T, ps, fill,
                                      exc, window, hole, dead):
    out, want = _paged_block_attention_case(
        dev, torch.float32, B, bs, H, Kh, D, T, ps, fill, exc, window, hole,
        dead)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,bs,H,Kh,D,T,ps,fill,exc,window,hole,dead", [
    (2, 8, 8, 2, 64, 100, 16, 40, None, 0, True, False),  # GQA, ragged T
    (2, 32, 4, 4, 128, 96, 16, 64, (16, 32), 0, False, False),  # exclude
    (1, 8, 4, 4, 32, 64, 16, 40, None, 12, False, False),  # window
    (3, 8, 4, 4, 64, 90, 5, 60, None, 0, True, True),  # ps 5, retired row
    (2, 16, 4, 4, 32, 200, 7, 150, None, 0, True, False),  # D 32, ps 7
    (2, 8, 4, 4, 256, 72, 16, 50, None, 0, True, False),  # D 256
])
def test_paged_block_attention_kernel_bf16(dev, B, bs, H, Kh, D, T, ps,
                                           fill, exc, window, hole, dead):
    """The tensor-core body over a page pool against the plain version."""
    out, want = _paged_block_attention_case(
        dev, torch.bfloat16, B, bs, H, Kh, D, T, ps, fill, exc, window,
        hole, dead)
    _bf16_close(out, want)


def test_paged_kernel_is_dense_kernel_on_gathered_view(dev):
    """K4 and K1 share one body: with every page mapped, K4 over any page
    table gives K1's result on the gathered dense view bit for bit."""
    g = torch.Generator(device=dev).manual_seed(4)
    B, bs, H, Kh, D, T, ps, fill = 3, 16, 8, 2, 128, 80, 16, 48
    q, pk, pv, bk, bv, pt = _paged_inputs(g, dev, B, bs, H, Kh, D, T, ps)
    q, pk, pv, bk, bv = (t.to(torch.bfloat16) for t in (q, pk, pv, bk, bv))
    ar = torch.arange(T, device=dev)
    pos = torch.where(ar < fill, ar, -1).to(torch.int32)
    lim = torch.tensor([fill, 0, fill], dtype=torch.int32, device=dev)
    sc = row_scalars(B, dev, slot=fill, block_start=fill, kv_limit=lim)
    slots = torch.arange(T, device=dev)
    phys = pt[:, slots // ps].long()
    ck, cv = pk[phys, slots % ps], pv[phys, slots % ps]
    paged = paged_block_attention_kernel(q, pk, pv, bk, bv, pos, pt, sc)
    dense = cached_block_attention_kernel(q, ck.contiguous(),
                                          cv.contiguous(), bk, bv, pos, sc)
    torch.cuda.synchronize()
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("R,V,offset,ties", [
    (37, 5000, 0, False),
    # ragged vocabularies: rows start off the 16-byte grid
    (32, 5001, 0, False),
    (256, 513, 0, False),
    # one row: 16 CTAs in its cluster
    (1, 126464, 0, False),
    # a base off the 16-byte grid
    (8, 4096, 3, False),
    # equal maxima in different splits of the plan: the first wins
    (32, 126464, 0, True),
    (9, 5001, 2, True),
])
def test_confidence_kernel(dev, R, V, offset, ties):
    """K2 against its plain version (conf 1e-5 relative, tokens equal) on
    ragged, unaligned and tied rows, the same bits on a second call."""
    from repro_torch.kernels.confidence import THREADS, plan

    g = torch.Generator(device=dev).manual_seed(1)
    x = (_rand(g, R * V + offset, dev=dev) * 3)[offset:].view(R, V)
    if ties:
        # integer logits (0..3) with a 9 at a first column in split
        # r % (C - 1) of row r, again in a later thread or lane of the
        # vector, in the same thread's next load, and twice in later
        # splits: the first column must win
        x.copy_(torch.randint(0, 4, (R, V), generator=g, device=dev).float())
        C, split = plan(R, V)
        first = []
        for r in range(R):
            c0 = (r % max(C - 1, 1)) * split + (37 * r) % (split // 2)
            x[r, [min(V - 1, c) for c in (
                c0, c0 + 4 * r + 1, c0 + 4 * THREADS, c0 + split + 3 * r,
                c0 + 2 * split + 3 * r)]] = 9.0
            first.append(c0)
        first = torch.tensor(first, dtype=torch.int32, device=dev)
    conf, tok = fused_confidence_kernel(x)
    again = fused_confidence_kernel(x)
    rc, rt = ref.confidence_ref(x)
    torch.testing.assert_close(conf, rc, rtol=1e-5, atol=0)
    assert torch.equal(tok, rt)
    if ties:
        assert torch.equal(tok, first)
    assert torch.equal(conf, again[0]) and torch.equal(tok, again[1])


@pytest.mark.parametrize("tied,quota", [(True, 0), (False, 0), (False, 3)])
def test_fused_step_kernel(dev, tied, quota):
    g = torch.Generator(device=dev).manual_seed(2)
    R, M, V = 32, 96, 1000
    x = _rand(g, R, M, dev=dev)
    w = _rand(g, *((V, M) if tied else (M, V)), dev=dev)
    masked = torch.rand(R, generator=g, device=dev) < 0.7
    rc0, _ = ref.confidence_ref(ref.unembed(w, x, transpose=tied))
    tau = torch.where(torch.arange(R, device=dev) % 2 == 0, rc0 * 0.5,
                      rc0 * 2.0)
    conf, tok, above = fused_step_kernel(x, w, tau, masked, tied=tied,
                                         quota=quota, group=8 if quota else 0)
    rc, rt, ra = fused_step_kernel(x.cpu(), w.cpu(), tau.cpu(),
                                   masked.cpu(), tied=tied, quota=quota,
                                   group=8 if quota else 0)
    torch.testing.assert_close(conf.cpu(), rc, rtol=1e-5, atol=0)
    assert torch.equal(tok.cpu(), rt) and torch.equal(above.cpu(), ra)


# bf16 K3 on wgmma (the wrapper's plan in brackets):
# (R, M, V, tied, quota)
_K3_BF16_CASES = [
    (1, 512, 1000, False, 0),      # one row (64 x 128, TMA)
    (32, 512, 1000, True, 0),      # Phase 1's rows, tied (64 x 128, TMA)
    (40, 200, 1000, False, 0),     # M not a multiple of 64 (64 x 128, TMA)
    (40, 512, 20000, False, 0),    # 64 x 128, TMA
    (40, 100, 1000, True, 0),      # tied, rows of 200 bytes (plain loads)
    (256, 512, 3001, False, 0),    # untied rows of 6002 bytes (plain)
    (256, 320, 5000, True, 0),     # 256 x 128, ragged V (TMA)
    (300, 512, 2000, False, 0),    # two 256-row tiles (TMA)
    (300, 200, 1003, True, 0),     # tied, ragged R and V (TMA)
    (128, 512, 3001, False, 4),    # quota, group 32 (128 x 128, plain)
    (96, 256, 20000, False, 0),    # 128 x 128, TMA
    (256, 4096, 126464, False, 0),  # the main path's step (256 x 128)
    (32, 4096, 126464, False, 0),   # Phase 1's step (64 x 128)
]


@pytest.mark.parametrize("R,M,V,tied,quota", _K3_BF16_CASES)
def test_fused_step_kernel_bf16(dev, R, M, V, tied, quota):
    """bf16 x and head: every product is exact in f32, so the kernel and
    the plain version differ only in the order of the f32 sums, at most
    ~M 2^-24 sum|x w| a logit (chip_smoke.py's K3 check): conf within
    1e-3 relative, tokens equal where the plain top-2 gap exceeds twice
    that, ``above`` equal where conf is 1e-3 relative away from tau; and
    the same bits twice."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = _rand(g, R, M, dev=dev).to(torch.bfloat16)
    w = (_rand(g, *((V, M) if tied else (M, V)), dev=dev)
         * M ** -0.5).to(torch.bfloat16)
    logits = ref.unembed(w, x, transpose=tied)
    c0, _ = ref.confidence_ref(logits)
    tau = c0 * torch.where(torch.rand(R, generator=g, device=dev) < 0.5,
                           0.8, 1.25)
    masked = torch.rand(R, generator=g, device=dev) < 0.8
    group = 32 if quota else 0
    out = fused_step_kernel(x, w, tau, masked, tied=tied, quota=quota,
                            group=group)
    again = fused_step_kernel(x, w, tau, masked, tied=tied, quota=quota,
                              group=group)
    rc, rt, ra = fused_step_plain(x, w, tau, masked, tied=tied, quota=quota,
                                  group=group)
    conf, tok, above = out
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    sabs = ref.unembed(w.abs(), x.abs(), transpose=tied)
    clear = -logits.topk(2, dim=-1).values.diff(dim=-1)[:, 0] > \
        2 * M * 2.0 ** -24 * sabs.amax(dim=-1)
    far = torch.ones_like(masked) if quota else \
        (rc - tau).abs() > 1e-3 * rc
    assert float(((conf - rc).abs() / rc).max()) <= 1e-3
    assert not bool(((tok != rt) & clear).any())
    assert not bool(((above != ra) & far).any())


@pytest.mark.parametrize("R,K,N", [
    (1, 128, 128),     # one row; bf16 fills its ring by TMA
    (70, 256, 1000),   # ragged row and column tiles
    (13, 200, 513),    # ragged everything
    (9, 130, 515),     # no row of q 4-aligned: byte loads (bf16: plain)
    (16, 1000, 384),   # K not a multiple of the 64-deep stage
    (256, 512, 200),   # 256 rows; N not a multiple of 128
    # bf16 block shapes (the wrapper's plan on a 132-SM card):
    (256, 1000, 12288),  # 256 x 128, ragged K
    (300, 1000, 4096),   # 128 x 64, ragged R and K
    (300, 512, 12200),   # 256 x 128 through plain loads (N % 16 != 0)
])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_matmul_kernel(dev, R, K, N, transpose, dtype):
    """K5 against its plain version: float32 within 1e-5 (the sums run in
    another order); bf16 within one bf16 step of the output (2^-7
    relative) plus 1e-4."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = _rand(g, R, K, dev=dev).to(dtype)
    w = _rand(g, *((N, K) if transpose else (K, N)), dev=dev) * K ** -0.5
    qt = quantize_tensor(w, axis=-1 if transpose else -2)
    n0 = quantized_matmul_kernel.launches
    out = quantized_matmul_kernel(x, qt.q, qt.scale, transpose=transpose)
    torch.cuda.synchronize()
    assert quantized_matmul_kernel.launches == n0 + 1
    assert out.dtype == dtype and out.shape == (R, N)
    want = ref.quantized_matmul_ref(x, qt.q, qt.scale, transpose=transpose)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(out.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-4)


@pytest.mark.parametrize("R,K,N", [
    (1, 128, 128),     # one row, 64-row block by TMA
    (13, 200, 513),    # ragged everything: plain loads
    (128, 512, 4096),  # 128-row block
    (300, 1000, 2000),  # 256-row blocks, ragged R and K
    (256, 512, 200),   # one ragged column tile (N % 16 != 0: plain loads)
])
@pytest.mark.parametrize("transpose", [False, True])
def test_quantized_matmul_kernel_f32_out(dev, R, K, N, transpose):
    """K5's head route, bf16 x with float32 out (one bf16 term on the head
    body): within 1e-5 of the plain version, the float32 product of the
    widened x (the sums run in another order); a second launch gives the
    same bits."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = _rand(g, R, K, dev=dev).to(torch.bfloat16)
    w = _rand(g, *((N, K) if transpose else (K, N)), dev=dev) * K ** -0.5
    qt = quantize_tensor(w, axis=-1 if transpose else -2)
    n0 = quantized_matmul_kernel.launches
    h0 = quantized_matmul_kernel.head_launches
    out = quantized_matmul_kernel(x, qt.q, qt.scale, transpose=transpose,
                                  out_dtype=torch.float32)
    again = quantized_matmul_kernel(x, qt.q, qt.scale, transpose=transpose,
                                    out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert quantized_matmul_kernel.launches == n0 + 2
    assert quantized_matmul_kernel.head_launches == h0 + 2
    assert out.dtype == torch.float32 and out.shape == (R, N)
    want = ref.quantized_matmul_ref(x, qt.q, qt.scale, transpose=transpose,
                                    out_dtype=torch.float32)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, again)


@pytest.mark.parametrize("R,M,V", [(32, 96, 1000), (13, 200, 513),
                                   (256, 512, 3001)])
@pytest.mark.parametrize("tied,quota", [(True, 0), (False, 0), (False, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_fused_step_kernel(dev, R, M, V, tied, quota, dtype):
    """K6 against its plain version: conf within 1e-5 relative (float32
    sums in another order; the head is drawn at the model's 1/sqrt(M)
    scale, so logits stay near 1 where a float32 step is ~1e-7), tokens
    and selections equal (thresholds sit a factor 2 from every
    confidence)."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = _rand(g, R, M, dev=dev).to(dtype)
    w = _rand(g, *((V, M) if tied else (M, V)), dev=dev) * M ** -0.5
    qt = quantize_tensor(w, axis=-1 if tied else -2)
    masked = torch.rand(R, generator=g, device=dev) < 0.7
    rc0, _, _ = ref.quantized_fused_step_ref(
        x, qt.q, qt.scale, torch.zeros(R, device=dev), masked, tied=tied)
    tau = torch.where(torch.arange(R, device=dev) % 2 == 0, rc0 * 0.5,
                      rc0 * 2.0)
    # quota ranks inside groups of 8 rows, or in one group of all R
    group = (8 if R % 8 == 0 else R) if quota else 0
    n0 = quantized_fused_step_kernel.launches
    conf, tok, above = quantized_fused_step_kernel(
        x, qt.q, qt.scale, tau, masked, tied=tied, quota=quota, group=group)
    torch.cuda.synchronize()
    assert quantized_fused_step_kernel.launches == n0 + 1
    rc, rt, ra = quantized_fused_step_kernel(
        x.cpu(), qt.q.cpu(), qt.scale.cpu(), tau.cpu(), masked.cpu(),
        tied=tied, quota=quota, group=group)
    torch.testing.assert_close(conf.cpu(), rc, rtol=1e-5, atol=0)
    assert torch.equal(tok.cpu(), rt) and torch.equal(above.cpu(), ra)


@pytest.mark.parametrize("B,H,S,T,D,causal,q_offset", [
    (1, 2, 64, 64, 32, True, 0),
    (2, 1, 48, 96, 64, True, 48),     # S < T, bottom-right aligned
    (1, 1, 33, 65, 16, False, 0),     # ragged S and T
    (2, 3, 1, 77, 128, True, 76),     # one query
    (1, 2, 70, 40, 64, True, -30),    # rows that see no key
    (1, 2, 128, 128, 128, False, 0),
    (1, 2, 64, 64, 128, False, 0),    # half a 128-row block
    (2, 2, 256, 256, 128, False, 0),  # two blocks a head
    (2, 2, 256, 256, 128, True, 0),   # causal: later blocks see more keys
    (1, 3, 200, 231, 128, True, 31),  # causal ragged tail of S and T
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, B, H, S, T, D, causal, q_offset, dtype):
    """K7 against its plain version: float32 within 2e-5 (the reference
    sweep's tolerance); bf16 elementwise within 2^-7 |want| + 2^-7 (P|V|):
    both round the output to bf16 once (one step apart at most), and the
    kernel rounds each probability to bf16 before P V, which moves the
    output by at most 2^-8 (P|V|)."""
    g = torch.Generator(device=dev).manual_seed(7)
    q = _rand(g, B, H, S, D, dev=dev).to(dtype)
    k = _rand(g, B, H, T, D, dev=dev).to(dtype)
    v = _rand(g, B, H, T, D, dev=dev).to(dtype)
    n0 = flash_attention_kernel.launches
    out = flash_attention_kernel(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    else:
        pv = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                     causal=causal, q_offset=q_offset)
        err = (out.float() - want.float()).abs()
        assert bool((err <= 2 ** -7 * (want.float().abs() + pv)).all()), \
            float(err.max())


def _record_batches(sched):
    """``chip_smoke.record_batches``: the one recorder of the scheduler's
    generate calls (inputs, page table and result of each batch)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.record_batches(sched)


def _on(tree, dev):
    return {k: _on(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def test_engine_on_card_matches_cpu(dev):
    """A reduced serving engine (three tasks, two batches of 4, the first
    calibrating all three) through the block attention (K1) and fused step
    (K3) kernels on the card against the same engine on the CPU: the
    reduced model decode's bar in ``chip_smoke.reduced_reference_check``,
    >= 0.95 of the tokens equal (a float32 near-tie may flip) and the
    calibrated tables within 1e-4; the batches and dead slots equal."""
    import dataclasses

    import numpy as np

    from repro_torch.config.base import DecodeConfig, EngineConfig
    from repro_torch.config.registry import get_config
    from repro_torch.data import tokenizer as tok
    from repro_torch.data.tasks import TASKS
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DiffusionEngine
    from repro_torch.serving.scheduler import Request

    cfg = dataclasses.replace(
        get_config("llada-8b").reduced(num_layers=2, max_d_model=128,
                                       vocab_size=tok.VOCAB),
        mask_token_id=tok.MASK_ID)
    dcfg = DecodeConfig(max_new_tokens=32, block_size=8, policy="osdt",
                        cap=0.75, slack=0.2, step_fusion="fused")
    ecfg = EngineConfig(batch_size=4, prompt_len=32, attn_impl="kernel")
    rng = np.random.default_rng(0)
    names = ("gsm8k-syn", "gpqa-syn", "humaneval-syn")
    per = {t: TASKS[t].make(rng, 2) for t in names}
    reqs = [Request(i, names[i % 3], per[names[i % 3]][i // 3].prompt)
            for i in range(6)]
    cpu = M.init_params(cfg, seed=0, device="cpu")
    out = {}
    for name, params in (("cpu", cpu), ("gpu", _on(cpu, dev))):
        eng = DiffusionEngine(params, cfg, dcfg, ecfg=ecfg)
        calls = _record_batches(eng.scheduler)
        n0 = (cached_block_attention_kernel.launches,
              fused_step_kernel.launches)
        eng.submit(list(reqs))
        n1 = (cached_block_attention_kernel.launches,
              fused_step_kernel.launches)
        out[name] = (eng, torch.cat([c["res"].tokens.cpu() for c in calls]),
                     n0, n1)
    (ce, ct, c0, c1), (ge, gt, g0, g1) = out["cpu"], out["gpu"]
    assert c1 == c0 and all(b > a for a, b in zip(g0, g1))
    assert (ge.stats.batches, ge.stats.dead_slots, ge.stats.requests) == \
        (ce.stats.batches, ce.stats.dead_slots, ce.stats.requests) == (2, 2, 6)
    for t in names:
        np.testing.assert_allclose(ge.store.tables[t], ce.store.tables[t],
                                   rtol=0, atol=1e-4)
    assert float((gt == ct).float().mean()) >= 0.95
