"""Plain PyTorch versions of every kernel (the allclose targets).

Each mirrors the reference's ``repro/kernels/ref.py`` function of the same
name, op for op, so that on the CPU the port reproduces the reference's
numbers. The wrappers use them for CPU tensors; ``chip_smoke.py`` holds
the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers import f32_scale, unembed


def confidence_ref(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [R, V] -> (conf [R] f32, tok [R] i32);
    conf = 1 / sum(exp(x - max))."""
    x = logits.float()
    m = x.amax(dim=-1)
    tok = torch.argmax(x, dim=-1).to(torch.int32)
    s = torch.exp(x - m[:, None]).sum(dim=-1)
    return 1.0 / s, tok


def quantized_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                         scale: torch.Tensor, *, transpose: bool,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain version of the int8 matmul kernel (K5), the accuracy contract:
    dequantize first (``q.float() * scale``), round the weight to
    ``x.dtype``, then contract (scaling after the dot is equal in exact
    arithmetic but not in floating point).

    x [..., K]; q int8 [K, N] (or [N, K] with ``transpose=True``); scale
    float32 with the contracted dim kept as size 1. Returns [..., N] in
    ``x.dtype``: a float32 activation contracts in float32, a bf16 one
    like the unquantized bf16 product. ``out_dtype`` (float32 for the lm
    head's bf16 activations) widens x to it first.
    """
    if out_dtype is not None:
        x = x.to(out_dtype)
    w = (q.float() * scale).to(x.dtype)
    return torch.matmul(x, w.t() if transpose else w)


def quota_rank_ref(conf: torch.Tensor, masked: torch.Tensor) -> torch.Tensor:
    """Stable descending rank of ``conf`` within the last axis, masked-out
    entries last: ``argsort(argsort(-conf_m))`` with stable sorts."""
    conf_m = torch.where(masked, conf, -torch.inf)
    order = torch.argsort(-conf_m, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def fused_step_ref(x: torch.Tensor, w: torch.Tensor, tau: torch.Tensor,
                   masked: torch.Tensor, *, tied: bool, quota: int = 0):
    """The unfused epilogue chain: the unembed contraction, then
    ``exp(max - logsumexp)`` confidence, then ``above = masked & (conf >
    tau)`` or, with ``quota > 0``, the per-row top-``quota`` of the masked
    confidences over the last axis. Shape-preserving.

    x [..., M]; w [V, M] (tied) or [M, V]; tau, masked [...].
    Returns (conf f32, tok i32, above bool).
    """
    logits = unembed(w, x, transpose=tied)
    m = logits.amax(dim=-1)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    conf = torch.exp(m - lse)
    if quota:
        above = (quota_rank_ref(conf, masked) < quota) & masked
    else:
        above = masked & (conf > tau.float())
    return conf, tok, above


def quantized_fused_step_ref(x: torch.Tensor, q: torch.Tensor,
                             scale: torch.Tensor, tau: torch.Tensor,
                             masked: torch.Tensor, *, tied: bool,
                             quota: int = 0):
    """Plain version of the int8-head fused step (K6): the head
    dequantized in float32 with one multiply (``q.float() * scale``, not
    rounded to ``x.dtype``), then :func:`fused_step_ref`, which contracts
    ``f32(x)`` against it in float32. This is the unfused int8 epilogue's
    arithmetic (the float32 int8 matmul, then the confidence pass) up to
    the order of the sums.

    q int8 [V, M] (tied) or [M, V]; scale float32 with V elements (one per
    vocab channel), in any shape.
    """
    s = scale.float().reshape((-1, 1) if tied else (1, -1))
    return fused_step_ref(x, q.float() * s, tau, masked, tied=tied,
                          quota=quota)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Plain version of the flash attention kernel (K7).

    q [B,H,S,D], k/v [B,H,T,D] -> [B,H,S,D] in ``q.dtype``, float32 math.
    ``causal`` keeps key ``t`` for query ``s`` where ``t <= s + q_offset``
    and fills the rest with -1e30, so a query that sees no key averages
    all of them, as the softmax of equal scores does.
    """
    S, T = q.shape[2], k.shape[2]
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) \
        * f32_scale(q.shape[-1])
    if causal:
        keep = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None] + q_offset)
        s = torch.where(keep, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool) -> torch.Tensor:
    """q [B,H,S,D], k/v [B,H,T,D] -> [B,H,S,D] (float32 math); the causal
    mask is bottom-right aligned, ``tril(k=T-S)``: key ``t`` is kept for
    query ``s`` where ``t <= s + T - S``."""
    return flash_attention_ref(q, k, v, causal=causal,
                               q_offset=k.shape[2] - q.shape[2])


def as_row(v, B: int, device) -> torch.Tensor:
    """[] / [B] / int -> [B] int32 on ``device``."""
    t = torch.as_tensor(v, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(B)


def _block_attend_oracle(q, ck, cv, block_k, block_v, kv_pos, *, slot,
                         block_start, kv_limit, exclude_start,
                         exclude_len: int, window: int,
                         extra_valid=None) -> torch.Tensor:
    """Virtually write the fresh block at ``slot`` (a per-row mask, so a
    sentinel ``slot + bs > T`` leaves the block invisible), build the
    kv-side validity, dense softmax in float32. Fully masked rows output
    0. Every geometry argument may be an int, [] or per-row [B].
    ``extra_valid`` [B, T] masks cache slots further (the paged layout's
    page-mapped mask); the fresh block stays visible."""
    B, bs, H, D = q.shape
    T, Kh = ck.shape[1], ck.shape[2]
    G = H // Kh
    dev = q.device
    slot = as_row(slot, B, dev)
    block_start = as_row(block_start, B, dev)
    lim = as_row(T if kv_limit is None else kv_limit, B, dev)

    ids = torch.arange(T, dtype=torch.int32, device=dev)
    off = ids[None, :] - slot[:, None]                        # [B, T]
    in_blk = (off >= 0) & (off < bs) & (slot[:, None] + bs <= T)
    offc = torch.clamp(off, 0, bs - 1).long()
    gidx = offc[:, :, None, None].expand(B, T, Kh, D)
    bkg = torch.gather(block_k.float(), 1, gidx)              # [B,T,Kh,D]
    bvg = torch.gather(block_v.float(), 1, gidx)
    sel = in_blk[:, :, None, None]
    ckx = torch.where(sel, bkg, ck.float())
    cvx = torch.where(sel, bvg, cv.float())
    posv = torch.where(in_blk, block_start[:, None] + offc.to(torch.int32),
                       kv_pos.to(torch.int32)[None])          # [B, T]

    valid = torch.where(in_blk, True,
                        (posv >= 0) & (ids[None] < lim[:, None]))
    if extra_valid is not None:
        valid &= extra_valid | in_blk
    if exclude_start is not None and exclude_len:
        exc = as_row(exclude_start, B, dev)
        valid &= ~((ids[None] >= exc[:, None])
                   & (ids[None] < exc[:, None] + exclude_len))
    if window:
        qmax = block_start[:, None] + bs - 1
        valid &= (qmax - posv) < window

    qg = q.reshape(B, bs, Kh, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, ckx) * f32_scale(D)
    s = torch.where(valid[:, None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, cvx)
    out = torch.where(valid.any(-1)[:, None, None, None, None], out, 0.0)
    return out.reshape(B, bs, H, D).to(q.dtype)


def cached_block_attention_ref(q, cache_k, cache_v, block_k, block_v,
                               kv_pos, *, slot, block_start,
                               kv_limit: Optional[object] = None,
                               exclude_start=None, exclude_len: int = 0,
                               window: int = 0) -> torch.Tensor:
    """Plain version of the cached block attention kernel.

    q [B,bs,H,D]; cache_k/v [B,T,Kh,D]; block_k/v [B,bs,Kh,D]; kv_pos [T].
    """
    return _block_attend_oracle(
        q, cache_k, cache_v, block_k, block_v, kv_pos, slot=slot,
        block_start=block_start, kv_limit=kv_limit,
        exclude_start=exclude_start, exclude_len=exclude_len, window=window)


def paged_block_attention_ref(q, pool_k, pool_v, block_k, block_v, kv_pos,
                              page_table, *, slot, block_start,
                              kv_limit: Optional[object] = None,
                              exclude_start=None, exclude_len: int = 0,
                              window: int = 0) -> torch.Tensor:
    """Plain version of the paged block attention kernel (K4).

    Gathers each row's dense logical [T, Kh, D] view through its page
    table (unmapped slots read page 0 and are masked), then runs the
    dense oracle with the page-mapped mask as the extra validity term.

    q [B,bs,H,D]; pool_k/v [P,ps,Kh,D]; block_k/v [B,bs,Kh,D]; kv_pos [T];
    page_table [B, n_log] int32, -1 = unmapped.
    """
    ps, T = pool_k.shape[1], kv_pos.shape[0]
    slots = torch.arange(T, device=q.device)
    pp = page_table[:, torch.div(slots, ps, rounding_mode="floor")]
    mapped = pp >= 0
    pp = pp.clamp(min=0).long()
    off = (slots % ps)[None]
    return _block_attend_oracle(
        q, pool_k[pp, off], pool_v[pp, off], block_k, block_v, kv_pos,
        slot=slot, block_start=block_start, kv_limit=kv_limit,
        exclude_start=exclude_start, exclude_len=exclude_len,
        window=window, extra_valid=mapped)
