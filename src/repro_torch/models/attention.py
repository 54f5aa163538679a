"""Attention core: masked dense and chunked online-softmax ("flash") paths.

Plain functions over ``q [B,S,H,D]``, ``k/v [B,T,K,D]`` with GQA grouping,
spelled as the reference's XLA paths are (these are not kernels there
either). Mask modes: ``causal`` (kv_pos <= q_pos), ``full``
(bidirectional, MDLM) and ``sliding`` (causal and q_pos - kv_pos < window).
An optional ``kv_valid`` bool [B, T] or [T] masks cache padding.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models.layers import f32_scale

NEG_INF = -1.0e30


def mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, mode: str,
              window: int) -> torch.Tensor:
    """Boolean mask [S, T] from position vectors."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    if mode == "causal":
        return k <= q
    if mode == "full":
        return torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    if mode == "sliding":
        return (k <= q) & (q - k < window)
    raise ValueError(f"unknown mask mode {mode!r}")


def cache_valid_mask(kv_pos: torch.Tensor, *, exclude_start=None,
                     exclude_len: int = 0, window: int = 0,
                     q_last=None) -> torch.Tensor:
    """[T] cache-slot validity from post-write slot positions: ``pos >= 0``,
    minus the slot range ``[exclude_start, exclude_start + exclude_len)``,
    minus entries outside ``window`` of ``q_last``."""
    valid = kv_pos >= 0
    if exclude_start is not None and exclude_len:
        ids = torch.arange(kv_pos.shape[0], dtype=torch.int32,
                           device=kv_pos.device)
        valid &= ~((ids >= exclude_start) & (ids < exclude_start
                                             + exclude_len))
    if window:
        valid &= (q_last - kv_pos) < window
    return valid


def _merge_valid(keep: torch.Tensor, kv_valid: Optional[torch.Tensor]):
    """keep [S,T] + kv_valid [B,T] or [T] -> [B|1,1,1,S,T]."""
    keep = keep[None, None, None]
    if kv_valid is not None:
        if kv_valid.ndim == 1:
            kv_valid = kv_valid[None]
        keep = keep & kv_valid[:, None, None, None, :]
    return keep


def attend_dense(q, k, v, *, q_pos, kv_pos, mode: str = "causal",
                 window: int = 0, kv_valid=None) -> torch.Tensor:
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) * f32_scale(D)
    keep = _merge_valid(mask_bias(q_pos, kv_pos, mode, window), kv_valid)
    scores = torch.where(keep, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, D)


def attend_flash(q, k, v, *, q_pos, kv_pos, mode: str = "causal",
                 window: int = 0, kv_valid=None, q_chunk: int = 512,
                 kv_chunk: int = 1024, kv_limit=None) -> torch.Tensor:
    """Online-softmax attention over q-chunks (outer) and kv-chunks (inner).

    ``kv_limit`` is the length-aware bound: entries at index >= kv_limit
    must already be masked by ``kv_valid``, and the inner loop runs only
    ``ceil(kv_limit / kv_chunk)`` chunks. The tail chunk is clamped into
    range and re-covered indices are masked.
    """
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    assert S % q_chunk == 0, (S, q_chunk)
    nq, nk = S // q_chunk, -(-T // kv_chunk)
    scale = f32_scale(D)
    dev = q.device

    qg = q.reshape(B, nq, q_chunk, K, G, D)
    qp = q_pos.reshape(nq, q_chunk)
    if kv_valid is not None and kv_valid.ndim == 1:
        kv_valid = kv_valid[None].expand(B, T)
    n_live = nk if kv_limit is None else \
        min(max(-(-int(kv_limit) // kv_chunk), 1), nk)
    ar = torch.arange(kv_chunk, device=dev)

    outs = []
    for i in range(nq):
        qc = qg[:, i].float()                      # [B,qc,K,G,D]
        m = torch.full((B, K, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, K, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, q_chunk, D), dtype=torch.float32,
                          device=dev)
        for t in range(n_live):
            start = min(t * kv_chunk, T - kv_chunk)
            kc = k[:, start:start + kv_chunk]
            vc = v[:, start:start + kv_chunk]
            kpc = kv_pos[start:start + kv_chunk]
            owned = (start + ar) >= t * kv_chunk
            s = torch.einsum("bqkgd,btkd->bkgqt", qc, kc.float()) * scale
            keep = mask_bias(qp[i], kpc, mode, window)[None, None, None] & \
                owned[None, None, None, None, :]
            if kv_valid is not None:
                vld = kv_valid[:, start:start + kv_chunk]
                keep = keep & vld[:, None, None, None, :]
            s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p, vc.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))   # [B,qc,K,G,D]
    out = torch.stack(outs, dim=1).reshape(B, S, H, D)
    return out.to(q.dtype)


def attention(q, k, v, *, q_pos, kv_pos, mode: str = "causal",
              window: int = 0, kv_valid=None, dense_limit: int = 2 ** 22,
              impl: str = "auto", kv_limit=None) -> torch.Tensor:
    """``impl``: "auto" picks dense vs chunked by score size (S*T);
    "dense" / "flash" force a path."""
    assert impl in ("auto", "dense", "flash"), impl
    S, T = q.shape[1], k.shape[1]
    if impl == "dense" or (impl == "auto" and S * T <= dense_limit
                           and kv_limit is None):
        return attend_dense(q, k, v, q_pos=q_pos, kv_pos=kv_pos, mode=mode,
                            window=window, kv_valid=kv_valid)
    return attend_flash(q, k, v, q_pos=q_pos, kv_pos=kv_pos, mode=mode,
                        window=window, kv_valid=kv_valid, kv_limit=kv_limit)


def is_row(v) -> bool:
    """Whether a geometry argument is per row: a rank-1 tensor."""
    return isinstance(v, torch.Tensor) and v.ndim == 1


def cached_block_attend(q, cache_k, cache_v, block_k, block_v, kv_pos, *,
                        slot, q_pos, kv_limit=None, exclude_start=None,
                        exclude_len: int = 0, window: int = 0,
                        impl: str = "auto", row_valid=None):
    """The plain cached block step attention (the reference's scalar
    path): write the fresh K/V into a COPY of the layer's cache at
    ``slot``, mask with ``cache_valid_mask``, attend bidirectionally.

    ``row_valid`` [B, T] adds a per-row slot mask on top of the shared
    positional validity (the paged layout passes its page-mapped mask);
    the fresh block always stays valid.

    Per-row forms (the step-sliced decode loop, where each row denoises
    its own cursor block): ``slot`` [B] writes row ``b``'s fresh block at
    its own slot (a sentinel ``>= T`` drops the write: a row with nothing
    to commit), ``q_pos`` [B, S] carries per-row positions (RoPE is
    already applied; "full" masks ignore the values), ``exclude_start``
    [B] excludes each row's own range, and ``kv_limit`` [B] masks each
    row to its own extent (the flash bound becomes the batch max). Any
    per-row argument switches to :func:`_cached_block_attend_rows`, which
    gives uniform rows this path's values bit for bit.

    Returns ``(out, (ck, cv))``: the written copies, for callers that
    commit the step. The inputs are left unchanged.
    """
    if any(is_row(a) for a in (slot, exclude_start, kv_limit)) \
            or q_pos.ndim == 2:
        return _cached_block_attend_rows(
            q, cache_k, cache_v, block_k, block_v, kv_pos, slot=slot,
            q_pos=q_pos, kv_limit=kv_limit, exclude_start=exclude_start,
            exclude_len=exclude_len, window=window, impl=impl,
            row_valid=row_valid)
    ck, cv = cache_lib.kv_write_slice(cache_k.clone(), cache_v.clone(),
                                      block_k, block_v, slot)
    pos = cache_lib.pos_write_slice(kv_pos.clone(), q_pos, slot)
    kv_valid = cache_valid_mask(pos, exclude_start=exclude_start,
                                exclude_len=exclude_len, window=window,
                                q_last=q_pos[-1])
    if row_valid is not None:
        ids = torch.arange(kv_pos.shape[0], device=kv_pos.device)
        in_block = (ids >= int(slot)) & (ids < int(slot) + q_pos.shape[0])
        kv_valid = kv_valid[None] & (row_valid | in_block[None])
    bound = None if kv_limit is None else \
        max(int(kv_limit), int(slot) + q_pos.shape[0])
    out = attention(q, ck, cv, q_pos=q_pos, kv_pos=torch.clamp(pos, min=0),
                    mode="full", kv_valid=kv_valid, impl=impl,
                    kv_limit=bound)
    return out, (ck, cv)


def _cached_block_attend_rows(q, cache_k, cache_v, block_k, block_v, kv_pos,
                              *, slot, q_pos, kv_limit, exclude_start,
                              exclude_len: int, window: int, impl: str,
                              row_valid):
    """Per-row generalisation of :func:`cached_block_attend` (see there).

    The mask is assembled as the scalar path assembles it, ``(pos-valid
    minus the exclusion) AND (row mask OR own fresh block)``, per row, so
    uniform rows give the scalar path's values bit for bit.
    """
    if window:
        raise ValueError("the per-row block attend has no sliding window")
    B, S = block_k.shape[:2]
    T = cache_k.shape[1]
    dev = kv_pos.device
    ids = torch.arange(T, dtype=torch.int32, device=dev)
    q2 = q_pos if q_pos.ndim == 2 else q_pos[None].expand(B, S)
    if is_row(slot):
        slot_r = slot.to(dev, torch.int32)
        idx = cache_lib.rows_write_index(slot_r, S, T)
        ck, cv = cache_lib.kv_write_slice_rows(
            cache_k.clone(), cache_v.clone(), block_k, block_v, slot_r,
            index=idx)
        pos = cache_lib.pos_write_slice_rows(kv_pos.clone(), q2, slot_r,
                                             index=idx)
    else:
        slot_r = torch.full((B,), int(slot), dtype=torch.int32, device=dev)
        ck, cv = cache_lib.kv_write_slice(cache_k.clone(), cache_v.clone(),
                                          block_k, block_v, int(slot))
        pos = cache_lib.pos_write_slice(kv_pos.clone(), q2[0], int(slot))
    valid = cache_valid_mask(pos)[None].expand(B, T)
    if exclude_start is not None and exclude_len:
        exc = torch.as_tensor(exclude_start, dtype=torch.int32,
                              device=dev).reshape(-1).expand(B)
        valid = valid & ~((ids[None] >= exc[:, None])
                          & (ids[None] < exc[:, None] + exclude_len))
    rv = row_valid
    if is_row(kv_limit):
        lim = ids[None] < kv_limit.to(dev)[:, None]
        rv = lim if rv is None else rv & lim
        kv_limit = kv_limit.max()  # flash bound: the batch-max extent
    if rv is not None:
        in_block = (ids[None] >= slot_r[:, None]) \
            & (ids[None] < slot_r[:, None] + S)
        valid = valid & (rv | in_block)
    bound = None if kv_limit is None else \
        max(int(kv_limit), int(slot_r.max()) + S)
    out = attention(q, ck, cv, q_pos=q2[0], kv_pos=torch.clamp(pos, min=0),
                    mode="full", kv_valid=valid, impl=impl, kv_limit=bound)
    return out, (ck, cv)


def paged_cached_block_attend(q, pool_k, pool_v, block_k, block_v,
                              page_table, kv_pos, *, slot, q_pos,
                              page_size: int, kv_limit=None, row_limit=None,
                              exclude_start=None, exclude_len: int = 0,
                              window: int = 0, impl: str = "auto"):
    """Plain paged block step attention for one layer.

    Gathers the dense logical view [B, T, Kh, D] through the page table
    and runs the exact :func:`cached_block_attend` sequence on it, so with
    every page mapped it equals the dense layout bitwise. Unmapped slots
    are masked per row. A rank-1 ``kv_limit`` [B] is folded into the row
    mask (the flash bound becomes the batch max); ``row_limit`` [B] only
    refines the row mask: row ``b`` attends cache slots ``< row_limit[b]``
    (a retired row, limit 0, attends only its fresh block). Returns
    ``(out, mapped)``; committing the block into the pool is a separate
    ``cache.paged_kv_write``.
    """
    T = kv_pos.shape[0]
    ck, cv, mapped = cache_lib.paged_kv_gather(pool_k, pool_v, page_table,
                                               T, page_size=page_size)
    if is_row(kv_limit):
        row_limit = kv_limit if row_limit is None else \
            torch.minimum(row_limit, kv_limit)
        kv_limit = kv_limit.max()
    if row_limit is not None:
        ids = torch.arange(T, dtype=torch.int32, device=kv_pos.device)
        mapped = mapped & (ids[None] < row_limit[:, None])
    out, _ = cached_block_attend(
        q, ck, cv, block_k, block_v, kv_pos, slot=slot, q_pos=q_pos,
        kv_limit=kv_limit, exclude_start=exclude_start,
        exclude_len=exclude_len, window=window, impl=impl,
        row_valid=mapped)
    return out, mapped
