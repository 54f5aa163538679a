"""Cached block attention: the CUDA kernels' wrappers (K1 dense, K4 paged).

``cached_block_attention_kernel`` is the port of the reference's
``cached_block_attention_pallas``: the active block attends the dense
cache (not pre-written) plus its own fresh K/V, with the block step's
masks. ``paged_block_attention_kernel`` ports
``paged_block_attention_pallas``: the same over a page pool read through
a page table. Both kernels are one body in ``csrc/block_attention.cu``. A
CPU tensor goes to the plain version (``ref.cached_block_attention_ref``
/ ``ref.paged_block_attention_ref``); a CUDA tensor launches the kernel
or raises. The per-row geometry arrives as one [5, B] operand
(``row_scalars``), as the reference's scalar-prefetch operand does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (as_row, cached_block_attention_ref,
                                     paged_block_attention_ref)
from repro_torch.models.layers import f32_scale

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "cached_block_attention": (
        ctypes.c_int,
        [_P] * 8 + [_I] * 8 + [ctypes.c_float, _I, _P]),
    "paged_block_attention": (
        ctypes.c_int,
        [_P] * 9 + [_I] * 10 + [ctypes.c_float, _I, _P]),
}


def kv_limit_from_pos(kv_pos: torch.Tensor) -> torch.Tensor:
    """Smallest bound such that every slot with ``pos >= 0`` lies below it
    (a 0-d int32 tensor on ``kv_pos``'s device: no host sync)."""
    ids1 = torch.arange(1, kv_pos.shape[0] + 1, dtype=torch.int32,
                        device=kv_pos.device)
    return torch.where(kv_pos >= 0, ids1, 0).amax().to(torch.int32)


def row_scalars(B: int, device, *, slot, block_start, kv_limit,
                exclude_start=None, exclude_len: int = 0) -> torch.Tensor:
    """The kernel's per-row geometry: [5, B] int32 rows slot, block_start,
    exc0, exc1, kv_limit. Each argument may be an int, [] or per-row [B];
    a block step builds this once for all its layers. Host integers travel
    in one asynchronous copy from pinned memory (a copy from pageable
    memory would wait for the stream); a device ``kv_limit`` stays there."""
    device = torch.device(device)
    exc0 = 0 if exclude_start is None else exclude_start
    geo = [slot, block_start, exc0]
    if all(isinstance(v, int) for v in geo):
        host = torch.tensor(geo + [exc0 + exclude_len], dtype=torch.int32,
                            pin_memory=device.type == "cuda")
        head = host.to(device, non_blocking=True)[:, None].expand(4, B)
    else:
        e0 = as_row(exc0, B, device)
        head = torch.stack([as_row(slot, B, device),
                            as_row(block_start, B, device), e0,
                            e0 + exclude_len])
    return torch.cat([head, as_row(kv_limit, B, device)[None]]).contiguous()


def _check_operands(q, cache, block_k, block_v, kv_pos, T: int, scalars,
                    extra=()) -> None:
    """Raise unless the operands are what the kernel takes: a CUDA device,
    bf16 or f32, the stated shapes, contiguous, on one device.
    ``cache`` lists (name, tensor, expected shape) in q's dtype."""
    if q.device.type != "cuda":
        raise ValueError(f"no block attention kernel for {q.device}")
    B, bs, H, D = q.shape
    Kh = cache[0][2][2]
    for name, t, shape in cache + (("block_k", block_k, (B, bs, Kh, D)),
                                   ("block_v", block_v, (B, bs, Kh, D))):
        if tuple(t.shape) != shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {q.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"block attention kernel takes bf16 or f32, "
                         f"not {q.dtype}")
    if H % Kh or D % 32 or D > 256:
        raise ValueError(f"unsupported heads/width: H={H} Kh={Kh} D={D}")
    if tuple(kv_pos.shape) != (T,) or kv_pos.dtype != torch.int32:
        raise ValueError("kv_pos must be [T] int32")
    if tuple(scalars.shape) != (5, B) or scalars.dtype != torch.int32:
        raise ValueError("scalars must be [5, B] int32")
    tensors = (q, block_k, block_v, kv_pos, scalars) + tuple(
        t for _, t, _ in cache) + tuple(extra)
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("block attention operands must be contiguous and "
                         "on one device")


def cached_block_attention_kernel(q, cache_k, cache_v, block_k, block_v,
                                  kv_pos, scalars, *, exclude_len: int = 0,
                                  window: int = 0) -> torch.Tensor:
    """q [B,bs,H,D]; cache_k/v [B,T,Kh,D]; block_k/v [B,bs,Kh,D];
    kv_pos [T] int32; scalars [5,B] int32 from ``row_scalars`` ->
    [B,bs,H,D]. A sentinel ``slot + bs > T`` hides the fresh block.
    """
    B, bs, H, D = q.shape
    if q.device.type == "cpu":
        return cached_block_attention_ref(
            q, cache_k, cache_v, block_k, block_v, kv_pos, slot=scalars[0],
            block_start=scalars[1], kv_limit=scalars[4],
            exclude_start=scalars[2], exclude_len=exclude_len, window=window)
    T, Kh = cache_k.shape[1], cache_k.shape[2]
    _check_operands(q, (("cache_k", cache_k, (B, T, Kh, D)),
                        ("cache_v", cache_v, (B, T, Kh, D))),
                    block_k, block_v, kv_pos, T, scalars)
    out = torch.empty_like(q)
    lib = build.load("block_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.cached_block_attention(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        block_k.data_ptr(), block_v.data_ptr(), kv_pos.data_ptr(),
        scalars.data_ptr(), out.data_ptr(), B, bs, H, Kh, D, T,
        int(bool(exclude_len)), int(window), f32_scale(D),
        int(q.dtype == torch.bfloat16), stream)
    build.check(err, "cached_block_attention")
    cached_block_attention_kernel.launches += 1
    return out


cached_block_attention_kernel.launches = 0


def paged_block_attention_kernel(q, pool_k, pool_v, block_k, block_v,
                                 kv_pos, page_table, scalars, *,
                                 exclude_len: int = 0,
                                 window: int = 0) -> torch.Tensor:
    """q [B,bs,H,D]; pool_k/v [P,ps,Kh,D] (one layer of the page pool);
    block_k/v [B,bs,Kh,D]; kv_pos [T] int32; page_table [B, n_log] int32
    with ``n_log * ps >= T`` (-1 = unmapped); scalars [5,B] int32 from
    ``row_scalars`` -> [B,bs,H,D]. Unmapped pages and pages at or past a
    row's kv_limit are never read.
    """
    B, bs, H, D = q.shape
    if q.device.type == "cpu":
        return paged_block_attention_ref(
            q, pool_k, pool_v, block_k, block_v, kv_pos, page_table,
            slot=scalars[0], block_start=scalars[1], kv_limit=scalars[4],
            exclude_start=scalars[2], exclude_len=exclude_len, window=window)
    P, ps, Kh = pool_k.shape[0], pool_k.shape[1], pool_k.shape[2]
    T, n_log = kv_pos.shape[0], page_table.shape[-1]
    _check_operands(q, (("pool_k", pool_k, (P, ps, Kh, D)),
                        ("pool_v", pool_v, (P, ps, Kh, D))),
                    block_k, block_v, kv_pos, T, scalars, (page_table,))
    if tuple(page_table.shape) != (B, n_log) or \
            page_table.dtype != torch.int32 or n_log * ps < T:
        raise ValueError(f"page_table must be [B, n_log] int32 with "
                         f"n_log * page_size >= T, got "
                         f"{tuple(page_table.shape)} {page_table.dtype}")
    out = torch.empty_like(q)
    lib = build.load("block_attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_block_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        block_k.data_ptr(), block_v.data_ptr(), kv_pos.data_ptr(),
        page_table.data_ptr(), scalars.data_ptr(), out.data_ptr(), B, bs, H,
        Kh, D, T, n_log, ps, int(bool(exclude_len)), int(window),
        f32_scale(D), int(q.dtype == torch.bfloat16), stream)
    build.check(err, "paged_block_attention")
    paged_block_attention_kernel.launches += 1
    return out


paged_block_attention_kernel.launches = 0
