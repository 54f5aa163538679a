"""Dense decode KV cache.

Layout, as in the reference:
  k, v  : [L, B, T, Kh, D]   (rotary already applied to k)
  pos   : [T] int32          absolute position held in each slot, -1 = empty
  length: int                tokens written so far (a host integer here:
                             eager PyTorch reads it without a device sync)

The writes update the given tensors IN PLACE and return them (the
reference returns new arrays); callers that need the old contents clone
first. When ``T`` is shorter than the sequence the cache is a ring buffer:
a write that crosses the end wraps to slot 0.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def init_kv_cache(num_layers: int, batch: int, max_len: int, kv_heads: int,
                  head_dim: int, dtype, device=None) -> dict:
    device = resolve_device(device)
    shape = (num_layers, batch, max_len, kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        "length": 0,
    }


def _ring_index(start: int, n: int, T: int, device) -> torch.Tensor:
    return (start + torch.arange(n, device=device)) % T


def kv_write_slice(cache_k: torch.Tensor, cache_v: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   start: int):
    """Write a [B, S, Kh, D] chunk at slot ``start`` of [B, T, Kh, D]
    buffers, wrap-aware, in place.

    XLA clamps a ``dynamic_update_slice`` start, so the reference spells
    the wrap out with a modular scatter; torch slicing neither clamps nor
    wraps, so both branches are spelled out here too.
    """
    start = int(start)
    S, T = k_new.shape[1], cache_k.shape[1]
    k_new = k_new.to(cache_k.dtype)
    v_new = v_new.to(cache_v.dtype)
    if S >= T:  # the chunk covers the whole ring: only the last T survive
        idx = _ring_index(start + S - T, T, T, cache_k.device)
        cache_k[:, idx] = k_new[:, S - T:]
        cache_v[:, idx] = v_new[:, S - T:]
    elif start + S <= T:  # contiguous
        cache_k[:, start:start + S] = k_new
        cache_v[:, start:start + S] = v_new
    else:  # wraps past the end of the ring
        idx = _ring_index(start, S, T, cache_k.device)
        cache_k[:, idx] = k_new
        cache_v[:, idx] = v_new
    return cache_k, cache_v


def pos_write_slice(pos: torch.Tensor, positions: torch.Tensor,
                    start: int) -> torch.Tensor:
    """Wrap-aware companion of :func:`kv_write_slice` for the [T] pos row,
    in place."""
    start = int(start)
    S, T = positions.shape[0], pos.shape[0]
    positions = positions.to(torch.int32)
    if S >= T:
        pos[_ring_index(start + S - T, T, T, pos.device)] = positions[S - T:]
    elif start + S <= T:
        pos[start:start + S] = positions
    else:
        pos[_ring_index(start, S, T, pos.device)] = positions
    return pos
