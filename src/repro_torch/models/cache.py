"""Decode KV caches: the dense layout, the paged layout and its host-side
page allocator.

Dense layout, as in the reference:
  k, v  : [L, B, T, Kh, D]   (rotary already applied to k)
  pos   : [T] int32          absolute position held in each slot, -1 = empty
  length: int                tokens written so far (a host integer here:
                             eager PyTorch reads it without a device sync)

The writes update the given tensors IN PLACE and return them (the
reference returns new arrays); callers that need the old contents clone
first. When ``T`` is shorter than the sequence the cache is a ring buffer:
a write that crosses the end wraps to slot 0.

Paged layout, as in the reference:
  kp, vp: [L, num_pages, page_size, Kh, D]  one pool shared by all rows
  pt    : [B, n_log] int32                  physical page of each row's
                                            logical page, -1 = unmapped
  pos, length: as in the dense layout (logical slots)
Writes through an unmapped entry are dropped, in place as above.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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


def rows_write_index(starts: torch.Tensor, S: int, T: int
                     ) -> Tuple[torch.Tensor, ...]:
    """The in-range entries of a per-row write of S slots, row ``b`` at
    slot ``starts[b]``: (row, chunk position, slot), one long tensor each.
    A start ``>= T`` (the write-gating sentinel of a row with nothing to
    commit) drops its row, and slots past ``T`` drop. torch has no
    dropping scatter, so the entries are filtered here (one host sync);
    a block step builds the index once for all its layers."""
    slots = starts.to(torch.int64)[:, None] + torch.arange(
        S, dtype=torch.int64, device=starts.device)              # [B, S]
    b, s = torch.nonzero((slots >= 0) & (slots < T), as_tuple=True)
    return b, s, slots[b, s]


def kv_write_slice_rows(cache_k: torch.Tensor, cache_v: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        starts: torch.Tensor, index=None):
    """Per-row companion of :func:`kv_write_slice`, in place: row ``b``'s
    [S] chunk lands at slot ``starts[b]`` of its own cache row (no ring
    wrap: the sliced decode loop owns full-length buffers). A start ``>=
    T`` drops the row's write. ``index`` is a prebuilt
    :func:`rows_write_index`."""
    b, s, slot = index if index is not None else rows_write_index(
        starts, k_new.shape[1], cache_k.shape[1])
    cache_k[b, slot] = k_new[b, s].to(cache_k.dtype)
    cache_v[b, slot] = v_new[b, s].to(cache_v.dtype)
    return cache_k, cache_v


def pos_write_slice_rows(pos: torch.Tensor, positions: torch.Tensor,
                         starts: torch.Tensor, index=None) -> torch.Tensor:
    """Per-row companion of :func:`pos_write_slice`, in place: mark every
    row's written slots valid in the SHARED [T] pos row (a union). Slot
    ranges are disjoint across rows, or identical with identical values
    when rows are uniform, so the order of the writes cannot matter.
    Sentinel starts (``>= T``) drop. positions [B, S]."""
    b, s, slot = index if index is not None else rows_write_index(
        starts, positions.shape[1], pos.shape[0])
    pos[slot] = positions[b, s].to(torch.int32)
    return pos


# ---------------------------------------------------------------------------
# paged KV: pool init, gather/scatter through page tables
# ---------------------------------------------------------------------------

def init_paged_kv_cache(num_layers: int, batch: int, max_len: int,
                        kv_heads: int, head_dim: int, dtype, *,
                        page_size: int, num_pages: int, device=None) -> dict:
    """Fresh paged cache: zeroed pool, fully unmapped tables."""
    device = resolve_device(device)
    n_log = -(-max_len // page_size)
    shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
    return {
        "kp": torch.zeros(shape, dtype=dtype, device=device),
        "vp": torch.zeros(shape, dtype=dtype, device=device),
        "pt": torch.full((batch, n_log), -1, dtype=torch.int32,
                         device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
        "length": 0,
    }


def identity_page_table(batch: int, max_len: int, page_size: int,
                        device=None) -> torch.Tensor:
    """[B, n_log] table mapping row b's logical page j to physical page
    ``b * n_log + j``: the trivial private layout."""
    device = resolve_device(device)
    n_log = -(-max_len // page_size)
    ar = torch.arange(n_log, dtype=torch.int32, device=device)
    return torch.arange(batch, dtype=torch.int32, device=device)[:, None] \
        * n_log + ar[None, :]


def _page_index(page_table: torch.Tensor, start, S: int,
                page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical page [B, S], in-page offset [S] or [B, S]) of logical
    slots ``start + arange(S)``. ``start`` is an int (every row writes the
    same logical range) or per-row [B] (the sliced decode loop: each row
    commits its own cursor block). Unmapped or out-of-range entries come
    back negative; callers clamp (gather) or drop (scatter)."""
    ar = torch.arange(S, dtype=torch.int32, device=page_table.device)
    per_row = isinstance(start, torch.Tensor) and start.ndim == 1
    if per_row:
        slots = start.to(page_table.device, torch.int32)[:, None] + ar
    else:
        slots = int(start) + ar
    lp = torch.div(slots, page_size, rounding_mode="floor")
    off = slots % page_size
    n_log = page_table.shape[1]
    in_range = (lp >= 0) & (lp < n_log)
    lp_safe = lp.clamp(0, n_log - 1).long()
    if per_row:
        pp = torch.gather(page_table, 1, lp_safe)
        return torch.where(in_range, pp, -1), off
    pp = page_table[:, lp_safe]
    return torch.where(in_range[None], pp, -1), off


def paged_kv_gather(pool_k: torch.Tensor, pool_v: torch.Tensor,
                    page_table: torch.Tensor, max_len: int, *,
                    page_size: int):
    """Materialise the dense logical view [B, T, Kh, D] of a paged row set
    from one layer's pools [P, ps, Kh, D]. Returns (k, v, mapped):
    ``mapped`` [B, T] flags slots whose page is mapped; unmapped slots
    read page 0 (finite garbage) and must be masked by the caller."""
    pp, off = _page_index(page_table, 0, max_len, page_size)
    mapped = pp >= 0
    pp = pp.clamp(min=0).long()
    off = off.long()[None]
    return pool_k[pp, off], pool_v[pp, off], mapped


def paged_write_index(page_table: torch.Tensor, start, S: int,
                      page_size: int, limit: Optional[int] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """The mapped entries of a write of S slots at logical ``start`` (an
    int, or per-row [B]): (row, chunk position, physical page, in-page
    offset), one long tensor each. torch has no dropping scatter and a
    clamped index would write page 0, so unmapped entries, and with
    ``limit`` every slot at or past it (a per-row start ``>= T`` is the
    sliced loop's write-gating sentinel), are filtered out here; the
    filter reads the mask on the host (one sync). The index depends only
    on the page table and the slot range, so a block step builds it once
    for all its layers."""
    pp, off = _page_index(page_table, start, S, page_size)
    keep = pp >= 0
    if limit is not None:
        ar = torch.arange(S, device=pp.device)
        slots = (start.to(pp.device)[:, None] if isinstance(
            start, torch.Tensor) and start.ndim == 1 else int(start)) + ar
        keep &= slots < limit
    b, s = torch.nonzero(keep, as_tuple=True)
    off = off[b, s] if off.ndim == 2 else off[s]
    return b, s, pp[b, s].long(), off.long()


def paged_kv_write(pool_k: torch.Tensor, pool_v: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   page_table: torch.Tensor, start, *, page_size: int,
                   index=None):
    """Scatter a [B, S, Kh, D] chunk at logical slot ``start`` (an int, or
    per-row [B]) through the page table into one layer's pools [P, ps,
    Kh, D], in place. Writes through unmapped entries are dropped. Rows
    must not share the pages they write. ``index`` is a prebuilt
    :func:`paged_write_index`."""
    b, s, pp, off = index if index is not None else paged_write_index(
        page_table, start, k_new.shape[1], page_size)
    pool_k[pp, off] = k_new[b, s].to(pool_k.dtype)
    pool_v[pp, off] = v_new[b, s].to(pool_v.dtype)
    return pool_k, pool_v


def paged_kv_write_layers(pool_k: torch.Tensor, pool_v: torch.Tensor,
                          ks: torch.Tensor, vs: torch.Tensor,
                          page_table: torch.Tensor, start: int, *,
                          page_size: int):
    """All-layer variant (prefill), in place: pools [L, P, ps, Kh, D],
    chunks [L, B, S, Kh, D]."""
    b, s, pp, off = paged_write_index(page_table, start, ks.shape[2],
                                      page_size)
    pool_k[:, pp, off] = ks[:, b, s].to(pool_k.dtype)
    pool_v[:, pp, off] = vs[:, b, s].to(pool_v.dtype)
    return pool_k, pool_v


# ---------------------------------------------------------------------------
# page ownership (host-side)
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free-list page allocator with refcounted sharing.

    Pure host state over physical page ids ``[0, num_pages)``; the pool
    tensors live on the device. ``alloc`` hands out private pages
    (refcount 1), ``share`` takes an extra reference on existing pages (a
    shared system-prompt prefix mapped into another row), ``fork`` maps a
    parent's pages read-only plus fresh private pages, ``free`` drops one
    reference and returns zero-ref pages to the free list. Every method
    validates its whole argument before changing anything, so a raise
    leaves the ledger exactly as it was.
    """

    def __init__(self, num_pages: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, not {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refs = [0] * num_pages

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: Sequence[int]) -> None:
        for p in pages:  # validate all before bumping any
            if self._refs[p] <= 0:
                raise ValueError(f"sharing an unallocated page {p}")
        for p in pages:
            self._refs[p] += 1

    def fork(self, parent: Sequence[int], n_private: int
             ) -> Tuple[List[int], List[int]]:
        """Copy-on-write fork of a row's page set: the child maps every
        ``parent`` page read-only (a refcount bump; pages are never
        copied, since write boundaries are page-aligned) and receives
        ``n_private`` fresh pages. Returns ``(shared, private)``. When the
        private allocation cannot be met, no parent reference is taken.
        Release a fork with ``free(shared); free(private)``."""
        if n_private > len(self._free):
            raise MemoryError(
                f"page pool exhausted: fork wants {n_private} private "
                f"pages, have {len(self._free)}")
        for p in parent:
            if self._refs[p] <= 0:
                raise ValueError(f"forking an unallocated parent page {p}")
        self.share(parent)
        return list(parent), self.alloc(n_private)

    def free(self, pages: Sequence[int]) -> None:
        drops: dict = {}  # duplicate-aware, validated before any drop
        for p in pages:
            drops[p] = drops.get(p, 0) + 1
        for p, n in drops.items():
            if self._refs[p] < n:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
