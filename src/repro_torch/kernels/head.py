"""The head body's launch plan (``csrc/head_wgmma.cuh``).

One ``wgmma`` body serves the bf16 fused step (K3), the int8 fused step
(K6) and the int8 matmul's float32 output (K5's head). This module holds
what their wrappers share: the block shapes, :func:`plan`, and
:func:`int8_launch`, which prepares x's terms for an int8 head.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

# the block shapes (head_wgmma.cuh launch): (rows of x, vocab columns)
_TILES = ((256, 128), (128, 128), (64, 128))


class Plan(NamedTuple):
    """A launch of the head body: ``tile`` indexes ``_TILES``; ``rows`` x
    ``width`` is the block (x rows by vocab columns, one partial per row
    and ``width`` columns); ``tma`` feeds the ring by TMA, else by plain
    loads into the same layouts."""
    tile: int
    rows: int
    width: int
    tma: bool


def plan(R: int, V: int, tied: bool, aligned: bool, *, int8: bool = False,
         terms: int = 1) -> Plan:
    """The head body's block for R rows and a V-column head (K3's bf16
    head; K6's and K5's float32 output's int8 head with ``int8``): the
    fewest rows of 64, 128 and 256 that hold R (256 past that) x 128
    columns; x in three bf16 terms (f32 x) takes at most 128 rows, whose
    stage fits four times in shared memory. TMA needs 16-byte aligned
    rows: ``aligned`` says so of x's rows, the base pointers and, for a
    tied int8 head, its rows (M bytes); an untied head's rows (V bf16 or
    V bytes) must be too. Every block runs the whole K loop, so a
    logit's sums do not depend on the block shape."""
    tile = 2 if R <= 64 else 1 if R <= 128 or terms > 1 else 0
    rows_ok = tied or V % (16 if int8 else 8) == 0
    return Plan(tile, *_TILES[tile], tma=aligned and rows_ok)


def int8_launch(x: torch.Tensor, q: torch.Tensor, V: int, tied: bool
                ) -> Tuple[Optional[torch.Tensor], Plan]:
    """x [R, M] bf16 or f32 against an int8 head of V channels, [V, M]
    (``tied``) or [M, V] -> (terms, plan): bf16 x is one term (``terms``
    None); f32 x is split on the card into ``terms`` [3, R, M] bf16 of
    scratch, allocated here, and runs as three."""
    R, M = x.shape
    bf16 = x.dtype == torch.bfloat16
    terms = None if bf16 else torch.empty((3, R, M), dtype=torch.bfloat16,
                                          device=x.device)
    xt = x if bf16 else terms
    aligned = M % (16 if tied else 8) == 0 and xt.data_ptr() % 16 == 0 \
        and q.data_ptr() % 16 == 0
    return terms, plan(R, V, tied, aligned, int8=True,
                       terms=1 if bf16 else 3)
