"""The kernels' entry points, in the reference's call signatures.

Each calls its kernel's wrapper, which makes the one device choice: the
hand-written CUDA kernel for a CUDA tensor, the plain ``ref`` version for
a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.block_attention import (
    cached_block_attention_kernel, kv_limit_from_pos,
    paged_block_attention_kernel, row_scalars)
from repro_torch.kernels.confidence import fused_confidence_kernel
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.fused_step import (fused_step_kernel,
                                            quantized_fused_step_kernel)
from repro_torch.kernels.quantized_matmul import quantized_matmul_kernel
from repro_torch.models.quantize import QuantizedTensor

__all__ = ["cached_block_attention", "cached_block_attention_kernel",
           "flash_attention", "fused_confidence", "fused_step",
           "kv_limit_from_pos", "paged_block_attention",
           "paged_block_attention_kernel", "quantized_matmul", "row_scalars"]


def quantized_matmul(x: torch.Tensor, w: QuantizedTensor, *,
                     transpose: bool = False,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [..., K] @ dequant(w)[(.T)] -> [..., N] in ``out_dtype`` (default
    ``x.dtype``; float32 with bf16 x for the lm head).

    ``w.q`` int8 [K, N] (projections, untied head) or, with
    ``transpose=True``, [N, K] (the tied embed table as the unembed); the
    weight is dequantized per output channel before the product.
    """
    lead = x.shape[:-1]
    out = quantized_matmul_kernel(x.reshape(-1, x.shape[-1]).contiguous(),
                                  w.q, w.scale, transpose=transpose,
                                  out_dtype=out_dtype)
    return out.reshape(*lead, out.shape[-1])


def fused_confidence(logits: torch.Tensor):
    """logits [..., V] -> (conf [...], tok [...])."""
    shape = logits.shape[:-1]
    conf, tok = fused_confidence_kernel(
        logits.reshape(-1, logits.shape[-1]).contiguous())
    return conf.reshape(shape), tok.reshape(shape)


def fused_step(x: torch.Tensor, w: torch.Tensor, tau: torch.Tensor,
               masked: torch.Tensor, *, tied: bool, quota: int = 0):
    """Fused denoising-step epilogue: unembed + confidence + select.

    x [..., M] final-norm'd hidden; w [V, M] (tied) or [M, V], or an int8
    head (:class:`QuantizedTensor`: K6, its per-channel scale applied to
    each logit); tau and masked [...]. ``quota > 0`` ranks over the last
    axis (x must be [B, bs, M]: one ranking group per block row). Returns
    ``(conf, tok, above)`` shaped like ``tau``.
    """
    lead = x.shape[:-1]
    if quota:
        assert x.ndim == 3, "quota ranks over [B, bs, M] block rows"
    if isinstance(w, QuantizedTensor):
        fn, head = quantized_fused_step_kernel, (w.q, w.scale)
    else:
        fn, head = fused_step_kernel, (w,)
    conf, tok, above = fn(
        x.reshape(-1, x.shape[-1]).contiguous(), *head,
        tau.reshape(-1).float().contiguous(), masked.reshape(-1).contiguous(),
        tied=tied, quota=quota, group=lead[-1] if quota else 0)
    return conf.reshape(lead), tok.reshape(lead), above.reshape(lead)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q [B,H,S,D], k/v [B,H,T,D] (equal heads) -> [B,H,S,D] in q's dtype.

    Follows the reference's oracle (``attention_ref``), not its TPU
    dispatch: a causal mask is bottom-right aligned, key ``t`` kept for
    query ``s`` where ``t <= s + T - S``, so the kernel runs with
    ``q_offset = T - S``. The reference's TPU branch calls its kernel with
    ``q_offset = 0`` while its CPU branch takes the oracle's mask; the two
    agree only when S == T.
    """
    T, S = k.shape[2], q.shape[2]
    return flash_attention_kernel(q, k, v, causal=causal,
                                  q_offset=T - S if causal else 0)


def cached_block_attention(q, cache_k, cache_v, block_k, block_v, *,
                           kv_pos, slot, block_start, kv_limit=None,
                           exclude_start=None, exclude_len: int = 0,
                           window: int = 0) -> torch.Tensor:
    """Block-step attention against the KV cache, without pre-writing it.

    q [B,bs,H,D]; cache_k/v [B,T,Kh,D]; block_k/v [B,bs,Kh,D]; kv_pos [T].
    The result equals writing the block at ``slot`` and attending the
    whole buffer with the block step's mask. ``slot`` / ``block_start`` /
    ``exclude_start`` / ``kv_limit`` may each be an int, [] or per-row [B];
    ``kv_limit`` defaults to the extent of the valid slots.
    """
    if kv_limit is None:
        kv_limit = kv_limit_from_pos(kv_pos)
    if exclude_start is None:
        exclude_len = 0
    scalars = row_scalars(q.shape[0], q.device, slot=slot,
                          block_start=block_start, kv_limit=kv_limit,
                          exclude_start=exclude_start,
                          exclude_len=exclude_len)
    return cached_block_attention_kernel(
        q, cache_k, cache_v, block_k, block_v, kv_pos, scalars,
        exclude_len=exclude_len, window=window)


def paged_block_attention(q, pool_k, pool_v, block_k, block_v, *, kv_pos,
                          page_table, slot, block_start, page_size: int,
                          kv_limit=None, exclude_start=None,
                          exclude_len: int = 0,
                          window: int = 0) -> torch.Tensor:
    """Block-step attention against a paged cache.

    q [B,bs,H,D]; pool_k/v [P,ps,Kh,D] (one layer of the page pool);
    block_k/v [B,bs,Kh,D]; kv_pos [T]; page_table [B, n_log] (-1 =
    unmapped). ``slot`` / ``block_start`` / ``exclude_start`` /
    ``kv_limit`` may each be an int, [] or per-row [B]; a retired row
    passes ``kv_limit=0`` and reads none of its pages.
    """
    if pool_k.shape[1] != page_size:
        raise ValueError(f"pool pages hold {pool_k.shape[1]} slots, "
                         f"not page_size={page_size}")
    if kv_limit is None:
        kv_limit = kv_limit_from_pos(kv_pos)
    if exclude_start is None:
        exclude_len = 0
    scalars = row_scalars(q.shape[0], q.device, slot=slot,
                          block_start=block_start, kv_limit=kv_limit,
                          exclude_start=exclude_start,
                          exclude_len=exclude_len)
    return paged_block_attention_kernel(
        q, pool_k, pool_v, block_k, block_v, kv_pos,
        page_table.to(torch.int32).contiguous(), scalars,
        exclude_len=exclude_len, window=window)
