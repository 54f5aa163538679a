"""Shared building blocks (plain functions on tensors).

Weights are stored ``[d_in, d_out]`` as in the reference, and layer leaves
are stacked ``[L, ...]``. Compute runs in the parameter dtype; the
normalisation statistics and the logits are float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.quantize import QuantizedTensor

# vocabulary columns per f32 upcast of a narrower head (see ``unembed``)
UNEMBED_CHUNK = 16384


def f32_scale(d: int) -> float:
    """``1 / sqrt(d)`` rounded as float32 arithmetic rounds it (the
    reference computes the attention scale in float32)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def project(x: torch.Tensor, w) -> torch.Tensor:
    """``x [..., d_in] @ w [d_in, d_out]``. A :class:`QuantizedTensor`
    weight goes through the int8 matmul (``ops.quantized_matmul``); a raw
    weight keeps the plain product, so the bf16 path is unchanged."""
    if isinstance(w, QuantizedTensor):
        from repro_torch.kernels import ops as kops  # kernels sit below models

        return kops.quantized_matmul(x, w)
    return torch.matmul(x, w)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    std = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """[head_dim//2] inverse frequencies, float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate interleaved pairs ``(x[..., 0::2], x[..., 1::2])``.
    x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    inv_freq = rope_frequencies(d, theta, x.device)
    angles = positions.float()[..., None] * inv_freq      # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                 # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    out = torch.stack([out1, out2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = project(x, params["wi_gate"])
    up = project(x, params["wi_up"])
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return project(hidden, params["wo"])


def init_embedding(gen, vocab: int, d_model: int, dtype,
                   device) -> torch.Tensor:
    e = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                    device=device)
    return (e * 0.02).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(table_or_head, x: torch.Tensor, *,
            transpose: bool) -> torch.Tensor:
    """Logits in float32. ``transpose`` when reusing the [V, M] embed table.

    A :class:`QuantizedTensor` head (int8) goes through the int8 matmul
    with the activations in their own dtype and float32 out: the float32
    product of the widened activations and the float32 dequantized
    weight, as on the raw path.

    The contraction is float32 as in the reference. A float32 head is used
    as it is. A narrower head (bf16 on the card) is upcast
    ``UNEMBED_CHUNK`` vocabulary columns at a time into a preallocated
    logits buffer, so a step never holds a float32 copy of the whole head
    (2 GB at LLaDA-8B's width); every column's contraction is the same
    float32 product either way.
    """
    w = table_or_head
    if isinstance(w, QuantizedTensor):
        from repro_torch.kernels import ops as kops

        return kops.quantized_matmul(x, w, transpose=transpose,
                                     out_dtype=torch.float32)
    xf = x.float()
    if w.dtype == torch.float32:
        return torch.matmul(xf, w.t() if transpose else w)
    V = w.shape[0] if transpose else w.shape[1]
    out = torch.empty(x.shape[:-1] + (V,), dtype=torch.float32,
                      device=x.device)
    for lo in range(0, V, UNEMBED_CHUNK):
        hi = min(V, lo + UNEMBED_CHUNK)
        wc = w[lo:hi].float().t() if transpose else w[:, lo:hi].float()
        out[..., lo:hi] = torch.matmul(xf, wc)
    return out
