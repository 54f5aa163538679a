"""Per-position confidence = probability of the argmax token.

The decoder's per-step pass over the vocab axis: the CUDA kernel in
``repro_torch.kernels.confidence`` fuses max / argmax / p(argmax) into one
pass; this is the entry point that takes it (``use_kernel=True``) or the
plain form.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops


def confidence_ref(logits: torch.Tensor):
    """logits [..., V] -> (confidence [...], argmax token [...]);
    confidence = softmax(logits)[argmax] = exp(max - logsumexp)."""
    logits = logits.float()
    m = logits.amax(dim=-1)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    return torch.exp(m - lse), tok


def confidence(logits: torch.Tensor, *, use_kernel: bool = False):
    if use_kernel:
        return kops.fused_confidence(logits)
    return confidence_ref(logits)
