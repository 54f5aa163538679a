"""Fused confidence: the CUDA kernel's wrapper (K2).

``fused_confidence_kernel`` is the port of the reference's
``fused_confidence_pallas``: one pass over the vocab gives ``conf = max
softmax`` and ``tok = argmax`` (first occurrence). Source:
``csrc/confidence.cu``: one launch whose C CTAs a row form a thread-block
cluster, each streaming a share of the row's 16-byte vectors, merged in
rank order through the cluster's shared memory; the only device memory
it writes is ``conf`` and ``tok``. :func:`plan` picks C. A CPU tensor
goes to the plain version (``ref.confidence_ref``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import confidence_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_confidence": (ctypes.c_int, [_P] * 3 + [_I] * 3 + [_P]),
}

# csrc/confidence.cu's kThreads, kUnroll and kMaxCluster
THREADS, UNROLL, MAX_CLUSTER = 256, 4, 16
# the card's SMs
SMS = 132


class Plan(NamedTuple):
    cluster: int   # CTAs a row, one thread-block cluster
    split: int     # columns a CTA streams as vectors, of a 16-byte aligned row


def plan(R: int, V: int) -> Plan:
    """The launch of ``R`` rows of ``V`` columns: the smallest power-of-two
    cluster from 2 to ``MAX_CLUSTER`` that gives every SM a CTA (``R * C
    >= SMS``). Phase 1's 32 rows take 8 and Phase 2's 256 take 2: both
    fill the card in one wave (four CTAs a SM), with no wave tail. More
    CTAs a row only add partials to merge."""
    c = 2
    while c < MAX_CLUSTER and c * R < SMS:
        c *= 2
    return Plan(c, 4 * -(-(V // 4) // c))


def fused_confidence_kernel(logits: torch.Tensor):
    """logits [R, V] float32 -> (conf [R] float32, tok [R] int32)."""
    if logits.device.type == "cpu":
        return confidence_ref(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"no confidence kernel for {logits.device}")
    if logits.ndim != 2 or logits.dtype != torch.float32 or \
            not logits.is_contiguous():
        raise ValueError("confidence kernel takes contiguous [R, V] float32 "
                         f"logits, not {tuple(logits.shape)} {logits.dtype}")
    R, V = logits.shape
    conf = torch.empty((R,), dtype=torch.float32, device=logits.device)
    tok = torch.empty((R,), dtype=torch.int32, device=logits.device)
    lib = build.load("confidence", _SIGNATURES)
    build.check(lib.fused_confidence(
        logits.data_ptr(), conf.data_ptr(), tok.data_ptr(), R, V,
        plan(R, V).cluster,
        torch.cuda.current_stream(logits.device).cuda_stream),
        "fused_confidence")
    fused_confidence_kernel.launches += 1
    return conf, tok


fused_confidence_kernel.launches = 0
