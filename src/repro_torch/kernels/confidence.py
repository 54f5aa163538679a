"""Fused confidence: the CUDA kernel's wrapper (K2).

``fused_confidence_kernel`` is the port of the reference's
``fused_confidence_pallas``: one streaming pass over the vocab gives
``conf = max softmax`` and ``tok = argmax`` (first occurrence). Source:
``csrc/confidence.cu``, sharing its accumulator with the fused step
(``csrc/softmax_acc.cuh``). A CPU tensor goes to the plain version
(``ref.confidence_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import confidence_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_confidence": (ctypes.c_int, [_P] * 6 + [_I] * 3 + [_P]),
}

# enough blocks to fill the card's 132 SMs a few times over, and no chunk
# shorter than this many columns
_TARGET_BLOCKS = 528
_MIN_CHUNK = 2048


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
    nsplit = max(1, min(-(-_TARGET_BLOCKS // R), -(-V // _MIN_CHUNK)))
    dev = logits.device
    part_m = torch.empty((nsplit, R), dtype=torch.float32, device=dev)
    part_s = torch.empty((nsplit, R), dtype=torch.float32, device=dev)
    part_i = torch.empty((nsplit, R), dtype=torch.int32, device=dev)
    conf = torch.empty((R,), dtype=torch.float32, device=dev)
    tok = torch.empty((R,), dtype=torch.int32, device=dev)
    lib = build.load("confidence", _SIGNATURES)
    err = lib.fused_confidence(
        logits.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), conf.data_ptr(), tok.data_ptr(), R, V, nsplit,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_confidence")
    fused_confidence_kernel.launches += 1
    return conf, tok


fused_confidence_kernel.launches = 0
