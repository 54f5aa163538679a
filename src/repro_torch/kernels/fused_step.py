"""Fused denoising-step epilogue: the CUDA kernel's wrapper (K3).

``fused_step_kernel`` is the port of the reference's
``fused_step_pallas``: the lm-head product runs tile by tile over the
vocab straight into the confidence accumulators, so the logits never
reach device memory, and the kernel emits ``(conf, tok, above)``. Source:
``csrc/fused_step.cu``. A CPU tensor goes to the plain version
(``ref.fused_step_ref``); a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_step_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_step": (ctypes.c_int, [_P] * 10 + [_I] * 7 + [_P]),
}

_VT = 128          # vocab columns per tile (csrc/fused_step.cu kVT)
_ROWS_FINISH = 128  # rows per finishing block in threshold mode


def fused_step_kernel(x: torch.Tensor, w: torch.Tensor, tau: torch.Tensor,
                      masked: torch.Tensor, *, tied: bool, quota: int = 0,
                      group: int = 0):
    """x [R, M]; w [V, M] (tied) or [M, V]; tau [R] f32; masked [R] bool
    -> (conf [R] f32, tok [R] i32, above [R] bool).

    ``quota > 0`` ranks inside each group of ``group`` consecutive rows
    (one batch row's block) instead of comparing with ``tau``.
    """
    R, M = x.shape
    if quota and (group <= 0 or R % group):
        raise ValueError(f"quota ranking needs groups that tile R={R}, "
                         f"got group={group}")
    if x.device.type == "cpu":
        if not quota:
            return fused_step_ref(x, w, tau, masked, tied=tied)
        g = R // group
        conf, tok, above = fused_step_ref(
            x.reshape(g, group, M), w, tau.reshape(g, group),
            masked.reshape(g, group), tied=tied, quota=quota)
        return conf.reshape(R), tok.reshape(R), above.reshape(R)
    if x.device.type != "cuda":
        raise ValueError(f"no fused step kernel for {x.device}")
    V = w.shape[0] if tied else w.shape[1]
    if tuple(w.shape) != ((V, M) if tied else (M, V)) or w.dtype != x.dtype:
        raise ValueError(f"head {tuple(w.shape)} {w.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype} (tied={tied})")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused step kernel takes bf16 or f32, not {x.dtype}")
    if tau.shape != (R,) or tau.dtype != torch.float32 or \
            masked.shape != (R,) or masked.dtype != torch.bool:
        raise ValueError("tau must be [R] float32 and masked [R] bool")
    if quota and group > 1024:
        raise ValueError(f"quota group {group} exceeds one block")
    tensors = (x, w, tau, masked)
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("fused step operands must be contiguous and on one "
                         "device")
    dev = x.device
    ntiles = -(-V // _VT)
    part_m = torch.empty((ntiles, R), dtype=torch.float32, device=dev)
    part_s = torch.empty((ntiles, R), dtype=torch.float32, device=dev)
    part_i = torch.empty((ntiles, R), dtype=torch.int32, device=dev)
    conf = torch.empty((R,), dtype=torch.float32, device=dev)
    tok = torch.empty((R,), dtype=torch.int32, device=dev)
    above = torch.empty((R,), dtype=torch.bool, device=dev)
    lib = build.load("fused_step", _SIGNATURES)
    err = lib.fused_step(
        x.data_ptr(), w.data_ptr(), tau.data_ptr(), masked.data_ptr(),
        part_m.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
        conf.data_ptr(), tok.data_ptr(), above.data_ptr(), R, M, V,
        int(tied), int(x.dtype == torch.bfloat16), int(quota),
        group if quota else _ROWS_FINISH,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "fused_step")
    fused_step_kernel.launches += 1
    return conf, tok, above


fused_step_kernel.launches = 0
