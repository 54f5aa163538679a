"""Fused denoising-step epilogue: the CUDA kernels' wrappers (K3, K6).

``fused_step_kernel`` is the port of the reference's
``fused_step_pallas``: the lm-head product runs tile by tile over the
vocab straight into the confidence accumulators, so the logits never
reach device memory, and the kernel emits ``(conf, tok, above)``.
``quantized_fused_step_kernel`` is the port of
``quantized_fused_step_pallas``: the same epilogue with an int8 head.
Source: ``csrc/fused_step.cu`` on ``csrc/head_wgmma.cuh``, the head body
that the bf16 K3, K6 and K5's float32 output share. A CPU tensor goes to
the plain version (``fused_step_plain``, ``quantized_fused_step_plain``);
a CUDA tensor launches the kernel or raises. The body runs on ``wgmma``
in a block shape that ``head.plan`` picks per call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.head import int8_launch, plan
from repro_torch.kernels.ref import fused_step_ref, quantized_fused_step_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_step": (ctypes.c_int, [_P] * 10 + [_I] * 10 + [_P]),
    "quantized_fused_step": (ctypes.c_int, [_P] * 12 + [_I] * 10 + [_P]),
}

_F32_VT = 128       # the f32 K3 body's vocab tile (csrc/fused_step.cu kVT)
_MAX_GRID_Y = 65535  # the vocab tiles, on grid y
_ROWS_FINISH = 8    # rows per finishing block in threshold mode (32
                    # lanes merge each row's partials)


def _check_rows(x, quota: int, group: int) -> None:
    R = x.shape[0]
    if quota and (group <= 0 or R % group):
        raise ValueError(f"quota ranking needs groups that tile R={R}, "
                         f"got group={group}")


def _plain(fn, x, tau, masked, quota: int, group: int):
    """``fn(x, tau, masked, quota)`` over [R] rows, or over [R/group,
    group] ranking groups with ``quota``; returns [R] outputs."""
    if not quota:
        return fn(x, tau, masked, 0)
    R, M = x.shape
    g = R // group
    conf, tok, above = fn(x.reshape(g, group, M), tau.reshape(g, group),
                          masked.reshape(g, group), quota)
    return conf.reshape(R), tok.reshape(R), above.reshape(R)


def _launch(entry: str, x, operands, tau, masked, V: int, width: int,
            tied: bool, quota: int, group: int, extra=()):
    """Checks the row operands, allocates ``ceil(V / width)`` partials a
    row and the outputs, and calls ``entry`` with the head ``operands``
    (pointers; None passes a null pointer) after x and the ints ``extra``
    before the stream."""
    R, M = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused step kernel takes bf16 or f32, not {x.dtype}")
    if tau.shape != (R,) or tau.dtype != torch.float32 or \
            masked.shape != (R,) or masked.dtype != torch.bool:
        raise ValueError("tau must be [R] float32 and masked [R] bool")
    if quota and group > 1024:
        raise ValueError(f"quota group {group} exceeds one block")
    tensors = [t for t in (x, *operands, tau, masked) if t is not None]
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("fused step operands must be contiguous and on one "
                         "device")
    dev = x.device
    ntiles = -(-V // width)
    if ntiles > _MAX_GRID_Y:
        raise ValueError(f"V={V} exceeds the kernel's grid")
    part_m = torch.empty((ntiles, R), dtype=torch.float32, device=dev)
    part_s = torch.empty((ntiles, R), dtype=torch.float32, device=dev)
    part_i = torch.empty((ntiles, R), dtype=torch.int32, device=dev)
    conf = torch.empty((R,), dtype=torch.float32, device=dev)
    tok = torch.empty((R,), dtype=torch.int32, device=dev)
    above = torch.empty((R,), dtype=torch.bool, device=dev)
    lib = build.load("fused_step", _SIGNATURES)
    err = getattr(lib, entry)(
        x.data_ptr(), *(None if t is None else t.data_ptr()
                        for t in operands), tau.data_ptr(),
        masked.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), conf.data_ptr(), tok.data_ptr(), above.data_ptr(),
        R, M, V, int(tied), int(x.dtype == torch.bfloat16), int(quota),
        group if quota else _ROWS_FINISH, *extra,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, entry)
    return conf, tok, above


def fused_step_plain(x: torch.Tensor, w: torch.Tensor, tau: torch.Tensor,
                     masked: torch.Tensor, *, tied: bool, quota: int = 0,
                     group: int = 0):
    """The plain version of :func:`fused_step_kernel` on any device, in
    its signature (``ref.fused_step_ref`` per ranking group)."""
    _check_rows(x, quota, group)

    def plain(x, tau, masked, quota):
        return fused_step_ref(x, w, tau, masked, tied=tied, quota=quota)
    return _plain(plain, x, tau, masked, quota, group)


def fused_step_kernel(x: torch.Tensor, w: torch.Tensor, tau: torch.Tensor,
                      masked: torch.Tensor, *, tied: bool, quota: int = 0,
                      group: int = 0):
    """x [R, M]; w [V, M] (tied) or [M, V]; tau [R] f32; masked [R] bool
    -> (conf [R] f32, tok [R] i32, above [R] bool).

    ``quota > 0`` ranks inside each group of ``group`` consecutive rows
    (one batch row's block) instead of comparing with ``tau``.
    """
    if x.device.type == "cpu":
        return fused_step_plain(x, w, tau, masked, tied=tied, quota=quota,
                                group=group)
    _check_rows(x, quota, group)
    if x.device.type != "cuda":
        raise ValueError(f"no fused step kernel for {x.device}")
    R, M = x.shape
    V = w.shape[0] if tied else w.shape[1]
    if tuple(w.shape) != ((V, M) if tied else (M, V)) or w.dtype != x.dtype:
        raise ValueError(f"head {tuple(w.shape)} {w.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype} (tied={tied})")
    if x.dtype == torch.bfloat16:
        aligned = M % 8 == 0 and x.data_ptr() % 16 == 0 and \
            w.data_ptr() % 16 == 0
        p = plan(R, V, tied, aligned)
        width, extra = p.width, (p.tile, int(p.tma))
    else:
        width, extra = _F32_VT, (0, 0)
    out = _launch("fused_step", x, (w,), tau, masked, V, width, tied, quota,
                  group, extra + (-(-V // width),))
    fused_step_kernel.launches += 1
    return out


fused_step_kernel.launches = 0


def quantized_fused_step_plain(x: torch.Tensor, q: torch.Tensor,
                               scale: torch.Tensor, tau: torch.Tensor,
                               masked: torch.Tensor, *, tied: bool,
                               quota: int = 0, group: int = 0):
    """The plain version of :func:`quantized_fused_step_kernel` on any
    device, in its signature (``ref.quantized_fused_step_ref`` per ranking
    group)."""
    _check_rows(x, quota, group)

    def plain(x, tau, masked, quota):
        return quantized_fused_step_ref(x, q, scale, tau, masked, tied=tied,
                                        quota=quota)
    return _plain(plain, x, tau, masked, quota, group)


def quantized_fused_step_kernel(x: torch.Tensor, q: torch.Tensor,
                                scale: torch.Tensor, tau: torch.Tensor,
                                masked: torch.Tensor, *, tied: bool,
                                quota: int = 0, group: int = 0):
    """x [R, M] bf16 or f32; q int8 [V, M] (tied) or [M, V]; scale f32
    with V elements (one per vocab channel); tau [R] f32; masked [R] bool
    -> (conf [R] f32, tok [R] i32, above [R] bool), as
    :func:`fused_step_kernel` with the head ``f32(q) * scale``. f32 x runs
    as three bf16 terms (a split into scratch first).
    """
    if x.device.type == "cpu":
        return quantized_fused_step_plain(x, q, scale, tau, masked,
                                          tied=tied, quota=quota, group=group)
    _check_rows(x, quota, group)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 fused step kernel for {x.device}")
    if q.ndim != 2 or q.dtype != torch.int8:
        raise ValueError(f"int8 head must be a 2-d int8 tensor, not "
                         f"{tuple(q.shape)} {q.dtype}")
    R, M = x.shape
    V = q.shape[0] if tied else q.shape[1]
    if tuple(q.shape) != ((V, M) if tied else (M, V)):
        raise ValueError(f"int8 head {tuple(q.shape)} {q.dtype} does not "
                         f"match x {tuple(x.shape)} (tied={tied})")
    if scale.numel() != V or scale.dtype != torch.float32:
        raise ValueError(f"scale {tuple(scale.shape)} {scale.dtype} is not "
                         f"{V} float32 values")
    terms, p = int8_launch(x, q, V, tied)
    out = _launch("quantized_fused_step", x, (q, scale, terms), tau, masked,
                  V, p.width, tied, quota, group,
                  (p.tile, int(p.tma), -(-V // p.width)))
    quantized_fused_step_kernel.launches += 1
    return out


quantized_fused_step_kernel.launches = 0
