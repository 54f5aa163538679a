"""Int8 weight-streaming matmul: the CUDA kernel's wrapper (K5).

``quantized_matmul_kernel`` is the port of the reference's
``quantized_matmul_pallas``: ``x @ dequant(q, scale)`` with the int8
weight dequantized per output channel before the product, in either
layout (``[K, N]``, or ``[N, K]`` with ``transpose=True`` for the tied
unembed). Source: ``csrc/quantized_matmul.cu`` (bf16 activations on
``wgmma``, float32 activations on CUDA-core FMAs). A CPU tensor goes to
the plain version (``ref.quantized_matmul_ref``); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import quantized_matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "quantized_matmul": (ctypes.c_int, [_P] * 4 + [_I] * 6 + [_P]),
}

# the bf16 kernel's block shapes (csrc/quantized_matmul.cu launch_tile):
# (rows, columns, blocks an SM by shared memory)
_TILES = ((256, 128, 1), (128, 64, 2), (64, 64, 3))
_FILL = 0.7          # a block shape must keep this share of the SMs busy
_F32_BN = 128        # the float32 kernel's column tile (qmm_f32.cuh kFN)
_MAX_GRID_Y = 65535  # the row tiles (bf16) or column tiles (f32) on grid y
_SMS = {}


def plan(R: int, N: int, sms: int) -> int:
    """The bf16 kernel's block shape for R rows and N columns on a card
    with ``sms`` SMs: the largest of ``_TILES`` whose blocks keep at least
    ``_FILL`` of the SMs busy, else the one with the most blocks (of those,
    the fewest rows: the least padding for a short R). Every
    shape runs the whole K loop in one block, so the sums are those of
    one K loop whatever the shape."""
    blocks = [-(-R // rows) * -(-N // cols) for rows, cols, _ in _TILES]
    for i, b in enumerate(blocks):
        if b >= _FILL * sms:
            return i
    return max(range(len(_TILES)), key=lambda i: (blocks[i], -_TILES[i][0]))


def quantized_matmul_kernel(x: torch.Tensor, q: torch.Tensor,
                            scale: torch.Tensor, *,
                            transpose: bool) -> torch.Tensor:
    """x [R, K] bf16 or float32; q int8 [K, N] (or [N, K] with
    ``transpose``); scale float32 with N elements -> [R, N] in x's dtype.
    """
    if x.device.type == "cpu":
        return quantized_matmul_ref(x, q, scale, transpose=transpose)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul kernel for {x.device}")
    if x.ndim != 2 or q.ndim != 2 or q.dtype != torch.int8:
        raise ValueError(f"int8 matmul takes x [R, K] and int8 q, not "
                         f"{tuple(x.shape)} and {tuple(q.shape)} {q.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8 matmul takes bf16 or f32 x, not {x.dtype}")
    R, K = x.shape
    N, Kq = q.shape if transpose else q.shape[::-1]
    if Kq != K or scale.numel() != N or scale.dtype != torch.float32:
        raise ValueError(f"q {tuple(q.shape)} and scale {tuple(scale.shape)} "
                         f"do not match x {tuple(x.shape)} "
                         f"(transpose={transpose})")
    bf16 = x.dtype == torch.bfloat16
    if (-(-R // 64) if bf16 else -(-N // _F32_BN)) > _MAX_GRID_Y:
        raise ValueError(f"[{R}, {N}] exceeds the kernel's grid")
    tensors = (x, q, scale)
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("int8 matmul operands must be contiguous and on one "
                         "device")
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if R == 0 or N == 0:
        return out
    tile = 0
    if bf16:
        if x.device not in _SMS:
            _SMS[x.device] = torch.cuda.get_device_properties(
                x.device).multi_processor_count
        tile = plan(R, N, _SMS[x.device])
    lib = build.load("quantized_matmul", _SIGNATURES)
    err = lib.quantized_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), R, K,
        N, int(transpose), int(bf16), tile,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quantized_matmul")
    quantized_matmul_kernel.launches += 1
    return out


quantized_matmul_kernel.launches = 0
