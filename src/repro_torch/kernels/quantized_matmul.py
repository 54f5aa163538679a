"""Int8 weight-streaming matmul: the CUDA kernel's wrapper (K5).

``quantized_matmul_kernel`` is the port of the reference's
``quantized_matmul_pallas``: ``x @ dequant(q, scale)`` with the int8
weight dequantized per output channel before the product, in either
layout (``[K, N]``, or ``[N, K]`` with ``transpose=True`` for the tied
unembed). Source: ``csrc/quantized_matmul.cu``: a bf16 output on its own
``wgmma`` body; a float32 output (the lm head's logits, from bf16 or
float32 activations) on the head body it shares with the int8-head fused
step (``csrc/head_wgmma.cuh``). A CPU tensor goes to the plain version
(``ref.quantized_matmul_ref``); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.head import int8_launch
from repro_torch.kernels.ref import quantized_matmul_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "quantized_matmul": (ctypes.c_int, [_P] * 5 + [_I] * 8 + [_P]),
}

# the bf16 kernel's block shapes (csrc/quantized_matmul.cu launch_tile):
# (rows, columns, blocks an SM by shared memory)
_TILES = ((256, 128, 1), (128, 64, 2), (64, 64, 3))
_FILL = 0.7          # a block shape must keep this share of the SMs busy
_MAX_GRID_Y = 65535  # the row tiles (bf16) or column tiles (f32) on grid y
_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
           (torch.float32, torch.float32))  # (x, out) the kernel takes
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
                            scale: torch.Tensor, *, transpose: bool,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """x [R, K] bf16 or float32; q int8 [K, N] (or [N, K] with
    ``transpose``); scale float32 with N elements -> [R, N] in
    ``out_dtype`` (default x's dtype). ``out_dtype=torch.float32`` with
    bf16 x is the lm head: the float32 product of the widened activations
    (one bf16 term on the card, where f32 x takes three).
    """
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if (x.dtype, out_dtype) not in _DTYPES:
        raise ValueError(f"int8 matmul takes (x, out) dtypes {_DTYPES}, not "
                         f"({x.dtype}, {out_dtype})")
    if x.device.type == "cpu":
        return quantized_matmul_ref(x, q, scale, transpose=transpose,
                                    out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 matmul kernel for {x.device}")
    if x.ndim != 2 or q.ndim != 2 or q.dtype != torch.int8:
        raise ValueError(f"int8 matmul takes x [R, K] and int8 q, not "
                         f"{tuple(x.shape)} and {tuple(q.shape)} {q.dtype}")
    R, K = x.shape
    N, Kq = q.shape if transpose else q.shape[::-1]
    if Kq != K or scale.numel() != N or scale.dtype != torch.float32:
        raise ValueError(f"q {tuple(q.shape)} and scale {tuple(scale.shape)} "
                         f"do not match x {tuple(x.shape)} "
                         f"(transpose={transpose})")
    tensors = (x, q, scale)
    if any(t.device != x.device or not t.is_contiguous() for t in tensors):
        raise ValueError("int8 matmul operands must be contiguous and on one "
                         "device")
    f32_out = out_dtype == torch.float32
    if f32_out:
        terms, p = int8_launch(x, q, N, transpose)
        tile, tma, grid_y = p.tile, p.tma, -(-N // p.width)
    else:
        if x.device not in _SMS:
            _SMS[x.device] = torch.cuda.get_device_properties(
                x.device).multi_processor_count
        terms, tma = None, False
        tile, grid_y = plan(R, N, _SMS[x.device]), -(-R // 64)
    if grid_y > _MAX_GRID_Y:
        raise ValueError(f"[{R}, {N}] exceeds the kernel's grid")
    out = torch.empty((R, N), dtype=out_dtype, device=x.device)
    if R == 0 or N == 0:
        return out
    lib = build.load("quantized_matmul", _SIGNATURES)
    err = lib.quantized_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if terms is None else terms.data_ptr(), R, K, N, int(transpose),
        int(x.dtype == torch.bfloat16), int(f32_out), tile, int(tma),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quantized_matmul")
    quantized_matmul_kernel.launches += 1
    if f32_out:
        quantized_matmul_kernel.head_launches += 1
    return out


quantized_matmul_kernel.launches = 0
quantized_matmul_kernel.head_launches = 0  # of them, float32 outputs
