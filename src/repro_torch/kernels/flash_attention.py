"""Flash attention, forward: the CUDA kernel's wrapper (K7).

``flash_attention_kernel`` is the port of the reference's
``flash_attention_pallas``: online-softmax attention over key tiles, the
scores never reaching device memory. Source: ``csrc/flash_attention.cu``
(bf16 on the tensor cores, float32 on CUDA-core FMAs). A CPU tensor goes
to the plain version (``ref.flash_attention_ref``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention": (ctypes.c_int, [_P] * 4 + [_I] * 7 + [_P]),
}

_BF16_HEAD_DIMS = (16, 32, 64, 128)  # csrc/flash_attention.cu's bf16 widths
_MAX_F32_HEAD_DIM = 128              # kFMaxD
_Q_TILE = {torch.bfloat16: 128, torch.float32: 16}  # kQT, kFQ


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q [B,H,S,D], k/v [B,H,T,D] -> [B,H,S,D] in q's dtype.

    ``causal`` keeps key ``t`` for query ``s`` where ``t <= s +
    q_offset`` (absolute positions: ``q_offset = T - S`` for a suffix of
    queries).
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for {q.device}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash attention takes q [B,H,S,D] and k/v "
                         f"[B,H,T,D], not {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    T = k.shape[2]
    if q.dtype not in _Q_TILE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes bf16 or f32 operands of one "
                         f"dtype, not {q.dtype}, {k.dtype}, {v.dtype}")
    bf16 = q.dtype == torch.bfloat16
    if (bf16 and D not in _BF16_HEAD_DIMS) or not 0 < D <= _MAX_F32_HEAD_DIM:
        raise ValueError(f"no {q.dtype} flash attention kernel for head "
                         f"dim {D}")
    if T == 0:
        raise ValueError("flash attention needs at least one key")
    tensors = (q, k, v)
    if any(t.device != q.device or not t.is_contiguous()
           or t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash attention operands must be contiguous, "
                         "16-byte aligned and on one device")
    out = torch.empty_like(q)
    blocks = B * H * -(-S // _Q_TILE[q.dtype])
    if blocks >= 2 ** 31:
        raise ValueError(f"{blocks} blocks exceed the kernel's grid")
    if blocks == 0:
        return out
    lib = build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S,
        T, D, int(causal), int(q_offset), int(bf16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
