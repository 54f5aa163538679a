"""The int8 matmul kernel's (K5's) order of sums against its bound.

The bf16 kernel (``csrc/quantized_matmul.cu``) is held to
``ref.quantized_matmul_ref`` within one bf16 step of the output plus 1e-4
(``bf16_close`` in ``chip_smoke.py``). Each of its blocks runs the whole
K loop: the weight dequantized as bf16(f32(q) * scale), the products
summed in f32 a 16-deep tensor-core step at a time, in order, the sum
rounded once to bf16. This test emulates that order on the CPU at
LLaDA-8B's contraction depths (K = 4096 and 12288; 16 rows, 256
columns) and shows it within the bound. It also shows why the kernel
does not split K: four splits whose f32 partials are added in a fixed
order stay within the bound too, but give other bits than one K loop on
some outputs (on the card, where one K loop gives cuBLAS's bits on the
dequantized weight, that difference is enough for the int8 decode on
random weights to part from its dequantized-weights twin). Rounding
each split's partial to bf16 before adding them, a fault far too small
for the teacher-forced replay of ``chip_smoke.py`` to see, misses the
bound. The port's plain version itself is held to the reference's
oracle in ``tests/test_torch_quantized.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.quantized_matmul import plan
from repro_torch.models.quantize import quantize_tensor

ROWS, COLS = 16, 256


def _inputs(K: int, rows: int = ROWS):
    g = np.random.default_rng(K)
    x = torch.tensor(g.standard_normal((rows, K)),
                     dtype=torch.float32).bfloat16()
    w = torch.tensor(g.standard_normal((K, COLS)),
                     dtype=torch.float32) * K ** -0.5
    return x, quantize_tensor(w, axis=-2)


def _kernel_order(x, qt, splits: int = 1, round_partials: bool = False):
    """bf16 of the f32 sum of the 16-deep steps in order, the weight
    dequantized as bf16(f32(q) * scale); with ``splits`` > 1 the K loop
    is cut into that many runs of whole 64-deep stages, whose f32 sums
    are added in order (each rounded to bf16 first with
    ``round_partials``)."""
    w = (qt.q.float() * qt.scale).bfloat16().float()
    xf = x.float()
    K = x.shape[1]
    per = -(-(-(-K // 64)) // splits) * 64  # K of one split, whole stages
    out = torch.zeros(x.shape[0], COLS)
    for z in range(splits):
        part = torch.zeros(x.shape[0], COLS)
        for k0 in range(z * per, min(K, (z + 1) * per), 16):
            part += xf[:, k0:k0 + 16] @ w[k0:k0 + 16]
        out += part.bfloat16().float() if round_partials else part
    return out.bfloat16()


def _misses(out, want) -> float:
    """Share of outputs beyond |out - want| <= 2^-7 |want| + 1e-4."""
    err = (out.float() - want.float()).abs()
    return float((err > want.float().abs() * 2 ** -7 + 1e-4).float().mean())


@pytest.mark.parametrize("K", [4096, 12288])
@pytest.mark.parametrize("splits", [1, 4])
def test_order_within_the_bf16_bound(K, splits):
    x, qt = _inputs(K)
    want = ref.quantized_matmul_ref(x, qt.q, qt.scale, transpose=False)
    assert _misses(_kernel_order(x, qt, splits), want) == 0.0


@pytest.mark.parametrize("K", [4096, 12288])
def test_split_partials_give_other_bits(K):
    """Four K splits added in order round some outputs otherwise than one
    K loop does (here some of 256 x 256)."""
    x, qt = _inputs(K, rows=256)
    assert not torch.equal(_kernel_order(x, qt, 4), _kernel_order(x, qt))


def test_bf16_partials_miss_the_bound():
    x, qt = _inputs(4096)
    want = ref.quantized_matmul_ref(x, qt.q, qt.scale, transpose=False)
    assert _misses(_kernel_order(x, qt, 4, round_partials=True), want) > 0


@pytest.mark.parametrize("R,N,tile", [
    (256, 4096, 1),    # 32 blocks of 256 x 128 would idle 3/4 of the SMs
    (256, 12288, 0),   # 96 of them keep 73% busy
    (1024, 4096, 0),   # the prefill fills the card with the largest
    (1024, 12288, 0),
    (128, 4096, 2),    # 64 x 64: the only shape with 128 blocks
    (32, 4096, 2),     # none fills it: the most blocks, the fewest rows
    (1, 128, 2),
])
def test_plan_block_shape(R, N, tile):
    """The wrapper's block shape on a 132-SM H100: the largest whose
    blocks keep 70% of the SMs busy, else the most blocks."""
    assert plan(R, N, 132) == tile
