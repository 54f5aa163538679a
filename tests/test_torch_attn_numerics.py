"""Why the bf16 block attention body carries P as two bf16 terms.

The kernel (``csrc/block_attention.cu``, K1/K4) is held to
``ref.cached_block_attention_ref``, which keeps the probabilities P in
float32, within one bf16 step of the output plus 1e-4 (``bf16_close`` in
``chip_smoke.py``). Its P V product runs on bf16 tensor cores. This test
emulates that product on the CPU at the main path's shape (8,192 query
rows: batch 8 x 32 heads x block 32; 224 live keys; head width 128;
random bf16 q/k/v, one key set for every row):
P rounded once to bf16 misses the bound on some outputs (those near 0,
where the bound is 1e-4), P split into two bf16 terms keeps it.
"""
import numpy as np
import pytest
import torch

ROWS, KEYS, D = 8192, 224, 128


def _emulate(terms: int):
    """(kernel-like out, oracle out), both rounded to bf16: the kernel's
    unnormalised p = exp(s - max) as ``terms`` bf16 terms through a
    float32 product with bf16 V, divided by the float32 sum at the end."""
    g = np.random.default_rng(0)

    def r(*shape):
        return torch.tensor(g.standard_normal(shape),
                            dtype=torch.float32).bfloat16().float()

    q, k, v = r(ROWS, D), r(KEYS, D), r(KEYS, D)
    s = q @ k.t() * D ** -0.5
    want = (torch.softmax(s, dim=-1) @ v).bfloat16().float()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    rest, acc = p, torch.zeros_like(want)
    for _ in range(terms):
        term = rest.bfloat16().float()
        acc += term @ v
        rest = rest - term
    out = (acc / p.sum(dim=-1, keepdim=True)).bfloat16().float()
    return out, want


@pytest.mark.parametrize("terms,holds", [(1, False), (2, True)])
def test_p_terms_against_the_bf16_bound(terms, holds):
    out, want = _emulate(terms)
    err = (out - want).abs()
    miss = float((err > want.abs() * 2 ** -7 + 1e-4).float().mean())
    assert (miss == 0.0) is holds, miss
    if not holds:
        assert miss > 0.01  # not a stray element: a share of the outputs
