"""The port's ``ops.flash_attention`` and the plain version of its flash
attention kernel (K7) against the JAX reference: its oracle
(``ref.attention_ref``), its off-TPU ``ops.flash_attention`` and its
Pallas kernel in interpret mode, on the same numpy inputs, over the
shapes of the reference's own kernel sweep. float32 within 2e-5. In
bf16 the port and the reference's oracle do the same float32 arithmetic
and round once, so they are held within one bf16 step, with at most 0.1%
of the elements differing (measured: 0.033%); the Pallas kernel, whose
arithmetic differs, within the sweep's 3e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_kernel

# (B, H, S, T, D), the shapes tests/test_kernels.py sweeps the kernel at
SHAPES = [
    (1, 2, 64, 64, 32),
    (2, 1, 48, 96, 64),
    (1, 1, 33, 65, 16),
    (1, 2, 128, 128, 64),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(seed, B, H, S, T, D, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, S, D), (B, H, T, D), (B, H, T, D))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tx = [torch.tensor(a).to(tdt) for a in arrs]
    return jx, tx


def _close(j, t, tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), rtol=tol, atol=tol)


def _within_step(j, t, differ=1e-3):
    """Elementwise within one bf16 step (2^-7 of the value's power of
    two), and at most a fraction ``differ`` of the elements not equal."""
    a, b = np.asarray(j, np.float32), t.float().numpy()
    mag = np.maximum(np.abs(a), np.abs(b))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert bool((np.abs(a - b) <= step).all()), (np.abs(a - b) / step).max()
    assert (a != b).mean() <= differ, (a != b).mean()


@pytest.mark.parametrize("B,H,S,T,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_reference(B, H, S, T, D, causal, dtype):
    """``ops.flash_attention`` and ``attention_ref`` against the
    reference's oracle, its ``ops.flash_attention`` (the oracle off the
    TPU) and its Pallas kernel run with ``q_offset = T - S``; causal with
    S < T is bottom-right aligned."""
    tol = TOL[dtype]
    jx, tx = _inputs(S * 7 + T + D, B, H, S, T, D, dtype)
    port = tops.flash_attention(*tx, causal=causal)
    assert port.dtype == tx[0].dtype and port.shape == (B, H, S, D)
    plain = tref.attention_ref(*tx, causal=causal)
    assert torch.equal(port, plain)
    for oracle in (jref.attention_ref, jops.flash_attention):
        if dtype == "bfloat16":
            _within_step(oracle(*jx, causal=causal), port)
        else:
            _close(oracle(*jx, causal=causal), port, tol)
    pallas = flash_attention_pallas(*jx, causal=causal, q_offset=T - S,
                                    q_tile=32, kv_tile=32, interpret=True)
    _close(pallas, port, tol)


def test_flash_attention_plain_q_offset():
    """The kernel's plain version masks by absolute position: query s
    keeps key t where t <= s + q_offset. ``q_offset = T - S`` is the
    oracle's bottom-right mask; a query that sees no key (negative
    offset) averages every key, as the oracle's softmax of tied -1e30
    scores does."""
    _, (q, k, v) = _inputs(3, 1, 2, 5, 9, 8, "float32")
    for off in (4, 0, -2):
        got = flash_attention_kernel(q, k, v, causal=True, q_offset=off)
        s = torch.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(8)
        keep = torch.arange(9)[None] <= torch.arange(5)[:, None] + off
        want = torch.softmax(torch.where(keep, s, -1e30), -1) @ v
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(flash_attention_kernel(q, k, v, causal=True,
                                              q_offset=4),
                       tref.attention_ref(q, k, v, causal=True))
    blind = flash_attention_kernel(q, k, v, causal=True, q_offset=-2)
    torch.testing.assert_close(blind[:, :, 0], v.mean(2), rtol=0, atol=1e-6)


def test_flash_attention_kernel_refuses_other_devices():
    meta = [torch.empty((1, 1, 4, 8), device="meta") for _ in range(3)]
    with pytest.raises(ValueError):
        flash_attention_kernel(*meta, causal=False)
