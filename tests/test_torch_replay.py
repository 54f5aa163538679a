"""The teacher-forced replay of ``chip_smoke.py`` on the CPU.

The replay judges the block attention kernel on the main path: one OSDT
decode is driven by the plain attention (``attn_impl="dense"``), and at
every block-step forward the kernel path (``attn_impl="kernel"``, gated)
and the plain chunked attention (``attn_impl="flash"``, printed only) run
on the same inputs and cache; each one's (conf, argmax) is compared with
the driving forward's. Here, on a reduced LLaDA-8B in float32, the kernel
path's wrapper takes its plain version (``ref.cached_block_attention_ref``),
which is bitwise the dense path's attention: the replay must report zero
difference. A perturbed attention output, and each emulated kernel fault
that the card check also runs, must be reported and must fail the gate.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.config.base import DecodeConfig
from repro_torch.config.registry import get_config
from repro_torch.core.decoder import make_generate_fn
from repro_torch.core.osdt import OSDTSession
from repro_torch.data import tokenizer as tok
from repro_torch.kernels import ops as kops
from repro_torch.models import model as M

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
    / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)
_BLOCK_STEP = M.block_step


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(
        get_config("llada-8b").reduced(num_layers=2, max_d_model=128,
                                       vocab_size=tok.VOCAB),
        mask_token_id=tok.MASK_ID)
    dcfg = DecodeConfig(max_new_tokens=32, block_size=8, policy="osdt",
                        cap=0.75, slack=0.2, step_fusion="fused")
    params = M.init_params(cfg, seed=0, device="cpu")
    prompts = np.random.default_rng(0).integers(0, 256, (4, 16))
    calib = OSDTSession(params, cfg, dcfg, tok.MASK_ID,
                        gen_fn=make_generate_fn(cfg, dcfg,
                                                attn_impl="kernel"))
    calib.generate(prompts[:1])
    return cfg, dcfg, params, prompts, calib.store


def _replay(setup, fusion):
    """The calibrated Phase 2 driven by the plain attention, the kernel
    path checked at every block step; returns (result, replay rows)."""
    cfg, dcfg, params, prompts, store = setup
    dc = dataclasses.replace(dcfg, step_fusion=fusion)
    return cs.replay_rows(params, cfg, dc, store, prompts)


@pytest.mark.parametrize("fusion", ["fused", "unfused"])
def test_replay_reports_zero_difference(setup, fusion):
    """Both paths take the same plain attention on the CPU: every forward
    (denoising steps and commits) compares equal, and the decode is the
    one the plain path gives without the replay."""
    res, rows = _replay(setup, fusion)
    assert {r["kind"] for r in rows} == {"step", "commit"}
    # one row per block-step forward: every forward but the prefill
    assert len(rows) == res.nfe - 1
    assert all(r["kernel"]["max_dconf"] == 0.0
               and r["kernel"]["agree"] == 1.0 for r in rows)
    # float32 in another order: within float32 rounding, same tokens
    assert all(r["flash"]["share"] < 1e-4 and r["flash"]["agree"] == 1.0
               for r in rows)
    assert cs.replay_ok(rows)
    cfg, dcfg, params, prompts, store = setup
    dc = dataclasses.replace(dcfg, step_fusion=fusion)
    plain = OSDTSession(params, cfg, dc, tok.MASK_ID, store=store,
                        gen_fn=make_generate_fn(cfg, dc, attn_impl="dense"))
    want = plain.generate(prompts)
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe
    assert M.block_step is _BLOCK_STEP  # the replay restores it


def test_replay_flags_a_perturbed_attention(setup, monkeypatch):
    """A kernel path whose attention output is off by a factor of 2 is
    reported at every denoising step and fails the gate; the plain path
    still drives, so the decode is unchanged."""
    orig = kops.cached_block_attention_kernel
    monkeypatch.setattr(kops, "cached_block_attention_kernel",
                        lambda *a, **k: orig(*a, **k) * 2.0)
    res, rows = _replay(setup, "fused")
    steps = [r for r in rows if r["kind"] == "step"]
    assert steps and all(r["kernel"]["max_dconf"] > 0.0 for r in steps)
    assert not cs.replay_ok(rows)
    assert max(r["kernel"]["share"] for r in rows) > cs.REPLAY_CONF_SHARE
    # the plain chunked attention is untouched: far inside the bars
    assert max(r["flash"]["share"] for r in rows) < 1e-4


def test_replay_compare_reads_masked_positions():
    """Differences at unmasked positions do not count; with no masked
    position every position counts; the hidden path unembeds first."""
    g = np.random.default_rng(1)
    logits = torch.tensor(g.standard_normal((2, 4, 50)), dtype=torch.float32)
    masked = torch.tensor([[True, False, True, False]] * 2)
    alt = logits.clone()
    alt[:, 1] += torch.linspace(0, 5, 50)  # unmasked position 1 only
    r = cs.replay_compare(logits, alt, masked)
    assert r == dict(max_dconf=0.0, share=0.0, agree=1.0, n=4)
    r = cs.replay_compare(logits, alt, torch.zeros_like(masked))
    assert r["n"] == 8 and r["max_dconf"] > 0 and r["agree"] == 0.75
    head = torch.tensor(g.standard_normal((16, 50)), dtype=torch.float32)
    x = torch.tensor(g.standard_normal((2, 4, 16)), dtype=torch.float32)
    r = cs.replay_compare(x, x + 0.5 * masked[..., None], masked, head=head)
    want = cs.replay_compare(x @ head, (x + 0.5 * masked[..., None]) @ head,
                             masked)
    assert r == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(cs.REPLAY_FAULTS))
def test_replay_rejects_emulated_faults(setup, monkeypatch, name):
    """Each kernel fault that the card check emulates (a softmax scale 10%
    high, the fresh block hidden, the last live slot dropped) moves the
    kernel path past the bars here too, and the plain path still drives."""
    monkeypatch.setattr(kops, "cached_block_attention_kernel",
                        cs.REPLAY_FAULTS[name](
                            kops.cached_block_attention_kernel))
    res, rows = _replay(setup, "fused")
    assert not cs.replay_ok(rows)
    monkeypatch.undo()
    want, _ = _replay(setup, "fused")
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe


_S, _A = cs.REPLAY_CONF_SHARE, cs.REPLAY_ARGMAX_AGREE


@pytest.mark.parametrize("kernel,flash,ok", [
    ([(0.0, 1.0, 100)], [(0.0, 1.0, 100)], True),
    ([(_S, _A, 100)], [(0.0, 1.0, 100)], True),
    ([(_S * 1.01, 1.0, 100)], [(0.0, 1.0, 100)], False),
    ([(0.0, _A - 0.01, 100)], [(0.0, 1.0, 100)], False),
    # one forward past the share bar fails, however many others hold
    ([(0.0, 1.0, 100)] * 9 + [(0.06, 1.0, 100)], [(0.0, 1.0, 100)] * 10,
     False),
    # argmax agreement is pooled over positions: 0.9 on 10 and 1.0 on 190
    ([(0.0, 0.9, 10), (0.0, 1.0, 190)], [(0.0, 1.0, 10)] * 2, True),
    ([(0.0, 0.9, 190), (0.0, 1.0, 10)], [(0.0, 1.0, 10)] * 2, False),
    # the printed reference does not move the bars
    ([(0.08, 0.9, 100)], [(0.5, 0.5, 100)], False),
])
def test_replay_gate(kernel, flash, ok):
    """Every forward's conf share is held to the bar, and the argmax
    agreement pooled over all compared positions to its bar; the plain
    chunked attention's rows are not read; an empty replay fails."""
    rows = [{impl: dict(share=share, agree=agree, n=n)
             for impl, (share, agree, n) in (("kernel", k), ("flash", f))}
            for k, f in zip(kernel, flash)]
    assert cs.replay_ok(rows) is ok
    assert not cs.replay_ok([])


# ---------------------------------------------------------------------------
# the int8 replay: K5 against the plain int8 matmul
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_setup(setup):
    """The reduced model's weights quantized, the unfused int8 decode and
    its calibrated store."""
    from repro_torch.models.quantize import quantize_decode_params

    cfg, dcfg, params, prompts, _ = setup
    qparams = quantize_decode_params(params, cfg)
    qdcfg = dataclasses.replace(dcfg, step_fusion="unfused",
                                weight_dtype="int8")
    calib = OSDTSession(qparams, cfg, qdcfg, tok.MASK_ID,
                        gen_fn=make_generate_fn(cfg, qdcfg,
                                                attn_impl="kernel"))
    calib.generate(prompts[:1])
    return cfg, qdcfg, qparams, prompts, calib.store


def test_int8_replay_reports_zero_difference(int8_setup):
    """On the CPU the int8 matmul's wrapper takes the plain version, which
    the replay also drives with: every forward compares equal, the decode
    is the plain int8 decode, and the wrapper is restored."""
    from repro_torch.kernels.quantized_matmul import \
        quantized_matmul_kernel as k5

    cfg, qdcfg, qparams, prompts, store = int8_setup
    res, rows = cs.int8_replay_rows(qparams, cfg, qdcfg, store, prompts, k5)
    assert len(rows) == res.nfe - 1
    assert {r["kind"] for r in rows} == {"step", "commit"}
    assert all(r["kernel"]["max_dconf"] == 0.0
               and r["kernel"]["agree"] == 1.0 for r in rows)
    assert cs.replay_ok(rows)
    assert kops.quantized_matmul_kernel is k5
    plain = OSDTSession(qparams, cfg, qdcfg, tok.MASK_ID, store=store,
                        gen_fn=make_generate_fn(cfg, qdcfg,
                                                attn_impl="kernel"))
    want = plain.generate(prompts)
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe


@pytest.mark.parametrize("name", sorted(cs.K5_REPLAY_FAULTS))
def test_int8_replay_rejects_emulated_k5_faults(int8_setup, name):
    """Each K5 fault that the card check emulates (a neighbour's scale,
    the contraction's last 1/16 dropped, one K stage counted twice) moves
    the checked path past the bars, while the plain int8 matmul still
    drives the same decode."""
    from repro_torch.kernels.quantized_matmul import \
        quantized_matmul_kernel as k5

    cfg, qdcfg, qparams, prompts, store = int8_setup
    res, rows = cs.int8_replay_rows(qparams, cfg, qdcfg, store, prompts,
                                    cs.K5_REPLAY_FAULTS[name](k5))
    assert not cs.replay_ok(rows)
    want, _ = cs.int8_replay_rows(qparams, cfg, qdcfg, store, prompts, k5)
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe


def test_int8_replay_stops_after_forwards(int8_setup):
    """With a forward limit the replay ends the decode there: its rows are
    the first rows of the whole replay, there is no result, and the
    model's ``block_step`` and the int8 matmul are restored."""
    from repro_torch.kernels.quantized_matmul import \
        quantized_matmul_kernel as k5

    cfg, qdcfg, qparams, prompts, store = int8_setup
    fault = cs.K5_REPLAY_FAULTS["one_stage_twice"](k5)
    _, whole = cs.int8_replay_rows(qparams, cfg, qdcfg, store, prompts, fault)
    res, rows = cs.int8_replay_rows(qparams, cfg, qdcfg, store, prompts,
                                    fault, forwards=3)
    assert res is None and len(whole) > 3
    assert rows == whole[:3]
    assert M.block_step is _BLOCK_STEP and kops.quantized_matmul_kernel is k5


@pytest.mark.parametrize("name", sorted(cs.K5_REPLAY_FAULTS))
def test_int8_replay_rejects_k5_faults_in_first_forwards(int8_setup, name):
    """The card check runs each K5 fault's replay over the decode's first
    ``K5_FAULT_FORWARDS`` forwards only: that many already fail the
    gate."""
    from repro_torch.kernels.quantized_matmul import \
        quantized_matmul_kernel as k5

    cfg, qdcfg, qparams, prompts, store = int8_setup
    _, rows = cs.int8_replay_rows(qparams, cfg, qdcfg, store, prompts,
                                  cs.K5_REPLAY_FAULTS[name](k5),
                                  forwards=cs.K5_FAULT_FORWARDS)
    assert len(rows) == cs.K5_FAULT_FORWARDS
    assert not cs.replay_ok(rows)


# ---------------------------------------------------------------------------
# the K3 replay: the fused step kernel against the plain fused step
# ---------------------------------------------------------------------------

def test_k3_replay_reports_zero_difference(setup):
    """On the CPU K3's wrapper takes the plain fused step, which the replay
    also drives with: one row per denoising forward, each equal, the
    decode is the plain fused decode, and the wrapper is restored."""
    from repro_torch.kernels.fused_step import fused_step_kernel as k3

    cfg, dcfg, params, prompts, store = setup
    res, rows = cs.k3_replay_rows(params, cfg, dcfg, store, prompts, k3)
    assert rows and {r["kind"] for r in rows} == {"step"}
    assert all(r["kernel"]["max_dconf"] == 0.0 and r["kernel"]["agree"] == 1.0
               and r["kernel"]["above_mismatch"] == 0 for r in rows)
    assert cs.replay_ok(rows)
    assert kops.fused_step_kernel is k3
    plain = OSDTSession(params, cfg, dcfg, tok.MASK_ID, store=store,
                        gen_fn=make_generate_fn(cfg, dcfg,
                                                attn_impl="kernel"))
    want = plain.generate(prompts)
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe


@pytest.mark.parametrize("name", sorted(cs.K3_REPLAY_FAULTS))
def test_k3_replay_rejects_emulated_faults(setup, name):
    """Each K3 fault that the card check emulates (logits 10% high, the
    contraction's last 1/16 dropped, the upper half of the vocabulary
    hidden) moves the checked fused step past the bars, while the plain
    fused step still drives the same decode."""
    from repro_torch.kernels.fused_step import fused_step_kernel as k3

    cfg, dcfg, params, prompts, store = setup
    res, rows = cs.k3_replay_rows(params, cfg, dcfg, store, prompts,
                                  cs.K3_REPLAY_FAULTS[name](k3))
    assert not cs.replay_ok(rows)
    want, _ = cs.k3_replay_rows(params, cfg, dcfg, store, prompts, k3)
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe


def test_k3_compare_reads_masked_positions():
    """conf and argmax are read over the masked positions (every position
    when none is masked); ``above`` over the positions whose conf is
    1e-3 relative away from tau, or every position without tau."""
    conf = torch.tensor([0.5, 0.2, 0.4, 0.1])
    tok = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    tau = torch.tensor([0.3, 0.2, 0.4002, 0.05])
    masked = torch.tensor([True, False, True, True])
    above = masked & (conf > tau)
    got_conf = conf.clone()
    got_conf[1] = 0.9                      # unmasked: not read
    got_conf[2] = 0.4005                   # masked, crosses tau (near)
    got_tok = tok.clone()
    got_tok[3] = 7
    got = (got_conf, got_tok, masked & (got_conf > tau))
    r = cs.k3_compare((conf, tok, above), got, masked, tau)
    # float32 differences: within a float32 step of 0.4
    assert r["max_dconf"] == pytest.approx(0.0005, rel=1e-3)
    assert r["share"] == pytest.approx(0.0005 / 0.5, rel=1e-3)
    assert r["agree"] == pytest.approx(2 / 3) and r["n"] == 3
    # position 2 flips `above` but sits within 1e-3 of tau; position 1
    # (conf == tau) is near too
    assert r["above_mismatch"] == 0 and r["above_far"] == 2
    r = cs.k3_compare((conf, tok, above), got, masked, None)
    assert r["above_mismatch"] == 1 and r["above_far"] == 4
    r = cs.k3_compare((conf, tok, above), got, torch.zeros_like(masked), tau)
    assert r["n"] == 4 and r["max_dconf"] == pytest.approx(0.7, rel=1e-6)


# ---------------------------------------------------------------------------
# the K6 replay: the int8-head fused step kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k6_setup(int8_setup):
    """The int8 setup with the fused epilogue (K6 in each denoising
    forward) and the unfused int8 session's calibrated store."""
    cfg, qdcfg, qparams, prompts, store = int8_setup
    return cfg, dataclasses.replace(qdcfg, step_fusion="fused"), qparams, \
        prompts, store


def test_k6_replay_reports_zero_difference(k6_setup):
    """On the CPU K6's wrapper takes the plain int8 fused step, which the
    replay also drives with: one row per denoising forward, each equal,
    the decode is the plain fused int8 decode, and the wrapper is
    restored."""
    from repro_torch.kernels.fused_step import \
        quantized_fused_step_kernel as k6

    cfg, fdcfg, qparams, prompts, store = k6_setup
    res, rows = cs.k6_replay_rows(qparams, cfg, fdcfg, store, prompts, k6)
    assert rows and {r["kind"] for r in rows} == {"step"}
    assert len(rows) == int(res.steps_per_block.sum())
    assert all(r["kernel"]["max_dconf"] == 0.0 and r["kernel"]["agree"] == 1.0
               and r["kernel"]["above_mismatch"] == 0 for r in rows)
    assert cs.replay_ok(rows)
    assert kops.quantized_fused_step_kernel is k6
    plain = OSDTSession(qparams, cfg, fdcfg, tok.MASK_ID, store=store,
                        gen_fn=make_generate_fn(cfg, fdcfg,
                                                attn_impl="kernel"))
    want = plain.generate(prompts)
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe


@pytest.mark.parametrize("name", sorted(cs.K6_REPLAY_FAULTS))
def test_k6_replay_rejects_emulated_faults(k6_setup, name):
    """Each K6 fault that the card check emulates (a neighbour's scale,
    the contraction's last 1/16 dropped, the upper half of the vocabulary
    hidden) moves the checked fused step past the bars, while the plain
    int8 fused step still drives the same decode and the wrapper is
    restored."""
    from repro_torch.kernels.fused_step import \
        quantized_fused_step_kernel as k6

    cfg, fdcfg, qparams, prompts, store = k6_setup
    res, rows = cs.k6_replay_rows(qparams, cfg, fdcfg, store, prompts,
                                  cs.K6_REPLAY_FAULTS[name](k6))
    assert not cs.replay_ok(rows)
    assert kops.quantized_fused_step_kernel is k6
    want, _ = cs.k6_replay_rows(qparams, cfg, fdcfg, store, prompts, k6)
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe


# ---------------------------------------------------------------------------
# the K2 replay: the confidence kernel against the plain confidence pass
# ---------------------------------------------------------------------------

def test_k2_replay_reports_zero_difference(setup):
    """On the CPU K2's wrapper takes the plain confidence pass, which the
    replay also drives with: one row per denoising forward of the unfused
    decode, each equal, the decode is the plain unfused decode, and the
    wrapper is restored."""
    from repro_torch.kernels.confidence import fused_confidence_kernel as k2

    cfg, dcfg, params, prompts, store = setup
    res, rows = cs.k2_replay_rows(params, cfg, dcfg, store, prompts, k2)
    assert rows and {r["kind"] for r in rows} == {"step"}
    assert len(rows) == int(res.steps_per_block.sum())
    assert all(r["kernel"]["max_dconf"] == 0.0 and r["kernel"]["agree"] == 1.0
               and r["kernel"]["n"] == prompts.shape[0] * dcfg.block_size
               for r in rows)
    assert cs.replay_ok(rows)
    assert "above" not in cs.step_replay_summary(rows)
    assert kops.fused_confidence_kernel is k2
    plain = OSDTSession(params, cfg, dcfg, tok.MASK_ID, store=store,
                        gen_fn=make_generate_fn(cfg, dcfg, attn_impl="kernel",
                                                step_fusion="unfused",
                                                use_kernel=True))
    want = plain.generate(prompts)
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe


@pytest.mark.parametrize("name", sorted(cs.K2_REPLAY_FAULTS))
def test_k2_replay_rejects_emulated_faults(setup, name):
    """Each K2 fault that the card check emulates (the upper half of the
    vocabulary hidden, the token taken within its split, the splits' sums
    merged without their rescale) moves the checked confidence pass past
    the bars, while the plain pass still drives the same decode and the
    wrapper is restored."""
    from repro_torch.kernels.confidence import fused_confidence_kernel as k2

    cfg, dcfg, params, prompts, store = setup
    res, rows = cs.k2_replay_rows(params, cfg, dcfg, store, prompts,
                                  cs.K2_REPLAY_FAULTS[name](k2))
    assert not cs.replay_ok(rows)
    assert kops.fused_confidence_kernel is k2
    want, _ = cs.k2_replay_rows(params, cfg, dcfg, store, prompts, k2)
    assert torch.equal(res.tokens, want.tokens) and res.nfe == want.nfe


def test_conf_compare_reads_every_row():
    """K2's wrapper sees no mask: every row counts."""
    conf = torch.tensor([0.5, 0.2, 0.4])
    tok = torch.tensor([1, 2, 3], dtype=torch.int32)
    got = (conf + torch.tensor([0.0, 0.1, 0.0]),
           torch.tensor([1, 2, 9], dtype=torch.int32))
    r = cs.conf_compare((conf, tok), got)
    assert r["max_dconf"] == pytest.approx(0.1, rel=1e-6)
    assert r["share"] == pytest.approx(0.2, rel=1e-6)
    assert r["agree"] == pytest.approx(2 / 3) and r["n"] == 3
