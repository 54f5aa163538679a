"""Configuration dataclasses (the fields the decode paths read).

A copy of the reference's ``ModelConfig`` / ``DecodeConfig`` cut down to
the dense family: the same field names, defaults and ``reduced`` rule, so a
config built here describes the same model as the reference's. The serving
knobs, ``EngineConfig``, are the reference's field for field; the ones the
port does not serve yet (step-sliced decode, drafting, the radix prefix
cache, mesh sharding) are kept so a config reads the same in both
packages, and the scheduler raises for them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of a dense (llama-style) MDLM."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    norm_eps: float = 1.0e-5
    tie_embeddings: bool = False
    supports_mdlm: bool = True
    mask_token_id: int = 0
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim > 0:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def reduced(self, *, num_layers: int = 2, max_d_model: int = 256,
                vocab_size: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU tests (the reference's rule)."""
        d = min(self.d_model, max_d_model)
        heads = max(1, d // 64)
        ratio = max(1, self.num_heads // max(1, self.num_kv_heads))
        kv = max(1, heads // ratio)
        heads = kv * ratio
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab_size=vocab_size,
            dtype="float32",
        )


@dataclass(frozen=True)
class DecodeConfig:
    """Diffusion decoding parameters (the paper's §3-§4 knobs)."""

    max_new_tokens: int = 128
    block_size: int = 32
    policy: str = "static"        # fixed | static | factor | osdt
    threshold: float = 0.9
    factor: float = 0.95
    mode: str = "block"           # block | step-block
    metric: str = "q1"            # mean | q1 | median | q3 | min-whisker
    cap: float = 0.9              # kappa
    slack: float = 0.1            # epsilon
    max_steps_per_block: int = 0  # 0 -> block_size
    # block-step attention: auto | dense | flash | kernel (the hand-written
    # CUDA block-attention kernel on the card, its plain version on the
    # CPU)
    attn_impl: str = "auto"
    # KV-cache layout: dense (every batch row owns a [T, Kh, D] buffer
    # slice) or paged (rows map logical pages onto a shared page pool
    # through per-row int32 page tables; -1 = unmapped)
    cache_layout: str = "dense"
    page_size: int = 16           # cache slots per page
    # denoising-step epilogue: unfused (head product, confidence pass,
    # select) or fused (one kernel, logits never reach memory)
    step_fusion: str = "unfused"
    # decode weight storage: bf16 (the params as they are) or int8
    # (``models.quantize.quantize_decode_params``: per-channel int8 with
    # float32 scales, the projections run through the int8 matmul kernel)
    weight_dtype: str = "bf16"

    @property
    def num_blocks(self) -> int:
        assert self.max_new_tokens % self.block_size == 0
        return self.max_new_tokens // self.block_size

    @property
    def steps_cap(self) -> int:
        return self.max_steps_per_block or self.block_size

    def pages_per_seq(self, max_len: int) -> int:
        """Logical pages covering a ``max_len``-slot cache row."""
        return -(-max_len // self.page_size)


@dataclass(frozen=True)
class EngineConfig:
    """Serving-engine / scheduler knobs (the reference's, SERVING.md).

    The scheduler decodes fixed-shape ``[batch_size, prompt_len]`` batches
    through one generate function; everything per request (threshold
    table, liveness, EOS exit) is a runtime argument.
    """

    batch_size: int = 4
    prompt_len: int = 64
    cache_mode: str = "prefix"    # prefix | dual | none (decoder variants)
    attn_impl: str = ""           # "" -> DecodeConfig.attn_impl
    # "" -> DecodeConfig.weight_dtype; "int8" makes the scheduler quantize
    # the params once at construction (quantize_decode_params) and serve
    # every forward from the int8 tiles
    weight_dtype: str = ""
    # retire rows at the first completed block containing EOS
    eos_early_exit: bool = True
    # npz path for CalibrationStore persistence ("" disables): loaded at
    # construction when no store is passed, saved after every calibration
    store_path: str = ""
    # paged layout: total pool pages; 0 -> shared pages + batch_size rows
    num_pages: int = 0
    # system prompt prepended to every request's prompt; with the paged
    # layout its K/V pages are prefilled once and mapped into every slot
    # (rounded down to whole pages)
    shared_prefix: str = ""
    # speculative block drafting (not ported: True, or draft_max_steps
    # other than 1, raises)
    spec_decode: bool = False
    draft_max_steps: int = 1
    # step-sliced decode loop; 0 is the batch-boundary runtime (>= 1 is
    # not ported: raises)
    slice_len: int = 0
    # radix-tree prefix cache (not ported: True, or either sizing knob
    # non-zero, raises)
    prefix_cache: bool = False
    prefix_cache_pages: int = 0
    prefix_cache_watermark: float = 0.0
    # mesh-sharded serving (not ported: > 1 raises)
    data_parallel: int = 1
    model_parallel: int = 1
    # observability, all off by default: a ring-buffer tracer exported as
    # Chrome/Perfetto trace_event JSON, and confidence-drift telemetry
    # against each task's stored calibration profile
    trace: bool = False
    trace_capacity: int = 1 << 16
    drift_telemetry: bool = False
    drift_threshold: float = 0.95
    drift_window: int = 32

    def resolved_cache_mode(self) -> str:
        assert self.cache_mode in ("prefix", "dual", "none"), self.cache_mode
        return self.cache_mode
