"""Dense-family model: init, full forward, prefill and the diffusion block
step.

``params`` is a plain dict mirroring the reference's pytree: per-layer
tensors are stacked along a leading layer axis and weights are stored
``[d_in, d_out]``. The layer loop is a Python loop over the stacked
leaves (the reference's ``lax.scan``).

Step vocabulary:
  forward     full sequence, no cache (cacheless MDLM generation)
  prefill     full sequence, builds the KV cache
  block_step  diffusion denoising step: the active block attends
              [prefix cache | block] bidirectionally; ``write=True``
              commits the block's K/V into the cache (in place)

Both take the dense cache or a paged one (a page pool read and written
through per-row page tables).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import cache as cache_lib
from repro_torch.models.attention import (attention, cached_block_attend,
                                          paged_cached_block_attend)
from repro_torch.models.layers import (apply_rope, dense_init, embed,
                                       init_embedding, mlp, project,
                                       rms_norm, unembed)
from repro_torch.models.quantize import QuantizedTensor


def param_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters with the reference's distributions: projections
    ``N(0, 1/d_in)``, embedding ``N(0, 0.02^2)``, norms ones. Drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the draws
    differ from the reference's ``jax.random``; tests share weights
    through ``convert.py`` instead)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"only the dense family is ported, "
                                  f"not {cfg.family!r}")
    device = resolve_device(device)
    dtype = param_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    m, hd = cfg.d_model, cfg.resolved_head_dim
    h, kh, L = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def stacked(d_in, d_out):
        w = torch.empty((L, d_in, d_out), dtype=dtype, device=device)
        for l in range(L):
            w[l] = dense_init(gen, d_in, d_out, dtype, device)
        return w

    params = {"embed": init_embedding(gen, cfg.vocab_size, m, dtype, device),
              "final_norm": ones(m)}
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, m, cfg.vocab_size, dtype, device)
    layers = {
        "ln1": ones(L, m),
        "wq": stacked(m, h * hd),
        "wk": stacked(m, kh * hd),
        "wv": stacked(m, kh * hd),
        "wo": stacked(h * hd, m),
        "ln2": ones(L, m),
        "mlp": {"wi_gate": stacked(m, cfg.d_ff), "wi_up": stacked(m, cfg.d_ff),
                "wo": stacked(cfg.d_ff, m)},
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", kh * hd), ("bv", kh * hd)):
            layers[name] = torch.zeros((L, n), dtype=dtype, device=device)
    params["layers"] = layers
    return params


def layer_params(layers: dict, l: int) -> dict:
    """Layer ``l``'s view of the stacked leaves. A stacked
    :class:`QuantizedTensor` (``q [L, in, out]``, ``scale [L, 1, out]``)
    is sliced in both of its tensors."""
    def at(v):
        if isinstance(v, dict):
            return layer_params(v, l)
        if isinstance(v, QuantizedTensor):
            return QuantizedTensor(v.q[l], v.scale[l])
        return v[l]

    return {k: at(v) for k, v in layers.items()}


# ---------------------------------------------------------------------------
# attention layer apply
# ---------------------------------------------------------------------------

def _qkv(p: dict, cfg: ModelConfig, h_norm: torch.Tensor,
         q_pos: torch.Tensor):
    B, S, _ = h_norm.shape
    hd = cfg.resolved_head_dim
    q = project(h_norm, p["wq"])
    k = project(h_norm, p["wk"])
    v = project(h_norm, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    q = apply_rope(q, q_pos, cfg.rope_theta)
    k = apply_rope(k, q_pos, cfg.rope_theta)
    return q, k, v


def _mlp_part(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp(p["mlp"], h)


def _attn_layer_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, mode: str, window: int):
    """Self-attention over the full sequence; returns the new hidden and
    the rotated (k, v) for the cache."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
    attn = attention(q, k, v, q_pos=positions, kv_pos=positions, mode=mode,
                     window=window)
    B, S = x.shape[:2]
    x = x + project(attn.reshape(B, S, -1).to(x.dtype), p["wo"])
    return _mlp_part(p, cfg, x), (k, v)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _pre_head(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """The final norm: everything of the head except the unembed product
    (what the fused step epilogue takes)."""
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return unembed(head_weights(params, cfg), _pre_head(params, cfg, x),
                   transpose=cfg.tie_embeddings)


def head_weights(params: dict, cfg: ModelConfig):
    """The unembed matrix: [V, M] (tied, the embed table) or [M, V]; a
    :class:`QuantizedTensor` for int8 params (a tied model's is
    ``"head_q"``: its raw ``embed`` stays for the token gathers)."""
    if cfg.tie_embeddings:
        return params.get("head_q", params["embed"])
    return params["head"]


# ---------------------------------------------------------------------------
# full forward / prefill
# ---------------------------------------------------------------------------

def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            mode: Optional[str] = None, window: int = 0,
            positions: Optional[torch.Tensor] = None,
            head: bool = True) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] float32. ``head=False``
    returns the final-norm'd hidden [B, S, M] instead. ``mode`` defaults
    to causal; MDLM decoding passes "full"."""
    mode = mode or "causal"
    x = embed(params["embed"], tokens)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for l in range(cfg.num_layers):
        x, _ = _attn_layer_full(layer_params(params["layers"], l), cfg, x,
                                positions, mode, window)
    return _head(params, cfg, x) if head else _pre_head(params, cfg, x)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_len: int, window: int = 0, mode: Optional[str] = None,
            cache: Optional[dict] = None, page_size: int = 0
            ) -> Tuple[torch.Tensor, dict]:
    """Forward over the prompt; returns (logits, cache). ``mode`` defaults
    to causal (sliding with a window); MDLM decoding passes "full". The
    cache is sized ``max_len`` (or the window) and holds the prompt's K/V.

    ``cache``: an externally owned PAGED cache (``"kp"`` in
    ``cache["attn"]``); the prompt's K/V scatter through its page table
    into the pool, in place, instead of into a fresh dense buffer. The
    page size is the pool's own (``page_size``, where given, must equal
    it). A shared system-prompt prefix is prefilled once into refcounted
    pages this way.
    """
    x = embed(params["embed"], tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if mode is None:
        mode = "sliding" if window else "causal"
    if cache is not None:
        if "kp" not in cache["attn"] or window:
            raise ValueError("an external prefill cache must be a paged "
                             "cache, with no window")
        page_size = _pool_page_size(cache["attn"], page_size)
    ks, vs = [], []
    for l in range(cfg.num_layers):
        x, (k, v) = _attn_layer_full(layer_params(params["layers"], l), cfg,
                                     x, positions, mode, window)
        ks.append(k)
        vs.append(v)
    if cache is not None:
        kv = cache["attn"]
        cache_lib.paged_kv_write_layers(kv["kp"], kv["vp"], torch.stack(ks),
                                        torch.stack(vs), kv["pt"], 0,
                                        page_size=page_size)
        cache_lib.pos_write_slice(kv["pos"], positions, 0)
        return _head(params, cfg, x), dict(cache, attn=dict(kv, length=S))
    kv_len = min(max_len, window) if window else max_len
    kv = cache_lib.init_kv_cache(cfg.num_layers, B, kv_len, cfg.num_kv_heads,
                                 cfg.resolved_head_dim, x.dtype, x.device)
    kv = _store_prefill_kv(kv, torch.stack(ks), torch.stack(vs), positions)
    return _head(params, cfg, x), {"attn": kv}


def _pool_page_size(kv: dict, page_size: int) -> int:
    """The page size of a paged cache, read from its pool's shape; a given
    ``page_size`` (the reference's static argument) must agree with it."""
    ps = kv["kp"].shape[2]
    if page_size and page_size != ps:
        raise ValueError(f"page_size={page_size} does not match the pool's "
                         f"page size {ps}")
    return ps


def _store_prefill_kv(kv_cache: dict, ks: torch.Tensor, vs: torch.Tensor,
                      positions: torch.Tensor) -> dict:
    """ks/vs [L,B,S,Kh,D]. Keep the window tail when the cache is a ring."""
    S = ks.shape[2]
    T = kv_cache["k"].shape[2]
    if S > T:  # sliding window: only the last T positions survive
        kv_cache["k"] = ks[:, :, S - T:].to(kv_cache["k"].dtype).contiguous()
        kv_cache["v"] = vs[:, :, S - T:].to(kv_cache["v"].dtype).contiguous()
        kv_cache["pos"] = positions[S - T:].to(torch.int32)
    else:
        kv_cache["k"][:, :, :S] = ks
        kv_cache["v"][:, :, :S] = vs
        cache_lib.pos_write_slice(kv_cache["pos"], positions, 0)
    kv_cache["length"] = S
    return kv_cache


# ---------------------------------------------------------------------------
# diffusion block step (the paper's step)
# ---------------------------------------------------------------------------

def block_step(params: dict, cfg: ModelConfig, block_tokens: torch.Tensor,
               block_start: int, cache: dict, *, write: bool = False,
               advance: bool = True, exclude_start: Optional[int] = None,
               exclude_len: int = 0, write_slot: Optional[int] = None,
               window: int = 0, attn_impl: str = "auto",
               page_size: int = 0, row_live: Optional[torch.Tensor] = None,
               head: bool = True) -> Tuple[torch.Tensor, dict]:
    """One denoising forward of the active block against the cache.

    block_tokens [B, bs] (masked positions hold the mask id); block_start
    is the absolute position of the block's first token. ``write=True``
    commits this forward's K/V at slot ``write_slot`` (default: the cache
    length), IN PLACE in the cache's tensors; ``advance=False`` keeps the
    length (the dual-cache refresh). ``exclude_start/len`` masks a slot
    range from attention (dual-cache steps exclude their own stale slots).
    ``head=False`` returns the final-norm'd hidden for the fused epilogue.

    ``attn_impl``: auto / dense / flash are the plain paths (write the
    block into a copy of each layer's cache, mask, attend; "flash" stops
    at the cache's valid extent); "kernel" is the block attention kernel's
    wrapper (the CUDA kernel on the card, which reads the fresh K/V as
    separate operands so nothing is copied on a step that does not write;
    its plain version on the CPU).

    A PAGED cache (``"kp"`` in ``cache["attn"]``; its page size is the
    pool's, and ``page_size``, where given, must equal it) is read
    through its page table: the kernel (K4) reads pool pages in
    place, the plain paths gather each row's logical view, and
    ``write=True`` scatters the block into the pool (writes through
    unmapped entries are dropped). ``row_live`` [B] bool (paged only)
    gives rows marked dead a ``kv_limit`` of 0: they attend only their
    fresh block and the kernel reads none of their pages; live rows keep
    the shared valid extent, so an all-live mask changes nothing.
    """
    assert cfg.supports_mdlm, f"{cfg.name} is causal-only"
    x = embed(params["embed"], block_tokens)
    B, bs, _ = x.shape
    kv = cache["attn"]
    paged = "kp" in kv
    if paged:
        if window:
            raise ValueError("a paged cache has no window")
        page_size = _pool_page_size(kv, page_size)
    block_start = int(block_start)
    q_pos = block_start + torch.arange(bs, dtype=torch.int32, device=x.device)
    slot = kv["length"] if write_slot is None else int(write_slot)
    use_kernel = attn_impl == "kernel"
    kv_limit = None
    if attn_impl in ("kernel", "flash"):
        # valid cache extent, shared across layers (one [T] reduction)
        kv_limit = kops.kv_limit_from_pos(kv["pos"])
    row_limit = None
    if paged and row_live is not None:
        # per-row extent: retired rows stop reading their mapped pages
        shared = kops.kv_limit_from_pos(kv["pos"]) if kv_limit is None \
            else kv_limit
        row_limit = torch.where(torch.as_tensor(row_live, device=x.device)
                                .bool(), shared, 0).to(torch.int32)
    if use_kernel:
        # the kernel's per-row geometry, shared across layers (one copy)
        exc_len = exclude_len if exclude_start is not None else 0
        scalars = kops.row_scalars(
            B, x.device, slot=slot, block_start=block_start,
            kv_limit=kv_limit if row_limit is None else row_limit,
            exclude_start=exclude_start, exclude_len=exc_len)
    if paged and write:
        # the mapped write entries, shared across layers (one host sync)
        widx = cache_lib.paged_write_index(kv["pt"], slot, bs, page_size)
    ck_all, cv_all = (kv["kp"], kv["vp"]) if paged else (kv["k"], kv["v"])

    for l in range(cfg.num_layers):
        lp = layer_params(params["layers"], l)
        ck, cv = ck_all[l], cv_all[l]
        hn = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(lp, cfg, hn, q_pos)
        if paged:
            if use_kernel:
                attn = kops.paged_block_attention_kernel(
                    q, ck, cv, k, v, kv["pos"], kv["pt"], scalars,
                    exclude_len=exc_len, window=window)
            else:
                attn, _ = paged_cached_block_attend(
                    q, ck, cv, k, v, kv["pt"], kv["pos"], slot=slot,
                    q_pos=q_pos, page_size=page_size, kv_limit=kv_limit,
                    row_limit=row_limit, exclude_start=exclude_start,
                    exclude_len=exclude_len, window=window, impl=attn_impl)
            if write:
                cache_lib.paged_kv_write(ck, cv, k, v, kv["pt"], slot,
                                         page_size=page_size, index=widx)
        elif use_kernel:
            attn = kops.cached_block_attention_kernel(
                q, ck, cv, k, v, kv["pos"], scalars, exclude_len=exc_len,
                window=window)
            if write:
                cache_lib.kv_write_slice(ck, cv, k, v, slot)
        else:
            attn, (ck_w, cv_w) = cached_block_attend(
                q, ck, cv, k, v, kv["pos"], slot=slot, q_pos=q_pos,
                kv_limit=kv_limit, exclude_start=exclude_start,
                exclude_len=exclude_len, window=window, impl=attn_impl)
            if write:
                ck.copy_(ck_w)
                cv.copy_(cv_w)
        x = x + project(attn.reshape(B, bs, -1).to(x.dtype), lp["wo"])
        x = _mlp_part(lp, cfg, x)

    out = _head(params, cfg, x) if head else _pre_head(params, cfg, x)
    if write:
        cache_lib.pos_write_slice(kv["pos"], q_pos, slot)
        kv = dict(kv, length=kv["length"] + bs if advance else kv["length"])
        cache = dict(cache, attn=kv)
    return out, cache
