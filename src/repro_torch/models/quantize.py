"""Post-training int8 weight quantization for the decode path.

A copy of the reference's ``repro/models/quantize.py`` in PyTorch. The
decode-path projection weights (QKV/O, the gated MLP and the lm head)
become symmetric per-output-channel int8 with float32 scales, computed
once from the bf16/f32 params:

    scale_c = max_k |w[k, c]| / 127          (per output channel c)
    q[k, c] = round(w[k, c] / scale_c)  in [-127, 127], int8
    dequant(q, scale) = q.float() * scale

The arithmetic is the reference's op for op (float32 ``amax``, division,
round half to even, clamp), so ``q`` and ``scale`` are bitwise the
reference's for the same weights. Quantization runs where the weights
are: on the card for the full-width model, on the CPU in the tests.

:class:`QuantizedTensor` keeps the scale at the weight's rank, with the
contracted dims of size 1, so a stacked ``[L, in, out]`` layer weight is
sliced layer by layer together with its ``[L, 1, out]`` scale
(``model.layer_params``).

Norms, biases and the embedding table stay in their source dtype: token
gathers read the raw table, and a tied model's unembed view of it is
added as ``"head_q"``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.config.base import ModelConfig

#: weight dtypes the decode path accepts (``DecodeConfig.weight_dtype``)
WEIGHT_DTYPES = ("bf16", "int8")


class QuantizedTensor(NamedTuple):
    """Symmetric per-channel int8 weight: ``dequant = q.float() * scale``.

    ``q`` keeps the source weight's shape; ``scale`` keeps its rank, with
    the contracted dims of size 1.
    """

    q: torch.Tensor      # int8, source shape
    scale: torch.Tensor  # float32, same rank, contracted dims size 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.q.shape)


def quantize_tensor(w: torch.Tensor, axis) -> QuantizedTensor:
    """Symmetric int8 over ``axis`` (the contracted dims).

    All-zero channels get scale 1 (their ``q`` is zero anyway), so
    dequantization never divides by zero. The float32 working copy is
    divided, rounded and clamped in place, so quantizing a stacked
    full-width weight holds two float32 copies of it at most.
    """
    w = w.to(torch.float32, copy=True)
    amax = w.abs().amax(dim=axis, keepdim=True)
    # divide by a device tensor, not a Python scalar: CUDA divides by a
    # host scalar as a multiply by its reciprocal, which can differ from
    # the division in the last bit
    div = torch.tensor(127.0, device=w.device)
    scale = torch.where(amax > 0, amax / div, 1.0)
    q = w.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """The dequant oracle: float32, scale broadcast over the kept dims."""
    return qt.q.float() * qt.scale


def max_abs_error_bound(qt: QuantizedTensor) -> torch.Tensor:
    """Elementwise ``|w - dequant(quantize(w))| <= scale / 2``."""
    return 0.5 * qt.scale


def _quantize_layer(lp: dict) -> dict:
    """Quantize one stacked layer's decode projections over their input
    axis (``-2``, stacked or not); everything else passes through."""
    out = dict(lp)
    for k in ("wq", "wk", "wv", "wo"):
        if k in out:
            out[k] = quantize_tensor(out[k], axis=-2)
    mlp = out.get("mlp")
    if isinstance(mlp, dict) and "wi_gate" in mlp:
        out["mlp"] = dict(mlp, **{k: quantize_tensor(mlp[k], axis=-2)
                                  for k in ("wi_gate", "wi_up", "wo")})
    return out


def quantize_decode_params(params: dict, cfg: ModelConfig) -> dict:
    """Int8-quantize every decode-path projection of ``params``.

    Returns a new params dict (the input is untouched): the layers'
    wq/wk/wv/wo and wi_gate/wi_up/wo become :class:`QuantizedTensor`; an
    untied head ``[d, V]`` is quantized per vocab column; a tied model
    keeps its raw ``embed`` and gains ``head_q``, the ``[V, d]`` table
    quantized per vocab row (the unembed's output channel).
    """
    if cfg.family != "dense":
        raise NotImplementedError(f"the int8 decode path covers the dense "
                                  f"family, not {cfg.family!r}")
    out = dict(params)
    out["layers"] = _quantize_layer(params["layers"])
    if cfg.tie_embeddings:
        out["head_q"] = quantize_tensor(params["embed"], axis=-1)
    elif "head" in params:
        out["head"] = quantize_tensor(params["head"], axis=-2)
    return out


def is_quantized(params: dict) -> bool:
    """True when ``quantize_decode_params`` already ran on this tree."""
    layers = params.get("layers", {})
    return isinstance(layers.get("wq"), QuantizedTensor) \
        or "head_q" in params


def tree_leaves(node):
    """The tensors of a (possibly quantized) params tree, depth first; a
    QuantizedTensor yields its ``q`` and then its ``scale``."""
    if isinstance(node, dict):
        for v in node.values():
            yield from tree_leaves(v)
    elif isinstance(node, QuantizedTensor):
        yield node.q
        yield node.scale
    elif node is not None:
        yield node


def decode_weight_bytes(params: dict, cfg: ModelConfig) -> int:
    """Bytes the decode forward streams for its weights, as stored: every
    layer leaf, the final norm and the head; a quantized leaf counts its
    int8 payload plus its float32 scales. A tied table counts once, as
    ``head_q`` when quantized (the gather reads only the tokens' rows)."""
    head = params.get("head_q", params.get("embed")) if cfg.tie_embeddings \
        else params.get("head")
    return sum(t.numel() * t.element_size()
               for part in (params["layers"], params.get("final_norm"), head)
               for t in tree_leaves(part))
