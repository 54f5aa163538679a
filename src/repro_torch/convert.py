"""Weights from the reference package into the port's parameter dict.

The port keeps the reference's keys and layouts (``[d_in, d_out]``
weights, stacked ``[L, ...]`` layer leaves), so conversion is a leaf-wise
copy:

* ``params_from_numpy`` takes the reference's params pytree with numpy
  leaves (``jax.tree.map(np.asarray, params)``), int8-quantized trees
  included;
* ``load_checkpoint`` reads the reference's checkpoint file: a msgpack
  map from ``/``-joined key paths to ``{dtype, shape, data}`` plus a
  ``__meta__`` dict.

bfloat16 leaves are read as uint16 and viewed as ``torch.bfloat16``:
numpy itself has no bfloat16 unless ``ml_dtypes`` is installed.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import msgpack
import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.quantize import QuantizedTensor


def _bf16_from_bits(bits: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return _bf16_from_bits(arr.view(np.uint16), device)
    return torch.from_numpy(arr.copy()).to(device)


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nest of tensors.

    A quantized node (the reference's ``QuantizedTensor`` after
    ``jax.tree.map(np.asarray, ...)``, known by its fields ``(q, scale)``)
    becomes the port's :class:`QuantizedTensor`, ``q`` int8 and ``scale``
    float32 as stored."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if getattr(type(node), "_fields", None) == QuantizedTensor._fields:
            return QuantizedTensor(_to_tensor(node.q, device),
                                   _to_tensor(node.scale, device))
        return _to_tensor(node, device)

    return conv(tree)


def _decode_leaf(spec: dict, device) -> torch.Tensor:
    shape = tuple(spec["shape"])
    if spec["dtype"] == "bfloat16":
        bits = np.frombuffer(spec["data"], dtype=np.uint16).reshape(shape)
        return _bf16_from_bits(bits, device)
    arr = np.frombuffer(spec["data"], dtype=np.dtype(spec["dtype"]))
    return _to_tensor(arr.reshape(shape), device)


def load_checkpoint(path: str, device=None) -> Tuple[Dict[str, Any], dict]:
    """Read a reference checkpoint; returns (params, meta)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    meta = payload.pop("__meta__", {}) or {}
    params: Dict[str, Any] = {}
    for key, spec in payload.items():
        *parents, leaf = key.split("/")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _decode_leaf(spec, device)
    return params, meta
