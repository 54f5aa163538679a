"""Architecture registry: ``get_config(name)`` / ``list_archs()``.

Only the configurations the port runs are registered (LLaDA-8B, the
paper's model family).
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}

_ARCH_MODULES = ["llada_8b"]


def register(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
    _REGISTRY[fn().name] = fn
    return fn


def _ensure_loaded() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)
