"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as given, or CUDA when none is given.

    There is no silent CPU fallback: without CUDA the caller must ask for
    the CPU explicitly, and a CUDA device asked for by name raises too.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
