"""Byte-level tokenizer with specials — offline-friendly, vocab 260.

Layout: bytes 0-255, PAD=256, BOS=257, EOS=258, MASK=259. Model configs
used with this tokenizer need vocab_size >= 260. MASK is the MDLM mask
token (``ModelConfig.mask_token_id``).
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
MASK_ID = 259
VOCAB = 260


def encode(text: str, *, bos: bool = False, eos: bool = False) -> List[int]:
    ids = list(text.encode("utf-8"))
    if bos:
        ids = [BOS_ID] + ids
    if eos:
        ids = ids + [EOS_ID]
    return ids


def decode(ids: Iterable[int]) -> str:
    data = bytes(i for i in ids if 0 <= i < 256)
    return data.decode("utf-8", errors="replace")


def pad_left(ids: List[int], length: int) -> List[int]:
    assert len(ids) <= length, (len(ids), length)
    return [PAD_ID] * (length - len(ids)) + ids


def pad_right(ids: List[int], length: int, fill: int = EOS_ID) -> List[int]:
    assert len(ids) <= length, (len(ids), length)
    return ids + [fill] * (length - len(ids))


def batch_prompts(prompts: List[List[int]], length: int) -> np.ndarray:
    return np.asarray([pad_left(p, length) for p in prompts], np.int32)
