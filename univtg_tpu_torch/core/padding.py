"""Bucket ladder helpers; a copy of ``univtg_tpu/core/padding.py``'s
``bucket_length`` and ``default_buckets``."""
from __future__ import annotations

from typing import Sequence


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket if none fits; inputs get truncated)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def default_buckets(max_len: int, *, base: int = 32) -> list[int]:
    """Power-of-two-ish ladder up to max_len: [32, 64, 128, ..., max_len]."""
    out = []
    b = base
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out
