"""Static-shape padding and length bucketing; a copy of
``univtg_tpu/core/padding.py``."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def pad_to(arr: np.ndarray, length: int, axis: int = 0, value=0.0) -> np.ndarray:
    """Pad (or truncate) `arr` to `length` along `axis`."""
    cur = arr.shape[axis]
    if cur == length:
        return arr
    if cur > length:
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(0, length)
        return arr[tuple(sl)]
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, length - cur)
    return np.pad(arr, widths, constant_values=value)


def pad_stack(arrs: Sequence[np.ndarray], length: int, value=0.0):
    """Pad a list of (L_i, ...) arrays to (B, length, ...) plus a float mask.

    Returns (stacked, mask) where mask is (B, length) with 1.0 for valid rows.
    """
    batch = np.stack([pad_to(np.asarray(a), length, 0, value) for a in arrs])
    mask = np.zeros((len(arrs), length), dtype=np.float32)
    for i, a in enumerate(arrs):
        mask[i, : min(len(a), length)] = 1.0
    return batch, mask


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
