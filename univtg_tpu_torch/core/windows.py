"""Clip-id <-> window conversions; a copy of ``univtg_tpu/core/windows.py``.

A window is an inclusive [start_clip_idx, end_clip_idx] pair; e.g. with
2-second clips, [10, 19] covers seconds [20, 40]. Reference contract:
utils/windows_utils.py (doctest vectors reused in tests/test_windows.py).
"""
from __future__ import annotations

from typing import List, Sequence


def clip_ids_to_windows(clip_ids: Sequence[int]) -> List[List[int]]:
    """Group sorted clip ids into maximal contiguous inclusive windows."""
    windows = []
    start = prev = clip_ids[0]
    for cid in clip_ids[1:]:
        if cid - prev > 1:
            windows.append([start, prev])
            start = cid
        prev = cid
    windows.append([start, prev])
    return windows


def windows_to_clip_ids(windows: Sequence[Sequence[int]]) -> List[int]:
    """Inverse of clip_ids_to_windows."""
    out: List[int] = []
    for w in windows:
        out.extend(range(w[0], w[1] + 1))
    return out


def clip_window_to_seconds(window: Sequence[int], clip_len: float = 2) -> List[float]:
    return [window[0] * clip_len, (window[1] + 1) * clip_len]
