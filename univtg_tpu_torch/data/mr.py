"""Moment-retrieval helpers; copies of ``univtg_tpu/data/mr.py``'s
``timestamp_grid`` and ``tef_features``."""
from __future__ import annotations

import numpy as np


def timestamp_grid(ctx_l: int, clip_len: float) -> np.ndarray:
    """(ctx_l, 2) normalized clip-center timestamps."""
    ts = (np.arange(ctx_l, dtype=np.float32) + clip_len / 2) / ctx_l
    return np.stack([ts, ts], axis=1)


def tef_features(ctx_l: int) -> np.ndarray:
    """(L, 2) temporal endpoint features."""
    st = np.arange(ctx_l, dtype=np.float32) / ctx_l
    return np.stack([st, st + 1.0 / ctx_l], axis=1)
