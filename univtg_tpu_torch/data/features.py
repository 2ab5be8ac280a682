"""Feature helpers; a copy of ``univtg_tpu/data/features.py:l2_normalize``."""
from __future__ import annotations

import numpy as np


def l2_normalize(x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Row L2 normalization with the reference's additive-eps convention."""
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)
