"""Kernel temporal segmentation (KTS) change-point detection; a copy of
``univtg_tpu/core/kts.py``.

Vectorized numpy implementation of the Potapov et al. (ECCV'14) dynamic
program: minimize total within-segment scatter of a frame-kernel matrix,
with automatic model selection via a BIC-style penalty. Behavioral
reference: utils/cpd_nonlin.py / utils/cpd_auto.py (shot boundaries for
summarization pipelines; the reference ships but never wires it --
SURVEY.md L0 row).
"""
from __future__ import annotations

import numpy as np


def segment_scatters(K: np.ndarray) -> np.ndarray:
    """J[i, j] = scatter of segment [i..j] (inclusive), via integral images."""
    n = K.shape[0]
    diag_cum = np.concatenate([[0.0], np.cumsum(np.diag(K))])
    block = np.zeros((n + 1, n + 1))
    block[1:, 1:] = np.cumsum(np.cumsum(K, axis=0), axis=1)

    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    lengths = (j - i + 1).astype(np.float64)
    seg_sum = (
        block[1 + j, 1 + j] + block[i, i] - block[1 + j, i] - block[i, 1 + j]
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        J = (diag_cum[1 + j] - diag_cum[i]) - seg_sum / lengths
    return np.where(j >= i, J, 0.0)


def cpd_nonlin(K: np.ndarray, ncp: int, lmin: int = 1, lmax: int = 100000,
               backtrack: bool = True):
    """DP change-point detection.

    Args:
      K: (n, n) frame kernel matrix. ncp: number of change points.
      lmin/lmax: segment length bounds.
    Returns:
      (cps, obj_vals): change-point indices (segment i spans
      [cps[i-1], cps[i]) ) and objective values for 0..ncp change points.
    """
    m = int(ncp)
    n = K.shape[0]
    assert K.shape[0] == K.shape[1]
    assert n >= (m + 1) * lmin and n <= (m + 1) * lmax
    assert lmax >= lmin >= 1

    J = segment_scatters(K)
    BIG = 1e101
    I = np.full((m + 1, n + 1), BIG)
    I[0, lmin:lmax] = J[0, lmin - 1 : lmax - 1]
    P = np.zeros((m + 1, n + 1), int) if backtrack else None

    for k in range(1, m + 1):
        for l in range((k + 1) * lmin, n + 1):
            t_lo = max(k * lmin, l - lmax)
            t_hi = l - lmin + 1
            if t_lo >= t_hi:
                continue
            cand = I[k - 1, t_lo:t_hi] + J[t_lo:t_hi, l - 1]
            best = int(np.argmin(cand))
            I[k, l] = cand[best]
            if backtrack:
                P[k, l] = t_lo + best

    obj_vals = I[:, n].copy()
    cps = np.zeros(m, int)
    if backtrack and m > 0:
        cur = n
        for k in range(m, 0, -1):
            cps[k - 1] = P[k, cur]
            cur = cps[k - 1]
    return cps, obj_vals


def cpd_auto(K: np.ndarray, max_ncp: int, vmax: float, desc_rate: int = 1, **kw):
    """Automatic change-point count selection (utils/cpd_auto.py:4-46).

    Returns (cps, costs): chosen change points and penalized costs for
    0..max_ncp change points.
    """
    m = int(max_ncp)
    _, scores = cpd_nonlin(K, m, backtrack=False, **kw)
    n = K.shape[0]
    n_orig = n * desc_rate
    penalties = np.zeros(m + 1)
    counts = np.arange(1, m + 1)
    penalties[1:] = (vmax * counts / (2.0 * n_orig)) * (
        np.log(float(n_orig) / counts) + 1
    )
    costs = scores / float(n) + penalties
    m_best = int(np.argmin(costs))
    cps, _ = cpd_nonlin(K, m_best, **kw)
    return cps, costs
