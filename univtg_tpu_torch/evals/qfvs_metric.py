"""QFVS semantic-matching metric; a copy of
``univtg_tpu/evals/qfvs_metric.py``.

Shot-level concept-tag IoU between machine and oracle summaries, maximum
weight bipartite matching, then P/R/F1. Reference: eval/qfvs.py:32-74
(networkx max_weight_matching over the pairwise semantic-IoU matrix).

The matching is computed with scipy's LSAP maximization: zero-weight pairs
contribute nothing to the total, so the maximum matching weight equals
networkx's max_weight_matching result while running in O(n^3) worst case
with tiny constants (summaries are ~2% of shots).
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def load_videos_tag(mat_path: str):
    """Load the UT-Egocentric per-shot concept-tag matrices from Tags.mat
    (eval/qfvs.py:9-30). Returns a list of (num_shots, num_concepts) arrays."""
    import scipy.io

    mat = scipy.io.loadmat(mat_path)
    videos = mat["Tags"][0]
    out = []
    for video_mat in videos:
        video_mat = video_mat[0]
        # ravel: MATLAB has no 1-D arrays, so a per-shot concept vector can
        # load as (1, C); consumers need (num_shots, num_concepts)
        out.append(np.array([np.ravel(shot_vec[0][0]) for shot_vec in video_mat]))
    return out


def semantic_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, C) x (M, C) binary tag matrices -> (N, M) IoU."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None, :] - inter
    return np.divide(inter, union, out=np.zeros_like(inter), where=union != 0)


def semantic_matching(machine_summary, gt_summary, video_tags) -> tuple:
    """P/R/F1 of the max-weight matching between summary shots.

    Args:
      machine_summary / gt_summary: shot-index lists.
      video_tags: (num_shots, num_concepts) tag matrix for this video.
    """
    m_tags = video_tags[np.asarray(machine_summary, int)]
    g_tags = video_tags[np.asarray(gt_summary, int)]
    weights = semantic_iou_matrix(m_tags, g_tags)
    ri, ci = linear_sum_assignment(-weights)
    total = weights[ri, ci].sum()
    precision = total / m_tags.shape[0]
    recall = total / g_tags.shape[0]
    if precision + recall == 0:
        return 0.0, 0.0, 0.0
    f1 = 2 * precision * recall / (precision + recall)
    return precision, recall, f1
