"""Domain-split highlight evaluators for TVSum / YouTube-HL; a copy of
``univtg_tpu/evals/hl_domain.py``.

Reference semantics: DatasetHL.evaluate (main/dataset.py:853-921):
  * TVSum: per-annotator (20) top-5 AP of the predicted saliency ranking,
    with per-annotator binarization at that annotator's median; averaged
    over videos then annotators.
  * YouTube: full-rank AP against the binarized match vector.
The AP accumulator is the trapezoidal update ap += (r - r_prev) *
(p_prev + p) / 2 with p_prev initialized to 1.
"""
from __future__ import annotations

import numpy as np


def ranked_ap(labels) -> float:
    """AP of a binary label sequence already sorted by predicted rank."""
    labels = list(labels)
    num_gt = sum(labels)
    if num_gt == 0:
        return 0.0
    hits = ap = rec = 0.0
    prc = 1.0
    for j, gt in enumerate(labels):
        hits += gt
        _rec = hits / num_gt
        _prc = hits / (j + 1)
        ap += (_rec - rec) * (prc + _prc) / 2
        rec, prc = _rec, _prc
    return ap


def evaluate_tvsum(pred_scores, annos, k: int = 5) -> float:
    """mAP over 20 annotators.

    Args:
      pred_scores: list of (L_i,) predicted saliency per video.
      annos: list of (L_i, 20) raw annotator score matrices.
    """
    n_annotators = annos[0].shape[1]
    per_annotator = []
    for i in range(n_annotators):
        video_ap = []
        for score, anno in zip(pred_scores, annos):
            order = np.argsort(-np.asarray(score), kind="stable")
            col = np.asarray(anno[:, i], np.float64)
            # torch.median semantics: the *lower* middle element, not the
            # numpy midpoint average (dataset.py:878)
            lower_median = np.sort(col)[(len(col) - 1) // 2]
            label = (col > lower_median).astype(np.float64)
            video_ap.append(ranked_ap(label[order][:k]))
        per_annotator.append(float(np.mean(video_ap)))
    return float(np.mean(per_annotator))


def evaluate_youtube(pred_scores, binary_labels) -> float:
    """mAP over videos against binarized match labels."""
    aps = []
    for score, label in zip(pred_scores, binary_labels):
        order = np.argsort(-np.asarray(score), kind="stable")
        aps.append(ranked_ap(np.asarray(label, np.float64)[order]))
    return float(np.mean(aps))
