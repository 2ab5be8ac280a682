"""Temporal non-maximum suppression; a copy of the host ``temporal_nms`` of
``univtg_tpu/core/nms.py``.

Host-side numpy, vectorized suppression per kept box: the reference's
O(N^2) list-popping loop (upstream utils/temporal_nms.py:25-74) reduces to
standard greedy NMS under hull-IoU with a strict `>` threshold and a keep
cap.

The IoU used here is intersection over the enclosing hull (the reference's
"not the correct union" comment, utils/temporal_nms.py:18) -- kept for exact
metric parity.
"""
from __future__ import annotations

import numpy as np


def _hull_iou_1_vs_many(span, spans):
    inter = np.maximum(
        0.0, np.minimum(span[1], spans[:, 1]) - np.maximum(span[0], spans[:, 0])
    )
    hull = np.maximum(span[1], spans[:, 1]) - np.minimum(span[0], spans[:, 0])
    out = np.zeros_like(inter)
    np.divide(inter, hull, out=out, where=hull != 0)
    return out


def temporal_nms(predictions, nms_thd, max_after_nms=100):
    """Greedy NMS over scored windows.

    Args:
      predictions: list of [st, ed, score] (or (N, 3) array). Larger score is
        better.
      nms_thd: hull-IoU threshold; candidates with IoU strictly greater than
        this vs an already-kept window are suppressed.
      max_after_nms: keep at most this many windows.

    Returns:
      list of [st, ed, score] kept windows in descending score order.
    """
    preds = np.asarray(predictions, dtype=np.float64).reshape(-1, 3)
    if len(preds) <= 1:
        return [list(map(float, p)) for p in preds]

    order = np.argsort(-preds[:, 2], kind="stable")
    preds = preds[order]
    alive = np.ones(len(preds), dtype=bool)
    keep = []
    for i in range(len(preds)):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) >= max_after_nms:
            break
        ious = _hull_iou_1_vs_many(preds[i, :2], preds[:, :2])
        alive &= ~(ious > nms_thd)
        alive[i] = False
    return [[float(preds[i, 0]), float(preds[i, 1]), float(preds[i, 2])] for i in keep]

