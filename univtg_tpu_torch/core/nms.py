"""Temporal non-maximum suppression; counterpart of ``univtg_tpu/core/nms.py``:
the host ``temporal_nms`` (a copy) and ``temporal_nms_torch`` (of
``temporal_nms_jax``), its fixed-shape twin on tensors of any device.

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
import torch


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



def temporal_nms_torch(spans, scores, nms_thd, max_keep):
    """Fixed-shape greedy NMS on tensors of any device, with no host sync,
    so a CUDA graph can capture it.

    Args:
      spans: (N, 2) xx windows. scores: (N,); a candidate whose score is not
        finite (-inf for padding) is never kept. nms_thd: python float.
        max_keep: python int.

    Returns:
      (keep_idx, keep_mask): (max_keep,) int32 indices into the input, in
      descending score order (the first index among equal scores), and a
      bool validity mask; a slot left empty holds -1 and False.
    """
    inter = (torch.minimum(spans[:, None, 1], spans[None, :, 1])
             - torch.maximum(spans[:, None, 0], spans[None, :, 0])).clamp_min(0)
    hull = (torch.maximum(spans[:, None, 1], spans[None, :, 1])
            - torch.minimum(spans[:, None, 0], spans[None, :, 0]))
    nonzero = hull != 0
    suppress = torch.where(nonzero, inter / torch.where(nonzero, hull, 1.0), 0.0) > nms_thd
    alive = torch.isfinite(scores)
    empty = torch.full_like(scores, float("-inf"))
    keep_idx = torch.full((max_keep,), -1, dtype=torch.int32, device=scores.device)
    keep_mask = torch.zeros((max_keep,), dtype=torch.bool, device=scores.device)
    for k in range(max_keep):
        masked = torch.where(alive, scores, empty)
        best = torch.argmax(masked).view(1)
        ok = masked.gather(0, best) > float("-inf")
        keep_idx[k:k + 1] = torch.where(ok, best.to(torch.int32), -1)
        keep_mask[k:k + 1] = ok
        alive = (alive & ~suppress.index_select(0, best)[0] & ok).index_fill(0, best, False)
    return keep_idx, keep_mask
