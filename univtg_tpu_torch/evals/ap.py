"""Average-precision kernels on the host; a copy of ``univtg_tpu/evals/ap.py``.
Batched detection AP runs the native C++ kernel (native/src/ap_kernel.cpp);
``detection_ap_batch_numpy`` is its numpy twin.

Numerically identical to the reference metric stack:
  * `binary_pr_curve` reproduces sklearn.metrics.precision_recall_curve
    (the reference imports sklearn at eval/utils.py:9; we are self-contained
    and verify equality in tests/test_ap.py).
  * `average_precision` reproduces eval/utils.py:171-211 (`get_ap`).
  * `detection_ap` reproduces the VOC-style detection AP with lock_gt
    tie-breaking, eval/utils.py:85-168.
"""
from __future__ import annotations

import numpy as np


def binary_pr_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Precision-recall pairs for binary labels, sklearn-compatible.

    Returns (precision, recall): arrays ordered by increasing threshold, with
    a final (1, 0) sentinel point, trimmed after full recall is attained.
    """
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()

    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps

    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    if tps[-1] == 0:
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]

    # reverse so recall is non-increasing, append the (1, 0) sentinel
    return np.hstack((precision[::-1], 1)), np.hstack((recall[::-1], 0))


def average_precision(y_true, y_score, interpolate=True, point_11=False):
    """AP of a scored binary ranking (the highlight-detection AP kernel).

    Degenerate label sets short-circuit: all-zeros -> 0, all-ones -> 1.
    """
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    assert len(y_true) == len(y_score)
    uniq = set(np.unique(y_true).tolist())
    if len(uniq) == 1:
        return 0 if y_true.flat[0] == 0 else 1
    assert uniq == {0, 1}, "labels must be binary"

    precision, recall = binary_pr_curve(y_true, y_score)
    recall = recall.astype(np.float32)

    if interpolate:
        for i in range(1, len(precision)):
            precision[i] = max(precision[i - 1], precision[i])

    if point_11:
        precision_11 = [
            precision[np.where(recall >= t)[0][-1]] for t in np.arange(0, 1.01, 0.1)
        ]
        return np.mean(precision_11)
    indices = np.where(np.diff(recall))
    return np.mean(precision[indices])


def interpolated_pr_auc(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC2011 interpolated area under a PR curve (eval/utils.py:66-82)."""
    mprec = np.hstack([[0], precision, [0]])
    mrec = np.hstack([[0], recall, [1]])
    for i in range(len(mprec) - 2, -1, -1):
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def _hull_free_iou_cross(spans1: np.ndarray, spans2: np.ndarray) -> np.ndarray:
    """(N,2) x (M,2) -> (N,M) standard temporal IoU (true union)."""
    areas1 = spans1[:, 1] - spans1[:, 0]
    areas2 = spans2[:, 1] - spans2[:, 0]
    left = np.maximum(spans1[:, None, 0], spans2[None, :, 0])
    right = np.minimum(spans1[:, None, 1], spans2[None, :, 1])
    inter = np.clip(right - left, 0, None)
    union = areas1[:, None] + areas2[None, :] - inter
    return inter / union


def detection_ap(
    gt_spans: np.ndarray,
    pred_spans: np.ndarray,
    pred_scores: np.ndarray,
    tiou_thresholds=np.linspace(0.5, 0.95, 10),
) -> np.ndarray:
    """Detection AP for a single query at several IoU thresholds.

    Greedy GT assignment with per-threshold GT locking: predictions are
    visited in descending score order; each claims its highest-IoU unlocked
    GT above the threshold, else counts as a false positive. Matches
    eval/utils.py:85-168 including the unstable argsort tie order on IoUs.

    Args:
      gt_spans: (G, 2) xx. pred_spans: (P, 2) xx. pred_scores: (P,).
    Returns:
      (len(tiou_thresholds),) AP values.
    """
    tiou_thresholds = np.asarray(tiou_thresholds)
    num_thds = len(tiou_thresholds)
    num_gts = len(gt_spans)
    num_preds = len(pred_spans)
    ap = np.zeros(num_thds)
    if num_preds == 0:
        return ap

    order = np.argsort(-np.asarray(pred_scores), kind="stable")
    pred_spans = np.asarray(pred_spans, dtype=np.float64)[order]

    tp = np.zeros((num_thds, num_preds))
    fp = np.zeros((num_thds, num_preds))
    lock_gt = np.full((num_thds, num_gts), -1)

    if num_gts == 0:
        fp[:] = 1
    else:
        gt_spans = np.asarray(gt_spans, dtype=np.float64)
        tiou = _hull_free_iou_cross(pred_spans, gt_spans)  # (P, G)
        for idx in range(num_preds):
            tiou_arr = tiou[idx]
            tiou_sorted_idx = tiou_arr.argsort()[::-1]
            for t_idx in range(num_thds):
                thd = tiou_thresholds[t_idx]
                for j_idx in tiou_sorted_idx:
                    if tiou_arr[j_idx] < thd:
                        fp[t_idx, idx] = 1
                        break
                    if lock_gt[t_idx, j_idx] >= 0:
                        continue
                    tp[t_idx, idx] = 1
                    lock_gt[t_idx, j_idx] = idx
                    break
                if fp[t_idx, idx] == 0 and tp[t_idx, idx] == 0:
                    fp[t_idx, idx] = 1

    tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
    fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
    recall = tp_cum / float(num_gts) if num_gts else np.zeros_like(tp_cum)
    precision = tp_cum / (tp_cum + fp_cum)
    for t_idx in range(num_thds):
        ap[t_idx] = interpolated_pr_auc(precision[t_idx], recall[t_idx])
    return ap


def detection_ap_batch(
    gt_list,
    pred_list,
    score_list,
    tiou_thresholds=np.linspace(0.5, 0.95, 10),
    n_threads: int = 8,
) -> np.ndarray:
    """Batched detection AP over queries -> (n_queries, n_thds), on the
    native C++ kernel (univtg_tpu_torch/native) over ``n_threads`` threads.
    Tie order on equal IoUs is stable-descending, as in
    ``detection_ap_batch_numpy``, which gives the same values."""
    import ctypes

    from univtg_tpu_torch.native import load_ap_kernel

    lib = load_ap_kernel()
    thds = np.ascontiguousarray(tiou_thresholds, np.float64)
    n_q = len(gt_list)
    out = np.zeros((n_q, len(thds)), np.float64)
    gt_off = np.zeros(n_q + 1, np.int64)
    pred_off = np.zeros(n_q + 1, np.int64)
    for i in range(n_q):
        gt_off[i + 1] = gt_off[i] + len(gt_list[i])
        pred_off[i + 1] = pred_off[i] + len(pred_list[i])
    gt_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(g, np.float64).reshape(-1, 2) for g in gt_list])
        if gt_off[-1]
        else np.zeros((0, 2))
    )
    pred_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(p, np.float64).reshape(-1, 2) for p in pred_list])
        if pred_off[-1]
        else np.zeros((0, 2))
    )
    score_flat = np.ascontiguousarray(
        np.concatenate([np.asarray(s, np.float64).reshape(-1) for s in score_list])
        if pred_off[-1]
        else np.zeros(0)
    )

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.detection_ap_batch(
        p(gt_flat, ctypes.c_double),
        p(gt_off, ctypes.c_int64),
        p(pred_flat, ctypes.c_double),
        p(score_flat, ctypes.c_double),
        p(pred_off, ctypes.c_int64),
        n_q,
        p(thds, ctypes.c_double),
        len(thds),
        n_threads,
        p(out, ctypes.c_double),
    )
    return out


def detection_ap_batch_numpy(
    gt_list,
    pred_list,
    score_list,
    tiou_thresholds=np.linspace(0.5, 0.95, 10),
) -> np.ndarray:
    """The numpy loop of the JAX package's ``detection_ap_batch``: the
    native kernel's twin, one ``detection_ap`` per query."""
    thds = np.ascontiguousarray(tiou_thresholds, np.float64)
    n_q = len(gt_list)
    out = np.zeros((n_q, len(thds)), np.float64)
    for i in range(n_q):
        out[i] = detection_ap(
            np.asarray(gt_list[i], np.float64).reshape(-1, 2),
            np.asarray(pred_list[i], np.float64).reshape(-1, 2),
            np.asarray(score_list[i], np.float64),
            thds,
        )
    return out
