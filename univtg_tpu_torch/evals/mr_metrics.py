"""Moment-retrieval metrics: mAP @ IoU ladder, R1/R5, mIoU, length ranges.

Submission/GT contract is the reference jsonl format (eval/eval.py:292-374):
  submission rows: {qid, query, vid, pred_relevant_windows: [[st, ed, score]...],
                    pred_saliency_scores: [...]}
  gt rows:         {qid, query, duration, vid, relevant_clip_ids,
                    relevant_windows: [[st, ed]...], saliency_scores}

Numbers are formatted through float(f"{100*v:.2f}") exactly as the reference
does, so metric jsons are byte-comparable.
"""
from __future__ import annotations

import copy
from collections import defaultdict

import numpy as np

from univtg_tpu_torch.evals.ap import detection_ap_batch, _hull_free_iou_cross


def _r2(v) -> float:
    return float(f"{v:.2f}")


def _paired_hull_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N,2),(N,2) -> (N,) intersection over enclosing hull (eval/utils.py:17-33)."""
    inter = np.maximum(
        0, np.minimum(pred[:, 1], gt[:, 1]) - np.maximum(pred[:, 0], gt[:, 0])
    )
    union = np.maximum(pred[:, 1], gt[:, 1]) - np.minimum(pred[:, 0], gt[:, 0])
    return np.divide(inter, union, out=np.zeros_like(inter), where=union != 0)


def compute_mr_ap(
    submission,
    ground_truth,
    iou_thds=np.linspace(0.5, 0.95, 10),
    max_gt_windows=None,
    max_pred_windows=10,
    num_workers=8,
    chunksize=50,
):
    """mAP over IoU thresholds, averaged over queries (eval/eval.py:20-70).

    Runs through the batched native AP kernel, `num_workers` its thread
    count.
    """
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_by_qid = defaultdict(list)
    for d in submission:
        windows = d["pred_relevant_windows"]
        if max_pred_windows is not None:
            windows = windows[:max_pred_windows]
        pred_by_qid[d["qid"]].extend([w[:3] for w in windows])

    gt_by_qid = defaultdict(list)
    for d in ground_truth:
        windows = d["relevant_windows"]
        if max_gt_windows is not None:
            windows = windows[:max_gt_windows]
        gt_by_qid[d["qid"]].extend(windows)

    qids = list(pred_by_qid)
    gt_list, pred_list, score_list = [], [], []
    for qid in qids:
        preds = np.asarray(pred_by_qid[qid], np.float64).reshape(-1, 3)
        gt_list.append(np.asarray(gt_by_qid[qid], np.float64).reshape(-1, 2))
        pred_list.append(preds[:, :2])
        score_list.append(preds[:, 2])
    ap = detection_ap_batch(
        gt_list, pred_list, score_list, iou_thds, n_threads=max(num_workers, 1)
    )

    ap_thds = ap.mean(0)
    out = dict(zip([str(e) for e in iou_thds], ap_thds))
    out["average"] = np.mean(ap_thds)
    return {k: _r2(100 * v) for k, v in out.items()}


def compute_mr_r1(submission, ground_truth, iou_thds=np.linspace(0.3, 0.95, 14)):
    """Recall@1 at IoU ladder + mIoU; GT = best-IoU window per query
    (eval/eval.py:73-99)."""
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_by_qid = {d["qid"]: d["pred_relevant_windows"][0][:2] for d in submission}
    gt_by_qid = {}
    for d in ground_truth:
        windows = d["relevant_windows"]
        best = 0
        if len(windows) > 0:
            ious = _hull_free_iou_cross(
                np.array([pred_by_qid[d["qid"]]], dtype=np.float64),
                np.array(windows, dtype=np.float64),
            )[0]
            best = int(np.argmax(ious))
        gt_by_qid[d["qid"]] = windows[best]

    qids = list(pred_by_qid.keys())
    pred = np.array([pred_by_qid[k] for k in qids], dtype=np.float64)
    gt = np.array([gt_by_qid[k] for k in qids], dtype=np.float64)
    iou = _paired_hull_iou(pred, gt)
    miou = _r2(np.mean(iou) * 100)
    r1 = {str(t): _r2(np.mean(iou >= t) * 100) for t in iou_thds}
    return r1, miou


def compute_mr_r5(submission, ground_truth, iou_thds=np.linspace(0.3, 0.95, 14)):
    """Recall@5: best pred among top-5 vs best-matching GT (eval/eval.py:102-132)."""
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_by_qid = {
        d["qid"]: [w[:2] for w in d["pred_relevant_windows"][:5]] for d in submission
    }
    best_pred, best_gt = {}, {}
    for d in ground_truth:
        qid = d["qid"]
        windows = d["relevant_windows"]
        pi, gi = 0, 0
        if len(windows) > 0:
            ious = _hull_free_iou_cross(
                np.array(pred_by_qid[qid], dtype=np.float64),
                np.array(windows, dtype=np.float64),
            )
            ious = np.nan_to_num(ious, nan=0.0)
            flat = np.where(ious == np.max(ious))
            pi, gi = int(flat[0][0]), int(flat[1][0])
        best_pred[qid] = pred_by_qid[qid][pi]
        best_gt[qid] = windows[gi]

    qids = list(pred_by_qid.keys())
    pred = np.array([best_pred[k] for k in qids], dtype=np.float64)
    gt = np.array([best_gt[k] for k in qids], dtype=np.float64)
    iou = _paired_hull_iou(pred, gt)
    return {str(t): _r2(np.mean(iou >= t) * 100) for t in iou_thds}


def filter_by_gt_length(submission, ground_truth, len_range):
    """Keep queries whose GT windows fall in (min_l, max_l] (eval/eval.py:139-171)."""
    min_l, max_l = len_range
    if min_l == 0 and max_l == float("inf"):
        return submission, ground_truth
    gt_in_range, qids = [], set()
    for d in ground_truth:
        windows = [w for w in d["relevant_windows"] if min_l < w[1] - w[0] <= max_l]
        if windows:
            d = copy.deepcopy(d)
            d["relevant_windows"] = windows
            gt_in_range.append(d)
            qids.add(d["qid"])
    sub_in_range = [copy.deepcopy(d) for d in submission if d["qid"] in qids]
    if not sub_in_range and not gt_in_range:
        return submission, ground_truth
    return sub_in_range, gt_in_range


LENGTH_RANGES = ([0, 10], [10, 30], [30, float("inf")], [0, float("inf")])
RANGE_NAMES = ("short", "middle", "long", "full")


def eval_moment_retrieval(submission, ground_truth, verbose=False, num_workers=8):
    """Full MR metric block over length ranges (eval/eval.py:174-195)."""
    out = {}
    for l_range, name in zip(LENGTH_RANGES, RANGE_NAMES):
        sub, gt = filter_by_gt_length(submission, ground_truth, l_range)
        if verbose:
            print(f"{name}: {l_range}, {len(gt)}/{len(ground_truth)} examples")
        mr_ap = compute_mr_ap(sub, gt, num_workers=num_workers)
        r1, miou = compute_mr_r1(sub, gt)
        r5 = compute_mr_r5(sub, gt)
        out[name] = {"MR-mIoU": miou, "MR-mAP": mr_ap, "MR-R1": r1, "MR-R5": r5}
    return out
