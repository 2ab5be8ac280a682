"""Highlight-detection metrics: HIT@1 and mAP at Fair/Good/VeryGood cutoffs.

Reference semantics: eval/eval.py:198-289 (3 annotators, clip_length=2
hard-coded for QVHighlights GT expansion).
"""
from __future__ import annotations

import numpy as np

from univtg_tpu_torch.evals.ap import average_precision


def _r2(v) -> float:
    return float(f"{v:.2f}")


def mk_gt_scores(gt_row, clip_length=2):
    """Expand sparse relevant-clip saliency to the full video grid
    (eval/eval.py:255-262). Returns (#clips, 3) scores in [0, 4]."""
    num_clips = int(gt_row["duration"] / clip_length)
    full = np.zeros((num_clips, 3))
    ids = np.array(gt_row["relevant_clip_ids"])
    full[ids] = np.array(gt_row["saliency_scores"])
    return full


def compute_hl_hit1(qid2preds, qid2gt_binary):
    """Does the argmax-saliency clip hit any annotator's positive set
    (eval/eval.py:198-210)."""
    hit = np.zeros((len(qid2preds), 3))
    for idx, (qid, pred) in enumerate(qid2preds.items()):
        top = int(np.argmax(pred["pred_saliency_scores"]))
        gt = qid2gt_binary[qid]
        if top < len(gt):
            hit[idx] = gt[top]
    return _r2(100 * np.mean(np.max(hit, 1)))


def _ap_one(args):
    idx, w_idx, y_true, y_pred = args
    if len(y_true) < len(y_pred):
        y_pred = y_pred[: len(y_true)]
    elif len(y_true) > len(y_pred):
        padded = np.zeros(len(y_true))
        padded[: len(y_pred)] = y_pred
        y_pred = padded
    return idx, w_idx, average_precision(y_true, y_pred)


def compute_hl_ap(qid2preds, qid2gt_binary, num_workers=1, chunksize=50):
    """Per-annotator AP of the saliency ranking, averaged (eval/eval.py:213-237).

    Single-process: the numpy AP kernel makes the reference's Pool(8)
    (eval/eval.py:224-228) pure overhead at this scale.
    """
    qids = list(qid2preds.keys())
    tasks = []
    for idx, qid in enumerate(qids):
        y_pred = np.array(qid2preds[qid]["pred_saliency_scores"])
        for w_idx in range(3):
            tasks.append((idx, w_idx, qid2gt_binary[qid][:, w_idx], y_pred))
    ap = np.zeros((len(qids), 3))
    for t in tasks:
        idx, w_idx, score = _ap_one(t)
        ap[idx, w_idx] = score
    return _r2(100 * np.mean(ap))


def eval_highlight(submission, ground_truth, verbose=False, num_workers=8):
    """HL metric block at the three annotator-score cutoffs (eval/eval.py:265-289)."""
    qid2preds = {d["qid"]: d for d in submission}
    qid2gt_full = {d["qid"]: mk_gt_scores(d) for d in ground_truth}
    out = {}
    for score_min, name in zip((2, 3, 4), ("Fair", "Good", "VeryGood")):
        binary = {k: (v >= score_min).astype(float) for k, v in qid2gt_full.items()}
        out[f"HL-min-{name}"] = {
            "HL-mAP": compute_hl_ap(qid2preds, binary, num_workers=num_workers),
            "HL-Hit1": compute_hl_hit1(qid2preds, binary),
        }
    return out
