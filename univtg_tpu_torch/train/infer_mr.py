"""Moment-retrieval inference: batched decode -> submission jsonl -> metrics;
counterpart of ``univtg_tpu/train/infer_mr.py``.

  * device: forward + dense decode (spans = timestamp + offsets, fg scores,
    eval_mode 'add' saliency fusion, fp16 saliency quantization),
    ``train/steps.py:make_eval_step``;
  * host: per-query duration scaling and clamping, stable score sort,
    4-decimal rounding, optional round-to-clip-multiple post-processing and
    NMS;
  * metrics through the port's copy of the evaluator (``evals/``).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from univtg_tpu_torch.core.nms import temporal_nms
from univtg_tpu_torch.data.prefetch import to_device
from univtg_tpu_torch.evals import eval_submission
from univtg_tpu_torch.evals.postprocessing import WindowPostProcessor
from univtg_tpu_torch.train.epoch_runner import strip_meta
from univtg_tpu_torch.train.steps import make_eval_step

logger = logging.getLogger(__name__)


def _host(t) -> np.ndarray:
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def decode_batch(dev_out, meta, no_sort_results=False):
    """Eval-step outputs + metadata -> submission rows."""
    scores = _host(dev_out["scores"])
    spans = _host(dev_out["spans"])
    saliency = _host(dev_out["saliency"])
    valid_len = _host(dev_out["valid_len"]).astype(np.int64)
    # guard: a diverged model must score ~0, not exploit the evaluator's
    # NaN-comparison quirk (NaN IoU silently counts as a true positive in
    # the VOC loop -- the reference inherits the same quirk)
    if not np.isfinite(spans).all() or not np.isfinite(scores).all():
        logger.warning("non-finite predictions in decode; sanitizing to zeros")
        spans = np.nan_to_num(spans, nan=0.0, posinf=0.0, neginf=0.0)
        scores = np.nan_to_num(scores, nan=0.0, posinf=0.0, neginf=0.0)
        saliency = np.nan_to_num(saliency, nan=0.0, posinf=0.0, neginf=0.0)
    # 'ce' decode emits absolute seconds; 'l1' emits duration-normalized
    absolute = bool(_host(dev_out.get("absolute_spans", False)))

    rows = []
    for i, m in enumerate(meta):
        dur = float(m["duration"])
        sp = np.clip(spans[i] if absolute else spans[i] * dur, 0, dur)
        sc = scores[i]
        ranked = np.concatenate([sp, sc[:, None]], axis=1)
        if not no_sort_results:
            order = np.argsort(-ranked[:, 2], kind="stable")
            ranked = ranked[order]
        windows = [[float(f"{v:.4f}") for v in row] for row in ranked]
        rows.append(
            {
                "qid": m["qid"],
                "query": m["query"],
                "vid": m["vid"],
                "pred_relevant_windows": windows,
                "pred_saliency_scores": saliency[i, : int(valid_len[i])].tolist(),
            }
        )
    return rows


def run_inference(
    model,
    loader,
    *,
    eval_mode: Optional[str] = "add",
    clip_length: float = 2.0,
    round_multiple: int = 1,
    no_sort_results: bool = False,
    eval_step=None,
    transfer_dtype: str = "float32",
):
    """Run the eval step over a loader's collated batches on the model's
    device; returns submission rows.

    transfer_dtype: one of epoch_runner.TRANSFER_DTYPES: a float name casts
    the input features for the copy; "int8" quantizes them on the host to
    cut the host-to-device copy 4x (data/collate.quantize_for_transfer) and
    dequantizes them on the device.
    """
    if eval_step is None:
        eval_step = make_eval_step(eval_mode)
    device = next(model.parameters()).device
    submission = []
    for batch in loader:
        model_inputs, targets = strip_meta(batch, transfer_dtype)
        dev_out = eval_step(model, to_device(model_inputs, device),
                            to_device(targets, device))
        submission.extend(decode_batch(dev_out, batch["meta"], no_sort_results))
    if round_multiple > 0:
        post = WindowPostProcessor(
            clip_length=clip_length, process_func_names=("round_multiple",)
        )
        submission = post(submission)
    return submission


def apply_nms(submission, nms_thd, max_before_nms=10, max_after_nms=10):
    """Per-query temporal NMS (upstream main/inference_mr.py:31-40)."""
    out = []
    for row in submission:
        row = dict(row)
        row["pred_relevant_windows"] = temporal_nms(
            row["pred_relevant_windows"][:max_before_nms],
            nms_thd=nms_thd,
            max_after_nms=max_after_nms,
        )
        out.append(row)
    return out


def evaluate_submission(submission, gt_data, num_workers=8):
    return eval_submission(
        submission, gt_data, verbose=False, match_number=True, num_workers=num_workers
    )
