"""Device-side decode; counterpart of
``univtg_tpu/train/steps.py:decode_dense_outputs``. The rest of the training
step arrives with the training slice (ROADMAP.md)."""
from __future__ import annotations

from typing import Optional

import torch


def decode_dense_outputs(outputs, vid_mask, timestamp,
                         eval_mode: Optional[str]):
    """THE dense-regression decode shared by serving and batch evaluation:
      spans    = timestamp + predicted offsets       (normalized units)
      scores   = foreground probability, zeroed outside the valid length
      saliency = fp16-quantized saliency (parity with the reference's
                 .half() cast) (+ fg prob when eval_mode == 'add')
    """
    prob = outputs["pred_logits"][..., 0]  # (B, Lv) sigmoid probs
    scores = prob * vid_mask
    spans = timestamp + outputs["pred_spans"]
    saliency = outputs["saliency_scores"].half().float()
    if eval_mode == "add":
        saliency = saliency + prob
    return {
        "scores": scores,
        "spans": spans,
        "saliency": saliency,
        "valid_len": vid_mask.sum(dim=1).to(torch.int32),
    }
