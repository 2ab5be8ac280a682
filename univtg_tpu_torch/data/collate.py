"""Batch assembly into static shapes; a copy of
``univtg_tpu/data/collate.py``'s ``collate_mr`` (with the pad target
``pad_v_to`` that the multi-process bucket plan hands it) and of its
``quantize_for_transfer``, the int8 host-to-device transfer.

Batches are padded to (max_q_l, max_v_l), or to a bucket of a length ladder
for long-video pretraining, so the device sees a few fixed shapes.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np

from univtg_tpu_torch.core.padding import bucket_length, pad_stack


def collate_mr(
    items,
    max_q_l: int,
    max_v_l: int,
    pad_batch_to: Optional[int] = None,
    max_windows: int = 5,
    v_buckets: Optional[Sequence[int]] = None,
    pad_v_to: Optional[int] = None,
):
    """Items (from MRDataset) -> {'model_inputs', 'targets', 'meta'}.

    If pad_batch_to is given, the batch dim is padded with repeats of the
    last item and `batch_mask` marks real rows (keeps shapes static for the
    final partial batch of an epoch).

    pad_v_to: explicit video pad target (the multi-process bucket plan:
    every rank is told the same target, so the ranks' shapes stay equal).
    A batch longer than it is cut to it, with a warning, and its clip-index
    labels clamped into range, as the JAX package does: raising would stop
    one rank of a gang and leave the others waiting in a collective.

    v_buckets: optional video-length bucket ladder. The batch pads to the
    smallest bucket >= the batch's max clip count (capped at max_v_l)
    instead of always max_v_l -- the compiled-program count is bounded by
    len(v_buckets) while padding FLOPs on mixed-length corpora drop with the
    actual length distribution (SURVEY.md §7 "Ragged -> static shapes";
    replaces the reference's per-batch max padding, main/dataset.py:1037-1052,
    which would retrace XLA per batch). Loss numerics are invariant to the
    bucket choice (tests/test_length_buckets.py) because every consumer
    masks: attention bias, conv heads, and all loss terms.
    """
    n_real = len(items)
    if pad_batch_to is not None and n_real < pad_batch_to:
        items = list(items) + [items[-1]] * (pad_batch_to - n_real)

    clamp_labels = False
    if pad_v_to is not None:
        pad_v = min(int(pad_v_to), max_v_l)
        batch_max = max(len(it["video_feat"]) for it in items)
        if batch_max > pad_v:
            # the plan's length estimates under-shot a feature file
            warnings.warn(
                f"bucket plan under-shoot: batch max clip count {batch_max}"
                f" > planned pad target {pad_v}; truncating (metadata "
                f"durations disagree with feature files?)",
                stacklevel=2,
            )
            clamp_labels = True
    elif v_buckets:
        batch_max = max(len(it["video_feat"]) for it in items)
        # max_v_l acts as the implicit top bucket: a ladder whose largest
        # rung is below the batch max must NOT truncate (pad_stack would
        # silently chop features while saliency/span label indices keep
        # pointing past the cut)
        ladder = sorted(set(list(v_buckets) + [max_v_l]))
        pad_v = min(bucket_length(batch_max, ladder), max_v_l)
    else:
        pad_v = max_v_l

    src_txt, src_txt_mask = pad_stack([it["query_feat"] for it in items], max_q_l)
    src_vid, src_vid_mask = pad_stack([it["video_feat"] for it in items], pad_v)
    timestamp, _ = pad_stack([it["timestamp"] for it in items], pad_v)
    span_nn, _ = pad_stack([it["span_labels_nn"] for it in items], pad_v)
    window, _ = pad_stack([it["timestamp_window"] for it in items], pad_v)

    batch_mask = np.zeros(len(items), np.float32)
    batch_mask[:n_real] = 1.0

    model_inputs = {
        "src_txt": src_txt.astype(np.float32),
        "src_txt_mask": src_txt_mask,
        "src_vid": src_vid.astype(np.float32),
        "src_vid_mask": src_vid_mask,
    }
    targets = {
        "timestamp": timestamp.astype(np.float32),
        "timestamp_mask": src_vid_mask,
        "timestamp_window": window.astype(np.float32),
        "span_labels_nn": span_nn.astype(np.float32),
        "batch_mask": batch_mask,
    }
    if "span_labels" in items[0]:
        # padded (B, max_windows, 2) cxw windows + counts (moment_detr
        # matching); static Wmax keeps one compiled program per bucket
        wmax = max_windows
        span_labels = np.zeros((len(items), wmax, 2), np.float32)
        n_windows = np.zeros(len(items), np.int32)
        for i, it in enumerate(items):
            w = np.asarray(it["span_labels"], np.float32).reshape(-1, 2)[:wmax]
            span_labels[i, : len(w)] = w
            n_windows[i] = len(w)
        if clamp_labels:
            # ce-format integer clip indices; l1 floats are <=~1, unaffected
            span_labels = np.minimum(span_labels, pad_v - 1)
        targets["span_labels"] = span_labels
        targets["n_windows"] = n_windows
    if "saliency_scores" in items[0]:
        sal, _ = pad_stack([it["saliency_scores"] for it in items], pad_v)
        targets["saliency_scores"] = sal.astype(np.float32)
        pos = np.stack([it["saliency_pos_labels"] for it in items]).astype(np.int32)
        neg = np.stack([it["saliency_neg_labels"] for it in items]).astype(np.int32)
        if clamp_labels:
            pos = np.minimum(pos, pad_v - 1)
            neg = np.minimum(neg, pad_v - 1)
        targets["saliency_pos_labels"] = pos
        targets["saliency_neg_labels"] = neg
    if "gates" in items[0]:
        targets["gates"] = np.stack([it["gates"] for it in items]).astype(np.float32)

    meta = [it["meta"] for it in items[:n_real]]
    return {"model_inputs": model_inputs, "targets": targets, "meta": meta}


def quantize_for_transfer(model_inputs, keys=("src_txt", "src_vid")):
    """Symmetric per-token int8 quantization of the input features for the
    host-to-device copy (TrainConfig.transfer_dtype='int8').

    Features are L2-normalized per clip, so a per-token max-abs scale keeps
    the quantization error small while cutting the copy's bytes 4x against
    float32 (2x against bfloat16). The step dequantizes on the device
    (train/steps.py:dequantize_inputs); compute stays in
    ModelConfig.compute_dtype.
    """
    mi = dict(model_inputs)
    for key in keys:
        v = np.asarray(mi.pop(key), np.float32)  # (B, L, D)
        amax = np.abs(v).max(axis=-1)  # (B, L)
        scale = np.where(amax > 0, amax, 1.0).astype(np.float32) / 127.0
        q = np.clip(np.rint(v / scale[..., None]), -127, 127).astype(np.int8)
        mi[key + "_q"] = q
        mi[key + "_scale"] = scale
    return mi
