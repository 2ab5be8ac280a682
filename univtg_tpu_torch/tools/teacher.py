"""CLIP-teacher pseudo-label generation for scalable pretraining; the
counterpart of ``univtg_tpu/tools/teacher.py``, with torch in place of
``jax.jit``.

For each video: similarity of its clip features against a class-concept
text-feature bank -> top-k concepts -> per-concept thresholded score curve
-> contiguous max-score windows -> curve-type jsonl samples.

Behavioral reference: teacher/clip2label.py:22-90 (window construction,
score quantization by `threshold`), teacher/csv2json.py, and
teacher/label2feature.py ("a photo of a" prompting). The similarity runs
on ``device`` (a card by default, as every entry point of the port; the CPU
when asked), one video at a time; the windows are built on the host.
``encode_class_bank`` takes the port's ``extract.pipeline.ClipEncoder``.
"""
from __future__ import annotations

import csv
import json
from typing import List, Sequence

import numpy as np
import torch

from univtg_tpu_torch.device import resolve_device


def class_csv_to_json(csv_path: str, json_path: str) -> List[str]:
    """Class-description csv -> json list of display names
    (teacher/csv2json.py)."""
    names = []
    with open(csv_path, newline="") as f:
        for row in csv.reader(f):
            if len(row) >= 2:
                names.append(row[1])
    with open(json_path, "w") as f:
        json.dump(names, f)
    return names


def encode_class_bank(encoder, class_names: Sequence[str], prompt="a photo of a"):
    """Concept names -> (C, embed_dim) pooled text features with prompting
    (teacher/label2feature.py:21-34)."""
    texts = [f"{prompt} {name}" for name in class_names]
    _, pooled = encoder.encode_texts(texts)
    return pooled


def _sim(vid_feats: torch.Tensor, txt_bank: torch.Tensor, eps: float = 1e-8):
    """(T, C) cosine similarities, each row L2-normalized with its norm
    floored at eps."""
    v = vid_feats / torch.clamp(torch.linalg.vector_norm(vid_feats, dim=1, keepdim=True),
                                min=eps)
    t = txt_bank / torch.clamp(torch.linalg.vector_norm(txt_bank, dim=1, keepdim=True),
                               min=eps)
    return v @ t.T


def score_curve_windows(scores: Sequence[float], clip_len: float) -> List[List[float]]:
    """Contiguous runs at the max score level -> [st, ed] second windows
    (teacher/clip2label.py:22-36). A run touching the sequence end is
    dropped, matching the reference's loop."""
    max_score = max(scores)
    windows = []
    start = end = None
    in_run = False
    for i, s in enumerate(scores):
        if not in_run and s == max_score:
            start, end = i * clip_len, (i + 1) * clip_len
            in_run = True
        elif in_run and s == max_score:
            end = (i + 1) * clip_len
        elif in_run:
            windows.append([start, end])
            in_run = False
    return windows


def pseudo_label_video(
    vid: str,
    vid_feats: np.ndarray,
    class_bank: np.ndarray,
    class_names: Sequence[str],
    clip_len: float = 2.0,
    topk: int = 5,
    threshold: float = 0.05,
    device="cuda",
) -> List[dict]:
    """One video -> up to topk curve-type jsonl rows (teacher/clip2label.py:61-90);
    the similarity on ``device``."""
    if len(vid_feats) == 0:
        return []
    dev = resolve_device(device)
    sim = _sim(torch.as_tensor(np.asarray(vid_feats, np.float32), device=dev),
               torch.as_tensor(np.asarray(class_bank, np.float32), device=dev))
    sim = sim.cpu().numpy()  # (T, C)
    concept_idx = np.argsort(-sim.sum(0), kind="stable")[:topk]

    rows = []
    for ci in concept_idx:
        score = [[s // threshold] for s in sim[:, ci].tolist()]
        windows = score_curve_windows([s[0] for s in score], clip_len)
        if not windows:
            continue
        rows.append(
            {
                "qid": int(ci),
                "query": class_names[ci],
                "duration": float(len(vid_feats) * clip_len),
                "vid": vid,
                "relevant_clip_ids": list(range(len(vid_feats))),
                "relevant_windows": windows,
                "saliency_scores": score,
            }
        )
    return rows


def generate_pseudo_labels(
    video_iter,
    class_bank: np.ndarray,
    class_names: Sequence[str],
    out_jsonl: str,
    clip_len: float = 2.0,
    topk: int = 5,
    threshold: float = 0.05,
    device="cuda",
) -> int:
    """Stream (vid, features) pairs -> curve jsonl. Returns #rows written."""
    n = 0
    with open(out_jsonl, "w") as f:
        for vid, feats in video_iter:
            for row in pseudo_label_video(
                vid, feats, class_bank, class_names, clip_len, topk, threshold, device
            ):
                f.write(json.dumps(row) + "\n")
                n += 1
    return n
