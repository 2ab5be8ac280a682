"""Host-side feature IO: per-id npz dirs and jsonl; a copy of
``univtg_tpu/data/features.py`` (``load_jsonl``, ``save_jsonl``,
``l2_normalize``, ``FeatureSource``, ``load_video_features``).

Whole-split h5 caches, byte-offset lazy metadata and the native npz reader
are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def load_jsonl(path: str):
    """Read a jsonl corpus into a list of dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def save_jsonl(rows, path: str):
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows))


def l2_normalize(x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Row L2 normalization with the reference's additive-eps convention."""
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


class FeatureSource:
    """Per-id .npz feature directory; features are L2-normalized on load
    when ``normalize``."""

    def __init__(self, feat_dir: str, key: str = "features",
                 normalize: bool = True):
        self.feat_dir = feat_dir
        self.key = key
        self.normalize = normalize

    def get(self, fid) -> Optional[np.ndarray]:
        path = os.path.join(self.feat_dir, f"{fid}.npz")
        try:
            feat = np.load(path)[self.key].astype(np.float32)
        except (OSError, KeyError, ValueError):
            return None
        if self.normalize:
            feat = l2_normalize(feat)
        return feat


def load_video_features(sources: Sequence[FeatureSource], vid) -> Optional[np.ndarray]:
    """Concatenate multi-backbone features on the channel dim after
    truncating to the shortest stream."""
    feats = []
    for src in sources:
        f = src.get(vid)
        if f is None:
            return None
        feats.append(f)
    min_len = min(len(f) for f in feats)
    return np.concatenate([f[:min_len] for f in feats], axis=1)
