"""Highlight-detection datasets (TVSum / YouTube-HL); a copy of
``univtg_tpu/data/hl.py``.

One dataset object serves both train and val through `set_state`, mirroring
DatasetHL (main/dataset.py:698-851). Domain video-id splits live as JSON
data files under configs/hl_splits/ (exported from the reference's
main/config_hl.py tables).

Annotation file schema (json or pickle, vid -> record):
  TVSum:   {"anno": (L, 20) annotator scores, "frames": int, "fps": float,
            "domain": str, "title": str}
  YouTube: {"match": (L,) scores, "clip": ..., "frames", "fps", "domain"}
Saliency targets: TVSum = per-clip mean of (anno - global mean) over the 20
annotators (dataset.py:843); YouTube = binarized match (dataset.py:848).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Optional, Sequence

import numpy as np

from univtg_tpu_torch.core.padding import pad_stack
from univtg_tpu_torch.data.features import (
    FeatureSource,
    l2_normalize,
    load_video_features,
)
from univtg_tpu_torch.data.mr import tef_features

SPLITS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "configs", "hl_splits")


def load_hl_splits(dset_name: str, splits_path: Optional[str] = None):
    path = splits_path or os.path.join(SPLITS_DIR, f"{dset_name}.json")
    with open(path) as f:
        return json.load(f)


def load_annotations(path: str):
    if path.endswith((".json", ".jsonl")):
        with open(path) as f:
            return json.load(f)
    with open(path, "rb") as f:
        return pickle.load(f)


@dataclasses.dataclass
class HLDataConfig:
    dset_name: str = "tvsum"  # tvsum | youtube
    domain: str = "BK"
    anno_path: str = ""
    v_feat_dirs: Sequence[str] = ()
    q_feat_dir: Optional[str] = ""
    q_feat_dim: int = 512
    use_tef: bool = True
    max_v_l: int = 512  # static pad length for the video stream
    max_q_l: int = 32
    splits_path: Optional[str] = None
    seed: int = 2018


class HLDataset:
    def __init__(self, cfg: HLDataConfig):
        assert cfg.dset_name in ("tvsum", "youtube")
        self.cfg = cfg
        splits = load_hl_splits(cfg.dset_name, cfg.splits_path)
        assert cfg.domain in splits, (cfg.domain, list(splits))
        self.label = load_annotations(cfg.anno_path)
        self.video_id = {
            k: [v for v in splits[cfg.domain][k] if v in self.label]
            for k in ("train", "val")
        }
        self.v_sources = [FeatureSource(d) for d in cfg.v_feat_dirs]
        self.q_source = (
            FeatureSource(cfg.q_feat_dir, key="last_hidden_state", normalize=False)
            if cfg.q_feat_dir
            else None
        )
        self.state = "train"
        self.epoch = 0

    def set_state(self, state: str):
        self.state = "train" if state == "train" else "val"

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.video_id[self.state])

    def get_video_id(self, idx: int) -> str:
        return self.video_id[self.state][idx]

    def get_saliency(self, idx: int) -> np.ndarray:
        vid = self.get_video_id(idx)
        if self.cfg.dset_name == "tvsum":
            anno = np.asarray(self.label[vid]["anno"], np.float32)
            return (anno - anno.mean()).mean(axis=1)
        return np.asarray(
            [1.0 if s > 0 else 0.0 for s in self.label[vid]["match"]], np.float32
        )

    def __getitem__(self, idx: int):
        cfg = self.cfg
        vid = self.get_video_id(idx)
        rng = np.random.default_rng((cfg.seed, self.epoch, idx))

        video = load_video_features(self.v_sources, vid)
        if video is None:
            raise FileNotFoundError(f"missing HL features for {vid}")
        saliency = self.get_saliency(idx)
        n = min(len(video), len(saliency))
        video, saliency = video[:n], saliency[:n]
        video = video[: cfg.max_v_l]
        saliency = saliency[: cfg.max_v_l]

        pos_pool = np.flatnonzero(saliency > 0)
        if len(pos_pool) == 0:
            pos_pool = np.arange(len(saliency))
        pos = int(rng.choice(pos_pool))

        if cfg.use_tef:
            video = np.concatenate([video, tef_features(len(video))], axis=1)

        item = {
            "meta": {"vid": vid, "idx": idx},
            "video_feat": video,
            "saliency_scores": saliency,
            "saliency_pos_labels": np.asarray([pos], np.int32),
        }
        if self.q_source is not None:
            q = self.q_source.get(vid)
            if q is None:
                q = np.zeros((10, cfg.q_feat_dim), np.float32)
            item["query_feat"] = l2_normalize(q.astype(np.float32))[: cfg.max_q_l]
        return item


def collate_hl(items, max_q_l: int, max_v_l: int, pad_batch_to: Optional[int] = None):
    """HL batch: saliency>0 defines timestamp_window (dataset.py:1130-1133)."""
    n_real = len(items)
    if pad_batch_to is not None and n_real < pad_batch_to:
        items = list(items) + [items[-1]] * (pad_batch_to - n_real)

    src_vid, src_vid_mask = pad_stack([it["video_feat"] for it in items], max_v_l)
    sal, _ = pad_stack([it["saliency_scores"] for it in items], max_v_l)

    batch_mask = np.zeros(len(items), np.float32)
    batch_mask[:n_real] = 1.0

    model_inputs = {
        "src_vid": src_vid.astype(np.float32),
        "src_vid_mask": src_vid_mask,
    }
    if "query_feat" in items[0]:
        src_txt, src_txt_mask = pad_stack([it["query_feat"] for it in items], max_q_l)
        model_inputs["src_txt"] = src_txt.astype(np.float32)
        model_inputs["src_txt_mask"] = src_txt_mask
    targets = {
        "saliency_scores": sal.astype(np.float32),
        "saliency_pos_labels": np.stack(
            [it["saliency_pos_labels"] for it in items]
        ).astype(np.int32),
        "timestamp_mask": src_vid_mask,
        "timestamp_window": (sal > 0).astype(np.float32),
        "batch_mask": batch_mask,
    }
    meta = [it["meta"] for it in items[:n_real]]
    return {"model_inputs": model_inputs, "targets": targets, "meta": meta}
