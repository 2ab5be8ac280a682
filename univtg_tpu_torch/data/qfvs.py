"""Query-focused video summarization (QFVS / UT-Egocentric) data pipeline;
a copy of ``univtg_tpu/data/qfvs.py``.

Layout mirrors the reference's data/qfvs tree (main/dataset_qfvs.py,
main/train_qfvs.py):

  {root}/processed/P0{v}_{feat}.h5                      features (S, F, D), seg_len (S,)
  {root}/metadata/origin_data/Dense_per_shot_tags/P0{v}/P0{v}.txt
  {root}/metadata/origin_data/Query-Focused_Summaries/Oracle_Summaries/P0{v}/{c1}_{c2}_oracle.txt
  {root}/txt_clip/{txt_feature}.pkl                     concept -> (Lq, Dq) embedding

Items are oracle concept-pair summaries; each __getitem__ returns the whole
video's segment grid plus three query variants (concept1, concept2, oracle
= concat). `prepare_qfvs_batch` flattens segments into the batch dimension
and adds per-segment TEF (dataset_qfvs.py:225-266).

``load_video_grid`` is the one read of a video's grid (h5py is imported
there alone): ``QFVSDataset`` and ``train/driver_qfvs.eval_split`` call it
through this module, so replacing it here replaces every grid read.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from univtg_tpu_torch.data.features import l2_normalize
from univtg_tpu_torch.data.mr import tef_features

CONCEPT_RENAMES = {
    "Cupglass": "Glass",
    "Musicalinstrument": "Instrument",
    "Petsanimal": "Animal",
}


@dataclasses.dataclass
class QFVSDataConfig:
    root: str = "data/qfvs"
    vid_feature: str = "fps1"
    txt_feature: str = "query"
    train_videos: Sequence[int] = (1, 2, 3)
    test_videos: Sequence[int] = (4,)
    max_segment_num: int = 20
    max_frame_num: int = 200
    top_percent: float = 0.02
    score_ensemble: bool = False
    score_gather: bool = False
    loss_gather: bool = False
    seed: int = 2018


def _h5_path(cfg, vid):
    return os.path.join(cfg.root, "processed", f"P0{vid}_{cfg.vid_feature}.h5")


def _tags_path(cfg, vid):
    return os.path.join(
        cfg.root,
        "metadata/origin_data/Dense_per_shot_tags",
        f"P0{vid}",
        f"P0{vid}.txt",
    )


def _oracle_dir(cfg, vid):
    return os.path.join(
        cfg.root,
        "metadata/origin_data/Query-Focused_Summaries/Oracle_Summaries",
        f"P0{vid}",
    )


def load_concept_embeddings(cfg: QFVSDataConfig) -> Dict[str, np.ndarray]:
    with open(os.path.join(cfg.root, "txt_clip", f"{cfg.txt_feature}.pkl"), "rb") as f:
        return pickle.load(f)


def load_video_grid(cfg: QFVSDataConfig, vid: int):
    """(S, F, D) feature grid + (S,) per-segment valid frame counts."""
    import h5py

    with h5py.File(_h5_path(cfg, vid), "r") as f:
        return f["features"][()], f["seg_len"][()]


def read_shot_tags(cfg: QFVSDataConfig, vid: int) -> List[List[str]]:
    with open(_tags_path(cfg, vid)) as f:
        return [line.strip().split(",") for line in f.readlines()]


def concept_gt_vector(cfg: QFVSDataConfig, vid: int, concept: str) -> np.ndarray:
    """Binary per-shot vector over the padded S*F grid (dataset_qfvs.py:151-162)."""
    gt = np.zeros(cfg.max_segment_num * cfg.max_frame_num, np.float32)
    for idx, tags in enumerate(read_shot_tags(cfg, vid)):
        if concept in tags:
            gt[idx] = 1
    return gt


def read_oracle_summary(path: str) -> List[int]:
    with open(path) as f:
        return [int(line.strip()) - 1 for line in f.readlines()]


class QFVSDataset:
    """Oracle concept-pair items over the configured training videos."""

    def __init__(self, cfg: QFVSDataConfig):
        self.cfg = cfg
        self.embedding = load_concept_embeddings(cfg)
        self.grids = {v: load_video_grid(cfg, v) for v in cfg.train_videos}
        self.items = []
        for vid in cfg.train_videos:
            odir = _oracle_dir(cfg, vid)
            for fname in sorted(os.listdir(odir)):
                if fname.endswith("_oracle.txt"):
                    c1, c2 = fname[: -len("_oracle.txt")].split("_")[:2]
                    self.items.append((vid, c1, c2, os.path.join(odir, fname)))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.items)

    def _embed(self, concept: str) -> np.ndarray:
        concept = CONCEPT_RENAMES.get(concept, concept)
        return l2_normalize(np.asarray(self.embedding[concept], np.float32))

    def segment_mask(self, seg_len) -> np.ndarray:
        cfg = self.cfg
        mask = np.zeros((cfg.max_segment_num, cfg.max_frame_num), np.float32)
        for j, n in enumerate(seg_len):
            mask[j, : int(n)] = 1
        return mask

    def __getitem__(self, index: int):
        cfg = self.cfg
        vid, c1, c2, oracle_path = self.items[index]
        rng = np.random.default_rng((cfg.seed, self.epoch, index))
        features, seg_len = self.grids[vid]

        gt1 = concept_gt_vector(cfg, vid, c1)
        gt2 = concept_gt_vector(cfg, vid, c2)
        oracle = np.zeros(cfg.max_segment_num * cfg.max_frame_num, np.float32)
        for shot in read_oracle_summary(oracle_path):
            oracle[shot] = 1

        def pos_of(v):
            nz = np.flatnonzero(v > 0)
            return int(rng.choice(nz)) if len(nz) else 0

        return {
            "features": np.asarray(features, np.float32),
            "seg_len": np.asarray(seg_len, np.int32),
            "mask_GT": self.segment_mask(seg_len),
            "concept1_GT": gt1,
            "concept2_GT": gt2,
            "oracle_summary": oracle,
            "tokens_1": self._embed(c1),
            "tokens_2": self._embed(c2),
            "saliency_pos_labels_1": pos_of(gt1),
            "saliency_pos_labels_2": pos_of(gt2),
            "saliency_pos_labels_oracle": pos_of(oracle),
            "meta": {"vid": vid, "c1": c1, "c2": c2},
        }


def prepare_qfvs_batch(item, max_q_l: int = 32):
    """One video -> segment-flattened model inputs for the three query
    variants + flat grid mask (dataset_qfvs.py:225-284).

    Returns (inputs_1, inputs_2, inputs_oracle, mask_flat) where each inputs
    dict has src_vid (S, F, D+2) with per-segment TEF.
    """
    features = item["features"]  # (S, F, D)
    S, F, D = features.shape
    assert item["mask_GT"].shape == (S, F), (
        "feature grids must be padded to (max_segment_num, max_frame_num)"
    )
    mask = item["mask_GT"]  # (S, F)

    tef = tef_features(F)  # (F, 2)
    src_vid = np.concatenate(
        [features, np.tile(tef[None], (S, 1, 1))], axis=-1
    ).astype(np.float32)

    def txt_inputs(tokens):
        t = tokens[:max_q_l]
        src_txt = np.tile(t[None], (S, 1, 1)).astype(np.float32)
        src_txt_mask = np.ones((S, len(t)), np.float32)
        return src_txt, src_txt_mask

    t1, m1 = txt_inputs(item["tokens_1"])
    t2, m2 = txt_inputs(item["tokens_2"])
    to = np.concatenate([t1, t2], axis=1)
    mo = np.concatenate([m1, m2], axis=1)

    base = {"src_vid": src_vid, "src_vid_mask": mask.astype(np.float32)}
    inputs_1 = dict(base, src_txt=t1, src_txt_mask=m1)
    inputs_2 = dict(base, src_txt=t2, src_txt_mask=m2)
    inputs_oracle = dict(base, src_txt=to, src_txt_mask=mo)
    mask_flat = item["mask_GT"].reshape(-1)
    return inputs_1, inputs_2, inputs_oracle, mask_flat
