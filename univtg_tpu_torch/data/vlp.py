"""Multi-corpus video-language pretraining dataset; a copy of
``univtg_tpu/data/vlp.py``.

Concatenates several MR-style corpora, tagging each sample with its
supervision type and the matching per-sample loss-gate vector
[b, g, f, s_intra, s_inter]:

  point    -> [0, 0, 1, 0, 0]   (foreground cls only)
  interval -> [1, 1, 0, 0, 0]   (boundary + GIoU)
  curve    -> [0, 0, 0, 1, 1]   (saliency contrastive)

Reference: DatasetVLP (main/dataset.py:22-240, vlp_mapping at :66-97).
Unlike the reference -- which stores the gate vector in targets but never
uses it -- these gates actually mask the per-sample loss terms
(univtg_tpu_torch/models/losses.py).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset

TYPE_GATES = {
    "point": np.array([0, 0, 1, 0, 0], np.float32),
    "interval": np.array([1, 1, 0, 0, 0], np.float32),
    "curve": np.array([0, 0, 0, 1, 1], np.float32),
}


@dataclasses.dataclass
class VLPCorpusSpec:
    data_path: str
    dset_name: str
    v_feat_dirs: Sequence[str]
    q_feat_dir: str
    type: str = "interval"  # point | interval | curve
    clip_len: float = 2.0


@dataclasses.dataclass
class VLPDataConfig:
    corpora: Sequence[VLPCorpusSpec] = ()
    q_feat_dim: int = 512
    v_feat_dim: int = 2816
    max_q_l: int = 32
    max_v_l: int = 75
    use_tef: bool = True
    txt_drop_ratio: float = 0.1
    data_ratio: float = 1.0
    # byte-offset-indexed corpus metadata for multi-million-sample
    # pretraining (see data/features.py LazyJsonl)
    lazy_metadata: bool = False
    seed: int = 2018


class VLPDataset:
    def __init__(self, cfg: VLPDataConfig):
        self.cfg = cfg
        self.parts = []
        self.part_gates = []
        sizes = []
        for pi, spec in enumerate(cfg.corpora):
            part_cfg = MRDataConfig(
                dset_name=spec.dset_name,
                data_path=spec.data_path,
                v_feat_dirs=spec.v_feat_dirs,
                q_feat_dir=spec.q_feat_dir,
                q_feat_dim=cfg.q_feat_dim,
                v_feat_dim=cfg.v_feat_dim,
                clip_len=spec.clip_len,
                max_q_l=cfg.max_q_l,
                max_v_l=cfg.max_v_l,
                use_tef=cfg.use_tef,
                txt_drop_ratio=cfg.txt_drop_ratio,
                lazy_metadata=cfg.lazy_metadata,
                seed=cfg.seed + pi,
            )
            ds = MRDataset(part_cfg)
            self.parts.append(ds)
            self.part_gates.append(TYPE_GATES[spec.type])
            sizes.append(len(ds))
        # compact numpy index (one int32+int64 per sample, not a tuple list:
        # 4.2M-sample corpora stay tens of MB instead of hundreds)
        self.part_ids = np.repeat(
            np.arange(len(sizes), dtype=np.int32), sizes
        )
        self.local_ids = np.concatenate(
            [np.arange(n, dtype=np.int64) for n in sizes]
        ) if sizes else np.zeros(0, np.int64)
        if cfg.data_ratio != 1.0:
            rng = np.random.default_rng(cfg.seed)
            keep = rng.permutation(len(self.part_ids))[
                : int(len(self.part_ids) * cfg.data_ratio)
            ]
            self.part_ids = self.part_ids[keep]
            self.local_ids = self.local_ids[keep]

    def set_epoch(self, epoch: int):
        for p in self.parts:
            p.set_epoch(epoch)

    def __len__(self):
        return len(self.part_ids)

    def feature_lengths(self) -> np.ndarray:
        """Per-item clip-count estimates across all corpora, aligned with
        this dataset's (possibly data_ratio-subsampled) index -- drives
        length-bucketed batching exactly like MRDataset.feature_lengths."""
        sizes = [len(p) for p in self.parts]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        flat = (
            np.concatenate([p.feature_lengths() for p in self.parts])
            if sizes
            else np.zeros(0, np.int64)
        )
        return flat[offsets[self.part_ids] + self.local_ids]

    def __getitem__(self, i: int):
        pi = int(self.part_ids[i])
        item = self.parts[pi][int(self.local_ids[i])]
        item["gates"] = self.part_gates[pi]
        return item
