"""Moment-retrieval dataset: jsonl metadata + npz/h5 features -> dense
per-clip supervision; a copy of ``univtg_tpu/data/mr.py``.

Behavioral contract follows DatasetMR (main/dataset.py:392-696):
  * timestamp grid: ((i + clip_len/2) / ctx_l) duplicated to (st, ed),
  * nearest-window assignment -> span_labels_nn + binary timestamp_window,
  * TEF (temporal endpoint feature) concat on the video stream,
  * saliency positive/negative sampling (annotator-score style or
    sub-as-query style),
  * short-window clamping for hacs/ego4d/videocc/activitynet,
  * QVHighlights test split gets dummy windows [[0, 150]],
  * missing features degrade to zeros (text) / skip (video).

Randomness is explicit: sampling draws from a per-(seed, epoch, index)
np.random.Generator instead of the reference's global `random`, making every
batch reproducible under data sharding.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from univtg_tpu_torch.data.features import (
    FeatureSource,
    l2_normalize,
    load_jsonl,
    load_video_features,
)

CLAMP_SHORT_WINDOW_DSETS = ("hacs", "ego4d", "videocc", "activitynet")


@dataclasses.dataclass
class MRDataConfig:
    dset_name: str = "qvhighlights"
    data_path: str = ""
    v_feat_dirs: Sequence[str] = ()
    q_feat_dir: str = ""
    q_feat_dim: int = 512
    v_feat_dim: int = 2816  # pre-TEF
    clip_len: float = 2.0
    max_q_l: int = 32
    max_v_l: int = 75
    use_tef: bool = True
    normalize_v: bool = True
    normalize_t: bool = True
    load_labels: bool = True
    max_windows: int = 5
    span_loss_type: str = "l1"  # l1 (cxw regression) | ce (st/ed indices)
    txt_drop_ratio: float = 0.0
    data_ratio: float = 1.0
    add_easy_negative: int = 1
    easy_negative_only: int = 1
    h5_cache_dir: str = ""  # data/{dset}/h5py dir with {feat_type}.hdf5
    # byte-offset-indexed metadata (multi-million-sample pretraining corpora;
    # records parse on access instead of living in RAM as dicts)
    lazy_metadata: bool = False
    seed: int = 2018


def timestamp_grid(ctx_l: int, clip_len: float) -> np.ndarray:
    """(ctx_l, 2) normalized clip-center timestamps (main/dataset.py:501)."""
    ts = (np.arange(ctx_l, dtype=np.float32) + clip_len / 2) / ctx_l
    return np.stack([ts, ts], axis=1)


def clamp_short_windows(windows, duration, clip_len):
    """Grow sub-clip windows to at least one clip length
    (main/dataset.py:493-499)."""
    out = []
    for st, ed in windows:
        if ed - st < clip_len:
            center = (st + ed) / 2
            st = max(0.0, center - 0.5 * clip_len)
            ed = min(float(duration), center + 0.5 * clip_len)
            ed = max(clip_len, ed)
        out.append([st, ed])
    return out


def assign_nearest_windows(ts: np.ndarray, windows_norm: np.ndarray):
    """Per-clip containing-window assignment (main/dataset.py:507-532).

    Args:
      ts: (L, 2) timestamp grid. windows_norm: (W, 2) windows normalized by
        video length.
    Returns:
      (span_labels_nn (L, 2), timestamp_window (L,)) -- clips inside no
      window keep zeros / fall back to window 0 when nothing matched at all;
      when several windows contain a clip the highest-index one wins
      (the reference's scatter ordering).
    """
    L = ts.shape[0]
    nn = np.zeros((L, 2), np.float32)
    contains = (ts[:, :1] >= windows_norm[None, :, 0]) & (
        windows_norm[None, :, 1] >= ts[:, 1:2]
    )  # (L, W)
    any_hit = contains.any(axis=1)
    if not any_hit.any():
        nn[:] = windows_norm[0]
    else:
        W = windows_norm.shape[0]
        last_hit = W - 1 - np.argmax(contains[:, ::-1], axis=1)
        nn[any_hit] = windows_norm[last_hit[any_hit]]
    window = (ts[:, 0] >= nn[:, 0]) & (ts[:, 1] <= nn[:, 1])
    return nn, window.astype(np.float32)


def tef_features(ctx_l: int) -> np.ndarray:
    """(L, 2) temporal endpoint features (main/dataset.py:534-542)."""
    st = np.arange(ctx_l, dtype=np.float32) / ctx_l
    return np.stack([st, st + 1.0 / ctx_l], axis=1)


def sample_saliency_from_scores(
    rel_clip_ids, scores, ctx_l, rng, add_easy_negative=1, easy_negative_only=1, max_n=1
):
    """Annotator-score pos/neg sampling (main/dataset.py:581-622)."""
    agg = np.sum(np.asarray(scores), axis=1)
    order = np.argsort(agg, kind="stable")
    hard_pos = [min(rel_clip_ids[i], ctx_l - 1) for i in order[-max_n:]]
    hard_neg = [min(rel_clip_ids[i], ctx_l - 1) for i in order[:max_n]]
    if agg[order[-1]] == agg[order[0]]:
        hard_neg = hard_pos

    easy_pos, easy_neg = [], []
    if add_easy_negative > 0:
        pool = sorted(set(range(ctx_l)) - set(rel_clip_ids))
        if len(pool) >= max_n:
            easy_pos = [int(rng.choice(rel_clip_ids)) for _ in range(max_n)]
            easy_neg = [int(rng.choice(pool)) for _ in range(max_n)]
        else:
            easy_pos, easy_neg = hard_pos, hard_neg
    if easy_negative_only > 0:
        return easy_pos, easy_neg
    return hard_pos + easy_pos, hard_neg + easy_neg


def sample_saliency_sub_as_query(gt_window, ctx_l, clip_len, rng, max_n=1):
    """Window-as-positive sampling for corpora without annotator scores
    (main/dataset.py:560-579)."""
    gt_st = min(int(gt_window[0] / clip_len), ctx_l - 1)
    gt_ed = max(0, min(int(gt_window[1] / clip_len), ctx_l) - 1)
    gt_ed = max(gt_st, gt_ed)
    if gt_st != gt_ed:
        pos = [int(rng.integers(gt_st, gt_ed + 1)) for _ in range(max_n)]
    else:
        pos = [gt_st] * max_n
    pool = list(range(0, gt_st)) + list(range(gt_ed + 1, ctx_l))
    if len(pool) >= max_n:
        neg = [int(rng.choice(pool)) for _ in range(max_n)]
    else:
        neg = pos
    return pos, neg


class MRDataset:
    """Map-style host dataset producing per-item numpy dicts."""

    def __init__(self, cfg: MRDataConfig):
        self.cfg = cfg
        self.data = load_jsonl(cfg.data_path, lazy=cfg.lazy_metadata)
        if cfg.data_ratio != 1.0:
            self.data = self.data[: int(len(self.data) * cfg.data_ratio)]
        self.is_test_split = "test" in os.path.basename(cfg.data_path)

        def cache_path(feat_dir):
            if not cfg.h5_cache_dir:
                return None
            name = os.path.basename(feat_dir.rstrip("/"))
            return os.path.join(cfg.h5_cache_dir, f"{name}.hdf5")

        if cfg.h5_cache_dir:  # cache preload keys need a full metadata scan
            vids = sorted({m["vid"] for m in self.data})
            qids = sorted({m["qid"] for m in self.data})
        else:
            vids = qids = None
        # h5 caches store already-normalized features (tools/pack_h5.py),
        # mirroring use_cache (main/dataset.py:448-467)
        self.v_sources = [
            FeatureSource(
                d, normalize=cfg.normalize_v, h5_cache_path=cache_path(d),
                cache_keys=vids,
            )
            for d in cfg.v_feat_dirs
        ]
        self.q_source = FeatureSource(
            cfg.q_feat_dir,
            key="last_hidden_state",
            normalize=False,
            h5_cache_path=cache_path(cfg.q_feat_dir),
            cache_keys=qids,
        )
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.data)

    def feature_lengths(self) -> np.ndarray:
        """Per-item clip-count ESTIMATES from metadata alone (duration /
        clip_len, capped at max_v_l) -- drives length-bucketed batching
        (data/loader.py) without touching any feature file. Single-process:
        exactness is not required (collate buckets from the actual batch
        max). Multi-process plan mode: the plan adds Loader.plan_margin
        clips of headroom; if an on-disk feature count still exceeds the
        planned pad target, collate warns and truncates with clamped label
        indices rather than desynchronizing the gang."""
        cfg = self.cfg
        return np.asarray(
            [
                min(
                    int(np.ceil(float(m["duration"]) / cfg.clip_len)),
                    cfg.max_v_l,
                )
                for m in self.data
            ],
            np.int64,
        )

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.cfg.seed, self.epoch, index))

    def _query_feat(self, qid, rng) -> np.ndarray:
        cfg = self.cfg
        q = self.q_source.get(qid)
        if q is None:
            return np.zeros((10, cfg.q_feat_dim), np.float32)
        q = q.astype(np.float32)
        if cfg.normalize_t:
            q = l2_normalize(q)
        if cfg.txt_drop_ratio > 0:
            n_drop = round(len(q) * cfg.txt_drop_ratio)
            if n_drop > 0:
                rows = rng.choice(len(q), size=n_drop, replace=False)
                q = q.copy()
                q[rows] = 0
        return q

    def __getitem__(self, index: int):
        cfg = self.cfg
        meta = self.data[index]
        rng = self._rng(index)

        query_feat = self._query_feat(meta["qid"], rng)[: cfg.max_q_l]
        video_feat = load_video_features(self.v_sources, meta["vid"])
        if video_feat is None:
            raise FileNotFoundError(f"video features missing for {meta['vid']}")
        video_feat = video_feat[: cfg.max_v_l]
        ctx_l = len(video_feat)

        windows = [list(w) for w in meta.get("relevant_windows", [])]
        if self.is_test_split and "qvhighlights" in cfg.dset_name:
            windows = [[0, 150]]
        if cfg.dset_name in CLAMP_SHORT_WINDOW_DSETS:
            windows = clamp_short_windows(windows, meta["duration"], cfg.clip_len)
        if not windows:
            windows = [[0, float(meta["duration"])]]

        ts = timestamp_grid(ctx_l, cfg.clip_len)
        windows_norm = np.asarray(windows, np.float32) / (ctx_l * cfg.clip_len)
        nn, window_mask = assign_nearest_windows(ts, windows_norm)
        if window_mask.sum() < 1:  # force one positive clip (dataset.py:529-532)
            idx = int(windows[0][0] / cfg.clip_len)
            idx = max(0, min(idx, ctx_l - 1))
            window_mask[idx] = 1

        if cfg.use_tef:
            video_feat = np.concatenate([video_feat, tef_features(ctx_l)], axis=1)

        item = {
            "meta": meta,
            "query_feat": query_feat,
            "video_feat": video_feat,
            "timestamp": ts,
            "span_labels_nn": nn,
            "timestamp_window": window_mask,
        }

        if cfg.load_labels:
            item["span_labels"] = self._span_labels(windows, ctx_l, rng)
            if "saliency_scores" in meta:
                sal = np.zeros(ctx_l, np.float32)
                ids = np.asarray(meta["relevant_clip_ids"])
                limit = int(np.searchsorted(ids, ctx_l)) if (ids >= ctx_l).any() else None
                sal[ids[:limit]] = np.mean(
                    np.asarray(meta["saliency_scores"][:limit]), -1
                )
                item["saliency_scores"] = sal
                pos, neg = sample_saliency_from_scores(
                    meta["relevant_clip_ids"],
                    meta["saliency_scores"],
                    ctx_l,
                    rng,
                    cfg.add_easy_negative,
                    cfg.easy_negative_only,
                )
            else:
                item["saliency_scores"] = window_mask.copy()
                pos, neg = sample_saliency_sub_as_query(
                    windows[0], ctx_l, cfg.clip_len, rng
                )
                # The reference DISCARDS the sub-as-query positive and
                # re-draws uniformly from the nonzeros of timestamp_window
                # (main/dataset.py:556-557: `random.choice(torch.where(
                # model_inputs['saliency_scores'])[0])` where saliency_scores
                # is timestamp_window). Mirror that override exactly; the
                # negative from the window-derived pool above is kept, as
                # upstream keeps its get_saliency_labels_sub_as_query neg.
                nz = np.flatnonzero(window_mask)
                pos = [int(rng.choice(nz))]
            item["saliency_pos_labels"] = np.asarray(pos, np.int32)
            item["saliency_neg_labels"] = np.asarray(neg, np.int32)
        return item

    def _span_labels(self, windows, ctx_l, rng):
        """Span labels, at most max_windows (main/dataset.py:624-642):
        l1 -> normalized (center, width) floats; ce -> inclusive
        (start_clip, end_clip) integer indices."""
        cfg = self.cfg
        windows = list(windows)
        if len(windows) > cfg.max_windows:
            rng.shuffle(windows)
            windows = windows[: cfg.max_windows]
        if cfg.span_loss_type == "ce":
            return np.asarray(
                [
                    [
                        int(w[0] / cfg.clip_len),
                        min(int(w[1] / cfg.clip_len), ctx_l) - 1,
                    ]
                    for w in windows
                ],
                np.int32,
            )
        w = np.asarray(windows, np.float32) / (ctx_l * cfg.clip_len)
        center = w.mean(axis=1)
        width = w[:, 1] - w[:, 0]
        return np.stack([center, width], axis=1)
