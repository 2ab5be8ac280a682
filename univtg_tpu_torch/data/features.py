"""Host-side feature IO: per-id npz dirs, whole-split h5 caches, jsonl; a
copy of ``univtg_tpu/data/features.py``.

The device never sees ragged data; these helpers produce numpy arrays that
the collator pads into static bucket shapes. h5py is imported only when an
h5 cache is read.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional, Sequence

import numpy as np


def load_jsonl(path: str, lazy: bool = False):
    """Read a jsonl corpus. lazy=True returns a LazyJsonl view (one int64
    byte offset per record instead of a parsed dict) for multi-million-sample
    pretraining corpora (the reference holds them fully in RAM,
    main/dataset.py:133-148)."""
    if lazy:
        return LazyJsonl(path)
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class LazyJsonl:
    """List-like lazy jsonl: records parse on access, thread-safe (per-thread
    file handles for the Loader's IO pool). Slicing returns a lazy view."""

    def __init__(self, path: str, offsets: Optional[np.ndarray] = None):
        self.path = path
        if offsets is None:
            offs = []
            pos = 0
            with open(path, "rb") as f:
                for line in f:
                    if line.strip():
                        offs.append(pos)
                    pos += len(line)
            offsets = np.asarray(offs, np.int64)
        self.offsets = offsets
        self._local = threading.local()

    def _handle(self):
        f = getattr(self._local, "f", None)
        if f is None:
            f = open(self.path, "rb")
            self._local.f = f
        return f

    def __len__(self):
        return len(self.offsets)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return LazyJsonl(self.path, self.offsets[i])
        f = self._handle()
        f.seek(int(self.offsets[i]))
        return json.loads(f.readline())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def save_jsonl(rows, path: str):
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows))


def l2_normalize(x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """Row L2 normalization with the reference's additive-eps convention
    (utils/basic_utils.py:97-99)."""
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


class FeatureSource:
    """Per-id .npz feature directory with optional whole-split h5 cache.

    Mirrors DatasetMR's IO behavior (main/dataset.py:448-467, 680-696):
    h5 caches already store L2-normalized features (tools/pack_h5.py), npz
    files are normalized on load.
    """

    def __init__(
        self,
        feat_dir: str,
        key: str = "features",
        normalize: bool = True,
        h5_cache_path: Optional[str] = None,
        cache_keys: Optional[Sequence] = None,
    ):
        from univtg_tpu_torch.native.reader import native_io_enabled

        self.feat_dir = feat_dir
        self.key = key
        self.normalize = normalize
        # native C++ reader (zip parse + inflate + fused L2 norm, GIL-free):
        # opt-in via UNIVTG_NATIVE_IO=1; a file it rejects is read by the
        # numpy path
        self.native = native_io_enabled()
        self.cache = None
        if h5_cache_path and os.path.exists(h5_cache_path):
            import h5py

            with h5py.File(h5_cache_path, "r") as f:
                keys = cache_keys if cache_keys is not None else list(f.keys())
                self.cache = {}
                for k in keys:
                    if str(k) in f:
                        self.cache[str(k)] = f[str(k)][:]

    def get(self, fid) -> Optional[np.ndarray]:
        if self.cache is not None:
            return self.cache.get(str(fid))
        path = os.path.join(self.feat_dir, f"{fid}.npz")
        if self.native and os.path.exists(path):
            from univtg_tpu_torch.native.reader import read_npz

            feat = read_npz(path, key=self.key, normalize=self.normalize)
            if feat is not None:
                return feat
            # fall through: numpy reads what the native reader rejected
        try:
            feat = np.load(path)[self.key].astype(np.float32)
        except (OSError, KeyError, ValueError):
            return None
        if self.normalize:
            feat = l2_normalize(feat)
        return feat


def load_video_features(sources: Sequence[FeatureSource], vid) -> Optional[np.ndarray]:
    """Concatenate multi-backbone features on the channel dim after
    truncating to the shortest stream (main/dataset.py:680-696)."""
    feats = []
    for src in sources:
        f = src.get(vid)
        if f is None:
            return None
        feats.append(f)
    min_len = min(len(f) for f in feats)
    return np.concatenate([f[:min_len] for f in feats], axis=1)
