"""Pack per-id npz feature dirs into one hdf5 per feature type for fast IO;
a copy of ``univtg_tpu/tools/pack_h5.py``.

Reference: data/create_h5py.py:19-72 -- L2 normalization is applied at pack
time, so `FeatureSource` h5 caches skip it on load.
"""
from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np

from univtg_tpu_torch.data.features import l2_normalize, load_jsonl


def pack_feature_dir(
    feat_dir: str,
    out_path: str,
    ids: Optional[Iterable] = None,
    key: str = "features",
    normalize: bool = True,
) -> int:
    """Write {id: l2norm(npz[key])} into out_path. Returns #entries."""
    import h5py

    if ids is None:
        ids = [f[: -len(".npz")] for f in sorted(os.listdir(feat_dir)) if f.endswith(".npz")]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    with h5py.File(out_path, "w") as f:
        for fid in ids:
            path = os.path.join(feat_dir, f"{fid}.npz")
            if not os.path.exists(path):
                continue
            feat = np.load(path)[key].astype(np.float32)
            if normalize:
                feat = l2_normalize(feat)
            f.create_dataset(str(fid), data=feat)
            n += 1
    return n


def pack_dataset(
    metadata_jsonl: str,
    v_feat_dirs,
    q_feat_dir: str,
    out_dir: str,
) -> dict:
    """Pack all feature streams referenced by a metadata jsonl into
    {out_dir}/{feat_type}.hdf5 (the use_cache layout, main/dataset.py:448-467)."""
    rows = load_jsonl(metadata_jsonl)
    vids = sorted({r["vid"] for r in rows})
    qids = sorted({r["qid"] for r in rows})
    out = {}
    for d in v_feat_dirs:
        name = os.path.basename(d.rstrip("/"))
        out[name] = pack_feature_dir(
            d, os.path.join(out_dir, f"{name}.hdf5"), vids, key="features"
        )
    name = os.path.basename(q_feat_dir.rstrip("/"))
    out[name] = pack_feature_dir(
        q_feat_dir,
        os.path.join(out_dir, f"{name}.hdf5"),
        qids,
        key="last_hidden_state",
    )
    return out
