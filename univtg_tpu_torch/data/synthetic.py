"""Synthetic corpus generators; copies of
``univtg_tpu/data/synthetic.py:create_synthetic_mr_corpus`` and
``create_synthetic_hl_corpus`` (TVSum/YouTube-HL style).

Produces jsonl metadata + per-id npz feature dirs with a *learnable* signal:
inside the GT window, video features point toward the query embedding; the
saliency annotator scores follow the same signal. The same seed writes the
same corpus as the JAX package's generators."""
from __future__ import annotations

import json
import os

import numpy as np


def create_synthetic_mr_corpus(
    root: str,
    n_train: int = 64,
    n_val: int = 32,
    v_dim: int = 64,
    q_dim: int = 32,
    clip_len: float = 2.0,
    max_clips: int = 75,
    seed: int = 0,
):
    rng = np.random.default_rng(seed)
    vid_dir = os.path.join(root, "vid_feat")
    txt_dir = os.path.join(root, "txt_feat")
    os.makedirs(vid_dir, exist_ok=True)
    os.makedirs(txt_dir, exist_ok=True)

    def make_split(name, n, qid0):
        rows = []
        for i in range(n):
            qid = qid0 + i
            vid = f"synt_{name}_{i}"
            n_clips = int(rng.integers(max_clips // 2, max_clips + 1))
            duration = n_clips * clip_len
            st_clip = int(rng.integers(0, n_clips - 4))
            ed_clip = int(rng.integers(st_clip + 2, min(st_clip + 12, n_clips)))
            window = [st_clip * clip_len, (ed_clip + 1) * clip_len]

            q = rng.standard_normal(q_dim).astype(np.float32)
            q_tokens = q[None] + 0.1 * rng.standard_normal((6, q_dim)).astype(np.float32)
            feats = 0.5 * rng.standard_normal((n_clips, v_dim)).astype(np.float32)
            # inject query-aligned signal inside the window
            proj = np.zeros(v_dim, np.float32)
            proj[: q_dim] = q
            feats[st_clip : ed_clip + 1] += proj
            np.savez(os.path.join(vid_dir, f"{vid}.npz"), features=feats)
            np.savez(os.path.join(txt_dir, f"{qid}.npz"), last_hidden_state=q_tokens)

            rel_ids = list(range(st_clip, ed_clip + 1))
            sal = [[4, 3, 4] for _ in rel_ids]
            rows.append(
                {
                    "qid": qid,
                    "query": f"synthetic query {qid}",
                    "duration": duration,
                    "vid": vid,
                    "relevant_clip_ids": rel_ids,
                    "relevant_windows": [window],
                    "saliency_scores": sal,
                }
            )
        path = os.path.join(root, f"{name}.jsonl")
        with open(path, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows))
        return path

    train_path = make_split("train", n_train, 0)
    val_path = make_split("val", n_val, 100000)
    return {
        "train_path": train_path,
        "val_path": val_path,
        "v_feat_dirs": [vid_dir],
        "q_feat_dir": txt_dir,
        "v_dim": v_dim,
        "q_dim": q_dim,
        "clip_len": clip_len,
        "max_clips": max_clips,
    }


def create_synthetic_hl_corpus(
    root: str,
    dset_name: str = "tvsum",
    n_train: int = 8,
    n_val: int = 4,
    v_dim: int = 64,
    q_dim: int = 32,
    max_clips: int = 60,
    seed: int = 0,
):
    """TVSum/YouTube-style corpus: annotations json + feature dirs + a
    single-domain split table."""
    rng = np.random.default_rng(seed)
    vid_dir = os.path.join(root, "hl_vid")
    txt_dir = os.path.join(root, "hl_txt")
    os.makedirs(vid_dir, exist_ok=True)
    os.makedirs(txt_dir, exist_ok=True)

    label, train_ids, val_ids = {}, [], []
    for i in range(n_train + n_val):
        vid = f"hlv_{i}"
        n = int(rng.integers(max_clips // 2, max_clips + 1))
        q = rng.standard_normal(q_dim).astype(np.float32)
        feats = 0.5 * rng.standard_normal((n, v_dim)).astype(np.float32)
        highlight = rng.uniform(0, 1, n) > 0.75
        if not highlight.any():
            highlight[int(rng.integers(0, n))] = True
        proj = np.zeros(v_dim, np.float32)
        proj[: q_dim] = q
        feats[highlight] += proj
        np.savez(os.path.join(vid_dir, f"{vid}.npz"), features=feats)
        np.savez(
            os.path.join(txt_dir, f"{vid}.npz"),
            last_hidden_state=q[None] + 0.1 * rng.standard_normal((4, q_dim)).astype(np.float32),
        )
        if dset_name == "tvsum":
            base = np.where(highlight[:, None], 4.0, 1.0)
            anno = base + rng.normal(0, 0.5, (n, 20))
            label[vid] = {
                "anno": anno.tolist(),
                "frames": n * 32,
                "fps": 16,
                "domain": "SYN",
                "title": f"synthetic {vid}",
            }
        else:
            label[vid] = {
                "match": highlight.astype(float).tolist(),
                "clip": list(range(n)),
                "frames": n * 32,
                "fps": 16,
                "domain": "SYN",
            }
        (train_ids if i < n_train else val_ids).append(vid)

    anno_path = os.path.join(root, f"{dset_name}_anno.json")
    with open(anno_path, "w") as f:
        json.dump(label, f)
    splits_path = os.path.join(root, f"{dset_name}_splits.json")
    with open(splits_path, "w") as f:
        json.dump({"SYN": {"train": train_ids, "val": val_ids}}, f)
    return {
        "anno_path": anno_path,
        "splits_path": splits_path,
        "v_feat_dirs": [vid_dir],
        "q_feat_dir": txt_dir,
        "v_dim": v_dim,
        "q_dim": q_dim,
        "max_clips": max_clips,
    }
