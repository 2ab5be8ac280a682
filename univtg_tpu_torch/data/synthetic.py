"""Synthetic corpus generators; copies of
``univtg_tpu/data/synthetic.py:create_synthetic_mr_corpus``,
``create_synthetic_hl_corpus`` (TVSum/YouTube-HL style),
``write_tags_mat`` and ``create_synthetic_qfvs_corpus`` (UT-Egocentric
style). The QFVS grids go through ``write_video_grid``, the one function
that imports h5py.

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


def write_tags_mat(path: str, videos_tag) -> str:
    """Write per-video shot-tag matrices in the eval/Tags.mat cell nesting
    that evals.qfvs_metric.load_videos_tag reads (Tags{1,V}{1,S}{1,1} ->
    concept vector)."""
    import scipy.io

    vids = np.empty((1, len(videos_tag)), dtype=object)
    for i, tags in enumerate(videos_tag):
        tags = np.asarray(tags)
        shots = np.empty((1, len(tags)), dtype=object)
        for s in range(len(tags)):
            cell = np.empty((1, 1), dtype=object)
            cell[0, 0] = tags[s]
            shots[0, s] = cell
        vids[0, i] = shots
    scipy.io.savemat(path, {"Tags": vids})
    return path


def write_video_grid(path: str, features: np.ndarray, seg_len: np.ndarray) -> None:
    """One video's (S, F, D) feature grid and (S,) valid frame counts as
    the h5 file data/qfvs.load_video_grid reads."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("features", data=features)
        f.create_dataset("seg_len", data=seg_len.astype(np.int64))


def create_synthetic_qfvs_corpus(
    root: str,
    videos=(1, 2, 3, 4),
    concepts=("Car", "Tree", "Food", "Sky"),
    max_segment_num: int = 4,
    max_frame_num: int = 16,
    v_dim: int = 32,
    q_dim: int = 16,
    vid_feature: str = "fps1",
    txt_feature: str = "query",
    seed: int = 0,
):
    """UT-Egocentric-style tree: h5 segment grids, per-shot tags, oracle
    summaries of the concept pairs of the first three concepts, the concept
    embeddings pickle (3 tokens each) and Tags.mat."""
    import itertools
    import pickle

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "processed"), exist_ok=True)
    os.makedirs(os.path.join(root, "txt_clip"), exist_ok=True)

    emb = {c: rng.standard_normal((3, q_dim)).astype(np.float32) for c in concepts}
    with open(os.path.join(root, "txt_clip", f"{txt_feature}.pkl"), "wb") as f:
        pickle.dump(emb, f)

    videos_tag = []
    for v in videos:
        seg_len = rng.integers(max_frame_num // 2, max_frame_num + 1, max_segment_num)
        n_shots = int(seg_len.sum())
        tags_bin = (rng.uniform(0, 1, (n_shots, len(concepts))) > 0.6).astype(int)
        tags_bin[tags_bin.sum(1) == 0, 0] = 1
        videos_tag.append(tags_bin)

        features = np.zeros((max_segment_num, max_frame_num, v_dim), np.float32)
        shot = 0
        for j, n in enumerate(seg_len):
            for k in range(int(n)):
                x = 0.3 * rng.standard_normal(v_dim).astype(np.float32)
                for ci, c in enumerate(concepts):
                    if tags_bin[shot, ci]:
                        x[:q_dim] += emb[c].mean(0)
                features[j, k] = x
                shot += 1
        write_video_grid(os.path.join(root, "processed", f"P0{v}_{vid_feature}.h5"),
                         features, seg_len)

        tag_dir = os.path.join(
            root, "metadata/origin_data/Dense_per_shot_tags", f"P0{v}"
        )
        os.makedirs(tag_dir, exist_ok=True)
        with open(os.path.join(tag_dir, f"P0{v}.txt"), "w") as f:
            for s in range(n_shots):
                f.write(",".join(c for ci, c in enumerate(concepts) if tags_bin[s, ci]) + "\n")

        odir = os.path.join(
            root, "metadata/origin_data/Query-Focused_Summaries/Oracle_Summaries", f"P0{v}"
        )
        os.makedirs(odir, exist_ok=True)
        for c1, c2 in itertools.combinations(concepts[:3], 2):
            ci1, ci2 = concepts.index(c1), concepts.index(c2)
            hits = np.flatnonzero(tags_bin[:, ci1] | tags_bin[:, ci2])
            pick = hits[: max(2, len(hits) // 4)]
            with open(os.path.join(odir, f"{c1}_{c2}_oracle.txt"), "w") as f:
                f.write("\n".join(str(int(s) + 1) for s in pick))
    tags_mat_path = write_tags_mat(os.path.join(root, "Tags.mat"), videos_tag)
    return {
        "root": root,
        "videos_tag": videos_tag,
        "concepts": concepts,
        "tags_mat_path": tags_mat_path,
    }
