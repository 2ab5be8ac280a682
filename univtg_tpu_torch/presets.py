"""Experiment presets of the port: the moment-retrieval preset of
``univtg_tpu/presets.py`` that trains the flagship on QVHighlights, with
the same hyperparameters (the reference's launch script: slowfast 2304 +
CLIP 512 (+2 TEF) video, CLIP 512 text).

In-training evaluation arrives with the ``infer-mr`` slice, so the preset
has no eval split yet (``eval_data=None``); the JAX package's other
presets (Charades, NLQ, TACoS, ActivityNet, DiDeMo) come with it
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

from univtg_tpu_torch.data.mr import MRDataConfig
from univtg_tpu_torch.models.config import ModelConfig
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.train.driver_mr import TrainConfig

SLOWFAST_DIM = 2304
CLIP_DIM = 512
TEF_DIM = 2


def flagship_model(**kw) -> ModelConfig:
    """The released UniVTG architecture (hidden 1024, 4 layers, FFN 1024)."""
    base = dict(
        vid_dim=SLOWFAST_DIM + CLIP_DIM + TEF_DIM,
        txt_dim=CLIP_DIM,
        hidden_dim=1024,
        num_layers=4,
        num_heads=8,
        ffn_dim=1024,
        droppath=0.1,
        input_dropout=0.5,
        max_v_l=75,
        max_q_l=32,
    )
    base.update(kw)
    return ModelConfig(**base)


def qvhighlights_mr(data_root="data/qvhighlights",
                    results_dir="results/mr-qvhighlights", **kw):
    """QVHighlights MR+HL fine-tuning (scripts/qvhl_pretrain.sh: bsz 32,
    lr 1e-4, 200 epochs, b10/g1/f10/s0.1, eval_mode add, nms 0.7). ``kw``:
    dotted overrides of the TrainConfig."""
    cfg = TrainConfig(
        model=flagship_model(),
        train_data=MRDataConfig(
            dset_name="qvhighlights",
            data_path=f"{data_root}/metadata/qvhighlights_train.jsonl",
            v_feat_dirs=(f"{data_root}/vid_slowfast", f"{data_root}/vid_clip"),
            q_feat_dir=f"{data_root}/txt_clip",
            v_feat_dim=SLOWFAST_DIM + CLIP_DIM,
            q_feat_dim=CLIP_DIM,
            clip_len=2.0,
            max_q_l=32,
            max_v_l=75,
        ),
        results_dir=results_dir,
        bsz=32,
        n_epoch=200,
        lr=1e-4,
        lr_drop=200,
        lr_warmup=10,
        weights=LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1),
        eval_mode="add",
        nms_thd=0.7,
        main_metric="MR-full-mAP",
    )
    for k, v in kw.items():
        cfg = _replace(cfg, k, v)
    return cfg


def _replace(cfg, key, value):
    """dataclasses.replace along a dotted path (``model.hidden_dim``)."""
    if "." in key:
        head, rest = key.split(".", 1)
        sub = _replace(getattr(cfg, head), rest, value)
        return dataclasses.replace(cfg, **{head: sub})
    if key not in {f.name for f in dataclasses.fields(cfg)}:
        raise KeyError(f"unknown config field {key}")
    return dataclasses.replace(cfg, **{key: value})


PRESETS = {"qvhighlights_mr": qvhighlights_mr}
