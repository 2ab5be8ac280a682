"""Experiment presets of the port: the moment-retrieval presets of
``univtg_tpu/presets.py`` (QVHighlights, Charades-STA, Ego4D-NLQ, TACoS,
ActivityNet, DiDeMo), each with its train and eval split and the same
hyperparameters (the reference's launch scripts: slowfast 2304 + CLIP 512
(+2 TEF) video, CLIP 512 text), the highlight-detection presets
(``youtube_hl``, ``tvsum_hl``), QFVS (``qfvs``: CLIP 512 + 2 TEF over 200
frames per segment) and the multi-corpus pretraining presets
(``vlp_pretrain``, ``cotrain``).
"""
from __future__ import annotations

import dataclasses

from univtg_tpu_torch.data.hl import HLDataConfig
from univtg_tpu_torch.data.mr import MRDataConfig
from univtg_tpu_torch.data.qfvs import QFVSDataConfig
from univtg_tpu_torch.models.config import ModelConfig
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.train.driver_hl import HLTrainConfig
from univtg_tpu_torch.train.driver_mr import TrainConfig
from univtg_tpu_torch.train.driver_qfvs import QFVSTrainConfig

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
    data = dict(
        dset_name="qvhighlights",
        v_feat_dirs=(f"{data_root}/vid_slowfast", f"{data_root}/vid_clip"),
        q_feat_dir=f"{data_root}/txt_clip",
        v_feat_dim=SLOWFAST_DIM + CLIP_DIM,
        q_feat_dim=CLIP_DIM,
        clip_len=2.0,
        max_q_l=32,
        max_v_l=75,
    )
    cfg = TrainConfig(
        model=flagship_model(),
        train_data=MRDataConfig(
            data_path=f"{data_root}/metadata/qvhighlights_train.jsonl", **data
        ),
        eval_data=MRDataConfig(
            data_path=f"{data_root}/metadata/qvhighlights_val.jsonl", **data
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


def _downstream_mr(dset_name, data_root, results_dir, clip_len, main_metric,
                   train_name="train.jsonl", val_name="val.jsonl", **kw):
    """Shared downstream MR template (Charades-STA / Ego4D-NLQ / TACoS /
    ActivityNet / DiDeMo)."""
    data = dict(
        dset_name=dset_name,
        v_feat_dirs=(f"{data_root}/vid_slowfast", f"{data_root}/vid_clip"),
        q_feat_dir=f"{data_root}/txt_clip",
        v_feat_dim=SLOWFAST_DIM + CLIP_DIM,
        q_feat_dim=CLIP_DIM,
        clip_len=clip_len,
        max_q_l=32,
        max_v_l=75,
    )
    cfg = TrainConfig(
        model=flagship_model(),
        train_data=MRDataConfig(data_path=f"{data_root}/metadata/{train_name}", **data),
        eval_data=MRDataConfig(data_path=f"{data_root}/metadata/{val_name}", **data),
        results_dir=results_dir,
        bsz=32,
        n_epoch=100,
        lr=1e-4,
        lr_drop=100,
        lr_warmup=10,
        weights=LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1),
        eval_mode="add",
        main_metric=main_metric,
    )
    for k, v in kw.items():
        cfg = _replace(cfg, k, v)
    return cfg


def charades_mr(data_root="data/charades", results_dir="results/mr-charades", **kw):
    return _downstream_mr(
        "charades", data_root, results_dir, clip_len=1.0,
        main_metric="MR-full-R1@0.5",
        train_name="charades_train.jsonl", val_name="charades_test.jsonl", **kw,
    )


def nlq_mr(data_root="data/ego4d", results_dir="results/mr-nlq", **kw):
    return _downstream_mr(
        "ego4d", data_root, results_dir, clip_len=2.0,
        main_metric="MR-full-R1@0.3",
        train_name="nlq_train.jsonl", val_name="nlq_val.jsonl", **kw,
    )


def tacos_mr(data_root="data/tacos", results_dir="results/mr-tacos", **kw):
    return _downstream_mr(
        "tacos", data_root, results_dir, clip_len=2.0,
        main_metric="MR-full-R1@0.3", **kw,
    )


def anet_mr(data_root="data/anet", results_dir="results/mr-anet", **kw):
    return _downstream_mr(
        "activitynet", data_root, results_dir, clip_len=2.0,
        main_metric="MR-full-R1@0.5", **kw,
    )


def didemo_mr(data_root="data/didemo", results_dir="results/mr-didemo", **kw):
    return _downstream_mr(
        "didemo", data_root, results_dir, clip_len=2.0,
        main_metric="MR-full-R1@0.5", **kw,
    )


def _hl(dset_name, data_root, results_dir, **kw) -> HLTrainConfig:
    """The HL template: the flagship on 2304 + 512 + 2 = 2818-d video, bsz
    4, lr 1e-4, 200 epochs, labels + saliency (b=0, g=0, f=10,
    s_intra=0.1, s_inter=0.1)."""
    cfg = HLTrainConfig(
        model=flagship_model(vid_dim=SLOWFAST_DIM + CLIP_DIM + TEF_DIM),
        data=HLDataConfig(
            dset_name=dset_name,
            anno_path=f"{data_root}/{dset_name}_anno.json",
            v_feat_dirs=(f"{data_root}/vid_slowfast", f"{data_root}/vid_clip"),
            q_feat_dir=f"{data_root}/txt_clip",
        ),
        results_dir=results_dir,
        bsz=4,
        n_epoch=200,
        lr=1e-4,
        weights=LossWeights(b=0, g=0, f=10, s_intra=0.1, s_inter=0.1),
    )
    for k, v in kw.items():
        cfg = _replace(cfg, k, v)
    return cfg


def youtube_hl(data_root="data/youtube", results_dir="results/hl-youtube", **kw):
    return _hl("youtube", data_root, results_dir, **kw)


def tvsum_hl(data_root="data/tvsum", results_dir="results/hl-tvsum", **kw):
    return _hl("tvsum", data_root, results_dir, **kw)


def qfvs(data_root="data/qfvs", results_dir="results/qfvs", **kw) -> QFVSTrainConfig:
    """QFVS on UT-Egocentric (main/train_qfvs.py): the flagship on CLIP 512
    + 2 TEF video over 200 frames per segment, 20 epochs, leave-one-out
    over the 4 videos."""
    cfg = QFVSTrainConfig(
        model=flagship_model(
            vid_dim=CLIP_DIM + TEF_DIM, max_v_l=200, hidden_dim=1024
        ),
        data=QFVSDataConfig(root=data_root),
        tags_mat_path="data/ute_query/Tags.mat",
        results_dir=results_dir,
        n_epoch=20,
    )
    for k, v in kw.items():
        cfg = _replace(cfg, k, v)
    return cfg


def vlp_pretrain(data_root="data", results_dir="results/vlp-pretrain", **kw):
    """Large-scale point+interval+curve pretraining (scripts/pretrain.sh:
    bsz 64, 10 epochs, hidden 1024, Ego4D point + VideoCC interval/curve;
    corpus jsonl paths follow the reference vlp_mapping,
    main/dataset.py:66-97)."""
    from univtg_tpu_torch.data.vlp import VLPCorpusSpec, VLPDataConfig
    from univtg_tpu_torch.train.driver_vlp import VLPTrainConfig

    def corpus(rel_jsonl, dset, ftype, v_suffix="", q_suffix=""):
        return VLPCorpusSpec(
            data_path=f"{data_root}/{rel_jsonl}",
            dset_name=dset,
            v_feat_dirs=(
                f"{data_root}/{dset}/vid_slowfast{v_suffix}",
                f"{data_root}/{dset}/vid_clip{v_suffix}",
            ),
            q_feat_dir=f"{data_root}/{dset}/txt_clip{q_suffix}",
            type=ftype,
        )

    cfg = VLPTrainConfig(
        model=flagship_model(),
        vlp_data=VLPDataConfig(
            corpora=(
                corpus("ego4d/metadata/point_egoclip_wo_val.jsonl", "ego4d", "point",
                       "_point", "_point"),
                corpus("videocc/metadata/interval_900k.jsonl", "videocc", "interval"),
                corpus("videocc/metadata/curve_5_window.jsonl", "videocc", "curve",
                       "", "_concept"),
            ),
            v_feat_dim=SLOWFAST_DIM + CLIP_DIM,
            q_feat_dim=CLIP_DIM,
            txt_drop_ratio=0.1,
        ),
        train_data=None,
        eval_data=_zero_shot_qvhighlights(data_root),
        results_dir=results_dir,
        bsz=64,
        n_epoch=10,
        lr=1e-4,
        lr_warmup=1,
        lr_drop=200,
        weights=LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1),
        eval_mode="add",
        max_es_cnt=-1,
    )
    for k, v in kw.items():
        cfg = _replace(cfg, k, v)
    return cfg


def _zero_shot_qvhighlights(data_root) -> MRDataConfig:
    """The QVHighlights val split the pretraining presets evaluate
    zero-shot (train_vlp_ddp.py:246-259)."""
    return MRDataConfig(
        dset_name="qvhighlights",
        data_path=f"{data_root}/qvhighlights/metadata/qvhighlights_val.jsonl",
        v_feat_dirs=(
            f"{data_root}/qvhighlights/vid_slowfast",
            f"{data_root}/qvhighlights/vid_clip",
        ),
        q_feat_dir=f"{data_root}/qvhighlights/txt_clip",
        v_feat_dim=SLOWFAST_DIM + CLIP_DIM,
        q_feat_dim=CLIP_DIM,
    )


def cotrain(data_root="data", results_dir="results/cotrain", resume="", **kw):
    """Multi-corpus downstream co-training (scripts/cotrain.sh: 6 corpora,
    100 epochs, resume from pretraining). Corpus types follow vlp_mapping
    (main/dataset.py:77-96): qvhighlights=curve, the rest=interval;
    Charades at 1 s clips."""
    from univtg_tpu_torch.data.vlp import VLPCorpusSpec, VLPDataConfig
    from univtg_tpu_torch.train.driver_vlp import VLPTrainConfig

    def corpus(dset, jsonl, ftype, clip_len=2.0):
        return VLPCorpusSpec(
            data_path=f"{data_root}/{dset}/metadata/{jsonl}",
            dset_name=dset,
            v_feat_dirs=(
                f"{data_root}/{dset}/vid_slowfast",
                f"{data_root}/{dset}/vid_clip",
            ),
            q_feat_dir=f"{data_root}/{dset}/txt_clip",
            type=ftype,
            clip_len=clip_len,
        )

    cfg = VLPTrainConfig(
        model=flagship_model(),
        vlp_data=VLPDataConfig(
            corpora=(
                corpus("qvhighlights", "qvhighlights_train.jsonl", "curve"),
                corpus("charades", "charades_train.jsonl", "interval", 1.0),
                corpus("ego4d", "nlq_train.jsonl", "interval"),
                corpus("tacos", "train.jsonl", "interval"),
                corpus("anet", "train.jsonl", "interval"),
                corpus("didemo", "train.jsonl", "interval"),
            ),
            v_feat_dim=SLOWFAST_DIM + CLIP_DIM,
            q_feat_dim=CLIP_DIM,
            txt_drop_ratio=0.1,
        ),
        train_data=None,
        eval_data=_zero_shot_qvhighlights(data_root),
        results_dir=results_dir,
        bsz=64,
        n_epoch=100,
        lr=1e-4,
        lr_warmup=1,
        lr_drop=200,
        weights=LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1),
        eval_mode="add",
        max_es_cnt=-1,
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


PRESETS = {
    "qvhighlights_mr": qvhighlights_mr,
    "charades_mr": charades_mr,
    "nlq_mr": nlq_mr,
    "tacos_mr": tacos_mr,
    "anet_mr": anet_mr,
    "didemo_mr": didemo_mr,
    "youtube_hl": youtube_hl,
    "tvsum_hl": tvsum_hl,
    "qfvs": qfvs,
    "vlp_pretrain": vlp_pretrain,
    "cotrain": cotrain,
}
