#!/usr/bin/env python
"""Synthetic end-to-end validation: train the grounding model on a planted
signal until the MR metrics recover it; the port's copy of
``scripts/validate_synthetic.py``.

The synthetic corpus injects query-aligned features inside each GT window
(data/synthetic.py), so a correct pipeline must reach high R1@0.5 / mIoU:
the run passes at R1@0.5 > 50 and mIoU > 50. Same arguments, corpus, model,
TrainConfig and loss weights as the JAX script, and ``--device`` (default
cuda):

    python -m univtg_tpu_torch.tools.validate_synthetic [--epochs 30] [--hidden 128] \
        [--device cpu]

``build(...)`` gives the corpus and the TrainConfig, with ModelConfig fields
overridden by keyword (the card runs the flagship's 8 heads at hidden
1024: the flash kernels take a head dim up to 128), and ``summarize`` the
printed line, for callers that run ``train_mr`` themselves.
"""
import argparse
import dataclasses
import json
import tempfile

from univtg_tpu_torch.data.mr import MRDataConfig
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.models import ModelConfig
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr

BAR = {"R1@0.5": 50.0, "mIoU": 50.0}


def build(root, epochs=30, hidden=128, n_train=256, bsz=32, **model_fields):
    """(corpus, TrainConfig) of the script's run under ``root``."""
    corpus = create_synthetic_mr_corpus(
        root, n_train=n_train, n_val=64, v_dim=64, q_dim=32, seed=0
    )
    model = ModelConfig(
        vid_dim=corpus["v_dim"] + 2,
        txt_dim=corpus["q_dim"],
        hidden_dim=hidden,
        num_layers=2,
        num_heads=4,
        ffn_dim=hidden,
        input_dropout=0.1,
        droppath=0.1,
        max_v_l=corpus["max_clips"],
        max_q_l=10,
    )
    model = dataclasses.replace(model, **model_fields)
    data_kw = dict(
        dset_name="qvhighlights",
        v_feat_dirs=corpus["v_feat_dirs"],
        q_feat_dir=corpus["q_feat_dir"],
        q_feat_dim=corpus["q_dim"],
        v_feat_dim=corpus["v_dim"],
        max_q_l=10,
        max_v_l=corpus["max_clips"],
    )
    cfg = TrainConfig(
        model=model,
        train_data=MRDataConfig(data_path=corpus["train_path"], **data_kw),
        eval_data=MRDataConfig(data_path=corpus["val_path"], **data_kw),
        results_dir=f"{root}/run",
        bsz=bsz,
        eval_bsz=32,
        n_epoch=epochs,
        eval_epoch=5,
        lr=3e-4,
        lr_warmup=3,
        lr_drop=1000,
        weights=LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1),
        save_interval=-1,
        max_es_cnt=1000,
    )
    return corpus, cfg


def summarize(metrics, best) -> dict:
    """The script's JSON line from train_mr's (metrics, best checkpoint)."""
    brief = metrics["brief"]
    return {
        "R1@0.5": brief["MR-full-R1@0.5-key"],
        "R1@0.7": brief["MR-full-R1@0.7-key"],
        "mAP": brief["MR-full-mAP-key"],
        "mIoU": brief["MR-full-mIoU-key"],
        "HL-VeryGood-mAP": brief["HL-min-VeryGood-mAP-key"],
        "best_ckpt": best,
    }


def passed(line: dict) -> bool:
    return all(line[k] > v for k, v in BAR.items())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--n-train", type=int, default=256)
    ap.add_argument("--bsz", type=int, default=32)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    root = tempfile.mkdtemp(prefix="univtg_synth_")
    _, cfg = build(root, args.epochs, args.hidden, args.n_train, args.bsz)
    line = summarize(*train_mr(cfg, device=args.device))
    print(json.dumps(line, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    print("VALIDATION", "PASSED" if passed(line) else "WEAK", "(planted signal recovery)")
    return line


if __name__ == "__main__":
    main()
