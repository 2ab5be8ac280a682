#!/usr/bin/env python
"""Reproduce the reference model zoo's QVHighlights numbers from a released
PyTorch checkpoint (model.md:19-20) with the port's evaluator; the port's
copy of ``scripts/reproduce_model_md.py``.

    python -m univtg_tpu_torch.tools.reproduce_model_md [model.attention_impl=pallas] \\
        --resume /path/to/model_best.ckpt \\
        --eval-path /path/to/highlight_val_release.jsonl \\
        --v-feat-dirs /feats/slowfast /feats/clip \\
        --q-feat-dir /feats/clip_text \\
        [--opt-json /path/to/opt.json] [--device cuda]

Expected (model.md:20, w/ PT, val): MR-full-mAP 45.44, HL HIT@1 68.77. The
architecture comes from the run's saved opt.json (beside the checkpoint,
or ``--opt-json``, or the container's 'opt' dict;
interop/torch_ckpt.load_reference_run), then the trailing ``model.key=value``
overrides (``model.attention_impl=pallas`` runs the flash kernels,
``model.compute_dtype=bfloat16`` bf16; give them before ``--v-feat-dirs``,
which takes every word up to the next option); inference mirrors
main/inference_mr.py:87-193 (eval_mode add, no rounding to the clip grid
by default). The headline metrics are scored on the submission before NMS,
the NMS'd copy (``--nms-thd``) under ``metrics_nms``.
"""
import argparse
import dataclasses
import json

from univtg_tpu_torch.models.config import ModelConfig

EXPECTED = {"MR-full-mAP-key": 45.44, "HL-min-VeryGood-Hit1-key": 68.77}


@dataclasses.dataclass(frozen=True)
class _Overridable:
    model: ModelConfig


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--resume", required=True, help="released .ckpt (torch.save)")
    ap.add_argument("--opt-json", default=None, help="saved opt.json (default: next to ckpt)")
    ap.add_argument("--eval-path", required=True, help="QVHL val jsonl with GT")
    ap.add_argument("--v-feat-dirs", nargs="+", required=True)
    ap.add_argument("--q-feat-dir", required=True)
    ap.add_argument("--clip-len", type=float, default=2.0)
    ap.add_argument("--eval-bsz", type=int, default=32)
    ap.add_argument("--eval-mode", default="add")
    # reference inference defaults (scripts/qvhl_inference.sh:41,52): no
    # clip-multiple rounding; NMS at 0.7 reported as secondary metrics
    ap.add_argument("--round-multiple", type=int, default=-1)
    ap.add_argument("--nms-thd", type=float, default=0.7)
    ap.add_argument("--out", default="reproduce_metrics.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("overrides", nargs="*", help="model.key=value, e.g. "
                    "model.attention_impl=pallas")
    return ap


def main(argv=None):
    """Run the reproduction; returns (metrics, the pre-NMS submission)."""
    from univtg_tpu_torch.cli import apply_overrides
    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.loader import Loader
    from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset
    from univtg_tpu_torch.device import resolve_device
    from univtg_tpu_torch.interop import load_reference_run
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.train.infer_mr import apply_nms, evaluate_submission, run_inference

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, state_dict = load_reference_run(args.resume, args.opt_json)
    cfg = apply_overrides(_Overridable(cfg), args.overrides).model
    print(f"restored: hidden={cfg.hidden_dim} layers={cfg.num_layers} "
          f"vid_dim={cfg.vid_dim} txt_dim={cfg.txt_dim} "
          f"attention_impl={cfg.attention_impl} compute_dtype={cfg.compute_dtype}")
    model = UniVTG(cfg, device="meta")
    model.load_state_dict({k: v.to(dev) for k, v in state_dict.items()}, assign=True)

    data_cfg = MRDataConfig(
        dset_name="qvhighlights",
        data_path=args.eval_path,
        v_feat_dirs=tuple(args.v_feat_dirs),
        q_feat_dir=args.q_feat_dir,
        v_feat_dim=cfg.vid_dim - 2,  # pre-TEF
        q_feat_dim=cfg.txt_dim,
        clip_len=args.clip_len,
        max_q_l=cfg.max_q_l,
        max_v_l=cfg.max_v_l,
    )
    ds = MRDataset(data_cfg)
    loader = Loader(
        ds,
        args.eval_bsz,
        lambda items, pad_batch_to: collate_mr(
            items, data_cfg.max_q_l, data_cfg.max_v_l, pad_batch_to
        ),
        shuffle=False,
    )
    submission = run_inference(
        model,
        loader,
        eval_mode=args.eval_mode,
        clip_length=args.clip_len,
        round_multiple=args.round_multiple,
    )
    # the headline metrics on the PRE-NMS submission (the reference scores
    # `submission` at main/inference_mr.py:50 and the NMS'd copy apart at :72)
    metrics = evaluate_submission(submission, ds.data)
    if args.nms_thd > 0:
        nms_submission = apply_nms(submission, args.nms_thd, 10, 10)
        metrics["metrics_nms"] = evaluate_submission(nms_submission, ds.data)["brief"]
    brief = metrics["brief"]
    print(json.dumps(brief, indent=1))
    with open(args.out, "w") as f:
        json.dump(metrics, f, indent=1)
    for k, want in EXPECTED.items():
        got = brief.get(k)
        if got is not None:
            print(f"{k}: got {got:.2f}  (model.md expects {want:.2f}, "
                  f"delta {got - want:+.2f})")
    return metrics, submission


if __name__ == "__main__":
    main()
