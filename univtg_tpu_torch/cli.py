"""Command-line entry point of the PyTorch port.

  python -m univtg_tpu_torch.cli train-mr --preset qvhighlights_mr \\
      [--resume ckpt] [--device cuda] [key=value ...]
  python -m univtg_tpu_torch.cli infer-mr --preset qvhighlights_mr \\
      --resume model_best.ckpt [--out preds.jsonl] [--device cuda] [key=value ...]
  python -m univtg_tpu_torch.cli train-hl --preset tvsum_hl [--device cuda] \\
      [key=value ...]
  python -m univtg_tpu_torch.cli infer-hl --preset tvsum_hl --ckpt-dir DIR \\
      [--device cuda] [key=value ...]
  python -m univtg_tpu_torch.cli train-qfvs --preset qfvs [--device cuda] \\
      [key=value ...]
  python -m univtg_tpu_torch.cli infer-qfvs --preset qfvs --ckpt-dir DIR \\
      [--device cuda] [key=value ...]
  python -m univtg_tpu_torch.cli train-vlp --preset vlp_pretrain [--resume ckpt] \\
      [--device cuda] [key=value ...]
  python -m univtg_tpu_torch.cli eval --submission preds.jsonl --gt val.jsonl
  python -m univtg_tpu_torch.cli plot --submission preds.jsonl [--gt val.jsonl] \
      --out-dir figs [--paper] [--baseline b.jsonl] [--video-dir D] [--max-queries 20]
  python -m univtg_tpu_torch.cli quantize --preset qvhighlights_mr \\
      --resume model_best.ckpt --out model_int8.ckpt [key=value ...]
  python -m univtg_tpu_torch.cli serve --resume model_best.ckpt \\
      [--config model.json] [--clip-ckpt ViT-B-32.pt] [--device cuda] [--port 8008] ...
  python -m univtg_tpu_torch.cli ground --preset qvhighlights_mr \\
      --resume model_best.ckpt --clip-ckpt ViT-B-32.pt --video v.mp4 \\
      --query "..." [--device cuda] model.vid_dim=514 model.txt_dim=512 [key=value ...]
  python -m univtg_tpu_torch.cli extract-text --metadata val.jsonl \\
      --clip-ckpt ViT-B-32.pt --out-dir data/x/txt_clip [--device cuda]
  python -m univtg_tpu_torch.cli pack-h5 --metadata train.jsonl \\
      --v-feat-dirs data/x/vid_slowfast data/x/vid_clip \\
      --q-feat-dir data/x/txt_clip --out-dir data/x/h5py

``train-mr``, ``infer-mr``, ``train-hl``, ``infer-hl``, ``train-qfvs``,
``infer-qfvs``, ``train-vlp`` and ``quantize`` take a preset
(univtg_tpu_torch/presets.py) and dotted ``key=value`` overrides of its
TrainConfig (HLTrainConfig for the HL commands, QFVSTrainConfig for QFVS,
VLPTrainConfig for ``train-vlp``), e.g.
``bsz=16 model.attention_impl=pallas eval_data=None``; values parse as
Python literals, else stay strings. ``infer-mr`` scores the preset's eval
split and writes the submission jsonl; ``train-hl`` trains a model per
highlight-detection domain and prints the best mAPs; ``infer-hl`` scores
the ``model_{domain}_best.ckpt`` files of ``--ckpt-dir``; ``train-qfvs``
trains a model per leave-one-out split and prints each split's best F/R/P
and AVG_F; ``infer-qfvs`` scores the ``model_V{n}_best.ckpt`` files of
``--ckpt-dir``; ``train-vlp`` pretrains on the preset's corpora with the
per-sample loss gates, in one process (across processes, each process
calls ``train/driver_vlp.init_distributed`` and then ``train_vlp``; the
``tp=``, ``ep=`` and ``model.seq_shard=`` overrides lay a world of dp * tp
* ep ranks out as parallel/mesh.py says);
``eval`` scores a submission file against ground truth; ``plot`` draws
per-query figures of a submission ({qid}.png, or with ``--paper`` the
paper's figure sets: a directory per query with 1_mr.jpg, 2_hl.jpg and
combined.jpg), with matplotlib, imported only there; ``quantize`` writes an int8 serving
checkpoint. ``serve --resume`` takes an upstream-format torch checkpoint
({'model': state_dict}), such as the ``model_best.ckpt`` that train-mr
writes, or an int8 checkpoint from ``quantize`` (told apart by its keys);
``--config`` a ModelConfig JSON (the same JSON the JAX package writes),
defaulting to the flagship with attention_impl="pallas", the hand-written
CUDA flash kernels; with ``--clip-ckpt`` (a released CLIP ``.pt``) the
server also takes raw videos and text queries. ``ground`` grounds one text
query in one raw video (the upstream demo's path: decode, CLIP towers,
UniVTG) and prints the answer and its JSON; its model comes from
``--preset`` and overrides, and CLIP video features are 512-d plus 2 TEF
dims, so a model for raw video takes ``model.vid_dim=514
model.txt_dim=512``; ``--resume`` takes what ``serve --resume`` takes.
``extract-text`` writes the CLIP token features of every query of a
metadata jsonl as ``{qid}.npz``. The commands that run a model run on CUDA
unless ``--device cpu`` is given. ``pack-h5`` packs the feature dirs a metadata
jsonl references into ``{out_dir}/{dir name}.hdf5`` caches
(tools/pack_h5.py), L2-normalized, which ``MRDataConfig.h5_cache_dir``
reads.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import signal

from univtg_tpu_torch.models.config import ModelConfig


def flagship_config(**kw) -> ModelConfig:
    """The flagship (presets.flagship_model: 2818-d video and 512-d text
    features, hidden 1024, 4 layers, 8 heads, FFN 1024, 75 clips and 32
    tokens) on the hand-written flash kernels."""
    from univtg_tpu_torch.presets import flagship_model

    return flagship_model(**{"attention_impl": "pallas", **kw})


def apply_overrides(cfg, pairs):
    """Apply dotted ``key=value`` overrides to a TrainConfig. A value is a
    Python literal (``4``, ``1.25``, ``True``, ``('a',)``), ``true`` /
    ``false`` in any case, or else the string as written."""
    from univtg_tpu_torch.presets import _replace

    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise SystemExit(f"override {pair!r} is not key=value")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = {"true": True, "false": False}.get(raw.lower(), raw)
        cfg = _replace(cfg, key, value)
    return cfg


def _preset_cfg(args):
    from univtg_tpu_torch.presets import PRESETS

    return apply_overrides(PRESETS[args.preset](), args.overrides)


def restored_model(cfg, path, device):
    """UniVTG(cfg.model) on ``device`` holding a float checkpoint's weights
    (train/checkpoint.restore_params checks every key and shape)."""
    from univtg_tpu_torch.device import resolve_device
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.train import checkpoint as ckpt

    dev = resolve_device(device)
    model = UniVTG(cfg.model, device="meta")
    params = ckpt.restore_params(path, model.state_dict(), cfg.model)
    model.load_state_dict({k: v.to(dev) for k, v in params.items()}, assign=True)
    return model


def cmd_train_mr(args):
    """Moment-retrieval training (train/driver_mr.py)."""
    from univtg_tpu_torch.train.driver_mr import train_mr

    metrics, best = train_mr(_preset_cfg(args), resume=args.resume,
                             device=args.device)
    print(json.dumps(metrics.get("brief", {}), indent=1))
    print(f"best checkpoint: {best}")


def cmd_infer_mr(args):
    """Eval-only run on the preset's eval split (the reference's
    start_inference, upstream main/inference_mr.py:224-269), through the
    inference of in-training evaluation: the same loader, and the eval-side
    transfer precision (default f32), not the training-throughput
    compression."""
    from univtg_tpu_torch.data.features import save_jsonl
    from univtg_tpu_torch.data.mr import MRDataset
    from univtg_tpu_torch.train.driver_mr import _run_eval_shard
    from univtg_tpu_torch.train.infer_mr import evaluate_submission
    from univtg_tpu_torch.train.steps import make_eval_step

    cfg = _preset_cfg(args)
    model = restored_model(cfg, args.resume, args.device)
    eval_ds = MRDataset(cfg.eval_data)
    submission = _run_eval_shard(cfg, model, eval_ds, make_eval_step(cfg.eval_mode))
    save_jsonl(submission, args.out or "inference_preds.jsonl")
    metrics = evaluate_submission(submission, eval_ds.data)
    print(json.dumps(metrics["brief"], indent=1))


def cmd_train_hl(args):
    """Highlight-detection training, one model per domain (train/driver_hl.py)."""
    from univtg_tpu_torch.train.driver_hl import train_hl

    print(json.dumps(train_hl(_preset_cfg(args), device=args.device), indent=1))


def cmd_infer_hl(args):
    """Per-domain mAP of the best HL checkpoints (the reference's
    main/inference_hl.py)."""
    from univtg_tpu_torch.train.driver_hl import infer_hl

    print(json.dumps(infer_hl(_preset_cfg(args), args.ckpt_dir, device=args.device),
                     indent=1))


def cmd_train_qfvs(args):
    """QFVS training, one model per leave-one-out split (train/driver_qfvs.py)."""
    from univtg_tpu_torch.train.driver_qfvs import train_qfvs

    print(json.dumps(train_qfvs(_preset_cfg(args), device=args.device), indent=1))


def cmd_infer_qfvs(args):
    """Per-split F/R/P of the best QFVS checkpoints (the reference's
    main/inference_qfvs.py)."""
    from univtg_tpu_torch.train.driver_qfvs import infer_qfvs

    print(json.dumps(infer_qfvs(_preset_cfg(args), args.ckpt_dir, device=args.device),
                     indent=1))


def cmd_train_vlp(args):
    """Multi-corpus pretraining in one process (train/driver_vlp.py)."""
    from univtg_tpu_torch.train.driver_vlp import train_vlp

    metrics, best = train_vlp(_preset_cfg(args), resume=args.resume, device=args.device)
    print(json.dumps(metrics.get("brief", {}), indent=1))
    print(f"best checkpoint: {best}")


def cmd_eval(args):
    """Offline submission scorer (upstream eval/eval.py:377-394)."""
    from univtg_tpu_torch.data.features import load_jsonl
    from univtg_tpu_torch.evals import eval_submission

    metrics = eval_submission(load_jsonl(args.submission), load_jsonl(args.gt))
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)


def cmd_plot(args):
    """Per-query figures of a submission (tools/plots.py; matplotlib)."""
    if args.paper:
        if not args.gt:
            raise SystemExit("--paper requires --gt (the comparison needs GT rows)")
        from univtg_tpu_torch.tools.plots import plot_comparison_set

        made = plot_comparison_set(
            args.submission, args.gt, args.out_dir,
            baseline_jsonl=args.baseline, video_dir=args.video_dir,
            max_queries=args.max_queries, template_path=args.template,
        )
        print(f"wrote {len(made)} figure sets to {args.out_dir}")
        return
    from univtg_tpu_torch.tools.plots import plot_submission

    n = plot_submission(
        args.submission, args.gt, args.out_dir, args.max_queries, baseline_jsonl=args.baseline
    )
    print(f"wrote {n} figures to {args.out_dir}")


def cmd_quantize(args):
    """Convert a trained checkpoint into an int8 serving checkpoint."""
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.serve.quantize import save_quantized
    from univtg_tpu_torch.train import checkpoint as ckpt

    cfg = _preset_cfg(args)
    template = UniVTG(cfg.model, device="meta").state_dict()
    save_quantized(args.out, ckpt.restore_params(args.resume, template, cfg.model))
    print(f"wrote int8 checkpoint: {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB)")


def cmd_pack_h5(args):
    """Whole-split h5 feature caches (tools/pack_h5.py)."""
    from univtg_tpu_torch.tools.pack_h5 import pack_dataset

    out = pack_dataset(args.metadata, args.v_feat_dirs, args.q_feat_dir, args.out_dir)
    print(json.dumps(out, indent=1))


def clip_encoder(path, device):
    """A ClipEncoder on ``device`` over the CLIP checkpoint at ``path``."""
    from univtg_tpu_torch.extract.pipeline import ClipEncoder
    from univtg_tpu_torch.interop.clip_ckpt import load_clip_checkpoint

    clip_params, clip_cfg = load_clip_checkpoint(path)
    return ClipEncoder(clip_params, clip_cfg, device=device)


def cmd_ground(args):
    """One video + one query grounded (the upstream demo's path)."""
    from univtg_tpu_torch.serve import GroundingPipeline
    from univtg_tpu_torch.serve.quantize import restore_serving_params

    cfg = _preset_cfg(args)
    pipe = GroundingPipeline(
        cfg.model, restore_serving_params(args.resume, cfg.model),
        clip_encoder=clip_encoder(args.clip_ckpt, args.device), device=args.device,
    )
    result = pipe.ground_video(args.video, args.query)
    print(pipe.describe(result, args.query))
    print(json.dumps({k: v for k, v in result.items() if k != "saliency"}, indent=1))


def cmd_extract_text(args):
    """Offline query-feature dump (upstream run_on_video/text_extractor.py)."""
    from univtg_tpu_torch.data.features import load_jsonl
    from univtg_tpu_torch.extract.pipeline import extract_query_features

    rows = load_jsonl(args.metadata)
    extract_query_features(clip_encoder(args.clip_ckpt, args.device), rows, args.out_dir)
    print(f"wrote {len(rows)} query features to {args.out_dir}")


def cmd_serve(args):
    """HTTP grounding service with dynamic micro-batching."""
    from univtg_tpu_torch.serve import GroundingPipeline, GroundingServer
    from univtg_tpu_torch.serve.quantize import restore_serving_params

    if args.config:
        with open(args.config) as f:
            cfg = ModelConfig.from_json(f.read())
    else:
        cfg = flagship_config()
    # saliency + foreground ranking, as every JAX preset serves
    pipe = GroundingPipeline(
        cfg, restore_serving_params(args.resume, cfg),
        clip_encoder=clip_encoder(args.clip_ckpt, args.device) if args.clip_ckpt else None,
        eval_mode="add", param_dtype=args.param_dtype, device=args.device,
    )
    # POST /reload takes a client-chosen filesystem path, so on a NON-local
    # bind it stays disabled unless --reload-token gates it
    local_hosts = ("127.0.0.1", "localhost", "::1")
    reload_ok = args.host in local_hosts or args.reload_token is not None
    if not reload_ok:
        print(
            f"note: /reload disabled (host {args.host} is non-local and no "
            f"--reload-token was given)"
        )
    server = GroundingServer(
        pipe, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        request_timeout_s=args.request_timeout_s,
        param_loader=(
            (lambda p: restore_serving_params(p, cfg)) if reload_ok else None
        ),
        checkpoint_path=args.resume,
        reload_token=args.reload_token,
    )
    if args.warmup is not None:
        if args.warmup == "default":
            lengths = None
        else:
            try:
                lengths = [int(x) for x in args.warmup.split(",")]
            except ValueError:
                raise SystemExit(
                    f"--warmup takes a comma-separated list of video "
                    f"lengths (e.g. --warmup=128,512), got {args.warmup!r}"
                )
        print("warming the batch ladder before taking traffic...")
        server.warmup(lengths)

    def _sigterm(*_):
        # SIGTERM drains like ctrl-c instead of killing mid-batch
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    print(f"serving on http://{args.host}:{server.port} "
          f"({pipe.device.type})  (ctrl-c to stop)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("draining in-flight requests...")
        server.close(drain_s=args.request_timeout_s)


def build_parser():
    p = argparse.ArgumentParser(prog="univtg_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "torch device; 'cpu' must be asked for explicitly"
    sp = sub.add_parser("train-mr")
    sp.set_defaults(fn=cmd_train_mr)
    sp.add_argument("--preset", required=True)
    sp.add_argument("--resume", default=None)
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("infer-mr")
    sp.set_defaults(fn=cmd_infer_mr)
    sp.add_argument("--preset", required=True)
    sp.add_argument("--resume", required=True)
    sp.add_argument("--out", default=None,
                    help="submission jsonl (default inference_preds.jsonl)")
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("train-hl")
    sp.set_defaults(fn=cmd_train_hl)
    sp.add_argument("--preset", required=True)
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("infer-hl")
    sp.set_defaults(fn=cmd_infer_hl)
    sp.add_argument("--preset", required=True)
    sp.add_argument("--ckpt-dir", required=True)
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("train-qfvs")
    sp.set_defaults(fn=cmd_train_qfvs)
    sp.add_argument("--preset", required=True)
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("infer-qfvs")
    sp.set_defaults(fn=cmd_infer_qfvs)
    sp.add_argument("--preset", required=True)
    sp.add_argument("--ckpt-dir", required=True)
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("train-vlp")
    sp.set_defaults(fn=cmd_train_vlp)
    sp.add_argument("--preset", required=True)
    sp.add_argument("--resume", default=None)
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("eval")
    sp.set_defaults(fn=cmd_eval)
    sp.add_argument("--submission", required=True)
    sp.add_argument("--gt", required=True)
    sp.add_argument("--out", default=None)
    sp = sub.add_parser("plot")
    sp.set_defaults(fn=cmd_plot)
    sp.add_argument("--submission", required=True)
    sp.add_argument("--gt", default=None)
    sp.add_argument("--baseline", default=None)
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--max-queries", type=int, default=20)
    sp.add_argument("--paper", action="store_true",
                    help="paper-style per-query comparison figure sets")
    sp.add_argument("--video-dir", default=None,
                    help="dir of {vid}.mp4 files for the frame strips")
    sp.add_argument("--template", default=None,
                    help="RGBA template PNG composited over each frame "
                         "(the reference's film-strip border)")
    sp = sub.add_parser("quantize")
    sp.set_defaults(fn=cmd_quantize)
    sp.add_argument("--preset", required=True)
    sp.add_argument("--resume", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("overrides", nargs="*")
    sp = sub.add_parser("pack-h5")
    sp.set_defaults(fn=cmd_pack_h5)
    sp.add_argument("--metadata", required=True)
    sp.add_argument("--v-feat-dirs", nargs="+", required=True)
    sp.add_argument("--q-feat-dir", required=True)
    sp.add_argument("--out-dir", required=True)
    sp = sub.add_parser("serve")
    sp.set_defaults(fn=cmd_serve)
    sp.add_argument("--resume", required=True,
                    help="upstream-format torch checkpoint ({'model': ...}) "
                         "or an int8 checkpoint from `quantize`")
    sp.add_argument("--config", default=None,
                    help="ModelConfig JSON (default: the flagship, "
                         "attention_impl='pallas')")
    sp.add_argument("--clip-ckpt", default=None,
                    help="a CLIP .pt: the server then also takes raw videos "
                         "(PUT Content-Type video/*) and text queries")
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8008)
    sp.add_argument("--max-batch", type=int, default=32)
    sp.add_argument("--max-wait-ms", type=float, default=4.0)
    sp.add_argument("--request-timeout-s", type=float, default=600.0)
    sp.add_argument("--reload-token", default=None,
                    help="require this X-Reload-Token header on POST "
                         "/reload (set it whenever --host is not local)")
    sp.add_argument("--param-dtype", default=None,
                    choices=[None, "bfloat16", "float32"],
                    help="cast weights at load; bfloat16 halves weight memory")
    sp.add_argument("--warmup", nargs="?", const="default", default=None,
                    help="run the batch ladder before accepting traffic; "
                         "optionally a comma-separated list of video lengths")
    sp = sub.add_parser(
        "ground", help="ground one text query in one raw video",
        epilog="CLIP video features are 512-d plus 2 TEF dims: a model for raw "
               "video takes the overrides model.vid_dim=514 model.txt_dim=512")
    sp.set_defaults(fn=cmd_ground)
    sp.add_argument("--preset", required=True)
    sp.add_argument("--resume", required=True,
                    help="what serve --resume takes: an upstream .ckpt, an int8 "
                         "file, or the JAX package's msgpack (float or int8)")
    sp.add_argument("--clip-ckpt", required=True,
                    help="a released CLIP .pt (TorchScript or state_dict)")
    sp.add_argument("--video", required=True)
    sp.add_argument("--query", required=True)
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.add_argument("overrides", nargs="*",
                    help="dotted key=value overrides, e.g. model.vid_dim=514 "
                         "model.txt_dim=512")
    sp = sub.add_parser("extract-text")
    sp.set_defaults(fn=cmd_extract_text)
    sp.add_argument("--metadata", required=True)
    sp.add_argument("--clip-ckpt", required=True)
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--device", default="cuda", help=device_help)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
