"""The port's MR driver end to end on the CPU: ``train_mr`` and ``cli
train-mr --device cpu`` for 2 epochs on a tiny synthetic corpus; the
train log, opt.json and the checkpoint they write; the checkpoint read back
by ``restore_params``, ``restore_checkpoint`` (resume_all) and the serving
pipeline; ``length_buckets`` padding each batch to its rung of the ladder;
the profiler trace, TensorBoard events and code.zip of ``profile_dir`` and
``tensorboard_dir="auto"``; the options the port does not run raising with
ROADMAP named, and the gang's options refused in one process. In-training evaluation is tests/test_torch_infer.py's."""
import dataclasses
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from univtg_tpu_torch import cli
from univtg_tpu_torch.data.mr import MRDataConfig
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.interop import load_torch_checkpoint
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.serve import GroundingPipeline
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train import driver_mr
from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr

torch.set_num_threads(1)
MODEL = dict(vid_dim=22, txt_dim=8, hidden_dim=32, num_layers=2, num_heads=4,
             ffn_dim=48, max_v_l=24, max_q_l=8)
KEYS = {"epoch", "time", "steps", "loss_b", "loss_g", "loss_f", "loss_s_inter",
        "loss_s_intra", "loss_overall", "grad_norm"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return create_synthetic_mr_corpus(str(tmp_path_factory.mktemp("corpus")),
                                      n_train=10, n_val=1, v_dim=20, q_dim=8,
                                      max_clips=24, seed=1)


def _data(c):
    return MRDataConfig(data_path=c["train_path"], v_feat_dirs=c["v_feat_dirs"],
                        q_feat_dir=c["q_feat_dir"], v_feat_dim=20, q_feat_dim=8,
                        max_q_l=8, max_v_l=24)


def _log(results_dir):
    with open(os.path.join(results_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_mr_writes_log_config_and_a_servable_checkpoint(corpus, tmp_path):
    cfg = TrainConfig(model=ModelConfig(**MODEL, attention_impl="pallas"),
                      train_data=_data(corpus), results_dir=str(tmp_path / "run"),
                      bsz=4, n_epoch=2, lr_warmup=1, num_io_threads=2,
                      transfer_dtype="bfloat16")
    metrics, best = train_mr(cfg, device="cpu")
    assert metrics == {} and best == str(tmp_path / "run" / "model_best.ckpt")
    log = _log(cfg.results_dir)
    assert [line["epoch"] for line in log] == [0, 1]
    assert all(set(line) == KEYS and line["steps"] == 3 for line in log)
    assert all(np.isfinite(line["loss_overall"]) for line in log)
    with open(os.path.join(cfg.results_dir, "opt.json")) as f:
        opt = json.load(f)
    assert opt["bsz"] == 4 and opt["model"]["attention_impl"] == "pallas"

    blob = torch.load(best, map_location="cpu", weights_only=True)
    assert set(blob) >= {"model", "optimizer", "epoch", "opt"} and blob["epoch"] == 1
    assert blob["step"] == 6 and blob["opt"]["n_epoch"] == 2
    template = UniVTG(cfg.model, device="cpu", seed=5).state_dict()
    params = ckpt.restore_params(best, template)
    assert all(torch.equal(params[k], blob["model"][k]) for k in template)
    assert not torch.equal(params["weightedpool.weight"], template["weightedpool.weight"])

    pipe = GroundingPipeline(cfg.model, load_torch_checkpoint(best, cfg.model),
                             eval_mode="add", device="cpu")
    rng = np.random.default_rng(0)
    res = pipe.ground_features(rng.standard_normal((17, 20)).astype(np.float32),
                               rng.standard_normal((5, 8)).astype(np.float32))
    assert np.asarray(res["saliency"]).shape == (17,)
    assert np.isfinite(np.asarray(res["topk_windows"])).all()

    # resume_all continues after the saved epoch with the optimizer state
    more = dataclasses.replace(cfg, n_epoch=3)
    train_mr(more, resume=best, resume_all=True, device="cpu")
    assert [line["epoch"] for line in _log(cfg.results_dir)] == [0, 1, 2]
    again = torch.load(best, map_location="cpu", weights_only=True)
    assert again["step"] == 9


def test_cli_train_mr_on_the_cpu(corpus, tmp_path, capsys):
    out = tmp_path / "cli"
    cli.main([
        "train-mr", "--preset", "qvhighlights_mr", "--device", "cpu",
        f"train_data.data_path={corpus['train_path']}",
        f"train_data.v_feat_dirs={corpus['v_feat_dirs']}",
        f"train_data.q_feat_dir={corpus['q_feat_dir']}",
        "train_data.v_feat_dim=20", "train_data.q_feat_dim=8",
        "train_data.max_v_l=24", "eval_data=None", "n_epoch=2", "bsz=5",
        "num_io_threads=2", f"results_dir={out}",
        *[f"model.{k}={v}" for k, v in MODEL.items()],
    ])
    assert f"best checkpoint: {out / 'model_best.ckpt'}" in capsys.readouterr().out
    assert [line["steps"] for line in _log(str(out))] == [2, 2]
    with open(out / "opt.json") as f:
        opt = json.load(f)
    # the preset's hyperparameters, with the overrides on top
    assert (opt["lr"], opt["lr_warmup"], opt["nms_thd"], opt["bsz"]) == (1e-4, 10, 0.7, 5)
    assert opt["eval_data"] is None and opt["async_checkpoint"] is True
    sd = load_torch_checkpoint(str(out / "model_best.ckpt"), ModelConfig(**MODEL))
    assert sd["input_vid_proj.0.net.1.weight"].shape == (32, 22)


def test_length_buckets_pad_each_batch_to_its_rung(corpus, tmp_path, monkeypatch):
    seen, make_step = [], driver_mr.make_train_step

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def run(state, model_inputs, targets, seed):
            seen.append((model_inputs["src_vid"].shape[1],
                         int(model_inputs["src_vid_mask"].sum(1).max())))
            return step(state, model_inputs, targets, seed)
        return run

    monkeypatch.setattr(driver_mr, "make_train_step", recording)
    cfg = TrainConfig(model=ModelConfig(**MODEL), train_data=_data(corpus),
                      results_dir=str(tmp_path / "run"), bsz=2, n_epoch=1,
                      num_io_threads=2, length_buckets=(12, 16))
    train_mr(cfg, device="cpu")
    assert len(seen) == 5
    for padded, longest in seen:  # the smallest rung that holds the batch
        assert padded == min(r for r in (12, 16, 24) if r >= longest)
    assert len({padded for padded, _ in seen}) > 1


def test_train_mr_writes_a_trace_tensorboard_events_and_its_code(corpus, tmp_path):
    run = tmp_path / "run"
    cfg = TrainConfig(model=ModelConfig(**MODEL, attention_impl="pallas"),
                      train_data=_data(corpus), eval_data=_data(corpus),
                      results_dir=str(run), bsz=4, n_epoch=2, eval_epoch=1,
                      num_io_threads=2, profile_dir=str(run / "profile"),
                      profile_steps=2, tensorboard_dir="auto")
    train_mr(cfg, device="cpu")
    assert [line["steps"] for line in _log(str(run))] == [3, 3]
    with open(run / "opt.json") as f:
        opt = json.load(f)
    assert opt["tensorboard_dir"] == "auto" and opt["profile_steps"] == 2
    with zipfile.ZipFile(run / "code.zip") as z:
        assert "univtg_tpu_torch/csrc/flash_bwd.cu" in z.namelist()
    # one trace, of the first two steps of epoch 0: the flash kernels' CPU
    # twins under the train step
    [trace] = os.listdir(run / "profile")
    with open(run / "profile" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::mm", "aten::addmm"} & names
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(run / "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"train/loss_overall", "train/grad_norm", "eval/MR-full-mAP-key"} <= tags
    assert [e.step for e in acc.Scalars("train/loss_overall")] == [0, 1]


def test_cli_defaults_to_cuda_for_train_mr():
    args = cli.build_parser().parse_args(["train-mr", "--preset", "qvhighlights_mr"])
    assert args.device == "cuda" and args.overrides == []


@pytest.mark.parametrize("field,value", [
    ("dp", 2), ("tp", 2),
    ("pp", 2), ("ep", 2), ("num_shards", 2),
    ("inject_fault_epoch", 0),
])
def test_unported_driver_options_raise(corpus, field, value, tmp_path):
    """pp > 1 needs model.pipeline_stages == pp (JAX's check, before the
    mesh); dp * pp * tp * ep must be the gang's world size and num_shards
    its dp, so a one-process run with dp, tp or num_shards 2 raises
    ValueError, and so does ep = 2 with a dense model (JAX's check, before
    the mesh); the fault injection is ported: rank 0 of a one-process run
    exits with 3 after epoch 0's log line (in a subprocess here)."""
    cfg = dataclasses.replace(TrainConfig(train_data=_data(corpus)), **{field: value})
    if field == "pp":
        with pytest.raises(ValueError, match=r"cfg.pp=2 requires cfg.model.pipeline_stages"):
            train_mr(cfg, device="cpu")
    elif field == "ep":
        with pytest.raises(ValueError, match="ep=2 needs a MoE model"):
            train_mr(cfg, device="cpu")
    elif field in ("dp", "tp", "num_shards"):
        with pytest.raises(ValueError, match="world size"):
            train_mr(cfg, device="cpu")
    else:
        run = tmp_path / "fault"
        code = (
            "import sys; sys.path.insert(0, %r)\n"
            "from univtg_tpu_torch.data.mr import MRDataConfig\n"
            "from univtg_tpu_torch.models import ModelConfig\n"
            "from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr\n"
            "cfg = TrainConfig(model=ModelConfig(**%r), train_data=MRDataConfig(**%r),\n"
            "                  results_dir=%r, bsz=4, n_epoch=3, lr_warmup=1,\n"
            "                  num_io_threads=2, inject_fault_epoch=0)\n"
            "train_mr(cfg, device='cpu')\n"
        ) % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))), MODEL,
             dataclasses.asdict(_data(corpus)), str(run))
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 3, proc.stderr[-3000:]
        assert [line["epoch"] for line in _log(run)] == [0]
        assert not (run / "model_best.ckpt").exists()


def test_moment_detr_needs_its_config(corpus):
    """model_id="moment_detr" with a plain ModelConfig names the class it
    needs (the JAX driver fails there with an AttributeError)."""
    cfg = TrainConfig(train_data=_data(corpus), model_id="moment_detr")
    with pytest.raises(ValueError, match="MomentDETRConfig"):
        train_mr(cfg, device="cpu")
