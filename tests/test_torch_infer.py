"""The port's batch evaluation against the JAX package's, at a small config
(hidden 64, 2 layers): the int8 transfer round trip, the eval step on mapped
weights (f32, 1e-4: only the summation order differs), ``cli infer-mr
--device cpu`` against JAX ``run_inference`` + ``evaluate_submission`` on
the same weights and synthetic corpus (same qids in the same order, windows
within 2e-4 s and scores within 1e-4 after the 4-decimal rounding, saliency
within 1e-4, metrics equal), in-training evaluation in ``train_mr`` (its
files, the best/latest pair, early stopping, ``eval_init``), and every MR
preset's JSON equal to the JAX preset's."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from univtg_tpu import presets as jax_presets
from univtg_tpu.data.collate import collate_mr as jax_collate
from univtg_tpu.data.collate import quantize_for_transfer as jax_quantize
from univtg_tpu.data.loader import Loader as JaxLoader
from univtg_tpu.data.mr import MRDataConfig as JaxDataConfig
from univtg_tpu.data.mr import MRDataset as JaxDataset
from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.train.config_io import to_json as jax_to_json
from univtg_tpu.train.infer_mr import evaluate_submission as jax_evaluate
from univtg_tpu.train.infer_mr import run_inference as jax_run_inference
from univtg_tpu.train.steps import dequantize_inputs as jax_dequantize
from univtg_tpu.train.steps import make_eval_step as jax_make_eval_step
from univtg_tpu_torch import cli, presets
from univtg_tpu_torch.data.collate import collate_mr, quantize_for_transfer
from univtg_tpu_torch.data.features import load_jsonl
from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.interop import state_dict_from_jax_params
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.train.driver_mr import TrainConfig, to_json, train_mr
from univtg_tpu_torch.train.epoch_runner import strip_meta
from univtg_tpu_torch.train.steps import dequantize_inputs, make_eval_step

torch.set_num_threads(1)
SMALL = dict(vid_dim=22, txt_dim=8, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, max_v_l=24, max_q_l=8)
DATA = dict(v_feat_dim=20, q_feat_dim=8, max_q_l=8, max_v_l=24)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return create_synthetic_mr_corpus(str(tmp_path_factory.mktemp("corpus")), n_train=10,
                                      n_val=10, v_dim=20, q_dim=8, max_clips=24, seed=2)


@pytest.fixture(scope="module")
def weights():
    """JAX params from a seed and the port's state_dict mapped from them."""
    rng = np.random.default_rng(0)
    args = (rng.standard_normal((2, 8, 8)).astype(np.float32), np.ones((2, 8), np.float32),
            rng.standard_normal((2, 24, 22)).astype(np.float32), np.ones((2, 24), np.float32))
    params = JaxUniVTG(JaxConfig(**SMALL)).init(jax.random.PRNGKey(3), *args,
                                                train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, state_dict_from_jax_params(params, ModelConfig(**SMALL))


def _data(cls, c, split):
    return cls(data_path=c[f"{split}_path"], v_feat_dirs=tuple(c["v_feat_dirs"]),
               q_feat_dir=c["q_feat_dir"], **DATA)


def _batch(c, n=4):
    ds = MRDataset(_data(MRDataConfig, c, "val"))
    return collate_mr([ds[i] for i in range(n)], 8, 24, pad_batch_to=n + 1)


def test_int8_transfer_round_trip_equals_jax(corpus):
    batch = _batch(corpus)
    got = quantize_for_transfer(batch["model_inputs"])
    want = jax_quantize(batch["model_inputs"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["src_vid_q"].dtype == np.int8
    deq = dequantize_inputs({k: torch.from_numpy(v) for k, v in got.items()})
    jdeq = jax_dequantize(want)
    for k in ("src_txt", "src_vid"):
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))
    # strip_meta's int8 batch is what the eval step undoes
    mi, _ = strip_meta(batch, "int8")
    assert torch.equal(dequantize_inputs(mi)["src_vid"], deq["src_vid"])


@pytest.mark.parametrize("transfer", ["float32", "int8"])
def test_eval_step_matches_jax(corpus, weights, transfer):
    params, sd = weights
    batch = _batch(corpus)
    mi, tg = strip_meta(batch, transfer)
    model = UniVTG(ModelConfig(**SMALL), device="cpu")
    model.load_state_dict(sd)
    got = make_eval_step("add")(model, mi, tg)
    jmi = jax_quantize(batch["model_inputs"]) if transfer == "int8" else batch["model_inputs"]
    want = jax_make_eval_step(JaxUniVTG(JaxConfig(**SMALL)), "add")(
        params, jmi, batch["targets"])
    assert not got["scores"].requires_grad
    for k in ("scores", "spans", "saliency", "valid_len"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)


def _preset_overrides(c):
    return [f"eval_data.{k}={v!r}" for k, v in dict(
        data_path=c["val_path"], v_feat_dirs=tuple(c["v_feat_dirs"]),
        q_feat_dir=c["q_feat_dir"], **DATA).items()] + [
        "eval_bsz=4", *[f"model.{k}={v}" for k, v in SMALL.items()]]


def test_cli_infer_mr_matches_jax_inference(corpus, weights, tmp_path, capsys):
    params, sd = weights
    torch.save({"model": sd}, tmp_path / "best.ckpt")
    out = tmp_path / "preds.jsonl"
    cli.main(["infer-mr", "--preset", "qvhighlights_mr", "--device", "cpu",
              "--resume", str(tmp_path / "best.ckpt"), "--out", str(out),
              *_preset_overrides(corpus)])
    brief = json.loads(capsys.readouterr().out)
    got = load_jsonl(str(out))

    jds = JaxDataset(_data(JaxDataConfig, corpus, "val"))
    loader = JaxLoader(jds, 4, lambda items, pad_batch_to: jax_collate(
        items, 8, 24, pad_batch_to))
    want = jax_run_inference(JaxUniVTG(JaxConfig(**SMALL)), params, loader,
                             eval_mode="add", clip_length=2.0, round_multiple=1)
    assert [r["qid"] for r in got] == [r["qid"] for r in want] == [m["qid"] for m in jds.data]
    for g, w in zip(got, want):
        gw, ww = np.asarray(g["pred_relevant_windows"]), np.asarray(w["pred_relevant_windows"])
        assert gw.shape == ww.shape
        np.testing.assert_allclose(gw[:, :2], ww[:, :2], atol=2e-4)
        np.testing.assert_allclose(gw[:, 2], ww[:, 2], atol=1e-4 + 1e-9)
        np.testing.assert_allclose(g["pred_saliency_scores"], w["pred_saliency_scores"],
                                   atol=1e-4)
    assert brief == dict(jax_evaluate(want, jds.data)["brief"])


def _train_cfg(c, tmp_path, **kw):
    return TrainConfig(model=ModelConfig(**SMALL), train_data=_data(MRDataConfig, c, "train"),
                       eval_data=_data(MRDataConfig, c, "val"),
                       results_dir=str(tmp_path / "run"), bsz=4, eval_bsz=4,
                       lr_warmup=1, num_io_threads=2, nms_thd=0.7, **kw)


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_mr_evaluates_and_keeps_the_best_and_latest(corpus, tmp_path):
    cfg = _train_cfg(corpus, tmp_path, n_epoch=2, eval_epoch=1)
    metrics, best = train_mr(cfg, device="cpu")
    run = cfg.results_dir
    evals = _lines(os.path.join(run, "eval_log.jsonl"))
    assert [e["epoch"] for e in evals] == [0, 1]
    assert set(metrics["brief"]) <= set(evals[0]) and "nms_brief" in metrics
    for name in ("metrics_e0000.json", "metrics_e0001.json", "latest_val_preds.jsonl",
                 "model_best.ckpt", "model_latest.ckpt"):
        assert os.path.exists(os.path.join(run, name)), name
    preds = load_jsonl(os.path.join(run, "latest_val_preds.jsonl"))
    assert len(preds) == 10 and all(len(p["pred_relevant_windows"]) for p in preds)
    best_epoch = max(evals, key=lambda e: (e["MR-full-mAP-key"], -e["epoch"]))["epoch"]
    blob = torch.load(best, weights_only=True)
    assert blob["epoch"] == best_epoch
    assert torch.load(os.path.join(run, "model_latest.ckpt"), weights_only=True)["epoch"] == 1
    with open(os.path.join(run, "metrics_e0001.json")) as f:
        assert json.load(f)["brief"] == {k: v for k, v in evals[1].items() if k != "epoch"}


def test_early_stop_after_the_first_evaluation_that_does_not_improve(corpus, tmp_path):
    """lr 0 keeps the weights, so the evaluation at epoch 0 scores what the
    one at epoch -1 (eval_init) scored, and max_es_cnt=0 stops there."""
    cfg = _train_cfg(corpus, tmp_path, n_epoch=5, eval_epoch=1, eval_init=True,
                     max_es_cnt=0, lr=0.0)
    train_mr(cfg, device="cpu")
    evals = _lines(os.path.join(cfg.results_dir, "eval_log.jsonl"))
    assert [e["epoch"] for e in evals] == [-1, 0]
    assert evals[0]["MR-full-mAP-key"] == evals[1]["MR-full-mAP-key"]
    assert [t["epoch"] for t in _lines(os.path.join(cfg.results_dir, "train_log.jsonl"))] == [0]
    blob = torch.load(os.path.join(cfg.results_dir, "model_best.ckpt"), weights_only=True)
    assert blob["epoch"] == -1 and blob["step"] == 0


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_mr_presets_equal_the_jax_presets(name):
    assert to_json(presets.PRESETS[name]()) == jax_to_json(jax_presets.PRESETS[name]())


def test_the_port_has_every_mr_preset_of_the_jax_package():
    mr = {k for k in presets.PRESETS if k.endswith("_mr")}
    assert mr == {k for k in jax_presets.PRESETS if k.endswith("_mr")}
    assert set(presets.PRESETS) - mr == {"tvsum_hl", "youtube_hl", "qfvs", "vlp_pretrain",
                                         "cotrain"}
    assert set(presets.PRESETS) == set(jax_presets.PRESETS)


def test_train_mr_with_the_int8_transfer(corpus, tmp_path):
    cfg = dataclasses.replace(_train_cfg(corpus, tmp_path, n_epoch=1, eval_epoch=1),
                              transfer_dtype="int8", transfer_dtype_eval="int8")
    metrics, _ = train_mr(cfg, device="cpu")
    assert np.isfinite(metrics["brief"]["MR-full-mAP-key"])
