"""The released-run path of the port against the JAX package's, on the CPU
at a small width (hidden 64, 2 layers): a released run is the port's
``UniVTG`` state dict under DDP's ``module.`` prefixes in upstream's
container (model, optimizer, lr_scheduler, epoch, opt) with opt.json beside
it in upstream's flag names. ``config_from_reference_opt`` and
``load_reference_run`` give JAX's config field by field, with JAX's
fallbacks and error; the loaded model's forward equals JAX's
``load_reference_run`` + ``UniVTG.apply`` on the same file within 1e-4; and
``tools/reproduce_model_md.py``, run in process on a synthetic corpus,
gives JAX's ``run_inference`` + ``evaluate_submission`` + ``apply_nms`` on
the same run: the same qids in the same order, windows within 2e-4 s,
metrics equal (the limits of tests/test_torch_infer.py)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from univtg_tpu.data.collate import collate_mr as jax_collate
from univtg_tpu.data.loader import Loader as JaxLoader
from univtg_tpu.data.mr import MRDataConfig as JaxDataConfig
from univtg_tpu.data.mr import MRDataset as JaxDataset
from univtg_tpu.interop import config_from_reference_opt as jax_config_from_opt
from univtg_tpu.interop import load_reference_run as jax_load_reference_run
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.train.infer_mr import apply_nms as jax_apply_nms
from univtg_tpu.train.infer_mr import evaluate_submission as jax_evaluate
from univtg_tpu.train.infer_mr import run_inference as jax_run_inference
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.interop import config_from_reference_opt, load_reference_run
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.tools import reproduce_model_md

torch.set_num_threads(1)
SMALL = dict(vid_dim=22, txt_dim=8, hidden_dim=64, num_layers=2, num_heads=4, ffn_dim=96,
             max_v_l=24, max_q_l=8, dropout=0.1, droppath=0.1, input_dropout=0.5)


def reference_opt(cfg: ModelConfig) -> dict:
    """opt.json as upstream's BaseOptions writes it: its flag names, the
    video width after the TEF bump, and flags the model does not read."""
    return {"dset_name": "qvhighlights", "model_id": "univtg", "v_feat_dim": cfg.vid_dim,
            "t_feat_dim": cfg.txt_dim, "hidden_dim": cfg.hidden_dim,
            "enc_layers": cfg.num_layers, "nheads": cfg.num_heads,
            "dim_feedforward": cfg.ffn_dim, "dropout": cfg.dropout, "droppath": cfg.droppath,
            "input_dropout": cfg.input_dropout, "n_input_proj": cfg.n_input_proj,
            "span_loss_type": cfg.span_loss_type, "max_q_l": cfg.max_q_l,
            "max_v_l": cfg.max_v_l, "use_txt_pos": cfg.use_txt_pos, "ctx_mode": "video_tef",
            "clip_length": 2.0, "lr": 0.0001, "eval_mode": "add"}


def _save_released(run_dir, cfg, seed=0, opt_json=True):
    """A released run of ``UniVTG(cfg)`` from ``seed`` in ``run_dir``: its
    model_best.ckpt path."""
    os.makedirs(run_dir, exist_ok=True)
    sd = UniVTG(cfg, device="cpu", seed=seed).state_dict()
    ckpt = os.path.join(run_dir, "model_best.ckpt")
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}, "optimizer": {},
                "lr_scheduler": {}, "epoch": 99, "opt": reference_opt(cfg)}, ckpt)
    if opt_json:
        with open(os.path.join(run_dir, "opt.json"), "w") as f:
            json.dump(reference_opt(cfg), f)
    return ckpt


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    cfg = ModelConfig(**SMALL)
    return _save_released(str(tmp_path_factory.mktemp("released")), cfg), cfg


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("opt", [
    "full",
    {"v_feat_dim": 100, "t_feat_dim": 50},
    {"v_feat_dim": 2818, "t_feat_dim": 512, "hidden_dim": None, "enc_layers": None,
     "use_txt_pos": 1, "span_loss_type": "ce", "max_q_l": 32, "n_input_proj": 1},
], ids=["full", "defaults", "nones"])
def test_config_from_reference_opt_equals_jax_field_by_field(opt):
    if opt == "full":
        opt = reference_opt(ModelConfig(**SMALL))
    got, want = config_from_reference_opt(opt), jax_config_from_opt(opt)
    assert _fields(got) == _fields(want)
    assert isinstance(got, ModelConfig)
    with pytest.raises(KeyError):
        config_from_reference_opt({"t_feat_dim": 8})
    with pytest.raises(KeyError):
        jax_config_from_opt({"t_feat_dim": 8})


def test_load_reference_run_fallbacks_and_error_match_jax(released, tmp_path):
    ckpt, cfg = released
    beside = os.path.join(os.path.dirname(ckpt), "opt.json")
    for args in ((ckpt,), (ckpt, beside)):
        got, sd = load_reference_run(*args)
        assert _fields(got) == _fields(jax_load_reference_run(*args)[0]) == _fields(cfg)
        assert list(sd) == list(UniVTG(cfg, device="meta").state_dict())
        assert not any(k.startswith("module.") for k in sd)
    # an explicit opt.json wins over the one beside the checkpoint
    other = dataclasses.replace(cfg, max_q_l=12)
    with open(tmp_path / "other.json", "w") as f:
        json.dump(reference_opt(other), f)
    got = load_reference_run(ckpt, str(tmp_path / "other.json"))[0]
    assert got.max_q_l == jax_load_reference_run(ckpt, str(tmp_path / "other.json"))[0].max_q_l
    assert got.max_q_l == 12
    blob = torch.load(ckpt, weights_only=False)
    # no opt.json beside the copy: the container's opt dict
    torch.save(blob, tmp_path / "with_opt.ckpt")
    got = load_reference_run(str(tmp_path / "with_opt.ckpt"))[0]
    assert _fields(got) == _fields(jax_load_reference_run(str(tmp_path / "with_opt.ckpt"))[0])
    # neither: the same error in both
    torch.save({"model": blob["model"]}, tmp_path / "bare.ckpt")
    for load in (load_reference_run, jax_load_reference_run):
        with pytest.raises(FileNotFoundError, match="opt.json"):
            load(str(tmp_path / "bare.ckpt"))


def test_loaded_forward_equals_jax(released):
    ckpt, _ = released
    cfg, sd = load_reference_run(ckpt)
    model = UniVTG(cfg, device="cpu")
    model.load_state_dict(sd)
    model.eval()
    jcfg, params = jax_load_reference_run(ckpt)
    rng = np.random.default_rng(1)
    vid = rng.standard_normal((2, 24, cfg.vid_dim)).astype(np.float32)
    txt = rng.standard_normal((2, 8, cfg.txt_dim)).astype(np.float32)
    vm, tm = np.ones((2, 24), np.float32), np.ones((2, 8), np.float32)
    vm[1, 17:] = 0
    tm[1, 5:] = 0
    want = JaxUniVTG(jcfg).apply(params, txt, tm, vid, vm, train=False)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (txt, tm, vid, vm)), train=False)
    for k in ("pred_spans", "saliency_scores", "pred_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return create_synthetic_mr_corpus(str(tmp_path_factory.mktemp("corpus")), n_train=4,
                                      n_val=12, v_dim=SMALL["vid_dim"] - 2,
                                      q_dim=SMALL["txt_dim"], max_clips=SMALL["max_v_l"],
                                      seed=13)


@pytest.fixture(scope="module")
def jax_reproduced(released, corpus):
    """The JAX script's chain on the released run: run_inference over the
    val split in batches of 5, scored before NMS, the NMS'd copy beside."""
    ckpt, _ = released
    jcfg, params = jax_load_reference_run(ckpt)
    jds = JaxDataset(JaxDataConfig(
        dset_name="qvhighlights", data_path=corpus["val_path"],
        v_feat_dirs=tuple(corpus["v_feat_dirs"]), q_feat_dir=corpus["q_feat_dir"],
        v_feat_dim=jcfg.vid_dim - 2, q_feat_dim=jcfg.txt_dim, clip_len=corpus["clip_len"],
        max_q_l=jcfg.max_q_l, max_v_l=jcfg.max_v_l))
    loader = JaxLoader(jds, 5, lambda items, pad_batch_to: jax_collate(
        items, jcfg.max_q_l, jcfg.max_v_l, pad_batch_to), shuffle=False)
    submission = jax_run_inference(JaxUniVTG(jcfg), params["params"], loader, eval_mode="add",
                                   clip_length=corpus["clip_len"], round_multiple=-1)
    metrics = jax_evaluate(submission, jds.data)
    metrics["metrics_nms"] = jax_evaluate(jax_apply_nms(submission, 0.7, 10, 10),
                                          jds.data)["brief"]
    return submission, metrics, [m["qid"] for m in jds.data]


def _args(released, corpus, out):
    return ["--resume", released[0], "--eval-path", corpus["val_path"],
            "--v-feat-dirs", *corpus["v_feat_dirs"], "--q-feat-dir", corpus["q_feat_dir"],
            "--clip-len", str(corpus["clip_len"]), "--eval-bsz", "5", "--out", str(out),
            "--device", "cpu"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_reproduce_model_md_equals_the_jax_chain(released, corpus, jax_reproduced, impl,
                                                 tmp_path, capsys):
    """"pallas" runs the flash kernel's twin on the CPU."""
    want_sub, want_metrics, qids = jax_reproduced
    out = tmp_path / "metrics.json"
    metrics, sub = reproduce_model_md.main([f"model.attention_impl={impl}",
                                            *_args(released, corpus, out)])
    printed = capsys.readouterr().out
    assert f"attention_impl={impl}" in printed and "model.md expects 45.44" in printed
    assert [r["qid"] for r in sub] == [r["qid"] for r in want_sub] == qids
    for g, w in zip(sub, want_sub):
        gw, ww = np.asarray(g["pred_relevant_windows"]), np.asarray(w["pred_relevant_windows"])
        assert gw.shape == ww.shape
        np.testing.assert_allclose(gw[:, :2], ww[:, :2], atol=2e-4)
        np.testing.assert_allclose(gw[:, 2], ww[:, 2], atol=1e-4 + 1e-9)
        np.testing.assert_allclose(g["pred_saliency_scores"], w["pred_saliency_scores"],
                                   atol=1e-4)
    assert metrics["brief"] == dict(want_metrics["brief"])
    assert metrics["metrics_nms"] == dict(want_metrics["metrics_nms"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(metrics))


def test_reproduce_model_md_takes_the_defaults_and_needs_a_card_by_default(released,
                                                                           corpus):
    args = reproduce_model_md.build_parser().parse_args(
        ["--resume", "r", "--eval-path", "e", "--v-feat-dirs", "a", "b", "--q-feat-dir", "q"])
    assert (args.clip_len, args.eval_bsz, args.eval_mode, args.round_multiple, args.nms_thd,
            args.out, args.opt_json, args.device, args.overrides) == (
        2.0, 32, "add", -1, 0.7, "reproduce_metrics.json", None, "cuda", [])
    assert args.v_feat_dirs == ["a", "b"]
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    argv = [a for a in _args(released, corpus, "unused.json") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reproduce_model_md.main(argv)
    with pytest.raises(KeyError, match="no_such_field"):
        reproduce_model_md.main(["model.no_such_field=1", *_args(released, corpus, "x")])
