"""Video-language pretraining in one process, against the JAX package:
``VLPDataset`` item by item (gates, features, spans; ``data_ratio``;
``feature_lengths``; corpora at 2 s and 1 s clips, as ``cotrain`` mixes
them), ``train_vlp`` against JAX's ``train_vlp`` from the same init (logged
losses, the brief metrics' keys), ``init_distributed``, ``cli train-vlp``
on the CPU over a tree laid out at the preset's own paths, and the gated
step on an all-curve batch.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from univtg_tpu_torch import cli
from univtg_tpu_torch.data.collate import collate_mr
from univtg_tpu_torch.data.mr import MRDataConfig
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.data.vlp import TYPE_GATES, VLPCorpusSpec, VLPDataConfig, VLPDataset
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.train.driver_vlp import VLPTrainConfig, init_distributed, train_vlp
from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

torch.set_num_threads(1)
V_DIM, Q_DIM, MAX_CLIPS = 40, 24, 24
TYPES = ("point", "interval", "curve")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Three synthetic MR corpora (one per supervision type; the interval
    one at 1 s clips) and a val split."""
    out = []
    for i, clip_len in enumerate((2.0, 1.0, 2.0)):
        out.append(create_synthetic_mr_corpus(
            str(tmp_path_factory.mktemp(f"vlp{i}")), n_train=6 + i, n_val=4, v_dim=V_DIM,
            q_dim=Q_DIM, clip_len=clip_len, max_clips=MAX_CLIPS, seed=10 + i))
    return out


def specs(corpora, cls=VLPCorpusSpec):
    return tuple(cls(data_path=c["train_path"], dset_name=name, v_feat_dirs=tuple(
        c["v_feat_dirs"]), q_feat_dir=c["q_feat_dir"], type=t, clip_len=c["clip_len"])
        for c, t, name in zip(corpora, TYPES, ("ego4d", "charades", "qvhighlights")))


def vlp_cfg(corpora, cls=VLPDataConfig, spec_cls=VLPCorpusSpec, **kw):
    return cls(corpora=specs(corpora, spec_cls), q_feat_dim=Q_DIM, v_feat_dim=V_DIM,
               max_q_l=8, max_v_l=MAX_CLIPS, txt_drop_ratio=0.1, **kw)


def _jax_vlp():
    from univtg_tpu.data import vlp as jvlp

    return jvlp


@pytest.mark.parametrize("data_ratio", [1.0, 0.5])
def test_vlp_dataset_equals_jax_item_by_item(corpora, data_ratio):
    jvlp = _jax_vlp()
    ds = VLPDataset(vlp_cfg(corpora, data_ratio=data_ratio))
    jds = jvlp.VLPDataset(vlp_cfg(corpora, jvlp.VLPDataConfig, jvlp.VLPCorpusSpec,
                                  data_ratio=data_ratio))
    assert len(ds) == len(jds) == int(21 * data_ratio)
    np.testing.assert_array_equal(ds.part_ids, jds.part_ids)
    np.testing.assert_array_equal(ds.local_ids, jds.local_ids)
    assert ds.part_ids.dtype == np.int32 and ds.local_ids.dtype == np.int64
    np.testing.assert_array_equal(ds.feature_lengths(), jds.feature_lengths())
    seen = set()
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            a, b = ds[i], jds[i]
            assert set(a) == set(b) and a["meta"] == b["meta"]
            for k in b:
                if k != "meta":
                    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} item {i}")
            part = int(ds.part_ids[i])
            np.testing.assert_array_equal(a["gates"], TYPE_GATES[TYPES[part]])
            seen.add(part)
    assert seen == {0, 1, 2} or data_ratio < 1
    batch = collate_mr([ds[i] for i in range(4)], 8, MAX_CLIPS)
    assert batch["targets"]["gates"].shape == (4, 5)


def test_vlp_items_keep_each_corpus_clip_length(corpora):
    """Each part keeps its corpus's clip length (and seed + part index): the
    timestamp grid (i + clip_len / 2) / ctx_l of a 1 s item and a 2 s item."""
    ds = VLPDataset(vlp_cfg(corpora))
    assert [p.cfg.clip_len for p in ds.parts] == [2.0, 1.0, 2.0]
    assert [p.cfg.seed for p in ds.parts] == [2018, 2019, 2020]
    for part, half in ((1, 0.5), (0, 1.0)):
        item = ds[int(np.flatnonzero(ds.part_ids == part)[0])]
        n = len(item["video_feat"])
        np.testing.assert_allclose(item["timestamp"][:, 0], (np.arange(n) + half) / n,
                                   rtol=1e-6)


def test_init_distributed_is_one_process():
    """One process joins no gang; a gang needs its coordinator and a rank
    inside it (gangs themselves: tests/test_torch_dist.py)."""
    from univtg_tpu_torch.parallel import dist

    assert init_distributed() == (0, 1)
    assert init_distributed(num_processes=1) == (0, 1)
    assert dist.active() is None and not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="not in a gang of 2"):
        init_distributed("localhost:1234", num_processes=2, process_id=2, device="cpu")
    assert dist.active() is None and not torch.distributed.is_initialized()


def test_a_curve_only_batch_gives_finite_grads_and_decays_every_weight(corpora):
    """An all-curve batch (gates [0, 0, 0, 1, 1]) gates every span loss to 0;
    the step stays finite, and AdamW still decays the span head, which gets
    no gradient (as optax decays every parameter)."""
    ds = VLPDataset(vlp_cfg(corpora))
    curve = [i for i in range(len(ds)) if ds.part_ids[i] == 2][:4]
    b = collate_mr([ds[i] for i in curve], 8, MAX_CLIPS)
    cfg = ModelConfig(vid_dim=V_DIM + 2, txt_dim=Q_DIM, hidden_dim=32, num_layers=1,
                      num_heads=4, ffn_dim=48, max_v_l=MAX_CLIPS, max_q_l=8, dropout=0.0,
                      droppath=0.0, input_dropout=0.0)
    model = UniVTG(cfg, device="cpu", seed=0)
    lr, wd = 1e-2, 0.1
    state = TrainState(model, make_optimizer(model.parameters(), lambda c: lr, wd, 0.1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, m = make_train_step(LossWeights(), use_gates=True)(
        state, {k: torch.from_numpy(v) for k, v in b["model_inputs"].items()},
        {k: torch.from_numpy(v) for k, v in b["targets"].items()}, 0)
    assert m["loss_b"].item() == m["loss_g"].item() == m["loss_f"].item() == 0.0
    assert all(np.isfinite(v.item()) for v in m.values()) and m["grad_norm"].item() > 0
    for p in model.parameters():
        assert torch.isfinite(p).all()
    for k, v in model.state_dict().items():
        if k.startswith("span_embed"):
            torch.testing.assert_close(v, before[k] * (1 - lr * wd), rtol=1e-5, atol=1e-7)


def _model(**kw):
    return ModelConfig(**{**dict(vid_dim=V_DIM + 2, txt_dim=Q_DIM, hidden_dim=32,
                                 num_layers=2, num_heads=4, ffn_dim=48, max_v_l=MAX_CLIPS,
                                 max_q_l=8, dropout=0.0, droppath=0.0, input_dropout=0.0),
                          **kw})


def _eval_data(c, cls=MRDataConfig):
    return cls(dset_name="qvhighlights", data_path=c["val_path"],
               v_feat_dirs=tuple(c["v_feat_dirs"]), q_feat_dir=c["q_feat_dir"],
               q_feat_dim=Q_DIM, v_feat_dim=V_DIM, max_q_l=8, max_v_l=MAX_CLIPS)


def _run_cfg(results_dir, **kw):
    return dict(results_dir=str(results_dir), bsz=8, eval_bsz=8, n_epoch=2, eval_epoch=1,
                lr=3e-4, lr_warmup=1, save_interval=-1, prefetch_depth=0, **kw)


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_vlp_follows_jax_train_vlp_from_the_same_init(corpora, tmp_path):
    """dp = 1, dropouts 0, the same init (JAX's init_state at cfg.seed,
    carried over by state_dict_from_jax_params into a weights-only resume):
    every logged epoch loss at rtol 1e-4, the same brief metric keys."""
    import jax

    from univtg_tpu.data.mr import MRDataConfig as JaxMRDataConfig
    from univtg_tpu.models import ModelConfig as JaxConfig
    from univtg_tpu.models import UniVTG as JaxUniVTG
    from univtg_tpu.train import driver_vlp as jdriver
    from univtg_tpu.train import steps as jsteps
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    jvlp = _jax_vlp()
    cfg = VLPTrainConfig(model=_model(), vlp_data=vlp_cfg(corpora), train_data=None,
                         eval_data=_eval_data(corpora[2]),
                         **_run_cfg(tmp_path / "torch"))
    jfields = {f.name for f in dataclasses.fields(JaxConfig)}
    jmodel_cfg = JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg.model).items()
                              if k in jfields})
    jcfg = jdriver.VLPTrainConfig(
        model=jmodel_cfg, vlp_data=vlp_cfg(corpora, jvlp.VLPDataConfig, jvlp.VLPCorpusSpec),
        train_data=None, eval_data=_eval_data(corpora[2], JaxMRDataConfig), dp=1, tp=1,
        **_run_cfg(tmp_path / "jax"))
    jmetrics, _ = jdriver.train_vlp(jcfg)
    params = jsteps.init_state(JaxUniVTG(jmodel_cfg), jmodel_cfg,
                               jsteps.make_optimizer(lambda c: 0.0),
                               jax.random.PRNGKey(cfg.seed)).params
    init = tmp_path / "init.ckpt"
    torch.save({"model": state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg.model)}, init)
    metrics, best = train_vlp(cfg, resume=str(init), device="cpu")
    assert os.path.exists(best)
    assert set(metrics["brief"]) == set(jmetrics["brief"])
    assert "MR-full-mAP-key" in metrics["brief"]
    got, want = _log(tmp_path / "torch" / "train_log.jsonl"), _log(
        tmp_path / "jax" / "train_log.jsonl")
    assert [g["steps"] for g in got] == [w["steps"] for w in want] == [3, 3]
    for g, w in zip(got, want, strict=True):
        keys = [k for k in w if k.startswith("loss_")]
        assert keys and set(keys) <= set(g)
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} epoch {w['epoch']}")
    with open(tmp_path / "torch" / "opt.json") as f:
        written = json.load(f)
    assert written["use_gates"] is True
    assert [c["type"] for c in written["vlp_data"]["corpora"]] == list(TYPES)


def _lay_out_preset_tree(root, corpora):
    """The vlp_pretrain preset's relative layout under root/data: each
    corpus's features split into its vid_slowfast (first 32 dims) and
    vid_clip (the rest) dirs, text features linked, the val split as
    QVHighlights'."""
    def place(c, dset, jsonl, v_suffix="", q_suffix="", split="train_path"):
        base = os.path.join(root, "data", dset)
        os.makedirs(os.path.join(base, "metadata"), exist_ok=True)
        with open(c[split]) as f, open(os.path.join(base, "metadata", jsonl), "w") as g:
            g.write(f.read())
        sf, cl = (os.path.join(base, f"vid_{k}{v_suffix}") for k in ("slowfast", "clip"))
        for d in (sf, cl):
            os.makedirs(d, exist_ok=True)
        for name in os.listdir(c["v_feat_dirs"][0]):
            x = np.load(os.path.join(c["v_feat_dirs"][0], name))["features"]
            np.savez(os.path.join(sf, name), features=x[:, :32])
            np.savez(os.path.join(cl, name), features=x[:, 32:])
        q = os.path.join(base, f"txt_clip{q_suffix}")
        if not os.path.exists(q):
            os.symlink(c["q_feat_dir"], q)

    place(corpora[0], "ego4d", "point_egoclip_wo_val.jsonl", "_point", "_point")
    place(corpora[1], "videocc", "interval_900k.jsonl")
    place(corpora[2], "videocc", "curve_5_window.jsonl", "", "_concept")
    place(corpora[2], "qvhighlights", "qvhighlights_val.jsonl", split="val_path")


def test_cli_train_vlp_on_the_cpu_at_the_presets_paths(corpora, tmp_path, monkeypatch,
                                                       capsys):
    _lay_out_preset_tree(tmp_path, corpora)
    monkeypatch.chdir(tmp_path)
    run = tmp_path / "run"
    cli.main(["train-vlp", "--preset", "vlp_pretrain", "--device", "cpu",
              f"vlp_data.v_feat_dim={V_DIM}", f"vlp_data.q_feat_dim={Q_DIM}",
              "vlp_data.max_q_l=8", f"vlp_data.max_v_l={MAX_CLIPS}",
              f"eval_data.v_feat_dim={V_DIM}", f"eval_data.q_feat_dim={Q_DIM}",
              "eval_data.max_q_l=8", f"eval_data.max_v_l={MAX_CLIPS}",
              f"model.vid_dim={V_DIM + 2}", f"model.txt_dim={Q_DIM}", "model.hidden_dim=32",
              "model.num_layers=1", "model.num_heads=4", "model.ffn_dim=48",
              f"model.max_v_l={MAX_CLIPS}", "model.max_q_l=8", "model.attention_impl=pallas",
              "bsz=8", "eval_bsz=8", "n_epoch=1", "eval_epoch=1", f"results_dir={run}"])
    out = capsys.readouterr().out
    brief = json.loads(out[: out.rindex("best checkpoint:")])
    assert "MR-full-mAP-key" in brief
    assert (run / "model_best.ckpt").exists() and (run / "opt.json").exists()
    assert _log(run / "train_log.jsonl")[0]["steps"] == 3  # 6 + 7 + 8 items, bsz 8


def test_vlp_entry_points_default_to_cuda(corpora, tmp_path):
    args = cli.build_parser().parse_args(["train-vlp", "--preset", "cotrain"])
    assert args.device == "cuda" and args.resume is None
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    cfg = VLPTrainConfig(model=_model(), vlp_data=vlp_cfg(corpora),
                         **_run_cfg(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_vlp(cfg)
