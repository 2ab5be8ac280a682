"""The highlight-detection vertical of the port against the JAX package's:
``create_synthetic_hl_corpus``, ``HLDataset`` (TVSum and YouTube
branches), ``collate_hl``, the domain evaluators, ``eval_domain`` on the
same weights, an HL train-step trajectory (labels + saliency, so the span
head has no gradient and only weight decay moves it), and ``train_hl`` /
``infer_hl`` / ``cli train-hl`` / ``cli infer-hl`` on the CPU. The cases of
JAX's ``tests/test_hl.py`` come first, on the port's modules.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from univtg_tpu_torch import cli
from univtg_tpu_torch.data.hl import HLDataConfig, HLDataset, collate_hl
from univtg_tpu_torch.data.synthetic import create_synthetic_hl_corpus
from univtg_tpu_torch.evals.hl_domain import evaluate_tvsum, evaluate_youtube, ranked_ap
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train.driver_hl import HLTrainConfig, eval_domain, infer_hl, train_hl
from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

torch.set_num_threads(1)
HL_WEIGHTS = dict(b=0, g=0, f=10, s_intra=0.1, s_inter=0.1)


# ----------------------------------------------- JAX's tests/test_hl.py cases


def test_ranked_ap_hand_computed():
    got = ranked_ap([1, 0, 1])
    want = 0.5 * (1 + 1) / 2 + 0 + 0.5 * (0.5 + 2 / 3) / 2
    assert got == pytest.approx(want)
    assert ranked_ap([0, 0]) == 0.0
    assert ranked_ap([1, 1]) == pytest.approx(1.0)


def test_evaluate_youtube_perfect_ranking():
    scores = [np.array([0.9, 0.1, 0.8, 0.2])]
    labels = [np.array([1, 0, 1, 0])]
    assert evaluate_youtube(scores, labels) == pytest.approx(1.0)


def test_evaluate_tvsum_topk():
    rng = np.random.default_rng(0)
    anno = rng.uniform(0, 5, (30, 20))
    assert evaluate_tvsum([anno.mean(1)], [anno]) > evaluate_tvsum([-anno.mean(1)], [anno])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return create_synthetic_hl_corpus(
        str(tmp_path_factory.mktemp("hl")), dset_name="tvsum", n_train=6, n_val=3
    )


@pytest.fixture(scope="module")
def yt_corpus(tmp_path_factory):
    return create_synthetic_hl_corpus(
        str(tmp_path_factory.mktemp("yt")), dset_name="youtube", n_train=4, n_val=2
    )


def make_cfg(corpus, dset_name="tvsum", cls=HLDataConfig):
    return cls(
        dset_name=dset_name,
        domain="SYN",
        anno_path=corpus["anno_path"],
        splits_path=corpus["splits_path"],
        v_feat_dirs=corpus["v_feat_dirs"],
        q_feat_dir=corpus["q_feat_dir"],
        q_feat_dim=corpus["q_dim"],
        max_v_l=corpus["max_clips"],
        max_q_l=8,
    )


def small_model(corpus, **kw):
    return ModelConfig(**{**dict(
        vid_dim=corpus["v_dim"] + 2, txt_dim=corpus["q_dim"], hidden_dim=32,
        num_layers=1, num_heads=4, ffn_dim=48, input_dropout=0.1,
        max_v_l=corpus["max_clips"], max_q_l=8), **kw})


def test_hl_dataset_contract(corpus):
    ds = HLDataset(make_cfg(corpus))
    assert len(ds) == 6
    ds.set_state("val")
    assert len(ds) == 3
    ds.set_state("train")
    item = ds[0]
    assert item["video_feat"].shape[1] == corpus["v_dim"] + 2
    assert len(item["saliency_scores"]) == len(item["video_feat"])
    anno = np.asarray(ds.label[item["meta"]["vid"]]["anno"], np.float32)
    want = (anno - anno.mean()).mean(1)[: len(item["saliency_scores"])]
    np.testing.assert_allclose(item["saliency_scores"], want, atol=1e-5)
    batch = collate_hl([ds[0], ds[1]], max_q_l=8, max_v_l=corpus["max_clips"], pad_batch_to=4)
    assert batch["model_inputs"]["src_vid"].shape[0] == 4
    assert (batch["targets"]["timestamp_window"]
            == (batch["targets"]["saliency_scores"] > 0)).all()


def test_youtube_dataset_branch(yt_corpus):
    ds = HLDataset(make_cfg(yt_corpus, "youtube"))
    item = ds[0]
    sal = item["saliency_scores"]
    assert set(np.unique(sal)).issubset({0.0, 1.0})
    match = ds.label[item["meta"]["vid"]]["match"]
    want = np.asarray([1.0 if s > 0 else 0.0 for s in match])[: len(sal)]
    np.testing.assert_array_equal(sal, want)
    assert evaluate_youtube([sal + 0.01], [sal]) == pytest.approx(1.0)


def _hl_cfg(corpus, results_dir, **kw):
    return HLTrainConfig(
        model=small_model(corpus), data=make_cfg(corpus), domains=["SYN"],
        results_dir=str(results_dir), bsz=4, eval_bsz=4, n_epoch=2, eval_epoch=1,
        lr=3e-4, lr_warmup=1, weights=LossWeights(**HL_WEIGHTS), **kw)


def test_hl_driver_trains_checkpoints_and_infer_hl_reads_them(corpus, tmp_path):
    """train_hl on the CPU: a best checkpoint per domain in the upstream
    container, best_tvsum_metrics.json with the domain and AVG; infer_hl on
    that directory gives the best epoch's mAP again."""
    cfg = _hl_cfg(corpus, tmp_path / "hl_run")
    scores = train_hl(cfg, device="cpu")
    assert set(scores) == {"SYN", "AVG"} and scores["SYN"] > 0
    assert scores["AVG"] == scores["SYN"]
    with open(tmp_path / "hl_run" / "best_tvsum_metrics.json") as f:
        assert json.load(f) == scores
    blob = ckpt.read_checkpoint(str(tmp_path / "hl_run" / "model_SYN_best.ckpt"))
    assert set(blob) == {"model", "optimizer", "epoch", "step", "opt"}
    assert blob["step"] == 2 * (blob["epoch"] + 1)  # 6 items, bsz 4: 2 steps an epoch
    assert infer_hl(cfg, str(tmp_path / "hl_run"), device="cpu") == scores


def test_hl_driver_runtime_knobs(corpus, tmp_path):
    """bf16 transfer casting, prefetch and the profiler window run through
    the shared epoch runner, as the JAX HL driver's test asks."""
    profile_dir = str(tmp_path / "trace")
    cfg = _hl_cfg(corpus, tmp_path / "hl_knobs", transfer_dtype="bfloat16",
                  prefetch_depth=2, profile_dir=profile_dir, profile_steps=1)
    cfg = dataclasses.replace(cfg, n_epoch=1, model=small_model(corpus, input_dropout=0.0))
    assert "SYN" in train_hl(cfg, device="cpu")
    assert os.path.isdir(profile_dir) and os.listdir(profile_dir)


@pytest.mark.parametrize("field,value,error,match", [
    ("dp", 2, ValueError, r"dp=2: .* dp is the world size \(1\)"),
    ("tp", 2, NotImplementedError, "tp > 1 yet .ROADMAP.md, queue 1 item 11"),
])
def test_hl_multi_device_options_raise(corpus, tmp_path, field, value, error, match):
    """dp is the world size (a gang of dp ranks runs HL, see
    tests/test_torch_dist.py), so dp=2 in one process is refused; tp is
    not ported."""
    cfg = dataclasses.replace(_hl_cfg(corpus, tmp_path / "x"), **{field: value})
    with pytest.raises(error, match=match):
        train_hl(cfg, device="cpu")
    with pytest.raises(error, match=match):
        infer_hl(cfg, str(tmp_path), device="cpu")


def test_cli_train_hl_and_infer_hl_on_the_cpu(corpus, tmp_path, capsys):
    run = tmp_path / "cli_hl"
    data = [f"data.anno_path={corpus['anno_path']}",
            f"data.splits_path={corpus['splits_path']}",
            f"data.v_feat_dirs={tuple(corpus['v_feat_dirs'])}",
            f"data.q_feat_dir={corpus['q_feat_dir']}", f"data.q_feat_dim={corpus['q_dim']}",
            f"data.max_v_l={corpus['max_clips']}", "data.max_q_l=8",
            f"model.vid_dim={corpus['v_dim'] + 2}", f"model.txt_dim={corpus['q_dim']}",
            "model.hidden_dim=32", "model.num_layers=1", "model.num_heads=4",
            "model.ffn_dim=48", "model.attention_impl=pallas"]
    cli.main(["train-hl", "--preset", "tvsum_hl", "--device", "cpu", *data,
              f"results_dir={run}", "n_epoch=1", "eval_epoch=1", "lr_warmup=1"])
    trained = json.loads(capsys.readouterr().out)
    assert set(trained) == {"SYN", "AVG"}
    assert (run / "model_SYN_best.ckpt").exists()
    cli.main(["infer-hl", "--preset", "tvsum_hl", "--ckpt-dir", str(run), "--device",
              "cpu", *data])
    assert json.loads(capsys.readouterr().out) == trained


def test_cli_hl_commands_default_to_cuda():
    p = cli.build_parser()
    assert p.parse_args(["train-hl", "--preset", "tvsum_hl"]).device == "cuda"
    args = p.parse_args(["infer-hl", "--preset", "youtube_hl", "--ckpt-dir", "d"])
    assert args.device == "cuda" and args.ckpt_dir == "d"


def test_hl_presets_match_jax():
    from univtg_tpu import presets as jpresets
    from univtg_tpu_torch.presets import PRESETS

    for name in ("tvsum_hl", "youtube_hl"):
        got, want = PRESETS[name](), getattr(jpresets, name)()
        assert dataclasses.asdict(got.data) == dataclasses.asdict(want.data)
        assert got.model.vid_dim == want.model.vid_dim == 2818
        assert (got.bsz, got.lr, got.n_epoch, tuple(got.losses)) == (
            want.bsz, want.lr, want.n_epoch, tuple(want.losses))
        assert got.weights.as_dict() == want.weights.as_dict()


# ------------------------------------------------------ against the JAX package


@pytest.mark.parametrize("dset_name", ["tvsum", "youtube"])
def test_synthetic_hl_corpus_equals_jax(tmp_path, dset_name):
    from univtg_tpu.data.synthetic import create_synthetic_hl_corpus as jax_corpus

    got = create_synthetic_hl_corpus(str(tmp_path / "a"), dset_name=dset_name, seed=3)
    want = jax_corpus(str(tmp_path / "b"), dset_name=dset_name, seed=3)
    assert {k: v for k, v in got.items() if "path" not in k and "dir" not in k} == {
        k: v for k, v in want.items() if "path" not in k and "dir" not in k}
    for key in ("anno_path", "splits_path"):
        with open(got[key]) as f, open(want[key]) as g:
            assert f.read() == g.read()
    for sub in (got["q_feat_dir"], got["v_feat_dirs"][0]):
        other = sub.replace(str(tmp_path / "a"), str(tmp_path / "b"))
        names = sorted(os.listdir(sub))
        assert names == sorted(os.listdir(other)) and names
        for n in names:
            a, b = np.load(os.path.join(sub, n)), np.load(os.path.join(other, n))
            for k in b.files:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dset_name", ["tvsum", "youtube"])
def test_hl_items_and_collate_equal_jax(corpus, yt_corpus, dset_name):
    from univtg_tpu.data import hl as jhl

    c = corpus if dset_name == "tvsum" else yt_corpus
    ds = HLDataset(make_cfg(c, dset_name))
    jds = jhl.HLDataset(make_cfg(c, dset_name, jhl.HLDataConfig))
    for state in ("train", "val"):
        ds.set_state(state)
        jds.set_state(state)
        for epoch in (0, 1):
            ds.set_epoch(epoch)
            jds.set_epoch(epoch)
            items, jitems = [ds[i] for i in range(len(ds))], [jds[i] for i in range(len(jds))]
            for a, b in zip(items, jitems, strict=True):
                assert a["meta"] == b["meta"] and set(a) == set(b)
                for k in b:
                    if k != "meta":
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            got = collate_hl(items[:3], 8, c["max_clips"], pad_batch_to=4)
            want = jhl.collate_hl(jitems[:3], 8, c["max_clips"], pad_batch_to=4)
            assert got["meta"] == want["meta"]
            for part in ("model_inputs", "targets"):
                assert set(got[part]) == set(want[part])
                for k in want[part]:
                    assert got[part][k].dtype == want[part][k].dtype, k
                    np.testing.assert_array_equal(got[part][k], want[part][k], err_msg=k)


def test_domain_evaluators_equal_jax():
    from univtg_tpu.evals import hl_domain as jhd

    rng = np.random.default_rng(5)
    lens = rng.integers(5, 40, 12)
    scores = [rng.standard_normal(n).astype(np.float32) for n in lens]
    annos = [rng.integers(1, 6, (n, 20)).astype(np.float32) for n in lens]  # ties
    labels = [(rng.uniform(size=n) > 0.7).astype(np.float64) for n in lens]
    assert evaluate_tvsum(scores, annos) == jhd.evaluate_tvsum(scores, annos)
    assert evaluate_tvsum(scores, annos, k=3) == jhd.evaluate_tvsum(scores, annos, k=3)
    assert evaluate_youtube(scores, labels) == jhd.evaluate_youtube(scores, labels)
    for lab in labels:
        assert ranked_ap(lab) == jhd.ranked_ap(lab)


def _jax_model(cfg: ModelConfig, impl: str, seq=(8, 60)):
    """The JAX twin of a port config, its init params, and the port's model
    holding the same weights."""
    import jax

    from univtg_tpu.models import ModelConfig as JaxConfig
    from univtg_tpu.models import UniVTG as JaxUniVTG
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    fields = {f.name for f in dataclasses.fields(JaxConfig)}
    kw = {k: v for k, v in dataclasses.asdict(cfg).items() if k in fields}
    jcfg = JaxConfig(**{**kw, "attention_impl": impl})
    tcfg = dataclasses.replace(cfg, attention_impl=impl)
    Lq, Lv = seq
    params = JaxUniVTG(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((2, Lq, cfg.txt_dim), np.float32),
        np.ones((2, Lq), np.float32), np.zeros((2, Lv, cfg.vid_dim), np.float32),
        np.ones((2, Lv), np.float32), train=False)["params"]
    model = UniVTG(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    return JaxUniVTG(jcfg), params, model, tcfg


@pytest.mark.parametrize("dset_name,impl", [("tvsum", "xla"), ("youtube", "xla"),
                                            ("tvsum", "pallas")])
def test_eval_domain_equals_jax(corpus, yt_corpus, dset_name, impl):
    """eval_domain's mAP on the same weights, JAX's Pallas forward in
    interpret mode for "pallas"."""
    import jax

    from univtg_tpu.train import driver_hl as jdriver
    from univtg_tpu.train.steps import forward as jforward

    c = corpus if dset_name == "tvsum" else yt_corpus
    jmodel, params, model, tcfg = _jax_model(small_model(c), impl)
    cfg = HLTrainConfig(model=tcfg, data=make_cfg(c, dset_name))
    jcfg = jdriver.HLTrainConfig(data=make_cfg(c, dset_name, _jax_data_cfg()))
    got = eval_domain(cfg, model, HLDataset(cfg.data))
    os.environ["UNIVTG_PALLAS_INTERPRET"] = "1"
    try:
        step = jax.jit(lambda p, mi: jforward(jmodel, p, mi, train=False))
        want = jdriver.eval_domain(jcfg, jmodel, params, _jax_dataset(c, dset_name), step)
    finally:
        os.environ.pop("UNIVTG_PALLAS_INTERPRET", None)
    assert got == want > 0


def _jax_data_cfg():
    from univtg_tpu.data.hl import HLDataConfig as JaxHLDataConfig

    return JaxHLDataConfig


def _jax_dataset(c, dset_name):
    from univtg_tpu.data.hl import HLDataset as JaxHLDataset

    return JaxHLDataset(make_cfg(c, dset_name, _jax_data_cfg()))


def test_hl_train_trajectory_matches_jax_and_decays_the_span_head(corpus):
    """Six HL steps (labels + saliency; the span head gets no gradient) at
    lr 1e-2 and weight decay 0.1, dropouts 0, the same weights and batches
    through JAX's make_train_step (optax) and the port's: losses at rtol
    1e-4, every parameter after at 2e-5, the span head's included (torch's
    AdamW alone would skip its decay: 1e-3 of each weight a step). The
    k-slice of each in_proj_bias, whose gradient is zero analytically, is
    held at 2 lr per step, as tests/test_torch_train.py holds it."""
    import jax

    from univtg_tpu.models.losses import LossWeights as JaxWeights
    from univtg_tpu.train import steps as jsteps
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    lr, wd, n_steps = 1e-2, 0.1, 6
    cfg = small_model(corpus, hidden_dim=32, num_layers=2, dropout=0.0, droppath=0.0,
                      input_dropout=0.0)
    jmodel, params, model, tcfg = _jax_model(cfg, "xla")
    ds = HLDataset(make_cfg(corpus))
    batches = []
    for epoch in range(3):
        ds.set_epoch(epoch)
        batches += [collate_hl([ds[j] for j in idx], 8, corpus["max_clips"], 4)
                    for idx in ((0, 1, 2, 3), (4, 5, 0, 1))]
    losses = ("labels", "saliency")
    tx = jsteps.make_optimizer(lambda count: lr, wd, 0.1)
    jstate = jsteps.TrainState(params=params, opt_state=tx.init(params), step=np.int32(0))
    jstep = jsteps.make_train_step(jmodel, tx, JaxWeights(**HL_WEIGHTS), losses,
                                   donate=False)
    state = TrainState(model, make_optimizer(model.parameters(), lambda count: lr, wd, 0.1))
    step = make_train_step(LossWeights(**HL_WEIGHTS), losses)
    span0 = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("span_embed")}
    assert len(span0) == 6
    for i, b in enumerate(batches[:n_steps]):
        jstate, jm = jstep(jstate, b["model_inputs"], b["targets"], jax.random.PRNGKey(1))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b["model_inputs"].items()},
                        {k: torch.from_numpy(v) for k, v in b["targets"].items()}, 1)
        for k in jm:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} at step {i}")
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params), tcfg)
    got = state.model.state_dict()
    D = tcfg.hidden_dim
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("self_attn.in_proj_bias"):
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * lr * n_steps, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, err_msg=k)
    for k, v in span0.items():  # decayed, and by weight decay alone
        torch.testing.assert_close(got[k], v * (1 - lr * wd) ** n_steps, rtol=1e-5,
                                   atol=1e-7)
