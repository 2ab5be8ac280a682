"""The QFVS vertical of the port against the JAX package's: the semantic
matching (against JAX and against networkx's max_weight_matching, the
reference evaluator's method), Tags.mat, the synthetic UT-Egocentric tree,
``QFVSDataset`` items, ``prepare_qfvs_batch``, ``compact_to_grid``,
``qfvs_losses`` and its gradients, three-step trajectories of
``make_qfvs_train_step`` against JAX's, the dropout structure of its three
forwards, ``eval_split`` on the same weights, and ``train_qfvs`` /
``infer_qfvs`` / ``cli train-qfvs`` / ``cli infer-qfvs`` on the CPU.
"""
import contextlib
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from univtg_tpu_torch import cli
from univtg_tpu_torch.data import qfvs as qfvs_data
from univtg_tpu_torch.data.qfvs import QFVSDataConfig, QFVSDataset, prepare_qfvs_batch
from univtg_tpu_torch.data.synthetic import create_synthetic_qfvs_corpus, write_tags_mat
from univtg_tpu_torch.evals.qfvs_metric import (
    load_videos_tag,
    semantic_iou_matrix,
    semantic_matching,
)
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models.losses import LossWeights, compact_to_grid, qfvs_losses
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train.driver_qfvs import (
    QFVSTrainConfig,
    eval_split,
    infer_qfvs,
    make_qfvs_train_step,
    train_qfvs,
)
from univtg_tpu_torch.train.steps import TrainState, make_optimizer

torch.set_num_threads(1)
S, F, V_DIM, Q_DIM = 4, 16, 32, 16
QFVS_WEIGHTS = dict(b=0, g=0, f=1.0, s_intra=0.05, s_inter=0.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return create_synthetic_qfvs_corpus(str(tmp_path_factory.mktemp("qfvs")))


def data_cfg(corpus, train_videos=(1, 2, 3), cls=QFVSDataConfig, **kw):
    return cls(root=corpus["root"], train_videos=train_videos, test_videos=(4,),
               max_segment_num=S, max_frame_num=F, **kw)


def small_model(**kw):
    return ModelConfig(**{**dict(
        vid_dim=V_DIM + 2, txt_dim=Q_DIM, hidden_dim=32, num_layers=2, num_heads=4,
        ffn_dim=48, input_dropout=0.0, dropout=0.0, droppath=0.0, max_v_l=F,
        max_q_l=8), **kw})


@contextlib.contextmanager
def pallas_interpret(impl):
    if impl == "pallas":
        os.environ["UNIVTG_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        os.environ.pop("UNIVTG_PALLAS_INTERPRET", None)


# --------------------------------------------------------------- the metric


def _networkx_matching(machine, gt, tags):
    """The reference evaluator's method (upstream eval/qfvs.py:57-74): the
    max-weight matching of the bipartite semantic-IoU graph."""
    import networkx as nx

    g = nx.Graph()
    for i, m in enumerate(machine):
        for j, t in enumerate(gt):
            a, b = tags[m], tags[t]
            inter, union = float((a * b).sum()), float(((a + b) > 0).sum())
            if union and inter:
                g.add_edge(("m", i), ("g", j), weight=inter / union)
    matching = nx.max_weight_matching(g)
    total = sum(g[u][v]["weight"] for u, v in matching)
    p, r = total / len(machine), total / len(gt)
    return (0.0, 0.0, 0.0) if p + r == 0 else (p, r, 2 * p * r / (p + r))


@pytest.mark.parametrize("seed", range(5))
def test_semantic_matching_equals_jax_and_networkx(corpus, seed):
    from univtg_tpu.evals import qfvs_metric as jmetric

    rng = np.random.default_rng(seed)
    tags = corpus["videos_tag"][seed % 4]
    n = len(tags)
    machine = rng.choice(n, size=int(rng.integers(1, 9)), replace=False).tolist()
    gt = rng.choice(n, size=int(rng.integers(1, 9)), replace=False).tolist()
    got = semantic_matching(machine, gt, tags)
    np.testing.assert_allclose(got, jmetric.semantic_matching(machine, gt, tags), atol=1e-12)
    np.testing.assert_allclose(got, _networkx_matching(machine, gt, tags), atol=1e-12)
    a, b = tags[machine], tags[gt]
    np.testing.assert_allclose(semantic_iou_matrix(a, b),
                               jmetric.semantic_iou_matrix(a, b), atol=1e-12)


def test_semantic_iou_matrix_by_hand():
    a = np.array([[1, 1, 0], [0, 0, 1], [0, 0, 0]])
    b = np.array([[1, 0, 0], [0, 0, 0]])
    np.testing.assert_allclose(semantic_iou_matrix(a, b), [[0.5, 0], [0, 0], [0, 0]])


def test_tags_mat_round_trips_and_reads_as_jax_reads_it(tmp_path):
    from univtg_tpu.evals.qfvs_metric import load_videos_tag as jload

    rng = np.random.default_rng(0)
    videos_tag = [(rng.uniform(0, 1, (n, 4)) > 0.5).astype(int) for n in (7, 3, 1)]
    path = write_tags_mat(str(tmp_path / "Tags.mat"), videos_tag)
    for loaded in (load_videos_tag(path), jload(path)):
        assert len(loaded) == 3
        for want, got in zip(videos_tag, loaded, strict=True):
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ the tree and the data


def test_synthetic_tree_equals_jax(tmp_path):
    import h5py

    from univtg_tpu.data.synthetic import create_synthetic_qfvs_corpus as jcorpus

    got = create_synthetic_qfvs_corpus(str(tmp_path / "a"), seed=3)
    want = jcorpus(str(tmp_path / "b"), seed=3)
    assert got["concepts"] == want["concepts"]
    for a, b in zip(got["videos_tag"], want["videos_tag"], strict=True):
        np.testing.assert_array_equal(a, b)
    files = []
    for dirpath, _, names in os.walk(tmp_path / "a"):
        files += [os.path.relpath(os.path.join(dirpath, n), tmp_path / "a") for n in names]
    assert len(files) == 1 + 4 + 4 + 12 + 1  # pkl, grids, tags, oracles, Tags.mat
    for rel in files:
        a, b = str(tmp_path / "a" / rel), str(tmp_path / "b" / rel)
        if rel.endswith(".h5"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert set(fa) == set(fb) == {"features", "seg_len"}
                for k in fa:
                    assert fa[k].dtype == fb[k].dtype
                    np.testing.assert_array_equal(fa[k][()], fb[k][()])
        elif rel.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                ea, eb = pickle.load(fa), pickle.load(fb)
            assert list(ea) == list(eb)
            for k in ea:
                np.testing.assert_array_equal(ea[k], eb[k])
        elif rel.endswith(".mat"):
            for x, y in zip(load_videos_tag(a), load_videos_tag(b), strict=True):
                np.testing.assert_array_equal(x, y)
        else:
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), rel


def test_load_video_grid_reads_what_jax_reads(corpus):
    from univtg_tpu.data import qfvs as jqfvs

    for v in (1, 4):
        got = qfvs_data.load_video_grid(data_cfg(corpus), v)
        want = jqfvs.load_video_grid(data_cfg(corpus, cls=jqfvs.QFVSDataConfig), v)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_dataset_items_equal_jax_for_two_epochs(corpus):
    from univtg_tpu.data import qfvs as jqfvs

    ds = QFVSDataset(data_cfg(corpus))
    jds = jqfvs.QFVSDataset(data_cfg(corpus, cls=jqfvs.QFVSDataConfig))
    assert ds.items == jds.items and len(ds) == 9  # 3 videos x C(3, 2) pairs
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            a, b = ds[i], jds[i]
            assert set(a) == set(b) and a["meta"] == b["meta"]
            for k in b:
                if k == "meta":
                    continue
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} item {i}")
    # the positives are drawn per (seed, epoch, index): epochs differ somewhere
    ds.set_epoch(0)
    e0 = [ds[i]["saliency_pos_labels_oracle"] for i in range(len(ds))]
    ds.set_epoch(1)
    assert e0 != [ds[i]["saliency_pos_labels_oracle"] for i in range(len(ds))]


@pytest.mark.parametrize("max_q_l", [8, 2])
def test_prepare_qfvs_batch_is_bit_equal_and_tiles_the_text(corpus, max_q_l):
    from univtg_tpu.data import qfvs as jqfvs

    ds = QFVSDataset(data_cfg(corpus))
    for i in (0, 4, 8):
        item = ds[i]
        got = prepare_qfvs_batch(item, max_q_l)
        want = jqfvs.prepare_qfvs_batch(item, max_q_l)
        for g, w in zip(got[:3], want[:3], strict=True):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(got[3], want[3])
        in1, in2, ino, mask_flat = got
        n_tok = min(max_q_l, 3)
        assert in1["src_vid"].shape == (S, F, V_DIM + 2)
        for s in range(S):  # the text is tiled over the segments
            np.testing.assert_array_equal(in1["src_txt"][s], item["tokens_1"][:max_q_l])
            np.testing.assert_array_equal(in2["src_txt"][s], item["tokens_2"][:max_q_l])
        # the oracle's text is [t1; t2] with an all-ones mask
        np.testing.assert_array_equal(
            ino["src_txt"], np.concatenate([in1["src_txt"], in2["src_txt"]], axis=1))
        assert ino["src_txt_mask"].shape == (S, 2 * n_tok) and ino["src_txt_mask"].all()
        np.testing.assert_array_equal(mask_flat, item["mask_GT"].reshape(-1))


def test_compact_to_grid_is_exact(corpus):
    from univtg_tpu.models.losses import compact_to_grid as jgrid

    rng = np.random.default_rng(1)
    seg_len = np.array([3, 0, 5, 2])
    vec = rng.standard_normal(10).astype(np.float32)
    got = compact_to_grid(vec, seg_len, 4, 6)
    want = np.zeros(24, np.float32)
    want[0:3], want[12:17], want[18:20] = vec[:3], vec[3:8], vec[8:10]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgrid(vec, seg_len, 4, 6))
    item = QFVSDataset(data_cfg(corpus))[0]
    n = int(item["seg_len"].sum())
    grid = compact_to_grid(item["concept1_GT"][:n], item["seg_len"], S, F)
    assert grid.sum() == item["concept1_GT"][:n].sum()
    assert (grid * (1 - item["mask_GT"].reshape(-1))).sum() == 0


# ----------------------------------------------------------------- the loss


@pytest.mark.parametrize("positives", ["some", "none"])
def test_qfvs_losses_and_grads_equal_jax(corpus, positives):
    import jax
    import jax.numpy as jnp

    from univtg_tpu.models.losses import qfvs_losses as jlosses

    item = QFVSDataset(data_cfg(corpus))[1]
    n = int(item["seg_len"].sum())
    gt = compact_to_grid(item["concept2_GT"][:n], item["seg_len"], S, F)
    if positives == "none":
        gt = np.zeros_like(gt)
    mask = item["mask_GT"].reshape(-1).astype(np.float32)
    rng = np.random.default_rng(2)
    probs = rng.uniform(0.01, 0.99, (S, F, 1)).astype(np.float32)
    probs[0, 0, 0], probs[1, 1, 0] = 1.0, 0.0  # the BCE floor at both ends
    sal = rng.standard_normal((S, F)).astype(np.float32)

    def jtotal(p, s):
        ld = jlosses({"pred_logits": p, "saliency_scores": s}, jnp.asarray(gt),
                     jnp.asarray(mask))
        return ld["loss_f"] + 0.05 * ld["loss_s_intra"] + ld["loss_s_inter"], ld

    (jt, jld), (jgp, jgs) = jax.value_and_grad(jtotal, argnums=(0, 1), has_aux=True)(
        jnp.asarray(probs), jnp.asarray(sal))
    p_t = torch.from_numpy(probs).requires_grad_()
    s_t = torch.from_numpy(sal).requires_grad_()
    ld = qfvs_losses({"pred_logits": p_t, "saliency_scores": s_t}, torch.from_numpy(gt),
                     torch.from_numpy(mask))
    assert set(ld) == set(jld) == {"loss_f", "loss_s_intra", "loss_s_inter"}
    (ld["loss_f"] + 0.05 * ld["loss_s_intra"] + ld["loss_s_inter"]).backward()
    for k in jld:
        np.testing.assert_allclose(ld[k].item(), float(jld[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(p_t.grad.numpy(), np.asarray(jgp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s_t.grad.numpy(), np.asarray(jgs), rtol=1e-5, atol=1e-6)
    assert np.isfinite(p_t.grad.numpy()).all()
    if positives == "none":
        assert ld["loss_f"].item() == ld["loss_s_intra"].item() == 0.0
        assert not p_t.grad.any() and not s_t.grad.any()


# --------------------------------------------------------- the train step


def _jax_model(cfg: ModelConfig):
    """The JAX twin of a port config, its init params, and the port's model
    holding the same weights."""
    import jax

    from univtg_tpu.models import ModelConfig as JaxConfig
    from univtg_tpu.models import UniVTG as JaxUniVTG
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    fields = {f.name for f in dataclasses.fields(JaxConfig)}
    jcfg = JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})
    params = JaxUniVTG(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((2, 6, cfg.txt_dim), np.float32),
        np.ones((2, 6), np.float32), np.zeros((2, F, cfg.vid_dim), np.float32),
        np.ones((2, F), np.float32), train=False)["params"]
    model = UniVTG(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return JaxUniVTG(jcfg), params, model


def _step_inputs(ds, index, max_q_l=8):
    """(in1, in2, in_oracle, gt1, gt2, gt_oracle, mask_flat) as numpy."""
    item = ds[index]
    in1, in2, ino, mask_flat = prepare_qfvs_batch(item, max_q_l)
    n = int(item["seg_len"].sum())
    gts = [compact_to_grid(item[k][:n], item["seg_len"], S, F)
           for k in ("concept1_GT", "concept2_GT", "oracle_summary")]
    return in1, in2, ino, *gts, mask_flat


def _torch(args):
    return [({k: torch.from_numpy(v) for k, v in a.items()} if isinstance(a, dict)
             else torch.from_numpy(a)) for a in args]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_qfvs_train_step_matches_jax_for_three_steps(corpus, impl):
    """Three steps of make_qfvs_train_step at dropouts 0, the same weights
    and items, against JAX's (optax; the Pallas kernels in interpret mode
    for "pallas"): every loss at rtol 1e-4, the global norm of the summed
    gradients at rtol 1e-4 (JAX's from value_and_grad of the same total),
    every parameter after at 2e-5 (the k-slice of in_proj_bias, whose
    gradient is zero analytically, at 2 lr per step, as
    tests/test_torch_train.py holds it)."""
    import jax
    import optax

    from univtg_tpu.models.losses import LossWeights as JaxWeights
    from univtg_tpu.models.losses import qfvs_losses as jlosses
    from univtg_tpu.train import driver_qfvs as jdriver
    from univtg_tpu.train import steps as jsteps
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    lr, wd, n_steps = 1e-3, 1e-4, 3
    cfg = small_model(attention_impl=impl)
    jmodel, params, model = _jax_model(cfg)
    ds = QFVSDataset(data_cfg(corpus))
    inputs = [_step_inputs(ds, i) for i in (0, 5, 7)]
    tx = jsteps.make_optimizer(lambda count: lr, wd, 0.1)
    jstate = jsteps.TrainState(params=params, opt_state=tx.init(params), step=np.int32(0))
    state = TrainState(model, make_optimizer(model.parameters(), lambda count: lr, wd, 0.1))
    step = make_qfvs_train_step(LossWeights(**QFVS_WEIGHTS))
    wdict = JaxWeights(**QFVS_WEIGHTS).as_dict()

    def jtotal(p, in1, in2, ino, g1, g2, go, mask_flat):
        total = 0.0
        for mi, gt in ((in1, g1), (in2, g2), (ino, go)):
            ld = jlosses(jsteps.forward(jmodel, p, mi, train=False), gt, mask_flat)
            total = total + sum(v * wdict[k] for k, v in ld.items() if k in wdict)
        return total

    with pallas_interpret(impl):
        jstep = jdriver.make_qfvs_train_step(jmodel, tx, JaxWeights(**QFVS_WEIGHTS))
        jgrad = jax.jit(jax.grad(jtotal))
        for i, args in enumerate(inputs):
            grads = jgrad(jstate.params, *args)
            jnorm = float(optax.global_norm(grads))
            jstate, jm = jstep(jstate, *args, jax.random.PRNGKey(1))
            state, m = step(state, *_torch(args), 1)
            assert set(m) == set(jm) | {"grad_norm"}
            for k in jm:
                np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, atol=1e-7,
                                           err_msg=f"{k} at step {i}")
            np.testing.assert_allclose(m["grad_norm"].item(), jnorm, rtol=1e-4)
    assert state.step == n_steps
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    got = state.model.state_dict()
    D = cfg.hidden_dim
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("self_attn.in_proj_bias"):
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * lr * n_steps, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_the_three_forwards_share_their_dropout_draws(corpus, impl):
    """The JAX step hands one ``rngs`` to its three forwards; the port seeds
    each from the same (seed, step) generator state. At every dropout > 0
    (input, attention and droppath), c1 and c2 fed the same query give
    equal outputs within a step, other outputs at the next step (rate 0:
    the weights stay), and the masks are live (train differs from eval)."""
    cfg = small_model(attention_impl=impl, input_dropout=0.5, dropout=0.1, droppath=0.1)
    model = UniVTG(cfg, device="cpu", seed=0)
    state = TrainState(model, make_optimizer(model.parameters(), lambda count: 0.0, 0.0,
                                             0.1))
    seen = []
    model.register_forward_hook(
        lambda mod, args, kwargs, out: seen.append(
            {k: out[k].detach().clone() for k in ("pred_logits", "saliency_scores")})
        if kwargs.get("train") else None, with_kwargs=True)
    in1, _, ino, g1, _, go, mask = _torch(_step_inputs(QFVSDataset(data_cfg(corpus)), 2))
    step = make_qfvs_train_step(LossWeights(**QFVS_WEIGHTS))
    per_step = []
    for _ in range(2):
        seen.clear()
        _, m = step(state, in1, in1, ino, g1, g1, go, mask, 7)
        assert len(seen) == 3
        for k in seen[0]:
            torch.testing.assert_close(seen[0][k], seen[1][k], rtol=0, atol=0)
        assert m["c1_loss_f"].item() == m["c2_loss_f"].item()
        per_step.append(seen[0])
    assert not torch.equal(per_step[0]["saliency_scores"], per_step[1]["saliency_scores"])
    with torch.inference_mode():
        model.eval()
        from univtg_tpu_torch.train.steps import forward

        plain = forward(model, in1, train=False)["saliency_scores"]
    assert not torch.equal(per_step[0]["saliency_scores"], plain)


# ------------------------------------------------------------ eval and driver


@pytest.mark.parametrize("impl,gather", [("xla", False), ("xla", True), ("pallas", False)])
def test_eval_split_equals_jax_on_the_same_weights(corpus, impl, gather):
    import jax

    from univtg_tpu.data import qfvs as jqfvs
    from univtg_tpu.train import driver_qfvs as jdriver
    from univtg_tpu.train.steps import forward as jforward

    jmodel, params, model = _jax_model(small_model(attention_impl=impl))
    kw = dict(top_percent=0.1, score_gather=gather, score_ensemble=True)
    cfg = QFVSTrainConfig(model=small_model(attention_impl=impl),
                          data=data_cfg(corpus, **kw), max_q_l=8)
    jcfg = jdriver.QFVSTrainConfig(data=data_cfg(corpus, cls=jqfvs.QFVSDataConfig, **kw),
                                   max_q_l=8)
    for test_video in (1, 4):
        got = eval_split(cfg, model, test_video, corpus["videos_tag"])
        with pallas_interpret(impl):
            fwd = jax.jit(lambda p, mi: jforward(jmodel, p, mi, train=False))
            want = jdriver.eval_split(jcfg, jmodel, params, test_video,
                                      corpus["videos_tag"], fwd=fwd)
        assert got == want and got["F"] > 0, (test_video, got, want)


def _qfvs_cfg(corpus, results_dir, **kw):
    return QFVSTrainConfig(**{**dict(
        model=small_model(input_dropout=0.1), data=data_cfg(corpus),
        tags_mat_path=corpus["tags_mat_path"], results_dir=str(results_dir), n_epoch=2,
        eval_epoch=1, splits=((2, 3, 4), (1, 2, 3)), max_q_l=8), **kw})


def test_train_qfvs_writes_metrics_and_checkpoints_infer_qfvs_reads(corpus, tmp_path):
    """train_qfvs on the CPU: each split's best F/R/P and AVG_F, printed and
    in qfvs_metrics.json; model_V{n}_best.ckpt per split in the upstream
    container, its step that of a fresh AdamW per split (9 items an
    epoch); infer_qfvs on that directory gives the same numbers."""
    cfg = _qfvs_cfg(corpus, tmp_path / "run")
    results = train_qfvs(cfg, device="cpu")
    assert set(results) == {"V1", "V4", "AVG_F"}
    for k in ("V1", "V4"):
        assert set(results[k]) == {"F", "R", "P"} and results[k]["F"] > 0
    assert results["AVG_F"] == round((results["V1"]["F"] + results["V4"]["F"]) / 2, 2)
    with open(tmp_path / "run" / "qfvs_metrics.json") as f:
        assert json.load(f) == results
    for v in ("V1", "V4"):
        blob = ckpt.read_checkpoint(str(tmp_path / "run" / f"model_{v}_best.ckpt"))
        assert set(blob) == {"model", "optimizer", "epoch", "step", "opt"}
        assert blob["step"] == 9 * (blob["epoch"] + 1)
    assert infer_qfvs(cfg, str(tmp_path / "run"), device="cpu") == results
    assert infer_qfvs(cfg, str(tmp_path / "run"), videos_tag=corpus["videos_tag"],
                      device="cpu") == results


def test_train_qfvs_reads_every_grid_through_load_video_grid(corpus, tmp_path, monkeypatch):
    """load_video_grid is the one grid read: replaced in data/qfvs.py, it
    serves training and evaluation with no h5 file (as chip_smoke.py runs
    where h5py is not installed) and the numbers do not move."""
    cfg = _qfvs_cfg(corpus, tmp_path / "h5", n_epoch=1)
    want = train_qfvs(cfg, device="cpu")
    grids = {v: qfvs_data.load_video_grid(cfg.data, v) for v in (1, 2, 3, 4)}
    calls = []

    def from_memory(data_cfg, vid):
        calls.append(vid)
        return grids[vid]

    monkeypatch.setattr(qfvs_data, "load_video_grid", from_memory)
    monkeypatch.setattr(qfvs_data, "_h5_path", lambda *a: "/nonexistent.h5")
    got = train_qfvs(dataclasses.replace(cfg, results_dir=str(tmp_path / "mem")),
                     device="cpu")
    assert got == want and sorted(set(calls)) == [1, 2, 3, 4]


def test_train_qfvs_runtime_knobs(corpus, tmp_path):
    """Prefetch off and on give the same results; the profiler window
    writes one trace over the first steps."""
    profile_dir = str(tmp_path / "trace")
    base = _qfvs_cfg(corpus, tmp_path / "k0", n_epoch=1, prefetch_depth=0)
    want = train_qfvs(dataclasses.replace(base, splits=((2, 3, 4),)), device="cpu")
    got = train_qfvs(dataclasses.replace(
        base, splits=((2, 3, 4),), prefetch_depth=2, results_dir=str(tmp_path / "k2"),
        profile_dir=profile_dir, profile_steps=1), device="cpu")
    assert got == want
    assert os.path.isdir(profile_dir) and os.listdir(profile_dir)


def _cli_overrides(corpus):
    return [f"data.root={corpus['root']}", f"data.max_segment_num={S}",
            f"data.max_frame_num={F}", f"tags_mat_path={corpus['tags_mat_path']}",
            f"model.vid_dim={V_DIM + 2}", f"model.txt_dim={Q_DIM}", "model.hidden_dim=32",
            "model.num_layers=1", "model.num_heads=4", "model.ffn_dim=48",
            f"model.max_v_l={F}", "model.attention_impl=pallas", "max_q_l=8",
            "splits=((2, 3, 4),)"]


def test_cli_train_qfvs_and_infer_qfvs_on_the_cpu(corpus, tmp_path, capsys):
    run = tmp_path / "cli_qfvs"
    cli.main(["train-qfvs", "--preset", "qfvs", "--device", "cpu", *_cli_overrides(corpus),
              f"results_dir={run}", "n_epoch=1"])
    trained = json.loads(capsys.readouterr().out)
    assert set(trained) == {"V1", "AVG_F"} and (run / "model_V1_best.ckpt").exists()
    cli.main(["infer-qfvs", "--preset", "qfvs", "--ckpt-dir", str(run), "--device", "cpu",
              *_cli_overrides(corpus)])
    assert json.loads(capsys.readouterr().out) == trained


def test_qfvs_entry_points_default_to_cuda(corpus, tmp_path):
    p = cli.build_parser()
    assert p.parse_args(["train-qfvs", "--preset", "qfvs"]).device == "cuda"
    args = p.parse_args(["infer-qfvs", "--preset", "qfvs", "--ckpt-dir", "d"])
    assert args.device == "cuda" and args.ckpt_dir == "d"
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    cfg = _qfvs_cfg(corpus, tmp_path / "x")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_qfvs(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_qfvs(cfg, str(tmp_path))
