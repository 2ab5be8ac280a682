"""The port's Moment-DETR against the JAX package's, and the port reading the
JAX package's checkpoints.

One small config (vid 20, txt 16, hidden 64, 2 encoder and 2 decoder layers,
4 heads, FFN 96, 6 queries, max_v_l 24, max_q_l 10, dropouts 0). Each check
builds the port's model, carries its weights into JAX with
``md_params_from_torch_state_dict`` and runs JAX's function on the same
numpy inputs: the forward at 1e-5, the span algebra at 1e-7, the matcher's
assignments equal (a differing one only where its total cost is within 1e-5
relative of JAX's), the losses at 1e-6 and their gradients at 1e-5, three
train steps at loss and grad-norm rtol 1e-4 and parameters 2e-5 (the k-slice
of each in_proj_bias, whose gradient is zero analytically, at 2 lr steps, as
tests/test_torch_train.py holds it), the decoded rows equal. Then the
driver on the CPU, as tests/test_moment_detr_driver.py drives JAX's, and
the flax msgpack reader against flax's own.
"""
import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from univtg_tpu.core import spans as jspans
from univtg_tpu.interop.torch_ckpt import md_params_from_torch_state_dict
from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.models import moment_detr as jmd
from univtg_tpu.models.losses import LossWeights as JaxWeights
from univtg_tpu.train import checkpoint as jckpt
from univtg_tpu.train import infer_mr as jinfer
from univtg_tpu.train import schedule as jschedule
from univtg_tpu.train import steps as jsteps
from univtg_tpu_torch.core import spans
from univtg_tpu_torch.data.collate import collate_mr
from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.interop import (
    flax_msgpack,
    load_torch_checkpoint,
    md_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models import moment_detr as md
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr
from univtg_tpu_torch.train.infer_mr import decode_batch
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import (
    TrainState,
    make_md_eval_step,
    make_md_train_step,
    make_optimizer,
)

torch.set_num_threads(1)
SMALL = dict(vid_dim=20, txt_dim=16, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, num_queries=6, num_decoder_layers=2, max_v_l=24, max_q_l=10,
             dropout=0.0, droppath=0.0, input_dropout=0.0)
B, LT, LV = 3, 7, 24
LR = 1e-3
SCHED = (LR, 2, 200, 0.1, 2)  # lr, warmup, drop, gamma, steps per epoch
WEIGHTS = dict(b=10, g=1, f=4, s_intra=1.0, s_inter=0.0)
VARIANTS = {  # name -> (span_loss_type, use_txt_pos, contrastive_align)
    "l1": ("l1", False, False),
    "ce": ("ce", False, False),
    "l1_txt_pos": ("l1", True, False),
    "l1_align": ("l1", False, True),
    "ce_txt_pos_align": ("ce", True, True),
}


def _cfgs(span="l1", txt_pos=False, align=False, **kw):
    kw = {**SMALL, "span_loss_type": span, "use_txt_pos": txt_pos,
          "contrastive_align": align, **kw}
    return jmd.MomentDETRConfig(**kw), md.MomentDETRConfig(**kw)


def _pair(span="l1", txt_pos=False, align=False, seed=0, **kw):
    """(JAX config, JAX params, port config, port model) of one init."""
    jcfg, cfg = _cfgs(span, txt_pos, align, **kw)
    model = md.MomentDETR(cfg, device="cpu", seed=seed)
    params = md_params_from_torch_state_dict(model.state_dict(), jcfg)
    return jcfg, params, cfg, model


def _inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)
    txt_mask = np.ones((b, LT), np.float32)
    vid_mask = np.ones((b, LV), np.float32)
    txt_mask[0, 5:] = 0
    vid_mask[0, 17:] = 0
    vid_mask[-1, 9:] = 0
    return (rng.standard_normal((b, LT, 16)).astype(np.float32), txt_mask,
            rng.standard_normal((b, LV, 20)).astype(np.float32), vid_mask)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _close(got, want, atol, path="out"):
    """got (torch tree) against want (JAX tree), leaf by leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, atol, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                                   atol=atol, err_msg=path)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    jcfg, params, cfg, model = _pair(*VARIANTS[variant])
    args = _inputs()
    want = jmd.MomentDETR(jcfg).apply({"params": params["params"]}, *args)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    assert got["pred_spans"].shape[-1] == (2 if cfg.span_loss_type == "l1" else 48)
    assert len(got["aux_outputs"]) == 1
    assert ("proj_queries" in got) == cfg.contrastive_align
    _close(got, want, 1e-5)


@pytest.mark.parametrize("txt_pos,align", [(False, False), (True, True)])
def test_md_state_dict_is_the_inverse_of_the_jax_mapper(txt_pos, align):
    _, params, cfg, model = _pair("l1", txt_pos, align)
    sd = model.state_dict()
    back = md_state_dict_from_jax_params(params, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # ... and a JAX init carried into the port runs the JAX forward
    jcfg, cfg = _cfgs("ce", txt_pos, align)
    args = _inputs(1)
    jparams = jmd.MomentDETR(jcfg).init(jax.random.PRNGKey(3), *args)["params"]
    port = md.MomentDETR(cfg, device="cpu")
    port.load_state_dict(md_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams), cfg), strict=True)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    _close(got, jmd.MomentDETR(jcfg).apply({"params": jparams}, *args), 1e-5)


def test_upstream_checkpoint_loads_with_no_mapper(tmp_path):
    _, _, cfg, model = _pair("l1", True, True)
    sd = model.state_dict()
    blob = {"model": {"module." + k: v for k, v in sd.items()}, "opt": {"x": 1}}
    blob["model"]["module.unused.weight"] = torch.zeros(3)
    torch.save(blob, tmp_path / "md.ckpt")
    got = load_torch_checkpoint(str(tmp_path / "md.ckpt"), cfg)
    assert list(got) == list(sd) and all(torch.equal(got[k], sd[k]) for k in sd)


def _spans(rng, *shape):
    a = rng.uniform(0, 1, (*shape, 2)).astype(np.float32)
    return np.sort(a, axis=-1)


@pytest.mark.parametrize("fn", ["iou_cross", "giou_cross"])
def test_cross_span_algebra_matches_jax(fn):
    rng = np.random.default_rng(4)
    a, b = _spans(rng, 5, 6), _spans(rng, 5, 4)
    a[0, 0] = b[0, 0]  # identical spans
    want = getattr(jspans, fn)(a, b)
    got = getattr(spans, fn)(torch.from_numpy(a), torch.from_numpy(b))
    if fn == "iou_cross":
        assert len(got) == 2 and got[0].shape == (5, 6, 4)
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)


def _match_inputs(span, seed, b=16, q=6, w=5, L=24):
    rng = np.random.default_rng(seed)
    n_windows = rng.integers(0, w + 1, b).astype(np.int32)
    n_windows[:w + 1] = np.arange(w + 1)  # every count 0..5
    logits = rng.standard_normal((b, q, 2)).astype(np.float32)
    if span == "l1":
        pred = rng.uniform(0.05, 0.95, (b, q, 2)).astype(np.float32)
        labels = np.stack([rng.uniform(0.2, 0.8, (b, w)), rng.uniform(0.05, 0.3, (b, w))],
                          -1).astype(np.float32)
    else:
        pred = rng.standard_normal((b, q, 2 * L)).astype(np.float32)
        st = rng.integers(0, L, (b, w))
        labels = np.stack([st, np.minimum(st + rng.integers(0, 6, (b, w)), L - 1)],
                          -1).astype(np.float32)
    for i, n in enumerate(n_windows):  # zero padding, as collate_mr pads
        labels[i, n:] = 0
    return {"pred_logits": logits, "pred_spans": pred}, labels, n_windows


def _cost(outputs, labels, span):
    """The matcher's cost, float64 numpy (for the near-tie rule)."""
    t = {k: torch.from_numpy(v).double() for k, v in outputs.items()}
    lab = torch.from_numpy(labels).double()
    prob = torch.softmax(t["pred_logits"], -1)[..., 0]
    if span == "ce":
        b, q, two_l = t["pred_spans"].shape
        sp = torch.softmax(t["pred_spans"].reshape(b, q, 2, two_l // 2), -1)
        idx = lab.long()
        w = idx.shape[1]
        p_st = torch.gather(sp[:, :, 0], 2, idx[:, None, :, 0].expand(b, q, w))
        p_ed = torch.gather(sp[:, :, 1], 2, idx[:, None, :, 1].expand(b, q, w))
        return (10 * (-p_st - p_ed) - 4 * prob[:, :, None]).numpy()
    l1 = (t["pred_spans"][:, :, None] - lab[:, None]).abs().sum(-1)
    giou = spans.giou_cross(spans.cxw_to_xx(t["pred_spans"]), spans.cxw_to_xx(lab))
    return (10 * l1 - giou - 4 * prob[:, :, None]).numpy()


def _same_assignment(got, want, cost, n_windows):
    """Equal, or equal in cost within 1e-5 relative (a near-tie)."""
    for b, n in enumerate(n_windows):
        g, w = got[b], want[b]
        assert (g[n:] == -1).all() and (w[n:] == -1).all()
        if (g == w).all():
            continue
        assert len(set(g[:n])) == n
        cg = cost[b, g[:n], np.arange(n)].sum()
        cw = cost[b, w[:n], np.arange(n)].sum()
        assert abs(cg - cw) <= 1e-5 * max(abs(cw), 1e-12), (b, g, w, cg, cw)


@pytest.mark.parametrize("impl", ["exhaustive", "callback"])
@pytest.mark.parametrize("span", ["l1", "ce"])
def test_hungarian_match_matches_jax(span, impl):
    for seed in range(3):
        outputs, labels, n_windows = _match_inputs(span, seed)
        want = np.asarray(jmd.hungarian_match(
            {k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(labels),
            jnp.asarray(n_windows), impl=impl, span_loss_type=span))
        got = md.hungarian_match(_torch(outputs), torch.from_numpy(labels),
                                 torch.from_numpy(n_windows), impl=impl,
                                 span_loss_type=span)
        assert got.dtype == torch.int32 and got.shape == want.shape
        cost = _cost(outputs, labels, span)
        _same_assignment(got.numpy(), want, cost, n_windows)
        # and the two impls of the port agree with each other
        other = md.hungarian_match(_torch(outputs), torch.from_numpy(labels),
                                   torch.from_numpy(n_windows),
                                   impl={"exhaustive": "callback",
                                         "callback": "exhaustive"}[impl],
                                   span_loss_type=span)
        _same_assignment(other.numpy(), got.numpy(), cost, n_windows)


def test_auto_matcher_enumerates_small_tables_only(monkeypatch):
    outputs, labels, n_windows = _match_inputs("l1", 0, q=10)
    exhaustive = md.hungarian_match(_torch(outputs), torch.from_numpy(labels),
                                    torch.from_numpy(n_windows), impl="exhaustive")
    called = []
    monkeypatch.setattr(md, "_lsap_host", lambda *a: called.append(1) or
                        np.asarray(exhaustive))
    auto = md.hungarian_match(_torch(outputs), torch.from_numpy(labels),
                              torch.from_numpy(n_windows))  # P(10, 5) = 30240
    assert torch.equal(auto, exhaustive) and not called
    monkeypatch.setattr(md, "EXHAUSTIVE_MAX_PERMS", 30239)
    md.hungarian_match(_torch(outputs), torch.from_numpy(labels),
                       torch.from_numpy(n_windows))
    assert called == [1]
    with pytest.raises(ValueError, match="matcher impl"):
        md.hungarian_match(_torch(outputs), torch.from_numpy(labels),
                           torch.from_numpy(n_windows), impl="greedy")


def _loss_inputs(span, align, seed=0):
    outputs, labels, n_windows = _match_inputs(span, seed, b=8)
    rng = np.random.default_rng(seed + 10)
    if span == "l1":
        aux_spans = rng.uniform(0.05, 0.95, outputs["pred_spans"].shape)
    else:
        aux_spans = rng.standard_normal(outputs["pred_spans"].shape)
    outputs["aux_outputs"] = [{
        "pred_logits": rng.standard_normal(outputs["pred_logits"].shape).astype(np.float32),
        "pred_spans": aux_spans.astype(np.float32)}]
    outputs["saliency_scores"] = rng.standard_normal((8, LV)).astype(np.float32)
    if align:
        def unit(*shape):
            x = rng.standard_normal(shape)
            return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

        outputs["proj_queries"] = unit(8, 6, 16)
        outputs["proj_txt_mem"] = unit(8, LT, 16)
    targets = {"span_labels": labels, "n_windows": n_windows,
               "saliency_pos_labels": rng.integers(0, LV, (8, 2)).astype(np.int32),
               "saliency_neg_labels": rng.integers(0, LV, (8, 2)).astype(np.int32)}
    return outputs, targets


@pytest.mark.parametrize("span,align", [("l1", False), ("l1", True), ("ce", True)])
def test_losses_and_gradients_match_jax(span, align):
    outputs, targets = _loss_inputs(span, align)
    kw = dict(eos_coef=0.1, saliency_margin=0.2, span_loss_type=span)

    def jtotal(out):
        ld = jmd.moment_detr_losses(out, jax.tree_util.tree_map(jnp.asarray, targets), **kw)
        return sum(ld.values()), ld

    (_, want), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, outputs))
    leaves = _torch(outputs)
    flat = [leaves["pred_logits"], leaves["pred_spans"], leaves["saliency_scores"],
            *(t for a in leaves["aux_outputs"] for t in a.values())]
    if align:
        flat += [leaves["proj_queries"], leaves["proj_txt_mem"]]
    for t in flat:
        t.requires_grad_(True)
    got = md.moment_detr_losses(leaves, _torch(targets), **kw)
    expect = {"loss_b", "loss_g", "loss_f", "loss_s_intra", "loss_b_0", "loss_g_0",
              "loss_f_0"} | ({"loss_contrastive_align"} if align else set())
    assert set(got) == set(want) == expect
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    sum(got.values()).backward()
    grads = {k: v.grad for k, v in leaves.items() if k != "aux_outputs"}
    grads["aux_outputs"] = [{k: v.grad for k, v in a.items()}
                            for a in leaves["aux_outputs"]]
    _close(grads, jgrads, 1e-5, "grad")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return create_synthetic_mr_corpus(str(tmp_path_factory.mktemp("md")), n_train=24,
                                      n_val=8, seed=5)


def _data(corpus, span="l1", split="train_path"):
    return MRDataConfig(
        dset_name="qvhighlights", data_path=corpus[split],
        v_feat_dirs=corpus["v_feat_dirs"], q_feat_dir=corpus["q_feat_dir"],
        q_feat_dim=corpus["q_dim"], v_feat_dim=corpus["v_dim"],
        clip_len=corpus["clip_len"], max_q_l=10, max_v_l=corpus["max_clips"],
        span_loss_type=span)


def _batches(corpus, span, n, split="train_path", bsz=4):
    ds = MRDataset(_data(corpus, span, split))
    return [collate_mr([ds[j] for j in range(i * bsz, (i + 1) * bsz)], 10,
                       corpus["max_clips"]) for i in range(n)]


def _md_kw(corpus, **kw):
    return dict(vid_dim=corpus["v_dim"] + 2, txt_dim=corpus["q_dim"],
                max_v_l=corpus["max_clips"], **kw)


@pytest.mark.parametrize("span,align", [("l1", False), ("ce", True)])
def test_three_train_steps_match_jax(corpus, span, align):
    """Loss and grad norm per step at rtol 1e-4, parameters after 3 steps at
    2e-5; the total weighs loss_contrastive_align 0."""
    jcfg, params, cfg, model = _pair(span, False, align, **_md_kw(corpus))
    tx = jsteps.make_optimizer(jschedule.build_schedule(*SCHED), 1e-4, 0.1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params["params"])
    jstate = jsteps.TrainState(params=jparams, opt_state=tx.init(jparams),
                               step=np.int32(0))
    jstep = jsteps.make_md_train_step(jmd.MomentDETR(jcfg), tx, JaxWeights(**WEIGHTS),
                                      0.1, 0.2, donate=False, span_loss_type=span)
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(*SCHED),
                                             1e-4, 0.1))
    step = make_md_train_step(LossWeights(**WEIGHTS), 0.1, 0.2, span)
    wd = LossWeights(**WEIGHTS).as_dict()
    for i, batch in enumerate(_batches(corpus, span, 3)):
        mi, tg = batch["model_inputs"], batch["targets"]
        jstate, jm = jstep(jstate, mi, tg, jax.random.PRNGKey(1))
        state, m = step(state, _torch(mi), _torch(tg), 1)
        assert set(m) == set(jm)
        for k in ("loss_overall", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                       err_msg=f"{k} at step {i}")
        weighted = sum(wd[re.sub(r"_\d+$", "", k)] * v.item() for k, v in m.items()
                       if k.startswith("loss_") and k not in (
                           "loss_overall", "loss_contrastive_align"))
        assert ("loss_contrastive_align" in m) == align
        np.testing.assert_allclose(m["loss_overall"].item(), weighted, rtol=1e-6)
    want = md_state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    D = cfg.hidden_dim
    for k, w in want.items():
        g = state.model.state_dict()[k]
        if k.endswith("in_proj_bias"):
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * LR * 3, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5, err_msg=k)
    assert state.step == 3


def _fp16_close(got, want):
    """Saliency is rounded to fp16, as the reference's .half(): an f32
    difference of an ulp that crosses a rounding boundary reads one fp16
    step, which is the limit."""
    step = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
    assert (np.abs(got - want) <= np.maximum(step, 1e-5)).all()


@pytest.mark.parametrize("span", ["l1", "ce"])
def test_eval_step_and_decoded_rows_match_jax(corpus, span):
    jcfg, params, cfg, model = _pair(span, **_md_kw(corpus, num_queries=5))
    [batch] = _batches(corpus, span, 1, split="val_path", bsz=8)
    mi, tg = batch["model_inputs"], batch["targets"]
    jout = jsteps.make_md_eval_step(jmd.MomentDETR(jcfg), span, 2.0)(params["params"],
                                                                     mi, tg)
    out = make_md_eval_step(span, 2.0)(model, _torch(mi), _torch(tg))
    for k in ("scores", "spans", "valid_len"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    _fp16_close(out["saliency"].numpy(), np.asarray(jout["saliency"]))
    assert out["absolute_spans"] == bool(jout["absolute_spans"]) == (span == "ce")
    rows = decode_batch(out, batch["meta"])
    want = jinfer.decode_batch(jout, batch["meta"])
    assert [r["qid"] for r in rows] == [r["qid"] for r in want]
    for r, w in zip(rows, want):
        assert len(r["pred_relevant_windows"]) == 5
        np.testing.assert_allclose(r["pred_relevant_windows"], w["pred_relevant_windows"],
                                   rtol=0, atol=1.5e-4)
        _fp16_close(np.asarray(r["pred_saliency_scores"]),
                    np.asarray(w["pred_saliency_scores"]))
        if span == "ce":
            assert r["pred_relevant_windows"] == w["pred_relevant_windows"]


def _train_cfg(corpus, tmp_path, span, **kw):
    model = md.MomentDETRConfig(**{**_md_kw(corpus), "input_dropout": 0.1,
                                   "max_q_l": 10, "span_loss_type": span, **kw})
    return TrainConfig(
        model=model, model_id="moment_detr",
        train_data=_data(corpus, span), eval_data=_data(corpus, span, "val_path"),
        results_dir=str(tmp_path / f"{span}_run"), bsz=8, eval_bsz=8, eval_epoch=1,
        lr=3e-4, lr_warmup=1, save_interval=-1, num_io_threads=2,
        weights=LossWeights(**WEIGHTS), eval_mode=None)


def _rows(run):
    with open(os.path.join(run, "latest_val_preds.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_mr_trains_moment_detr_on_the_cpu(corpus, tmp_path):
    """tests/test_moment_detr_driver.py's l1 run, with scan_steps=2, which
    Moment-DETR runs step by step; the best checkpoint reloads to the same
    rows, and opt.json reads back as a MomentDETRConfig."""
    cfg = dataclasses.replace(
        _train_cfg(corpus, tmp_path, "l1", hidden_dim=64, num_layers=1, num_heads=4,
                   ffn_dim=96, num_queries=6, num_decoder_layers=2),
        n_epoch=2, scan_steps=2)
    metrics, best = train_mr(cfg, device="cpu")
    assert os.path.exists(best) and "MR-full-mAP-key" in metrics["brief"]
    with open(os.path.join(cfg.results_dir, "train_log.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [line["steps"] for line in lines] == [3, 3]
    assert lines[-1]["loss_overall"] < lines[0]["loss_overall"]
    assert {"loss_b_0", "loss_g_0", "loss_f_0", "grad_norm"} <= set(lines[0])
    rows = _rows(cfg.results_dir)
    assert len(rows[0]["pred_relevant_windows"]) == 6
    from univtg_tpu_torch.train.config_io import load_config

    assert load_config(TrainConfig, cfg.results_dir).model == cfg.model


def test_train_mr_ce_windows_lie_on_the_clip_grid(corpus, tmp_path):
    cfg = dataclasses.replace(
        _train_cfg(corpus, tmp_path, "ce", hidden_dim=48, num_layers=1, num_heads=4,
                   ffn_dim=64, num_queries=5, num_decoder_layers=1, aux_loss=False),
        n_epoch=1, round_multiple=0)  # unrounded: the clip grid is the decode's
    metrics, _ = train_mr(cfg, device="cpu")
    assert "MR-full-mAP-key" in metrics["brief"]
    # start and end are argmaxes of their own, so an end before the start is
    # the model's answer (JAX's and the reference's too), not a decode fault
    row = _rows(cfg.results_dir)[0]
    duration = MRDataset(cfg.eval_data).data[0]["duration"]
    for st, ed, _score in row["pred_relevant_windows"]:
        assert st % corpus["clip_len"] == 0 and ed % corpus["clip_len"] == 0
        assert 0 <= st <= duration and 0 <= ed <= duration


def test_moment_detr_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        md.MomentDETR(md.MomentDETRConfig(**SMALL))


# --- the JAX package's checkpoints -----------------------------------------

UNIVTG_SMALL = dict(vid_dim=20, txt_dim=16, hidden_dim=64, num_layers=2, num_heads=4,
                    ffn_dim=96, max_v_l=24, max_q_l=10, dropout=0.0, droppath=0.0,
                    input_dropout=0.0, use_txt_pos=True)


def _jax_checkpoint(path, model_name):
    """A JAX save_checkpoint file of a fresh JAX init: (port config, JAX
    forward outputs on _inputs(), model)."""
    args = _inputs(2)
    if model_name == "moment_detr":
        jcfg, cfg = _cfgs("l1", True, True)
        jmodel = jmd.MomentDETR(jcfg)
    else:
        jcfg, cfg = JaxConfig(**UNIVTG_SMALL), ModelConfig(**UNIVTG_SMALL)
        jmodel = JaxUniVTG(jcfg)
    params = jmodel.init(jax.random.PRNGKey(5), *args)["params"]
    tx = jsteps.make_optimizer(jschedule.build_schedule(*SCHED), 1e-4, 0.1)
    state = jsteps.TrainState(params=params, opt_state=tx.init(params), step=np.int32(7))
    jckpt.save_checkpoint(str(path), state, epoch=3)
    return cfg, jmodel.apply({"params": params}, *args)


def _tree_equal(got, want, path="blob"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(want, np.generic):
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), path


@pytest.mark.parametrize("model_name", ["univtg", "moment_detr"])
def test_a_jax_checkpoint_loads_into_the_port(model_name, tmp_path):
    path = tmp_path / "model_best.ckpt"
    cfg, want = _jax_checkpoint(path, model_name)
    raw = path.read_bytes()
    assert flax_msgpack.is_msgpack_map(raw[:1])
    _tree_equal(flax_msgpack.read(str(path)), serialization.msgpack_restore(raw))
    model_cls = md.MomentDETR if model_name == "moment_detr" else UniVTG
    model = model_cls(cfg, device="cpu", seed=1)
    model.load_state_dict(ckpt.restore_params(str(path), model.state_dict(), cfg))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in _inputs(2)))
    for k in ("pred_logits", "pred_spans", "saliency_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    # the serving loader reads it too, and the full restore: the weights,
    # the fresh optax state's count 0 (the file's step 7 seeds only JAX's
    # dropout) and the epoch
    sd = load_torch_checkpoint(str(path), cfg)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="cfg="):
        ckpt.restore_params(str(path), model.state_dict())
    fresh = model_cls(cfg, device="cpu", seed=2)
    state = TrainState(fresh, make_optimizer(fresh.parameters(), lambda _: 1e-4))
    state, epoch = ckpt.restore_checkpoint(str(path), state)
    assert (epoch, state.step) == (3, 0)
    assert all(torch.equal(v, sd[k]) for k, v in fresh.state_dict().items())
    assert all(float(s["step"]) == 0 and not s["exp_avg"].any()
               for s in state.optimizer.adamw.state.values())


def test_train_mr_resumes_weights_from_a_jax_checkpoint(corpus, tmp_path):
    cfg = dataclasses.replace(
        _train_cfg(corpus, tmp_path, "l1", hidden_dim=48, num_layers=1, num_heads=4,
                   ffn_dim=64, num_queries=5, num_decoder_layers=1),
        n_epoch=1, eval_data=None)
    jcfg = jmd.MomentDETRConfig(**dataclasses.asdict(cfg.model))
    # weights of another seed than train_mr's own init, in JAX's layout
    other = md.MomentDETR(cfg.model, device="cpu", seed=cfg.seed + 5).state_dict()
    params = md_params_from_torch_state_dict(other, jcfg)["params"]
    tx = jsteps.make_optimizer(jschedule.build_schedule(*SCHED), 1e-4, 0.1)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, jsteps.TrainState(params=params, opt_state=tx.init(params),
                                                  step=np.int32(0)), 0)
    train_mr(dataclasses.replace(cfg, lr=0.0), resume=path, device="cpu")
    back = ckpt.restore_params(os.path.join(cfg.results_dir, "model_best.ckpt"),
                               md.MomentDETR(cfg.model, device="meta").state_dict())
    want = md_state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                         cfg.model)
    for k, w in want.items():  # lr 0: AdamW's decay is lr * wd, so nothing moves
        torch.testing.assert_close(back[k], w, rtol=0, atol=0, msg=k)


def test_reader_handles_chunks_and_bfloat16(tmp_path, monkeypatch):
    """A bfloat16 leaf, numpy scalars, plain Python values and a leaf that
    flax splits into chunks (its chunk size made small here)."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    tree = {
        "params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                   "bf": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
                   "big": rng.standard_normal((40, 9)).astype(np.float32),
                   "i": np.arange(7, dtype=np.int64), "b": np.array([True, False])},
        "step": np.int32(12), "epoch": 3, "neg": -70000, "f": 0.25, "none": None,
        "flag": True, "name": "x" * 40, "ints": [1, 300, 70000, 2**40, -5, -200],
        "bytes": b"\x00\x01", "scalar": np.float64(2.5),
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    raw = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in raw
    got = flax_msgpack.loads(raw)
    _tree_equal(got, serialization.msgpack_restore(raw))
    assert got["params"]["bf"].dtype == np.float32
    np.testing.assert_array_equal(got["params"]["bf"],
                                  tree["params"]["bf"].astype(np.float32))


@pytest.mark.parametrize("raw,match", [
    (b"\x81\xa1a\xd4\x05\x00", "ext type 5"),  # {"a": fixext1 of type 5}
    (b"\x81\xa1a\xc1", "type code 0xc1"),  # the one code msgpack never uses
    (b"\x81\xa1a\x92\x01", "truncated"),
])
def test_reader_refuses_what_flax_does_not_write(raw, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.loads(raw)


def test_univtg_converter_still_inverts_the_jax_mapper():
    from univtg_tpu.interop.torch_ckpt import params_from_torch_state_dict

    cfg = ModelConfig(**UNIVTG_SMALL)
    sd = UniVTG(cfg, device="cpu").state_dict()
    back = state_dict_from_jax_params(
        params_from_torch_state_dict(sd, JaxConfig(**UNIVTG_SMALL)), cfg)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
