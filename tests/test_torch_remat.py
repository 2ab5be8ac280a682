"""``remat`` and ``scan_layers`` in the port, and the three one-process model
options through the entry points.

  * remat (each encoder layer under ``torch.utils.checkpoint``) against no
    remat, dropouts at the flagship's defaults (droppath 0.1, input dropout
    0.5) and at attention dropout 0.1, one generator seed, "xla" and
    "pallas" (the kernels' twins), dense and MoE: the loss and every
    gradient equal, then 2 steps' metrics and params equal; the attention
    runs twice a layer and step under remat (``attention.dispatches``);
  * remat under a ring of 2 CPU ranks ("ring", "ring_pallas"): the same
    equalities;
  * the port's remat against the JAX package's remat (a MoE model of the
    unrolled layout, dropouts 0, 3 steps from JAX's init): every metric at
    rtol 1e-4, the params at 2e-5;
  * a JAX scan-layout (stacked) tree of a dense model converts equal to
    the unrolled one;
  * ``cli train-mr`` (``scan_steps=2``), ``infer-mr``, ``quantize`` and the
    served int8 file of a MoE model with scan_layers and remat, on the CPU,
    from ``key=value`` overrides (``true`` parses to a bool); a config JSON
    of either package round-trips.
"""
import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.models.encoder import unstack_layer_params
from univtg_tpu_torch import cli
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.interop import state_dict_from_jax_params
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models.losses import LossWeights, compute_losses
from univtg_tpu_torch.ops import attention
from univtg_tpu_torch.parallel.ring import RingGroup, use_ring
from univtg_tpu_torch.presets import PRESETS
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden")
SMALL = dict(vid_dim=34, txt_dim=16, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, max_v_l=16, max_q_l=6)
FLAGSHIP_DROPOUTS = dict(dropout=0.0, droppath=0.1, input_dropout=0.5)
MOE = dict(moe_experts=4, moe_top_k=2)


def _golden():
    spec = importlib.util.spec_from_file_location(
        "make_jax_moe", os.path.join(GOLDEN, "make_jax_moe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _golden()


def _t(batch):
    return tuple({k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in batch)


def _state(cfg, sd=None, seed=3):
    model = UniVTG(cfg, device="cpu", seed=seed)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return TrainState(model, make_optimizer(model.parameters(), build_schedule(*G.SCHEDULE),
                                            G.WD, G.GRAD_CLIP))


def _grads(cfg, batch, seed=7):
    """One train-mode forward and backward: (loss, {name: grad}, attention
    calls)."""
    model = UniVTG(cfg, device="cpu", seed=3)
    mi, tg = batch
    before = sum(attention.dispatches.values())
    out = model(mi["src_txt"], mi["src_txt_mask"], mi["src_vid"], mi["src_vid_mask"],
                train=True, generator=torch.Generator().manual_seed(seed))
    loss = compute_losses(out, tg, LossWeights(**G.WEIGHTS))["loss_overall"]
    loss.backward()
    calls = sum(attention.dispatches.values()) - before
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, calls


def _two_steps(cfg, batches):
    state = _state(cfg)
    step = make_train_step(LossWeights(**G.WEIGHTS))
    metrics = [step(state, mi, tg, 5)[1] for mi, tg in batches]
    return metrics, dict(state.model.named_parameters())


def _assert_remat_is_the_plain_step(cfg, batches):
    plain = _grads(cfg, batches[0])
    remat = _grads(dataclasses.replace(cfg, remat=True), batches[0])
    assert torch.equal(plain[0], remat[0])
    assert plain[1].keys() == remat[1].keys()
    for name, g in plain[1].items():
        assert torch.equal(g, remat[1][name]), name
    assert remat[2] == 2 * plain[2] == 2 * cfg.num_layers  # recomputed once
    want, want_p = _two_steps(cfg, batches)
    got, got_p = _two_steps(dataclasses.replace(cfg, remat=True), batches)
    for g, w in zip(got, want, strict=True):
        assert all(torch.equal(g[k], w[k]) for k in w), (g, w)
    assert all(torch.equal(got_p[n], p) for n, p in want_p.items())


@pytest.mark.parametrize("ffn", ["dense", "moe"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("attn_dropout", [0.0, 0.1])
def test_remat_gives_the_plain_step(ffn, impl, attn_dropout):
    cfg = ModelConfig(**SMALL, **FLAGSHIP_DROPOUTS, **(MOE if ffn == "moe" else {}),
                      attention_impl=impl)
    cfg = dataclasses.replace(cfg, dropout=attn_dropout)
    _assert_remat_is_the_plain_step(cfg, [_t(G.batch(s)) for s in range(2)])


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_remat_under_a_cpu_ring_gives_the_plain_step(impl):
    """Under a ring of 2 CPU ranks ("ring_pallas": the block kernel's twin,
    the backward through the plain ring; attention dropout runs "ring")."""
    cfg = ModelConfig(**SMALL, **{**FLAGSHIP_DROPOUTS, "dropout": 0.1}, attention_impl=impl)
    batches = [_t(G.batch(s)) for s in range(2)]  # 16 + 6 tokens: tiles over 2
    before = dict(attention.dispatches)
    with use_ring(RingGroup(2, devices=["cpu"] * 2)):
        _assert_remat_is_the_plain_step(cfg, batches)
    assert attention.dispatches["ring"] > before["ring"]


def test_remat_steps_equal_jax_remat():
    """JAX's per-layer nn.remat (unrolled layout, a MoE model) and the
    port's checkpoint: 3 steps from JAX's init."""
    states, metrics, batches = G.run(3, remat=True, scan_layers=False)
    states = [jax.tree_util.tree_map(np.asarray, s) for s in states]
    assert "layers_0" in states[0].params["encoder"]
    cfg = ModelConfig(**{**G.MOE_MODEL, "remat": True, "scan_layers": False})
    state = _state(cfg, state_dict_from_jax_params(states[0].params, cfg))
    step = make_train_step(LossWeights(**G.WEIGHTS))
    for i in range(3):
        state, m = step(state, *_t(batches[i]), 0)
        assert set(m) == set(metrics[i])
        for k, w in metrics[i].items():
            np.testing.assert_allclose(m[k].item(), w, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} at step {i}")
    want = state_dict_from_jax_params(states[3].params, cfg)
    got = state.model.state_dict()
    D, lr = cfg.hidden_dim, G.SCHEDULE[0]
    for k, w in want.items():
        g = got[k]
        if k.endswith("self_attn.in_proj_bias"):  # its k-slice: zero gradient
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * lr * 3, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5, err_msg=k)


def test_a_jax_scan_layout_tree_converts_equal_to_the_unrolled_one():
    jcfg = JaxConfig(**SMALL, scan_layers=True, pre_norm=True)
    mi, _ = G.batch(0)
    params = JaxUniVTG(jcfg).init(jax.random.PRNGKey(2), mi["src_txt"], mi["src_txt_mask"],
                                  mi["src_vid"], mi["src_vid_mask"], train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    assert params["encoder"]["layers"]["layer"]["in_proj_kernel"].shape == (2, 64, 192)
    unrolled = {**params, "encoder": unstack_layer_params(params["encoder"])}
    cfg = ModelConfig(**SMALL, pre_norm=True)
    got = state_dict_from_jax_params(params, cfg)
    want = state_dict_from_jax_params(unrolled, cfg)
    assert got.keys() == want.keys() == UniVTG(cfg, device="meta").state_dict().keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


# ------------------------------------------------------- the entry points

OPTIONS = ["model.moe_experts=4", "model.moe_top_k=2", "model.scan_layers=true",
           "model.remat=TRUE", "model.attention_impl=pallas"]


def test_overrides_parse_and_configs_round_trip():
    cfg = cli.apply_overrides(PRESETS["qvhighlights_mr"](), OPTIONS).model
    assert (cfg.moe_experts, cfg.moe_top_k, cfg.scan_layers, cfg.remat) == (4, 2, True, True)
    assert cli.apply_overrides(PRESETS["qvhighlights_mr"](),
                               ["model.remat=false"]).model.remat is False
    jcfg = JaxConfig(**SMALL, **MOE, scan_layers=True, remat=True, moe_capacity_factor=2.0)
    tcfg = ModelConfig.from_json(jcfg.to_json())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert JaxConfig.from_json(tcfg.to_json()) == jcfg


def test_cli_train_infer_quantize_and_serve_a_moe_model(tmp_path, capsys):
    corpus = create_synthetic_mr_corpus(str(tmp_path / "corpus"), n_train=8, n_val=4,
                                        v_dim=20, q_dim=8, max_clips=16, seed=3)
    data = dict(v_feat_dim=20, q_feat_dim=8, max_q_l=8, max_v_l=16)
    split = {"train_data": corpus["train_path"], "eval_data": corpus["val_path"]}
    pairs = [f"{part}.{k}={v!r}" for part, path in split.items() for k, v in dict(
        data_path=path, v_feat_dirs=tuple(corpus["v_feat_dirs"]),
        q_feat_dir=corpus["q_feat_dir"], **data).items()]
    model = dict(vid_dim=22, txt_dim=8, hidden_dim=64, num_layers=2, num_heads=4,
                 ffn_dim=96, max_v_l=16, max_q_l=8)
    pairs += [f"model.{k}={v}" for k, v in model.items()] + OPTIONS
    run = tmp_path / "run"
    cli.main(["train-mr", "--preset", "qvhighlights_mr", "--device", "cpu", *pairs,
              "bsz=4", "eval_bsz=4", "n_epoch=2", "eval_epoch=1", "scan_steps=2",
              f"results_dir={run}", "num_io_threads=1", "prefetch_depth=0"])
    capsys.readouterr()
    lines = [json.loads(line) for line in open(run / "train_log.jsonl")]
    assert [line["steps"] for line in lines] == [2, 2]
    assert all(np.isfinite(line["loss_moe_aux"]) and 0 < line["loss_moe_aux"] <= 4
               for line in lines)
    best = str(run / "model_best.ckpt")
    cli.main(["infer-mr", "--preset", "qvhighlights_mr", "--device", "cpu", "--resume",
              best, "--out", str(tmp_path / "preds.jsonl"), *pairs])
    brief = json.loads(capsys.readouterr().out)
    assert all(np.isfinite(v) for v in brief.values())
    int8 = str(tmp_path / "int8.ckpt")
    cli.main(["quantize", "--preset", "qvhighlights_mr", "--resume", best, "--out", int8,
              *pairs])
    cfg = cli.apply_overrides(PRESETS["qvhighlights_mr"](), pairs).model
    from univtg_tpu_torch.serve import GroundingPipeline
    from univtg_tpu_torch.serve.quantize import restore_serving_params

    served = restore_serving_params(int8, cfg)
    assert served["transformer.encoder.layers.0.moe.w1"].shape == (4, 64, 96)
    pipe = GroundingPipeline(cfg, served, eval_mode="add", device="cpu")
    rng = np.random.default_rng(0)
    res = pipe.ground_features(rng.standard_normal((16, 20)).astype(np.float32),
                               rng.standard_normal((5, 8)).astype(np.float32))
    assert np.isfinite(res["saliency"]).all() and len(res["topk_windows"]) > 0
