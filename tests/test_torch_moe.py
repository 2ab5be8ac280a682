"""The port's Mixture-of-Experts FFN (ops/moe.py) and MoE model against the
JAX package's, at JAX's own MoE configuration (hidden 64, 2 layers, 4 heads,
FFN 96, 4 experts, top-2, scan_layers; tests/torch_golden/make_jax_moe.py).

  * ``moe_capacity`` equal to JAX's over a grid of (N, E, k, factor);
  * the routing of the same probabilities (top-1 and top-2, with padding,
    with overflow at factor 0.5): dispatch and combine equal to JAX's
    ``moe_routing``, the aux at 1e-6;
  * ``moe_ffn`` values and gradients (x, router, experts) against JAX's at
    1e-5, and the index version against ``moe_ffn_reference`` (the one-hot
    einsums) at 1e-6;
  * the model forward from JAX-initialised params in both layouts at 1e-4
    (saliency 2e-3 after the fp16 cast), no token's top-k choice within
    1e-5 of a tie;
  * 3 train steps against JAX's ``make_train_step`` (dropouts 0): every
    metric, ``loss_moe_aux`` among them, at rtol 1e-4, the params at 2e-5;
  * the int8 values and scales of a MoE model equal JAX's, and JAX's int8
    file of the scan layout serves;
  * the committed fixture (chip_smoke.py phase 7t) is JAX's run, and
    ``resume_all`` from it reproduces its metrics on the CPU;
  * the top-1 router gets the task gradient; top_k > E, a MoE model in a
    gang and ep > 1 raise.
One JAX run of the fixture's model (4 steps) is shared by the module.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.models.encoder import unstack_layer_params
from univtg_tpu.ops import moe as jmoe
from univtg_tpu.serve.quantize import _path_str, dequantize_params, quantize_params
from univtg_tpu.serve.quantize import save_quantized as jax_save_quantized
from univtg_tpu.train import checkpoint as jckpt
from univtg_tpu.train.steps import decode_dense_outputs as jax_decode
from univtg_tpu_torch.interop import state_dict_from_jax_params
from univtg_tpu_torch.interop.jax_params import JaxTreeMismatch, checked_state_dict_from_jax
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models.config import check_supported
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.ops import moe
from univtg_tpu_torch.parallel import dist
from univtg_tpu_torch.serve.quantize import quantize_state_dict, restore_serving_params
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import (
    TrainState,
    decode_dense_outputs,
    make_optimizer,
    make_train_step,
)

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden")
TIE = 1e-5  # the smallest gap between a token's ranked router probabilities


def _golden():
    spec = importlib.util.spec_from_file_location(
        "make_jax_moe", os.path.join(GOLDEN, "make_jax_moe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _golden()


@pytest.fixture(scope="module")
def jax_run():
    """JAX's fixture model from its init, 4 steps: (states, metrics, batches)."""
    states, metrics, batches = G.run()
    return [jax.tree_util.tree_map(np.asarray, s) for s in states], metrics, batches


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return tuple({k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in batch)


# ------------------------------------------------------------------ the op


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0])
def test_capacity_equals_jax(factor):
    for n in (1, 7, 8, 40, 107, 3424, 16640):
        for e in (2, 4, 8):
            for k in range(1, e + 1):
                assert moe.moe_capacity(n, e, k, factor) == jmoe.moe_capacity(n, e, k, factor)
    # the flagship training batch: 32 x (75 + 32) tokens, E 4, top-2
    assert moe.moe_capacity(32 * 107, 4, 2, 1.25) == 2144


def _probs(seed, n=40, e=4):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, e)).astype(np.float32) * 2.0
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _dense(r, n, e, c):
    """The index routing as JAX's (N, E, C) dispatch and combine."""
    dispatch = torch.zeros(n, e, c)
    combine = torch.zeros(n, e, c)
    for k in range(r.expert.shape[0]):
        kept = r.keep[k] > 0
        tok = torch.arange(n)[kept]
        dispatch[tok, r.expert[k][kept], r.slot[k][kept]] += 1.0
        combine[tok, r.expert[k][kept], r.slot[k][kept]] += r.gate[k][kept]
    return dispatch, combine


ROUTING_CASES = {  # name -> (capacity factor, padded rows)
    "plain": (2.0, 0),
    "padding": (2.0, 9),
    "overflow": (0.5, 5),
}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", list(ROUTING_CASES))
def test_routing_equals_jax(case, top_k):
    factor, padded = ROUTING_CASES[case]
    n, e = 40, 4
    probs = _probs(top_k * 10 + len(case))
    mask = np.ones(n, np.float32)
    if padded:
        mask[-padded:] = 0
    c = jmoe.moe_capacity(n, e, top_k, factor)
    jd, jc, jaux = jmoe.moe_routing(jnp.asarray(probs), e, top_k, c, jnp.asarray(mask))
    r = moe.moe_routing(torch.from_numpy(probs), e, top_k, c, torch.from_numpy(mask))
    d, cmb = _dense(r, n, e, c)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(cmb.numpy(), np.asarray(jc))
    np.testing.assert_allclose(r.aux.item(), float(jaux), rtol=0, atol=1e-6)
    rd, rc, raux = moe.moe_routing_reference(torch.from_numpy(probs), e, top_k, c,
                                             torch.from_numpy(mask))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(rc.numpy(), np.asarray(jc))
    assert raux.item() == r.aux.item()
    routed = int(mask.sum()) * top_k
    if case == "overflow":  # tokens were dropped
        assert r.keep.sum().item() < routed
    else:
        assert r.keep.sum().item() == routed
    assert not r.keep[:, mask == 0].any()


def _rand_moe(seed=0, d=8, f=16, e=4):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((d, e)) * 0.3).astype(np.float32),
            (rng.standard_normal((e, d, f)) * 0.2).astype(np.float32),
            (rng.standard_normal((e, f)) * 0.05).astype(np.float32),
            (rng.standard_normal((e, f, d)) * 0.2).astype(np.float32),
            (rng.standard_normal((e, d)) * 0.05).astype(np.float32))


def _ffn_case(seed, factor):
    weights = _rand_moe(seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((3, 10, 8)).astype(np.float32)
    mask = np.ones((3, 10), np.float32)
    mask[2, 6:] = 0
    cot = rng.standard_normal((3, 10, 8)).astype(np.float32)
    return x, weights, mask, cot


def _torch_grads(fn, x, weights, mask, cot, top_k, factor):
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, *weights)]
    y, aux = fn(leaves[0], *leaves[1:], top_k=top_k, capacity_factor=factor,
                token_mask=torch.from_numpy(mask))
    (torch.sum(y * torch.from_numpy(cot)) + 0.5 * aux).backward()
    return y.detach().numpy(), aux.item(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_moe_ffn_values_and_grads_equal_jax(top_k, factor):
    x, weights, mask, cot = _ffn_case(3 + top_k, factor)

    def jax_loss(x, *w):
        y, aux = jmoe.moe_ffn(x, *w, top_k=top_k, capacity_factor=factor,
                              token_mask=jnp.asarray(mask))
        return jnp.sum(y * cot) + 0.5 * aux, (y, aux)

    (_, (jy, jaux)), jgrads = jax.value_and_grad(jax_loss, argnums=tuple(range(6)),
                                                 has_aux=True)(x, *weights)
    y, aux, grads = _torch_grads(moe.moe_ffn, x, weights, mask, cot, top_k, factor)
    np.testing.assert_allclose(y, np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(aux, float(jaux), rtol=0, atol=1e-6)
    names = ("x", "router", "w1", "b1", "w2", "b2")
    for name, g, w in zip(names, grads, jgrads, strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5, err_msg=name)
        assert np.abs(w).max() > 0, name


@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_index_version_equals_the_one_hot_reference(top_k, factor):
    x, weights, mask, cot = _ffn_case(11 + top_k, factor)
    y, aux, grads = _torch_grads(moe.moe_ffn, x, weights, mask, cot, top_k, factor)
    ry, raux, rgrads = _torch_grads(moe.moe_ffn_reference, x, weights, mask, cot,
                                    top_k, factor)
    np.testing.assert_allclose(y, ry, rtol=0, atol=1e-6)
    assert aux == raux
    for g, w in zip(grads, rgrads, strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_top1_router_gets_task_gradient():
    """Top-1 keeps the raw router probability as the gate (Switch): a
    renormalised gate g/g == 1 would cut the router off from the task loss."""
    rk, w1, b1, w2, b2 = (torch.from_numpy(a) for a in _rand_moe(seed=5))
    rk.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 4, 8)).astype(np.float32))
    y, _ = moe.moe_ffn(x, rk, w1, b1, w2, b2, top_k=1, capacity_factor=8.0, aux=False)
    torch.mean(y ** 2).backward()
    assert rk.grad.norm().item() > 1e-4


def test_top_k_above_experts_raises(monkeypatch):
    with pytest.raises(ValueError, match="top_k"):
        moe.moe_routing(torch.full((4, 2), 0.5), 2, 3, 8)
    cfg = ModelConfig(**{**G.MOE_MODEL, "moe_experts": 2, "moe_top_k": 3})
    with pytest.raises(ValueError, match="moe_top_k"):
        check_supported(cfg)
    with pytest.raises(ValueError, match="moe_top_k"):
        UniVTG(cfg, device="cpu")


def test_moe_in_a_gang_and_ep_raise(tmp_path):
    """A MoE model in a gang routes the global batch (tests/test_torch_ep.py
    holds gangs of 2, 4 and 8 against JAX): in a gang of one its step is the
    one-process step bit for bit. ep > 1 raises JAX's ValueErrors for a
    dense model, for top_k > E and for E that does not tile over ep."""
    from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr

    cfg = ModelConfig(**G.MOE_MODEL)
    mi, tg = _t(G.batch(0))
    metrics = []
    for gang in (True, False):
        model = UniVTG(cfg, device="cpu")
        state = TrainState(model, make_optimizer(model.parameters(),
                                                 build_schedule(*G.SCHEDULE)))
        if gang:
            dist.init_gang(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
        try:
            metrics.append(make_train_step(LossWeights(**G.WEIGHTS))(state, mi, tg, 0)[1])
        finally:
            dist.shutdown()
        assert state.step == 1
    for k in metrics[0]:
        assert torch.equal(metrics[0][k], metrics[1][k]), k
    dense = {k: v for k, v in G.MOE_MODEL.items() if not k.startswith("moe_")}
    for model_kw, ep, match in (
            (dense, 2, "ep=2 needs a MoE model"),
            ({**G.MOE_MODEL, "moe_experts": 3, "moe_top_k": 1}, 2,
             "moe_experts=3 must tile over ep=2"),
            ({**G.MOE_MODEL, "moe_experts": 2, "moe_top_k": 3}, 2, "moe_top_k=3 must be <=")):
        with pytest.raises(ValueError, match=match):
            train_mr(TrainConfig(model=ModelConfig(**model_kw), ep=ep), device="cpu")


# --------------------------------------------------------------- the model


def _port(sd, **kw):
    model = UniVTG(ModelConfig(**{**G.MOE_MODEL, **kw}), device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def _router_gaps(model, args):
    """The smallest gap, over tokens and layers, between a valid token's
    ranked router probabilities down to its (k+1)-th: near a tie, another
    summation order may route it otherwise."""
    gaps = []

    def hook(mod, inputs, _):
        h, mask = inputs[0], inputs[1]
        probs = torch.softmax(h.reshape(-1, h.shape[-1]).float() @ mod.router.float(), -1)
        top = torch.sort(probs, dim=-1, descending=True).values[:, : mod.top_k + 1]
        valid = mask.reshape(-1) > 0
        gaps.append((top[:, :-1] - top[:, 1:])[valid].min().item())

    handles = [layer.moe.register_forward_hook(hook)
               for layer in model.transformer.encoder.layers]
    try:
        with torch.inference_mode():
            model(*args)
    finally:
        for h in handles:
            h.remove()
    return min(gaps)


@pytest.mark.parametrize("layout", ["scan", "unrolled"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_equals_jax_from_either_layout(jax_run, layout, impl):
    states, _, batches = jax_run
    params = states[0].params
    mi, tg = batches[0]
    args = (mi["src_txt"], mi["src_txt_mask"], mi["src_vid"], mi["src_vid_mask"])
    want = JaxUniVTG(JaxConfig(**G.MOE_MODEL)).apply({"params": params}, *args, train=False)
    if layout == "unrolled":
        params = {**params, "encoder": unstack_layer_params(params["encoder"])}
        assert "layers_1" in params["encoder"] and "layers" not in params["encoder"]
    cfg = ModelConfig(**G.MOE_MODEL, attention_impl=impl)
    sd = state_dict_from_jax_params(params, cfg)
    model = _port(sd, attention_impl=impl)
    targs = tuple(torch.from_numpy(a) for a in args)
    assert _router_gaps(model, targs) > TIE
    with torch.inference_mode():
        got = model(*targs)
    assert "aux_moe" not in got  # eval sows no aux
    for k in ("pred_logits", "pred_spans", "saliency_scores", "vid_mem_proj"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
    dec = decode_dense_outputs(got, targs[3], torch.from_numpy(tg["timestamp"]), "add")
    jdec = jax_decode(want, jnp.asarray(mi["src_vid_mask"]), jnp.asarray(tg["timestamp"]),
                      "add")
    np.testing.assert_allclose(dec["saliency"].numpy(), np.asarray(jdec["saliency"]),
                               rtol=0, atol=2e-3)


def _assert_params_follow(model, jparams, n_steps, atol=2e-5, lr=G.SCHEDULE[0]):
    """Every parameter against JAX's at atol; the k-slice of each
    in_proj_bias, whose gradient is zero analytically, at 2 lr per step (as
    tests/test_torch_resume.py)."""
    want = state_dict_from_jax_params(_np(jparams), model.cfg)
    got = model.state_dict()
    D = model.cfg.hidden_dim
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("self_attn.in_proj_bias"):
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * lr * n_steps, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol, err_msg=k)


def test_three_train_steps_equal_jax(jax_run):
    states, metrics, batches = jax_run
    cfg = ModelConfig(**G.MOE_MODEL)
    model = _port(state_dict_from_jax_params(states[0].params, cfg))
    state = TrainState(model, make_optimizer(model.parameters(),
                                             build_schedule(*G.SCHEDULE), G.WD,
                                             G.GRAD_CLIP))
    step = make_train_step(LossWeights(**G.WEIGHTS))
    for i in range(3):
        state, m = step(state, *_t(batches[i]), 0)
        assert set(m) == set(metrics[i]) and "loss_moe_aux" in m
        for k, w in metrics[i].items():
            np.testing.assert_allclose(m[k].item(), w, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} at step {i}")
    _assert_params_follow(model, states[3].params, 3)


# ------------------------------------------------------------ int8 serving


def test_int8_of_a_moe_model_equals_jax(jax_run):
    """JAX takes one scale per last-axis channel over every other axis; the
    port holds the MoE tensors in JAX's layout, so its scales and values are
    JAX's, of the unrolled tree (layer by layer)."""
    states, _, _ = jax_run
    cfg = ModelConfig(**{**G.MOE_MODEL, "scan_layers": False})
    params = states[3].params
    params = {**params, "encoder": unstack_layer_params(params["encoder"])}
    sd = state_dict_from_jax_params(params, cfg)
    q_j, scales_j = quantize_params(params)
    q_t, scales_t = quantize_state_dict(sd)
    want_q = state_dict_from_jax_params(q_j, cfg)
    for name in sd:
        assert q_t[name].dtype == want_q[name].dtype, name
        assert torch.equal(q_t[name], want_q[name]), name
    spread = jax.tree_util.tree_map_with_path(
        lambda p, leaf: np.broadcast_to(scales_j.get(_path_str(p), np.float32(0)),
                                        leaf.shape), params)
    want_s = state_dict_from_jax_params(spread, cfg)
    for name in sd:
        got = scales_t.get(name, torch.zeros(()))
        assert torch.equal(got.expand(sd[name].shape), want_s[name]), name
    assert len(scales_t) == len(scales_j)
    layer = "transformer.encoder.layers.1.moe"
    assert scales_t[f"{layer}.w1"].shape == (1, 1, 96)
    assert scales_t[f"{layer}.b1"].shape == (1, 96) and scales_t[f"{layer}.router"].shape == (1, 4)


def test_jax_int8_file_of_the_scan_layout_serves(jax_run, tmp_path):
    states, _, batches = jax_run
    params = states[3].params
    path = str(tmp_path / "jax_int8.msgpack")
    jax_save_quantized(path, params)
    cfg = ModelConfig(**G.MOE_MODEL)
    got = restore_serving_params(path, cfg)
    want = state_dict_from_jax_params(dequantize_params(*quantize_params(params)), cfg)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    from univtg_tpu_torch.serve import GroundingPipeline

    mi, _ = batches[0]
    pipe = GroundingPipeline(cfg, got, eval_mode="add", device="cpu")
    res = pipe.ground_features(mi["src_vid"][0][:, :-2], mi["src_txt"][0])  # TEF added
    assert np.isfinite(res["saliency"]).all()


# --------------------------------------------------------------- the fixture


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, tree


def test_the_fixture_is_jax_run(jax_run, tmp_path):
    """tests/torch_golden/jax_moe is what make_jax_moe.py writes: the
    checkpoint of the shared run's state after SAVED_AT steps, its batches
    and metrics (1e-6: another host's XLA may round otherwise)."""
    states, metrics, batches = jax_run
    path = str(tmp_path / "model_latest.ckpt")
    jckpt.save_checkpoint(path, states[G.SAVED_AT], 0)
    root = os.path.join(GOLDEN, "jax_moe")
    got = dict(_flat(ckpt.read_checkpoint(path)))
    want = dict(_flat(ckpt.read_checkpoint(os.path.join(root, "model_latest.ckpt"))))
    assert got.keys() == want.keys()
    assert any("/encoder/layers/layer/moe_w1" in k for k in want)  # the scan layout
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    with np.load(os.path.join(root, "batches.npz")) as z:
        for i, (mi, tg) in enumerate(batches[G.SAVED_AT:]):
            for part, d in (("model_inputs", mi), ("targets", tg)):
                for k, v in d.items():
                    np.testing.assert_array_equal(z[f"{i}/{part}/{k}"], v)
    with open(os.path.join(root, "expected.json")) as f:
        expected = json.load(f)
    assert expected["model"] == G.MOE_MODEL and expected["step"] == G.SAVED_AT
    for g, w in zip(metrics[G.SAVED_AT:], expected["metrics"], strict=True):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-6), k


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_the_fixture_resumes_on_the_cpu(impl):
    """Phase 7t's check on the CPU: resume_all from the scan-layout MoE
    checkpoint, then its 2 batches against JAX's recorded metrics."""
    root = os.path.join(GOLDEN, "jax_moe")
    with open(os.path.join(root, "expected.json")) as f:
        want = json.load(f)
    model = UniVTG(ModelConfig(**want["model"], attention_impl=impl), device="cpu", seed=1)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             build_schedule(*want["schedule"]), want["wd"],
                                             want["grad_clip"]))
    state, epoch = ckpt.restore_checkpoint(os.path.join(root, "model_latest.ckpt"), state)
    assert (epoch, state.step) == (want["epoch"], want["step"])
    step = make_train_step(LossWeights(**want["weights"]))
    with np.load(os.path.join(root, "batches.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    for i, w in enumerate(want["metrics"]):
        mi, tg = ({k.split("/")[2]: torch.from_numpy(v) for k, v in arrays.items()
                   if k.startswith(f"{i}/{part}/")} for part in ("model_inputs", "targets"))
        state, m = step(state, mi, tg, 1)
        for k, v in w.items():
            np.testing.assert_allclose(m[k].item(), v, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} at step {i}")


def test_a_stacked_tree_of_other_depth_raises(jax_run):
    states, _, _ = jax_run
    cfg = ModelConfig(**{**G.MOE_MODEL, "num_layers": 1})
    want = UniVTG(cfg, device="meta").state_dict()
    with pytest.raises(JaxTreeMismatch,
                       match=r"params/encoder/layers/layer/\S+ stacks 2 layers, the config has 1"):
        checked_state_dict_from_jax(states[0].params, cfg, want)
