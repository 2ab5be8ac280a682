"""The port's train step against the JAX package's, and its dropouts by
distribution.

Trajectory: one small model (hidden 64, 2 layers, 4 heads), the same
weights (JAX init carried over by ``state_dict_from_jax_params``), the same
batches (one synthetic corpus through the port's dataset and collate) and
every dropout at 0, stepped by JAX's ``make_train_step`` (optax) and by the
port's (ClippedAdamW): 10 steps with attention "xla", 3 with "pallas" (JAX:
the Pallas kernels in interpret mode; port: the kernels' twins). Per step,
the loss is held at rtol 1e-4 and grad_norm at rtol 1e-4; after the run,
every parameter at atol 2e-5, except the k-slice of each in_proj_bias: its
gradient is zero analytically (softmax is shift-invariant), so float noise
there turns into Adam steps of +-lr of either sign, held at 2 * lr * steps.
"""
import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.models.losses import LossWeights as JaxWeights
from univtg_tpu.train import schedule as jschedule
from univtg_tpu.train import steps as jsteps
from univtg_tpu_torch.data.collate import collate_mr
from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.interop import state_dict_from_jax_params
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models.encoder import drop_path
from univtg_tpu_torch.models.layers import dropout
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.ops.attention import sdpa
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_train_step,
    step_generator,
)

torch.set_num_threads(1)
SMALL = dict(vid_dim=40, txt_dim=24, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, max_v_l=16, max_q_l=8, dropout=0.0, droppath=0.0,
             input_dropout=0.0)
BSZ, LR = 4, 1e-3
SCHED = (LR, 2, 200, 0.1, 2)  # lr, warmup, drop, gamma, steps per epoch


@contextlib.contextmanager
def pallas_interpret():
    os.environ["UNIVTG_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        os.environ.pop("UNIVTG_PALLAS_INTERPRET", None)


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """Collated numpy batches of one synthetic corpus (8 items, 2 batches
    per epoch, a new sampling every epoch)."""
    root = tmp_path_factory.mktemp("corpus")
    c = create_synthetic_mr_corpus(str(root), n_train=8, n_val=1, v_dim=38,
                                   q_dim=24, max_clips=16)
    ds = MRDataset(MRDataConfig(
        data_path=c["train_path"], v_feat_dirs=c["v_feat_dirs"],
        q_feat_dir=c["q_feat_dir"], v_feat_dim=38, q_feat_dim=24, max_q_l=8,
        max_v_l=16))
    out = []
    for epoch in range(5):
        ds.set_epoch(epoch)
        for i in range(0, 8, BSZ):
            b = collate_mr([ds[j] for j in range(i, i + BSZ)], 8, 16)
            out.append((b["model_inputs"], b["targets"]))
    return out


def _run_pair(batches, impl, n_steps):
    jcfg = JaxConfig(**SMALL, attention_impl=impl)
    tcfg = ModelConfig(**SMALL, attention_impl=impl)
    mi0 = batches[0][0]
    params = JaxUniVTG(jcfg).init(
        jax.random.PRNGKey(0), mi0["src_txt"], mi0["src_txt_mask"],
        mi0["src_vid"], mi0["src_vid_mask"], train=False)["params"]
    tx = jsteps.make_optimizer(jschedule.build_schedule(*SCHED), 1e-4, 0.1)
    jstate = jsteps.TrainState(params=params, opt_state=tx.init(params),
                               step=np.int32(0))
    jstep = jsteps.make_train_step(JaxUniVTG(jcfg), tx, JaxWeights(),
                                   donate=False)

    model = UniVTG(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    state = TrainState(model, make_optimizer(model.parameters(),
                                             build_schedule(*SCHED), 1e-4, 0.1))
    step = make_train_step(LossWeights())

    for i in range(n_steps):
        mi, tg = batches[i]
        with pallas_interpret() if impl == "pallas" else contextlib.nullcontext():
            jstate, jm = jstep(jstate, mi, tg, jax.random.PRNGKey(1))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in mi.items()},
                        {k: torch.from_numpy(v) for k, v in tg.items()}, 1)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"{k} at step {i}")
    return jstate.params, state, tcfg


@pytest.mark.parametrize("impl,n_steps", [("xla", 10), ("pallas", 3)])
def test_trajectory_matches_jax(batches, impl, n_steps):
    jparams, state, tcfg = _run_pair(batches, impl, n_steps)
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                                      tcfg)
    got = state.model.state_dict()
    D = tcfg.hidden_dim
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("self_attn.in_proj_bias"):
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * LR * n_steps, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, err_msg=k)
    assert state.step == n_steps


def test_step_generator_is_a_function_of_seed_and_step():
    a = torch.rand(5, generator=step_generator(3, 7, "cpu"))
    assert torch.equal(a, torch.rand(5, generator=step_generator(3, 7, "cpu")))
    assert not torch.equal(a, torch.rand(5, generator=step_generator(3, 8, "cpu")))
    assert not torch.equal(a, torch.rand(5, generator=step_generator(4, 7, "cpu")))


def _masks(fn, step):
    return fn(step_generator(0, step, "cpu"))


@pytest.mark.parametrize("kind", ["input", "xla_attention", "drop_path"])
def test_dropout_keep_rate_scale_and_seeding(kind):
    """Keep rate within 1 % of 1 - rate, kept values scaled by 1/(1-rate),
    dropped ones exactly 0; the same (seed, step) gives the same mask and
    the next step another one."""
    rate = 0.3
    ones = torch.ones(64, 40, 50)
    if kind == "input":
        fn = lambda g: dropout(ones, rate, g)  # noqa: E731
    elif kind == "xla_attention":
        # one head, all scores 0: every probability is 1/50 before dropout,
        # and V = I reads the dropped probabilities out
        q, k = torch.zeros(64, 40, 64), torch.zeros(64, 50, 64)
        v = torch.nn.functional.pad(torch.eye(50), (0, 14)).repeat(64, 1, 1)

        def fn(g):
            return sdpa(q, k, v, None, 1, rate, g)[..., :50] * 50
    else:
        fn = lambda g: drop_path(torch.ones(20000, 3, 2), rate, g)  # noqa: E731
    a = _masks(fn, 0)
    kept_vals = a[a != 0]
    torch.testing.assert_close(kept_vals, torch.full_like(kept_vals, 1 / (1 - rate)),
                               rtol=1e-5, atol=0)
    kept = (a != 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 0.01, kept
    assert torch.equal(a, _masks(fn, 0))
    assert not torch.equal(a, _masks(fn, 1))
    if kind == "drop_path":  # one draw per sample, whole branch
        assert torch.all(a == a[:, :1, :1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f32_paths_run_cudnn_without_tf32(dtype, monkeypatch):
    """torch starts with cudnn.allow_tf32 = True, which on a card rounds a
    convolution's f32 inputs to TF32. The f32 paths turn it off for
    themselves: UniVTG's conv heads in the train step's forward and
    backward, and CLIP's image convolutions; bf16 runs as found. The
    switch, set True here, reads as each convolution sees it and is True
    again after."""
    from univtg_tpu_torch.extract.clip.model import CLIP, CLIPConfig

    seen = []

    def watch(module, tag):
        module.register_forward_pre_hook(
            lambda *_: seen.append((tag, "fwd", torch.backends.cudnn.allow_tf32)))
        module.register_full_backward_hook(
            lambda *_: seen.append((tag, "bwd", torch.backends.cudnn.allow_tf32)))

    cfg = ModelConfig(**{**SMALL, "compute_dtype": dtype})
    model = UniVTG(cfg, device="cpu")
    for conv in model.class_embed.layers:
        watch(conv, "head")
    clip = CLIP(CLIPConfig(embed_dim=32, image_resolution=64, vision_layers=1,
                           vision_width=64, vision_patch_size=32, context_length=16,
                           vocab_size=100, transformer_width=32, transformer_heads=2,
                           transformer_layers=1, compute_dtype=dtype), device="cpu")
    conv2d = torch.nn.functional.conv2d

    def clip_conv(*args, **kw):  # the ViT's patch embedding calls F.conv2d
        seen.append(("clip", "fwd", torch.backends.cudnn.allow_tf32))
        return conv2d(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", clip_conv)
    rng = np.random.default_rng(0)
    B, Lt, Lv = 2, 8, 16
    mi = {"src_txt": rng.standard_normal((B, Lt, 24)), "src_txt_mask": np.ones((B, Lt)),
          "src_vid": rng.standard_normal((B, Lv, 40)), "src_vid_mask": np.ones((B, Lv))}
    ts = np.tile(((np.arange(Lv) + 1.0) / Lv)[None, :, None], (B, 1, 2))
    tg = {"timestamp": ts, "timestamp_mask": np.ones((B, Lv)),
          "timestamp_window": (np.arange(Lv) < 4)[None].repeat(B, 0),
          "span_labels_nn": ts, "saliency_scores": rng.uniform(0, 1, (B, Lv)),
          "saliency_pos_labels": np.full((B, 1), 2)}
    as_t = lambda d: {k: torch.as_tensor(np.asarray(v, np.float32)  # noqa: E731
                                         if k != "saliency_pos_labels" else v) for k, v in d.items()}
    state = TrainState(model, make_optimizer(model.parameters(), lambda c: 1e-3))
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        make_train_step(LossWeights())(state, as_t(mi), as_t(tg), 0)
        with torch.no_grad():
            clip.encode_image(torch.zeros(1, 64, 64, 3))
        after = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert after is True
    assert {(tag, way) for tag, way, _ in seen} == {("head", "fwd"), ("head", "bwd"),
                                                    ("clip", "fwd")}
    assert all(flag is (dtype != "float32") for _, _, flag in seen), seen


def test_dropouts_reach_the_model_in_train_mode_only():
    cfg = ModelConfig(**{**SMALL, "dropout": 0.1, "droppath": 0.1,
                         "input_dropout": 0.5}, attention_impl="pallas")
    model = UniVTG(cfg, device="cpu")
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32)),
            torch.ones(2, 5),
            torch.from_numpy(rng.standard_normal((2, 9, 40)).astype(np.float32)),
            torch.ones(2, 9)]
    with torch.no_grad():
        a = model(*args, train=True, generator=step_generator(0, 0, "cpu"))
        b = model(*args, train=True, generator=step_generator(0, 0, "cpu"))
        c = model(*args, train=True, generator=step_generator(0, 1, "cpu"))
        e = model(*args, train=False, generator=step_generator(0, 0, "cpu"))
        f = model(*args)
    assert torch.equal(a["saliency_scores"], b["saliency_scores"])
    assert not torch.equal(a["saliency_scores"], c["saliency_scores"])
    assert torch.equal(e["pred_spans"], f["pred_spans"])
    assert not torch.equal(a["pred_spans"], e["pred_spans"])
