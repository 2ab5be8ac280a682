"""The port's UniVTG against the JAX package's at a small config (hidden 64,
2 layers, 4 heads, vid_dim 40, txt_dim 24): the exact weight round trip,
the forward with attention_impl "pallas" (JAX: Pallas in interpret mode;
port: the kernel's twin on the CPU) and "xla", padding invariance, the
src_cls bank and decode_dense_outputs, at float32, atol 1e-4."""
import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univtg_tpu.interop.torch_ckpt import params_from_torch_state_dict
from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.train.steps import decode_dense_outputs as jax_decode
from univtg_tpu_torch.interop import state_dict_from_jax_params
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models.config import check_supported
from univtg_tpu_torch.train.steps import decode_dense_outputs

torch.set_num_threads(1)
ATOL = 1e-4
SMALL = dict(vid_dim=40, txt_dim=24, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, max_v_l=16, max_q_l=8)
VARIANTS = {
    "xla": dict(attention_impl="xla"),
    "pallas": dict(attention_impl="pallas"),
    "pre_norm-txt_pos-ce": dict(attention_impl="xla", pre_norm=True,
                                use_txt_pos=True, span_loss_type="ce"),
}


@contextlib.contextmanager
def pallas_interpret():
    os.environ["UNIVTG_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        os.environ.pop("UNIVTG_PALLAS_INTERPRET", None)


def _configs(**kw):
    return JaxConfig(**SMALL, **kw), ModelConfig(**SMALL, **kw)


def _inputs(seed, B=3, Lv=12, Lt=6, vid_lens=(12, 7, 3), txt_lens=(6, 4, 1)):
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((B, Lv, SMALL["vid_dim"])).astype(np.float32)
    txt = rng.standard_normal((B, Lt, SMALL["txt_dim"])).astype(np.float32)
    vm = np.zeros((B, Lv), np.float32)
    tm = np.zeros((B, Lt), np.float32)
    for b in range(B):
        vm[b, : vid_lens[b]] = 1
        tm[b, : txt_lens[b]] = 1
    return txt, tm, vid, vm


def _jax_params(jcfg, seed=0):
    txt, tm, vid, vm = _inputs(0)
    params = JaxUniVTG(jcfg).init(jax.random.PRNGKey(seed), txt, tm, vid, vm,
                                  train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port(tcfg, params):
    model = UniVTG(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, tcfg), strict=True)
    return model


def _jax_apply(jcfg, params, *args):
    ctx = pallas_interpret() if jcfg.attention_impl == "pallas" else contextlib.nullcontext()
    with ctx:
        out = JaxUniVTG(jcfg).apply({"params": params}, *args, train=False)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_apply(model, *args):
    with torch.inference_mode():
        out = model(*[torch.from_numpy(a) for a in args])
    return {k: v.numpy() for k, v in out.items()}


def _assert_tree_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _to_jax(state_dict, jcfg):
    """The JAX package's converter, plus the pre-norm final LayerNorm that
    it does not map (upstream ``transformer.encoder.norm``)."""
    params = params_from_torch_state_dict(state_dict, jcfg)["params"]
    if jcfg.pre_norm:
        params["encoder"]["final_norm"] = {
            "scale": state_dict["transformer.encoder.norm.weight"].numpy(),
            "bias": state_dict["transformer.encoder.norm.bias"].numpy(),
        }
    return params


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_weight_round_trip_is_exact(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    params = _jax_params(jcfg)
    model = _port(tcfg, params)  # strict load: the key sets are equal
    _assert_tree_equal(_to_jax(model.state_dict(), jcfg), params)
    # and from the port's own seeded init: torch -> JAX -> torch is exact too
    native = UniVTG(tcfg, device="cpu", seed=3).state_dict()
    again = state_dict_from_jax_params(_to_jax(native, jcfg), tcfg)
    assert set(again) == set(native)
    for k in native:
        assert again[k].dtype == native[k].dtype, k
        assert torch.equal(again[k], native[k]), k


def test_seeded_init_is_deterministic():
    _, tcfg = _configs()
    a = UniVTG(tcfg, device="cpu", seed=5).state_dict()
    b = UniVTG(tcfg, device="cpu", seed=5).state_dict()
    c = UniVTG(tcfg, device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["weightedpool.weight"], c["weightedpool.weight"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    params = _jax_params(jcfg, seed=1)
    args = _inputs(2)
    want = _jax_apply(jcfg, params, *args)
    got = _port_apply(_port(tcfg, params), *args)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_padding_invariance(impl):
    """Valid positions do not depend on how far video or text are padded."""
    _, tcfg = _configs(attention_impl=impl)
    model = UniVTG(tcfg, device="cpu", seed=4)
    txt, tm, vid, vm = _inputs(5)
    short = _port_apply(model, txt, tm, vid, vm)
    long_args = (
        np.pad(txt, ((0, 0), (0, 5), (0, 0)), constant_values=3.0),
        np.pad(tm, ((0, 0), (0, 5))),
        np.pad(vid, ((0, 0), (0, 9), (0, 0)), constant_values=-2.0),
        np.pad(vm, ((0, 0), (0, 9))),
    )
    long = _port_apply(model, *long_args)
    for b, n in enumerate((12, 7, 3)):
        for k in ("pred_logits", "pred_spans", "saliency_scores"):
            np.testing.assert_allclose(long[k][b, :n], short[k][b, :n], atol=ATOL,
                                       err_msg=k)


def test_src_cls_bank_matches_jax():
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=2)
    rng = np.random.default_rng(6)
    cls = rng.standard_normal((5, 3, SMALL["txt_dim"])).astype(np.float32)
    cls_mask = np.ones((5, 3), np.float32)
    cls_mask[1, 2:] = 0
    args = _inputs(7) + (cls, cls_mask)
    want = _jax_apply(jcfg, params, *args)
    got = _port_apply(_port(tcfg, params), *args)
    assert got["cls_mem_proj"].shape == (5, SMALL["hidden_dim"])
    np.testing.assert_allclose(got["cls_mem_proj"], want["cls_mem_proj"], atol=ATOL)
    np.testing.assert_allclose(got["saliency_scores"], want["saliency_scores"], atol=ATOL)


@pytest.mark.parametrize("eval_mode", [None, "add"])
def test_decode_dense_outputs_matches_jax(eval_mode):
    jcfg, tcfg = _configs()
    params = _jax_params(jcfg, seed=3)
    txt, tm, vid, vm = _inputs(8)
    ts = np.random.default_rng(9).random((3, 12, 2)).astype(np.float32)
    out_j = JaxUniVTG(jcfg).apply({"params": params}, txt, tm, vid, vm, train=False)
    want = {k: np.asarray(v) for k, v in jax_decode(out_j, jnp.asarray(vm), jnp.asarray(ts),
                                                    eval_mode).items()}
    model = _port(tcfg, params)
    with torch.inference_mode():
        out_t = model(*[torch.from_numpy(a) for a in (txt, tm, vid, vm)])
        got = decode_dense_outputs(out_t, torch.from_numpy(vm), torch.from_numpy(ts), eval_mode)
    for k in ("scores", "spans", "saliency"):
        # saliency went through the fp16 cast on both sides
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=2e-3 if k == "saliency" else ATOL)
    np.testing.assert_array_equal(got["valid_len"].numpy(), want["valid_len"])
    assert got["valid_len"].dtype == torch.int32
    fp16 = out_t["saliency_scores"].half().float()
    if eval_mode == "add":
        fp16 = fp16 + out_t["pred_logits"][..., 0]
    assert torch.equal(got["saliency"], fp16)


def test_config_json_is_shared_with_the_jax_package():
    jcfg = JaxConfig(**SMALL, attention_impl="pallas", compute_dtype="bfloat16")
    tcfg = ModelConfig.from_json(jcfg.to_json())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.dtype == torch.bfloat16 and tcfg.head_dim == 16
    assert JaxConfig.from_json(tcfg.to_json()) == jcfg


@pytest.mark.parametrize("field,value,error,match", [
    ("pipeline_stages", 2, ValueError, "pipeline_stages needs scan_layers=True"),
    ("attention_impl", "splash", NotImplementedError, "ROADMAP"),
])
def test_unported_config_values_raise(field, value, error, match):
    """A pipeline without the scan layout raises JAX's error; an attention
    impl the port does not have names ROADMAP.md."""
    cfg = ModelConfig(**SMALL, **{field: value})
    with pytest.raises(error, match=match):
        check_supported(cfg)
    with pytest.raises(error):
        UniVTG(cfg, device="cpu")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_seq_shard_without_a_mesh_changes_nothing(impl):
    """seq_shard runs (parallel/mesh.py; a tp gang in tests/test_torch_tp.py);
    without a mesh it is a no-op, as JAX's seq_constraint is: the same
    outputs bit for bit, in eval and in a training forward."""
    outs = []
    for seq in (False, True):
        cfg = ModelConfig(**SMALL, seq_shard=seq, attention_impl=impl)
        check_supported(cfg)
        model = UniVTG(cfg, device="cpu", seed=5)
        args = [torch.from_numpy(x) for x in _inputs(1)]
        with torch.no_grad():
            outs.append([model(*args, train=train,
                               generator=torch.Generator().manual_seed(3))
                         for train in (False, True)])
    for a, b in zip(*outs):
        for k in ("pred_logits", "pred_spans", "saliency_scores"):
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("field,value", [
    ("scan_layers", True), ("remat", True), ("moe_experts", 4),
])
def test_one_process_model_options_build_and_run(field, value):
    """The options once refused (tests/test_torch_moe.py and
    tests/test_torch_remat.py hold them against JAX): they pass
    check_supported, build, and run a finite train-mode forward and
    backward; only a MoE model returns aux_moe, in training."""
    cfg = ModelConfig(**SMALL, **{field: value})
    check_supported(cfg)
    model = UniVTG(cfg, device="cpu")
    args = [torch.from_numpy(a) for a in _inputs(5)]
    out = model(*args, train=True, generator=torch.Generator().manual_seed(0))
    assert ("aux_moe" in out) == (field == "moe_experts")
    loss = out["saliency_scores"].nan_to_num(neginf=0.0).sum() + out.get("aux_moe", 0.0)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    with torch.inference_mode():
        assert "aux_moe" not in model(*args)


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_ring_attention_impls_are_supported(impl):
    """The ring impls are ported (tests/test_torch_ring.py): they pass
    check_supported and build, and run "xla" when no ring is active."""
    cfg = ModelConfig(**SMALL, attention_impl=impl)
    check_supported(cfg)
    model = UniVTG(cfg, device="cpu")
    args = [torch.from_numpy(a) for a in _inputs(4)]
    with torch.inference_mode():
        got = model(*args)["saliency_scores"]
        for layer in model.transformer.encoder.layers:
            layer.self_attn.impl = "xla"
        want = model(*args)["saliency_scores"]
    assert torch.equal(got, want)


def test_train_mode_raises():
    """Training draws dropout masks from an explicit generator: train mode
    without one raises (unless every rate is 0), eval ignores it, and
    model.train() only flips the default of ``train=``."""
    _, tcfg = _configs()
    model = UniVTG(tcfg, device="cpu")
    assert not model.training
    args = [torch.from_numpy(a) for a in _inputs(10)]
    with pytest.raises(ValueError, match="generator"):
        model(*args, train=True)
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(*args)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        trained = model(*args, generator=g)["saliency_scores"]
        evald = model(*args, train=False, generator=g)["saliency_scores"]
        model.eval()
        assert torch.equal(model(*args)["saliency_scores"], evald)
    assert not torch.equal(trained, evald)
    off = UniVTG(ModelConfig(**SMALL, droppath=0.0, input_dropout=0.0),
                 device="cpu")
    with torch.no_grad():
        off(*args, train=True)
