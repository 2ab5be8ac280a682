"""``scan_steps``: the port's ``stack_batches`` and ``make_scan_train_step``
against the JAX package's, and the driver's scan loop.

On the CPU: ``stack_batches`` and ``strip_meta`` bit for bit against JAX's
(float32, bfloat16, float16, the float8 names, int8), the names the port
refuses; K = 4 scanned steps against JAX's ``lax.scan`` step (same weights,
dropouts 0, clipped AdamW: losses rtol 1e-4, params 2e-5); ``train_mr`` with
``scan_steps=2`` on 40 items at bsz 16 (one group and a remainder, as JAX's
``tests/test_scan_driver.py``) bit-equal to ``scan_steps=1``; a bucket change
flushing the group; ``resume_all`` mid-run equal to the uninterrupted run;
scan under a ring on the CPU equal to eager ring steps bit for bit and to
JAX's scan under ``jax.set_mesh``; a ring across two cards raising. The ``cuda`` tests (they skip without a
card, with the reason named) hold a CUDA-graph replay against eager single
steps at dropout 0, fresh attention-dropout masks per replay, and counters
that count replays.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from univtg_tpu_torch.data.collate import collate_mr
from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.ops import attention as attn
from univtg_tpu_torch.ops import flash_attention as fa
from univtg_tpu_torch.parallel import RingGroup, use_ring
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train import driver_mr
from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr
from univtg_tpu_torch.train.epoch_runner import TRANSFER_DTYPES, strip_meta
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import (
    TrainState,
    make_optimizer,
    make_scan_train_step,
    make_train_step,
    stack_batches,
)

torch.set_num_threads(1)
SMALL = dict(vid_dim=40, txt_dim=24, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, max_v_l=16, max_q_l=8, dropout=0.0, droppath=0.0,
             input_dropout=0.0)
LR = 1e-3
SCHED = (LR, 2, 200, 0.1, 2)  # lr, warmup, drop, gamma, steps per epoch
K = 4


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    """K collated batches of 4 from one synthetic corpus."""
    c = create_synthetic_mr_corpus(str(tmp_path_factory.mktemp("corpus")),
                                   n_train=8, n_val=1, v_dim=38, q_dim=24,
                                   max_clips=16)
    ds = MRDataset(MRDataConfig(
        data_path=c["train_path"], v_feat_dirs=c["v_feat_dirs"],
        q_feat_dir=c["q_feat_dir"], v_feat_dim=38, q_feat_dim=24, max_q_l=8,
        max_v_l=16))
    out = []
    for epoch in range(2):
        ds.set_epoch(epoch)
        out += [collate_mr([ds[j] for j in range(i, i + 4)], 8, 16) for i in (0, 4)]
    return out


def _bits(x):
    """Raw bits of a numpy or torch array (so bf16/fp8 compare exactly)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(x).view(np.uint8)


def _assert_same_bits(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(w), err_msg=k)


@pytest.mark.parametrize("transfer", ["float32", "bfloat16", "int8"])
def test_stack_batches_equals_jax_bit_for_bit(batches, transfer):
    from univtg_tpu.train import steps as jsteps

    smi, stg = stack_batches(batches[:K], transfer)
    jmi, jtg = jsteps.stack_batches(batches[:K], transfer)
    _assert_same_bits(smi, jmi)
    _assert_same_bits(stg, jtg)
    assert smi["src_vid_mask"].shape[0] == K


@pytest.mark.parametrize("transfer", [n for n in TRANSFER_DTYPES if n != "int8"])
def test_strip_meta_casts_as_jax_does(batches, transfer):
    """Every float name the port takes gives JAX's bits (float16 among them,
    which the port refused before)."""
    from univtg_tpu.train import epoch_runner as jrunner

    mi, tg = strip_meta(batches[0], transfer)
    jmi, jtg = jrunner.strip_meta(batches[0], transfer)
    assert mi["src_vid"].dtype == getattr(torch, transfer)
    _assert_same_bits(mi, jmi)
    _assert_same_bits(tg, jtg)


@pytest.mark.parametrize("name", ["int16", "uint8", "float", "half", "float4_e2m1fn"])
def test_strip_meta_refuses_what_is_not_a_torch_float_name(batches, name):
    """A documented difference: JAX casts to any dtype name numpy or
    ml_dtypes knows (int16 features, say); the port takes torch's floating
    dtypes by their own names, and int8's quantization."""
    with pytest.raises(ValueError, match=name):
        strip_meta(batches[0], name)


def _models(impl="xla"):
    """A JAX model with its init params, and the port's model with the same
    weights."""
    import jax

    from univtg_tpu.models import ModelConfig as JaxConfig
    from univtg_tpu.models import UniVTG as JaxUniVTG
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    jcfg = JaxConfig(**SMALL, attention_impl=impl)
    tcfg = ModelConfig(**SMALL, attention_impl=impl)
    z = np.zeros
    params = JaxUniVTG(jcfg).init(
        jax.random.PRNGKey(0), z((2, 8, 24), np.float32), np.ones((2, 8), np.float32),
        z((2, 16, 40), np.float32), np.ones((2, 16), np.float32), train=False)["params"]
    model = UniVTG(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    return JaxUniVTG(jcfg), params, model, tcfg


def test_scan_step_matches_jax_scan(batches):
    """K = 4 stacked steps of the port (on the CPU: the single steps in
    order) against JAX's lax.scan step, same weights, dropouts 0, clipped
    AdamW on the warmup schedule: each step's losses at rtol 1e-4, the
    params after at 2e-5 (the k-slice of each in_proj_bias, whose gradient
    is zero analytically, at 2 lr per step, as tests/test_torch_train.py)."""
    import jax

    from univtg_tpu.models.losses import LossWeights as JaxWeights
    from univtg_tpu.train import schedule as jschedule
    from univtg_tpu.train import steps as jsteps
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    jmodel, params, model, tcfg = _models()
    tx = jsteps.make_optimizer(jschedule.build_schedule(*SCHED), 1e-4, 0.1)
    jstate = jsteps.TrainState(params=params, opt_state=tx.init(params),
                               step=np.int32(0))
    jscan = jsteps.make_scan_train_step(jmodel, tx, JaxWeights())
    jsmi, jstg = jsteps.stack_batches(batches[:K])
    jstate, jm = jscan(jstate, jsmi, jstg, jax.random.PRNGKey(1))

    state = TrainState(model, make_optimizer(model.parameters(),
                                             build_schedule(*SCHED), 1e-4, 0.1))
    smi, stg = stack_batches(batches[:K])
    state, m = make_scan_train_step(LossWeights())(state, smi, stg, 1)
    assert state.step == K
    assert set(jm) <= set(m) and m["grad_norm"].shape == (K,)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), tcfg)
    got = state.model.state_dict()
    D = tcfg.hidden_dim
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("self_attn.in_proj_bias"):
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * LR * K, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, err_msg=k)


@pytest.fixture(scope="module")
def corpus40(tmp_path_factory):
    return create_synthetic_mr_corpus(str(tmp_path_factory.mktemp("scan")),
                                      n_train=40, n_val=1, v_dim=20, q_dim=8,
                                      max_clips=24, seed=9)


def _cfg(c, results_dir, **kw):
    data = MRDataConfig(data_path=c["train_path"], v_feat_dirs=c["v_feat_dirs"],
                        q_feat_dir=c["q_feat_dir"], v_feat_dim=20, q_feat_dim=8,
                        max_q_l=8, max_v_l=24)
    model = ModelConfig(vid_dim=22, txt_dim=8, hidden_dim=32, num_layers=2,
                        num_heads=4, ffn_dim=48, max_v_l=24, max_q_l=8,
                        attention_impl="pallas")
    return TrainConfig(model=model, train_data=data, results_dir=str(results_dir),
                       bsz=16, lr_warmup=1, num_io_threads=2, **kw)


def _log(results_dir):
    with open(os.path.join(results_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _params(path):
    return ckpt.read_checkpoint(path)["model"]


def test_train_mr_scan_steps_equals_single_steps(corpus40, tmp_path):
    """40 items at bsz 16: 3 batches an epoch, one group of 2 and a
    remainder; the dropouts at their defaults. On the CPU the group is the
    single steps in order, so the params are the same bits."""
    runs = {}
    for k in (1, 2):
        cfg = _cfg(corpus40, tmp_path / f"k{k}", n_epoch=2, scan_steps=k)
        train_mr(cfg, device="cpu")
        runs[k] = (_log(cfg.results_dir), _params(os.path.join(cfg.results_dir,
                                                               "model_best.ckpt")))
    (log1, p1), (log2, p2) = runs[1], runs[2]
    assert [line["steps"] for line in log2] == [3, 3]
    for a, b in zip(log1, log2, strict=True):
        assert set(a) == set(b)
        for key in a:
            if key != "time":
                assert a[key] == pytest.approx(b[key], rel=1e-6, abs=1e-9), key
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def test_a_bucket_change_flushes_the_group():
    """Batches of one video-length bucket stack; a bucket change sends the
    pending batches, and the epoch's remainder, through the single step."""
    calls = []

    def batch(L):
        return {"model_inputs": {"src_vid": np.zeros((2, L, 3), np.float32),
                                 "src_vid_mask": np.ones((2, L), np.float32)},
                "targets": {"t": np.zeros(2, np.float32)}, "meta": []}

    def single(state, mi, tg, seed):
        calls.append(("single", mi["src_vid"].shape[1]))
        return state, {"loss_overall": torch.zeros(())}

    def scan(state, smi, stg, seed):
        calls.append(("scan", (smi["src_vid"].shape[0], smi["src_vid"].shape[2])))
        return state, {"loss_overall": torch.zeros(smi["src_vid"].shape[0])}

    counted = []
    cfg = TrainConfig(scan_steps=2)
    loader = [batch(L) for L in (16, 16, 24, 24, 24, 16)]
    driver_mr._run_scan_epoch(cfg, loader, single, scan, None, 0, "cpu",
                              lambda m: counted.append(m["loss_overall"].numel()))
    assert calls == [("scan", (2, 16)), ("scan", (2, 24)), ("single", 24),
                     ("single", 16)]
    assert counted == [2, 2, 1, 1]


def test_resume_all_mid_run_equals_the_uninterrupted_run(corpus40, tmp_path):
    """scan_steps=2: one epoch, then resume_all from its checkpoint for the
    second, gives the params of two epochs in one run, bit for bit."""
    whole = _cfg(corpus40, tmp_path / "whole", n_epoch=2, scan_steps=2)
    train_mr(whole, device="cpu")
    first = _cfg(corpus40, tmp_path / "half", n_epoch=1, scan_steps=2)
    _, path = train_mr(first, device="cpu")
    second = dataclasses.replace(first, n_epoch=2)
    train_mr(second, resume=path, resume_all=True, device="cpu")
    assert [line["steps"] for line in _log(second.results_dir)] == [3, 3]
    got = _params(os.path.join(second.results_dir, "model_best.ckpt"))
    want = _params(os.path.join(whole.results_dir, "model_best.ckpt"))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_optimizer_files_resume_on_another_device():
    """A file keeps a plain rate, and loading it keeps this optimizer's own
    ``capturable`` (a card's AdamW is capturable, the CPU's is not; torch's
    load_state_dict would take the file's), so a card's checkpoint resumes
    on the CPU and the other way round."""
    model = UniVTG(ModelConfig(**SMALL), device="cpu")

    def stepped(opt, count):
        for p in opt.params:
            p.grad = torch.ones_like(p)
        opt.step(count)
        return opt

    saved = stepped(make_optimizer(model.parameters(), lambda c: 1e-3), 0).state_dict()
    assert all(isinstance(g["lr"], float) for g in saved["param_groups"])
    from_card = {**saved, "param_groups": [{**g, "capturable": True, "lr": torch.tensor(1e-3)}
                                           for g in saved["param_groups"]]}
    opt = make_optimizer(model.parameters(), lambda c: 2e-3)
    opt.load_state_dict(from_card)
    assert [g["capturable"] for g in opt.adamw.param_groups] == [False]
    stepped(opt, 1)
    assert opt.adamw.param_groups[0]["lr"] == 2e-3
    assert all(s["step"].device.type == "cpu" and float(s["step"]) == 2
               for s in opt.adamw.state.values())


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_scan_under_an_active_ring_raises(batches, impl, monkeypatch):
    """A ring whose ranks sit on two cards cannot be one CUDA graph: the
    scan step raises with the reason before it touches a card (two cards
    are pretended here; nothing runs on them)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    ring = RingGroup(2, devices=["cuda:0", "cuda:1"])
    model = UniVTG(ModelConfig(**{**SMALL, "attention_impl": impl}), device="cpu")
    state = TrainState(model, make_optimizer(model.parameters(), lambda s: 1e-3))
    smi, stg = stack_batches(batches[:2])
    with use_ring(ring):
        with pytest.raises(NotImplementedError, match=r"spans the cards \[0, 1\]"):
            make_scan_train_step(LossWeights())(state, smi, stg, 0)
    assert state.step == 0


def _ring_pair(impl):
    model = UniVTG(ModelConfig(**{**SMALL, "attention_impl": impl}), device="cpu", seed=3)
    twin = UniVTG(ModelConfig(**{**SMALL, "attention_impl": impl}), device="cpu", seed=3)
    return [TrainState(m, make_optimizer(m.parameters(), build_schedule(*SCHED), 1e-4, 0.1))
            for m in (model, twin)]


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_scan_under_a_ring_equals_eager_ring_steps(batches, impl):
    """K = 2 under use_ring(RingGroup(2) on the CPU) is two eager ring steps
    bit for bit (the K single steps in order), every step dispatched to the
    ring."""
    a, b = _ring_pair(impl)
    smi, stg = stack_batches(batches[:2])
    before = dict(attn.dispatches)
    with use_ring(RingGroup(2, devices=["cpu"] * 2)):
        a, got = make_scan_train_step(LossWeights())(a, smi, stg, 1)
        step = make_train_step(LossWeights())
        want = [step(b, *strip_meta(batch), 1)[1] for batch in batches[:2]]
    assert a.step == b.step == 2
    assert attn.dispatches[impl] - before[impl] == 2 * 2 * SMALL["num_layers"]
    assert attn.dispatches["xla"] == before["xla"]
    for k in want[0]:
        assert torch.equal(got[k], torch.stack([m[k] for m in want])), k
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name


def test_scan_under_a_ring_follows_jax_scan_under_a_mesh(batches):
    """K = 2 "ring_pallas" steps under use_ring(RingGroup(2) on the CPU)
    against JAX's lax.scan step with "ring" under
    jax.set_mesh(make_mesh(dp=1, tp=2)), from the same weights: losses and
    grad norms at rtol 1e-4, the params at 2e-5 (the k-slice of each
    in_proj_bias at 2 lr per step, as test_scan_step_matches_jax_scan)."""
    import jax

    from univtg_tpu.models.losses import LossWeights as JaxWeights
    from univtg_tpu.parallel import make_mesh
    from univtg_tpu.train import schedule as jschedule
    from univtg_tpu.train import steps as jsteps
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    jmodel, params, _, _ = _models("ring")
    _, _, model, tcfg = _models("ring_pallas")
    tx = jsteps.make_optimizer(jschedule.build_schedule(*SCHED), 1e-4, 0.1)
    jstate = jsteps.TrainState(params=params, opt_state=tx.init(params),
                               step=np.int32(0))
    jscan = jsteps.make_scan_train_step(jmodel, tx, JaxWeights())
    with jax.set_mesh(make_mesh(dp=1, tp=2)):
        jstate, jm = jscan(jstate, *jsteps.stack_batches(batches[:2]),
                           jax.random.PRNGKey(1))
    state = TrainState(model, make_optimizer(model.parameters(),
                                             build_schedule(*SCHED), 1e-4, 0.1))
    with use_ring(RingGroup(2, devices=["cpu"] * 2)):
        state, m = make_scan_train_step(LossWeights())(state, *stack_batches(batches[:2]), 1)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jstate.params), tcfg)
    got = state.model.state_dict()
    D = tcfg.hidden_dim
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("self_attn.in_proj_bias"):
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * LR * 2, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, err_msg=k)


# ---------------------------------------------------------------- on a card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan step replays a CUDA graph of "
                    "the hand-written flash kernels, which have no CPU mode "
                    "(run tests/test_torch_scan.py -m cuda on an H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_state(device, dropout=0.0, seed=0):
    cfg = ModelConfig(**{**SMALL, "attention_impl": "pallas", "dropout": dropout})
    model = UniVTG(cfg, device=device, seed=seed)
    return TrainState(model, make_optimizer(model.parameters(),
                                            build_schedule(*SCHED), 1e-4, 0.1))


def _card_groups(batches, n_groups, k=2):
    return [stack_batches((batches * n_groups)[i * k:(i + 1) * k]) for i in range(n_groups)]


@pytest.mark.cuda
def test_cuda_graph_replay_equals_eager_steps(cuda_device, batches):
    """Dropouts 0: three groups of 2 (eager, captured, replayed) against six
    single steps from the same weights: losses, grad norms and params with
    the same bits."""
    groups = _card_groups(batches, 3)
    a, b = _card_state(cuda_device), _card_state(cuda_device)
    scan, single = make_scan_train_step(LossWeights()), make_train_step(LossWeights())
    got, want = [], []
    for smi, stg in groups:
        got.append(scan(a, smi, stg, 5)[1])
        for i in range(2):
            mi = {k: v[i].to(cuda_device) for k, v in smi.items()}
            tg = {k: v[i].to(cuda_device) for k, v in stg.items()}
            want.append(single(b, mi, tg, 5)[1])
    assert len(scan.groups) == 1 and next(iter(scan.groups.values())).graph is not None
    for g, (w0, w1) in zip(got, zip(want[::2], want[1::2])):
        for key in w0:
            assert torch.equal(g[key].cpu(), torch.stack([w0[key], w1[key]]).cpu()), key
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_cuda_replays_draw_fresh_masks(cuda_device, batches, dropout):
    """At rate 0 the parameters stay put, so losses differ only by their
    masks. Attention dropout 0.1 (the flash kernels' in-kernel mask): two
    replays of one batch give other losses, and so do the two steps of one
    replay; dropout 0 gives the same bits throughout."""
    smi, stg = stack_batches([batches[0], batches[0]])
    scan = make_scan_train_step(LossWeights())
    state = _card_state(cuda_device, dropout=dropout)
    state.optimizer.schedule = lambda count: 0.0
    losses = [scan(state, smi, stg, 3)[1]["loss_overall"].cpu() for _ in range(3)]
    fresh = not torch.equal(losses[1], losses[2]) and losses[1][0] != losses[1][1]
    assert fresh == (dropout > 0), losses


@pytest.mark.cuda
def test_cuda_replays_add_to_the_counters(cuda_device, batches):
    """Each group of K steps counts, per step, one launch of each flash
    kernel per "pallas" dispatch, whether it ran eagerly, was captured or
    replayed."""
    groups = _card_groups(batches, 3)
    state = _card_state(cuda_device)
    scan = make_scan_train_step(LossWeights())
    per_step = None
    for smi, stg in groups:
        before = (dict(fa.launches), dict(attn.dispatches))
        scan(state, smi, stg, 0)
        made = {k: fa.launches[k] - before[0][k] for k in fa.launches}
        disp = attn.dispatches["pallas"] - before[1]["pallas"]
        per_step = per_step or disp // 2
        assert disp == 2 * per_step > 0
        assert made == {k: 2 * per_step for k in fa.launches}, made
