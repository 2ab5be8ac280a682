"""``resume_all`` from the JAX package's checkpoint, and the background
checkpoint writer.

Resume: a JAX run (``make_train_step`` / ``make_md_train_step`` and optax)
saved by the JAX package's ``save_checkpoint`` after k = 2 steps is resumed
in the port by ``restore_checkpoint`` (weights, optax state, step) and
stepped 2 more times on the batches JAX takes next: losses and grad norm at
rtol 1e-4, the params at 2e-5 (the k-slice of each in_proj_bias, whose
gradient is zero analytically, at 2 lr per step, as
tests/test_torch_train.py). UniVTG with ``grad_clip = 0.1`` and 0,
Moment-DETR, and ``train_mr(resume="auto")`` pointed at a JAX
``model_latest.ckpt``; the moments under the port's names (the fused
``in_proj_weight`` too); a tree that does not match the config raising with
the first path that differs; the committed fixture of chip_smoke.py phase
7l (tests/torch_golden/jax_resume) equal to what its script writes, and
resumed on the CPU.

Writer: ``AsyncCheckpointer``'s files equal the synchronous writer's; the
state is on the host when ``save`` returns; at most one write in flight; a
writer's error re-raises on the next ``save``/``wait``; ``train_mr`` with
``async_checkpoint`` on and off writes equal checkpoints.
"""
import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.models import moment_detr as jmd
from univtg_tpu.models.losses import LossWeights as JaxWeights
from univtg_tpu.train import checkpoint as jckpt
from univtg_tpu.train import schedule as jschedule
from univtg_tpu.train import steps as jsteps
from univtg_tpu_torch.data.collate import collate_mr
from univtg_tpu_torch.data.loader import Loader
from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.interop import state_dict_from_jax
from univtg_tpu_torch.interop.jax_params import JaxTreeMismatch
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models import moment_detr as md
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import (
    TrainState,
    make_md_train_step,
    make_optimizer,
    make_train_step,
)

torch.set_num_threads(1)
SMALL = dict(vid_dim=40, txt_dim=24, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, max_v_l=16, max_q_l=8, dropout=0.0, droppath=0.0,
             input_dropout=0.0)
MD_EXTRA = dict(num_queries=5, num_decoder_layers=2)
BSZ, LR, K = 4, 1e-3, 2
SCHED = (LR, 2, 200, 0.1, 2)  # lr, warmup, drop, gamma, steps per epoch
WEIGHTS = dict(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
CASES = {  # name -> (model, grad_clip)
    "univtg_clip": ("univtg", 0.1),
    "univtg_no_clip": ("univtg", 0.0),
    "moment_detr": ("moment_detr", 0.1),
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return create_synthetic_mr_corpus(str(tmp_path_factory.mktemp("corpus")), n_train=8,
                                      n_val=1, v_dim=38, q_dim=24, max_clips=16, seed=4)


def _data(c):
    return MRDataConfig(data_path=c["train_path"], v_feat_dirs=c["v_feat_dirs"],
                        q_feat_dir=c["q_feat_dir"], v_feat_dim=38, q_feat_dim=24,
                        max_q_l=8, max_v_l=16)


@pytest.fixture(scope="module")
def batches(corpus):
    """The port Loader's batches for epochs 0 and 1 (2 a epoch), as
    train_mr draws them at seed 2018."""
    ds = MRDataset(_data(corpus))
    loader = Loader(ds, BSZ, lambda items, pad_batch_to: collate_mr(
        items, 8, 16, pad_batch_to), shuffle=True, seed=2018, num_threads=1)
    out = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        out += [(b["model_inputs"], b["targets"]) for b in loader]
    return out


def _configs(model_name):
    if model_name == "moment_detr":
        return jmd.MomentDETRConfig(**SMALL, **MD_EXTRA), md.MomentDETRConfig(**SMALL, **MD_EXTRA)
    return JaxConfig(**SMALL), ModelConfig(**SMALL)


def _jax_run(model_name, grad_clip, batches, n_steps):
    """JAX init from PRNGKey(0), then n_steps steps: [(state, metrics)]
    after each step, the initial state first."""
    jcfg, _ = _configs(model_name)
    mi0 = batches[0][0]
    args = (mi0["src_txt"], mi0["src_txt_mask"], mi0["src_vid"], mi0["src_vid_mask"])
    if model_name == "moment_detr":
        jmodel = jmd.MomentDETR(jcfg)
        params = jmodel.init(jax.random.PRNGKey(0), *args)["params"]
    else:
        jmodel = JaxUniVTG(jcfg)
        params = jmodel.init(jax.random.PRNGKey(0), *args, train=False)["params"]
    tx = jsteps.make_optimizer(jschedule.build_schedule(*SCHED), 1e-4, grad_clip)
    state = jsteps.TrainState(params=params, opt_state=tx.init(params), step=np.int32(0))
    if model_name == "moment_detr":
        step = jsteps.make_md_train_step(jmodel, tx, JaxWeights(**WEIGHTS), 0.1, 0.2,
                                         donate=False)
    else:
        step = jsteps.make_train_step(jmodel, tx, JaxWeights(**WEIGHTS), donate=False)
    out = [(state, None)]
    for mi, tg in batches[:n_steps]:
        state, m = step(state, mi, tg, jax.random.PRNGKey(1))
        out.append((state, {k: float(v) for k, v in m.items()}))
    return out


def _port_state(model_name, grad_clip, seed=7):
    _, cfg = _configs(model_name)
    cls = md.MomentDETR if model_name == "moment_detr" else UniVTG
    model = cls(cfg, device="cpu", seed=seed)  # another init than JAX's
    return TrainState(model, make_optimizer(model.parameters(), build_schedule(*SCHED),
                                            1e-4, grad_clip))


def _port_step(model_name):
    if model_name == "moment_detr":
        return make_md_train_step(LossWeights(**WEIGHTS), 0.1, 0.2)
    return make_train_step(LossWeights(**WEIGHTS))


def _assert_params_follow(state, jparams, n_steps):
    cfg = state.model.cfg
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    got = state.model.state_dict()
    D = cfg.hidden_dim
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("self_attn.in_proj_bias"):
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * LR * n_steps, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_resume_all_continues_the_jax_trajectory(batches, tmp_path, case):
    model_name, grad_clip = CASES[case]
    run = _jax_run(model_name, grad_clip, batches, 2 * K)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, run[K][0], epoch=0)
    state = _port_state(model_name, grad_clip)
    state, epoch = ckpt.restore_checkpoint(path, state)
    assert (epoch, state.step) == (0, K)
    assert all(float(s["step"]) == K for s in state.optimizer.adamw.state.values())
    step = _port_step(model_name)
    for i in range(K, 2 * K):
        mi, tg = batches[i]
        state, m = step(state, {k: torch.from_numpy(v) for k, v in mi.items()},
                        {k: torch.from_numpy(v) for k, v in tg.items()}, 1)
        want = run[i + 1][1]
        assert set(m) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(m[k].item(), w, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} at step {i}")
    assert state.step == 2 * K
    _assert_params_follow(state, run[-1][0].params, 2 * K)


def test_jax_moments_land_under_the_port_names(batches, tmp_path):
    """exp_avg / exp_avg_sq of every parameter are mu / nu through the
    weight converter: the fused in_proj_weight is in_proj_kernel
    transposed; the file's step and epoch are kept; a CPU optimizer keeps a
    CPU step (the card's capturable AdamW gets it on the card, as torch's
    load_state_dict places a capturable step)."""
    run = _jax_run("univtg", 0.1, batches, K)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, run[K][0], epoch=5)
    state, epoch = ckpt.restore_checkpoint(path, _port_state("univtg", 0.1))
    assert epoch == 5
    adam = jax.tree_util.tree_map(np.asarray, run[K][0].opt_state[1][0])
    names = [n for n, _ in state.model.named_parameters()]
    got = {names[i]: s for i, s in enumerate(state.optimizer.adamw.state_dict()["state"].values())}
    key = "transformer.encoder.layers.0.self_attn.in_proj_weight"
    for slot, moment in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = moment["encoder"]["layers_0"]["in_proj_kernel"].T
        np.testing.assert_array_equal(got[key][slot].numpy(), want)
        assert torch.equal(got["weightedpool.weight"][slot],
                           torch.from_numpy(np.array(moment["weighted_pool"]["w"])))
    assert all(s["step"].device.type == "cpu" and float(s["step"]) == K
               for s in got.values())
    assert len(got) == len(names)


def test_train_mr_resume_auto_continues_a_jax_run(corpus, batches, tmp_path):
    """A JAX model_latest.ckpt of epoch 0 (2 steps) in results_dir:
    train_mr(resume="auto") trains epoch 1 on the Loader's batches as JAX
    would, and its final params follow JAX's 2e-5."""
    run = _jax_run("univtg", 0.1, batches, 2 * K)
    results = tmp_path / "run"
    results.mkdir()
    jckpt.save_checkpoint(str(results / "model_latest.ckpt"), run[K][0], epoch=0)
    cfg = TrainConfig(model=ModelConfig(**SMALL), train_data=_data(corpus),
                      results_dir=str(results), bsz=BSZ, n_epoch=2, lr=SCHED[0],
                      lr_warmup=SCHED[1], lr_drop=SCHED[2], lr_gamma=SCHED[3],
                      weights=LossWeights(**WEIGHTS), save_interval=-1, num_io_threads=1,
                      prefetch_depth=0)
    _, best = train_mr(cfg, resume="auto", device="cpu")
    with open(results / "train_log.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [(line["epoch"], line["steps"]) for line in lines] == [(1, K)]
    for k in ("loss_overall", "grad_norm"):
        want = np.mean([run[i + 1][1][k] for i in range(K, 2 * K)])
        np.testing.assert_allclose(lines[0][k], want, rtol=1e-4, err_msg=k)
    state = _port_state("univtg", 0.1)
    state.model.load_state_dict(ckpt.read_checkpoint(best)["model"])
    _assert_params_follow(state, run[-1][0].params, 2 * K)


@pytest.mark.parametrize("what,port,grad_clip,match", [
    ("no clip in the file", dict(SMALL), 0.0,
     r"opt_state has the links \['0', '1'\]; grad_clip=0.0"),
    ("a layer fewer in the config", dict(SMALL, num_layers=1), 0.1,
     r"params/encoder/layers_1/\S+, which the model of this config does not have"),
    ("another width", dict(SMALL, ffn_dim=48), 0.1,
     r"params/encoder/layers_0/linear1/kernel has the shape of \(96, 64\)"),
    ("text positions the file lacks", dict(SMALL, use_txt_pos=True), 0.1,
     r"the JAX tree has no params/txt_pos"),
])
def test_a_jax_tree_that_does_not_match_raises(batches, tmp_path, what, port, grad_clip,
                                               match):
    run = _jax_run("univtg", 0.1, batches, 1)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, run[1][0], epoch=0)
    model = UniVTG(ModelConfig(**port), device="cpu")
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(*SCHED),
                                             1e-4, grad_clip))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(JaxTreeMismatch, match=match):
        ckpt.restore_checkpoint(path, state)
    assert state.step == 0 and all(torch.equal(v, before[k])
                                   for k, v in model.state_dict().items())


def test_counts_that_disagree_raise(batches, tmp_path):
    """Adam's count and the schedule's are one count in the port."""
    run = _jax_run("univtg", 0.1, batches, 1)
    jstate = run[1][0]
    clip, (adam, decay, sched) = jstate.opt_state
    jstate = jstate.replace(opt_state=(clip, (adam, decay, sched._replace(count=np.int32(9)))))
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, jstate, epoch=0)
    with pytest.raises(JaxTreeMismatch, match="count is 1 but the schedule's .* is 9"):
        ckpt.restore_checkpoint(path, _port_state("univtg", 0.1))


# ------------------------------------------------- the card's JAX fixture

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden")


def _golden():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_jax_resume", os.path.join(GOLDEN, "make_jax_resume.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, tree


def test_the_golden_fixture_is_what_its_script_writes(tmp_path):
    """tests/torch_golden/jax_resume (chip_smoke.py phase 7l) is the JAX
    package's run that make_jax_resume.py writes: the same tree, arrays
    and metrics (1e-6: another host's XLA may round otherwise)."""
    made = _golden().make(str(tmp_path / "jax_resume"))
    committed = os.path.join(GOLDEN, "jax_resume")
    got = dict(_flat(ckpt.read_checkpoint(os.path.join(made, "model_latest.ckpt"))))
    want = dict(_flat(ckpt.read_checkpoint(os.path.join(committed, "model_latest.ckpt"))))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    with np.load(os.path.join(made, "batches.npz")) as a, \
            np.load(os.path.join(committed, "batches.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
    with open(os.path.join(made, "expected.json")) as a, \
            open(os.path.join(committed, "expected.json")) as b:
        got, want = json.load(a), json.load(b)
    assert {k: v for k, v in got.items() if k != "metrics"} == \
        {k: v for k, v in want.items() if k != "metrics"}
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-6), k


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_the_golden_fixture_resumes_on_the_cpu(impl):
    """Phase 7l's check on the CPU ("pallas": the kernels' twins): the
    fixture restored by resume_all, then its 2 batches, against JAX's
    recorded metrics at rtol 1e-4."""
    root = os.path.join(GOLDEN, "jax_resume")
    with open(os.path.join(root, "expected.json")) as f:
        want = json.load(f)
    cfg = ModelConfig(**want["model"], attention_impl=impl)
    model = UniVTG(cfg, device="cpu", seed=1)
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


# ---------------------------------------------------------------- the writer


def _stepped_state():
    state = _port_state("univtg", 0.1)
    for p in state.optimizer.params:
        p.grad = torch.full_like(p, 0.5)
    state.optimizer.step(0)
    state.step = 1
    return state


def _same_blob(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _same_blob(got[k], want[k])
        elif isinstance(want[k], torch.Tensor):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def test_async_writer_files_equal_the_synchronous_ones(tmp_path):
    """The file's tensors are the state's as save() found it, though the
    parameters change right after it returns."""
    state = _stepped_state()
    cfg_json = json.dumps({"x": 1})
    ckpt.save_checkpoint(str(tmp_path / "sync" / "m.ckpt"), state, 3, cfg_json)
    writer = ckpt.AsyncCheckpointer()
    writer.save(str(tmp_path / "async" / "m.ckpt"), state, 3, cfg_json)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    writer.wait()
    _same_blob(ckpt.read_checkpoint(str(tmp_path / "async" / "m.ckpt")),
               ckpt.read_checkpoint(str(tmp_path / "sync" / "m.ckpt")))
    assert (tmp_path / "async" / "opt.json").read_text() == cfg_json
    assert not os.path.exists(tmp_path / "async" / "m.ckpt.tmp")


def test_async_writer_keeps_one_write_in_flight(tmp_path, monkeypatch):
    """A second save waits for the first write to land, so the files come
    in the order of the saves; wait() returns once the last has landed."""
    release, order, active = threading.Event(), [], []
    write = ckpt._write_blob

    def slow(path, blob, config_json):
        active.append(path)
        assert len(active) == 1, "two writes in flight"
        if not order:
            release.wait(timeout=30)
        write(path, blob, config_json)
        order.append(os.path.basename(path))
        active.remove(path)

    monkeypatch.setattr(ckpt, "_write_blob", slow)
    state = _stepped_state()
    writer = ckpt.AsyncCheckpointer()
    writer.save(str(tmp_path / "latest.ckpt"), state, 0)
    second = threading.Thread(target=writer.save,
                              args=(str(tmp_path / "best.ckpt"), state, 0))
    second.start()
    second.join(timeout=0.5)
    assert second.is_alive() and order == []  # joined on the first write
    release.set()
    second.join(timeout=30)
    writer.wait()
    assert order == ["latest.ckpt", "best.ckpt"]


@pytest.mark.parametrize("then", ["save", "wait"])
def test_async_writer_error_reraises(tmp_path, then):
    """A write that fails (here: its directory is a file) raises on the next
    save() or wait(), as RuntimeError from the writer's error; the writer
    goes on working after it."""
    (tmp_path / "blocked").write_text("a file where a directory should be")
    state = _stepped_state()
    writer = ckpt.AsyncCheckpointer()
    writer.save(str(tmp_path / "blocked" / "m.ckpt"), state, 0)
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as info:
        if then == "save":
            writer.save(str(tmp_path / "ok.ckpt"), state, 0)
        else:
            writer.wait()
    assert isinstance(info.value.__cause__, OSError)
    writer.save(str(tmp_path / "ok.ckpt"), state, 0)
    writer.wait()
    assert os.path.exists(tmp_path / "ok.ckpt")


def test_train_mr_writes_equal_checkpoints_with_and_without_the_writer(corpus, tmp_path):
    files = {}
    for on in (True, False):
        cfg = TrainConfig(model=ModelConfig(**SMALL), train_data=_data(corpus),
                          eval_data=dataclasses.replace(_data(corpus),
                                                        data_path=corpus["val_path"]),
                          results_dir=str(tmp_path / f"async_{on}"), bsz=BSZ, n_epoch=2,
                          eval_epoch=1, lr_warmup=1, save_interval=1, num_io_threads=1,
                          async_checkpoint=on)
        train_mr(cfg, device="cpu")
        files[on] = sorted(f for f in os.listdir(cfg.results_dir) if f.endswith(".ckpt"))
        assert files[on] == ["model_best.ckpt", "model_e0001.ckpt", "model_latest.ckpt"]
    for name in files[True]:
        got = ckpt.read_checkpoint(str(tmp_path / "async_True" / name))
        want = ckpt.read_checkpoint(str(tmp_path / "async_False" / name))
        assert got["opt"]["async_checkpoint"] and not want["opt"]["async_checkpoint"]
        got["opt"] = want["opt"] = None
        _same_blob(got, want)
