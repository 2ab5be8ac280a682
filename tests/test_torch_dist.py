"""Training across processes on the CPU: gangs of two gloo ranks
(tests/torch_dist_worker.py, one subprocess each, a ``file://`` store in
tmp_path, a timeout per gang) against one process and the JAX package.

(a) the ranks' summed gradients of the global-batch step equal the one-
process gradients on the whole batch (plain, gated, a rank without
saliency, a rank without a positive span, Moment-DETR); (b) a 2-rank
``train_vlp`` gang against the JAX package's one-process step on the same
assembled global batches from the same weights: losses and grad norms at
rtol 1e-4, parameters at 2e-5, the ranks bit-equal; (c) the Loader's shards,
its bucket plan (``plan_shards``) and collate's ``pad_v_to`` against JAX's;
(d) ``sharded_eval`` against the full evaluation; (e) the elastic restart
after ``inject_fault_epoch``; (f) the broadcast early stop; (g) what is
still refused, and the backend rule.
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from univtg_tpu_torch.data.collate import collate_mr
from univtg_tpu_torch.data.loader import Loader
from univtg_tpu_torch.data.mr import MRDataset
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.parallel import dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)
GANG_TIMEOUT = 180


def _once(tmp_path_factory, name, make):
    """``make(dir)`` run once per test session, whichever xdist worker asks
    first (the others wait on a lock and reuse the directory): the shared
    gangs and corpora are not remade by every worker that runs one of their
    tests. Returns what ``make`` returned, as JSON."""
    import fcntl

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent  # the session's directory, shared by its workers
    root = base / "torch_dist"
    root.mkdir(exist_ok=True)
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = root / name / "done.json"
        if not done.exists():
            (root / name).mkdir(exist_ok=True)
            done.write_text(json.dumps(make(str(root / name))))
        return json.loads(done.read_text())


@pytest.fixture(scope="module")
def meta(tmp_path_factory):
    def make(root):
        a = create_synthetic_mr_corpus(os.path.join(root, "a"), n_train=20, n_val=6, seed=31)
        b = create_synthetic_mr_corpus(os.path.join(root, "b"), n_train=12, n_val=4, seed=32)
        return {"corpora": [a, b], "bsz": 8, "root": root}

    return _once(tmp_path_factory, "corpora", make)


def _launch(meta, base, mode, world=2, **extra):
    """Start a gang of ``world`` ranks in ``base``; returns the processes."""
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, f"meta_{mode}.json")
    with open(path, "w") as f:
        json.dump({**meta, **extra}, f)
    store = os.path.join(base, f"store_{mode}")
    if os.path.exists(store):  # a FileStore left by a gang that failed
        os.remove(store)
    store = "file://" + store
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), str(r), str(world),
         store, mode, path, base],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _wait(procs, rcs=None):
    """Wait for the gang (GANG_TIMEOUT), then check each rank's exit code
    (0 unless ``rcs`` says otherwise); returns the outputs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GANG_TIMEOUT)[0])
    finally:
        _kill(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        want = 0 if rcs is None else rcs[r]
        if want is not None:
            assert p.returncode == want, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# (a) ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gang_grads(meta, tmp_path_factory):
    def make(base):
        _wait(_launch(meta, base, "grads"))
        return base

    base = _once(tmp_path_factory, "grads", make)
    return [torch.load(os.path.join(base, f"grads_r{r}.pt")) for r in range(2)]


@pytest.mark.parametrize("case", worker.GRAD_CASES)
def test_rank_gradients_sum_to_the_one_process_gradient(meta, gang_grads, case):
    """Each rank steps on its half of the batch; after the all-reduce both
    hold the one-process gradient of the whole batch (|d| <= 1e-6 of the
    largest gradient, and at least 1e-6), and the global batch's losses."""
    losses, grads = worker.grads_of(case, meta["corpora"][0], meta["bsz"])
    (l0, g0), (l1, g1) = gang_grads[0][case], gang_grads[1][case]
    assert l0 == l1
    for k, v in losses.items():
        assert l0[k] == pytest.approx(v, rel=1e-6, abs=1e-7), k
    scale = max(1.0, max(float(g.abs().max()) for g in grads.values()))
    for name, g in grads.items():
        assert torch.equal(g0[name], g1[name]), name
        err = float((g0[name] - g).abs().max())
        assert err <= 1e-6 * scale, (name, err, scale)
    assert any(float(g.abs().max()) > 0 for g in grads.values())


# (b) ------------------------------------------------------------------------

def _jax_twin(obj, jcls):
    """The JAX package's dataclass of the same fields as ``obj``."""
    out = {}
    for f in dataclasses.fields(jcls):
        if hasattr(obj, f.name):
            out[f.name] = getattr(obj, f.name)
    return jcls(**out)


def test_train_vlp_gang_follows_the_jax_global_batch_step(meta, tmp_path):
    """2 ranks x bsz 4, 2 epochs, dropouts 0, from the JAX init: every
    epoch's losses and grad norm at rtol 1e-4 of JAX's one-process step on
    the two shards' batches concatenated, the final parameters at 2e-5,
    and the two ranks' parameters bit-equal."""
    import jax

    from univtg_tpu.data import vlp as jvlp
    from univtg_tpu.data.collate import collate_mr as jcollate
    from univtg_tpu.data.loader import Loader as JLoader
    from univtg_tpu.models import ModelConfig as JModelConfig
    from univtg_tpu.models.losses import LossWeights as JLossWeights
    from univtg_tpu.parallel import make_mesh, replicate_params, shard_batch
    from univtg_tpu.train import driver_vlp as jdriver
    from univtg_tpu.train.driver_mr import build_everything
    from univtg_tpu.train.steps import make_train_step as jmake_train_step
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    cfg = worker.build_cfg(meta, str(tmp_path / "unused"))
    jdata = jvlp.VLPDataConfig(
        **{**dataclasses.asdict(cfg.vlp_data),
           "corpora": tuple(_jax_twin(c, jvlp.VLPCorpusSpec) for c in cfg.vlp_data.corpora)})
    jcfg = _jax_twin(cfg, jdriver.VLPTrainConfig)
    jcfg = dataclasses.replace(jcfg, model=_jax_twin(cfg.model, JModelConfig), vlp_data=jdata,
                               weights=_jax_twin(cfg.weights, JLossWeights), use_gates=True)
    ds = jvlp.VLPDataset(jdata)
    loaders = [JLoader(ds, cfg.bsz, lambda items, pad_batch_to: jcollate(
        items, jdata.max_q_l, jdata.max_v_l, pad_batch_to), shuffle=True, seed=cfg.seed,
        num_threads=2, shard_index=s, num_shards=2) for s in range(2)]
    model, optimizer, state = build_everything(jcfg, len(loaders[0]))
    init = str(tmp_path / "init.ckpt")
    torch.save({"model": state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, state.params), cfg.model)}, init)
    base = str(tmp_path / "gang")
    procs = _launch(meta, base, "train", init=init)
    try:
        mesh = make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
        state = state.replace(params=replicate_params(mesh, state.params))
        step = jmake_train_step(model, optimizer, jcfg.weights, tuple(jcfg.losses),
                                use_gates=True)
        rng = jax.random.PRNGKey(cfg.seed + 1)
        want = []
        for epoch in range(cfg.n_epoch):
            for ld in loaders:
                ld.set_epoch(epoch)
            per = []
            for b0, b1 in zip(*loaders):
                mi, tg = ({k: np.concatenate([b0[part][k], b1[part][k]]) for k in b0[part]}
                          for part in ("model_inputs", "targets"))
                state, m = step(state, shard_batch(mesh, mi), shard_batch(mesh, tg), rng)
                per.append({k: float(v) for k, v in m.items()})
            want.append({k: float(np.mean([p[k] for p in per])) for k in per[0]} | {
                "steps": len(per)})
    finally:
        _wait(procs)
    logs = [_log(os.path.join(base, f"p{r}", "train_log.jsonl")) for r in range(2)]
    assert [line["epoch"] for line in logs[0]] == [0, 1]
    for l0, l1, w in zip(logs[0], logs[1], want, strict=True):
        assert l0["steps"] == l1["steps"] == w["steps"] == 4  # 32 items / (4 x 2)
        keys = [k for k in w if k.startswith("loss_") or k == "grad_norm"]
        assert "grad_norm" in keys and len(keys) > 3
        for k in keys:
            assert l0[k] == l1[k], k
            np.testing.assert_allclose(l0[k], w[k], rtol=1e-4, err_msg=k)
    finals = [torch.load(os.path.join(base, f"p{r}", "final.pt")) for r in range(2)]
    jfinal = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, state.params),
                                        cfg.model)
    for k, v in finals[0].items():
        assert torch.equal(v, finals[1][k]), k
        if k in jfinal:
            np.testing.assert_allclose(v.numpy(), np.asarray(jfinal[k]), atol=2e-5,
                                       err_msg=k)
    with open(os.path.join(base, "p1", "opt.json")) as f:
        assert json.load(f)["shard_index"] == 1
    assert os.path.exists(os.path.join(base, "p0", "model_best.ckpt"))
    assert not os.path.exists(os.path.join(base, "p1", "model_best.ckpt"))
    assert not os.path.exists(os.path.join(base, "p1", "code.zip"))


# (c) ------------------------------------------------------------------------

def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["meta"] == w["meta"]
        for part in ("model_inputs", "targets"):
            assert set(g[part]) == set(w[part])
            for k in w[part]:
                assert g[part][k].dtype == w[part][k].dtype, k
                np.testing.assert_array_equal(g[part][k], w[part][k], err_msg=k)


@pytest.mark.parametrize("plan", [False, True], ids=["shards", "bucket_plan"])
def test_rank_batches_and_hints_equal_the_jax_loaders(meta, plan):
    from univtg_tpu.data.collate import collate_mr as jcollate
    from univtg_tpu.data.loader import Loader as JLoader
    from univtg_tpu.data.mr import MRDataConfig as JMRDataConfig
    from univtg_tpu.data.mr import MRDataset as JMRDataset

    cfg = worker.build_cfg(meta, "unused", "evalstop").eval_data
    cfg = dataclasses.replace(cfg, data_path=meta["corpora"][0]["train_path"])
    ds, jds = MRDataset(cfg), JMRDataset(_jax_twin(cfg, JMRDataConfig))
    buckets = (8, 16) if plan else None
    lengths = ds.feature_lengths()
    np.testing.assert_array_equal(lengths, jds.feature_lengths())

    def loaders(cls, data, coll, shard):
        return cls(data, 3, lambda items, pad_batch_to, pad_v_to=None: coll(
            items, 10, cfg.max_v_l, pad_batch_to, v_buckets=buckets, pad_v_to=pad_v_to),
            shuffle=True, seed=5, num_threads=2, shard_index=shard, num_shards=2,
            lengths=lengths if plan else None, plan_shards=plan, plan_buckets=buckets)

    for shard in (0, 1):
        ld, jld = loaders(Loader, ds, collate_mr, shard), loaders(JLoader, jds, jcollate, shard)
        assert len(ld) == len(jld) == (3 if plan else 4)
        for epoch in (0, 1):
            ld.set_epoch(epoch)
            jld.set_epoch(epoch)
            if plan:
                got, want = ld._global_plan(), jld._global_plan()
                assert got[1] == want[1] and all(h in (8, 16, 1 << 30) for h in got[1])
                for g, w in zip(got[0], want[0], strict=True):
                    np.testing.assert_array_equal(g, w)
            _same_batches(list(ld), list(jld))


def test_pad_v_to_cuts_and_clamps_as_jax_does(meta):
    """A batch longer than its planned target is cut to it with a warning
    and its clip-index labels clamped, as the JAX collate does."""
    from univtg_tpu.data.collate import collate_mr as jcollate

    cfg = worker.build_cfg(meta, "unused", "evalstop").eval_data
    items = [MRDataset(cfg)[i] for i in range(4)]
    longest = max(len(it["video_feat"]) for it in items)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a batch that fits its target warns of nothing
        got = collate_mr(items, 10, cfg.max_v_l, 4, pad_v_to=longest + 3)
        want = jcollate(items, 10, cfg.max_v_l, 4, pad_v_to=longest + 3)
    assert got["model_inputs"]["src_vid"].shape[1] == min(longest + 3, cfg.max_v_l)
    _same_batches([got], [want])
    with pytest.warns(UserWarning, match="under-shoot"):
        got = collate_mr(items, 10, cfg.max_v_l, 4, pad_v_to=longest - 5)
    with pytest.warns(UserWarning, match="under-shoot"):
        want = jcollate(items, 10, cfg.max_v_l, 4, pad_v_to=longest - 5)
    assert got["model_inputs"]["src_vid"].shape[1] == longest - 5
    _same_batches([got], [want])
    assert got["targets"]["saliency_pos_labels"].max() <= longest - 6


# (d), (f) --------------------------------------------------------------------

@pytest.fixture(scope="module")
def evalstop(meta, tmp_path_factory):
    def make(base):
        _wait(_launch(meta, base, "evalstop"))
        return base

    return _once(tmp_path_factory, "evalstop", make)


def test_sharded_eval_equals_the_full_evaluation(meta, evalstop):
    """Both ranks score their stride shard of the val split; rank 0's merged
    metrics equal one process's full evaluation of the checkpoint saved at
    that evaluation (rel 1e-6), and only rank 0 wrote them."""
    from univtg_tpu_torch.train import checkpoint as ckpt
    from univtg_tpu_torch.train import driver_mr
    from univtg_tpu_torch.train.steps import make_eval_step

    base = evalstop
    cfg = worker.build_cfg(meta, os.path.join(base, "full"), "evalstop")
    eval_ds = MRDataset(cfg.eval_data)
    rows = _log(os.path.join(base, "p0", "latest_val_preds.jsonl"))
    assert [r["qid"] for r in rows] == [m["qid"] for m in eval_ds.data]
    (line,) = _log(os.path.join(base, "p0", "eval_log.jsonl"))
    model = driver_mr.build_model(cfg, "cpu", cfg.seed)
    model.load_state_dict(ckpt.restore_params(
        os.path.join(base, "p0", "model_latest.ckpt"), model.state_dict()))
    sub = driver_mr._run_eval_shard(cfg, model, eval_ds, make_eval_step(cfg.eval_mode))
    want = driver_mr.evaluate_submission(sub, eval_ds.data)["brief"]
    assert "MR-full-mAP-key" in want
    for k, v in want.items():
        assert line[k] == pytest.approx(v, rel=1e-6), k
    assert not os.path.exists(os.path.join(base, "p1", "latest_val_preds.jsonl"))
    assert not os.path.exists(os.path.join(base, "p1", "model_latest.ckpt"))


def test_early_stop_ends_every_rank(evalstop):
    """Rank 0's stop after its first evaluation (max_es_cnt=1, no gain)
    reaches rank 1: both log epoch 0 only of 4 and exit 0; the final-save
    decision too (rank 0 saves model_best.ckpt, rank 1 nothing)."""
    base = evalstop
    for r in range(2):
        assert [line["epoch"] for line in _log(os.path.join(base, f"p{r}",
                                                             "train_log.jsonl"))] == [0]
    assert os.path.exists(os.path.join(base, "p0", "model_best.ckpt"))
    assert not os.path.exists(os.path.join(base, "p1", "model_best.ckpt"))


# (e) ------------------------------------------------------------------------

def test_elastic_restart_continues_the_uninterrupted_curve(meta, tmp_path):
    """Rank 1 exits with 3 after epoch 1; rank 0 fails in the next
    collective. The gang restarted from rank 0's model_latest.ckpt with
    resume_all continues epoch for epoch as an uninterrupted 4-epoch gang
    (rel 1e-6)."""
    results, full = str(tmp_path / "elastic"), str(tmp_path / "full")
    gang_a, gang_c = _launch(meta, results, "elastic"), _launch(meta, full, "full4")
    outs = _wait(gang_a, rcs=[None, 3])
    assert gang_a[0].returncode != 0, outs[0][-3000:]
    logs_a = _log(os.path.join(results, "p0", "train_log.jsonl"))
    assert [line["epoch"] for line in logs_a] == [0, 1]
    resumed_from = torch.load(os.path.join(results, "p0", "model_latest.ckpt"))["epoch"]
    assert resumed_from in (0, 1)
    _wait(_launch(meta, results, "resume"))
    _wait(gang_c)
    logs_b = _log(os.path.join(results, "p0", "train_log.jsonl"))
    assert [line["epoch"] for line in logs_b[2:]] == list(range(resumed_from + 1, 4))
    by_epoch = {line["epoch"]: line for line in _log(os.path.join(full, "p0",
                                                                  "train_log.jsonl"))}
    assert sorted(by_epoch) == [0, 1, 2, 3]
    for line in logs_b[2:]:
        want = by_epoch[line["epoch"]]
        assert line["steps"] == want["steps"]
        assert line["loss_overall"] == pytest.approx(want["loss_overall"], rel=1e-6)
    for r in range(2):
        ends = [torch.load(os.path.join(d, f"p{r}", "final.pt")) for d in (results, full)]
        for k, v in ends[0].items():
            torch.testing.assert_close(v, ends[1][k], rtol=1e-5, atol=1e-6)


# (g) ------------------------------------------------------------------------

@pytest.mark.parametrize("field,value,error", [
    ("tp", 2, NotImplementedError), ("pp", 2, NotImplementedError),
    ("ep", 2, NotImplementedError), ("dp", 3, ValueError),
])
def test_what_is_still_refused(meta, tmp_path, field, value, error):
    from univtg_tpu_torch.train.driver_vlp import train_vlp

    cfg = dataclasses.replace(worker.build_cfg(meta, str(tmp_path / "x")), **{field: value})
    with pytest.raises(error, match="ROADMAP" if error is NotImplementedError else "world"):
        train_vlp(cfg, device="cpu")


def test_backend_rule_and_scan_under_gloo_on_a_card(tmp_path):
    assert dist.choose_backend("cpu", 2, 0)[0] == "gloo"
    assert dist.choose_backend("cuda", 1, 1)[0] == "nccl"
    assert dist.choose_backend("cuda", 4, 4)[0] == "nccl"
    backend, why = dist.choose_backend("cuda", 2, 1)
    assert backend == "gloo" and "NCCL refuses two ranks on one GPU" in why
    with pytest.raises(RuntimeError, match="needs a card"):
        dist.choose_backend("cuda", 1, 0)
    gang = dist.init_gang("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    try:
        assert (gang.backend, gang.device, dist.rank(), dist.world()) == (
            "gloo", torch.device("cpu"), 0, 1)
        with pytest.raises(NotImplementedError, match="cannot capture"):
            dist.check_capturable(torch.device("cuda"))
        dist.check_capturable(torch.device("cpu"))
        with pytest.raises(RuntimeError, match="joined a gang already"):
            dist.init_gang("file://" + str(tmp_path / "store2"), 1, 0, device="cpu")
    finally:
        dist.shutdown()
    assert dist.active() is None and not torch.distributed.is_initialized()


@pytest.mark.cuda
def test_cuda_scan_step_under_gloo_on_a_card_raises(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: gloo on a card (run tests/test_torch_dist.py "
                    "-m cuda on an H100)")
    from univtg_tpu_torch.models import ModelConfig, UniVTG
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_scan_train_step

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")  # as if two ranks shared the card
    gang = dist.init_gang("file://" + str(tmp_path / "store"), 1, 0, device="cuda")
    try:
        assert gang.backend == "gloo"
        model = UniVTG(ModelConfig(vid_dim=8, txt_dim=8, hidden_dim=32, num_layers=1,
                                   num_heads=4, ffn_dim=48, max_v_l=8, max_q_l=4),
                       device=gang.device)
        state = TrainState(model, make_optimizer(model.parameters(), lambda c: 1e-4))
        with pytest.raises(NotImplementedError, match="cannot capture"):
            make_scan_train_step(LossWeights())(state, {"src_vid": torch.zeros(2, 1)}, {}, 0)
    finally:
        dist.shutdown()
