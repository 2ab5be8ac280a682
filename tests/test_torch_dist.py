"""Training across processes on the CPU: gangs of two gloo ranks
(tests/torch_dist_worker.py, one subprocess each, a ``file://`` store in
tmp_path, a deadline per gang, tests/torch_gang.py) against one process and the JAX package.

(a) the ranks' summed gradients of the global-batch step equal the one-
process gradients on the whole batch (plain, gated, a rank without
saliency, a rank without a positive span, Moment-DETR); (b) a 2-rank
``train_vlp`` gang against the JAX package's one-process step on the same
assembled global batches from the same weights: losses and grad norms at
rtol 1e-4, parameters at 2e-5, the ranks bit-equal; (c) the Loader's shards,
its bucket plan (``plan_shards``) and collate's ``pad_v_to`` against JAX's;
(d) ``sharded_eval`` against the full evaluation; (e) the elastic restart
after ``inject_fault_epoch``; (f) the broadcast early stop; (g) what is
still refused, and the backend rule; (h) ``train_hl`` in a gang of two
against the JAX package's HL step and one process of the port on the
batches the gang assembles, and ``train_qfvs`` refusing the gang.
"""
import dataclasses
import json
import os
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
import torch_gang  # noqa: E402

torch.set_num_threads(1)
GANG_TIMEOUT = 180  # the whole gang's deadline, from its launch


@pytest.fixture(scope="module")
def meta(tmp_path_factory):
    def make(root):
        a = create_synthetic_mr_corpus(os.path.join(root, "a"), n_train=20, n_val=6, seed=31)
        b = create_synthetic_mr_corpus(os.path.join(root, "b"), n_train=12, n_val=4, seed=32)
        return {"corpora": [a, b], "bsz": 8, "root": root}

    return torch_gang.once(tmp_path_factory, "torch_dist", "corpora", make)


def _launch(meta, base, mode, world=2, **extra):
    """Start a gang of ``world`` ranks in ``base``, their process groups'
    timeout in the meta file (torch_gang.PG_TIMEOUT_S); returns the
    torch_gang.Gang."""
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, f"meta_{mode}.json")
    with open(path, "w") as f:
        json.dump({**meta, **extra, "pg_timeout": torch_gang.PG_TIMEOUT_S}, f)
    store = os.path.join(base, f"store_{mode}")
    if os.path.exists(store):  # a FileStore left by a gang that failed
        os.remove(store)
    store = "file://" + store
    return torch_gang.launch(
        [[sys.executable, os.path.join(HERE, "torch_dist_worker.py"), str(r), str(world), store,
          mode, path, base] for r in range(world)],
        [os.path.join(base, f"rank{r}_{mode}.log") for r in range(world)])


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# (a) ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gang_grads(meta, tmp_path_factory):
    def make(base):
        torch_gang.wait(_launch(meta, base, "grads"), GANG_TIMEOUT)
        return base

    base = torch_gang.once(tmp_path_factory, "torch_dist", "grads", make)
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
        torch_gang.wait(procs, GANG_TIMEOUT)
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
        torch_gang.wait(_launch(meta, base, "evalstop"), GANG_TIMEOUT)
        return base

    return torch_gang.once(tmp_path_factory, "torch_dist", "evalstop", make)


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
    outs = torch_gang.wait(gang_a, GANG_TIMEOUT, rcs=[None, 3])
    assert gang_a.procs[0].returncode != 0, outs[0][-3000:]
    logs_a = _log(os.path.join(results, "p0", "train_log.jsonl"))
    assert [line["epoch"] for line in logs_a] == [0, 1]
    resumed_from = torch.load(os.path.join(results, "p0", "model_latest.ckpt"))["epoch"]
    assert resumed_from in (0, 1)
    torch_gang.wait(_launch(meta, results, "resume"), GANG_TIMEOUT)
    torch_gang.wait(gang_c, GANG_TIMEOUT)
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

@pytest.mark.parametrize("field,value,error,match", [
    ("tp", 2, ValueError, r"dp\*pp\*ep\*tp = 1\*1\*1\*2 = 2 devices but the gang has 1"),
    ("pp", 2, ValueError, r"cfg.pp=2 requires cfg.model.pipeline_stages == pp \(got 0\)"),
    ("ep", 2, ValueError, "ep=2 needs a MoE model"), ("dp", 3, ValueError, "world"),
])
def test_what_is_still_refused(meta, tmp_path, field, value, error, match):
    """pp without a matching model.pipeline_stages (JAX's driver check), a
    mesh of more ranks than the gang has (tp=2 in one process) and ep over a
    dense model are refused, as JAX's make_mesh and driver refuse them."""
    from univtg_tpu_torch.train.driver_vlp import train_vlp

    cfg = dataclasses.replace(worker.build_cfg(meta, str(tmp_path / "x")), **{field: value})
    with pytest.raises(error, match=match):
        train_vlp(cfg, device="cpu")


def test_a_lost_rank_ends_its_gang_in_seconds(tmp_path):
    """The harness's two bounds (tests/torch_gang.py): a rank that exits
    with a code the harness does not expect ends its gang at once, and a
    rank whose peer never joins fails its rendezvous after the timeout its
    process group was given (3 s here), not after gloo's 30 minutes."""
    join = ("import sys, torch_gang, torch.distributed as td\n"
            "torch_gang.join_with_timeout(3)\n"
            "td.init_process_group('gloo', init_method=sys.argv[1], world_size=2, rank=0)\n"
            "td.barrier()\n")
    env = {"PYTHONPATH": os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")])}
    store = "file://" + str(tmp_path / "store")
    gang = torch_gang.launch([[sys.executable, "-c", join, store],
                              [sys.executable, "-c", "import sys; sys.exit(3)"]],
                             [str(tmp_path / "r0.log"), str(tmp_path / "r1.log")], env=env)
    with pytest.raises(AssertionError, match="rank 1 exited 3"):
        torch_gang.wait(gang, GANG_TIMEOUT)
    assert all(p.returncode is not None for p in gang.procs)  # none left running
    alone = torch_gang.launch(
        [[sys.executable, "-c", join, "file://" + str(tmp_path / "store2")]],
        [str(tmp_path / "alone.log")], env=env)
    out = torch_gang.wait(alone, GANG_TIMEOUT, rcs=[None])[0]
    assert alone.procs[0].returncode != 0, out
    assert "imeout" in out or "timed out" in out, out[-2000:]


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


# (h) ------------------------------------------------------------------------

HL_LOSSES = ("labels", "saliency")


def _hl_jax_model(hl):
    """The JAX model of build_hl_cfg's config and its init from PRNGKey(0)."""
    import jax

    from univtg_tpu.models import ModelConfig as JModelConfig
    from univtg_tpu.models import UniVTG as JUniVTG

    cfg = worker.build_hl_cfg({"hl": hl}, "unused").model
    jmodel = JUniVTG(_jax_twin(cfg, JModelConfig))
    z = np.zeros
    params = jmodel.init(jax.random.PRNGKey(0), z((2, 8, hl["q_dim"]), np.float32),
                         np.ones((2, 8), np.float32),
                         z((2, hl["max_clips"], hl["v_dim"] + 2), np.float32),
                         np.ones((2, hl["max_clips"]), np.float32), train=False)["params"]
    return jmodel, params, cfg


@pytest.fixture(scope="module")
def hl_gang(meta, tmp_path_factory):
    """The two ranks' train_hl from the JAX init; returns the directory,
    the corpus and each rank's hl.json."""
    def make(base):
        import jax

        from univtg_tpu.interop.torch_ckpt import params_from_torch_state_dict  # noqa: F401
        from univtg_tpu_torch.data.synthetic import create_synthetic_hl_corpus
        from univtg_tpu_torch.interop import state_dict_from_jax_params

        hl = create_synthetic_hl_corpus(os.path.join(base, "hl"), n_train=8, n_val=3,
                                        v_dim=24, q_dim=16, max_clips=20, seed=5)
        _, params, cfg = _hl_jax_model(hl)
        init = os.path.join(base, "hl_init.pt")
        torch.save(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                              cfg), init)
        torch_gang.wait(_launch({**meta, "hl": hl}, base, "hl", init=init), GANG_TIMEOUT)
        return {"base": base, "hl": hl, "init": init}

    made = torch_gang.once(tmp_path_factory, "torch_dist", "hl", make)
    made["ranks"] = []
    for r in range(2):
        with open(os.path.join(made["base"], f"p{r}", "hl.json")) as f:
            made["ranks"].append(json.load(f))
    return made


def _hl_global_batches(cfg, hl_cfg_data):
    """Each epoch's global batches as the gang assembles them: the two
    ranks' shards (Loader shard 0 and 1 of 2), rank order, concatenated."""
    from univtg_tpu_torch.data.hl import HLDataset, collate_hl

    ds = HLDataset(hl_cfg_data)
    ds.set_state("train")
    loaders = [Loader(ds, cfg.bsz, lambda items, pad_batch_to: collate_hl(
        items, cfg.data.max_q_l, cfg.data.max_v_l, pad_batch_to), shuffle=True,
        seed=cfg.seed, shard_index=r, num_shards=2) for r in range(2)]
    epochs = []
    for epoch in range(cfg.n_epoch):
        for ld in loaders:
            ld.set_epoch(epoch)
        epochs.append([tuple({k: np.concatenate([b0[part][k], b1[part][k]])
                              for k in b0[part]} for part in ("model_inputs", "targets"))
                       for b0, b1 in zip(*loaders)])
    return epochs, len(loaders[0])


def _knife_edge(sal):
    """Whether a batch's saliency sums to zero only by rounding: it holds
    saliency, but its exact (f64) sum is below 1e-6 of its absolute sum.
    TVSum's scores are centered per video, so every batch's sum is ~0 and
    the f32 sum that decides ``has_signal`` (upstream's ``saliency.sum() ==
    0``) lands on either side of zero with the summation order."""
    sal = np.asarray(sal, np.float64)
    return np.abs(sal).sum() > 0 and abs(sal.sum()) <= 1e-6 * np.abs(sal).sum()


def test_hl_gang_follows_the_jax_global_batch_step(hl_gang):
    """2 ranks x bsz 2, 2 epochs, dropouts 0, from the JAX init, against
    JAX's HL step (labels + saliency) on the assembled global batch: every
    step's losses and grad norm at rtol 1e-4 and the parameters after it at
    2e-5 (the k-slice of each in_proj_bias at 2 lr per step, as
    tests/test_torch_train.py), the ranks' steps and parameters bit-equal.
    A batch at the knife-edge of ``has_signal`` (ROADMAP.md queue 3: XLA's
    f32 sum of the centered scores reads 0 where torch's does not) ends the
    comparison there: it is checked to be one (JAX's saliency terms 0, the
    port's not, loss_f equal), and the trajectories part from it."""
    import jax

    from univtg_tpu.models.losses import LossWeights as JLossWeights
    from univtg_tpu.train import schedule as jschedule
    from univtg_tpu.train import steps as jsteps
    from univtg_tpu_torch.interop import state_dict_from_jax_params

    cfg = worker.build_hl_cfg({"hl": hl_gang["hl"]}, "unused")
    jmodel, params, tcfg = _hl_jax_model(hl_gang["hl"])
    epochs, per_epoch = _hl_global_batches(cfg, cfg.data)
    tx = jsteps.make_optimizer(jschedule.build_schedule(
        cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma, per_epoch), cfg.wd, cfg.grad_clip)
    jstate = jsteps.TrainState(params=params, opt_state=tx.init(params), step=np.int32(0))
    jstep = jsteps.make_train_step(jmodel, tx, _jax_twin(cfg.weights, JLossWeights),
                                   HL_LOSSES, donate=False)
    r0, r1 = hl_gang["ranks"]
    assert r0["steps"] == r1["steps"] and len(r0["steps"]) == 4
    snaps = [torch.load(os.path.join(hl_gang["base"], f"p{r}", "steps.pt")) for r in range(2)]
    D = tcfg.hidden_dim
    batches = [b for e in epochs for b in e]
    compared = 0
    for i, ((mi, tg), got) in enumerate(zip(batches, r0["steps"], strict=True)):
        jstate, m = jstep(jstate, mi, tg, jax.random.PRNGKey(1))
        want = {k: float(v) for k, v in m.items()}
        assert set(got) == set(want)
        if want["loss_s_inter"] == 0.0 and _knife_edge(tg["saliency_scores"]):
            assert got["loss_s_inter"] != 0.0 and got["loss_s_intra"] != 0.0
            np.testing.assert_allclose(got["loss_f"], want["loss_f"], rtol=1e-4)
            break
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k} at step {i}")
        jsd = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params),
                                         tcfg)
        for k, w in jsd.items():
            assert torch.equal(snaps[0][i][k], snaps[1][i][k]), k
            g = snaps[0][i][k]
            if k.endswith("self_attn.in_proj_bias"):
                np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                           atol=2 * cfg.lr * (i + 1), err_msg=k)
                g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                       err_msg=f"{k} after step {i}")
        compared += 1
    assert compared >= 3
    finals = [torch.load(os.path.join(hl_gang["base"], f"p{r}", "final.pt")) for r in range(2)]
    for k, v in finals[0].items():
        assert torch.equal(v, finals[1][k]) and torch.equal(v, snaps[0][-1][k]), k


def test_hl_gang_scores_equal_one_process(hl_gang):
    """The port in one process on the assembled batches, evaluated after each
    epoch as rank 0 does: the same per-domain best mAP as the gang's (both
    ranks return rank 0's), losses at rtol 1e-4, parameters at 2e-5; only
    rank 0 wrote the scores and the checkpoint."""
    from univtg_tpu_torch.data.hl import HLDataset
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.train import driver_hl
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

    cfg = worker.build_hl_cfg({"hl": hl_gang["hl"]}, "unused")
    epochs, per_epoch = _hl_global_batches(cfg, cfg.data)
    model = UniVTG(cfg.model, device="cpu")
    model.load_state_dict(torch.load(hl_gang["init"]))
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(
        cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma, per_epoch), cfg.wd, cfg.grad_clip))
    step = make_train_step(cfg.weights, HL_LOSSES)
    dataset = HLDataset(cfg.data)
    got, best = [], 0.0
    for batches in epochs:
        for mi, tg in batches:
            state, m = step(state, {k: torch.from_numpy(v) for k, v in mi.items()},
                            {k: torch.from_numpy(v) for k, v in tg.items()}, cfg.seed + 1)
            got.append({k: float(v) for k, v in m.items()})
        best = max(best, driver_hl.eval_domain(cfg, model, dataset))
    r0, r1 = hl_gang["ranks"]
    assert r0["scores"] == r1["scores"] == {"SYN": best, "AVG": best}
    for g, w in zip(got, r0["steps"], strict=True):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7, err_msg=k)
    final = torch.load(os.path.join(hl_gang["base"], "p0", "final.pt"))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=2e-5, err_msg=k)
    base = hl_gang["base"]
    assert os.path.exists(os.path.join(base, "p0", "best_tvsum_metrics.json"))
    assert os.path.exists(os.path.join(base, "p0", "model_SYN_best.ckpt"))
    assert not os.path.exists(os.path.join(base, "p1", "best_tvsum_metrics.json"))
    assert not os.path.exists(os.path.join(base, "p1", "model_SYN_best.ckpt"))


def test_qfvs_refuses_a_gang_and_says_why(hl_gang):
    """The JAX QFVS driver shards nothing, so the port's runs in one process
    and refuses a gang on every rank."""
    for rank in hl_gang["ranks"]:
        assert rank["qfvs"] and "runs in one process, as the JAX package's does" in rank["qfvs"]
