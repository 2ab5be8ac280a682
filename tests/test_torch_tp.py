"""Tensor parallelism, seq_shard and the ring across processes on the CPU:
gangs of gloo ranks (tests/torch_mesh_worker.py, one subprocess each, each
gang launched once per session by tests/torch_mesh_jax.py) against the JAX
package on the same mesh of its virtual CPU devices (``make_mesh``,
``replicate_params``, ``shard_batch``, ``jax.set_mesh``), from JAX's init.

Tolerances are PERF.md's: per step loss and global grad norm at rtol 1e-4,
the parameters after 3 AdamW steps at 2e-5 (the k-slice of each
in_proj_bias at 2 lr per step); the ring's forward at 1e-5 and its dropout
bit for bit against the one-process ring.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_jax as mj  # noqa: E402

from univtg_tpu_torch.models import ModelConfig, UniVTG  # noqa: E402
from univtg_tpu_torch.ops.ring_attention import ring_attention  # noqa: E402
from univtg_tpu_torch.parallel.ring import RingGroup  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    return mj.gang(tmp_path_factory, "tp2")


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    return mj.gang(tmp_path_factory, "tp4")


@pytest.fixture(scope="module")
def dense_jax(gang2):
    """JAX's init of the dense model, as the gangs got it."""
    return mj.jax_init(mj.DENSE, mj.batch(0)[0])


def _got(gang, name):
    return torch.load(os.path.join(gang["base"], f"{name}.pt"))


@pytest.mark.parametrize("name,mesh,impl", [
    ("tp2_xla", (1, 2, 1), "xla"),
    ("tp2_pallas", (1, 2, 1), "pallas"),
])
def test_tp2_steps_follow_jax_on_the_same_mesh(gang2, dense_jax, name, mesh, impl):
    """tp=2: each rank holds 2 of the 4 heads and 48 of the 96 FFN columns;
    3 AdamW steps from JAX's init against JAX's step on make_mesh(dp=1,
    tp=2) ("pallas": the kernels' CPU twins, JAX on "xla"); the ranks
    agree; the attention ran the impl asked for, 2 calls a step."""
    metrics, params = mj.jax_run(mj.DENSE, mesh, dense_jax, mj.batches())
    got = _got(gang2, name)
    mj.assert_trajectory(got, metrics, params, mj.DENSE)
    mj.ranks_agree(gang2["base"], name, 2)
    assert got["dispatches"][impl] == 2 * mj.STEPS


def test_dp2_tp2_steps_follow_jax_on_the_same_mesh(gang4, dense_jax):
    """dp=2 x tp=2: each dp row reads half of the global batch; against
    JAX's step on make_mesh(dp=2, tp=2)."""
    metrics, params = mj.jax_run(mj.DENSE, (2, 2, 1), dense_jax, mj.batches())
    mj.assert_trajectory(_got(gang4, "dp2tp2_xla"), metrics, params, mj.DENSE)
    mj.ranks_agree(gang4["base"], "dp2tp2_xla", 4)


def test_seq_shard_with_a_tiling_length_follows_jax(gang2, dense_jax):
    """seq_shard at tp=2 over 28 + 4 = 32 tokens (16 a rank between the
    matrices): JAX's seq_shard=True step on the same mesh, no warning."""
    cfg = {**mj.DENSE, "seq_shard": True}
    metrics, params = mj.jax_run(cfg, (1, 2, 1), dense_jax, mj.batches())
    got = _got(gang2, "seq_tile")
    mj.assert_trajectory(got, metrics, params, cfg)
    assert not [w for w in got["warnings"] if "seq_constraint" in w]


def test_seq_shard_with_a_ragged_length_warns_and_runs_unsharded(gang2):
    """27 + 4 = 31 tokens do not tile over tp=2: JAX's warning, once, and
    the steps of the same gang without seq_shard, bit for bit."""
    got, plain = _got(gang2, "seq_ragged"), _got(gang2, "noseq_ragged")
    warned = [w for w in got["warnings"] if "seq_constraint skipped" in w]
    assert warned == ["seq_constraint skipped: token axis (31) does not tile over tp=2; "
                      "sequence parallelism is inactive for this shape. Pad L to a "
                      "multiple of 2 to enable it."]
    assert got["metrics"] == plain["metrics"]
    for k, v in plain["params"].items():
        assert torch.equal(got["params"][k], v), k


def test_ring_under_seq_shard_follows_jax(gang2, dense_jax):
    """"ring" at tp=2 under seq_shard (tests/test_ring_attention.py's
    test_ring_train_step_with_seq_shard): the tp ranks are the ring, each
    projecting its own 16 tokens with the whole projections; against JAX's
    ring on the same mesh."""
    cfg = {**mj.DENSE, "attention_impl": "ring", "seq_shard": True}
    metrics, params = mj.jax_run(cfg, (1, 2, 1), dense_jax, mj.batches())
    got = _got(gang2, "ring_seq")
    mj.assert_trajectory(got, metrics, params, cfg)
    assert got["dispatches"]["ring"] == 2 * mj.STEPS and got["dispatches"]["xla"] == 0


def test_ring_pallas_over_tp_follows_jax_ring(gang2, dense_jax):
    """"ring_pallas" at tp=2 without seq_shard (the kernels' CPU twin over
    the process ring, its backward through the plain ring): JAX's "ring" on
    the same mesh."""
    cfg = {**mj.DENSE, "attention_impl": "ring"}
    metrics, params = mj.jax_run(cfg, (1, 2, 1), dense_jax, mj.batches())
    got = _got(gang2, "ring_pallas_tp2")
    mj.assert_trajectory(got, metrics, params, {**mj.DENSE, "attention_impl": "ring_pallas"})
    assert got["dispatches"]["ring_pallas"] == 2 * mj.STEPS


@pytest.fixture(scope="module")
def jax_ring():
    """JAX's collective ring (ops/ring_attention.py) on make_mesh(dp=1,
    tp=P), and its gradients of sum(out * w)."""
    from univtg_tpu.ops.ring_attention import ring_attention as jring
    from univtg_tpu.parallel import make_mesh

    def run(P, t):
        mesh = make_mesh(dp=1, tp=P, devices=jax.devices()[:P])
        q, k, v, m, w = (t[n].numpy() for n in "qkvmw")

        def loss(q, k, v):
            out = jring(q, k, v, m, num_heads=mj.RING_SHAPE["H"], mesh=mesh, axis="tp")
            return (out * w).sum(), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            q, k, v)  # one compile, not an eager dispatch per op
        return [np.asarray(x) for x in (out, *grads)]

    return run


@pytest.mark.parametrize("P,gang", [(2, "gang2"), (4, "gang4")])
def test_ring_across_processes_matches_jax_and_one_process(request, jax_ring, P, gang):
    """Each of P processes holds its 1/P of q, k, v and the mask; "ring"
    and "ring_pallas" (the twin, backward through the plain ring): the
    gathered output and gradients against JAX's collective ring at 1e-5
    (one fully masked half row); with dropout, the gathered output equal bit
    for bit to the one-process ring, RingGroup(P) on the CPU."""
    g = request.getfixturevalue(gang)
    got = _got(g, f"ring_p{P}")
    t = torch.load(g["inputs"]["ring"])
    want = jax_ring(P, t)
    for impl in ("ring", "ring_pallas"):
        for name, a, b in zip(("out", "dq", "dk", "dv"), got[impl], want):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, err_msg=f"{impl} {name}")
    one = ring_attention(t["q"], t["k"], t["v"], t["m"], num_heads=mj.RING_SHAPE["H"],
                         ring=RingGroup(P, devices=["cpu"] * P), dropout_rate=mj.RING_RATE,
                         dropout_seed=torch.tensor([mj.RING_SEED], dtype=torch.int32))
    assert torch.equal(got["dropout"], one)


def test_jax_checkpoint_resumes_into_tp2_on_jax_curve(gang2):
    """resume_all from the JAX package's checkpoint
    (tests/torch_golden/jax_resume) into a tp=2 gang: the params and both
    Adam moments cut into the ranks' shards; the next 2 steps' losses and
    grad norms on JAX's curve (expected.json) at rtol 1e-4."""
    with open(os.path.join(mj.GOLDEN, "jax_resume", "expected.json")) as f:
        expected = json.load(f)["metrics"]
    got = _got(gang2, "resume_jax_tp2")
    for i, (g, w) in enumerate(zip(got["metrics"], expected, strict=True)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"{k} at step {i}")


def test_hl_tp2_follows_the_jax_step(gang2):
    """train_hl in a tp=2 gang (one dp row: both ranks read every item)
    against JAX's HL step (labels + saliency) on make_mesh(dp=1, tp=2) over
    the same batches: every step's losses and grad norm at rtol 1e-4 until
    a batch at the knife-edge of ``has_signal`` (tests/test_torch_dist.py);
    both ranks return rank 0's scores; rank 0's evaluation model holds the
    canonical parameters."""
    import dataclasses

    import torch_dist_worker as dw

    from univtg_tpu.models.losses import LossWeights as JLossWeights
    from univtg_tpu.parallel import make_mesh, replicate_params, shard_batch
    from univtg_tpu.train import schedule as jschedule
    from univtg_tpu.train import steps as jsteps
    from univtg_tpu_torch.data.hl import HLDataset, collate_hl
    from univtg_tpu_torch.data.loader import Loader

    hl = gang2["inputs"]["hl"]
    cfg = dw.build_hl_cfg({"hl": hl}, "unused")
    jmodel, params, _ = mj.hl_jax_model(hl)
    ds = HLDataset(cfg.data)
    ds.set_state("train")
    loader = Loader(ds, cfg.bsz, lambda items, pad_batch_to: collate_hl(
        items, cfg.data.max_q_l, cfg.data.max_v_l, pad_batch_to), shuffle=True,
        seed=cfg.seed, shard_index=0, num_shards=1)
    batches = []
    for epoch in range(cfg.n_epoch):
        loader.set_epoch(epoch)
        batches += [(b["model_inputs"], b["targets"]) for b in loader]
    tx = jsteps.make_optimizer(jschedule.build_schedule(
        cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma, len(loader)), cfg.wd, cfg.grad_clip)
    mesh = make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    jstate = jsteps.TrainState(params=replicate_params(mesh, params),
                               opt_state=tx.init(params), step=np.int32(0))
    weights = JLossWeights(**{f.name: getattr(cfg.weights, f.name)
                              for f in dataclasses.fields(JLossWeights)})
    jstep = jsteps.make_train_step(jmodel, tx, weights, ("labels", "saliency"), donate=False)
    ranks = []
    for r in range(2):
        with open(os.path.join(gang2["base"], f"p{r}", "hl.json")) as f:
            ranks.append(json.load(f))
    assert ranks[0]["steps"] == ranks[1]["steps"] and ranks[0]["scores"] == ranks[1]["scores"]
    compared = 0
    with jax.set_mesh(mesh):
        for i, ((mi, tg), got) in enumerate(zip(batches, ranks[0]["steps"], strict=True)):
            jstate, m = jstep(jstate, shard_batch(mesh, mi), shard_batch(mesh, tg),
                              jax.random.PRNGKey(1))
            want = {k: float(v) for k, v in m.items()}
            sal = np.asarray(tg["saliency_scores"], np.float64)
            if want["loss_s_inter"] == 0.0 and np.abs(sal).sum() > 0 \
                    and abs(sal.sum()) <= 1e-6 * np.abs(sal).sum():
                break  # the knife-edge of has_signal: the trajectories part here
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                           err_msg=f"{k} at step {i}")
            compared += 1
    assert compared >= 2
    final = torch.load(os.path.join(gang2["base"], "p0", "final.pt"))
    assert final["transformer.encoder.layers.0.linear1.weight"].shape[0] == cfg.model.ffn_dim


def test_tp_needs_heads_and_ffn_that_tile():
    """The port splits whole heads: num_heads % tp and ffn_dim % tp raise
    ValueError (JAX needs only that 3 D tiles; ROADMAP.md queue 3)."""
    from univtg_tpu_torch.parallel import mesh as pm

    cfg = ModelConfig(**mj.DENSE)
    with pytest.raises(ValueError, match="num_heads=4 must be a multiple of tp=3"):
        pm.check_model(cfg, tp=3)
    with pytest.raises(ValueError, match="ffn_dim=96 must be a multiple of tp=5"):
        pm.check_model(ModelConfig(**{**mj.DENSE, "num_heads": 5, "hidden_dim": 80}), tp=5)
    with pytest.raises(ValueError, match="needs a MoE model"):
        pm.check_model(cfg, ep=2)
    with pytest.raises(ValueError, match="must tile over ep=3"):
        pm.check_model(ModelConfig(**mj.MOE), ep=3)
    with pytest.raises(ValueError, match="moe_top_k=5 must be <= moe_experts=4"):
        pm.check_model(ModelConfig(**{**mj.MOE, "moe_top_k": 5}), ep=2)
    pm.check_model(cfg, tp=2)
    assert UniVTG(cfg, device="cpu") is not None


def _jax_twin(obj, jcls):
    import dataclasses

    return jcls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(jcls)
                   if hasattr(obj, f.name)})


@pytest.mark.parametrize("name,gang,dp", [("mr_tp2", "gang2", 1), ("mr_dp2tp2", "gang4", 2)])
def test_train_mr_gang_follows_jax_and_writes_canonical_checkpoints(request, name, gang,
                                                                   dp):
    """train_mr at tp=2 (and dp=2 x tp=2 with sharded_eval), 2 epochs from
    JAX's init given as a weights-only resume: every step against JAX's
    step on the dp rows' shards concatenated, on make_mesh(dp, tp=2), at
    rtol 1e-4, the ranks equal; rank 0 alone wrote the checkpoints, which
    are canonical (whole in_proj, both Adam moments whole) and whose
    one-process evaluation equals the gang's last one."""
    import torch_mesh_worker as mw

    from univtg_tpu.data.collate import collate_mr as jcollate
    from univtg_tpu.data.loader import Loader as JLoader
    from univtg_tpu.data.mr import MRDataConfig as JMRDataConfig
    from univtg_tpu.data.mr import MRDataset as JMRDataset
    from univtg_tpu.models.losses import LossWeights as JLossWeights
    from univtg_tpu.parallel import make_mesh, replicate_params, shard_batch
    from univtg_tpu.train import schedule as jschedule
    from univtg_tpu.train import steps as jsteps
    from univtg_tpu_torch.data.mr import MRDataset
    from univtg_tpu_torch.train import driver_mr
    from univtg_tpu_torch.train.infer_mr import evaluate_submission
    from univtg_tpu_torch.train.steps import make_eval_step

    g = request.getfixturevalue(gang)
    base = os.path.join(g["base"], name)
    cfg = mw.mr_cfg({"name": name, "mesh": [dp, 2, 1], "cfg": mj.DENSE,
                     "corpus": g["inputs"]["mr"], "sharded_eval": dp > 1}, "unused")
    jdata = _jax_twin(cfg.train_data, JMRDataConfig)
    ds = JMRDataset(jdata)
    loaders = [JLoader(ds, cfg.bsz, lambda items, pad_batch_to: jcollate(
        items, jdata.max_q_l, jdata.max_v_l, pad_batch_to), shuffle=True, seed=cfg.seed,
        num_threads=2, shard_index=d, num_shards=dp) for d in range(dp)]
    mesh = make_mesh(dp=dp, tp=2, devices=jax.devices()[:2 * dp])
    params = mj.jax_init(mj.DENSE, mj.batch(0)[0])
    tx = jsteps.make_optimizer(jschedule.build_schedule(
        cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma, len(loaders[0])), cfg.wd,
        cfg.grad_clip)
    jstate = jsteps.TrainState(params=replicate_params(mesh, params),
                               opt_state=tx.init(params), step=np.int32(0))
    jstep = jsteps.make_train_step(mj.JaxUniVTG(mj.JaxConfig(**mj.DENSE)), tx,
                                   _jax_twin(cfg.weights, JLossWeights), donate=False)
    want = []
    with jax.set_mesh(mesh):
        for epoch in range(cfg.n_epoch):
            for ld in loaders:
                ld.set_epoch(epoch)
            for rows in zip(*loaders):
                mi, tg = ({k: np.concatenate([b[part][k] for b in rows]) for k in rows[0][part]}
                          for part in ("model_inputs", "targets"))
                jstate, m = jstep(jstate, shard_batch(mesh, mi), shard_batch(mesh, tg),
                                  jax.random.PRNGKey(cfg.seed + 1))
                want.append({k: float(v) for k, v in m.items()})
    world = 2 * dp
    steps = []
    for r in range(world):
        with open(os.path.join(base, f"steps_r{r}.json")) as f:
            steps.append(json.load(f))
    assert all(s == steps[0] for s in steps) and len(steps[0]) == len(want) >= 4
    for i, (got, w) in enumerate(zip(steps[0], want)):
        for k in ("loss_overall", "grad_norm"):
            np.testing.assert_allclose(got[k], w[k], rtol=1e-4, err_msg=f"{k} at step {i}")
    assert not any(os.path.exists(os.path.join(base, f"p{r}", "model_latest.ckpt"))
                   for r in range(1, world))
    latest = os.path.join(base, "p0", "model_latest.ckpt")
    blob = torch.load(latest, weights_only=True)
    D = mj.DENSE["hidden_dim"]
    w = "transformer.encoder.layers.0.self_attn.in_proj_weight"
    assert blob["model"][w].shape == (3 * D, D)
    names = [n for n, p in UniVTG(ModelConfig(**mj.DENSE), device="meta").named_parameters()]
    assert blob["optimizer"]["state"][names.index(w)]["exp_avg"].shape == (3 * D, D)
    model = UniVTG(cfg.model, device="cpu")
    model.load_state_dict(blob["model"])
    eval_ds = MRDataset(cfg.eval_data)
    sub = driver_mr._run_eval_shard(cfg, model, eval_ds, make_eval_step(cfg.eval_mode))
    brief = evaluate_submission(sub, eval_ds.data)["brief"]
    with open(os.path.join(base, "p0", "eval_log.jsonl")) as f:
        last = [json.loads(line) for line in f][-1]
    assert last.pop("epoch") == cfg.n_epoch - 1 and last == brief


def test_moment_detr_on_a_tp_mesh_runs_replicated(gang2):
    """Moment-DETR at tp=2: JAX's rules split none of its leaves, so both
    ranks hold it whole (parallel/mesh.replicate_model) and the step reduces
    over dp alone: 2 steps equal one process's on the same batches, the
    ranks equal, the gathered parameters the one process's."""
    import torch_mesh_worker as mw

    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer

    case = {"cfg": mj.MD, "md": True}
    model, step = mw.md_model_and_step(case)
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(*mj.SCHED),
                                             mj.WD, mj.CLIP))
    want = []
    for mi, tg in torch.load(gang2["inputs"]["md_batches"]):
        state, m = step(state, mi, tg, 1)
        want.append({k: float(v) for k, v in m.items()})
    got = _got(gang2, "md_tp2")
    mj.ranks_agree(gang2["base"], "md_tp2", 2)
    assert len(got["metrics"]) == len(want) == 2
    for g, w in zip(got["metrics"], want):
        for k in ("loss_overall", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
