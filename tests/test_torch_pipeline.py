"""GPipe and interleaved GPipe across processes on the CPU
(univtg_tpu_torch/parallel/pipeline.py): gangs of gloo ranks
(tests/torch_mesh_worker.py, launched once per session by
tests/torch_mesh_jax.py) against the JAX package's pipelines on the same
``make_mesh(dp, tp, pp=)`` of its virtual CPU devices, from JAX's init:
the schedule, the forward against JAX's ``pipeline_layers`` and the
sequential stack, 3 AdamW steps of ``make_train_step`` against JAX's step
on the same mesh (pp = 2 at dp = 1 and 2, interleaved, remat, pp = 2 x tp
= 2, dp = 2 x pp = 2 x tp = 2), MoE at one microbatch, dropout against the
port's own one-process step, the drivers (``train_mr``, ``train_vlp``,
``resume_all`` from a JAX checkpoint), and the refusals and the fallback,
in JAX's words.

Tolerances are PERF.md's: per step loss, aux and grad norm at rtol 1e-4,
the parameters after 3 AdamW steps at 2e-5 (the k-slice of each
in_proj_bias at 2 lr per step); the forward at 1e-5.
"""
import dataclasses
import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_jax as mj  # noqa: E402

from univtg_tpu.parallel import pipeline as jpipe  # noqa: E402
from univtg_tpu_torch.models import ModelConfig, UniVTG  # noqa: E402
from univtg_tpu_torch.models.losses import LossWeights  # noqa: E402
from univtg_tpu_torch.ops import flash_attention as fa  # noqa: E402
from univtg_tpu_torch.parallel import mesh as pm  # noqa: E402
from univtg_tpu_torch.parallel import pipeline as pipe  # noqa: E402
from univtg_tpu_torch.train.schedule import build_schedule  # noqa: E402
from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    return mj.gang(tmp_path_factory, "pipe2")


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    return mj.gang(tmp_path_factory, "pipe4")


@pytest.fixture(scope="module")
def gang8(tmp_path_factory):
    return mj.gang(tmp_path_factory, "w8")


def _got(gang, name):
    return torch.load(os.path.join(gang["base"], f"{name}.pt"))


def pipeline_ran(gang, name, world, pp, v=1, layers=4):
    """Every rank ran the pipeline (ticks and hops), held one stage's
    layers alone, and no rank fell back to the layers in order."""
    got = _got(gang, name)
    assert not any("sequential scan instead" in w for w in got["warnings"])
    for r in range(world):
        with open(os.path.join(gang["base"], f"{name}_held_r{r}.json")) as f:
            held = json.load(f)
        assert held["pipe"]["ticks"] > 0 and held["pipe"]["hops"] > 0, (r, held["pipe"])
        idx = sorted({int(k.split(".")[3]) for k in held["keys"]
                      if k.startswith("transformer.encoder.layers.")})
        assert any(idx == pm.stage_layers(layers, pp, v, s) for s in range(pp)), (r, idx)


# ---- the schedule, no gang --------------------------------------------------

@pytest.mark.parametrize("pp", [2, 3, 4])
@pytest.mark.parametrize("v", [1, 2, 3])
def test_schedules_equal_jax(pp, v):
    """schedule_active over every (tick, stage) and pipeline_ticks equal
    JAX's for M in 1..9; interleave_permutation equals JAX's; every
    microbatch runs every chunk once, one tick after the chunk before it, on
    stage c % pp, and no stage runs two chunks a tick."""
    for M in range(1, 10):
        T = pipe.pipeline_ticks(M, pp, v)
        assert T == jpipe.pipeline_ticks(M, pp, v)
        ts, ss = np.arange(T + 2), np.arange(pp)
        fn = jax.jit(jax.vmap(jax.vmap(
            lambda t, s: jpipe.schedule_active(t, s, pp=pp, v=v, n_micro=M), (None, 0)),
            (0, None)))  # one compile, not an eager dispatch per op
        act, j, m = (np.asarray(a) for a in fn(jnp.asarray(ts), jnp.asarray(ss)))
        seen = {}
        for t in ts:
            for s in ss:
                got = pipe.schedule_active(int(t), int(s), pp=pp, v=v, n_micro=M)
                assert got == (bool(act[t, s]), int(j[t, s]), int(m[t, s])), (M, t, s)
                if got[0]:
                    c = s + pp * got[1]
                    assert (got[2], c) not in seen
                    seen[(got[2], c)] = t
        assert len(seen) == M * pp * v and max(seen.values()) == T - 1
        for (mb, c), t in seen.items():
            if c + 1 < pp * v:
                assert seen[(mb, c + 1)] == t + 1
    np.testing.assert_array_equal(pipe.interleave_permutation(2 * pp * v, pp, v),
                                  jpipe.interleave_permutation(2 * pp * v, pp, v))


def test_permute_pipeline_params_is_jax_permutation():
    """permute_pipeline_params on a JAX-layout tree (params and optax's
    mu/nu mirrors) equals JAX's, round-trips, leaves other leaves alone and
    refuses a stack that does not tile, in JAX's words."""
    rng = np.random.default_rng(0)
    tree = {"params": {"encoder": {"layers": {"layer": {"w": rng.standard_normal((8, 3))}}},
                       "head": rng.standard_normal((8, 3))},
            "opt": {"mu": {"encoder": {"layers": {"layer": {"w": rng.standard_normal((8, 3))}}}}}}
    for v in (1, 2, 4):
        got = pipe.permute_pipeline_params(tree, 8, 2, v)
        want = jpipe.permute_pipeline_params(tree, 8, 2, v)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
        back = pipe.permute_pipeline_params(got, 8, 2, v, inverse=True)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    torch_leaf = {"layers": {"layer": {"w": torch.arange(8.0)}}}
    assert pipe.permute_pipeline_params(torch_leaf, 8, 2, 2)["layers"]["layer"]["w"].tolist() \
        == jpipe.interleave_permutation(8, 2, 2).tolist()
    with pytest.raises(ValueError, match="must tile over pp=2 stages x interleave=3"):
        pipe.permute_pipeline_params(tree, 8, 2, 3)


def test_stage_layers_and_block_rows():
    """A stage holds chunks s + pp j of L / (pp v) layers (JAX's device-major
    shard, in canonical order); dp rank d runs JAX's block rows [m mb + d
    mb / dp, ...) of every microbatch."""
    perm = jpipe.interleave_permutation(8, 2, 2).reshape(2, -1)
    for s in range(2):
        assert pm.stage_layers(8, 2, 2, s) == sorted(perm[s].tolist())
    assert pm.stage_layers(4, 4, 1, 3) == [3]
    assert pipe.block_rows(4, 2, 0, 2) == [0, 1, 4, 5]
    assert pipe.block_rows(4, 2, 1, 2) == [2, 3, 6, 7]
    assert pipe.block_rows(4, 1, 0, 4) == [0, 1, 2, 3]


def test_jax_tree_to_a_pipeline_stage():
    """``shard_state_dict_from_jax`` at stage 1 of pp = 2, interleave 2 (one
    layer a chunk): the JAX scan-layout tree's layers 1 and 3 under their
    canonical names, every other entry whole; the grad norm weighs a
    stage's layer once and a replicated entry 1 / pp."""
    from univtg_tpu_torch.interop.jax_params import (
        shard_state_dict_from_jax,
        state_dict_from_jax_params,
    )

    cfg = mj.pipe_cfg(mj.PIPE, 2, 4, 2)
    params = mj.jax_init(mj.PIPE, mj.batch(0)[0])
    full = state_dict_from_jax_params(params, ModelConfig(**cfg))
    sd = shard_state_dict_from_jax(params, ModelConfig(**cfg),
                                   {"dp": 0, "pp": 1, "ep": 0, "tp": 0},
                                   {"dp": 1, "pp": 2, "ep": 1, "tp": 1})
    layers = {pm.layer_index(k) for k in sd} - {None}
    assert layers == {1, 3}
    assert set(sd) == {k for k in full if pm.layer_index(k) in (None, 1, 3)}
    assert all(torch.equal(sd[k], full[k]) for k in sd)
    ax = pm.Axis
    mesh = pm.Mesh(dp=ax(1, 0, None, "gloo"), ep=ax(1, 0, None, "gloo"),
                   tp=ax(1, 0, None, "gloo"), model=ax(1, 0, None, "gloo"), grid=((0, 1),),
                   pp=ax(2, 1, None, "gloo"), row=ax(2, 1, None, "gloo"))
    assert pm.replicas("transformer.encoder.layers.3.linear1.weight", mesh) == 1
    assert pm.replicas("input_vid_proj.0.LayerNorm.weight", mesh) == 2
    assert mesh.pp_ranks() == (0, 1) and mesh.norm_axis is mesh.row


# ---- the forward -------------------------------------------------------------

@pytest.mark.parametrize("name,gang,dp,pp,M,v", [
    ("fwd_pp2_m8", "gang2", 1, 2, 8, 1), ("fwd_pp2_v2", "gang2", 1, 2, 4, 2),
    ("fwd_dp2pp2_m4", "gang4", 2, 2, 4, 1), ("fwd_pp4_m4", "gang4", 1, 4, 4, 1)])
def test_gpipe_forward_follows_jax_pipeline_and_sequential(request, tmp_path_factory, name,
                                                          gang, dp, pp, M, v):
    """The pipelined eval forward of the gang, each dp row on its half of
    the batch, against JAX's pipeline_layers forward on make_mesh(dp,
    pp=pp) and JAX's sequential stack, at 1e-5."""
    g = request.getfixturevalue(gang)
    data = mj.batches(B=mj.PIPE_B)
    params = mj.jax_init(mj.PIPE, data[0][0])
    seq = mj.jax_ref(tmp_path_factory, "pipe_forward_seq",
                     lambda: mj.jax_forward(mj.PIPE, (1, 1), params, data[0][0]))
    want = mj.jax_forward(mj.pipe_cfg(mj.PIPE, pp, M, v), (dp, pp), params, data[0][0])
    got = _got(g, name)
    for k in want:
        np.testing.assert_allclose(want[k], seq[k], rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-5, err_msg=k)


# ---- GPipe training ---------------------------------------------------------

@pytest.mark.parametrize("name,gang,mesh,M,v,extra", [
    ("gp_pp2", "gang2", (1, 1, 1, 2), 4, 1, {}),
    ("gp_pp2_v2", "gang2", (1, 1, 1, 2), 4, 2, {}),
    ("gp_pp2_remat", "gang2", (1, 1, 1, 2), 4, 1, {"remat": True}),
    ("gp_dp2pp2", "gang4", (2, 1, 1, 2), 4, 1, {}),
    ("gp_pp2tp2", "gang4", (1, 2, 1, 2), 4, 1, {}),
    ("gp_dp2pp2tp2", "gang8", (2, 2, 1, 2), 4, 1, {}),
])
def test_gpipe_steps_follow_jax_on_the_same_mesh(request, name, gang, mesh, M, v, extra):
    """3 steps of make_train_step on a pipelined model (the forward
    contains the pipeline; its backward is the reverse schedule) against
    JAX's make_train_step on make_mesh(dp, tp, pp=2) with the same
    pipeline (which equals its sequential step): the sequential step's
    gradients, every rank the same metrics, each rank holding its stage's
    layers alone."""
    g = request.getfixturevalue(gang)
    cfg = mj.pipe_cfg(mj.PIPE, mesh[3], M, v, **extra)
    data = mj.batches(B=mj.PIPE_B)
    params = mj.jax_init(mj.PIPE, data[0][0])
    metrics, final = mj.jax_run(cfg, mesh, params, data)
    world = int(np.prod(mesh))
    mj.assert_trajectory(_got(g, name), metrics, final, cfg)
    mj.ranks_agree(g["base"], name, world)
    pipeline_ran(g, name, world, mesh[3], v)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_gpipe_with_dropout_equals_the_one_process_step(gang2, impl):
    """Dropouts on (attention 0.1, drop path 0.1, input 0.3): a pp = 2 GPipe
    step equals the port's one-process step from the same generator seed
    (each stage draws every layer's noise for the whole batch in layer
    order, and gives each microbatch its rows; the flash twins hash the
    microbatch's rows through row_off), 3 steps at the training limits;
    the attention ran the impl asked for on every microbatch."""
    name = f"gp_drop_{impl}"
    cfg = {**mj.PIPE, **mj.DROP, "attention_impl": impl}
    model = UniVTG(ModelConfig(**cfg), device="cpu")
    model.load_state_dict(torch.load(gang2["inputs"]["pipe_init"]))
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(*mj.SCHED),
                                             mj.WD, mj.CLIP))
    step = make_train_step(LossWeights())
    want = []
    for mi, tg in torch.load(gang2["inputs"]["pipe"]):
        state, m = step(state, mi, tg, 1)
        want.append({k: float(v) for k, v in m.items()})
    got = _got(gang2, name)
    mj.assert_trajectory(got, want, model.state_dict(), cfg)
    mj.ranks_agree(gang2["base"], name, 2)
    pipeline_ran(gang2, name, 2, 2)
    # rank 0 holds 2 of the 4 layers: 2 layers x 4 microbatches x 3 steps
    assert got["dispatches"][impl] == 2 * 4 * mj.STEPS


def test_moe_gpipe_at_one_microbatch_follows_the_sequential_jax_step(gang2):
    """MoE under GPipe at M = 1 and dp = 1 routes the same tokens as the
    sequential stack (tests/test_moe.py:325): 3 steps against JAX's
    sequential MoE step, the aux (the mean over layers, microbatches and dp
    shards) included."""
    data = mj.batches(B=8, Lv=16, Lt=6)
    params = mj.jax_init(mj.MOE, data[0][0])
    metrics, final = mj.jax_run(mj.MOE, (1, 1, 1), params, data)
    got = _got(gang2, "gp_moe_m1")
    assert "loss_moe_aux" in metrics[0]
    mj.assert_trajectory(got, metrics, final, mj.MOE)
    mj.ranks_agree(gang2["base"], "gp_moe_m1", 2)
    pipeline_ran(gang2, "gp_moe_m1", 2, 2, layers=2)


@pytest.mark.parametrize("rows,off", [(0, 0), (2, 0), (3, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_twin_with_a_row_offset_is_the_whole_twin_sliced(rows, off, rate):
    """A microbatch of batch rows [r, r + mb), over heads [off, off + Hl) of
    H, hashing its global rows through head_span (H, r H + off), gives the
    twin over the whole batch and every head on those rows and heads: the
    forward, its lse and the backward twins bit for bit."""
    B, L, H, Hl, dh, mb = 5, 40, 4, 2, 8, 2
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((B, L, H * dh)).astype(np.float32))
                     for _ in range(4))
    mask = torch.ones(B, L)
    mask[1, 30:] = 0
    seed = torch.tensor([4321], dtype=torch.int32)
    cols = slice(off * dh, (off + Hl) * dh)
    sel = slice(rows, rows + mb)
    lse_rows = torch.cat([torch.arange(b * H + off, b * H + off + Hl)
                          for b in range(rows, rows + mb)])
    out_all, lse_all = fa._forward(q, k, v, mask, H, None, rate, seed)
    part = [t[sel, :, cols].contiguous() for t in (q, k, v)]
    span = (H, rows * H + off)
    out, lse = fa._forward(*part, mask[sel], Hl, None, rate, seed, head_span=span)
    assert torch.equal(out, out_all[sel, :, cols]) and torch.equal(lse, lse_all[lse_rows])
    g_all = fa._backward(q, k, v, mask, out_all, lse_all, dout, H, None, rate, seed)
    g = fa._backward(*part, mask[sel], out, lse, dout[sel, :, cols].contiguous(), Hl, None,
                     rate, seed, head_span=span)
    for a, b in zip(g, g_all):
        assert torch.equal(a, b[sel, :, cols])


# ---- the drivers -------------------------------------------------------------

def _mr_want(g, name, dp, jcfg, schedule="gpipe", n_micro=0, tp=1):
    """JAX's step (GPipe, or 1F1B) on make_mesh(dp, tp, pp=2) over the
    batches the gang's dp rows read (the Loader's shards concatenated), 2
    epochs."""
    import torch_mesh_worker as mw

    from univtg_tpu.data.collate import collate_mr as jcollate
    from univtg_tpu.data.loader import Loader as JLoader
    from univtg_tpu.data.mr import MRDataConfig as JMRDataConfig
    from univtg_tpu.data.mr import MRDataset as JMRDataset
    from univtg_tpu.models.losses import LossWeights as JLossWeights
    from univtg_tpu.parallel import make_mesh, replicate_params, shard_batch
    from univtg_tpu.train import schedule as jschedule
    from univtg_tpu.train import steps as jsteps
    from univtg_tpu.train.steps_1f1b import make_1f1b_train_step

    cfg = mw.mr_cfg({"name": name, "mesh": mj.pp_mesh(dp=dp), "cfg": jcfg,
                     "corpus": g["inputs"]["mr"]}, "unused")
    jdata = _jax_twin(cfg.train_data, JMRDataConfig)
    ds = JMRDataset(jdata)
    loaders = [JLoader(ds, cfg.bsz, lambda items, pad_batch_to: jcollate(
        items, jdata.max_q_l, jdata.max_v_l, pad_batch_to), shuffle=True, seed=cfg.seed,
        num_threads=2, shard_index=d, num_shards=dp) for d in range(dp)]
    mesh = make_mesh(dp=dp, pp=2, tp=tp, devices=jax.devices()[:2 * dp * tp])
    params = mj.jax_init(mj.PIPE, mj.batch(0)[0])
    tx = jsteps.make_optimizer(jschedule.build_schedule(
        cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma, len(loaders[0])), cfg.wd,
        cfg.grad_clip)
    jstate = jsteps.TrainState(params=replicate_params(mesh, params),
                               opt_state=tx.init(params), step=np.int32(0))
    model = mj.JaxUniVTG(mj.JaxConfig(**jcfg))
    weights = _jax_twin(cfg.weights, JLossWeights)
    jstep = (make_1f1b_train_step(model, tx, weights, n_micro=n_micro, donate=False)
             if schedule == "1f1b" else jsteps.make_train_step(model, tx, weights, donate=False))
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
    return cfg, want


def _jax_twin(obj, jcls):
    return jcls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(jcls)
                   if hasattr(obj, f.name)})


def check_driver_run(g, name, world, cfg, want):
    """Every rank's steps equal, against JAX's at rtol 1e-4; rank 0 alone
    wrote the checkpoints, canonical (every layer and both Adam moments of
    every parameter), and one process's evaluation of model_latest.ckpt
    equals the gang's last one (the evaluation ran a local non-pipeline
    copy on the gathered parameters)."""
    from univtg_tpu_torch.data.mr import MRDataset
    from univtg_tpu_torch.train import driver_mr
    from univtg_tpu_torch.train.infer_mr import evaluate_submission
    from univtg_tpu_torch.train.steps import make_eval_step

    base = os.path.join(g["base"], name)
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
    blob = torch.load(os.path.join(base, "p0", "model_latest.ckpt"), weights_only=True)
    whole = UniVTG(cfg.model, device="meta")
    assert list(blob["model"]) == list(whole.state_dict())
    names = [n for n, _ in whole.named_parameters()]
    state = blob["optimizer"]["state"]
    assert sorted(state) == list(range(len(names)))
    for i, n in enumerate(names):
        assert state[i]["exp_avg"].shape == blob["model"][n].shape, n
    model = UniVTG(dataclasses.replace(cfg.model, pipeline_stages=0), device="cpu")
    model.load_state_dict(blob["model"])
    eval_ds = MRDataset(cfg.eval_data)
    sub = driver_mr._run_eval_shard(cfg, model, eval_ds, make_eval_step(cfg.eval_mode))
    brief = evaluate_submission(sub, eval_ds.data)["brief"]
    with open(os.path.join(base, "p0", "eval_log.jsonl")) as f:
        last = [json.loads(line) for line in f][-1]
    assert last.pop("epoch") == cfg.n_epoch - 1 and last == brief


def test_train_mr_gpipe_dp2_pp2_follows_jax_and_evaluates_a_local_copy(gang4):
    """train_mr at dp = 2 x pp = 2 (GPipe, 2 microbatches), 2 epochs from
    JAX's init: every step against JAX's step on make_mesh(dp=2, pp=2)
    over the dp rows' shards; rank 0 evaluates a local copy loaded from the
    gathered parameters; the canonical checkpoint's one-process evaluation
    gives the gang's metrics."""
    jcfg = mj.pipe_cfg(mj.PIPE, 2, 2)
    cfg, want = _mr_want(gang4, "mr_dp2pp2", 2, jcfg)
    check_driver_run(gang4, "mr_dp2pp2", 4, cfg, want)


def test_train_mr_1f1b_interleaved_with_sharded_eval_follows_jax(gang2):
    """train_mr at pp = 2 with pipeline_schedule='1f1b', interleave 2 (one
    layer a chunk) and sharded_eval (every rank scores its stride shard on
    its local copy), 2 epochs: every step against JAX's
    make_1f1b_train_step on make_mesh(pp=2) with the same interleave; the
    checkpoint canonical, its one-process evaluation the gang's."""
    jcfg = mj.pipe_cfg(mj.PIPE, 2, 2, 2)
    cfg, want = _mr_want(gang2, "mr_pp2_1f1b", 1, jcfg, "1f1b", 2)
    check_driver_run(gang2, "mr_pp2_1f1b", 2, cfg, want)
    assert os.path.exists(os.path.join(gang2["base"], "mr_pp2_1f1b", "p1", "eval_log.jsonl"))


def test_jax_checkpoint_resumes_into_pp2_on_jax_curve(gang2):
    """resume_all from the JAX package's checkpoint (tests/torch_golden/
    jax_resume: 2 layers, its unrolled layout) into a pp = 2 gang, one
    layer a stage: the params and both Adam moments land in each stage's
    shard by name; the next 2 steps on JAX's curve at rtol 1e-4."""
    with open(os.path.join(mj.GOLDEN, "jax_resume", "expected.json")) as f:
        expected = json.load(f)["metrics"]
    got = _got(gang2, "resume_jax_pp2")
    for i, (g, w) in enumerate(zip(got["metrics"], expected, strict=True)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"{k} at step {i}")
    pipeline_ran(gang2, "resume_jax_pp2", 2, 2, layers=2)


def test_train_vlp_runs_at_pp2(gang2):
    """train_vlp (the loss gates on) with pp = 2 over two corpus specs: both
    ranks take the same finite steps, through the pipelined model."""
    steps = []
    for r in range(2):
        with open(os.path.join(gang2["base"], "vlp_pp2", f"steps_r{r}.json")) as f:
            steps.append(json.load(f))
    assert steps[0] == steps[1] and len(steps[0]) >= 2
    assert all(np.isfinite(s["loss_overall"]) and np.isfinite(s["grad_norm"])
               for s in steps[0])


# ---- refusals and the fallback -----------------------------------------------

SMALL = dict(vid_dim=34, txt_dim=16, hidden_dim=32, num_layers=4, num_heads=4, ffn_dim=48,
             max_v_l=28, max_q_l=4, dropout=0.0, droppath=0.0, input_dropout=0.0)


def test_pipeline_config_without_a_pp_mesh_warns_once_and_equals_the_sequential_model():
    """pipeline_stages = 2 with no pp mesh: JAX's one-time warning, then the
    layers in order, equal to the same weights without pipeline_stages."""
    pipe._PIPELINE_FALLBACK_WARNED.clear()
    cfg = ModelConfig(**SMALL, scan_layers=True, pipeline_stages=2)
    model = UniVTG(cfg, device="cpu", seed=3)
    plain = UniVTG(dataclasses.replace(cfg, pipeline_stages=0), device="cpu", seed=3)
    mi = {k: torch.from_numpy(v) for k, v in mj.batch(0)[0].items()}
    args = (mi["src_txt"], mi["src_txt_mask"], mi["src_vid"], mi["src_vid_mask"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = model(*args, train=False)
        model(*args, train=False)
    msgs = [str(w.message) for w in caught if "pipeline_stages" in str(w.message)]
    assert len(msgs) == 1 and msgs[0].startswith(
        "pipeline_stages=2 configured but no matching 'pp' mesh axis is active")
    want = plain(*args, train=False)
    for k in ("pred_logits", "pred_spans", "saliency_scores"):
        assert torch.equal(out[k], want[k]), k


@pytest.mark.parametrize("stages", [2, 0])
def test_device_major_params_are_refused_off_the_pipeline(stages):
    """pipeline_pre_permuted with interleave > 1 off the pipeline raises
    JAX's error, before the fallback warning (with or without
    pipeline_stages)."""
    cfg = ModelConfig(**SMALL, scan_layers=True, pipeline_stages=stages,
                      pipeline_interleave=2, pipeline_pre_permuted=True)
    model = UniVTG(cfg, device="cpu")
    mi = {k: torch.from_numpy(v) for k, v in mj.batch(0)[0].items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="stored in device-major chunk order"):
            model(mi["src_txt"], mi["src_txt_mask"], mi["src_vid"], mi["src_vid_mask"],
                  train=False)


def test_pipeline_stages_needs_scan_layers():
    with pytest.raises(ValueError, match="pipeline_stages needs scan_layers=True"):
        UniVTG(ModelConfig(**SMALL, pipeline_stages=2), device="cpu")


@pytest.mark.parametrize("change,match", [
    ({"model_id": "moment_detr"}, "supports model_id='univtg' only"),
    ({"model.pipeline_stages": 4}, r"cfg.pp=2 requires cfg.model.pipeline_stages == pp"),
    ({"model.pipeline_pre_permuted": True}, "pipeline_pre_permuted is an execution layout"),
    ({"model.num_layers": 3}, r"num_layers=3 must tile over pp=2 stages x "
                              r"pipeline_interleave=1"),
    ({"model.pipeline_interleave": 4}, r"must tile over pp=2 stages x pipeline_interleave=4"),
    ({"pipeline_schedule": "zb"}, "pipeline_schedule must be 'gpipe' or '1f1b'"),
    ({"pipeline_schedule": "1f1b", "model.pre_norm": True}, "needs pre_norm=False"),
    ({"pipeline_schedule": "1f1b", "scan_steps": 2}, "and scan_steps=1"),
    ({"bsz": 3}, "bsz=3 must split into pipeline_microbatches=2"),
    ({"eval_bsz": 5}, "eval_bsz=5 must split into pipeline_microbatches=2"),
    ({"model.attention_impl": "ring_pallas", "pipeline_schedule": "1f1b", "scan_steps": 2},
     "and scan_steps=1"),
])
def test_driver_validations_raise_in_jax_words(tmp_path, change, match):
    """train_mr's pp > 1 validations, before any data is read (the JAX
    driver's): a ring impl passes them (test_train_mr_runs_ring_pallas_in_a_
    pipeline_stage), and with scan_steps > 1 under pp it still raises."""
    from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr

    model = ModelConfig(**SMALL, scan_layers=True, pipeline_stages=2)
    top = {k: v for k, v in change.items() if not k.startswith("model.")}
    model = dataclasses.replace(model, **{k[6:]: v for k, v in change.items()
                                          if k.startswith("model.")})
    if top.get("model_id") == "moment_detr":
        from univtg_tpu_torch.models.moment_detr import MomentDETRConfig

        model = MomentDETRConfig()
    cfg = TrainConfig(**{"model": model, "pp": 2, "bsz": 4, "eval_bsz": 4,
                         "results_dir": str(tmp_path / "run"), **top})
    with pytest.raises(ValueError, match=match):
        train_mr(cfg, device="cpu")


def test_train_mr_runs_ring_pallas_in_a_pipeline_stage(gang4):
    """train_mr at dp = 1 x pp = 2 x tp = 2 (GPipe, 2 microbatches) with
    "ring_pallas" passes the pp validations (once the port refused a ring
    inside a stage) and runs every training attention call on the kernel's
    twin over the stage's process ring: 2 epochs from JAX's init, every step
    against JAX's GPipe step on the same make_mesh(dp=1, tp=2, pp=2) ("xla":
    JAX's "ring_pallas" inside a GPipe stage aborts XLA on the CPU, and its
    "ring" there doubles two heads' gradients, ROADMAP.md queue 3); the
    checkpoint canonical, its one-process evaluation the gang's."""
    name = "mr_pp2tp2_ring_pallas"
    cfg, want = _mr_want(gang4, name, 1, mj.pipe_cfg(mj.PIPE, 2, 2), tp=2)
    check_driver_run(gang4, name, 4, cfg, want)
    for r in range(4):
        with open(os.path.join(gang4["base"], name, f"dispatches_r{r}.json")) as f:
            made = json.load(f)
        # 2 layers a stage x 2 microbatches a step, all on the ring
        assert made == {**{k: 0 for k in made}, "ring_pallas": 2 * 2 * len(want)}, (r, made)
