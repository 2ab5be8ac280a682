"""True 1F1B across processes on the CPU
(univtg_tpu_torch/parallel/pipeline_1f1b.py,
univtg_tpu_torch/train/steps_1f1b.py): the schedule against JAX's and its
invariants (tests/test_pipeline_1f1b.py:42), and gangs of gloo ranks
(tests/torch_mesh_worker.py, launched once per session by
tests/torch_mesh_jax.py) stepping ``make_1f1b_train_step`` against the JAX
package's ``make_1f1b_train_step`` on the same ``make_mesh(dp, tp, pp=,
ep=)``, from JAX's init: JAX's grid (tests/test_pipeline_1f1b.py:160-173:
dp = 2, M = 8 with the ring slots reused, 4 stages of 2 layers, M = 1,
``use_txt_pos``, interleave 2, tp = 2), MoE at pp = 2 and pp = 2 x ep = 2
(tests/test_moe.py:404), the TAL class bank (tests/test_tal_cls.py:99),
and the saved chunk inputs' bound against GPipe's growth.

Tolerances are PERF.md's: per step loss, aux and grad norm at rtol 1e-4,
the parameters after 3 AdamW steps at 2e-5 (the k-slice of each
in_proj_bias at 2 lr per step).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_jax as mj  # noqa: E402

from univtg_tpu.parallel import pipeline_1f1b as jf1  # noqa: E402
from univtg_tpu_torch.models import ModelConfig, UniVTG  # noqa: E402
from univtg_tpu_torch.models.losses import LossWeights  # noqa: E402
from univtg_tpu_torch.parallel import mesh as pm  # noqa: E402
from univtg_tpu_torch.parallel import pipeline_1f1b as f1  # noqa: E402
from univtg_tpu_torch.train.schedule import build_schedule  # noqa: E402
from univtg_tpu_torch.train.steps import TrainState, make_optimizer  # noqa: E402
from univtg_tpu_torch.train.steps_1f1b import check_1f1b, make_1f1b_train_step  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    return mj.gang(tmp_path_factory, "f1b2")


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    return mj.gang(tmp_path_factory, "f1b4")


def _got(gang, name):
    return torch.load(os.path.join(gang["base"], f"{name}.pt"))


@pytest.mark.parametrize("pp,v,n_micro", [
    (2, 1, 4), (2, 1, 1), (2, 1, 8), (4, 1, 4), (4, 1, 13), (3, 1, 7),
    (2, 2, 4), (2, 2, 3), (2, 2, 16), (2, 4, 8), (4, 2, 8), (3, 3, 7),
])
def test_schedule_equals_jax_and_keeps_its_invariants(pp, v, n_micro):
    """schedule_1f1b and pipeline_1f1b_ticks equal JAX's at every (tick,
    stage); and JAX's invariants: every (microbatch, chunk) runs forward and
    backward once, the backward after the forward; forward rides chunk c ->
    c + 1 and backward c -> c - 1 one tick apart; the ring of 2 pp slots per
    (stage, slot) never holds two live microbatches in one place; the ticks
    end at the last active one; at v = 1 the last stage's forward and
    backward of a microbatch share a tick."""
    ticks = f1.pipeline_1f1b_ticks(n_micro, pp, v)
    assert ticks == jf1.pipeline_1f1b_ticks(n_micro, pp, v)
    fwd_seen, bwd_seen, last_active = {}, {}, -1
    for t in range(ticks + 2 * pp * v):
        for s in range(pp):
            fwd, bwd = f1.schedule_1f1b(t, s, pp=pp, n_micro=n_micro, interleave=v)
            assert (fwd, bwd) == jf1.schedule_1f1b(t, s, pp=pp, n_micro=n_micro, interleave=v)
            if fwd is not None:
                j, m = fwd
                assert (m, s + pp * j) not in fwd_seen
                fwd_seen[(m, s + pp * j)] = t
                last_active = max(last_active, t)
            if bwd is not None:
                j, m = bwd
                c = s + pp * j
                assert (m, c) not in bwd_seen and (m, c) in fwd_seen
                bwd_seen[(m, c)] = t
                last_active = max(last_active, t)
        for s in range(pp):
            for j in range(v):
                c = s + pp * j
                live = [m for m in range(n_micro)
                        if (m, c) in fwd_seen and (m, c) not in bwd_seen]
                slots = [m % (2 * pp) for m in live]
                assert len(set(slots)) == len(slots), (t, s, j, live)
    assert len(fwd_seen) == len(bwd_seen) == n_micro * pp * v
    for m in range(n_micro):
        for c in range(pp * v - 1):
            assert fwd_seen[(m, c + 1)] == fwd_seen[(m, c)] + 1
            assert bwd_seen[(m, c)] == bwd_seen[(m, c + 1)] + 1
        if v == 1:
            assert fwd_seen[(m, pp - 1)] == bwd_seen[(m, pp - 1)]
    assert last_active + 1 == ticks


@pytest.mark.parametrize("name,gang,mesh,M,base,v", [
    ("f1_dp2pp2_m4", "gang4", (2, 1, 1, 2), 4, "PIPE", 1),       # canonical
    ("f1_pp2_m8", "gang2", (1, 1, 1, 2), 8, "PIPE", 1),          # ring slots reused
    ("f1_pp4_m4", "gang4", (1, 1, 1, 4), 4, "PIPE8", 1),         # 4 stages, 8 layers
    ("f1_pp2_m1", "gang2", (1, 1, 1, 2), 1, "PIPE", 1),          # one microbatch
    ("f1_txtpos", "gang4", (2, 1, 1, 2), 4, "TXTPOS", 1),        # d_pos summed over pp
    ("f1_pp2_v2", "gang2", (1, 1, 1, 2), 4, "PIPE8", 2),         # interleaved
    ("f1_pp2tp2", "gang4", (1, 2, 1, 2), 4, "PIPE", 1),          # Megatron tp in a stage
])
def test_1f1b_steps_follow_jax_on_the_same_mesh(request, name, gang, mesh, M, base, v):
    """3 steps of make_1f1b_train_step (the loss the mean of the
    (microbatch x dp shard) block losses, JAX's rows in each block) against
    JAX's make_1f1b_train_step on make_mesh(dp, tp, pp=): every rank the
    same metrics, the parameters after the steps JAX's."""
    g = request.getfixturevalue(gang)
    model = {"PIPE": mj.PIPE, "PIPE8": mj.PIPE8,
             "TXTPOS": {**mj.PIPE, "use_txt_pos": True}}[base]
    cfg = mj.pipe_cfg(model, mesh[3], M, v)
    data = mj.batches(B=mj.PIPE_B)
    params = mj.jax_init(model, data[0][0])
    metrics, final = mj.jax_run(cfg, mesh, params, data, "1f1b", M)
    world = int(np.prod(mesh))
    mj.assert_trajectory(_got(g, name), metrics, final, cfg)
    mj.ranks_agree(g["base"], name, world)
    _check_stage(g, name, world, mesh[3], v, model["num_layers"])


def _check_stage(gang, name, world, pp, v, layers):
    """Every rank ran ticks and hops and held one stage's layers alone."""
    for r in range(world):
        with open(os.path.join(gang["base"], f"{name}_held_r{r}.json")) as f:
            held = json.load(f)
        assert held["pipe"]["ticks"] > 0 and held["pipe"]["hops"] > 0, held["pipe"]
        idx = sorted({int(k.split(".")[3]) for k in held["keys"]
                      if k.startswith("transformer.encoder.layers.")})
        assert any(idx == pm.stage_layers(layers, pp, v, s) for s in range(pp)), (r, idx)


@pytest.mark.parametrize("name,gang,mesh", [
    ("f1_moe_pp2", "gang2", (1, 1, 1, 2)), ("f1_moe_pp2ep2", "gang4", (1, 1, 2, 2))])
def test_moe_1f1b_follows_jax(request, name, gang, mesh):
    """MoE under 1F1B (tests/test_moe.py:404): each block routes alone and
    each chunk's backward seeds its aux with aux_weight / (layers M dp); at
    pp = 2 and pp = 2 x ep = 2 (2 experts a rank) against JAX's 1F1B step on
    the same mesh, loss_moe_aux included."""
    g = request.getfixturevalue(gang)
    cfg = mj.pipe_cfg(mj.MOE, 2, 4)
    data = mj.batches(B=8, Lv=16, Lt=6)
    params = mj.jax_init(mj.MOE, data[0][0])
    metrics, final = mj.jax_run(cfg, mesh, params, data, "1f1b", 4)
    assert "loss_moe_aux" in metrics[0]
    mj.assert_trajectory(_got(g, name), metrics, final, cfg)
    mj.ranks_agree(g["base"], name, int(np.prod(mesh)))
    _check_stage(g, name, int(np.prod(mesh)), 2, 1, 2)


def test_tal_class_bank_under_1f1b_follows_jax(gang4):
    """The TAL class bank (static src_cls) rides with the heads: its
    cotangent, summed over the blocks and over pp, goes back through pre
    (tests/test_tal_cls.py:99): dp = 2 x pp = 2, 4 microbatches, the
    saliency_cls loss, against JAX's 1F1B step with the same bank."""
    cfg = mj.pipe_cfg(mj.PIPE, 2, 4)
    data = mj.tal_batches()
    params = mj.jax_init(mj.PIPE, data[0][0])
    metrics, final = mj.jax_run(cfg, (2, 1, 1, 2), params, data, "1f1b", 4, tal=True)
    got = _got(gang4, "f1_tal")
    assert metrics[0]["loss_s_intra"] != 0.0
    mj.assert_trajectory(got, metrics, final, cfg)
    mj.ranks_agree(gang4["base"], "f1_tal", 4)


def test_1f1b_saved_inputs_stay_bounded_while_gpipe_grows(gang2):
    """The engines' counters over one step at pp = 2, M = 2, 4, 8 and 16:
    the chunk inputs 1F1B carries from one tick to the next stay the same
    and at most 2 pp per slot on each stage; GPipe keeps a graph per
    microbatch and chunk, M on a stage of one chunk."""
    for r in range(2):
        with open(os.path.join(gang2["base"], f"mem_pp2_r{r}.json")) as f:
            peaks = json.load(f)
        f1b = [peaks[f"1f1b_{M}"] for M in mj.MEM_MICRO]
        assert len(set(f1b)) == 1 and 0 <= f1b[0] <= 2 * 2, (r, peaks)
        assert [peaks[f"gpipe_{M}"] for M in mj.MEM_MICRO] == list(mj.MEM_MICRO), (r, peaks)
    with open(os.path.join(gang2["base"], "mem_pp2_r0.json")) as f:
        assert json.load(f)["1f1b_16"] > 0  # stage 0 keeps its inputs in flight


SMALL = dict(vid_dim=34, txt_dim=16, hidden_dim=32, num_layers=4, num_heads=4, ffn_dim=48,
             max_v_l=28, max_q_l=4)


@pytest.mark.parametrize("kw,match", [
    ({"scan_layers": False}, "needs cfg.scan_layers=True"),
    ({"pre_norm": True}, "supports post-norm encoders only"),
    ({"pipeline_pre_permuted": True}, "pipeline_pre_permuted without pipeline_interleave > 1"),
])
def test_1f1b_requirements_raise_in_jax_words(kw, match):
    cfg = ModelConfig(**{**SMALL, "scan_layers": True, **kw})
    with pytest.raises(ValueError, match=match):
        check_1f1b(cfg, 2)


def test_1f1b_needs_a_model_on_a_pp_mesh():
    """A model with no pp mesh raises, in JAX's words for a missing mesh."""
    cfg = ModelConfig(**SMALL, scan_layers=True)
    model = UniVTG(cfg, device="cpu")
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(*mj.SCHED)))
    mi, tg = ({k: torch.from_numpy(v) for k, v in part.items()} for part in mj.batch(0))
    with pytest.raises(ValueError, match="pipeline_1f1b needs a model on a mesh with a 'pp'"):
        make_1f1b_train_step(LossWeights(), n_micro=2)(state, mi, tg, 1)
