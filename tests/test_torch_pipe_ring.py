"""A ring inside a pipeline stage on the CPU: "ring" and "ring_pallas" at pp
= 2 x tp = 2 (the stage's tp ranks are its ring, parallel/ring.ProcessRing)
through GPipe, interleaved GPipe, 1F1B and the drivers, in the gangs of
tests/torch_mesh_jax.py ("pipe4", "f1b4"), and the ring's dropout hash with
a batch-row offset (ops/ring_attention.py), which places a microbatch's rows
as the whole batch's call places them.

The references:
  * 1F1B: JAX's ``make_1f1b_train_step`` with "ring" on the same
    ``make_mesh(dp=1, tp=2, pp=2)``;
  * GPipe: JAX's "ring" over the same two tp ranks, ``make_mesh(dp=1,
    tp=2)``, where JAX runs the layers in order (its pipeline fallback), and
    for the first step's loss JAX's GPipe "ring" on the same ``make_mesh(dp=1,
    tp=2, pp=2)``. JAX's GPipe with a ring at tp = 2 doubles the gradients
    of the class and span heads' convolutions (ROADMAP.md, queue 3), so
    after its first update its curve is not the sequential step's, which
    the port keeps;
  * "ring_pallas": the port's "ring" in the same gang (JAX's "ring_pallas"
    inside a GPipe stage aborts XLA on the CPU);
  * attention dropout: the port's one-process "ring" step under
    ``use_ring(RingGroup(2))`` from the same seed.

Every case counts the impl each attention call ran on each rank, so that a
silent fallback to plain attention fails it. Tolerances are the gangs':
per step loss and grad norm at rtol 1e-4, the parameters after the steps at
2e-5 (the k-slice of each in_proj_bias at 2 lr per step); "ring_pallas"
against "ring" at 1e-5.
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

from univtg_tpu_torch.models import ModelConfig, UniVTG  # noqa: E402
from univtg_tpu_torch.models.losses import LossWeights  # noqa: E402
from univtg_tpu_torch.ops import attention  # noqa: E402
from univtg_tpu_torch.ops.ring_attention import dropout_keep_mask, ring_attention  # noqa: E402
from univtg_tpu_torch.parallel import RingGroup, use_ring  # noqa: E402
from univtg_tpu_torch.parallel import mesh as pm  # noqa: E402
from univtg_tpu_torch.train.schedule import build_schedule  # noqa: E402
from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step  # noqa: E402

torch.set_num_threads(1)

MESH = (1, 2, 1, 2)  # (dp, tp, ep, pp)
WORLD = 4


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    return mj.gang(tmp_path_factory, "pipe4")


@pytest.fixture(scope="module")
def f1b4(tmp_path_factory):
    return mj.gang(tmp_path_factory, "f1b4")


def _got(gang, name):
    return torch.load(os.path.join(gang["base"], f"{name}.pt"))


def _held(gang, name, r):
    with open(os.path.join(gang["base"], f"{name}_held_r{r}.json")) as f:
        return json.load(f)


def stage_tp_ranks():
    """The gang ranks of each stage's tp axis on dp 1 x pp 2 x tp 2."""
    grid = pm.mesh_grid(WORLD, 1, 2, 1, 1, WORLD, 2)  # (dp, pp, ep, tp)
    return [tuple(int(r) for r in grid[0, s, 0]) for s in range(2)]


def ring_ran(gang, name, impl, per_stage, v=1, layers=4):
    """On every rank: the pipeline ran (ticks and hops) on one stage's layers
    alone, each layer's ring is its stage's tp ranks, and its attention
    calls ran ``impl`` ``per_stage[s]`` times and nothing else."""
    stages = stage_tp_ranks()
    for r in range(WORLD):
        held = _held(gang, name, r)
        s = next(i for i, ranks in enumerate(stages) if r in ranks)
        assert held["pipe"]["ticks"] > 0 and held["pipe"]["hops"] > 0, (r, held["pipe"])
        idx = sorted({int(k.split(".")[3]) for k in held["keys"]
                      if k.startswith("transformer.encoder.layers.")})
        assert idx == pm.stage_layers(layers, 2, v, s), (r, idx)
        assert held["ring_ranks"] == [list(stages[s])] * len(idx), (r, held["ring_ranks"])
        want = {k: 0 for k in attention.dispatches}
        want[impl] = per_stage[s]
        assert held["dispatches"] == want, (r, held["dispatches"])


# ---- the ring's dropout hash with a batch-row offset, no gang ---------------

@pytest.mark.parametrize("rows,mb", [(0, 2), (1, 2), (3, 1), (2, 3)])
def test_keep_mask_with_a_row_offset_is_the_whole_batch_mask_sliced(rows, mb):
    """dropout_keep_mask at row_off r over mb rows equals rows r..r+mb-1 of
    the mask over the whole batch, at any query and key offset; row_off 0
    is the JAX package's hash bit for bit."""
    from univtg_tpu.ops.ring_attention import dropout_keep_mask as jax_mask

    B, H, Lq, Lk = 5, 3, 8, 12
    seed = torch.tensor([987], dtype=torch.int32)
    for q_off, k_off in ((0, 0), (8, 24)):
        whole = dropout_keep_mask(seed, 0.3, (B, H, Lq, Lk), q_off, k_off)
        part = dropout_keep_mask(seed, 0.3, (mb, H, Lq, Lk), q_off, k_off, row_off=rows)
        assert torch.equal(part, whole[rows:rows + mb])
        want = np.asarray(jax_mask(np.int32(987), 0.3, (B, H, Lq, Lk), q_off, k_off))
        np.testing.assert_array_equal(whole.numpy(), want)
    if rows:
        assert not torch.equal(part, dropout_keep_mask(seed, 0.3, (mb, H, Lq, Lk), q_off, k_off))


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_one_card_ring_with_a_row_offset_is_the_whole_ring_sliced(P, impl):
    """Attention over a RingGroup(P) at attention dropout 0.2 on rows [r, r +
    mb) with row_off r gives the whole batch's output on those rows and
    their gradients, bit for bit: through ring_attention, and through
    multihead_attention, where "ring_pallas" with dropout falls back to the
    offset-aware "ring" (counted in ``dispatches``)."""
    B, L, D, H, r, mb = 4, 16, 32, 4, 1, 2
    rng = np.random.default_rng(P)
    q, k, v, w = (torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
                  for _ in range(4))
    mask = torch.ones(B, L)
    mask[2, 11:] = 0
    seed = torch.tensor([4242], dtype=torch.int32)
    ring = RingGroup(P, devices=["cpu"] * P)

    def run(rows, off):
        xs = [t[rows].clone().requires_grad_() for t in (q, k, v)]
        out = ring_attention(*xs, mask[rows], num_heads=H, ring=ring, dropout_rate=0.2,
                             dropout_seed=seed, row_off=off)
        return [out] + list(torch.autograd.grad((out * w[rows]).sum(), xs))

    whole, part = run(slice(0, B), 0), run(slice(r, r + mb), r)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[r:r + mb])
    assert not torch.equal(run(slice(r, r + mb), 0)[0], whole[0][r:r + mb])

    eye = torch.eye(D)
    kw = dict(in_proj_weight=torch.cat([eye, eye, eye]), in_proj_bias=torch.zeros(3 * D),
              out_weight=eye, out_bias=None, num_heads=H, impl=impl, dropout_rate=0.2,
              noise=seed)
    before = dict(attention.dispatches)
    with use_ring(ring):
        got = attention.multihead_attention(q[r:r + mb], k[r:r + mb], v[r:r + mb],
                                            key_padding_mask=mask[r:r + mb], row_off=r, **kw)
    assert attention.dispatches["ring"] - before["ring"] == 1
    assert torch.allclose(got, whole[0][r:r + mb], atol=1e-6)


def test_process_ring_with_a_row_offset_is_the_whole_batch_sliced(gang4):
    """The process ring over a stage's two tp ranks (pp = 2 x tp = 2) at
    dropout 0.3: batch row 1 alone, at row_off 1, gives row 1 of the whole
    batch's output bit for bit, which equals the one-card RingGroup(2)."""
    got = _got(gang4, "ring_rows_pp2tp2")
    assert torch.equal(got["dropout_rows"], got["dropout"][1:2])
    full = torch.load(gang4["inputs"]["ring"])
    want = ring_attention(full["q"], full["k"], full["v"], full["m"], num_heads=mj.RING_SHAPE["H"],
                          ring=RingGroup(2, devices=["cpu"] * 2), dropout_rate=mj.RING_RATE,
                          dropout_seed=torch.tensor([mj.RING_SEED], dtype=torch.int32))
    assert torch.equal(got["dropout"], want)


# ---- GPipe and interleaved GPipe ----------------------------------------------

def test_a_stage_s_tp_ranks_are_its_ring(gang4):
    """On dp 1 x pp 2 x tp 2 every layer's ProcessRing holds its stage's tp
    ranks, as mesh.tp_ranks() names them: ranks 0, 1 for stage 0 and 2, 3
    for stage 1."""
    assert stage_tp_ranks() == [(0, 1), (2, 3)]
    for r in range(WORLD):
        held = _held(gang4, "gp_pp2tp2_ring", r)
        assert held["ring_ranks"] == [[0, 1] if r < 2 else [2, 3]] * 2, (r, held)


@pytest.mark.parametrize("name,base,v", [("gp_pp2tp2_ring", "PIPE", 1),
                                         ("gp_pp2tp2_v2_ring", "PIPE8", 2)])
def test_gpipe_ring_steps_follow_jax_ring(tmp_path_factory, gang4, name, base, v):
    """2 steps of make_train_step on a GPipe model (M = 4, interleave v) with
    "ring" at pp = 2 x tp = 2 against JAX's "ring" over the same tp = 2
    ranks; at interleave 1 the first step's loss also against JAX's GPipe
    "ring" on the same make_mesh(dp=1, tp=2, pp=2). Every rank: the same
    metrics, its stage's layers, each attention call on the ring (layers a
    stage x M x steps)."""
    model = {"PIPE": mj.PIPE, "PIPE8": mj.PIPE8}[base]
    cfg = mj.pipe_cfg({**model, **mj.RING}, 2, 4, v)
    data = mj.batches(B=mj.PIPE_B)[:mj.RING_STEPS]
    params = mj.jax_init(model, data[0][0])
    metrics, final = mj.jax_ref(tmp_path_factory, f"{name}_tp2", lambda: mj.jax_run(
        cfg, (1, 2, 1), params, data))
    got = _got(gang4, name)
    mj.assert_trajectory(got, metrics, final, cfg, mj.RING_STEPS)
    mj.ranks_agree(gang4["base"], name, WORLD)
    n = model["num_layers"] // 2
    ring_ran(gang4, name, "ring", [n * 4 * mj.RING_STEPS] * 2, v, model["num_layers"])
    if v == 1:
        first, _ = mj.jax_run(cfg, MESH, params, data[:1])
        np.testing.assert_allclose(got["metrics"][0]["loss_overall"],
                                   first[0]["loss_overall"], rtol=1e-4)


def test_ring_pallas_inside_a_stage_follows_the_port_s_ring(gang4):
    """"ring_pallas" (the kernel's CPU twin over the stage's process ring) in
    the same GPipe steps as gp_pp2tp2_ring: the port's "ring" at 1e-5, every
    attention call on "ring_pallas"."""
    got, want = _got(gang4, "ring_pallas_pp2tp2"), _got(gang4, "gp_pp2tp2_ring")
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        for k in ("loss_overall", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(), atol=1e-5, err_msg=k)
    mj.ranks_agree(gang4["base"], "ring_pallas_pp2tp2", WORLD)
    ring_ran(gang4, "ring_pallas_pp2tp2", "ring_pallas", [2 * 4 * mj.RING_STEPS] * 2)


def test_gpipe_ring_with_dropout_equals_the_one_process_ring_step(gang4):
    """Dropouts on (attention 0.1, drop path 0.1, input 0.3): the GPipe step
    with "ring" at pp = 2 x tp = 2, M = 4, equals the port's one-process
    "ring" step under RingGroup(2) from the same seed, 2 steps at the
    training limits. Each microbatch hashes its own rows (row_off): with
    every microbatch on rows 0..mb-1's bits the curve leaves this one."""
    cfg = {**mj.PIPE, **mj.DROP, **mj.RING}
    model = UniVTG(ModelConfig(**cfg), device="cpu")
    model.load_state_dict(torch.load(gang4["inputs"]["pipe_init"]))
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(*mj.SCHED),
                                             mj.WD, mj.CLIP))
    step = make_train_step(LossWeights())
    want = []
    before = dict(attention.dispatches)
    with use_ring(RingGroup(2, devices=["cpu"] * 2)):
        for mi, tg in torch.load(gang4["inputs"]["pipe"])[:mj.RING_STEPS]:
            state, m = step(state, mi, tg, 1)
            want.append({k: float(v) for k, v in m.items()})
    assert attention.dispatches["ring"] - before["ring"] == 4 * mj.RING_STEPS
    got = _got(gang4, "gp_drop_ring_pp2tp2")
    mj.assert_trajectory(got, want, model.state_dict(), cfg, mj.RING_STEPS)
    mj.ranks_agree(gang4["base"], "gp_drop_ring_pp2tp2", WORLD)
    ring_ran(gang4, "gp_drop_ring_pp2tp2", "ring", [2 * 4 * mj.RING_STEPS] * 2)


# ---- 1F1B ----------------------------------------------------------------------

def test_1f1b_ring_steps_follow_jax_on_the_same_mesh(tmp_path_factory, f1b4):
    """2 steps of make_1f1b_train_step with "ring" at pp = 2 x tp = 2, M = 4,
    against JAX's 1F1B "ring" step on the same make_mesh(dp=1, tp=2, pp=2).
    The backward recomputes each chunk with its ring hops in one order on
    both tp ranks of a stage: stage 0 runs each of its layers' rings twice a
    microbatch (forward, recompute), stage 1 once (the last chunk's forward
    is dead and skipped)."""
    cfg = mj.pipe_cfg({**mj.PIPE, **mj.RING}, 2, 4)
    data = mj.batches(B=mj.PIPE_B)[:mj.RING_STEPS]
    params = mj.jax_init(mj.PIPE, data[0][0])
    metrics, final = mj.jax_ref(tmp_path_factory, "f1_pp2tp2_ring", lambda: mj.jax_run(
        cfg, MESH, params, data, "1f1b", 4))
    mj.assert_trajectory(_got(f1b4, "f1_pp2tp2_ring"), metrics, final, cfg, mj.RING_STEPS)
    mj.ranks_agree(f1b4["base"], "f1_pp2tp2_ring", WORLD)
    per_step = 2 * 4
    ring_ran(f1b4, "f1_pp2tp2_ring", "ring",
             [2 * per_step * mj.RING_STEPS, per_step * mj.RING_STEPS])


# ---- the drivers -----------------------------------------------------------------

def _driver_dispatches(gang, name):
    out = []
    for r in range(WORLD):
        with open(os.path.join(gang["base"], name, f"dispatches_r{r}.json")) as f:
            out.append(json.load(f))
    return out


def test_train_vlp_runs_a_ring_inside_a_stage(gang4):
    """train_vlp (the loss gates on) at pp = 2 x tp = 2 with "ring": every
    rank takes the same finite steps, each of its attention calls on the
    ring (one layer a stage x 2 microbatches a step)."""
    steps = []
    for r in range(WORLD):
        with open(os.path.join(gang4["base"], "vlp_pp2tp2_ring", f"steps_r{r}.json")) as f:
            steps.append(json.load(f))
    assert all(s == steps[0] for s in steps) and len(steps[0]) >= 2
    assert all(np.isfinite(s["loss_overall"]) and np.isfinite(s["grad_norm"])
               for s in steps[0])
    for made in _driver_dispatches(gang4, "vlp_pp2tp2_ring"):
        assert made == {**{k: 0 for k in made}, "ring": 2 * len(steps[0])}, made
