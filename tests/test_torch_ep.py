"""MoE across processes on the CPU: gangs of gloo ranks
(tests/torch_mesh_worker.py, launched once per session by
tests/torch_mesh_jax.py) against the JAX package's global-batch MoE step on
the same mesh (tests/test_moe.py's ``_moe_cfg``: 4 experts, top-2,
scan_layers), from JAX's init: a dp=2 gang (routing over the global batch:
C from the global token count, slots in the global token order, the aux
over every token), ep=2 (2 experts a rank), tp=2 x ep=2 and the 8-rank
dp=2 x ep=2 x tp=2 at 1 layer. Loss, aux and grad norm at rtol 1e-4 per
step, the parameters after 3 AdamW steps at 2e-5, once no router near-tie
(1e-5) is asserted for the batches; and the tp=2 x ep=2 gang's checkpoint,
canonical, loaded into one process.
"""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_jax as mj  # noqa: E402

from univtg_tpu_torch.models import ModelConfig, UniVTG  # noqa: E402
from univtg_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from univtg_tpu_torch.train.schedule import build_schedule  # noqa: E402
from univtg_tpu_torch.train.steps import TrainState, forward, make_optimizer  # noqa: E402

torch.set_num_threads(1)
TIE = 1e-5


@pytest.fixture(scope="module")
def gang2(tmp_path_factory):
    return mj.gang(tmp_path_factory, "ep2")


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    return mj.gang(tmp_path_factory, "ep4")


@pytest.fixture(scope="module")
def gang8(tmp_path_factory):
    return mj.gang(tmp_path_factory, "w8")


def _no_router_near_tie(cfg, init_path):
    """The top-k choices of every token of the first global batch, at the
    init, are clear of the next expert by more than TIE in probability: a
    tie there could route otherwise by rounding alone."""
    model = UniVTG(ModelConfig(**cfg), device="cpu")
    model.load_state_dict(torch.load(init_path))
    mi, _ = mj.batches(1, B=8, Lv=16, Lt=6)[0]
    probs = []
    hook = model.transformer.encoder.layers[0].moe
    x_seen = []
    handle = hook.register_forward_pre_hook(lambda m, args: x_seen.append(args[0]))
    with torch.no_grad():
        forward(model, {k: torch.from_numpy(v) for k, v in mi.items()}, train=False)
    handle.remove()
    x = x_seen[0].reshape(-1, x_seen[0].shape[-1])
    probs = torch.softmax(x.float() @ hook.router.float(), dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    k = cfg["moe_top_k"]
    assert (top[:, k - 1] - top[:, k]).min().item() > TIE


@pytest.mark.parametrize("name,mesh,gang,layers,seq,jax_mesh", [
    ("moe_dp2", (2, 1, 1), "gang2", 2, False, (2, 1, 1)),
    ("moe_ep2", (1, 1, 2), "gang2", 2, False, (1, 1, 2)),
    ("moe_tp2ep2", (1, 2, 2), "gang4", 2, False, (1, 2, 2)),
    ("moe_tp2ep2_seq", (1, 2, 2), "gang4", 2, True, (1, 1, 1)),
    ("moe_dp2ep2tp2", (2, 2, 2), "gang8", 1, False, (2, 2, 2)),
])
def test_moe_gang_follows_the_jax_global_batch_step(request, name, mesh, gang, layers, seq,
                                                    jax_mesh):
    """The gang's MoE steps against JAX's on make_mesh(dp, tp, ep): every
    rank agrees, and loss, aux, grad norm and parameters follow JAX. Under
    seq_shard (16 + 6 tokens, 11 a rank) the router runs on the gathered
    blocks and the bank's output is reduce-scattered back into them; that
    case is held against JAX's seq_shard step on one device, because JAX's
    own step on make_mesh(1, tp=2, ep=2) with seq_shard leaves every other
    mesh's result (grad norm 19.996 at step 0, 11.045 on one device and on
    tp=2 or ep=2 alone; ROADMAP.md queue 3)."""
    g = request.getfixturevalue(gang)
    cfg = {**mj.MOE, "num_layers": layers, "seq_shard": seq}
    init = g["inputs"]["moe_init" if layers == 2 else "moe1_init"]
    _no_router_near_tie({**cfg, "seq_shard": False}, init)
    data = mj.batches(B=8, Lv=16, Lt=6)
    params = mj.jax_init(cfg, data[0][0])
    metrics, final = mj.jax_run(cfg, jax_mesh, params, data)
    got = torch.load(os.path.join(g["base"], f"{name}.pt"))
    mj.assert_trajectory(got, metrics, final, cfg)
    mj.ranks_agree(g["base"], name, int(np.prod(mesh)))


def test_tp2_ep2_checkpoint_is_canonical_and_loads_in_one_process(gang4):
    """The tp=2 x ep=2 gang's checkpoint holds the one-process layout (all
    4 experts, every column, both Adam moments whole): it restores into a
    model and optimizer of one process with resume_all, whose forward is
    the forward of the gang's gathered parameters."""
    got = torch.load(os.path.join(gang4["base"], "moe_tp2ep2.pt"))
    cfg = ModelConfig(**mj.MOE)
    model = UniVTG(cfg, device="cpu")
    state = TrainState(model, make_optimizer(model.parameters(), build_schedule(*mj.SCHED),
                                             mj.WD, mj.CLIP))
    state, epoch = ckpt.restore_checkpoint(os.path.join(gang4["base"], "moe_tp2ep2.ckpt"),
                                           state)
    assert (epoch, state.step) == (0, mj.STEPS)
    blob = torch.load(os.path.join(gang4["base"], "moe_tp2ep2.ckpt"))
    w1 = "transformer.encoder.layers.0.moe.w1"
    assert blob["model"][w1].shape == (4, 64, 96)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    i = names.index(w1)
    assert blob["optimizer"]["state"][i]["exp_avg"].shape == (4, 64, 96)
    whole = UniVTG(cfg, device="cpu")
    whole.load_state_dict(got["params"])
    mi, _ = mj.batches(1, B=8, Lv=16, Lt=6)[0]
    mi = {k: torch.from_numpy(v) for k, v in mi.items()}
    with torch.no_grad():
        a, b = forward(model, mi), forward(whole, mi)
    for k in ("pred_logits", "pred_spans", "saliency_scores"):
        assert torch.equal(a[k], b[k]), k


def test_moe_step_in_a_gang_needs_the_model_on_its_mesh(monkeypatch):
    """A MoE model that was not put on a mesh (parallel/mesh.shard_model)
    would route each rank's shard on its own in a gang of more than one
    rank: the step refuses it before any collective."""
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.parallel import dist
    from univtg_tpu_torch.train.steps import make_train_step

    model = UniVTG(ModelConfig(**{**mj.MOE, "num_layers": 1}), device="cpu")
    state = TrainState(model, make_optimizer(model.parameters(),
                                             build_schedule(*mj.SCHED), 1e-4, 0.1))
    mi, tg = mj.batches(1, B=2, Lv=16, Lt=6)[0]
    mi, tg = ({k: torch.from_numpy(v) for k, v in d.items()} for d in (mi, tg))
    monkeypatch.setattr(dist, "world", lambda: 2)
    with pytest.raises(ValueError, match="shard_model"):
        make_train_step(LossWeights())(state, mi, tg, 0)
