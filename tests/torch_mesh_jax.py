"""The JAX side of the model-parallel gang tests (tests/test_torch_tp.py,
tests/test_torch_ep.py, tests/test_torch_pipeline.py,
tests/test_torch_1f1b.py) and the gangs they share: the configurations, the
seeded batches, JAX's init carried over to the port, JAX's train step (or
1F1B step) on ``make_mesh(dp, tp, pp=, ep=)`` under ``jax.set_mesh``, and
the three gangs (of 2, 4 and 8 gloo ranks, tests/torch_mesh_worker.py),
each launched once per test session. A JAX reference that several tests
read is computed once per session (``jax_ref``).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import torch

import torch_gang
import torch_mesh_worker as mw
from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.models.losses import LossWeights as JaxWeights
from univtg_tpu.parallel import make_mesh, replicate_params, shard_batch
from univtg_tpu.train import schedule as jschedule
from univtg_tpu.train import steps as jsteps
from univtg_tpu_torch.interop import state_dict_from_jax_params

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_golden")

DENSE = dict(vid_dim=34, txt_dim=16, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, max_v_l=28, max_q_l=4, dropout=0.0, droppath=0.0,
             input_dropout=0.0)
# tests/test_moe.py's _moe_cfg
MOE = dict(vid_dim=34, txt_dim=16, hidden_dim=64, num_layers=2, num_heads=4,
           ffn_dim=96, dropout=0.0, droppath=0.0, input_dropout=0.0, max_v_l=16,
           max_q_l=6, moe_experts=4, moe_top_k=2, scan_layers=True)
SCHED = (1e-3, 2, 200, 0.1, 2)  # lr, warmup, drop, gamma, steps per epoch
WD, CLIP = 1e-4, 0.1
STEPS = 3
RING_SHAPE = dict(B=2, L=32, D=64, H=4)  # tests/test_ring_attention.py's
RING_RATE, RING_SEED = 0.3, 11
# the pipeline cases: JAX's tests/test_pipeline*.py model, in the scan layout
PIPE = dict(DENSE, num_layers=4, scan_layers=True)
PIPE8 = dict(PIPE, num_layers=8)
RING = {"attention_impl": "ring"}
RING_PALLAS = {"attention_impl": "ring_pallas"}
RING_STEPS = 2  # the steps of a ring-inside-a-stage case
PIPE_B = 8  # a global batch of 8 rows: M = 4 microbatches tile over dp = 2
DROP = dict(dropout=0.1, droppath=0.1, input_dropout=0.3)
MEM_MICRO = (2, 4, 8, 16)


def pipe_cfg(base: dict, pp: int, n_micro: int, v: int = 1, **kw) -> dict:
    """``base`` pipelined over ``pp`` stages, ``n_micro`` microbatches, ``v``
    chunks a stage."""
    return {**base, "pipeline_stages": pp, "pipeline_microbatches": n_micro,
            "pipeline_interleave": v, **kw}


def tal_bank(C=5, Lc=3, D=16, seed=0):
    """tests/test_tal_cls.py's class bank: (C, Lc, D) features, all valid."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, Lc, D)).astype(np.float32),
            np.ones((C, Lc), np.float32))


def tal_batches(n=STEPS, B=PIPE_B):
    """``batches`` with tests/test_tal_cls.py's class targets (cls_idx)."""
    out = []
    for mi, tg in batches(n, B=B):
        cls_idx = np.zeros((B, 5), np.float32)
        cls_idx[np.arange(B), np.arange(B) % 5] = 1
        out.append((mi, dict(tg, cls_idx=cls_idx)))
    return out


def batch(seed, B=4, Lv=28, Lt=4, vid_dim=34, txt_dim=16):
    """A seeded (model_inputs, targets) batch of B x (Lv clips + Lt words),
    one row's video half padded."""
    rng = np.random.default_rng(seed)
    ts = np.tile(((np.arange(Lv) + 1.0) / Lv)[None, :, None], (B, 1, 2)).astype(np.float32)
    window = np.zeros((B, Lv), np.float32)
    window[:, 3 + seed:8 + seed] = 1
    nn_sp = np.zeros((B, Lv, 2), np.float32)
    nn_sp[:, :, 0], nn_sp[:, :, 1] = (3 + seed) / Lv, (8 + seed) / Lv
    vm = np.ones((B, Lv), np.float32)
    vm[1, Lv - Lv // 4:] = 0
    mi = {"src_txt": rng.standard_normal((B, Lt, txt_dim)).astype(np.float32),
          "src_txt_mask": np.ones((B, Lt), np.float32),
          "src_vid": rng.standard_normal((B, Lv, vid_dim)).astype(np.float32),
          "src_vid_mask": vm}
    tg = {"timestamp": ts, "timestamp_mask": vm, "timestamp_window": window * vm,
          "span_labels_nn": nn_sp,
          "saliency_scores": rng.uniform(0, 1, (B, Lv)).astype(np.float32) * vm,
          "saliency_pos_labels": np.full((B, 1), 4 + seed, np.int32)}
    return mi, tg


def batches(n=STEPS, **kw):
    return [batch(s, **kw) for s in range(n)]


def jax_init(cfg: dict, mi):
    """JAX's init of ``cfg`` from PRNGKey(0) (numpy leaves)."""
    params = jax.jit(lambda key: JaxUniVTG(JaxConfig(**cfg)).init(
        key, mi["src_txt"], mi["src_txt_mask"], mi["src_vid"], mi["src_vid_mask"],
        train=False))(jax.random.PRNGKey(0))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def jax_run(cfg: dict, mesh_shape, params, data, schedule="gpipe", n_micro=0, tal=False):
    """JAX's make_train_step (AdamW, the clip; with ``schedule`` "1f1b" its
    make_1f1b_train_step) on ``make_mesh(dp, tp, ep)`` or ``make_mesh(dp,
    tp, pp=, ep=)`` (``mesh_shape`` (dp, tp, ep) or (dp, tp, ep, pp)) under
    ``jax.set_mesh``, the params laid out by ``replicate_params`` and each
    batch by ``shard_batch``; ``tal``: the class bank of ``tal_bank`` as
    static inputs and the saliency_cls loss: (every step's metrics, the
    final params as the port's canonical state dict)."""
    from univtg_tpu.train.steps_1f1b import make_1f1b_train_step

    dp, tp, ep, pp = (tuple(mesh_shape) + (1,))[:4]
    mesh = make_mesh(dp=dp, tp=tp, pp=pp, ep=ep, devices=jax.devices()[:dp * tp * ep * pp])
    model = JaxUniVTG(JaxConfig(**cfg))
    tx = jsteps.make_optimizer(jschedule.build_schedule(*SCHED), WD, CLIP)
    state = jsteps.TrainState(params=replicate_params(mesh, params),
                              opt_state=tx.init(params), step=np.int32(0))
    kw = {}
    if tal:
        bank, bank_mask = tal_bank()
        kw = dict(losses=("spans", "labels", "saliency_cls"),
                  static_inputs={"src_cls": bank, "src_cls_mask": bank_mask})
    if schedule == "1f1b":
        step = make_1f1b_train_step(model, tx, JaxWeights(), n_micro=n_micro, donate=False,
                                    **kw)
    else:
        step = jsteps.make_train_step(model, tx, JaxWeights(), donate=False, **kw)
    metrics = []
    with jax.set_mesh(mesh):
        for mi, tg in data:
            state, m = step(state, shard_batch(mesh, mi), shard_batch(mesh, tg),
                            jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
    final = jax.tree_util.tree_map(np.asarray, state.params)
    return metrics, state_dict_from_jax_params(final, _port_cfg(cfg))


def _port_cfg(cfg):
    from univtg_tpu_torch.models import ModelConfig

    return ModelConfig(**cfg)


def jax_ref(tmp_path_factory, name: str, make):
    """``make()`` (a picklable result) computed once per test session,
    whichever xdist worker asks first; the others load it."""
    def run(base):
        path = os.path.join(base, "ref.pt")
        torch.save(make(), path)
        return {"path": path}

    made = torch_gang.once(tmp_path_factory, "torch_mesh", f"jax_{name}", run)
    return torch.load(made["path"], weights_only=False)


def jax_forward(cfg: dict, mesh_shape, params, mi):
    """JAX's eval forward of ``cfg`` on ``mi`` (the pipeline's when the mesh
    (dp, pp) carries a matching pp axis, ``parallel/pipeline.py``): the
    outputs the gangs' forward cases write, as numpy."""
    dp, pp = mesh_shape
    mesh = make_mesh(dp=dp, tp=1, pp=pp, devices=jax.devices()[:dp * pp])
    model = JaxUniVTG(JaxConfig(**cfg))
    with jax.set_mesh(mesh):
        out = jax.jit(lambda p, m: model.apply(
            {"params": p}, m["src_txt"], m["src_txt_mask"], m["src_vid"], m["src_vid_mask"],
            train=False))(replicate_params(mesh, params), shard_batch(mesh, mi))
    return {k: np.asarray(out[k]) for k in ("pred_logits", "pred_spans", "saliency_scores")}


def assert_trajectory(got: dict, metrics, params, cfg: dict, n_steps=STEPS):
    """A gang's run (worker kind steps) against JAX's: loss_overall and
    grad_norm at rtol 1e-4 per step, the parameters after the run at 2e-5;
    the k-slice of each in_proj_bias at 2 lr per step (its gradient is zero
    analytically, tests/test_torch_train.py)."""
    assert len(got["metrics"]) == len(metrics) == n_steps
    for i, (g, w) in enumerate(zip(got["metrics"], metrics)):
        for k in ("loss_overall", "grad_norm") + (("loss_moe_aux",) if "loss_moe_aux" in w
                                                  else ()):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"{k} at step {i}")
    D = cfg["hidden_dim"]
    for k, w in params.items():
        g = got["params"][k]
        assert g.shape == w.shape, k
        if k.endswith("self_attn.in_proj_bias"):
            np.testing.assert_allclose(g[D:2 * D].numpy(), w[D:2 * D].numpy(),
                                       atol=2 * SCHED[0] * n_steps, err_msg=k)
            g, w = torch.cat([g[:D], g[2 * D:]]), torch.cat([w[:D], w[2 * D:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, err_msg=k)


def ranks_agree(base, name, world):
    """Every rank's metrics of a case, equal."""
    runs = []
    for r in range(world):
        with open(os.path.join(base, f"{name}_r{r}.json")) as f:
            runs.append(json.load(f))
    assert all(run == runs[0] for run in runs), name
    return runs[0]


def _tensors(data):
    return [tuple({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}
                  for d in pair) for pair in data]


def _steps(name, mesh, cfg, init, data_path, **kw):
    return {"name": name, "kind": "steps", "mesh": list(mesh), "cfg": cfg, "init": init,
            "batches": data_path, "sched": list(SCHED), "wd": WD, "clip": CLIP,
            "seed": 1, **kw}


def _inputs(base):
    """The shared inputs under ``base``: the dense and MoE inits (JAX's,
    carried over), the batches, the ring operands and the HL corpus."""
    from univtg_tpu_torch.data.synthetic import (
        create_synthetic_hl_corpus,
        create_synthetic_mr_corpus,
    )

    made = {}
    dense, ragged = batches(), batches(Lv=27)
    moe = batches(B=8, Lv=16, Lt=6)
    pipe, mem = batches(B=PIPE_B), batches(1, B=max(MEM_MICRO))
    for name, data in (("dense", dense), ("ragged", ragged), ("moe", moe), ("pipe", pipe),
                       ("mem", mem), ("tal", tal_batches())):
        made[name] = os.path.join(base, f"{name}_batches.pt")
        torch.save(_tensors(data), made[name])
    bank, bank_mask = tal_bank()
    made["tal_bank"] = os.path.join(base, "tal_bank.pt")
    torch.save({"src_cls": torch.from_numpy(bank), "src_cls_mask": torch.from_numpy(bank_mask)},
               made["tal_bank"])
    for name, cfg, mi in (("dense_init", DENSE, dense[0][0]), ("moe_init", MOE, moe[0][0]),
                          ("moe1_init", {**MOE, "num_layers": 1}, moe[0][0]),
                          ("pipe_init", PIPE, pipe[0][0]), ("pipe8_init", PIPE8, pipe[0][0]),
                          ("txtpos_init", {**PIPE, "use_txt_pos": True}, pipe[0][0])):
        made[name] = os.path.join(base, f"{name}.pt")
        torch.save(state_dict_from_jax_params(jax_init(cfg, mi), _port_cfg(cfg)), made[name])
    rng = np.random.default_rng(7)
    B, L, D = RING_SHAPE["B"], RING_SHAPE["L"], RING_SHAPE["D"]
    ring = {n: torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
            for n in "qkvw"}
    mask = np.ones((B, L), np.float32)
    mask[1, 20:] = 0
    ring["m"] = torch.from_numpy(mask)
    made["ring"] = os.path.join(base, "ring_inputs.pt")
    torch.save(ring, made["ring"])
    made["mr"] = create_synthetic_mr_corpus(os.path.join(base, "mr"), n_train=16, n_val=6,
                                            v_dim=32, q_dim=16, max_clips=28, seed=3)
    made["md_batches"] = os.path.join(base, "md_batches.pt")
    torch.save(_tensors(mr_batches(made["mr"], 2)), made["md_batches"])
    made["hl"] = create_synthetic_hl_corpus(os.path.join(base, "hl"), n_train=8, n_val=3,
                                            v_dim=24, q_dim=16, max_clips=20, seed=5)
    made["hl_init"] = os.path.join(base, "hl_init.pt")
    _, params, hl_cfg = hl_jax_model(made["hl"])
    torch.save(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                          hl_cfg), made["hl_init"])
    npz = np.load(os.path.join(GOLDEN, "jax_resume", "batches.npz"))
    made["resume_batches"] = os.path.join(base, "resume_batches.pt")
    torch.save([tuple({k.split("/")[2]: torch.from_numpy(npz[k]) for k in npz.files
                       if k.startswith(f"{i}/{part}/")}
                      for part in ("model_inputs", "targets")) for i in range(2)],
               made["resume_batches"])
    return made


MD = dict(DENSE, num_queries=5, num_decoder_layers=2)


def mr_batches(corpus, n, bsz=4):
    """The first n collated (model_inputs, targets) batches of an MR corpus
    in item order, at DENSE's caps (Moment-DETR's matched losses read its
    windows)."""
    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset

    ds = MRDataset(MRDataConfig(
        data_path=corpus["train_path"], v_feat_dirs=tuple(corpus["v_feat_dirs"]),
        q_feat_dir=corpus["q_feat_dir"], v_feat_dim=corpus["v_dim"],
        q_feat_dim=corpus["q_dim"], max_q_l=DENSE["max_q_l"], max_v_l=DENSE["max_v_l"]))
    out = []
    for i in range(n):
        b = collate_mr([ds[j] for j in range(i * bsz, (i + 1) * bsz)], DENSE["max_q_l"],
                       DENSE["max_v_l"])
        out.append((b["model_inputs"], b["targets"]))
    return out


def hl_jax_model(hl):
    """The JAX model of torch_dist_worker.build_hl_cfg's config and its init
    from PRNGKey(0), and the port's config."""
    import torch_dist_worker as dw

    cfg = dw.build_hl_cfg({"hl": hl}, "unused").model
    fields = {f.name for f in dataclasses.fields(JaxConfig)}
    jmodel = JaxUniVTG(JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                                    if k in fields}))
    z = np.zeros
    params = jmodel.init(jax.random.PRNGKey(0), z((2, 8, hl["q_dim"]), np.float32),
                         np.ones((2, 8), np.float32),
                         z((2, hl["max_clips"], hl["v_dim"] + 2), np.float32),
                         np.ones((2, hl["max_clips"]), np.float32), train=False)["params"]
    return jmodel, params, cfg


def _jobs(made, base):
    """The cases of each gang, by world size."""
    d, r, m = made["dense"], made["ragged"], made["moe"]
    di, mi, m1 = made["dense_init"], made["moe_init"], made["moe1_init"]
    golden = os.path.join(GOLDEN, "jax_resume")
    with open(os.path.join(golden, "expected.json")) as f:
        resume = json.load(f)
    ring = {"kind": "ring", "inputs": made["ring"], "heads": RING_SHAPE["H"],
            "rate": RING_RATE, "seed": RING_SEED}
    return {
        2: [_steps("tp2_xla", (1, 2, 1), DENSE, di, d),
            _steps("tp2_pallas", (1, 2, 1), {**DENSE, "attention_impl": "pallas"}, di, d),
            _steps("seq_tile", (1, 2, 1), {**DENSE, "seq_shard": True}, di, d),
            _steps("seq_ragged", (1, 2, 1), {**DENSE, "seq_shard": True}, di, r),
            _steps("noseq_ragged", (1, 2, 1), DENSE, di, r),
            _steps("ring_seq", (1, 2, 1), {**DENSE, "attention_impl": "ring",
                                           "seq_shard": True}, di, d),
            _steps("ring_pallas_tp2", (1, 2, 1), {**DENSE, "attention_impl": "ring_pallas"},
                   di, d),
            _steps("resume_jax_tp2", (1, 2, 1), resume["model"], None,
                   made["resume_batches"], resume=os.path.join(golden, "model_latest.ckpt"),
                   weights=resume["weights"]),
            _steps("moe_dp2", (2, 1, 1), MOE, mi, m),
            _steps("moe_ep2", (1, 1, 2), MOE, mi, m),
            {**ring, "name": "ring_p2", "mesh": [1, 2, 1]},
            {"name": "mr_tp2", "kind": "train_mr", "mesh": [1, 2, 1], "cfg": DENSE,
             "corpus": made["mr"], "init": di},
            _steps("md_tp2", (1, 2, 1), MD, None, made["md_batches"], md=True),
            {"name": "hl_tp2", "kind": "hl", "tp": 2, "hl": made["hl"],
             "init": made["hl_init"]}],
        4: [_steps("dp2tp2_xla", (2, 2, 1), DENSE, di, d),
            _steps("moe_tp2ep2", (1, 2, 2), MOE, mi, m,
                   ckpt=os.path.join(base, "moe_tp2ep2.ckpt")),
            _steps("moe_tp2ep2_seq", (1, 2, 2), {**MOE, "seq_shard": True}, mi, m),
            {**ring, "name": "ring_p4", "mesh": [1, 4, 1]},
            {"name": "mr_dp2tp2", "kind": "train_mr", "mesh": [2, 2, 1], "cfg": DENSE,
             "corpus": made["mr"], "init": di, "sharded_eval": True}],
        8: [_steps("moe_dp2ep2tp2", (2, 2, 2), {**MOE, "num_layers": 1}, m1, m)],
    }


def pp_mesh(dp=1, tp=1, ep=1, pp=2):
    """A worker's [dp, tp, ep, slices, pp] mesh."""
    return [dp, tp, ep, 1, pp]


def _pipe_jobs(made, base):
    """The pipeline cases of each gang (tests/test_torch_pipeline.py,
    tests/test_torch_1f1b.py, tests/test_torch_pipe_ring.py): GPipe ("gp_")
    and 1F1B ("f1_") steps, the forwards, the saved-input peaks, the
    drivers, and a ring inside a stage (pp = 2 x tp = 2, its tp ranks the
    ring)."""
    pd, pi, p8 = made["pipe"], made["pipe_init"], made["pipe8_init"]
    ring = {"kind": "ring", "inputs": made["ring"], "heads": RING_SHAPE["H"],
            "rate": RING_RATE, "seed": RING_SEED}
    m, mi, tal = made["moe"], made["moe_init"], made["tal"]
    golden = os.path.join(GOLDEN, "jax_resume")
    with open(os.path.join(golden, "expected.json")) as f:
        resume = json.load(f)

    def f1(name, mesh, cfg, init, data=pd, **kw):
        return _steps(name, mesh, cfg, init, data, schedule="1f1b", **kw)

    def fwd(name, mesh, cfg):
        return {"name": name, "kind": "forward", "mesh": mesh, "cfg": cfg, "init": pi,
                "batches": pd}

    return {
        2: [fwd("fwd_pp2_m8", pp_mesh(), pipe_cfg(PIPE, 2, 8)),
            fwd("fwd_pp2_v2", pp_mesh(), pipe_cfg(PIPE, 2, 4, 2)),
            _steps("gp_pp2", pp_mesh(), pipe_cfg(PIPE, 2, 4), pi, pd),
            _steps("gp_pp2_v2", pp_mesh(), pipe_cfg(PIPE, 2, 4, 2), pi, pd),
            _steps("gp_pp2_remat", pp_mesh(), pipe_cfg(PIPE, 2, 4, remat=True), pi, pd),
            _steps("gp_drop_xla", pp_mesh(), pipe_cfg({**PIPE, **DROP}, 2, 4), pi, pd),
            _steps("gp_drop_pallas", pp_mesh(),
                   pipe_cfg({**PIPE, **DROP, "attention_impl": "pallas"}, 2, 4), pi, pd),
            _steps("gp_moe_m1", pp_mesh(), pipe_cfg(MOE, 2, 1), mi, m),
            f1("f1_pp2_m8", pp_mesh(), pipe_cfg(PIPE, 2, 8), pi),
            f1("f1_pp2_m1", pp_mesh(), pipe_cfg(PIPE, 2, 1), pi),
            f1("f1_pp2_v2", pp_mesh(), pipe_cfg(PIPE8, 2, 4, 2), p8),
            f1("f1_moe_pp2", pp_mesh(), pipe_cfg(MOE, 2, 4), mi, m),
            {"name": "mem_pp2", "kind": "mem", "mesh": pp_mesh(), "cfg": pipe_cfg(PIPE, 2, 2),
             "batches": made["mem"], "micro": list(MEM_MICRO), "sched": list(SCHED)},
            _steps("resume_jax_pp2", pp_mesh(), pipe_cfg(
                {**resume["model"], "scan_layers": True}, 2, 2), None,
                made["resume_batches"], resume=os.path.join(golden, "model_latest.ckpt"),
                weights=resume["weights"]),
            {"name": "mr_pp2_1f1b", "kind": "train_mr", "mesh": pp_mesh(),
             "cfg": pipe_cfg(PIPE, 2, 2, 2), "schedule": "1f1b", "corpus": made["mr"],
             "init": pi, "sharded_eval": True},
            {"name": "vlp_pp2", "kind": "train_vlp", "pp": 2, "corpus": made["mr"],
             "model": {"scan_layers": True, "pipeline_stages": 2}}],
        4: [fwd("fwd_dp2pp2_m4", pp_mesh(dp=2), pipe_cfg(PIPE, 2, 4)),
            fwd("fwd_pp4_m4", pp_mesh(pp=4), pipe_cfg(PIPE, 4, 4)),
            _steps("gp_dp2pp2", pp_mesh(dp=2), pipe_cfg(PIPE, 2, 4), pi, pd),
            _steps("gp_pp2tp2", pp_mesh(tp=2), pipe_cfg(PIPE, 2, 4), pi, pd),
            f1("f1_dp2pp2_m4", pp_mesh(dp=2), pipe_cfg(PIPE, 2, 4), pi),
            f1("f1_pp4_m4", pp_mesh(pp=4), pipe_cfg(PIPE8, 4, 4), p8),
            f1("f1_txtpos", pp_mesh(dp=2), pipe_cfg({**PIPE, "use_txt_pos": True}, 2, 4),
               made["txtpos_init"]),
            f1("f1_pp2tp2", pp_mesh(tp=2), pipe_cfg(PIPE, 2, 4), pi),
            f1("f1_moe_pp2ep2", pp_mesh(ep=2), pipe_cfg(MOE, 2, 4), mi, m),
            f1("f1_tal", pp_mesh(dp=2), pipe_cfg(PIPE, 2, 4), pi, tal, tal=made["tal_bank"]),
            f1("f1_pp2tp2_ring", pp_mesh(tp=2), pipe_cfg({**PIPE, **RING}, 2, 4), pi,
               steps=RING_STEPS),
            {"name": "mr_dp2pp2", "kind": "train_mr", "mesh": pp_mesh(dp=2),
             "cfg": pipe_cfg(PIPE, 2, 2), "corpus": made["mr"], "init": pi,
             "ckpt_infer": True},
            _steps("gp_pp2tp2_ring", pp_mesh(tp=2), pipe_cfg({**PIPE, **RING}, 2, 4), pi, pd,
                   steps=RING_STEPS),
            _steps("gp_pp2tp2_v2_ring", pp_mesh(tp=2), pipe_cfg({**PIPE8, **RING}, 2, 4, 2),
                   p8, pd, steps=RING_STEPS),
            _steps("ring_pallas_pp2tp2", pp_mesh(tp=2),
                   pipe_cfg({**PIPE, **RING_PALLAS}, 2, 4), pi, pd, steps=RING_STEPS),
            _steps("gp_drop_ring_pp2tp2", pp_mesh(tp=2),
                   pipe_cfg({**PIPE, **DROP, **RING}, 2, 4), pi, pd, steps=RING_STEPS),
            {**ring, "name": "ring_rows_pp2tp2", "mesh": pp_mesh(tp=2), "rows": [1, 2]},
            {"name": "mr_pp2tp2_ring_pallas", "kind": "train_mr", "mesh": pp_mesh(tp=2),
             "cfg": pipe_cfg({**PIPE, **RING_PALLAS}, 2, 2), "corpus": made["mr"],
             "init": pi},
            {"name": "vlp_pp2tp2_ring", "kind": "train_vlp", "pp": 2, "tp": 2,
             "corpus": made["mr"],
             "model": {"scan_layers": True, "pipeline_stages": 2, **RING}}],
        8: [_steps("gp_dp2pp2tp2", pp_mesh(dp=2, tp=2), pipe_cfg(PIPE, 2, 4), pi, pd)],
    }


# the gang jobs: name -> (world, its cases in order), by test file and world
# size, so that a test waits only on the cases it reads and xdist runs the
# jobs side by side; the two 8-rank cases share one gang
JOBS = {
    "tp2": (2, ("tp2_xla", "tp2_pallas", "seq_tile", "seq_ragged", "noseq_ragged",
                "ring_seq", "ring_pallas_tp2", "resume_jax_tp2", "ring_p2", "mr_tp2",
                "md_tp2", "hl_tp2")),
    "tp4": (4, ("dp2tp2_xla", "ring_p4", "mr_dp2tp2")),
    "ep2": (2, ("moe_dp2", "moe_ep2")),
    "ep4": (4, ("moe_tp2ep2", "moe_tp2ep2_seq")),
    "pipe2": (2, ("fwd_pp2_m8", "fwd_pp2_v2", "gp_pp2", "gp_pp2_v2", "gp_pp2_remat",
                  "gp_drop_xla", "gp_drop_pallas", "gp_moe_m1", "resume_jax_pp2",
                  "mr_pp2_1f1b", "vlp_pp2")),
    "pipe4": (4, ("fwd_dp2pp2_m4", "fwd_pp4_m4", "gp_dp2pp2", "gp_pp2tp2", "mr_dp2pp2",
                  "gp_pp2tp2_ring", "gp_pp2tp2_v2_ring", "ring_pallas_pp2tp2",
                  "gp_drop_ring_pp2tp2", "ring_rows_pp2tp2", "mr_pp2tp2_ring_pallas",
                  "vlp_pp2tp2_ring")),
    "f1b2": (2, ("f1_pp2_m8", "f1_pp2_m1", "f1_pp2_v2", "f1_moe_pp2", "mem_pp2")),
    "f1b4": (4, ("f1_dp2pp2_m4", "f1_pp4_m4", "f1_txtpos", "f1_pp2tp2", "f1_moe_pp2ep2",
                 "f1_tal", "f1_pp2tp2_ring")),
    "w8": (8, ("moe_dp2ep2tp2", "gp_dp2pp2tp2")),
}


def job_cases(made, base, job):
    """The cases of gang job ``job`` (JOBS), with their outputs in ``base``."""
    world, names = JOBS[job]
    by_name = {}
    for jobs in (_jobs(made, base), _pipe_jobs(made, base)):
        for w, cases in jobs.items():
            by_name.update({c["name"]: (w, c) for c in cases})
    assert all(by_name[n][0] == world for n in names), job
    return [by_name[n][1] for n in names]


def gang(tmp_path_factory, job: str) -> dict:
    """Run gang job ``job`` (JOBS) once per session; returns its directory,
    rank 0's log and the shared inputs."""
    inputs = torch_gang.once(tmp_path_factory, "torch_mesh", "inputs", _inputs)

    def make(base):
        cases = job_cases(dict(inputs), base, job)
        outs = torch_gang.wait(mw.launch({"cases": cases, "out": base}, base, JOBS[job][0]),
                               mw.GANG_TIMEOUT)
        return {"base": base, "log": outs[0][-20000:]}

    return {**torch_gang.once(tmp_path_factory, "torch_mesh", f"gang_{job}", make),
            "inputs": inputs}
