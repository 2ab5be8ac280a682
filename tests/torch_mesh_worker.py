"""One rank of a model-parallel gang of the port on the CPU (gloo), for
tests/test_torch_{tp,ep,pipeline,1f1b}.py, and the helpers that launch
such gangs (over tests/torch_gang.py).

    python torch_mesh_worker.py <rank> <world> <init_method> <job.json>

``job.json`` holds ``pg_timeout``, the seconds its process groups wait
(torch_gang.join_with_timeout), and ``cases``, run in order by every rank,
each on its own
mesh ``[dp, tp, ep]`` or ``[dp, tp, ep, 1, pp]`` (dp * pp * tp * ep =
world; the groups of a grid are made once). Kinds:
  * steps -- the model of ``cfg`` (Moment-DETR with ``md``, replicated)
    from the canonical state dict at
    ``init`` (or ``resume``d with ``resume_all`` from a checkpoint, the JAX
    package's too), put on the mesh, stepped by ``make_train_step`` (with
    ``schedule`` "1f1b" ``make_1f1b_train_step``; ``tal``: the class bank
    at that path as static inputs and the saliency_cls loss) over
    the global batches at ``batches`` (each dp row its slice); writes every
    step's metrics, the canonical parameters after the last step (gathered
    by every rank), the warnings and the attention dispatches to
    ``<out>/<name>.pt`` (rank 0) and each rank's metrics to
    ``<out>/<name>_r<rank>.json``, with the pipeline's counters, the
    parameters it holds, its attention dispatches and its layers' process
    ring ranks to ``<out>/<name>_held_r<rank>.json``; ``steps``: the first
    that many batches only; with ``ckpt``, rank 0 saves the gathered
    checkpoint there;
  * forward -- the model of ``cfg`` from ``init`` on the mesh, in eval, on
    the global batch's model inputs at ``batches`` (its first), each dp row
    its slice: the outputs all-gathered over dp to ``<out>/<name>.pt``
    (rank 0);
  * mem -- one step of each pipeline schedule at each microbatch count of
    ``micro`` on the batch at ``batches``: the engines' saved-input peaks
    to ``<out>/<name>_r<rank>.json``;
  * train_vlp -- ``train_vlp`` on two corpora specs over the ``corpus``,
    every step's metrics to ``<out>/<name>/steps_r<rank>.json``;
  * ring -- ``process_ring_attention`` and ``ring_attention_pallas`` (the
    CPU twin) over the tp axis as a ``ProcessRing`` on the (B, L, D) q, k,
    v and mask at ``inputs``, each rank on its block: the outputs and the
    gradients of ``sum(out * w)`` all-gathered, and the dropout output at
    ``rate``/``seed``, and with ``rows`` [r, r + n) that dropout output of
    those batch rows alone at ``row_off`` r, to ``<out>/<name>.pt`` (rank 0);
  * hl -- ``train_hl`` through ``torch_dist_worker.run_hl`` with ``tp`` set
    (dp = world / tp), into ``<out>/p<rank>``;
  * train_mr -- ``train_mr`` (the config of ``mr_cfg``) from the weights
    at ``init`` (weights only, loaded whole before the model is put on
    the mesh), every step's metrics to ``<out>/<name>/steps_r<rank>.json``
    and the attention dispatches of its steps to
    ``<out>/<name>/dispatches_r<rank>.json``; its logs and checkpoints in
    ``<out>/<name>/p<rank>``; train_vlp likewise, with ``tp`` and the
    ``model`` fields set.
"""
import json
import os
import sys
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)
import torch_gang  # noqa: E402

# the whole gang's deadline: a job takes 10-30 s alone on 8 idle cores
GANG_TIMEOUT = 300


def launch(job: dict, base: str, world: int):
    """Start a gang of ``world`` ranks on ``job``, written to base/job.json
    with the process groups' timeout (torch_gang.PG_TIMEOUT_S); returns the
    torch_gang.Gang."""
    os.makedirs(base, exist_ok=True)
    path = os.path.join(base, "job.json")
    with open(path, "w") as f:
        json.dump({"pg_timeout": torch_gang.PG_TIMEOUT_S, **job}, f)
    store = os.path.join(base, "store")
    if os.path.exists(store):  # a FileStore left by a gang that failed
        os.remove(store)
    logs = [os.path.join(base, f"rank{r}.log") for r in range(world)]
    return torch_gang.launch([[sys.executable, os.path.abspath(__file__), str(r), str(world),
                               "file://" + store, path] for r in range(world)], logs)


def dp_slice(tree, mesh):
    """This dp row's rows of a global batch (a dict of tensors)."""
    if mesh is None or not mesh.dp.on:
        return tree
    n = next(iter(tree.values())).shape[0] // mesh.dp.size
    return {k: v[mesh.dp.index * n:(mesh.dp.index + 1) * n] for k, v in tree.items()}


def run_steps(case, rank, out):
    import torch

    from univtg_tpu_torch.models import ModelConfig, UniVTG
    from univtg_tpu_torch.ops import attention
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.parallel import pipeline as pipe
    from univtg_tpu_torch.train import checkpoint as ckpt
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer

    mesh = pm.make_mesh(*case["mesh"])
    model, step = md_model_and_step(case) if case.get("md") else (
        UniVTG(ModelConfig(**case["cfg"]), device="cpu", seed=0), None)
    if step is None:
        step = _dense_step(case)
    if case.get("init"):
        model.load_state_dict(torch.load(case["init"]))
    (pm.replicate_model if case.get("md") else pm.shard_model)(model, mesh)
    state = TrainState(model, make_optimizer(model.parameters(),
                                             build_schedule(*case["sched"]),
                                             case["wd"], case["clip"]))
    if case.get("resume"):
        ckpt.restore_checkpoint(case["resume"], state)
    before = dict(attention.dispatches)
    pipe.reset_stats()
    metrics = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for mi, tg in torch.load(case["batches"])[:case.get("steps")]:
            state, m = step(state, dp_slice(mi, mesh), dp_slice(tg, mesh), case["seed"])
            metrics.append({k: float(v) for k, v in m.items()})
    blob = ckpt.host_blob(state, 0, None)
    if case.get("ckpt") and rank == 0:
        ckpt.save_checkpoint(case["ckpt"], state, 0, blob=blob)
    with open(os.path.join(out, f"{case['name']}_r{rank}.json"), "w") as f:
        json.dump(metrics, f)
    made = {k: attention.dispatches[k] - before[k] for k in before}
    rings = [] if case.get("md") else [
        layer.self_attn.ring for layer in model.transformer.encoder.stage_layers()]
    held = {"pipe": dict(pipe.stats), "n_params": sum(p.numel() for p in model.parameters()),
            "keys": sorted(model.state_dict()), "dispatches": made,
            "ring_ranks": [None if r is None else list(r.ranks) for r in rings]}
    with open(os.path.join(out, f"{case['name']}_held_r{rank}.json"), "w") as f:
        json.dump(held, f)
    if rank == 0:
        torch.save({"metrics": metrics, "params": blob["model"],
                    "warnings": [str(w.message) for w in caught],
                    "dispatches": made},
                   os.path.join(out, f"{case['name']}.pt"))


def _dense_step(case):
    """The UniVTG train step of a steps case: make_train_step, or with
    ``schedule`` "1f1b" make_1f1b_train_step (``n_micro``); ``tal``: the
    class bank at that path as static inputs, the saliency_cls loss."""
    import torch

    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.train.steps import make_train_step
    from univtg_tpu_torch.train.steps_1f1b import make_1f1b_train_step

    weights = LossWeights(**case.get("weights", {}))
    losses = ("spans", "labels", "saliency_cls") if case.get("tal") else (
        "spans", "labels", "saliency")
    static = torch.load(case["tal"]) if case.get("tal") else None
    if case.get("schedule") == "1f1b":
        return make_1f1b_train_step(weights, losses, n_micro=case.get("n_micro", 0),
                                    static_inputs=static)
    return make_train_step(weights, losses, static_inputs=static)


def run_forward(case, rank, out):
    import torch

    from univtg_tpu_torch.models import ModelConfig, UniVTG
    from univtg_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(*case["mesh"])
    model = UniVTG(ModelConfig(**case["cfg"]), device="cpu", seed=0)
    model.load_state_dict(torch.load(case["init"]))
    pm.shard_model(model, mesh)
    mi = dp_slice(torch.load(case["batches"])[0][0], mesh)
    with torch.no_grad():
        got = model(mi["src_txt"], mi["src_txt_mask"], mi["src_vid"], mi["src_vid_mask"],
                    train=False)
    got = {k: pm.all_gather(got[k], mesh.dp, 0)
           for k in ("pred_logits", "pred_spans", "saliency_scores")}
    if rank == 0:
        torch.save(got, os.path.join(out, f"{case['name']}.pt"))


def run_mem(case, rank, out):
    import torch

    from univtg_tpu_torch.models import ModelConfig, UniVTG
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.parallel import pipeline as pipe
    from univtg_tpu_torch.train.schedule import build_schedule
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer

    mesh = pm.make_mesh(*case["mesh"])
    mi, tg = torch.load(case["batches"])[0]
    peaks = {}
    for schedule in ("gpipe", "1f1b"):
        for M in case["micro"]:
            cfg = ModelConfig(**{**case["cfg"], "pipeline_microbatches": M})
            model = pm.shard_model(UniVTG(cfg, device="cpu", seed=0), mesh)
            state = TrainState(model, make_optimizer(model.parameters(),
                                                     build_schedule(*case["sched"])))
            pipe.reset_stats()
            _dense_step({"schedule": schedule})(state, mi, tg, 1)
            peaks[f"{schedule}_{M}"] = pipe.stats["saved_peak"]
    with open(os.path.join(out, f"{case['name']}_r{rank}.json"), "w") as f:
        json.dump(peaks, f)


def md_model_and_step(case):
    """A Moment-DETR case's model (seed 0) and its train step."""
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.models.moment_detr import MomentDETR, MomentDETRConfig
    from univtg_tpu_torch.train.steps import make_md_train_step

    return (MomentDETR(MomentDETRConfig(**case["cfg"]), device="cpu", seed=0),
            make_md_train_step(LossWeights(**case.get("weights", {}))))


def run_ring(case, rank, out):
    import torch

    from univtg_tpu_torch.ops import ring_attention_pallas as rap
    from univtg_tpu_torch.ops.ring_attention import process_ring_attention
    from univtg_tpu_torch.parallel import mesh as pm
    from univtg_tpu_torch.parallel.ring import ProcessRing

    mesh = pm.make_mesh(*case["mesh"])
    ring = ProcessRing(mesh.tp, mesh.tp_ranks())
    full = torch.load(case["inputs"])
    q, k, v, mask, w = (full[n].chunk(ring.size, dim=1)[ring.rank] for n in "qkvmw")
    H = case["heads"]
    res = {}
    for name, fn in (("ring", process_ring_attention), ("ring_pallas", rap.ring_attention_pallas)):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*xs, mask, num_heads=H, ring=ring)
        grads = torch.autograd.grad((o * w).sum(), xs)
        res[name] = [pm.all_gather(t.detach(), mesh.tp, 1) for t in (o, *grads)]
    seed = torch.tensor([case["seed"]], dtype=torch.int32)
    o = process_ring_attention(q, k, v, mask, num_heads=H, ring=ring,
                               dropout_rate=case["rate"], dropout_seed=seed)
    res["dropout"] = pm.all_gather(o, mesh.tp, 1)
    if case.get("rows"):
        r0, r1 = case["rows"]
        o = process_ring_attention(q[r0:r1], k[r0:r1], v[r0:r1], mask[r0:r1], num_heads=H,
                                   ring=ring, dropout_rate=case["rate"], dropout_seed=seed,
                                   row_off=r0)
        res["dropout_rows"] = pm.all_gather(o, mesh.tp, 1)
    if rank == 0:
        torch.save(res, os.path.join(out, f"{case['name']}.pt"))


def mr_cfg(case, results_dir):
    """The TrainConfig of a train_mr case: the case's model on its corpus
    (``corpus``: create_synthetic_mr_corpus's dict), bsz 4 a dp row, 2
    epochs each evaluated, lr 1e-3."""
    from univtg_tpu_torch.data.mr import MRDataConfig
    from univtg_tpu_torch.models import ModelConfig
    from univtg_tpu_torch.train.driver_mr import TrainConfig

    c = case["corpus"]

    def data(path):
        return MRDataConfig(data_path=path, v_feat_dirs=tuple(c["v_feat_dirs"]),
                            q_feat_dir=c["q_feat_dir"], v_feat_dim=c["v_dim"],
                            q_feat_dim=c["q_dim"], max_q_l=case["cfg"]["max_q_l"],
                            max_v_l=case["cfg"]["max_v_l"])

    mesh = case["mesh"] + [1, 1][len(case["mesh"]) - 3:]
    return TrainConfig(model=ModelConfig(**case["cfg"]), train_data=data(c["train_path"]),
                       eval_data=data(c["val_path"]), results_dir=results_dir, bsz=4,
                       eval_bsz=4, n_epoch=2, eval_epoch=1, lr=1e-3, lr_warmup=1,
                       lr_drop=100, num_io_threads=2, prefetch_depth=0, seed=7,
                       tp=mesh[1], ep=mesh[2], pp=mesh[4],
                       pipeline_schedule=case.get("schedule", "gpipe"),
                       sharded_eval=case.get("sharded_eval", False))


def _recorded(module, name, steps, dispatches):
    """Wrap ``module.name`` (a step factory) so that every step's metrics
    go to ``steps`` and the attention dispatches of its steps are added up
    in ``dispatches``; returns undo."""
    from univtg_tpu_torch.ops import attention

    make_step = getattr(module, name)

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def run(state, mi, tg, seed):
            before = dict(attention.dispatches)
            state, metrics = step(state, mi, tg, seed)
            steps.append({k: float(v) for k, v in metrics.items()})
            for k, n in attention.dispatches.items():
                dispatches[k] = dispatches.get(k, 0) + n - before[k]
            return state, metrics
        return run

    setattr(module, name, recording)
    return lambda: setattr(module, name, make_step)


def run_train_mr(case, rank, out):
    from univtg_tpu_torch.train import driver_mr, steps_1f1b

    steps, made = [], {}
    base = os.path.join(out, case["name"])
    undo = [_recorded(driver_mr, "make_train_step", steps, made),
            _recorded(steps_1f1b, "make_1f1b_train_step", steps, made)]
    try:
        driver_mr.train_mr(mr_cfg(case, os.path.join(base, f"p{rank}")),
                           resume=case["init"], device="cpu",
                           resume_all=case.get("resume_all", False))
    finally:
        for u in undo:
            u()
    _write_steps(base, rank, steps, made)


def _write_steps(base, rank, steps, dispatches):
    with open(os.path.join(base, f"steps_r{rank}.json"), "w") as f:
        json.dump(steps, f)
    with open(os.path.join(base, f"dispatches_r{rank}.json"), "w") as f:
        json.dump(dispatches, f)


def run_train_vlp(case, rank, out):
    import dataclasses

    import torch_dist_worker as dw

    from univtg_tpu_torch.train import driver_mr
    from univtg_tpu_torch.train.driver_vlp import train_vlp

    steps, made = [], {}
    base = os.path.join(out, case["name"])
    cfg = dw.build_cfg({"corpora": [case["corpus"], case["corpus"]]},
                       os.path.join(base, f"p{rank}"))
    cfg = dataclasses.replace(cfg, pp=case["pp"], tp=case.get("tp", 1),
                              model=dataclasses.replace(cfg.model, **case["model"]))
    undo = _recorded(driver_mr, "make_train_step", steps, made)
    try:
        train_vlp(cfg, device="cpu")
    finally:
        undo()
    _write_steps(base, rank, steps, made)


def run_hl_case(case, rank, out):
    import dataclasses

    import torch_dist_worker as dw

    build = dw.build_hl_cfg
    dw.build_hl_cfg = lambda meta, d: dataclasses.replace(build(meta, d), tp=case["tp"])
    dw.run_hl({"hl": case["hl"], "init": case["init"]}, out, rank)


def main():
    import torch

    torch.set_num_threads(1)
    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    with open(sys.argv[4]) as f:
        job = json.load(f)
    from univtg_tpu_torch.parallel import dist

    torch_gang.join_with_timeout(job["pg_timeout"])
    dist.init_gang(init, world, rank, device="cpu")
    kinds = {"steps": run_steps, "ring": run_ring, "hl": run_hl_case,
             "train_mr": run_train_mr, "forward": run_forward, "mem": run_mem,
             "train_vlp": run_train_vlp}
    for case in job["cases"]:
        kinds[case["kind"]](case, rank, job["out"])
    dist.shutdown()
    print(f"worker {rank} done", flush=True)


if __name__ == "__main__":
    main()
