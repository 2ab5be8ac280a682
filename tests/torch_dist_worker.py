"""One rank of a gang of the port on the CPU (gloo), for
tests/test_torch_dist.py; the port's counterpart of tests/mp_worker.py.

    python torch_dist_worker.py <rank> <world> <init_method> <mode> <meta.json> <results_base>

``meta.json`` holds the synthetic corpora (``corpora``) and, for the mode
"grads", the path of the shared batches. Modes:
  * grads -- one global-batch step per case of ``GRAD_CASES`` on this
    rank's half of the case's batch; writes the summed gradients and the
    losses to ``results_base/grads_r{rank}.pt``;
  * train, evalstop, elastic, resume, full4 -- ``train_vlp`` on
    ``build_cfg(meta, results_base/p{rank}, mode)``; the rank's final
    parameters go to ``p{rank}/final.pt``;
  * hl -- ``train_hl`` on ``build_hl_cfg(meta, results_base/p{rank})`` from
    the weights at ``meta["init"]``; every step's metrics, the scores it
    returned and the message of ``train_qfvs``'s refusal go to
    ``p{rank}/hl.json``, the final parameters to ``p{rank}/final.pt`` and
    the parameters after each step to ``p{rank}/steps.pt``.
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GRAD_CASES = ("plain", "gates", "saliency_one_rank", "no_span_one_rank", "moment_detr")
HIDDEN = dict(hidden_dim=32, num_layers=2, num_heads=4, ffn_dim=48, dropout=0.0,
              droppath=0.0, input_dropout=0.0)


def model_cfg(corpus, cls=None):
    from univtg_tpu_torch.models.config import ModelConfig

    cls = cls or ModelConfig
    return cls(vid_dim=corpus["v_dim"] + 2, txt_dim=corpus["q_dim"],
               max_v_l=corpus["max_clips"], max_q_l=10, **HIDDEN)


def build_cfg(meta, results_dir, mode="train"):
    """The VLP run of ``mode``, shared by the ranks and the tests."""
    from univtg_tpu_torch.data.mr import MRDataConfig
    from univtg_tpu_torch.data.vlp import VLPCorpusSpec, VLPDataConfig
    from univtg_tpu_torch.train.driver_vlp import VLPTrainConfig

    a, b = meta["corpora"]
    vlp_data = VLPDataConfig(
        corpora=tuple(
            VLPCorpusSpec(data_path=c["train_path"], dset_name=name,
                          v_feat_dirs=tuple(c["v_feat_dirs"]), q_feat_dir=c["q_feat_dir"],
                          type=t)
            for c, name, t in ((a, "qvhighlights", "curve"), (b, "videocc", "interval"))),
        q_feat_dim=a["q_dim"], v_feat_dim=a["v_dim"], max_q_l=10, max_v_l=a["max_clips"],
        txt_drop_ratio=0.0)
    eval_data = MRDataConfig(
        dset_name="qvhighlights", data_path=a["val_path"],
        v_feat_dirs=tuple(a["v_feat_dirs"]), q_feat_dir=a["q_feat_dir"],
        q_feat_dim=a["q_dim"], v_feat_dim=a["v_dim"], clip_len=a["clip_len"],
        max_q_l=10, max_v_l=a["max_clips"])
    kw = dict(n_epoch=2, eval_epoch=10, eval_data=None)
    if mode == "evalstop":
        # sharded evaluation after epoch 0, whose missing main metric counts
        # as no gain: max_es_cnt=1 stops every rank there
        kw = dict(n_epoch=4, eval_epoch=1, eval_data=eval_data, sharded_eval=True,
                  main_metric="no-such-metric", max_es_cnt=1)
    elif mode in ("elastic", "resume", "full4"):
        kw = dict(n_epoch=4, eval_epoch=1, eval_data=eval_data,
                  inject_fault_epoch=1 if mode == "elastic" else -1)
    return VLPTrainConfig(
        model=model_cfg(a), vlp_data=vlp_data, results_dir=results_dir,
        bsz=4,  # per rank; the global batch is 4 * world
        eval_bsz=4, lr=3e-4, lr_warmup=1, lr_drop=100, save_interval=-1,
        num_io_threads=2, prefetch_depth=0, seed=7, inject_fault_rank=1, **kw)


def build_hl_cfg(meta, results_dir):
    """The HL run of mode "hl": one domain of ``meta["hl"]``'s corpus, 2
    items a rank a step, 2 epochs, each evaluated, dropouts 0."""
    from univtg_tpu_torch.data.hl import HLDataConfig
    from univtg_tpu_torch.models.config import ModelConfig
    from univtg_tpu_torch.train.driver_hl import HLTrainConfig

    c = meta["hl"]
    data = HLDataConfig(dset_name="tvsum", domain="SYN", anno_path=c["anno_path"],
                        splits_path=c["splits_path"], v_feat_dirs=tuple(c["v_feat_dirs"]),
                        q_feat_dir=c["q_feat_dir"], q_feat_dim=c["q_dim"],
                        max_v_l=c["max_clips"], max_q_l=8)
    model = ModelConfig(vid_dim=c["v_dim"] + 2, txt_dim=c["q_dim"], max_v_l=c["max_clips"],
                        max_q_l=8, **HIDDEN)
    return HLTrainConfig(model=model, data=data, domains=["SYN"], results_dir=results_dir,
                         bsz=2,  # per rank; the global batch is 2 * world
                         eval_bsz=4, n_epoch=2, eval_epoch=1, lr=3e-4, lr_warmup=1,
                         prefetch_depth=0)


def run_hl(meta, base, rank):
    """Mode "hl": train_hl with the model built from meta["init"] and every
    step's metrics recorded; then train_qfvs, which must refuse the gang."""
    import torch

    from univtg_tpu_torch.train import driver_hl
    from univtg_tpu_torch.train.driver_qfvs import QFVSTrainConfig, train_qfvs

    init = torch.load(meta["init"])
    built, steps, params = [], [], []
    make_model, make_step = driver_hl.UniVTG, driver_hl.make_train_step

    def from_init(cfg, device, seed):
        built.append(make_model(cfg, device=device, seed=seed))
        built[-1].load_state_dict(init)
        return built[-1]

    def recording(*args, **kw):
        step = make_step(*args, **kw)

        def run(state, mi, tg, seed):
            state, metrics = step(state, mi, tg, seed)
            steps.append({k: float(v) for k, v in metrics.items()})
            params.append({k: v.detach().clone() for k, v in state.model.state_dict().items()})
            return state, metrics

        return run

    driver_hl.UniVTG, driver_hl.make_train_step = from_init, recording
    out = os.path.join(base, f"p{rank}")
    scores = driver_hl.train_hl(build_hl_cfg(meta, out), device="cpu")
    try:
        train_qfvs(QFVSTrainConfig(), videos_tag={}, device="cpu")
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    with open(os.path.join(out, "hl.json"), "w") as f:
        json.dump({"scores": scores, "steps": steps, "qfvs": refused}, f)
    torch.save(built[-1].state_dict(), os.path.join(out, "final.pt"))
    torch.save(params, os.path.join(out, "steps.pt"))


def case_batch(name, corpus, bsz, seed=3):
    """(model cfg, loss_fn, model_inputs, targets) of a gradient case: a
    global batch of ``bsz`` items of the corpus, edited as the case says."""
    import dataclasses

    import numpy as np
    import torch

    from univtg_tpu_torch.data.collate import collate_mr
    from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset
    from univtg_tpu_torch.models.losses import LossWeights
    from univtg_tpu_torch.models.moment_detr import MomentDETRConfig
    from univtg_tpu_torch.train import steps

    md = name == "moment_detr"
    data = MRDataConfig(
        dset_name="qvhighlights", data_path=corpus["train_path"],
        v_feat_dirs=tuple(corpus["v_feat_dirs"]), q_feat_dir=corpus["q_feat_dir"],
        q_feat_dim=corpus["q_dim"], v_feat_dim=corpus["v_dim"],
        clip_len=corpus["clip_len"], max_q_l=10, max_v_l=corpus["max_clips"])
    ds = MRDataset(data)
    order = np.random.default_rng(seed).permutation(len(ds))[:bsz]
    batch = collate_mr([ds[int(i)] for i in order], 10, corpus["max_clips"])
    mi = {k: torch.from_numpy(v) for k, v in batch["model_inputs"].items()}
    tg = {k: torch.from_numpy(v) for k, v in batch["targets"].items()}
    half = bsz // 2
    weights = LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    if name == "gates":
        gates = np.random.default_rng(seed).integers(0, 2, (bsz, 5)).astype(np.float32)
        gates[:, 3:] = 1.0
        tg["gates"] = torch.from_numpy(gates)
    elif name == "saliency_one_rank":
        tg["saliency_scores"][:half] = 0.0  # rank 0's shard has no saliency
    elif name == "no_span_one_rank":
        tg["timestamp_window"][half:] = 0.0  # rank 1's shard has no positive span
    if md:
        cfg = model_cfg(corpus, MomentDETRConfig)
        cfg = dataclasses.replace(cfg, num_queries=5, num_decoder_layers=2)
        step = steps.make_md_train_step(weights)
    else:
        cfg = model_cfg(corpus)
        step = steps.make_train_step(weights, use_gates=name == "gates")
    return cfg, step, mi, tg


def grads_of(name, corpus, bsz, rank=0, world=1):
    """One step of the case on rank ``rank``'s 1/world of its batch, the
    learning rate 0; returns (losses, gradients after the all-reduce)."""
    import torch

    from univtg_tpu_torch.models.moment_detr import MomentDETR
    from univtg_tpu_torch.models.univtg import UniVTG
    from univtg_tpu_torch.train.steps import TrainState, make_optimizer

    cfg, step, mi, tg = case_batch(name, corpus, bsz)
    per = bsz // world
    sl = slice(rank * per, (rank + 1) * per)
    mi = {k: v[sl] for k, v in mi.items()}
    tg = {k: v[sl] for k, v in tg.items()}
    model = (MomentDETR if name == "moment_detr" else UniVTG)(cfg, device="cpu", seed=1)
    opt = make_optimizer(model.parameters(), lambda c: 0.0, weight_decay=0.0, grad_clip=0.0)
    state = TrainState(model, opt)
    _, metrics = step(state, mi, tg, 0)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


def main():
    import torch

    torch.set_num_threads(1)
    rank, world, init, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    with open(sys.argv[5]) as f:
        meta = json.load(f)
    base = sys.argv[6]

    from univtg_tpu_torch.train import driver_mr
    from univtg_tpu_torch.train.driver_vlp import init_distributed, train_vlp

    assert init_distributed(init, world, rank, device="cpu") == (rank, world)
    if mode == "grads":
        out = {name: grads_of(name, meta["corpora"][0], meta["bsz"], rank, world)
               for name in GRAD_CASES}
        torch.save(out, os.path.join(base, f"grads_r{rank}.pt"))
    elif mode == "hl":
        run_hl(meta, base, rank)
    else:
        built = []
        build_model = driver_mr.build_model
        driver_mr.build_model = lambda *a, **k: built.append(build_model(*a, **k)) or built[-1]
        resume, resume_all = None, False
        if mode == "resume":  # every rank restarts from rank 0's latest checkpoint
            resume, resume_all = os.path.join(base, "p0", "model_latest.ckpt"), True
        elif meta.get("init"):
            resume = meta["init"]
        cfg = build_cfg(meta, os.path.join(base, f"p{rank}"), mode)
        train_vlp(cfg, resume=resume, resume_all=resume_all, device="cpu")
        torch.save(built[0].state_dict(), os.path.join(base, f"p{rank}", "final.pt"))
    print(f"worker {rank} done", flush=True)


if __name__ == "__main__":
    main()
