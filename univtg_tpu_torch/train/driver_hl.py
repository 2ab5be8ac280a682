"""Highlight-detection training driver (the reference's main/train_hl.py);
counterpart of ``univtg_tpu/train/driver_hl.py``.

Per-domain loop with a fresh model per domain (seeded from ``cfg.seed``),
best-mAP checkpointing (``model_{domain}_best.ckpt``, the upstream
container of train/checkpoint.py), and a final per-domain + AVG metrics json
(``best_{dset}_metrics.json``). Losses: labels + saliency only
(model/univtg.py:439-440); the span head gets no gradient, and AdamW still
decays it, as optax does (train/steps.ClippedAdamW). The hot loop is the MR
driver's (train/epoch_runner.run_train_epoch: ``transfer_dtype``,
``prefetch_depth``, and the ``profile_dir`` window over the first
``profile_steps`` steps of the first domain). Runs on CUDA unless
``device='cpu'`` is asked for.

In a gang of processes (parallel/dist.py, one rank per device; the
counterpart of the JAX driver's batch sharded over ``make_mesh(dp, tp)``):
each rank reads its shard of each domain's training items (``bsz`` per
rank), every step is the global batch's (train/steps.py gathers the
outputs and sums the gradients), and rank 0 evaluates, checkpoints and
writes the scores, which it broadcasts: every rank returns them. ``dp``
must be None or the world size (``ValueError``); ``tp`` > 1 raises
``NotImplementedError`` naming ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from univtg_tpu_torch.data.hl import HLDataConfig, HLDataset, collate_hl, load_hl_splits
from univtg_tpu_torch.data.loader import Loader
from univtg_tpu_torch.data.prefetch import to_device
from univtg_tpu_torch.device import resolve_device
from univtg_tpu_torch.evals.hl_domain import evaluate_tvsum, evaluate_youtube
from univtg_tpu_torch.models.config import ModelConfig
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.models.univtg import UniVTG
from univtg_tpu_torch.parallel import dist
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train.epoch_runner import StepProfiler, run_train_epoch
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import (
    TrainState,
    forward,
    make_optimizer,
    make_train_step,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class HLTrainConfig:
    """The JAX package's HLTrainConfig, field for field."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: HLDataConfig = dataclasses.field(default_factory=HLDataConfig)
    domains: Optional[Sequence[str]] = None  # None -> all in the split table
    results_dir: str = "results/hl"
    bsz: int = 4
    eval_bsz: int = 4
    n_epoch: int = 200
    lr: float = 1e-4
    lr_drop: int = 200
    lr_gamma: float = 0.1
    lr_warmup: float = 10
    wd: float = 1e-4
    grad_clip: float = 0.1
    weights: LossWeights = dataclasses.field(
        default_factory=lambda: LossWeights(b=0, g=0, f=10, s_intra=0.1, s_inter=0.1)
    )
    losses: Sequence[str] = ("labels", "saliency")
    eval_epoch: int = 5
    eval_mode: Optional[str] = "add"
    f_loss_coef: float = 10.0  # drives the eval score-fusion selection
    s_loss_intra_coef: float = 0.1
    seed: int = 2018
    dp: Optional[int] = None
    tp: int = 1
    # the MR driver's hot-loop knobs (train/epoch_runner.py)
    transfer_dtype: str = "float32"
    prefetch_depth: int = 2
    profile_dir: str = ""
    profile_steps: int = 5


def _refuse_unported(cfg: HLTrainConfig):
    if cfg.tp > 1:
        raise NotImplementedError(
            "the HL driver of univtg_tpu_torch does not run tp > 1 yet "
            "(ROADMAP.md, queue 1 item 11)")
    if cfg.dp is not None and cfg.dp != dist.world():
        raise ValueError(
            f"dp={cfg.dp}: univtg_tpu_torch runs one rank per device, so dp is the "
            f"world size ({dist.world()}); leave it None")


def _domains(cfg: HLTrainConfig):
    return list(cfg.domains or load_hl_splits(cfg.data.dset_name, cfg.data.splits_path))


def _pred_scores(cfg: HLTrainConfig, outputs):
    """Eval-score selection (main/train_hl.py:53-62)."""
    prob = np.asarray(outputs["pred_logits"])[..., 0]
    sal = np.asarray(outputs["saliency_scores"])
    if cfg.f_loss_coef == 0:
        return sal
    if cfg.s_loss_intra_coef == 0:
        return prob
    if cfg.eval_mode == "add":
        return sal + prob
    return prob


def _loader(cfg: HLTrainConfig, dataset, train: bool):
    """The training loader reads this rank's shard (all of it outside a
    gang); the evaluation loader the whole split."""
    return Loader(
        dataset,
        cfg.bsz if train else cfg.eval_bsz,
        lambda items, pad_batch_to: collate_hl(
            items, cfg.data.max_q_l, cfg.data.max_v_l, pad_batch_to
        ),
        shuffle=train,
        seed=cfg.seed,
        shard_index=dist.rank() if train else 0,
        num_shards=dist.world() if train else 1,
    )


@torch.inference_mode()
def domain_scores(cfg: HLTrainConfig, model, dataset: HLDataset):
    """(fused per-video scores, ground truth) of the domain's val split,
    each cut to the video's length: the eval forward on the model's device
    in f32 features; the truth is the (L, 20) annotator matrix (TVSum) or
    the binary match labels (YouTube)."""
    dataset.set_state("val")
    device = next(model.parameters()).device
    model.eval()
    scores, truth = [], []
    for batch in _loader(cfg, dataset, train=False):
        mi = to_device({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in batch["model_inputs"].items()}, device)
        out = forward(model, mi, train=False)
        fused = _pred_scores(cfg, {k: out[k].float().cpu().numpy()
                                   for k in ("pred_logits", "saliency_scores")})
        lens = np.asarray(batch["model_inputs"]["src_vid_mask"]).sum(1).astype(int)
        for i, m in enumerate(batch["meta"]):
            scores.append(fused[i, : lens[i]])
            if cfg.data.dset_name == "tvsum":
                anno = dataset.label[m["vid"]]["anno"]
                truth.append(np.asarray(anno, np.float32)[: lens[i]])
            else:
                truth.append(dataset.get_saliency(m["idx"])[: lens[i]])
    dataset.set_state("train")
    return scores, truth


def eval_domain(cfg: HLTrainConfig, model, dataset: HLDataset) -> float:
    """The domain's val mAP in percent, rounded to 4 places."""
    scores, truth = domain_scores(cfg, model, dataset)
    if cfg.data.dset_name == "tvsum":
        mAP = evaluate_tvsum(scores, truth)
    else:
        mAP = evaluate_youtube(scores, truth)
    return round(mAP * 100, 4)


def infer_hl(cfg: HLTrainConfig, ckpt_dir: str, device="cuda") -> dict:
    """Eval-only pass over the per-domain best checkpoints (the reference's
    main/inference_hl.py): {domain: mAP, "AVG": mean}."""
    _refuse_unported(cfg)
    model = UniVTG(cfg.model, device=resolve_device(device))
    scores = {}
    for domain in _domains(cfg):
        dataset = HLDataset(dataclasses.replace(cfg.data, domain=domain))
        path = os.path.join(ckpt_dir, f"model_{domain}_best.ckpt")
        model.load_state_dict(ckpt.restore_params(path, model.state_dict(), cfg.model))
        scores[domain] = eval_domain(cfg, model, dataset)
    scores["AVG"] = sum(scores.values()) / len(scores)
    return scores


def train_hl(cfg: HLTrainConfig, device="cuda") -> dict:
    """Trains one fresh model per domain; returns {domain: best mAP, "AVG":
    mean} and writes it to best_{dset}_metrics.json. In a gang every rank
    calls it (the rank's own device, of ``device``'s type)."""
    _refuse_unported(cfg)
    dev = dist.rank_device(device)
    is_main = dist.rank() == 0
    os.makedirs(cfg.results_dir, exist_ok=True)
    domains = _domains(cfg)

    def make_loader(domain):
        dataset = HLDataset(dataclasses.replace(cfg.data, domain=domain))
        dataset.set_state("train")
        return dataset, _loader(cfg, dataset, train=True)

    # one schedule for every domain, quantized to the first domain's epoch
    # length (HL domain sizes are near-equal), as the JAX driver does
    first = make_loader(domains[0])
    schedule = build_schedule(cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma,
                              max(1, len(first[1])))
    train_step = make_train_step(cfg.weights, tuple(cfg.losses))
    seed = cfg.seed + 1  # the JAX driver's PRNGKey(seed + 1)
    scores = {}
    with StepProfiler(cfg.profile_dir, cfg.profile_steps, enabled=is_main) as profiler:
        for di, domain in enumerate(domains):
            dataset, loader = first if di == 0 else make_loader(domain)
            # fresh model per domain (train_hl.py:193-209)
            model = UniVTG(cfg.model, device=dev, seed=cfg.seed)
            state = TrainState(model, make_optimizer(model.parameters(), schedule,
                                                     cfg.wd, cfg.grad_clip))
            dist.check_replicated(model, state.optimizer, state.step)
            best = 0.0
            for epoch in range(cfg.n_epoch):
                dataset.set_state("train")
                loader.set_epoch(epoch)
                profiler.start()
                n_done = 0

                def record(metrics):
                    nonlocal n_done
                    n_done += 1
                    profiler.after_step(n_done, metrics)

                run_train_epoch(loader, train_step, state, seed, dev,
                                transfer_dtype=cfg.transfer_dtype,
                                prefetch_depth=cfg.prefetch_depth, record=record)
                profiler.stop()
                if is_main and (epoch + 1) % cfg.eval_epoch == 0:
                    mAP = eval_domain(cfg, model, dataset)
                    if mAP > best:
                        best = mAP
                        ckpt.save_checkpoint(
                            os.path.join(cfg.results_dir, f"model_{domain}_best.ckpt"),
                            state, epoch)
            scores[domain] = best
            logger.info(f"domain {domain}: best mAP {best}")
    scores["AVG"] = sum(scores.values()) / len(scores)
    # rank 0's scores are the run's, on every rank
    scores = json.loads(dist.all_gather_bytes(json.dumps(scores).encode())[0])
    if is_main:
        with open(os.path.join(cfg.results_dir,
                               f"best_{cfg.data.dset_name}_metrics.json"), "w") as f:
            json.dump(scores, f, indent=1)
    return scores
