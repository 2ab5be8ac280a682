"""QFVS training driver (the reference's main/train_qfvs.py); counterpart of
``univtg_tpu/train/driver_qfvs.py``.

Leave-one-out over the 4 UT-Egocentric videos: per item the model runs three
times (concept1, concept2, oracle = concat) over the segment-flattened grid,
and the three criteria are summed into one backward, one global-norm clip
and one AdamW step (train_qfvs.py:179-195). The three forwards draw their
dropout and droppath masks from generators seeded alike, from (seed, step),
as the JAX step hands the same ``rngs`` to all three: c1 and c2, whose
shapes are equal, draw equal masks. Evaluation picks the top-2% shots and
scores bipartite semantic-matching F1 against the oracle summaries
(train_qfvs.py:33-145). One schedule serves every split, sized by the first
split's dataset; the model and AdamW (its moments and step) are built anew
per split from ``cfg.seed``. The host prep of item N+1 runs in the
``device_prefetch`` thread while the device runs step N; one ``profile_dir``
window covers the first ``profile_steps`` steps of the run. Runs on CUDA
unless ``device='cpu'`` is asked for.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Sequence

import numpy as np
import torch

from univtg_tpu_torch.data import qfvs as qfvs_data
from univtg_tpu_torch.data.qfvs import QFVSDataConfig
from univtg_tpu_torch.data.prefetch import device_prefetch, to_device
from univtg_tpu_torch.device import exact_f32, resolve_device
from univtg_tpu_torch.evals.qfvs_metric import load_videos_tag, semantic_matching
from univtg_tpu_torch.models.config import ModelConfig
from univtg_tpu_torch.models.losses import LossWeights, compact_to_grid, qfvs_losses
from univtg_tpu_torch.models.univtg import UniVTG
from univtg_tpu_torch.parallel import dist
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train.epoch_runner import StepProfiler
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import (
    TrainState,
    forward,
    make_optimizer,
    step_generator,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class QFVSTrainConfig:
    """The JAX package's QFVSTrainConfig, field for field."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: QFVSDataConfig = dataclasses.field(default_factory=QFVSDataConfig)
    tags_mat_path: str = ""
    results_dir: str = "results/qfvs"
    n_epoch: int = 20
    lr: float = 1e-4
    lr_drop: int = 200
    lr_gamma: float = 0.1
    lr_warmup: float = -1
    wd: float = 1e-4
    grad_clip: float = 0.1
    weights: LossWeights = dataclasses.field(
        default_factory=lambda: LossWeights(b=0, g=0, f=1.0, s_intra=0.05, s_inter=0.0)
    )
    eval_epoch: int = 1
    splits: Sequence[Sequence[int]] = ((2, 3, 4), (1, 3, 4), (1, 2, 4), (1, 2, 3))
    seed: int = 2018
    max_q_l: int = 32
    # the hot loop's knobs: host prep of the next item in a background
    # thread, and the profiler window over the run's first steps
    prefetch_depth: int = 2
    profile_dir: str = ""
    profile_steps: int = 5


_VARIANTS = ("c1", "c2", "oracle")


def make_qfvs_train_step(weights: LossWeights):
    """Returns (state, in1, in2, in_oracle, gt1, gt2, gt_oracle, mask_flat,
    seed) -> (state, metrics): the three train-mode forwards (c1, c2,
    oracle), each seeded from the same ``step_generator(seed, step)``
    state, their weighted ``qfvs_losses`` summed into one backward, then the
    clip and one AdamW step. metrics: ``{c1,c2,oracle}_loss_{f,s_intra,
    s_inter}``, ``loss_overall`` and ``grad_norm`` (unclipped), as device
    scalars; the state is updated in place and returned."""
    wd = weights.as_dict()

    def step(state: TrainState, in1, in2, in_oracle, gt1, gt2, gt_oracle, mask_flat,
             seed: int):
        device = next(state.model.parameters()).device
        state.model.train()
        state.optimizer.zero_grad()
        total = None
        metrics = {}
        for tag, mi, gt in zip(_VARIANTS, (in1, in2, in_oracle), (gt1, gt2, gt_oracle)):
            outputs = forward(state.model, mi, train=True,
                              generator=step_generator(seed, state.step, device))
            ld = qfvs_losses(outputs, gt, mask_flat)
            weighted = sum(v * wd[k] for k, v in ld.items() if k in wd)
            total = weighted if total is None else total + weighted
            metrics.update({f"{tag}_{k}": v.detach() for k, v in ld.items()})
        with exact_f32(state.model.cfg.dtype):  # the conv heads' backward in f32
            total.backward()
        metrics["loss_overall"] = total.detach()
        metrics["grad_norm"] = state.optimizer.step(state.step)
        state.step += 1
        return state, metrics

    return step


def _output_mode(cfg: QFVSTrainConfig) -> str:
    """Score-head selection (train_qfvs.py:106-113): saliency-only when the
    fg head is untrained, logits-only when saliency is untrained, else
    ensemble if configured."""
    if cfg.weights.f == 0:
        return "saliency"
    if cfg.weights.s_intra == 0:
        return "logits"
    return "ensemble" if cfg.data.score_ensemble else "logits"


def _model_inputs(inputs, device):
    return to_device({k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in inputs.items()}, device)


@torch.inference_mode()
def _score_one(model, inputs, mode: str) -> np.ndarray:
    """The eval forward's (S*F,) grid scores of one query variant."""
    model.eval()
    outputs = forward(model, _model_inputs(inputs, next(model.parameters()).device),
                      train=False)
    logits = outputs["pred_logits"][..., 0].float().cpu().numpy().reshape(-1)
    sal = outputs["saliency_scores"].float().cpu().numpy().reshape(-1)
    if mode == "saliency":
        return sal
    if mode == "ensemble":
        return logits + sal
    return logits


def split_scores(cfg: QFVSTrainConfig, model, test_video: int):
    """[(oracle summary path, scores of the valid frames in shot order)]
    over the test video's oracle summaries; the c1 and c2 scores are added
    with ``score_gather``."""
    data_cfg = dataclasses.replace(cfg.data, train_videos=(test_video,))
    dataset = qfvs_data.QFVSDataset(data_cfg)
    odir = qfvs_data._oracle_dir(data_cfg, test_video)
    mode = _output_mode(cfg)
    out = []
    for fname in sorted(os.listdir(odir)):
        if not fname.endswith("_oracle.txt"):
            continue
        c1, c2 = fname[: -len("_oracle.txt")].split("_")[:2]
        index = [i for i, it in enumerate(dataset.items) if it[1] == c1 and it[2] == c2][0]
        in1, in2, in_oracle, mask_flat = qfvs_data.prepare_qfvs_batch(dataset[index],
                                                                      cfg.max_q_l)
        score = _score_one(model, in_oracle, mode)
        if cfg.data.score_gather:
            score = score + _score_one(model, in1, mode) + _score_one(model, in2, mode)
        out.append((os.path.join(odir, fname), score[mask_flat > 0]))
    return out


def eval_split(cfg: QFVSTrainConfig, model, test_video: int, videos_tag) -> dict:
    """Mean F/R/P (percent, 2 places) over the test video's oracle
    summaries: the top ``max(int(n * top_percent), 1)`` shots by a stable
    descending sort, matched against the oracle summary's shots."""
    tags = videos_tag[test_video - 1]
    f1_sum = p_sum = r_sum = 0.0
    scored = split_scores(cfg, model, test_video)
    for path, compact in scored:
        compact = compact[: min(len(compact), len(tags))]
        k = int(len(compact) * cfg.data.top_percent)
        top_idx = np.argsort(-compact, kind="stable")[: max(k, 1)]
        gt_summary = qfvs_data.read_oracle_summary(path)
        p, r, f1 = semantic_matching(list(top_idx), gt_summary, tags)
        f1_sum += f1
        p_sum += p
        r_sum += r
    n = len(scored)
    return {
        "F": round(100 * f1_sum / n, 2),
        "R": round(100 * r_sum / n, 2),
        "P": round(100 * p_sum / n, 2),
    }


def _test_videos(cfg: QFVSTrainConfig):
    """Each split's held-out video: the first of all videos not in it."""
    all_videos = set(cfg.data.train_videos) | set(cfg.data.test_videos)
    for s in cfg.splits:
        all_videos |= set(s)
    return [sorted(all_videos - set(split))[0] for split in cfg.splits]


def _average_f(cfg: QFVSTrainConfig, results: dict) -> float:
    return round(sum(v["F"] for k, v in results.items() if k.startswith("V"))
                 / len(cfg.splits), 2)


def infer_qfvs(cfg: QFVSTrainConfig, ckpt_dir: str, videos_tag=None,
               device="cuda") -> dict:
    """Eval-only pass over the per-split best checkpoints
    (``model_V{n}_best.ckpt`` of ``ckpt_dir``; the reference's
    main/inference_qfvs.py)."""
    if videos_tag is None:
        videos_tag = load_videos_tag(cfg.tags_mat_path)
    model = UniVTG(cfg.model, device=resolve_device(device))
    results = {}
    for test_video in _test_videos(cfg):
        path = os.path.join(ckpt_dir, f"model_V{test_video}_best.ckpt")
        model.load_state_dict(ckpt.restore_params(path, model.state_dict(), cfg.model))
        results[f"V{test_video}"] = eval_split(cfg, model, test_video, videos_tag)
    results["AVG_F"] = _average_f(cfg, results)
    return results


def train_qfvs(cfg: QFVSTrainConfig, videos_tag=None, device="cuda") -> dict:
    """Leave-one-out training; returns {"V{n}": best {F, R, P}, ...,
    "AVG_F"} and writes it to ``qfvs_metrics.json``. videos_tag: per-video
    (num_shots, num_concepts) tag matrices, read from ``cfg.tags_mat_path``
    (eval/Tags.mat) when not given."""
    if dist.world() > 1:
        raise NotImplementedError(
            "the QFVS driver runs in one process, as the JAX package's does: "
            "it shards nothing over devices or processes")
    dev = resolve_device(device)
    os.makedirs(cfg.results_dir, exist_ok=True)
    if videos_tag is None:
        videos_tag = load_videos_tag(cfg.tags_mat_path)
    # one schedule across splits, quantized to the first split's epoch length
    first_cfg = dataclasses.replace(cfg.data, train_videos=tuple(cfg.splits[0]))
    first_n = len(qfvs_data.QFVSDataset(first_cfg))
    schedule = build_schedule(cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma,
                              max(first_n, 1))
    train_step = make_qfvs_train_step(cfg.weights)
    seed = cfg.seed + 1  # the JAX driver's PRNGKey(seed + 1)
    results = {}
    with StepProfiler(cfg.profile_dir, cfg.profile_steps) as profiler:
        for split, test_video in zip(cfg.splits, _test_videos(cfg)):
            data_cfg = dataclasses.replace(cfg.data, train_videos=tuple(split))
            dataset = qfvs_data.QFVSDataset(data_cfg)
            # a fresh model and AdamW per split: moments and step from zero
            model = UniVTG(cfg.model, device=dev, seed=cfg.seed)
            state = TrainState(model, make_optimizer(model.parameters(), schedule,
                                                     cfg.wd, cfg.grad_clip))

            def prep(idx, dataset=dataset):
                item = dataset[int(idx)]
                in1, in2, in_oracle, mask_flat = qfvs_data.prepare_qfvs_batch(
                    item, cfg.max_q_l)
                S, F = item["mask_GT"].shape
                n_valid = int(item["seg_len"].sum())
                gts = [torch.from_numpy(compact_to_grid(item[key][:n_valid],
                                                        item["seg_len"], S, F))
                       for key in ("concept1_GT", "concept2_GT", "oracle_summary")]
                tail = to_device({"gt1": gts[0], "gt2": gts[1], "gt_oracle": gts[2],
                                  "mask_flat": torch.from_numpy(mask_flat)}, dev)
                return (_model_inputs(in1, dev), _model_inputs(in2, dev),
                        _model_inputs(in_oracle, dev), tail)

            best = {"F": 0.0}
            order = np.arange(len(dataset))
            for epoch in range(cfg.n_epoch):
                dataset.set_epoch(epoch)
                np.random.default_rng((cfg.seed, epoch)).shuffle(order)
                profiler.start()
                n_done = 0
                for in1, in2, in_oracle, t in device_prefetch(list(order), prep,
                                                              cfg.prefetch_depth):
                    state, metrics = train_step(state, in1, in2, in_oracle, t["gt1"],
                                                t["gt2"], t["gt_oracle"], t["mask_flat"],
                                                seed)
                    n_done += 1
                    profiler.after_step(n_done, metrics)
                profiler.stop()
                if (epoch + 1) % cfg.eval_epoch == 0:
                    scores = eval_split(cfg, model, test_video, videos_tag)
                    if scores["F"] > best["F"]:
                        best = scores
                        ckpt.save_checkpoint(
                            os.path.join(cfg.results_dir, f"model_V{test_video}_best.ckpt"),
                            state, epoch)
            results[f"V{test_video}"] = best
            logger.info(f"split test=V{test_video}: best {best}")
    results["AVG_F"] = _average_f(cfg, results)
    with open(os.path.join(cfg.results_dir, "qfvs_metrics.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results
