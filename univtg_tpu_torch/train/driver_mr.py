"""Moment-retrieval training driver on one device; counterpart of
``univtg_tpu/train/driver_mr.py``.

``train_mr(cfg)``: datasets -> Loader -> model, AdamW, the train and eval
steps -> epoch loop with periodic evaluation on ``eval_data`` (every
``eval_epoch`` epochs, and at epoch -1 with ``eval_init``), main-metric
early stopping and the best/latest/periodic checkpoint triple. Per-epoch
metric means stream to ``train_log.jsonl``, each evaluation's brief metrics
to ``eval_log.jsonl``, its predictions to ``latest_val_preds.jsonl`` and its
full metrics to ``metrics_eNNNN.json``, the config to ``opt.json``
(train/config_io.py) and the source to ``code.zip``, all in
``results_dir``; the epoch and evaluation scalars also to TensorBoard with
``tensorboard_dir`` ("auto": ``results_dir/tb``), and a torch.profiler
trace of the first ``profile_steps`` steps into ``profile_dir``.
Checkpoints are torch files in the upstream container (train/checkpoint.py).
``TrainConfig`` has the JAX package's fields and JSON.

Across processes (a gang of parallel/dist.py, one rank per device): each
rank reads its shard of the data (``num_shards`` = the world size,
``shard_index`` = the rank; with ``length_buckets`` the Loader's global
bucket plan), every step is the global batch's (train/steps.py), and only
rank 0 evaluates, checkpoints, writes TensorBoard, profiles and snapshots
the code; its early-stop and final-save decisions are broadcast. Every rank
writes its own ``train_log.jsonl`` and ``opt.json`` into its results_dir,
as in the JAX package. ``sharded_eval`` spreads the evaluation over the
ranks (stride shards, submissions all-gathered, rank 0 merging);
``inject_fault_epoch``/``inject_fault_rank`` make one rank exit hard after
an epoch, and the gang restarts with ``resume`` = rank 0's
``model_latest.ckpt`` and ``resume_all``. ``dp`` is the world size (None
means it); ``tp``/``pp``/``ep`` > 1 raise ``NotImplementedError`` naming
ROADMAP.md. With ``async_checkpoint`` (the default) the checkpoints are
written by train/checkpoint.AsyncCheckpointer: the state is copied to the
host at each save and the file written in the background, one write in
flight; the driver waits for it before an early stop, a hard exit of
``inject_fault_epoch``, and before it returns. ``scan_steps = K > 1``
stacks K batches of one video-length bucket into one call of ``make_scan_train_step`` (on a card,
one CUDA-graph replay); a ragged remainder, or a bucket change, goes
through the single step. ``model_id="moment_detr"`` trains MomentDETR
(cfg.model a MomentDETRConfig) through the Moment-DETR steps, step by step
whatever scan_steps says.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from univtg_tpu_torch.data.collate import collate_mr
from univtg_tpu_torch.data.features import save_jsonl
from univtg_tpu_torch.data.loader import Loader
from univtg_tpu_torch.data.mr import MRDataConfig, MRDataset
from univtg_tpu_torch.data.prefetch import device_prefetch, to_device, to_pinned
from univtg_tpu_torch.models.config import ModelConfig
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.models.moment_detr import MomentDETR, MomentDETRConfig
from univtg_tpu_torch.models.univtg import UniVTG
from univtg_tpu_torch.parallel import dist
from univtg_tpu_torch.train import checkpoint as ckpt
from univtg_tpu_torch.train.config_io import snapshot_code, to_json
from univtg_tpu_torch.train.epoch_runner import StepProfiler, run_train_epoch, strip_meta
from univtg_tpu_torch.train.infer_mr import (
    apply_nms,
    evaluate_submission,
    run_inference,
)
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import (
    TrainState,
    make_eval_step,
    make_md_eval_step,
    make_md_train_step,
    make_optimizer,
    make_scan_train_step,
    make_train_step,
    stack_batches,
)
from univtg_tpu_torch.utils.tb import TBWriter

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig, field for field (its comments say what
    each multi-device field does there)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    model_id: str = "univtg"
    saliency_margin: float = 0.2
    train_data: Optional[MRDataConfig] = None
    eval_data: Optional[MRDataConfig] = None
    results_dir: str = "results/run"
    # optimization (defaults = scripts/qvhl_pretrain.sh)
    bsz: int = 32
    eval_bsz: int = 32
    n_epoch: int = 200
    lr: float = 1e-4
    lr_drop: int = 200
    lr_gamma: float = 0.1
    lr_warmup: float = 10
    wd: float = 1e-4
    grad_clip: float = 0.1
    # losses
    weights: LossWeights = dataclasses.field(
        default_factory=lambda: LossWeights(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)
    )
    losses: Sequence[str] = ("spans", "labels", "saliency")
    # eval
    eval_epoch: int = 5
    eval_init: bool = False
    main_metric: str = "MR-full-mAP"
    eval_mode: Optional[str] = "add"
    nms_thd: float = -1.0
    max_before_nms: int = 10
    max_after_nms: int = 10
    round_multiple: int = 1
    max_es_cnt: int = 200
    save_interval: int = 50
    # runtime
    seed: int = 2018
    dp: Optional[int] = None
    tp: int = 1
    ep: int = 1
    pp: int = 1
    pipeline_schedule: str = "gpipe"
    num_io_threads: int = 8
    use_gates: bool = False  # per-sample loss gating (VLP multi-corpus)
    shard_index: int = 0
    num_shards: int = 1
    scan_steps: int = 1
    tensorboard_dir: str = ""
    # host-to-device feature copy: a name of epoch_runner.TRANSFER_DTYPES (compute
    # always runs in ModelConfig.compute_dtype); evaluation batches take
    # transfer_dtype_eval, so a training throughput choice never moves the
    # reported metrics
    transfer_dtype: str = "float32"
    transfer_dtype_eval: str = "float32"
    # batches cast and copied ahead in a background thread; 0 disables
    prefetch_depth: int = 2
    # video-length bucket ladder for training batches (None: pad to max_v_l)
    length_buckets: Optional[Sequence[int]] = None
    # fault injection for elastic multi-process restarts (-1: off)
    inject_fault_epoch: int = -1
    inject_fault_rank: int = 0
    # checkpoint writes in a background thread (checkpoint.AsyncCheckpointer);
    # the copy to the host stays synchronous
    async_checkpoint: bool = True
    profile_dir: str = ""
    profile_steps: int = 5
    sharded_eval: bool = False


def _refuse_unported(cfg: TrainConfig):
    unported = {
        "tp > 1": cfg.tp > 1,
        "pp > 1": cfg.pp > 1,
        "ep > 1": cfg.ep > 1,
    }
    named = [k for k, on in unported.items() if on]
    if named:
        raise NotImplementedError(
            f"train_mr of univtg_tpu_torch does not run {', '.join(named)} "
            f"yet (ROADMAP.md, queue 1)"
        )
    if cfg.model_id not in ("univtg", "moment_detr"):
        raise ValueError(f"unknown model_id {cfg.model_id!r}")
    if cfg.model_id == "moment_detr" and not isinstance(cfg.model, MomentDETRConfig):
        raise ValueError(
            f"model_id='moment_detr' needs cfg.model to be a MomentDETRConfig, "
            f"not a {type(cfg.model).__name__}")


def _place_in_gang(cfg: TrainConfig) -> TrainConfig:
    """cfg with the gang's data shard: ``dp`` must be the world size (None
    means it: one rank per device), and ``num_shards``/``shard_index``
    the world size and the rank (left at 1/0 they are filled in)."""
    world, rank = dist.world(), dist.rank()
    if cfg.dp is not None and cfg.dp != world:
        raise ValueError(
            f"dp={cfg.dp}: univtg_tpu_torch runs one rank per device, so dp is the "
            f"world size ({world}); leave it None")
    if (cfg.num_shards, cfg.shard_index) == (1, 0):
        cfg = dataclasses.replace(cfg, num_shards=world, shard_index=rank)
    if (cfg.num_shards, cfg.shard_index) != (world, rank):
        raise ValueError(
            f"shard {cfg.shard_index} of {cfg.num_shards}: univtg_tpu_torch reads "
            f"one data shard per rank, so num_shards/shard_index must be the world "
            f"size and the rank ({world}/{rank}); train_vlp sets them")
    return cfg


def build_model(cfg: TrainConfig, device="cuda", seed: int = 0):
    """The model of cfg.model_id: MomentDETR or UniVTG, on ``device``."""
    if cfg.model_id == "moment_detr":
        return MomentDETR(cfg.model, device=device, seed=seed)
    return UniVTG(cfg.model, device=device, seed=seed)


def train_mr(cfg: TrainConfig, resume: Optional[str] = None,
             train_dataset=None, resume_all: bool = False,
             device="cuda") -> Tuple[dict, str]:
    """Returns (best_metrics, best_ckpt_path). ``train_dataset`` overrides
    the MRDataset built from cfg.train_data.

    resume semantics follow the reference: ``resume`` alone loads weights
    only; ``resume_all`` also restores the optimizer and continues after the
    saved epoch; resume='auto' picks up results_dir/model_latest.ckpt with
    resume_all semantics; a JAX package checkpoint resumes too (its params,
    optax state and step). ``device`` defaults to CUDA and raises without a
    card; pass device='cpu' to train on the CPU. In a gang every rank calls
    it (the rank's own device, of ``device``'s type)."""
    _refuse_unported(cfg)
    cfg = _place_in_gang(cfg)
    dev = dist.rank_device(device)
    is_main = cfg.shard_index == 0
    os.makedirs(cfg.results_dir, exist_ok=True)
    train_ds = train_dataset if train_dataset is not None else MRDataset(cfg.train_data)
    eval_ds = MRDataset(cfg.eval_data) if cfg.eval_data else None

    train_max_q = cfg.train_data.max_q_l if cfg.train_data else cfg.model.max_q_l
    train_max_v = cfg.train_data.max_v_l if cfg.train_data else cfg.model.max_v_l
    v_buckets = tuple(cfg.length_buckets) if cfg.length_buckets else None
    lengths = None
    if v_buckets and hasattr(train_ds, "feature_lengths"):
        lengths = train_ds.feature_lengths()
    if v_buckets and cfg.num_shards > 1 and lengths is None:
        # each rank would bucket from its own shard's batch max, and the
        # ranks' shapes would diverge
        raise ValueError(
            "length_buckets with num_shards > 1 needs a dataset exposing "
            "feature_lengths(), so every rank computes the same bucket plan")
    train_loader = Loader(
        train_ds,
        cfg.bsz,
        lambda items, pad_batch_to, pad_v_to=None: collate_mr(
            items, train_max_q, train_max_v, pad_batch_to, v_buckets=v_buckets,
            pad_v_to=pad_v_to,
        ),
        shuffle=True,
        seed=cfg.seed,
        num_threads=cfg.num_io_threads,
        shard_index=cfg.shard_index,
        num_shards=cfg.num_shards,
        lengths=lengths,
        plan_shards=bool(v_buckets),
        plan_buckets=v_buckets,
    )
    steps_per_epoch = len(train_loader)
    model = build_model(cfg, dev, cfg.seed)
    schedule = build_schedule(cfg.lr, cfg.lr_warmup, cfg.lr_drop, cfg.lr_gamma,
                              max(steps_per_epoch, 1))
    state = TrainState(model, make_optimizer(model.parameters(), schedule,
                                             cfg.wd, cfg.grad_clip))

    resume_epoch = None
    if resume == "auto":  # elastic restart: pick up the latest checkpoint
        latest = os.path.join(cfg.results_dir, "model_latest.ckpt")
        resume = latest if os.path.exists(latest) else None
        resume_all = True
    if resume:
        if resume_all:
            state, resume_epoch = ckpt.restore_checkpoint(resume, state)
        else:  # weights only
            model.load_state_dict(
                ckpt.restore_params(resume, model.state_dict(), cfg.model), strict=True)
    dist.check_replicated(model, state.optimizer, state.step)

    scan_step = None
    if cfg.model_id == "moment_detr":
        # step by step whatever scan_steps says, as the JAX driver runs it
        span_loss_type = cfg.model.span_loss_type
        train_step = make_md_train_step(cfg.weights, cfg.weights.eos_coef,
                                        cfg.saliency_margin, span_loss_type)
        eval_step = make_md_eval_step(
            span_loss_type, cfg.eval_data.clip_len if cfg.eval_data else 2.0)
    else:
        train_step = make_train_step(cfg.weights, tuple(cfg.losses),
                                     use_gates=cfg.use_gates)
        if cfg.scan_steps > 1:
            scan_step = make_scan_train_step(cfg.weights, tuple(cfg.losses),
                                             use_gates=cfg.use_gates)
        eval_step = make_eval_step(cfg.eval_mode)
    seed = cfg.seed + 1  # the JAX driver's PRNGKey(seed + 1)
    cfg_json = to_json(cfg)
    with open(os.path.join(cfg.results_dir, "opt.json"), "w") as f:
        f.write(cfg_json)
    if is_main:
        snapshot_code(cfg.results_dir)
    tb_dir = cfg.tensorboard_dir
    if tb_dir == "auto":
        tb_dir = os.path.join(cfg.results_dir, "tb")
    gang = dist.world() > 1

    best_score, best_metrics, es_cnt = -np.inf, None, 0
    best_path = os.path.join(cfg.results_dir, "model_best.ckpt")
    latest_path = os.path.join(cfg.results_dir, "model_latest.ckpt")
    start_epoch = -1 if cfg.eval_init else 0
    if resume_epoch is not None:
        start_epoch = resume_epoch + 1
    # every write has landed when the block is left (a writer's error raises)
    with ckpt.checkpoint_writer(cfg.async_checkpoint) as saver, \
            open(os.path.join(cfg.results_dir, "train_log.jsonl"), "a") as train_log, \
            open(os.path.join(cfg.results_dir, "eval_log.jsonl"), "a") as eval_log, \
            TBWriter(tb_dir if is_main else "") as tb, \
            StepProfiler(cfg.profile_dir, cfg.profile_steps, enabled=is_main) as profiler:
        for epoch in range(start_epoch, cfg.n_epoch):
            if epoch > -1:
                if epoch == max(start_epoch, 0):
                    # one profiler window per run, over the first
                    # profile_steps steps of the first trained epoch
                    profiler.start()
                line = _train_one_epoch(cfg, epoch, train_loader, train_step, scan_step,
                                        state, seed, dev, train_log, profiler)
                profiler.stop()  # short epoch: close the trace at epoch end
                tb.scalars(line, epoch, prefix="train/")
                if (epoch == cfg.inject_fault_epoch
                        and cfg.shard_index == cfg.inject_fault_rank):
                    # a simulated crash: no cleanup, no checkpoint, as a
                    # killed member of a gang looks to its peers; the write
                    # in flight lands first, for the restart to read
                    saver.wait()
                    logger.warning(f"inject_fault: hard exit at epoch {epoch}")
                    os._exit(3)
            stop = False
            if eval_ds is not None and (epoch + 1) % cfg.eval_epoch == 0:
                metrics = None
                if cfg.sharded_eval and gang:
                    # every rank scores its shard; rank 0 merges
                    metrics = _eval_once_sharded(cfg, model, eval_ds, eval_step, epoch)
                if is_main:
                    if metrics is None:
                        metrics = _eval_once(cfg, model, eval_ds, eval_step, epoch)
                    eval_log.write(json.dumps({"epoch": epoch, **metrics["brief"]}) + "\n")
                    eval_log.flush()
                    tb.scalars(metrics["brief"], epoch, prefix="eval/")
                    score = metrics["brief"].get(f"{cfg.main_metric}-key")
                    if score is None:
                        score = metrics["brief"].get(cfg.main_metric)
                    saver.save(latest_path, state, epoch, cfg_json)
                    if score is not None and score > best_score:
                        best_score, best_metrics, es_cnt = score, metrics, 0
                        saver.save(best_path, state, epoch, cfg_json)
                    else:
                        es_cnt += 1
                        stop = 0 <= cfg.max_es_cnt <= es_cnt
                # rank 0's decision reaches every rank: a rank that left the
                # loop alone would leave the others waiting in the next step
                stop = dist.broadcast_flag(stop)
            if stop:
                saver.wait()
                logger.info("early stop")
                break
            if (is_main and cfg.save_interval > 0 and epoch > 0
                    and epoch % cfg.save_interval == 0):
                saver.save(os.path.join(cfg.results_dir, f"model_e{epoch:04d}.ckpt"),
                           state, epoch, cfg_json)

        # no evaluation picked a best checkpoint: the final state is the best.
        # best_metrics is rank 0's to know, so its decision is broadcast
        if dist.broadcast_flag(best_metrics is None) and is_main:
            saver.save(best_path, state, cfg.n_epoch - 1, cfg_json)
    return best_metrics or {}, best_path


def _train_one_epoch(cfg, epoch, train_loader, train_step, scan_step, state, seed,
                     dev, train_log, profiler):
    """One training epoch (the state is updated in place); returns its line
    of train_log.jsonl, written there."""
    train_loader.set_epoch(epoch)
    t0 = time.time()
    # metrics stay on the card until the epoch ends: no host sync per step
    # (but the one that closes the profiler window); scan groups record (K,)
    # tensors, and the epoch means are over steps, the reference's
    # AverageMeter
    step_metrics = []
    n_steps = 0

    def record(metrics):
        nonlocal n_steps
        step_metrics.append(metrics)
        n_steps += metrics["loss_overall"].numel()
        profiler.after_step(n_steps, metrics)

    if scan_step is None:
        run_train_epoch(
            train_loader, train_step, state, seed, dev,
            transfer_dtype=cfg.transfer_dtype,
            prefetch_depth=cfg.prefetch_depth,
            record=record,
        )
    else:
        _run_scan_epoch(cfg, train_loader, train_step, scan_step, state, seed, dev,
                        record)
    means = {}
    if step_metrics:
        stacked = {k: torch.cat([m[k].reshape(-1) for m in step_metrics])
                   for k in step_metrics[0]}
        means = {k: float(v.float().mean()) for k, v in stacked.items()}
    line = {"epoch": epoch, "time": time.time() - t0, "steps": n_steps, **means}
    train_log.write(json.dumps(line) + "\n")
    train_log.flush()
    logger.info(f"epoch {epoch}: {line}")
    return line


def _scan_groups(loader, K: int):
    """The JAX driver's grouping: batches of one video-length bucket in
    groups of K; a bucket change flushes the pending batches, and the
    epoch's remainder, one by one (groups of 1)."""

    def vlen(batch):
        return batch["model_inputs"]["src_vid"].shape[1]

    pending = []
    for batch in loader:
        if pending and vlen(batch) != vlen(pending[0]):
            yield from ([b] for b in pending)
            pending = []
        pending.append(batch)
        if len(pending) == K:
            yield pending
            pending = []
    yield from ([b] for b in pending)


def _run_scan_epoch(cfg, train_loader, train_step, scan_step, state, seed, dev,
                    record):
    """The scan loop: each group of cfg.scan_steps batches goes to the scan
    step, stacked and pinned (on a card) in the prefetch thread; a group of
    one goes to the single step, cast and copied there."""

    def prep(group):
        if len(group) == cfg.scan_steps:
            smi, stg = stack_batches(group, cfg.transfer_dtype)
            return scan_step, to_pinned(smi, dev), to_pinned(stg, dev)
        mi, tg = strip_meta(group[0], cfg.transfer_dtype)
        return train_step, to_device(mi, dev), to_device(tg, dev)

    for step, mi, tg in device_prefetch(_scan_groups(train_loader, cfg.scan_steps),
                                        prep, cfg.prefetch_depth):
        record(step(state, mi, tg, seed)[1])


def _eval_loader(cfg, eval_ds):
    """The eval split in order, collated to the eval data's caps."""
    return Loader(
        eval_ds,
        cfg.eval_bsz,
        lambda items, pad_batch_to: collate_mr(
            items, cfg.eval_data.max_q_l, cfg.eval_data.max_v_l, pad_batch_to
        ),
        shuffle=False,
        num_threads=cfg.num_io_threads,
    )


class _EvalShard:
    """Stride-slice view of a dataset: items shard_index, shard_index + S,
    ... including the remainder (the training shards drop it so every rank
    takes as many steps; evaluation must score every item once)."""

    def __init__(self, ds, shard_index: int, num_shards: int):
        self.ds = ds
        self.idx = list(range(shard_index, len(ds), num_shards))

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[self.idx[i]]


def _run_eval_shard(cfg, model, eval_ds, eval_step, shard_index=0, num_shards=1):
    """Inference over one stride shard of the eval set (by default the
    whole set) on the model's device."""
    if num_shards > 1:
        eval_ds = _EvalShard(eval_ds, shard_index, num_shards)
    return run_inference(
        model,
        _eval_loader(cfg, eval_ds),
        eval_mode=cfg.eval_mode,
        clip_length=cfg.eval_data.clip_len,
        round_multiple=cfg.round_multiple,
        eval_step=eval_step,
        transfer_dtype=cfg.transfer_dtype_eval,
    )


def _finish_eval(cfg, submission, eval_ds, epoch):
    """Persist the predictions, score them, re-score after NMS when
    nms_thd > 0, and write the metrics json."""
    save_jsonl(submission, os.path.join(cfg.results_dir, "latest_val_preds.jsonl"))
    metrics = evaluate_submission(submission, eval_ds.data)
    if cfg.nms_thd > 0:
        nms_sub = apply_nms(
            submission, cfg.nms_thd, cfg.max_before_nms, cfg.max_after_nms
        )
        metrics["nms_brief"] = evaluate_submission(nms_sub, eval_ds.data)["brief"]
    with open(
        os.path.join(cfg.results_dir, f"metrics_e{max(epoch, 0):04d}.json"), "w"
    ) as f:
        json.dump(metrics, f, indent=1)
    return metrics


def _eval_once(cfg, model, eval_ds, eval_step, epoch):
    submission = _run_eval_shard(cfg, model, eval_ds, eval_step)
    return _finish_eval(cfg, submission, eval_ds, epoch)


def _eval_once_sharded(cfg, model, eval_ds, eval_step, epoch):
    """Evaluation spread over a gang: every rank scores its stride shard on
    its own device, the submissions are all-gathered, and rank 0 merges
    them back into dataset order and scores them (the JAX driver's
    ``_eval_once_sharded``). A collective: every rank calls it; the metrics
    on rank 0, None elsewhere. Every rank checks the merge, so a shard that
    went missing raises on all of them, not on rank 0 alone."""
    sub_local = _run_eval_shard(cfg, model, eval_ds, eval_step,
                                cfg.shard_index, cfg.num_shards)
    by_qid = {}
    for blob in dist.all_gather_bytes(json.dumps(sub_local).encode()):
        for row in json.loads(blob):
            by_qid[row["qid"]] = row
    submission = [by_qid[m["qid"]] for m in eval_ds.data if m["qid"] in by_qid]
    if len(submission) != len(eval_ds.data):
        missing = {m["qid"] for m in eval_ds.data} - set(by_qid)
        raise RuntimeError(
            f"sharded eval covered {len(submission)}/{len(eval_ds.data)} "
            f"queries; {len(missing)} missing (e.g. {sorted(missing)[:5]}): a "
            f"rank dropped part of its shard")
    if len(submission) != len(by_qid):
        raise RuntimeError("sharded eval gathered qids that are not in the eval "
                           "metadata: the ranks' shard views are out of step")
    if cfg.shard_index != 0:
        return None
    return _finish_eval(cfg, submission, eval_ds, epoch)
