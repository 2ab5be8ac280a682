"""The train and eval steps and the device-side decode; counterpart of
``univtg_tpu/train/steps.py`` (``make_optimizer``, ``TrainState``,
``step_dropout_rngs``, ``dequantize_inputs``, ``forward``,
``make_train_step``, ``make_scan_train_step``, ``stack_batches``,
``make_md_train_step``, ``make_md_eval_step``, ``make_eval_step``,
``decode_dense_outputs``).

PyTorch runs eagerly, so the train step is a plain function over a mutable
``TrainState``: forward in train mode, ``compute_losses``, backward, the
global-norm clip and AdamW, with every metric left on the device (no host
sync per step). The scan step runs K of them per call, on a card as one
CUDA-graph replay (``ScanTrainStep``). The eval step is the forward in eval
mode and the dense decode, under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from univtg_tpu_torch.core.spans import cxw_to_xx
from univtg_tpu_torch.device import exact_f32
from univtg_tpu_torch.models.losses import LossWeights, compute_losses
from univtg_tpu_torch.parallel import dist
from univtg_tpu_torch.train.epoch_runner import strip_meta


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element squared (f32)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class ClippedAdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(schedule, b1=0.9,
    b2=0.999, eps=1e-8, weight_decay))`` over a model's parameters.

    ``step(count)`` gives every parameter without a gradient a zero one
    (optax decays every parameter; torch's AdamW skips a ``.grad`` of None,
    e.g. the span head under HL's losses), clips the gradients in place
    with optax's formula (``g / norm * max_norm`` when ``norm >=
    max_norm``; torch's ``clip_grad_norm_`` adds 1e-6 to the norm instead),
    sets the rate to ``schedule(count)`` -- optax reads the schedule at the
    count before the increment -- and takes one AdamW step. Every parameter
    decays, biases and LayerNorms included: one parameter group, as
    optax.adamw does. Returns the unclipped global norm, on the device.

    On a card AdamW is ``capturable`` and its rate a device tensor, so the
    step can be captured in a CUDA graph (``make_scan_train_step``);
    ``step_with_lr(lr)`` takes the rate as such a tensor.
    """

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, grad_clip: float = 0.1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.capturable = bool(self.params) and self.params[0].is_cuda
        lr = float(schedule(0))
        if self.capturable:
            lr = torch.tensor(lr, dtype=torch.float32, device=self.params[0].device)
        self.lr = lr
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay, capturable=self.capturable,
        )

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, count: int) -> torch.Tensor:
        if self.capturable:
            self.lr.fill_(float(self.schedule(count)))
        else:
            self.lr = float(self.schedule(count))
        return self.step_with_lr(self.lr)

    @torch.no_grad()
    def step_with_lr(self, lr) -> torch.Tensor:
        """The zero fill, the clip and one AdamW step at rate ``lr`` (a
        float, or on a card a one-element f32 device tensor)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.grad_clip > 0:
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        return norm

    def state_dict(self):
        state = self.adamw.state_dict()
        for group in state["param_groups"]:  # a plain rate in the file
            group["lr"] = float(group["lr"])
        return state

    def load_state_dict(self, state):
        """torch's AdamW takes ``capturable`` and ``lr`` from the file's
        param groups; this optimizer keeps its own (a file written on the
        CPU resumes on a card and the other way round)."""
        state = {**state, "param_groups": [
            {**g, "capturable": self.capturable} for g in state["param_groups"]]}
        self.adamw.load_state_dict(state)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr


def make_optimizer(params, schedule, weight_decay=1e-4, grad_clip=0.1):
    """AdamW + global-norm clip (the reference clips before each step with
    max_norm=grad_clip)."""
    return ClippedAdamW(params, schedule, weight_decay, grad_clip)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer and the step counter."""

    model: torch.nn.Module
    optimizer: ClippedAdamW
    step: int = 0


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The 63-bit generator seed of (seed, step), and of the rank in a gang
    (rank 0 keeps the one-process seed)."""
    entropy = [int(seed), int(step)] + ([int(rank)] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(2)
    return (int(state[0]) << 32 | int(state[1])) & 0x7FFFFFFFFFFFFFFF


def step_generator(seed: int, step: int, device, rank: int = 0) -> torch.Generator:
    """The step's dropout/droppath generator, on ``device``, seeded from
    (seed, step, rank): a resumed run draws the same masks, and no two ranks
    of a gang draw the same. Counterpart of ``step_dropout_rngs`` (its bits
    differ: torch's generator is not the TPU's, and JAX draws the global
    batch's masks from one key)."""
    return torch.Generator(device=device).manual_seed(step_seed(seed, step, rank))


def dequantize_inputs(model_inputs):
    """Float features back from the (int8 ``*_q``, per-token ``*_scale``)
    pairs of data/collate.quantize_for_transfer (transfer_dtype='int8'), on
    the device; float batches pass through."""
    mi = dict(model_inputs)
    for key in ("src_txt", "src_vid"):
        q = mi.pop(key + "_q", None)
        if q is not None:
            scale = mi.pop(key + "_scale")
            mi[key] = q.to(scale.dtype) * scale[..., None]
    return mi


def forward(model, model_inputs, *, train=False, generator=None):
    model_inputs = dequantize_inputs(model_inputs)
    args = [
        model_inputs["src_txt"],
        model_inputs["src_txt_mask"],
        model_inputs["src_vid"],
        model_inputs["src_vid_mask"],
    ]
    if model_inputs.get("src_cls") is not None:
        args += [model_inputs["src_cls"], model_inputs["src_cls_mask"]]
    return model(*args, train=train, generator=generator)


def _dense_losses(weights, losses, use_gates):
    """(outputs, targets) -> compute_losses' dict, loss_overall included."""

    def loss_fn(outputs, targets):
        gates = targets.get("gates") if use_gates else None
        return compute_losses(outputs, targets, weights, losses, gates)

    return loss_fn


def _train_body(state: TrainState, model_inputs, targets, generator, update,
                loss_fn, static_inputs=None):
    """Forward in train mode, ``loss_fn(outputs, targets)`` (a dict holding
    loss_overall), backward and ``update()`` (the optimizer step, returning
    the global norm); returns the metrics.

    In a gang (parallel/dist.py) the loss is the global batch's, as in the
    JAX package's SPMD step: the outputs and targets of every rank are
    gathered in rank order, this rank's own slice live
    (``dist.gather_batch``), so each rank's backward gives the global loss's
    gradient through its own samples; their sum over the ranks
    (``dist.all_reduce_grads``) is the global gradient, and the clip and
    AdamW that follow come out the same on every rank. Any ``loss_fn``
    (dense, gated, Moment-DETR) is exact this way: the InfoNCE over the
    batch, the batch-wide normalisers and ``has_signal`` all see the
    global batch."""
    if static_inputs:
        model_inputs = {**model_inputs, **static_inputs}
    state.model.train()
    outputs = forward(state.model, model_inputs, train=True, generator=generator)
    if dist.active() is not None:
        B = model_inputs["src_vid_mask"].shape[0]
        outputs = dist.gather_batch(
            outputs, B, replicated=("cls_mem_proj",) if static_inputs else ())
        targets = dist.gather_batch(targets, B)
    loss_dict = loss_fn(outputs, targets)
    state.optimizer.zero_grad()
    with exact_f32(state.model.cfg.dtype):  # the conv heads' backward in f32
        loss_dict["loss_overall"].backward()
    dist.all_reduce_grads(state.model.parameters())
    metrics = {k: v.detach() for k, v in loss_dict.items()}
    metrics["grad_norm"] = update()
    return metrics


def make_train_step(weights: LossWeights,
                    losses: Sequence[str] = ("spans", "labels", "saliency"),
                    use_gates: bool = False, static_inputs=None):
    """Returns (state, model_inputs, targets, seed) -> (state, metrics).

    metrics: every ``loss_*``, ``loss_overall`` and ``grad_norm`` (the
    global norm of the unclipped gradients), as device scalars. The state
    is updated in place and returned. static_inputs: extra model inputs
    constant across steps (the class-feature bank {src_cls, src_cls_mask}
    of TAL-style pretraining).
    """

    return _single_step(_dense_losses(weights, losses, use_gates), static_inputs)


def _single_step(loss_fn, static_inputs=None):
    """(state, model_inputs, targets, seed) -> (state, metrics): one
    ``_train_body`` on the step's generator and the scheduled rate."""

    def step(state: TrainState, model_inputs, targets, seed: int):
        device = next(state.model.parameters()).device
        dist.check_same(dist.shape_signature(model_inputs, targets),
                        "the shapes of the step's batch")
        metrics = _train_body(
            state, model_inputs, targets,
            step_generator(seed, state.step, device, dist.rank()),
            lambda: state.optimizer.step(state.step), loss_fn, static_inputs)
        state.step += 1
        return state, metrics

    return step


def stack_batches(batches, transfer_dtype: str = "float32"):
    """K collated batches -> (model_inputs, targets) CPU tensors with a
    leading K axis, meta dropped, each batch cast as ``strip_meta`` casts
    it for the single step (JAX ``stack_batches``)."""
    pairs = [strip_meta(b, transfer_dtype) for b in batches]

    def stack(trees):
        return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}

    return stack([mi for mi, _ in pairs]), stack([tg for _, tg in pairs])


def _replay_counters():
    """The kernel launch and attention dispatch counts, which the wrappers
    add to in Python: at a graph's capture, not at its replays."""
    from univtg_tpu_torch.ops import attention, flash_attention, int8_matmul
    from univtg_tpu_torch.ops import ring_attention_pallas

    return (attention.dispatches, flash_attention.launches, int8_matmul.launches,
            ring_attention_pallas.launches)


def _shapes(tree):
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(tree.items()))


class _Group:
    """One key's static (K, ...) input buffers, its (K,) rates, and, once
    captured, its graph, the graph's (K,) metrics and what its capture
    counted."""

    def __init__(self, stacked_mi, stacked_tg, K, device):
        def buffers(tree):
            return {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                    for k, v in tree.items()}

        self.mi, self.tg = buffers(stacked_mi), buffers(stacked_tg)
        self.lr = torch.empty(K, dtype=torch.float32, device=device)
        self.graph = None
        self.metrics = None
        self.counts = None


class ScanTrainStep:
    """K training steps per call over K stacked batches; the counterpart of
    JAX ``make_scan_train_step`` (``lax.scan``, one dispatch per K steps).

    (state, stacked_model_inputs, stacked_targets, seed) -> (state,
    stacked_metrics): the inputs carry a leading K axis (``stack_batches``),
    every metric too (``grad_norm`` included, which JAX's scan drops).

    On the CPU the K single steps of ``make_train_step`` run in order, with
    the same bits. On a card there is one ``torch.cuda.CUDAGraph`` per key
    (K, the attention impl and the shapes and dtypes of the stacked
    inputs), all in one memory pool, capturing K steps (forward, losses,
    backward, zero fill, clip, AdamW) over static (K, ...) buffers that each
    call fills by ``copy_`` from pinned memory: one ``replay()`` per K
    steps. A key's first call runs the same K steps eagerly on the capture
    stream (cuBLAS, the kernels' libraries and their attributes, AdamW's
    state come into being there); its second call captures and replays. A
    failed capture or replay raises. Dropout draws from one CUDA generator
    registered with every graph, seeded before every call from (seed, the step
    at the group's start), so a resumed run draws the same masks; its bits
    differ from the single step's. Each step ``k`` reads its rate from a
    (K,) device buffer filled from ``schedule(step + k)``. The launch and
    dispatch counters count once per replay what the capture counted. A
    graph holds the addresses of the parameters, gradients and AdamW state
    of the state it captured, so one ScanTrainStep serves one TrainState,
    loaded before the first call. Under an active ring (``"ring"``,
    ``"ring_pallas"``) whose ranks share one card the graph holds the ring
    too: the ranks' streams are made before the capture, and each ring call
    forks them from the capture stream and joins them back through events
    (ops/ring_attention_pallas.py), so its launches, hops and the plain
    ring's backward are captured with the step; the ring's size is part of
    the key. A ring across cards raises (``RingGroup.check_capturable``). In a gang
    (parallel/dist.py) each step is the global-batch step of
    ``_train_body``: on the CPU the K steps run in order; on a card under
    NCCL the graph captures their all-gathers and all-reduces with them;
    under gloo on a card it raises (``dist.check_capturable``).
    """

    def __init__(self, weights, losses, use_gates):
        self.loss_fn = _dense_losses(weights, tuple(losses), use_gates)
        self.single = _single_step(self.loss_fn)
        self.groups = {}
        self.stream = self.pool = self.generator = None

    def __call__(self, state: TrainState, stacked_mi, stacked_tg, seed: int):
        from univtg_tpu_torch.parallel.ring import active_ring

        impl = state.model.cfg.attention_impl
        ring = active_ring() if impl in ("ring", "ring_pallas") else None
        if ring is not None:
            ring.check_capturable()
        K = int(next(iter(stacked_mi.values())).shape[0])
        device = next(state.model.parameters()).device
        dist.check_capturable(device)
        dist.check_same(dist.shape_signature(stacked_mi, stacked_tg),
                        "the shapes of the scan step's batches")
        if device.type != "cuda":
            per_step = []
            for i in range(K):
                state, m = self.single(state, {k: v[i] for k, v in stacked_mi.items()},
                                       {k: v[i] for k, v in stacked_tg.items()}, seed)
                per_step.append(m)
            return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}
        return state, self._on_card(state, stacked_mi, stacked_tg, seed, K, impl, ring,
                                    device)

    def _steps(self, state, group, K):
        """The K steps over the group's buffers (eager, or under capture)."""
        per_step = []
        for i in range(K):
            lr = group.lr[i]
            per_step.append(_train_body(
                state, {k: v[i] for k, v in group.mi.items()},
                {k: v[i] for k, v in group.tg.items()}, self.generator,
                lambda: state.optimizer.step_with_lr(lr), self.loss_fn))
        return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    def _on_card(self, state, stacked_mi, stacked_tg, seed, K, impl, ring, device):
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
            self.pool = torch.cuda.graph_pool_handle()
            self.generator = torch.Generator(device=device)
        if ring is not None:
            # the ranks' streams exist before any capture: a graph forks them
            # from the capture stream and joins them back, call by call
            ring.make_streams()
        key = (K, impl, ring and (ring.size, ring.devices), _shapes(stacked_mi),
               _shapes(stacked_tg))
        group = self.groups.get(key)
        first = group is None
        if first:
            group = self.groups[key] = _Group(stacked_mi, stacked_tg, K, device)
        rates = torch.tensor([float(state.optimizer.schedule(state.step + i))
                              for i in range(K)], dtype=torch.float32)
        for dst, src in ((group.mi, stacked_mi), (group.tg, stacked_tg)):
            for k, v in src.items():
                if not (v.is_cuda or v.is_pinned()):
                    v = v.pin_memory()
                dst[k].copy_(v, non_blocking=True)
        group.lr.copy_(rates.pin_memory(), non_blocking=True)
        current = torch.cuda.current_stream(device)
        if first:
            self.generator.manual_seed(step_seed(seed, state.step, dist.rank()))
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                metrics = self._steps(state, group, K)
            current.wait_stream(self.stream)
        else:
            if group.graph is None:
                self._capture(state, group, K)
            self.generator.manual_seed(step_seed(seed, state.step, dist.rank()))
            group.graph.replay()
            for counts, made in zip(_replay_counters(), group.counts):
                for name, n in made.items():
                    counts[name] += n
            metrics = {k: v.clone() for k, v in group.metrics.items()}
        state.step += K
        return metrics

    def _capture(self, state, group, K):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = [dict(c) for c in _replay_counters()]
        # thread_local: the driver's prefetch thread pins and copies the next
        # batches meanwhile, which a global capture would count against it
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            group.metrics = self._steps(state, group, K)
        # the capture ran no kernel: its counts come back at each replay
        group.counts = []
        for counts, was in zip(_replay_counters(), before):
            group.counts.append({k: counts[k] - was[k] for k in counts})
            counts.update(was)
        group.graph = graph


def make_scan_train_step(weights: LossWeights,
                         losses: Sequence[str] = ("spans", "labels", "saliency"),
                         use_gates: bool = False) -> ScanTrainStep:
    """K same-shape training steps per call (``ScanTrainStep``)."""
    return ScanTrainStep(weights, losses, use_gates)


def make_md_train_step(weights: LossWeights, eos_coef: float = 0.1,
                       saliency_margin: float = 0.2, span_loss_type: str = "l1"):
    """The Moment-DETR train step: Hungarian matching and the matched losses
    (models/moment_detr.moment_detr_losses); each aux decoder layer's term
    ``{k}_{i}`` takes the weight of ``k``, and a loss that
    ``weights.as_dict()`` does not name (loss_contrastive_align) weighs 0,
    as in the JAX package. Same signature and metrics as make_train_step."""
    from univtg_tpu_torch.models.moment_detr import moment_detr_losses

    wd = weights.as_dict()

    def loss_fn(outputs, targets):
        ld = moment_detr_losses(outputs, targets, eos_coef=eos_coef,
                                saliency_margin=saliency_margin,
                                span_loss_type=span_loss_type)
        ld["loss_overall"] = sum(wd.get(re.sub(r"_\d+$", "", k), 0.0) * v
                                 for k, v in ld.items())
        return ld

    return _single_step(loss_fn)


def make_md_eval_step(span_loss_type: str = "l1", clip_length: float = 2.0):
    """The Moment-DETR decode, as make_eval_step's: 'l1' -> per-query
    softmax foreground probability and cxw -> xx normalized spans; 'ce' ->
    argmax start/end clip indices -> absolute seconds (``absolute_spans``),
    scores the product of the st/ed max probabilities."""

    @torch.inference_mode()
    def step(model, model_inputs, targets):
        model.eval()
        outputs = forward(model, model_inputs, train=False)
        saliency = outputs["saliency_scores"].half().float()
        spans = outputs["pred_spans"]
        if span_loss_type == "ce":
            B, Q, two_l = spans.shape
            sp = torch.softmax(spans.reshape(B, Q, 2, two_l // 2), dim=-1)
            top, idx = sp.max(dim=-1)  # (B, Q, 2)
            scores = top.prod(dim=-1)
            # the end index is inclusive: + 1 clip
            end = torch.tensor([0.0, 1.0], device=spans.device)
            spans = (idx.float() + end) * clip_length
        else:
            scores = torch.softmax(outputs["pred_logits"], dim=-1)[..., 0]
            spans = cxw_to_xx(spans)
        return {
            "scores": scores,
            "spans": spans,
            "saliency": saliency,
            "valid_len": model_inputs["src_vid_mask"].sum(dim=1).to(torch.int32),
            "absolute_spans": span_loss_type == "ce",
        }

    return step


def make_eval_step(eval_mode: Optional[str] = "add"):
    """Returns (model, model_inputs, targets) -> the decoded tensors of
    decode_dense_outputs, on the device; the host only sorts and rounds per
    query (train/infer_mr.py:decode_batch)."""

    @torch.inference_mode()
    def step(model, model_inputs, targets):
        model.eval()
        outputs = forward(model, model_inputs, train=False)
        return decode_dense_outputs(outputs, model_inputs["src_vid_mask"],
                                    targets["timestamp"], eval_mode)

    return step


def decode_dense_outputs(outputs, vid_mask, timestamp,
                         eval_mode: Optional[str]):
    """THE dense-regression decode shared by serving and batch evaluation:
      spans    = timestamp + predicted offsets       (normalized units)
      scores   = foreground probability, zeroed outside the valid length
      saliency = fp16-quantized saliency (parity with the reference's
                 .half() cast) (+ fg prob when eval_mode == 'add')
    """
    prob = outputs["pred_logits"][..., 0]  # (B, Lv) sigmoid probs
    scores = prob * vid_mask
    spans = timestamp + outputs["pred_spans"]
    saliency = outputs["saliency_scores"].half().float()
    if eval_mode == "add":
        saliency = saliency + prob
    return {
        "scores": scores,
        "spans": spans,
        "saliency": saliency,
        "valid_len": vid_mask.sum(dim=1).to(torch.int32),
    }
