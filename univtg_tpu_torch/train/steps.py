"""The train and eval steps and the device-side decode; counterpart of
``univtg_tpu/train/steps.py`` (``make_optimizer``, ``TrainState``,
``step_dropout_rngs``, ``dequantize_inputs``, ``forward``,
``make_train_step``, ``make_eval_step``, ``decode_dense_outputs``).

PyTorch runs eagerly, so the train step is a plain function over a mutable
``TrainState``: forward in train mode, ``compute_losses``, backward, the
global-norm clip and AdamW, with every metric left on the device (no host
sync per step). The eval step is the forward in eval mode and the dense
decode, under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from univtg_tpu_torch.models.losses import LossWeights, compute_losses


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element squared (f32)."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


class ClippedAdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(schedule, b1=0.9,
    b2=0.999, eps=1e-8, weight_decay))`` over a model's parameters.

    ``step(count)`` clips the gradients in place with optax's formula
    (``g / norm * max_norm`` when ``norm >= max_norm``; torch's
    ``clip_grad_norm_`` adds 1e-6 to the norm instead), sets the rate to
    ``schedule(count)`` -- optax reads the schedule at the count before the
    increment -- and takes one AdamW step. Every parameter decays, biases
    and LayerNorms included: one parameter group, as optax.adamw does.
    Returns the unclipped global norm, on the device.
    """

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, grad_clip: float = 0.1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.adamw = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, count: int) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        if self.grad_clip > 0:
            keep = norm < self.grad_clip
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.grad_clip))
        for group in self.adamw.param_groups:
            group["lr"] = float(self.schedule(count))
        self.adamw.step()
        return norm

    def state_dict(self):
        return self.adamw.state_dict()

    def load_state_dict(self, state):
        self.adamw.load_state_dict(state)


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


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's dropout/droppath generator, on ``device``, seeded from
    (seed, step): a resumed run draws the same masks. Counterpart of
    ``step_dropout_rngs`` (its bits differ: torch's generator is not the
    TPU's)."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    s = (int(state[0]) << 32 | int(state[1])) & 0x7FFFFFFFFFFFFFFF
    return torch.Generator(device=device).manual_seed(s)


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

    def step(state: TrainState, model_inputs, targets, seed: int):
        model = state.model
        device = next(model.parameters()).device
        if static_inputs:
            model_inputs = {**model_inputs, **static_inputs}
        model.train()
        outputs = forward(model, model_inputs, train=True,
                          generator=step_generator(seed, state.step, device))
        gates = targets.get("gates") if use_gates else None
        loss_dict = compute_losses(outputs, targets, weights, losses, gates)
        state.optimizer.zero_grad()
        loss_dict["loss_overall"].backward()
        grad_norm = state.optimizer.step(state.step)
        state.step += 1
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["grad_norm"] = grad_norm
        return state, metrics

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
