"""The 1F1B-pipelined train step of the UniVTG flagship; counterpart of
``univtg_tpu/train/steps_1f1b.py`` (``make_1f1b_train_step``).

It composes the model's three phases around the 1F1B engine
(parallel/pipeline_1f1b.py):

  * ``pre`` (input projections, token types, positions) runs on every
    stage under plain autograd, with the step's generator (the same bits on
    every stage of a dp row);
  * the encoder's layers run inside the engine, each stage its own, with the
    one-forward-one-backward schedule whose saved activations are O(pp)
    chunk inputs whatever the microbatch count M;
  * the heads and the loss run in the last chunk's backward, per
    (microbatch x dp shard) block, so the loss is the mean of the block
    losses (the reference's DDP locality for its normalised and contrastive
    terms, main/train_vlp_ddp.py:272-275), not the global batch's: the
    global-batch rule of train/steps.py is off here, as in the JAX package.

The blocks hold JAX's rows: the step's inputs and targets are exchanged
over dp first (``pipeline.exchange_blocks``). After the engine the head
gradients and the cotangents of the encoder input, the positions, the
pre-encoder tokens and the TAL class bank are summed over pp and go back
through ``pre``; every gradient is then summed over dp, and AdamW with the
global-norm clip follows (the norm of the pp-split gradient: the layers
once per stage, the replicated parameters weighed 1 / pp).
"""
from __future__ import annotations

from typing import Sequence

import torch

from univtg_tpu_torch.device import exact_f32
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.parallel import dist
from univtg_tpu_torch.parallel import mesh as pm
from univtg_tpu_torch.parallel import pipeline as pipe
from univtg_tpu_torch.parallel.pipeline_1f1b import pipeline_1f1b
from univtg_tpu_torch.train.steps import (
    TrainState,
    _dense_losses,
    data_rank,
    dequantize_inputs,
    step_generator,
)


def check_1f1b(cfg, n_micro: int = 0) -> int:
    """Raise ValueError where the config cannot run 1F1B (JAX's
    requirements); returns the microbatch count M."""
    if not cfg.scan_layers:
        raise ValueError(
            "make_1f1b_train_step needs cfg.scan_layers=True (the engine "
            "shards the stacked encoder/layers/layer parameter layout)")
    if cfg.pre_norm:
        raise ValueError(
            "make_1f1b_train_step supports post-norm encoders only (a "
            "pre-norm final LayerNorm is not part of the staged layer stack)")
    if cfg.pipeline_pre_permuted and cfg.pipeline_interleave <= 1:
        raise ValueError(
            "pipeline_pre_permuted without pipeline_interleave > 1 is "
            "meaningless (device-major == canonical order at v=1)")
    M = n_micro or cfg.pipeline_microbatches or cfg.pipeline_stages
    if M < 1:
        raise ValueError(
            "set n_micro (or cfg.pipeline_microbatches/pipeline_stages) to "
            "the microbatch count")
    return M


def make_1f1b_train_step(weights: LossWeights,
                         losses: Sequence[str] = ("spans", "labels", "saliency"),
                         use_gates: bool = False, n_micro: int = 0, static_inputs=None):
    """Returns (state, model_inputs, targets, seed) -> (state, metrics), as
    ``make_train_step``, running the encoder of ``state.model`` (put on a
    mesh with a pp axis, parallel/mesh.shard_model) under the 1F1B
    schedule. n_micro: M (0 -> cfg.pipeline_microbatches or
    cfg.pipeline_stages). static_inputs: the TAL class bank {src_cls,
    src_cls_mask}, which rides with the heads. metrics: every loss term
    (the mean over the blocks), loss_moe_aux for a MoE model (the mean over
    layers x microbatches x dp shards, added to loss_overall with
    weights.moe_aux), and grad_norm (unclipped)."""
    loss_fn = _dense_losses(weights, tuple(losses), use_gates)
    names = []

    def step(state: TrainState, model_inputs, targets, seed: int):
        model = state.model
        cfg = model.cfg
        M = check_1f1b(cfg, n_micro)
        enc = model.transformer.encoder
        if not enc.pipelined:
            raise ValueError(
                "pipeline_1f1b needs a model on a mesh with a 'pp' axis (use "
                "parallel.mesh.shard_model(model, make_mesh(..., pp=N)))")
        mesh = enc.mesh
        dist.check_same(dist.shape_signature(model_inputs, targets),
                        "the shapes of the step's batch")
        device = next(model.parameters()).device
        generator = step_generator(seed, state.step, device, data_rank(model))
        B = model_inputs["src_vid_mask"].shape[0]
        model_inputs, _ = pipe.exchange_blocks(model_inputs, mesh, M, B)
        targets, _ = pipe.exchange_blocks(targets, mesh, M, B)
        mi = dequantize_inputs({**model_inputs, **(static_inputs or {})})
        cls_mask = mi.get("src_cls_mask")
        model.train()
        state.optimizer.zero_grad()
        with exact_f32(cfg.dtype):
            src, mask, pos, vid, txt, cls_tok = model.pre(
                mi["src_txt"], mi["src_txt_mask"], mi["src_vid"], mi["src_vid_mask"],
                mi.get("src_cls"), cls_mask, generator)
            ch = pipe.Chunks(enc, mask, M, cfg.moe_experts > 1)
            ch.check_batch()
            ch.draw(src, generator)
            need_pos = pos.requires_grad
            metrics, aux_sum, d_src, d_pos, d_vid, d_txt, d_cls = pipeline_1f1b(
                model, ch, src.detach(), pos.detach(), vid.detach(), txt.detach(),
                mi["src_vid_mask"], mi["src_txt_mask"], targets, cls_tok, cls_mask,
                loss_fn=loss_fn, need_pos_grad=need_pos, aux_weight=weights.moe_aux)
            # the heads' gradients (on the last stage) and the cotangents of
            # pre's outputs summed over pp, in one collective per dtype
            layer_ids = {id(p) for layer in enc.stage_layers() for p in layer.parameters()}
            shared = [p for p in model.parameters() if p.requires_grad
                      and id(p) not in layer_ids]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in shared]
            cots = [d_src, d_vid, d_txt] + ([d_pos] if need_pos else []) \
                + ([d_cls] if cls_tok is not None else [])
            if not names:  # the loss terms' names, which the last stage knows
                names.extend(max(dist.all_gather_objects(sorted(metrics), mesh.pp.group),
                                 key=len))
            scalars = torch.stack([metrics.get(k, aux_sum.new_zeros(())) for k in names]
                                  + [aux_sum])
            summed = pm.all_reduce_many(grads + cots + [scalars], mesh.pp)
            for p, g in zip(shared, summed[:len(shared)]):
                p.grad = g
            cots = summed[len(shared):-1]
            outs = [src, vid, txt] + ([pos] if need_pos else []) \
                + ([cls_tok] if cls_tok is not None else [])
            torch.autograd.backward(outs, cots)
        dist.all_reduce_grads(model.parameters(), mesh.dp)
        scalars = pm.all_reduce_many([summed[-1]], mesh.dp)[0]
        out = dict(zip(names, scalars[:-1]))
        if cfg.moe_experts > 1:
            aux_mean = scalars[-1] / (cfg.num_layers * M * mesh.dp.size)
            out["loss_moe_aux"] = aux_mean
            out["loss_overall"] = out["loss_overall"] + weights.moe_aux * aux_mean
        out["grad_norm"] = state.optimizer.step(state.step)
        state.step += 1
        return state, out

    return step
