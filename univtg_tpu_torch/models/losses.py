"""Grounding losses; counterpart of ``univtg_tpu/models/losses.py``, the
QFVS criterion (``qfvs_losses``, ``compact_to_grid``) included.

Dense per-clip supervision with no Hungarian matching, mask-disciplined for
static shapes (multiply-by-mask and masked reductions instead of boolean
indexing). ``gates`` is the optional (B, 5) per-sample loss gate [b, g, f,
s_intra, s_inter] of multi-corpus batches mixing point, interval and curve
supervision.

Where the reference takes ``jnp.maximum``/``jnp.clip`` of a differentiable
value, this file takes ``torch.maximum``/``torch.minimum``, whose ties split
the gradient in half as JAX's do (``clamp`` would pass all of it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from univtg_tpu_torch.core.spans import giou_paired
from univtg_tpu_torch.models.layers import mask_log, sim_matrix

TEMPERATURE = 0.07  # hard-coded in the reference model

# Smallest normal f32: a log at an exact zero would make the clipped-BCE
# backward emit 0 * inf = NaN once the sigmoid saturates, and a subnormal
# floor flushes to zero on some devices. torch's fused BCE clamps its log
# at -100 instead, which is a different function; this floor is explicit.
_BCE_FLOOR = 1e-37


def smooth_l1(x, y, beta: float = 1.0):
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _safe_div(num, den):
    return num / den.clamp_min(1.0)


def _clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x)), ties halved."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _bce_logs(probs):
    """NaN-safe (log p, log(1-p)) for probability-space BCE."""
    return (torch.log(_clip(probs, _BCE_FLOOR, 1.0)),
            torch.log(_clip(1.0 - probs, _BCE_FLOOR, 1.0)))


def has_signal(sal, like):
    """1 when the batch carries any saliency, else 0: a whole-batch zero
    saliency turns the saliency terms off."""
    return (sal.sum() != 0).to(like.dtype)


def loss_spans(outputs, targets, gates=None):
    """Boundary regression: smooth-L1 + GIoU on in-window clips."""
    src_spans = targets["timestamp"] + outputs["pred_spans"]
    gt_spans = targets["span_labels_nn"]
    valid = targets["timestamp_window"].to(src_spans.dtype)  # (B, Lv)
    if gates is not None:
        valid_b = valid * gates[:, None, 0]
        valid_g = valid * gates[:, None, 1]
    else:
        valid_b = valid_g = valid

    l1 = smooth_l1(src_spans, gt_spans) * valid_b[..., None]
    loss_b = _safe_div(l1.sum(), valid_b.sum())

    giou = giou_paired(src_spans, gt_spans)  # (B, Lv)
    loss_g = _safe_div(((1.0 - giou) * valid_g).sum(), valid_g.sum())
    return {"loss_b": loss_b, "loss_g": loss_g}


def loss_labels(outputs, targets, eos_coef: float = 0.1, gates=None):
    """Per-clip foreground BCE with background down-weighting."""
    probs = outputs["pred_logits"][..., 0]  # sigmoid probabilities (B, Lv)
    mask = targets["timestamp_mask"].to(probs.dtype)
    valid = targets["timestamp_window"].to(probs.dtype)

    weights = mask * eos_coef + valid * (1.0 - eos_coef)
    logp, log1mp = _bce_logs(probs)
    ce = -(valid * logp + (1.0 - valid) * log1mp) * weights
    if gates is not None:
        ce = ce * gates[:, None, 2]
    return {"loss_f": _safe_div((ce * mask).sum(), mask.sum())}


def _cosine_rows(a, b, eps: float = 1e-8):
    an = torch.linalg.vector_norm(a, dim=-1).clamp_min(eps)
    bn = torch.linalg.vector_norm(b, dim=-1).clamp_min(eps)
    return torch.sum(a * b, dim=-1) / (an * bn)


def _pos_index(targets):
    pos_idx = targets["saliency_pos_labels"].long()  # (B,) or (B, n)
    return pos_idx[:, 0] if pos_idx.dim() == 2 else pos_idx


def _inter_video(vid_feats, txt_feats):
    """Log-softmax diagonals of the positive clips against the batch of
    sentences, both directions."""
    sim = sim_matrix(vid_feats, txt_feats)
    i_diag = torch.diagonal(F.log_softmax(sim / TEMPERATURE, dim=1))
    j_diag = torch.diagonal(F.log_softmax(sim.T / TEMPERATURE, dim=1))
    return i_diag, j_diag


def loss_saliency(outputs, targets, gates=None):
    """Inter-video InfoNCE + intra-video below-positive contrastive."""
    sal = targets["saliency_scores"]  # (B, Lv) dense scores
    pos_idx = _pos_index(targets)
    batch_idx = torch.arange(sal.shape[0], device=sal.device)

    vid_mem = outputs["vid_mem_proj"]  # (B, Lv, D)
    txt_feats = outputs["txt_mem_proj"][:, 0, :]  # (B, D)
    vid_feats = vid_mem[batch_idx, pos_idx]  # (B, D)

    i_diag, j_diag = _inter_video(vid_feats, txt_feats)
    if gates is not None:
        g = gates[:, 4]
        inter = (-_safe_div((i_diag * g).sum(), g.sum())
                 - _safe_div((j_diag * g).sum(), g.sum()))
    else:
        inter = -i_diag.mean() - j_diag.mean()

    # intra-video: clips scoring below the sampled positive are in-softmax
    mask = targets["timestamp_mask"]
    selected = sal[batch_idx, pos_idx][:, None]  # (B, 1)
    below = (sal < selected).to(mask.dtype)
    below = below.scatter(1, pos_idx[:, None], 1.0)  # no host scalar: capturable
    in_mask = below * mask

    sim_in = _cosine_rows(vid_mem, txt_feats[:, None, :])  # (B, Lv)
    sim_in = sim_in + mask_log(in_mask)
    logsm_i = F.log_softmax(sim_in / TEMPERATURE, dim=1)
    logsm_j = F.log_softmax(sim_in / TEMPERATURE, dim=0)
    pos_i = logsm_i[batch_idx, pos_idx]
    pos_j = logsm_j[batch_idx, pos_idx]
    if gates is not None:
        g = gates[:, 3]
        intra = (-_safe_div((pos_i * g).sum(), g.sum())
                 - _safe_div((pos_j * g).sum(), g.sum()))
    else:
        intra = -pos_i.mean() - pos_j.mean()

    on = has_signal(sal, inter)
    return {"loss_s_inter": inter * on, "loss_s_intra": intra * on}


def loss_saliency_cls(outputs, targets, gates=None):
    """TAL-style saliency: inter-video InfoNCE + class-feature contrastive.
    Needs outputs['cls_mem_proj'] and targets['cls_idx'] (B, C)."""
    sal = targets["saliency_scores"]
    pos_idx = _pos_index(targets)
    batch_idx = torch.arange(sal.shape[0], device=sal.device)

    vid_feats = outputs["vid_mem_proj"][batch_idx, pos_idx]
    txt_feats = outputs["txt_mem_proj"][:, 0, :]
    i_diag, j_diag = _inter_video(vid_feats, txt_feats)
    inter = -i_diag.mean() - j_diag.mean()

    out = {"loss_s_inter": inter}
    if "cls_idx" in targets:
        cls_idx = targets["cls_idx"].to(sal.dtype)  # (B, C)
        cls_feats = outputs["cls_mem_proj"]  # (C, D) or (B, 1, D)
        if cls_feats.dim() == 3:
            cls_feats = cls_feats[:, 0, :]
        sim_cls = sim_matrix(vid_feats, cls_feats)
        logsm = F.log_softmax(sim_cls / TEMPERATURE, dim=1)
        count = cls_idx.sum().clamp_min(1.0)
        out["loss_s_intra"] = -(logsm * cls_idx).sum() / count
    on = has_signal(sal, inter)
    return {k: v * on for k, v in out.items()}


def qfvs_losses(outputs, gt_grid, mask_flat):
    """QFVS criterion over the segment-flattened grid (upstream
    model/univtg_qfvs.py:215-261, 358-377, which masked_selects the valid
    frames; here the labels sit at their grid positions, scattered on the
    host by ``compact_to_grid``).

    outputs: (S, F, 1) pred_logits and (S, F) saliency_scores; gt_grid and
    mask_flat: (S*F,) binary labels and validity. Returns {'loss_f',
    'loss_s_intra', 'loss_s_inter'}: the foreground BCE over valid frames
    and the MIL-NCE over all valid frames (positives in the numerator),
    each normalised by the positive count and 0 without positives;
    loss_s_inter is 0."""
    probs = outputs["pred_logits"].reshape(-1)
    sal = outputs["saliency_scores"].reshape(-1)
    gt = gt_grid.to(probs.dtype)
    mask = mask_flat.to(probs.dtype)
    n_pos = gt.sum()
    has_pos = n_pos > 0
    zero = torch.zeros((), dtype=probs.dtype, device=probs.device)

    logp, log1mp = _bce_logs(probs)
    ce = -(gt * logp + (1.0 - gt) * log1mp) * mask
    loss_f = torch.where(has_pos, ce.sum() / n_pos.clamp_min(1.0), zero)

    logsm = F.log_softmax(sal / TEMPERATURE + mask_log(mask), dim=0)
    intra = -torch.where(has_pos, (logsm * gt).sum() / n_pos.clamp_min(1.0), zero)
    return {"loss_f": loss_f, "loss_s_intra": intra, "loss_s_inter": zero}


def compact_to_grid(vec_compact, seg_len, max_segments: int, max_frames: int):
    """A compact per-shot vector (shot i = the i-th valid frame) scattered
    onto the padded (S*F,) grid of the flattened model inputs (numpy)."""
    grid = np.zeros(max_segments * max_frames, np.float32)
    pos = 0
    for j, n in enumerate(np.asarray(seg_len, int)):
        grid[j * max_frames : j * max_frames + n] = vec_compact[pos : pos + n]
        pos += n
    return grid


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Loss coefficients (the reference's *_loss_coef flags)."""

    b: float = 10.0
    g: float = 1.0
    f: float = 10.0
    s_intra: float = 0.1
    s_inter: float = 0.1
    eos_coef: float = 0.1
    # MoE load-balance aux coefficient; active only when the model reports
    # an aux loss (outputs["aux_moe"])
    moe_aux: float = 0.01

    def as_dict(self):
        return {
            "loss_b": self.b,
            "loss_g": self.g,
            "loss_f": self.f,
            "loss_s_intra": self.s_intra,
            "loss_s_inter": self.s_inter,
            "loss_moe_aux": self.moe_aux,
        }


def compute_losses(outputs, targets, weights: LossWeights,
                   losses=("spans", "labels", "saliency"),
                   gates: Optional[torch.Tensor] = None):
    """Dispatch + weighted total: mr/vlp train spans+labels+saliency
    (saliency_cls for TAL corpora), hl/vs labels+saliency."""
    out = {}
    if "spans" in losses:
        out.update(loss_spans(outputs, targets, gates))
    if "labels" in losses:
        out.update(loss_labels(outputs, targets, weights.eos_coef, gates))
    if "saliency" in losses:
        out.update(loss_saliency(outputs, targets, gates))
    if "saliency_cls" in losses:
        out.update(loss_saliency_cls(outputs, targets, gates))
    if "aux_moe" in outputs:
        out["loss_moe_aux"] = outputs["aux_moe"]
    wd = weights.as_dict()
    out["loss_overall"] = sum(v * wd[k] for k, v in out.items() if k in wd)
    return out
