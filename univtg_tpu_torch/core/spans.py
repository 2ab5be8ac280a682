"""Temporal span algebra; counterpart of ``univtg_tpu/core/spans.py``
(``xx_to_cxw``, ``cxw_to_xx``, ``iou_cross``, ``iou_cross_safe``,
``iou_paired``, ``giou_cross``, ``giou_paired``, ``intersection_over_pred``).

Span formats: xx = (start, end), cxw = (center, width); the last dim is 2.
``torch.maximum``/``torch.minimum`` stand where the reference takes
``jnp.maximum``/``jnp.clip``, so that ties split their gradient in half as
JAX's do.
"""
from __future__ import annotations

import torch


def xx_to_cxw(spans):
    """(..., 2) xx -> cxw."""
    center = (spans[..., 0] + spans[..., 1]) * 0.5
    width = spans[..., 1] - spans[..., 0]
    return torch.stack([center, width], dim=-1)


def cxw_to_xx(spans):
    """(..., 2) cxw -> xx."""
    x1 = spans[..., 0] - 0.5 * spans[..., 1]
    x2 = spans[..., 0] + 0.5 * spans[..., 1]
    return torch.stack([x1, x2], dim=-1)


def _relu(x):
    """jnp.clip(x, 0, None): maximum(0, x), ties halved."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def iou_cross(spans1, spans2):
    """Pairwise IoU of (..., N, 2) and (..., M, 2) xx spans -> (iou, union),
    each (..., N, M). The division is left raw, as the reference leaves it:
    two zero-width spans at one point give nan."""
    areas1 = spans1[..., 1] - spans1[..., 0]
    areas2 = spans2[..., 1] - spans2[..., 0]
    left = torch.maximum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.minimum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    inter = _relu(right - left)
    union = areas1[..., :, None] + areas2[..., None, :] - inter
    return inter / union, union


def giou_cross(spans1, spans2):
    """Pairwise generalized IoU of (..., N, 2) and (..., M, 2) xx spans ->
    (..., N, M); the spans must be ordered (start <= end)."""
    iou, union = iou_cross(spans1, spans2)
    left = torch.minimum(spans1[..., :, None, 0], spans2[..., None, :, 0])
    right = torch.maximum(spans1[..., :, None, 1], spans2[..., None, :, 1])
    enclose = _relu(right - left)
    return iou - (enclose - union) / enclose


def iou_paired(spans1, spans2):
    """Element-wise IoU over aligned xx spans, with the enclosing hull as
    the union (the paired variant R1/mIoU use). Zero hull -> 0."""
    inter = _relu(torch.minimum(spans1[..., 1], spans2[..., 1])
                  - torch.maximum(spans1[..., 0], spans2[..., 0]))
    hull = (torch.maximum(spans1[..., 1], spans2[..., 1])
            - torch.minimum(spans1[..., 0], spans2[..., 0]))
    nonzero = hull != 0
    return torch.where(nonzero, inter / torch.where(nonzero, hull, 1.0), 0.0)


def giou_paired(spans1, spans2, eps: float = 1e-12):
    """Element-wise generalized IoU over aligned xx spans (mask-safe: a
    near-zero union or hull is replaced by eps)."""
    areas1 = spans1[..., 1] - spans1[..., 0]
    areas2 = spans2[..., 1] - spans2[..., 0]
    inter = _relu(torch.minimum(spans1[..., 1], spans2[..., 1])
                  - torch.maximum(spans1[..., 0], spans2[..., 0]))
    union = areas1 + areas2 - inter
    iou = inter / torch.where(union.abs() > eps, union, eps)
    enclose = _relu(torch.maximum(spans1[..., 1], spans2[..., 1])
                    - torch.minimum(spans1[..., 0], spans2[..., 0]))
    enclose = torch.where(enclose.abs() > eps, enclose, eps)
    return iou - (enclose - union) / enclose


def iou_cross_safe(spans1, spans2, eps: float = 1e-12):
    """``iou_cross`` with a union at or below ``eps`` giving IoU 0 (the
    mask-safe variant for padded spans) -> (iou, union)."""
    iou, union = iou_cross(spans1, spans2)
    return torch.where(union > eps, iou, 0.0), union


def intersection_over_pred(gt_spans, pred_spans):
    """Pairwise intersection over the *prediction* span's length: (..., N,
    2) ground truth and (..., M, 2) predictions -> (..., N, M). The division
    is left raw, as the reference leaves it."""
    left = torch.maximum(gt_spans[..., :, None, 0], pred_spans[..., None, :, 0])
    right = torch.minimum(gt_spans[..., :, None, 1], pred_spans[..., None, :, 1])
    inter = _relu(right - left)
    return inter / (pred_spans[..., None, :, 1] - pred_spans[..., None, :, 0])
