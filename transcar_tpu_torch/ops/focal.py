"""Sigmoid focal loss, focal matching cost and L1 loss
(``transcar_tpu/ops/focal.py``; mmdet ``FocalLoss``, ``FocalLossCost`` and
``L1Loss`` semantics).

  pt            = (1 - p) * t + p * (1 - t)
  focal_weight  = (alpha * t + (1 - alpha) * (1 - t)) * pt ** gamma
  loss          = BCE_with_logits(x, t) * focal_weight

Integer labels are one-hot expanded; label == num_classes is background
(an all-zero one-hot row).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_weights: torch.Tensor, num_classes: int,
                       gamma: float = 2.0, alpha: float = 0.25,
                       avg_factor=1.0, loss_weight: float = 1.0
                       ) -> torch.Tensor:
    """Focal classification loss over flat query predictions.

    logits [N, C]; labels [N] in [0, C] (C = background); label_weights
    [N]; avg_factor: the normalizer (num_pos + bg_weight · num_neg).
    Returns a scalar.
    """
    onehot = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes]
    onehot = onehot.to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * onehot + p * (1.0 - onehot)
    focal_weight = (alpha * onehot + (1.0 - alpha) * (1.0 - onehot)) * (
        pt ** gamma)
    bce = (logits.clamp(min=0.0) - logits * onehot
           + torch.log1p(torch.exp(-logits.abs())))
    loss = bce * focal_weight * label_weights[..., None]
    return loss_weight * loss.sum() / torch.clamp(
        torch.as_tensor(avg_factor, dtype=loss.dtype), min=1.0)


def focal_loss_cost(logits: torch.Tensor, gt_labels: torch.Tensor,
                    weight: float = 2.0, gamma: float = 2.0,
                    alpha: float = 0.25, eps: float = 1e-12) -> torch.Tensor:
    """mmdet ``FocalLossCost``: logits [..., Q, C], gt_labels [..., G]
    (leading dims broadcast) → [..., Q, G]."""
    p = torch.sigmoid(logits)
    neg_cost = -torch.log(1.0 - p + eps) * (1.0 - alpha) * p ** gamma
    pos_cost = -torch.log(p + eps) * alpha * (1.0 - p) ** gamma
    idx = gt_labels.long().unsqueeze(-2).expand(
        *logits.shape[:-1], gt_labels.shape[-1])
    return (pos_cost.gather(-1, idx) - neg_cost.gather(-1, idx)) * weight


def l1_loss(pred: torch.Tensor, target: torch.Tensor, weights: torch.Tensor,
            avg_factor=1.0, loss_weight: float = 0.25) -> torch.Tensor:
    """Weighted L1 regression loss (mmdet ``L1Loss``)."""
    loss = (pred - target).abs() * weights
    return loss_weight * loss.sum() / torch.clamp(
        torch.as_tensor(avg_factor, dtype=loss.dtype), min=1.0)
