"""Set-to-set detection loss: Hungarian targets + focal cls + weighted L1
(``transcar_tpu/train/loss.py``; reference ``Detr3DHead.loss``,
detr3d_head.py:742-1001, and ``HungarianAssigner3D``).

  * cost = FocalLossCost(w 2.0) + BBox3DL1Cost(w 0.25) over normalized
    boxes; all L·B problems of a step are solved in one kernel launch
    on the card, which the host never waits for (ops/hungarian.py; the
    plain PyTorch solver on the CPU).
  * labels: matched queries get the gt label, the rest background
    (= num_classes); label weights are all ones.
  * bbox targets: normalized gt boxes at matched rows, weights 1 there ×
    ``code_weights``; non-finite target rows are dropped.
  * cls_avg_factor = num_pos + bg_cls_weight · num_neg, and the bbox
    normalizer clamp(num_pos, 1), both over the whole (global) batch; NaN
    losses become 0.

gt boxes arrive padded to a static G in gravity-center form (cx, cy,
cz, w, l, h, yaw, vx, vy) with ``num_gt`` real rows; padded rows have
positive dims so their ``log`` stays finite.
"""
from __future__ import annotations

from typing import Dict

import torch

from transcar_tpu_torch.core.boxes import normalize_bbox
from transcar_tpu_torch.core.device import const
from transcar_tpu_torch.ops.focal import (focal_loss_cost, l1_loss,
                                          sigmoid_focal_loss)
from transcar_tpu_torch.ops.hungarian import hungarian_match
from transcar_tpu_torch.parallel.distributed import global_sum, rank_world


def hungarian_targets(cls_all: torch.Tensor, box_all: torch.Tensor,
                      gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                      num_gt: torch.Tensor, cfg):
    """Per-query targets of every (layer, sample).

    cls_all [L, B, Q, C], box_all [L, B, Q, 10], gt_boxes [B, G, 9],
    gt_labels [B, G], num_gt [B].  Returns labels [L, B, Q] (int64),
    bbox_targets and bbox_weights [L, B, Q, 10].
    """
    nl, b, nq, _ = cls_all.shape
    g = gt_boxes.shape[1]
    gt_norm = normalize_bbox(gt_boxes)                        # [B, G, 10]
    with torch.no_grad():
        cost = focal_loss_cost(cls_all, gt_labels,
                               weight=cfg.match_cls_weight,
                               gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
        cost = cost + (box_all[..., None, :10] - gt_norm[:, None, :, :10]
                       ).abs().sum(-1) * cfg.match_reg_weight  # [L, B, Q, G]
        matched, _ = hungarian_match(cost.reshape(nl * b, nq, g),
                                     num_gt.repeat(nl))
    # padded slots carry the sentinel Q: they land in an extra column that
    # is then dropped (the JAX scatter's mode="drop"); a real slot left
    # unmatched carries -1, which the JAX scatter, like NumPy indexing,
    # takes from the end: query Q - 1
    idx = matched.reshape(nl, b, g)
    idx = torch.where(idx < 0, idx + nq, idx)
    labels = torch.full((nl, b, nq + 1), cfg.num_classes, dtype=torch.int64,
                        device=cls_all.device)
    labels.scatter_(2, idx, gt_labels.long().expand(nl, b, g))
    tgt = torch.zeros((nl, b, nq + 1, 10), dtype=torch.float32,
                      device=cls_all.device)
    idx10 = idx[..., None].expand(nl, b, g, 10)
    tgt.scatter_(2, idx10, gt_norm.float().expand(nl, b, g, 10))
    wts = torch.zeros_like(tgt)
    wts.scatter_(2, idx10, torch.ones((nl, b, g, 10), device=tgt.device))
    return labels[:, :, :nq], tgt[:, :, :nq], wts[:, :, :nq]


def _layer_loss(cls_scores, bbox_preds, labels, bbox_targets, bbox_weights,
                num_pos, batch, cfg):
    """Loss of one decoder layer over the batch (cls_scores [B, Q, C];
    ``num_pos`` and ``batch`` are the global batch's)."""
    b, nq, c = cls_scores.shape
    cls_avg = torch.clamp(num_pos + cfg.bg_cls_weight * (batch * nq - num_pos),
                          min=1.0)
    loss_cls = sigmoid_focal_loss(
        cls_scores.reshape(-1, c), labels.reshape(-1),
        torch.ones(b * nq, device=cls_scores.device), c,
        gamma=cfg.focal_gamma, alpha=cfg.focal_alpha, avg_factor=cls_avg,
        loss_weight=cfg.loss_cls_weight)
    code_w = const(cfg.code_weights, cls_scores.device)
    targets = bbox_targets.reshape(-1, 10)
    finite = torch.isfinite(targets).all(dim=-1, keepdim=True)
    weights = bbox_weights.reshape(-1, 10) * code_w * finite
    loss_bbox = l1_loss(
        bbox_preds.reshape(-1, 10), torch.where(finite, targets, 0.0),
        weights, avg_factor=torch.clamp(num_pos, min=1.0),
        loss_weight=cfg.loss_bbox_weight)
    return torch.nan_to_num(loss_cls), torch.nan_to_num(loss_bbox)


def detr3d_loss(preds: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, num_gt: torch.Tensor,
                cfg, group=None) -> Dict[str, torch.Tensor]:
    """Full multi-layer loss (``cfg``: a ``HeadConfig``).

    With a data ``group`` (``parallel/mesh.Grid.data_group``) this rank's
    rows are one part of a global batch: ``num_pos`` and the batch size of
    ``cls_avg`` are the global batch's (summed over the group, the
    reference's ``reduce_mean``, which the JAX step gets from its global
    batch), so each rank's loss is its rows' share of the global loss, and
    the sum of the ranks' losses (and gradients) is the global batch's.

    Args:
      preds: all_cls_scores [L, B, Q, C] and all_bbox_preds [L, B, Q, 10]:
        the 3 fusion layers in TransCAR mode, the decoder layers in
        camera-only DETR3D mode.
      gt_boxes [B, G, 9], gt_labels [B, G], num_gt [B].
    Returns:
      ``loss_cls`` / ``loss_bbox`` of the last layer, ``d{i}.loss_cls`` /
      ``d{i}.loss_bbox`` of the earlier ones, and ``total``.
    """
    cls_all = preds["all_cls_scores"]
    box_all = preds["all_bbox_preds"]
    nl = cls_all.shape[0]
    labels, targets, weights = hungarian_targets(
        cls_all, box_all, gt_boxes, gt_labels, num_gt, cfg)
    num_pos = global_sum(num_gt.sum().float().to(cls_all.device)[None],
                         group)[0]
    batch = cls_all.shape[1] * rank_world(group)[1]
    losses, total = {}, 0.0
    for lid in range(nl):
        lc, lb = _layer_loss(cls_all[lid], box_all[lid], labels[lid],
                             targets[lid], weights[lid], num_pos, batch, cfg)
        prefix = "" if lid == nl - 1 else f"d{lid}."
        losses[prefix + "loss_cls"] = lc
        losses[prefix + "loss_bbox"] = lb
        total = total + lc + lb
    losses["total"] = total
    return losses
