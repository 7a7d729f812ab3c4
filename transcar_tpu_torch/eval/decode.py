"""NMS-free box decoding (``transcar_tpu/eval/decode.py``).

Sigmoid scores, flat top-k (max_num = 300) over query × class of the last
layer, labels = idx % num_classes, boxes via ``denormalize_bbox``, the
post-center-range filter (± the optional score threshold) as a validity
mask, and the gravity → bottom-center z shift (detr3d_head.py:1018).
Static shapes: always ``max_num`` rows plus ``valid``.
"""
from __future__ import annotations

from typing import Dict

import torch

from transcar_tpu_torch.core.boxes import denormalize_bbox
from transcar_tpu_torch.core.device import const


def nms_free_decode(preds: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """preds: all_cls_scores [L, B, Q, C], all_bbox_preds [L, B, Q, 10];
    cfg: a ``HeadConfig``.  Returns dict(boxes [B, K, 9] bottom-center,
    scores [B, K], labels [B, K] int32, valid [B, K] bool)."""
    cls_scores = preds["all_cls_scores"][-1]
    bbox_preds = preds["all_bbox_preds"][-1]
    b, nq, nc = cls_scores.shape
    scores = torch.sigmoid(cls_scores).reshape(b, nq * nc)
    k = min(cfg.max_detections, nq * nc)
    top_scores, idx = torch.topk(scores, k, dim=-1)
    labels = (idx % nc).to(torch.int32)
    box_codes = torch.gather(
        bbox_preds, 1, (idx // nc)[..., None].expand(-1, -1,
                                                     bbox_preds.shape[-1]))
    boxes = denormalize_bbox(box_codes)                # gravity-center z
    pcr = const(cfg.post_center_range, boxes.device, boxes.dtype)
    centers = boxes[..., :3]
    valid = (centers >= pcr[:3]).all(-1) & (centers <= pcr[3:]).all(-1)
    if cfg.score_threshold is not None:
        valid = valid & (top_scores > cfg.score_threshold)
    z_bottom = boxes[..., 2:3] - 0.5 * boxes[..., 5:6]
    boxes = torch.cat([boxes[..., :2], z_bottom, boxes[..., 3:]], dim=-1)
    return {"boxes": boxes, "scores": top_scores, "labels": labels,
            "valid": valid}
