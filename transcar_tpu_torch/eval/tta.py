"""Test-time augmentation utilities (``transcar_tpu/eval/tta.py``).

The reference's ObjDGCNN ``aug_test_pts`` (obj_dgcnn.py:84-187) is inherited
CenterPoint code: it indexes CenterHead-style ``reg``/``rot``/``vel`` output
maps that ``DGCNN3DHead`` never produces, so it cannot run with the model it
ships with.  These are the JAX package's working double-flip helpers for the
DETR-style heads: flip the input point cloud, decode each view, map boxes
back to the canonical frame, concatenate and keep the global top-k.  As in
the JAX package, nothing but their test calls them (the camera TTA of
``cli.test --aug-test`` is ``train/step.py::aug_eval_step``).

LiDAR flip conventions (mmdet3d ``LiDARInstance3DBoxes.flip``):
  horizontal (BEV y): y → −y, yaw → −yaw, vy → −vy
  vertical   (BEV x): x → −x, yaw → −yaw + π, vx → −vx
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def flip_points(points: torch.Tensor, horizontal: bool = False,
                vertical: bool = False) -> torch.Tensor:
    """points: [..., N, F] with xyz in the first 3 dims (a new tensor)."""
    pts = points.clone()
    if horizontal:
        pts[..., 1] = pts[..., 1] * -1.0
    if vertical:
        pts[..., 0] = pts[..., 0] * -1.0
    return pts


def unflip_boxes(boxes: torch.Tensor, horizontal: bool = False,
                 vertical: bool = False) -> torch.Tensor:
    """boxes: [..., 9] (x, y, z, w, l, h, yaw, vx, vy) decoded in the
    flipped frame → canonical frame (a new tensor)."""
    b = boxes.clone()
    if horizontal:
        b[..., 1] = b[..., 1] * -1.0
        b[..., 6] = b[..., 6] * -1.0
        if b.shape[-1] > 8:
            b[..., 8] = b[..., 8] * -1.0
    if vertical:
        b[..., 0] = b[..., 0] * -1.0
        b[..., 6] = -b[..., 6] + math.pi
        if b.shape[-1] > 7:
            b[..., 7] = b[..., 7] * -1.0
    return b


def merge_flip_detections(decoded: List[Dict], flips: List[tuple],
                          max_num: int = 300) -> Dict[str, np.ndarray]:
    """Merge per-view decoded detections (``eval/decode.py`` output, one
    sample each, tensors or arrays) into a single top-k set.

    Args:
      decoded: list of dicts with boxes [K, 9], scores [K], labels [K],
        valid [K], one per augmented view.
      flips: matching list of (horizontal, vertical) the view was run with.
    """
    boxes, scores, labels = [], [], []
    for det, (hor, ver) in zip(decoded, flips):
        b = unflip_boxes(torch.as_tensor(np.asarray(det["boxes"])), hor, ver)
        s = np.asarray(det["scores"]) * np.asarray(det["valid"])
        boxes.append(b.numpy())
        scores.append(s)
        labels.append(np.asarray(det["labels"]))
    boxes = np.concatenate(boxes)
    scores = np.concatenate(scores)
    labels = np.concatenate(labels)
    order = np.argsort(-scores)[:max_num]
    return {
        "boxes": boxes[order],
        "scores": scores[order],
        "labels": labels[order],
        "valid": scores[order] > 0,
    }
