"""Synthetic flagship batches and LiDAR point clouds, made with numpy from
a seed.

The port's copy of the JAX driver's fake batch on the ``fp32`` wire
(pre-normalized float images): 6 camera images, an outward-looking
nuScenes-like camera ring as ``lidar2img`` (so about 1/n of the pc-range
points project inside each image and the decoder's sampling carries real
features), radar tokens whose padding rows hold the 500.0 sentinel, and
padded ground truth ``gt_boxes`` / ``gt_labels`` / ``num_gt`` for the
training loss.  The same seed gives the same arrays as the JAX driver's
``_fake_batch(np.random.default_rng(seed), ...)``.

:func:`fake_points` is the port's copy of the point cloud that the JAX
benchmark CLI and ``bench.py`` draw for the LiDAR presets.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def fake_batch(rng: np.random.Generator, b: int, n: int, h: int, w: int,
               num_radar: int, max_gt: int = 32) -> Dict[str, np.ndarray]:
    """Arrays of one batch: images [b, n, h, w, 3] float32, lidar2img
    [b, n, 4, 4], radar_tokens [b, num_radar, 36] (40 real points, the rest
    at the sentinel), gt_boxes [b, max_gt, 9] gravity-center boxes with
    positive dims, gt_labels [b, max_gt] int32 and num_gt [b] int32 (7)."""
    images = rng.normal(size=(b, n, h, w, 3)).astype(np.float32)
    # camera i faces azimuth a with z_cam = forward, x_cam = right,
    # y_cam = down
    l2i = np.zeros((b, n, 4, 4), np.float32)
    fx = 0.8 * w                      # ~64° horizontal FOV, slight overlap
    k = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]], np.float32)
    for i in range(n):
        a = 2 * np.pi * i / n
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        right = np.array([-np.sin(a), np.cos(a), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        rot = np.stack([right, down, fwd]).astype(np.float32)  # world→cam
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = k @ rot
        l2i[:, i] = m
    radar = np.full((b, num_radar, 36), 500.0, np.float32)
    nreal = min(40, num_radar)
    radar[:, :nreal] = rng.normal(size=(b, nreal, 36)).astype(np.float32)
    radar[:, :nreal, 0:2] *= 30.0
    gt_boxes = np.ones((b, max_gt, 9), np.float32)
    gt_boxes[:, :, 0:2] = rng.uniform(-40, 40, (b, max_gt, 2))
    gt_boxes[:, :, 3:6] = rng.uniform(0.5, 6, (b, max_gt, 3))
    gt_labels = rng.integers(0, 10, (b, max_gt)).astype(np.int32)
    num_gt = np.full((b,), 7, np.int32)
    return {"images": images, "lidar2img": l2i, "radar_tokens": radar,
            "gt_boxes": gt_boxes, "gt_labels": gt_labels, "num_gt": num_gt}


def fake_points(rng: np.random.Generator, b: int, n_max: int,
                pc_range: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
    """points [b, n_max, 5] float32 (xyz uniform over ``pc_range``,
    intensity in [0, 255), time lag in [0, 0.45)) and num_points [b]
    int32, 90% of ``n_max`` real."""
    pc = pc_range
    pts = np.zeros((b, n_max, 5), np.float32)
    pts[:, :, 0] = rng.uniform(pc[0], pc[3], (b, n_max))
    pts[:, :, 1] = rng.uniform(pc[1], pc[4], (b, n_max))
    pts[:, :, 2] = rng.uniform(pc[2], pc[5], (b, n_max))
    pts[:, :, 3] = rng.uniform(0, 255, (b, n_max))
    pts[:, :, 4] = rng.uniform(0, 0.45, (b, n_max))
    return pts, np.full((b,), int(n_max * 0.9), np.int32)
