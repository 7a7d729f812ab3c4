"""LiDAR point-cloud pipeline for the ObjDGCNN track.

Host-side rebuild of the reference's point train pipeline
(projects/configs/obj_dgcnn/pillar.py:175-206, ops implemented upstream in
mmdet3d 0.17 datasets/pipelines/{loading,transforms_3d}.py):

  LoadPointsFromFile(load_dim 5, use_dim 5)
  LoadPointsFromMultiSweeps(sweeps 9, pad_empty_sweeps, remove_close)
  GlobalRotScaleTrans(rot ±0.3925, scale 0.95–1.05, trans_std 0)
  RandomFlip3D(bev horizontal 0.5, vertical 0.5)
  PointsRangeFilter(pc_range) / ObjectRangeFilter / ObjectNameFilter
  PointShuffle

TPU-first inversion: the output is a STATIC [max_points, 5] buffer plus a
valid count (the voxelizer ops/voxelize.py consumes exactly that), so the
whole downstream model jits with fixed shapes.  Semantics notes:
  * key-frame points get time-channel 0, each sweep gets the key−sweep
    timestamp lag in seconds in column 4 (LoadPointsFromMultiSweeps).
  * remove_close drops |x|<r & |y|<r ego returns, key frame excluded —
    same as the reference (its key frame skips _remove_close on the
    first list entry), sweeps and pad_empty repeats filtered.
  * box yaw/flip conventions follow mmdet3d 0.17
    LiDARInstance3DBoxes.rotate/.flip: rotate does
    xyz @ Rᵀ, yaw += angle; horizontal flip negates (y, vy) and maps
    yaw → π − yaw; vertical flip negates (x, vx) and maps yaw → −yaw.
  * ObjectRangeFilter runs AFTER augmentation (reference order), with
    limit_yaw re-applied.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from transcar_tpu_torch.core.config import PC_RANGE, DataConfig


def load_points(path: str, load_dim: int = 5) -> np.ndarray:
    """LoadPointsFromFile: raw nuScenes .bin → [N, load_dim] float32."""
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"lidar point file not found: {path!r} — the infos pkl must "
            "carry per-sample 'lidar_path' (and sweep 'data_path') entries "
            "pointing at raw nuScenes .bin files for the ObjDGCNN track")
    pts = np.fromfile(path, dtype=np.float32)
    return pts.reshape(-1, load_dim)


def remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Drop ego-vehicle returns: |x| < r AND |y| < r."""
    close = (np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius)
    return points[~close]


def load_points_multisweep(
    lidar_path: str,
    sweeps: List[Dict],
    timestamp: float,
    nsweeps: int = 9,
    load_dim: int = 5,
    pad_empty_sweeps: bool = True,
    remove_close_radius: float = 1.0,
    test_mode: bool = False,
    rng: Optional[np.random.Generator] = None,
    rebase=None,
) -> np.ndarray:
    """LoadPointsFromFile + LoadPointsFromMultiSweeps.

    ``sweeps`` entries carry data_path, sensor2lidar_rotation/translation
    and timestamp (the infos-pkl schema built by obtain_sensor2top,
    tools/data_converter/nuscenes_converter.py:287-347).
    """
    rng = rng or np.random.default_rng()
    rebase = rebase or (lambda p: p)
    key = load_points(rebase(lidar_path), load_dim)
    key[:, 4] = 0.0                                  # key-frame time lag
    out = [key]
    ts = timestamp / 1e6

    if pad_empty_sweeps and len(sweeps) == 0:
        filt = (remove_close(key, remove_close_radius)
                if remove_close_radius > 0 else key)
        out.extend([filt] * nsweeps)
    else:
        if len(sweeps) <= nsweeps:
            choices = np.arange(len(sweeps))
        elif test_mode:
            choices = np.arange(nsweeps)
        else:
            choices = rng.choice(len(sweeps), nsweeps, replace=False)
        for idx in choices:
            sw = sweeps[int(idx)]
            pts = load_points(rebase(str(sw["data_path"])), load_dim)
            if remove_close_radius > 0:
                pts = remove_close(pts, remove_close_radius)
            rot = np.asarray(sw["sensor2lidar_rotation"], np.float64)
            tr = np.asarray(sw["sensor2lidar_translation"], np.float64)
            pts = pts.copy()
            pts[:, :3] = pts[:, :3] @ rot.T + tr
            pts[:, 4] = ts - float(sw["timestamp"]) / 1e6
            out.append(pts.astype(np.float32))
    return np.concatenate(out, axis=0).astype(np.float32)


def global_rot_scale_trans(
    points: np.ndarray, boxes: np.ndarray,
    rng: np.random.Generator,
    rot_range: Tuple[float, float] = (-0.3925, 0.3925),
    scale_range: Tuple[float, float] = (0.95, 1.05),
    trans_std: Tuple[float, float, float] = (0.0, 0.0, 0.0),
):
    """GlobalRotScaleTrans: rotate → scale → translate, boxes + points.

    boxes: [G, 9] (x,y,z,w,l,h,yaw,vx,vy).  Rotation follows mmdet3d 0.17
    LiDARInstance3DBoxes.rotate: xyz' = xyz @ Rᵀ with
    Rᵀ = [[c,−s,0],[s,c,0],[0,0,1]], yaw += angle, vel @ Rᵀ₂ₓ₂.
    """
    points = points.copy()
    boxes = boxes.copy()
    angle = float(rng.uniform(rot_range[0], rot_range[1]))
    c, s = np.cos(angle), np.sin(angle)
    rot_t = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                     np.float32)
    points[:, :3] = points[:, :3] @ rot_t
    if len(boxes):
        boxes[:, :3] = boxes[:, :3] @ rot_t
        boxes[:, 6] += angle
        boxes[:, 7:9] = boxes[:, 7:9] @ rot_t[:2, :2]

    scale = float(rng.uniform(scale_range[0], scale_range[1]))
    points[:, :3] *= scale
    if len(boxes):
        boxes[:, :6] *= scale
        boxes[:, 7:9] *= scale

    trans = rng.normal(scale=np.asarray(trans_std, np.float32), size=3) \
        .astype(np.float32)
    points[:, :3] += trans
    if len(boxes):
        boxes[:, :3] += trans
    return points, boxes


def random_flip_3d(
    points: np.ndarray, boxes: np.ndarray, rng: np.random.Generator,
    flip_ratio_horizontal: float = 0.5, flip_ratio_vertical: float = 0.5,
):
    """RandomFlip3D (sync_2d=False): independent BEV-horizontal (y) and
    BEV-vertical (x) flips, mmdet3d 0.17 LiDARInstance3DBoxes.flip
    conventions (see module docstring)."""
    points = points.copy()
    boxes = boxes.copy()
    if rng.random() < flip_ratio_horizontal:
        points[:, 1] = -points[:, 1]
        if len(boxes):
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 8] = -boxes[:, 8]
            boxes[:, 6] = -boxes[:, 6] + np.pi
    if rng.random() < flip_ratio_vertical:
        points[:, 0] = -points[:, 0]
        if len(boxes):
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 7] = -boxes[:, 7]
            boxes[:, 6] = -boxes[:, 6]
    return points, boxes


def points_range_filter(points: np.ndarray,
                        pc_range=PC_RANGE) -> np.ndarray:
    r = np.asarray(pc_range, np.float32)
    keep = ((points[:, 0] > r[0]) & (points[:, 0] < r[3])
            & (points[:, 1] > r[1]) & (points[:, 1] < r[4])
            & (points[:, 2] > r[2]) & (points[:, 2] < r[5]))
    return points[keep]


def object_range_filter(boxes: np.ndarray, labels: np.ndarray,
                        pc_range=PC_RANGE):
    """ObjectRangeFilter on (possibly augmented) boxes: BEV center range
    + limit_yaw to [-π, π)."""
    if not len(boxes):
        return boxes, labels
    r = np.asarray(pc_range, np.float32)
    keep = ((boxes[:, 0] > r[0]) & (boxes[:, 0] < r[3])
            & (boxes[:, 1] > r[1]) & (boxes[:, 1] < r[4]))
    boxes, labels = boxes[keep].copy(), labels[keep]
    boxes[:, 6] = (boxes[:, 6] + np.pi) % (2 * np.pi) - np.pi
    return boxes, labels


def pad_points(points: np.ndarray, max_points: int):
    """Static [max_points, F] buffer + valid count.  Overflow drops the
    tail (points were shuffled, so the drop is uniform); pad rows sit at
    the pc-range corner-ish zero, excluded by the count."""
    n = min(len(points), max_points)
    buf = np.zeros((max_points, points.shape[1]), np.float32)
    buf[:n] = points[:n]
    return buf, np.int32(n)


def prepare_lidar_sample(info: Dict, cfg: DataConfig, training: bool,
                         rng: Optional[np.random.Generator] = None,
                         rebase=None, pc_range=PC_RANGE,
                         gt_boxes: Optional[np.ndarray] = None,
                         gt_labels: Optional[np.ndarray] = None
                         ) -> Dict[str, np.ndarray]:
    """Full per-sample LiDAR pipeline → static-shape arrays.

    info: an infos-pkl entry (lidar_path, sweeps, timestamp).  GT must be
    passed pre-name-filtered but NOT range-filtered (the reference range-
    filters after augmentation).
    """
    rng = rng or np.random.default_rng()
    pts = load_points_multisweep(
        str(info["lidar_path"]), list(info.get("sweeps", [])),
        float(info["timestamp"]), nsweeps=cfg.lidar_sweeps,
        load_dim=cfg.lidar_load_dim,
        pad_empty_sweeps=cfg.lidar_pad_empty_sweeps,
        remove_close_radius=cfg.lidar_remove_close,
        test_mode=not training, rng=rng, rebase=rebase)

    boxes = gt_boxes if gt_boxes is not None else np.zeros((0, 9),
                                                           np.float32)
    labels = gt_labels if gt_labels is not None else np.zeros((0,),
                                                              np.int32)
    if training:
        pts, boxes = global_rot_scale_trans(
            pts, boxes, rng, cfg.rot_range, cfg.scale_range, cfg.trans_std)
        pts, boxes = random_flip_3d(
            pts, boxes, rng, cfg.flip_ratio_horizontal,
            cfg.flip_ratio_vertical)
    pts = points_range_filter(pts, pc_range)
    boxes, labels = object_range_filter(boxes, labels, pc_range)
    if training and cfg.point_shuffle:
        pts = pts[rng.permutation(len(pts))]

    from transcar_tpu_torch.data.loader import pad_gt

    buf, n = pad_points(pts, cfg.max_points)
    gt_b, gt_l, num_gt = pad_gt(boxes, labels, cfg.max_gt_boxes)
    return {"points": buf, "num_points": n,
            "gt_boxes": gt_b, "gt_labels": gt_l, "num_gt": num_gt}
